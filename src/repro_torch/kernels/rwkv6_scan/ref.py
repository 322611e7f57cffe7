"""Plain PyTorch versions of the RWKV6 scan (K5): the sequential
recurrence (the oracle, and what the wrapper runs on CPU tensors), the
chunked closed form, both from a given or a zero state, and
:func:`rwkv6_subchunk`, a twin of the CUDA kernel's arithmetic that the
tests hold against the oracle."""
from __future__ import annotations

import math

import torch

from repro_torch.models.rwkv6 import rwkv_chunk, rwkv_ref_scan


def _zero_state(r):
    B, _, H, hd = r.shape
    return torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)


def rwkv6_scan(r, k, v, logw, u, S_in=None):
    """r,k,v,logw [B,T,H,hd]; u [H,hd]; S_in [B,H,hd,hd] or None (zero).
    Returns (out [B,T,H,hd] f32, S_final [B,H,hd,hd] f32)."""
    return rwkv_ref_scan(r, k, v, logw, u,
                         _zero_state(r) if S_in is None else S_in)


def rwkv6_chunked(r, k, v, logw, u, chunk: int = 64, S_in=None):
    return rwkv_chunk(r, k, v, logw, u,
                      _zero_state(r) if S_in is None else S_in, chunk)


def tf32(x):
    """Round f32 to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` does:
    to nearest, ties away from zero, on the int32 view."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _mm(a, b, split: bool):
    """a @ b through TF32 tensor-core products: 3xTF32 (hi·hi + hi·lo +
    lo·hi, each operand split as hi = tf32(x), lo = tf32(x - hi)) or, with
    ``split=False``, one pass on tf32(a) @ tf32(b)."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def rwkv6_subchunk(r, k, v, logw, u, S_in=None, chunk: int = 64,
                   sub: int = 16, tf32_split: bool = True):
    """The CUDA kernel's arithmetic in plain torch (tests only).

    Per chunk of ``chunk`` rows (the last one ragged), in log2 units with
    la = running sum of log2 w and la_prev[t] = la[t-1] (0 at the chunk's
    first row), split into sub-chunks of ``sub`` rows with e_J the last
    row of sub-chunk J (la[e_-1] = 0):

    * diagonal blocks att[J,J]: the exact pairwise form in f32,
      sum_d r[t]k[i] 2^(la_prev[t]-la[i]) for i < t, and r.(u*k) at i = t;
    * every decay after that factored at the sub-chunk boundaries:
      r'[J] = r[J] * 2^(la_prev[J] - la[e_J-1]), k'[J] = k[J] *
      2^(la[e_J] - la[J]); the blocks below the diagonal, I > J, are
      att[I,J] = (r'[I] * 2^(la[e_I-1] - la[e_J])) @ k'[J]^T; and
      r*2^la_prev = r' * 2^la[e_J-1], k*2^(la_C - la) = k' * 2^(la_C -
      la[e_J]); every exponent is <= 0;
    * out = [r*2^la_prev | att] @ [S; v] and
      S <- 2^la_C * S + (k*2^(la_C - la))^T @ v;

    every matrix product (the off-diagonal att blocks, out, the state
    update) rounds its operands to TF32 as the kernel's ``mma.sync`` does
    (:func:`_mm`).  r,k,v,logw [B,T,H,hd]; u [H,hd]; S_in [B,H,hd,hd] or
    None.  Returns (out [B,T,H,hd] f32, S_final [B,H,hd,hd] f32)."""
    B, T, H, hd = r.shape
    S = (_zero_state(r) if S_in is None else S_in).float()

    def bh(x):                          # [B,T,H,hd] -> [B,H,T,hd] f32
        return x.float().permute(0, 2, 1, 3)

    r, k, v = bh(r), bh(k), bh(v)
    lw = bh(logw) * math.log2(math.e)
    u = u.float()[None, :, None, :]                       # [1,H,1,hd]
    outs = []
    for t0 in range(0, T, chunk):
        rc, kc, vc = (x[:, :, t0:t0 + chunk] for x in (r, k, v))
        L = rc.shape[2]
        la = torch.cumsum(lw[:, :, t0:t0 + chunk], dim=2)
        lp = torch.cat([torch.zeros_like(la[:, :, :1]), la[:, :, :-1]], 2)
        laC = la[:, :, -1:]                                       # [.,1,hd]
        att = torch.zeros(B, H, L, L, device=r.device)
        rA, kA, rp, kp, ends = [], [], [], [], []
        for j0 in range(0, L, sub):
            j1 = min(j0 + sub, L)
            # diagonal block: exact pairwise decays, u bonus on the diagonal
            D = lp[:, :, j0:j1, None] - la[:, :, None, j0:j1]    # [.,t,i,hd]
            lower = torch.ones(j1 - j0, j1 - j0,
                               device=r.device).tril(-1).bool()
            E = torch.where(lower[:, :, None], torch.exp2(D), 0.0)
            blk = (rc[:, :, j0:j1, None] * kc[:, :, None, j0:j1] * E).sum(-1)
            blk = blk + torch.diag_embed(
                (rc[:, :, j0:j1] * u * kc[:, :, j0:j1]).sum(-1))
            att[:, :, j0:j1, j0:j1] = blk
            # decays factored at the sub-chunk's ends
            start = lp[:, :, j0:j0 + 1]                       # la[e_J-1]
            end = la[:, :, j1 - 1:j1]                         # la[e_J]
            rp.append(rc[:, :, j0:j1] * torch.exp2(lp[:, :, j0:j1] - start))
            kp.append(kc[:, :, j0:j1] * torch.exp2(end - la[:, :, j0:j1]))
            rA.append(rp[-1] * torch.exp2(start))
            kA.append(kp[-1] * torch.exp2(laC - end))
            ends.append((j0, j1, start, end))
        for bi, (i0, i1, start_i, _) in enumerate(ends):
            for bj, (j0, j1, _, end_j) in enumerate(ends[:bi]):
                A = rp[bi] * torch.exp2(start_i - end_j)
                att[:, :, i0:i1, j0:j1] = _mm(A, kp[bj].transpose(-1, -2),
                                              tf32_split)
        rA, kA = torch.cat(rA, 2), torch.cat(kA, 2)
        outs.append(_mm(torch.cat([rA, att], -1), torch.cat([S, vc], -2),
                        tf32_split))
        S = torch.exp2(laC).transpose(-1, -2) * S + _mm(
            kA.transpose(-1, -2), vc, tf32_split)
    out = torch.cat(outs, 2) if outs else torch.zeros(B, H, 0, hd,
                                                      device=r.device)
    return out.permute(0, 2, 1, 3).contiguous(), S
