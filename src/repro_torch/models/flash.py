"""The forward of the reference's flash-style attention
(``repro.models.flash``), in plain torch.

The reference's ``Ctx.flash`` defaults to True, so its prefill of a
global attention layer runs this forward: per query chunk (a divisor of
the sequence length, so no padding), logits over the full key range in
f32, an unnormalised ``exp(logits - max)`` cast to the value dtype for the
product with ``v``, and one division by the row sum.  It is
mathematically the query-chunked softmax of
:func:`repro_torch.models.attention.chunked_attention` with its own
rounding.  The custom VJP that gives the reference's version its name
serves training and waits with it (ROADMAP A.7).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pick_chunk(T: int, chunk: int) -> int:
    """The largest divisor of ``T`` that is at most ``chunk``."""
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


def _mask_for(qpos, kpos, causal: bool, window: int):
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _chunk_fwd(qc, k, v, mask, scale: float):
    """qc [B,Hkv,G,C,hd]; k/v [B,L,Hkv,hd] -> o [B,Hkv,G,C,hd]."""
    logits = torch.einsum("bkgcd,blkd->bkgcl", qc, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgcl,blkd->bkgcd", p.to(v.dtype), v)
    return o / torch.clamp(s, min=1e-30).to(o.dtype)


def flash_attention(q, k, v, *, causal: bool, window: int, chunk: int):
    """q [B,Tq,Hq,hd] vs k/v [B,Tk,Hkv,hd] (GQA: query head ``h = kv * G +
    g``) -> o [B,Tq,Hq,hd] in ``q``'s dtype; window > 0 masks a sliding
    window."""
    B, Tq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    C = _pick_chunk(Tq, chunk)
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, Tq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, Tq, C):
        qpos = c0 + torch.arange(C, device=q.device)
        outs.append(_chunk_fwd(qg[:, :, :, c0:c0 + C], k, v,
                               _mask_for(qpos, kpos, causal, window), scale))
    o = torch.cat(outs, dim=3)                       # [B,Hkv,G,Tq,hd]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, hd).to(q.dtype)
