"""Flash-style attention with a custom VJP (counterpart of
``repro.models.flash``), in plain torch.

The forward, per query chunk (a divisor of the sequence length, so no
padding): logits over the full key range in f32, an unnormalised
``exp(logits - max)`` cast to the value dtype for the product with ``v``,
one division by the row sum, and the row's log-sum-exp ``lse``.  It is
mathematically the query-chunked softmax of
:func:`repro_torch.models.attention.chunked_attention` with its own
rounding; the reference's ``Ctx.flash`` defaults to True, so its prefill
and training of a global attention layer run it.

The backward (:class:`FlashAttention`) saves only ``(q, k, v, o, lse)``
and recomputes each chunk's probabilities from ``lse``: no ``T x T``
matrix is kept, at the cost of one more ``Q K^T`` product.  It is the
reference's ``bwd``, chunk by chunk in the same order: ``dv`` and ``dk``
accumulate over the query chunks in f32, ``dq`` per chunk.  The class
defines ``setup_context``, so ``torch.func`` transforms (a compiled
layer VJP) trace through it.
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


def _logits(qc, k, mask, scale: float):
    """f32 logits [B,Hkv,G,C,L] of qc [B,Hkv,G,C,hd] against k [B,L,Hkv,hd],
    masked."""
    logits = torch.einsum("bkgcd,blkd->bkgcl", qc, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    return logits


def _chunk_fwd(qc, k, v, mask, scale: float):
    """qc [B,Hkv,G,C,hd]; k/v [B,L,Hkv,hd] -> (o [B,Hkv,G,C,hd], lse
    [B,Hkv,G,C])."""
    logits = _logits(qc, k, mask, scale)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgcl,blkd->bkgcd", p.to(v.dtype), v)
    o = o / torch.clamp(s, min=1e-30).to(o.dtype)
    lse = (m + torch.log(torch.clamp(s, min=1e-30)))[..., 0]
    return o, lse


def _grouped(q, Hkv: int):
    """[B,T,Hq,hd] -> [B,Hkv,G,T,hd] (query head ``h = kv * G + g``)."""
    B, T, Hq, hd = q.shape
    return q.reshape(B, T, Hkv, Hq // Hkv, hd).permute(0, 2, 3, 1, 4)


def _ungrouped(o):
    """[B,Hkv,G,T,hd] -> [B,T,Hkv*G,hd]."""
    B, Hkv, G, T, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hkv * G, hd)


def flash_forward(q, k, v, causal: bool, window: int, chunk: int):
    """q [B,Tq,Hq,hd] vs k/v [B,Tk,Hkv,hd] -> (o [B,Tq,Hq,hd] in ``q``'s
    dtype, lse [B,Hkv,G,Tq] f32)."""
    Tq, hd = q.shape[1], q.shape[-1]
    C = _pick_chunk(Tq, chunk)
    scale = 1.0 / (hd ** 0.5)
    qg = _grouped(q, k.shape[2])
    kpos = torch.arange(k.shape[1], device=q.device)
    outs, lses = [], []
    for c0 in range(0, Tq, C):
        qpos = c0 + torch.arange(C, device=q.device)
        o, lse = _chunk_fwd(qg[:, :, :, c0:c0 + C], k, v,
                            _mask_for(qpos, kpos, causal, window), scale)
        outs.append(o)
        lses.append(lse)
    o = _ungrouped(torch.cat(outs, dim=3)).to(q.dtype)
    return o, torch.cat(lses, dim=3)


def flash_backward(q, k, v, o, lse, do, causal: bool, window: int,
                   chunk: int):
    """The reference's chunked backward: (dq, dk, dv) in the dtypes of
    (q, k, v)."""
    Tq, hd = q.shape[1], q.shape[-1]
    Hkv = k.shape[2]
    C = _pick_chunk(Tq, chunk)
    scale = 1.0 / (hd ** 0.5)
    qg = _grouped(q, Hkv)
    og = _grouped(o, Hkv)
    dog = _grouped(do.float(), Hkv)
    delta = torch.sum(dog * og.float(), dim=-1)          # [B,Hkv,G,Tq]
    kf, vf = k.float(), v.float()
    kpos = torch.arange(k.shape[1], device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for c0 in range(0, Tq, C):
        qc = qg[:, :, :, c0:c0 + C]
        doc = dog[:, :, :, c0:c0 + C]
        qpos = c0 + torch.arange(C, device=q.device)
        logits = _logits(qc, k, _mask_for(qpos, kpos, causal, window), scale)
        p = torch.exp(logits - lse[:, :, :, c0:c0 + C, None])
        dv = dv + torch.einsum("bkgcl,bkgcd->blkd", p, doc)
        dp = torch.einsum("bkgcd,blkd->bkgcl", doc, vf)
        ds = p * (dp - delta[:, :, :, c0:c0 + C, None]) * scale
        dqs.append(torch.einsum("bkgcl,blkd->bkgcd", ds, kf))
        dk = dk + torch.einsum("bkgcl,bkgcd->blkd", ds, qc.float())
    dq = _ungrouped(torch.cat(dqs, dim=3))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``flash(q, k, v)`` with the reference's custom VJP: the forward
    returns ``(o, lse)`` (``lse`` not differentiable) and the backward
    recomputes the probabilities from ``lse`` (the module docstring)."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: int, chunk: int):
        return flash_forward(q, k, v, causal, window, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, chunk = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.cfg = (causal, window, chunk)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None


def make_flash_attention(causal: bool, window: int, chunk: int):
    """``flash(q, k, v)`` for q, k, v [B,T{q,k},H{q,kv},hd], GQA-grouped;
    ``window > 0`` masks a sliding window.  Differentiable through
    :class:`FlashAttention`."""
    def flash(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, chunk)[0]
    return flash


def flash_attention(q, k, v, *, causal: bool, window: int, chunk: int):
    """The flash forward alone: o [B,Tq,Hq,hd] in ``q``'s dtype."""
    return flash_forward(q, k, v, causal, window, chunk)[0]
