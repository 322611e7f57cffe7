"""Attention mixers of the port (counterpart of ``repro.models.attention``):
global and sliding-window causal self-attention with RoPE and grouped
query heads, for prefill and decode.

Prefill uses *query-chunked* attention (a loop over query chunks: logits
never materialise beyond ``[B, Hkv, G, chunk, Tk]``), and sliding-window
layers slice a banded KV strip.  Decode attends a preallocated KV cache
(a ring buffer for local layers) that holds, per slot, the absolute
position written there (-1 = empty).  Under ``Ctx.flash`` (the
reference's default) a prefill without a useful band runs the forward of
``repro.models.flash`` instead (:mod:`repro_torch.models.flash`).

The reference writes a decode token with ``dynamic_update_slice`` at a
traced position; the port selects the slot with ``torch.where`` over the
slot axis, so a compiled decode step takes the position as a tensor
input (no graph break, no compile per position): 0-d, or one per row
when the rows of a batch sit at their own positions (an engine tick's
slots).  Unlike
``dynamic_update_slice``, which clamps an index past the end, a position
beyond the cache writes nothing; the serve path sizes the cache to the
prompt plus the generated tokens.

Training (:func:`attn_train`) runs the same attention over the whole
sequence, through the flash forward and its custom VJP
(:func:`repro_torch.models.flash.make_flash_attention`) under
``Ctx.flash``.

Plain torch throughout: the reference has no Pallas kernel here.
Cross-attention waits (ROADMAP A.5.7).
"""
from __future__ import annotations

import torch

from repro_torch.models.flash import flash_attention, make_flash_attention
from repro_torch.models.layers import apply_rope, noshard
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def attn_specs(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.param_dtype
    s = {
        "wq": ParamSpec((d, hq, hd), ("embed", "q_heads", "head_dim"), pd),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), pd),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), pd),
        "wo": ParamSpec((hq, hd, d), ("q_heads", "head_dim", "embed"), pd),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((hq, hd), ("q_heads", "head_dim"), pd, "zeros")
        s["bk"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), pd, "zeros")
        s["bv"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), pd, "zeros")
    return s


def qkv(p, x, cfg, shd=noshard):
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = shd(q, "batch", None, "q_heads", None)
    k = shd(k, "batch", None, "kv_heads", None)
    v = shd(v, "batch", None, "kv_heads", None)
    return q, k, v


def out_proj(p, o, shd=noshard):
    return shd(torch.einsum("bthk,hkd->btd", o, p["wo"]), "batch", None, None)


# ---------------------------------------------------------------------------
# Core chunked attention (prefill)
# ---------------------------------------------------------------------------

def _grouped_logits(qc, k):
    """qc [B,C,Hq,hd], k [B,L,Hkv,hd] -> logits [B,Hkv,G,C,L] (GQA grouped:
    query head ``h = kv * G + g``), divided by sqrt(hd) in ``qc``'s
    dtype."""
    B, C, Hq, hd = qc.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = qc.reshape(B, C, Hkv, G, hd)
    scale = torch.full((), hd, dtype=torch.float32,
                       device=qc.device).sqrt().to(qc.dtype)
    return torch.einsum("bckgd,blkd->bkgcl", qg, k) / scale


def _attend(qc, k, v, mask):
    """mask [C, L] boolean (True = keep) or None.  Returns [B,C,Hq,hd]."""
    logits = _grouped_logits(qc, k).float()
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    B, Hkv, G, C, L = w.shape
    o = torch.einsum("bkgcl,blkd->bckgd", w, v)
    return o.reshape(B, C, Hkv * G, o.shape[-1])


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 512, shd=noshard):
    """q [B,Tq,Hq,hd] vs k/v [B,Tk,Hkv,hd]; q and k share position origin 0.

    window > 0 => sliding-window causal attention over a banded KV strip.
    A ragged last chunk is padded with zero queries and cut off after."""
    B, Tq, Hq, hd = q.shape
    Tk = k.shape[1]
    chunk = min(chunk, Tq)
    n = -(-Tq // chunk)
    if Tq % chunk:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, n * chunk - Tq))
    banded = window > 0 and (window + chunk) < Tk
    L = min(Tk, chunk + window) if banded else Tk
    outs = []
    for ci in range(n):
        c0 = ci * chunk
        qc = q[:, c0:c0 + chunk]
        qpos = c0 + torch.arange(chunk, device=q.device)
        if banded:
            start = min(max(c0 + chunk - L, 0), Tk - L)
            kc, vc = k[:, start:start + L], v[:, start:start + L]
            kpos = start + torch.arange(L, device=q.device)
        else:
            kc, vc, kpos = k, v, torch.arange(Tk, device=q.device)
        mask = None
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
        outs.append(_attend(qc, kc, vc, mask))
    return torch.cat(outs, dim=1)[:, :Tq]


# ---------------------------------------------------------------------------
# Decode (one new token against a preallocated cache)
# ---------------------------------------------------------------------------

def cache_specs(cfg, kind: str, batch: int, s_max: int) -> dict:
    """Abstract cache layout for one attention layer."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    slots = min(s_max, cfg.window) if kind == "attn_local" else s_max
    return {
        "k": ParamSpec((batch, slots, hkv, hd),
                       ("batch", "kv_seq", "kv_heads", None),
                       cfg.compute_dtype, "zeros"),
        "v": ParamSpec((batch, slots, hkv, hd),
                       ("batch", "kv_seq", "kv_heads", None),
                       cfg.compute_dtype, "zeros"),
        "pos": ParamSpec((slots,), (None,), "int32", "zeros"),
    }


def _row_mask(m, shape):
    """A mask of the slots, ``[slots]`` (every row) or ``[B, slots]`` (one
    per row), reshaped to ``shape`` (``-1`` at the slot axis, 1 elsewhere)
    with the batch axis first."""
    lead = m.shape[0] if m.dim() == 2 else 1
    return m.reshape(lead, *shape[1:])


def decode_attend(q1, ck, cv, cpos, pos, *, window: int = 0, shd=noshard):
    """q1 [B,1,Hq,hd]; the cache already holds the current token at its
    slot.  ``cpos`` [slots] (shared by the rows) or [B, slots] int32 holds
    the absolute position in each slot (-1 = empty); ``pos`` is 0-d or one
    per row [B].  Masks, per row: slot valid, <= pos, and within the
    window if local.  Logits in f32."""
    hd = q1.shape[-1]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=cpos.device)[..., None]
    valid = (cpos >= 0) & (cpos <= pos)
    if window > 0:
        valid &= cpos > pos - window
    logits = _grouped_logits(q1, ck).float()           # [B,Hkv,G,1,slots]
    logits = torch.where(_row_mask(valid, (1, 1, 1, 1, -1)), logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(cv.dtype)
    B, Hkv, G, _, L = w.shape
    o = torch.einsum("bkgcl,blkd->bckgd", w, cv)
    return o.reshape(B, 1, Hkv * G, hd)


def cache_insert(cache, k1, v1, pos, *, window: int = 0):
    """Write the current token's k/v at slot ``pos`` (the ring slot
    ``pos % slots`` for a local layer); ``pos`` is an int or a 0-d integer
    tensor on the cache's device (every row at one position), or one
    position per row [B], each row writing its own slot; then the slot
    positions come back per row, [B, slots]."""
    slots = cache["k"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache["k"].device)
    slot = pos % slots if window > 0 else pos
    hit = torch.arange(slots, device=cache["k"].device) == slot[..., None]
    at = _row_mask(hit, (1, -1, 1, 1))
    ck = torch.where(at, k1.to(cache["k"].dtype), cache["k"])
    cv = torch.where(at, v1.to(cache["v"].dtype), cache["v"])
    cpos = torch.where(hit, pos[..., None], cache["pos"])
    return {**cache, "k": ck, "v": cv, "pos": cpos}


def cache_fill_prefill(cache, k, v, *, window: int = 0):
    """Bulk-load prefill K/V into the cache (the last ``slots`` tokens, at
    their ring slots, for a local layer whose prompt outgrows it)."""
    slots = cache["k"].shape[1]
    T = k.shape[1]
    dev = cache["k"].device
    if window > 0 and T > slots:
        tail_pos = torch.arange(T - slots, T, device=dev)
        ring_slot = tail_pos % slots
        ck = cache["k"].index_copy(1, ring_slot,
                                   k[:, -slots:].to(cache["k"].dtype))
        cv = cache["v"].index_copy(1, ring_slot,
                                   v[:, -slots:].to(cache["v"].dtype))
        cpos = cache["pos"].index_copy(0, ring_slot,
                                       tail_pos.to(torch.int32))
    else:
        if T > slots:
            raise ValueError(f"prompt of {T} tokens does not fit a cache of "
                             f"{slots} slots")
        ck = torch.cat([k.to(cache["k"].dtype), cache["k"][:, T:]], dim=1)
        cv = torch.cat([v.to(cache["v"].dtype), cache["v"][:, T:]], dim=1)
        idx = torch.arange(slots, device=dev)
        cpos = torch.where(idx < T, idx, -1).to(torch.int32)
    return {**cache, "k": ck, "v": cv, "pos": cpos}


# ---------------------------------------------------------------------------
# Full mixer (projection + rope + attend) for prefill and decode
# ---------------------------------------------------------------------------

def rope_q_k(cfg, q, k, positions):
    """RoPE on q and k (M-RoPE waits for qwen2-vl, ROADMAP A.5.6)."""
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _mix_attend(q, k, v, *, kind: str, cfg, ctx):
    """Route between the flash forward (global layers, ``Ctx.flash``) and
    the query-chunked baseline (local layers whose band keeps compute
    sub-quadratic, or ``Ctx(flash=False)``)."""
    causal = kind != "attn_enc"
    window = cfg.window if kind == "attn_local" else 0
    T = q.shape[1]
    chunk = min(ctx.q_chunk, T)
    banded_useful = window > 0 and (window + chunk) < k.shape[1]
    if ctx.flash and not banded_useful:
        if ctx.mode == "train":             # the custom VJP
            return make_flash_attention(causal, window, chunk)(q, k, v)
        return flash_attention(q, k, v, causal=causal, window=window,
                               chunk=chunk)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=chunk, shd=ctx.shd)


def attn_train(p, x, cfg, *, kind: str, ctx):
    """Training forward: attention over the sequence at positions
    ``arange(T)``, no cache (differentiable; the flash VJP under
    ``Ctx.flash``)."""
    shd = ctx.shd
    q, k, v = qkv(p, x, cfg, shd)
    B, T = x.shape[:2]
    pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
    q, k = rope_q_k(cfg, q, k, pos)
    o = _mix_attend(q, k, v, kind=kind, cfg=cfg, ctx=ctx)
    return out_proj(p, o, shd)


def attn_prefill(p, x, cfg, *, kind: str, ctx, cache):
    """Prefill: attention over the prompt, and the KV cache filled."""
    shd = ctx.shd
    q, k, v = qkv(p, x, cfg, shd)
    B, T = x.shape[:2]
    pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
    q, k = rope_q_k(cfg, q, k, pos)
    window = cfg.window if kind == "attn_local" else 0
    o = _mix_attend(q, k, v, kind=kind, cfg=cfg, ctx=ctx)
    cache = cache_fill_prefill(cache, k, v, window=window)
    return out_proj(p, o, shd), cache


def attn_decode(p, x1, cfg, *, kind: str, ctx, cache):
    """x1 [B,1,d]; ``ctx.pos`` is the absolute position of this token (an
    int or a 0-d integer tensor), or of each row's token ([B]: RoPE's
    angles, the slot written and the mask per row)."""
    shd = ctx.shd
    q, k, v = qkv(p, x1, cfg, shd)
    B = x1.shape[0]
    pos = torch.as_tensor(ctx.pos, dtype=torch.int32, device=x1.device)
    q, k = rope_q_k(cfg, q, k, pos.reshape(-1, 1).expand(B, 1))
    window = cfg.window if kind == "attn_local" else 0
    cache = cache_insert(cache, k, v, pos, window=window)
    o = decode_attend(q, cache["k"], cache["v"], cache["pos"], pos,
                      window=window, shd=shd)
    return out_proj(p, o, shd), cache
