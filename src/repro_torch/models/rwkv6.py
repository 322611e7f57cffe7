"""RWKV6 "Finch" time-mix of the port: data-dependent per-channel decay
linear attention (counterpart of ``repro.models.rwkv6``).

Semantics (the sequential oracle, per head; r,k,w,u in R^dk, v in R^dv):

    out_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

Prefill uses a *chunked* closed form in which every exponent is a
cumulative-decay difference with t >= i, hence <= 0:

    la_t   = cumsum(log w)                (within chunk, la_0 = 0)
    inter  = (r_t * exp(la_{t-1})) @ S_in
    intra  = sum_{i<t} [sum_d r_t k_i exp(la_{t-1,d} - la_{i,d})] v_i
           + (r_t . (u*k_t)) v_t
    S_out  = diag(exp(la_C)) S_in + sum_i (k_i * exp(la_C - la_i)) v_i^T

The scan is the region :data:`RWKV6_SCAN` with three variants: ``ref``
(sequential oracle), ``chunked`` (closed form) and ``hopper`` (the
hand-written CUDA kernel K5, ``repro_torch/kernels/csrc/rwkv6_scan.cu``,
which starts from ``S_in`` itself).  :func:`rwkv_train` picks one by name
(``impl=``); with ``impl=None`` it runs :func:`rwkv_chunk`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.regions import region
from repro_torch.models.layers import noshard, rmsnorm
from repro_torch.models.params import ParamSpec

LORA_R = 32  # rank of the ddlerp / decay adapters


def rwkv_specs(cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    pd = cfg.param_dtype
    adapters = {}
    for nm in ("r", "k", "v", "g", "w"):
        adapters[f"mu_{nm}"] = ParamSpec((d,), ("embed",), "float32", "zeros")
        adapters[f"A_{nm}"] = ParamSpec((d, LORA_R), ("embed", None), pd)
        adapters[f"B_{nm}"] = ParamSpec((LORA_R, d), (None, "embed"), pd, "zeros")
    return {
        **adapters,
        "wr": ParamSpec((d, H, hd), ("embed", "q_heads", "head_dim"), pd),
        "wk": ParamSpec((d, H, hd), ("embed", "q_heads", "head_dim"), pd),
        "wv": ParamSpec((d, H, hd), ("embed", "q_heads", "head_dim"), pd),
        "wg": ParamSpec((d, H, hd), ("embed", "q_heads", "head_dim"), pd),
        "w0": ParamSpec((H, hd), ("q_heads", "head_dim"), "float32", "rwkv_decay"),
        "u": ParamSpec((H, hd), ("q_heads", "head_dim"), "float32", "zeros"),
        "ln_out": ParamSpec((H, hd), ("q_heads", "head_dim"), "float32", "ones"),
        "wo": ParamSpec((H, hd, d), ("q_heads", "head_dim", "embed"), pd),
    }


def rwkv_state_specs(cfg, batch: int) -> dict:
    H, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    return {
        "S": ParamSpec((batch, H, hd, hd), ("batch", "q_heads", None, None),
                       "float32", "zeros"),
        "x_prev": ParamSpec((batch, d), ("batch", None), cfg.compute_dtype,
                            "zeros"),
    }


def _ddlerp(p, nm, x, x_prev):
    """Data-dependent token-shift lerp (RWKV6): x + (x_prev - x) * mix."""
    # the reference's XLA keeps this bf16 difference unrounded in f32 (it
    # fuses the subtraction into the f32 math that reads it; ROADMAP C.2)
    dx = x_prev.float() - x.float()
    base = x.float() + dx * p[f"mu_{nm}"]
    A, B = p[f"A_{nm}"], p[f"B_{nm}"]
    lora = torch.tanh(base.to(A.dtype) @ A) @ B
    mix = p[f"mu_{nm}"] + lora.float()
    return (x.float() + dx * mix).to(x.dtype)


def _heads(x, w):
    """einsum("btd,dhk->bthk"): x [B,T,d] @ w [d,H,hd]."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).reshape(*x.shape[:2], H, hd)


def _projections(p, x, x_prev, cfg):
    """Token-shifted projections. x [B,T,d]; x_prev [B,T,d] (shifted input)."""
    r = _heads(_ddlerp(p, "r", x, x_prev), p["wr"])
    k = _heads(_ddlerp(p, "k", x, x_prev), p["wk"])
    v = _heads(_ddlerp(p, "v", x, x_prev), p["wv"])
    g = _heads(_ddlerp(p, "g", x, x_prev), p["wg"])
    xw = _ddlerp(p, "w", x, x_prev).float()
    wlora = torch.tanh(xw.to(p["A_w"].dtype) @ p["A_w"]) @ p["B_w"]
    dproj = wlora.float().reshape(*x.shape[:2], cfg.n_heads, cfg.hd)
    logw = -torch.exp(torch.clamp(p["w0"] + dproj, -8.0, 6.0))  # log-decay <= 0
    logw = torch.clamp(logw, min=-12.0)                           # floor
    return r, k, v, g, logw


def rwkv_chunk(r, k, v, logw, u, S_in, chunk: int):
    """Chunked linear-attention scan over the T axis.

    r,k,v [B,T,H,hd] (compute dtype); logw [B,T,H,hd] f32; u [H,hd] f32;
    S_in [B,H,hd,hd] f32.  Returns (out [B,T,H,hd] f32, S_out).
    """
    B, T, H, hd = r.shape
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"T={T} is not a multiple of the chunk {C}")
    causal = torch.arange(C, device=r.device)
    mask = (causal[:, None] > causal[None, :])[None, :, :, None, None]
    eye = torch.eye(C, device=r.device)[None, :, :, None]
    S = S_in
    outs = []
    for c0 in range(0, T, C):
        rc, kc, vc = (a[:, c0:c0 + C].float() for a in (r, k, v))
        lwc = logw[:, c0:c0 + C]                       # [B,C,H,hd]
        la = torch.cumsum(lwc, dim=1)                  # la_t, t=1..C
        la_prev = la - lwc                             # la_{t-1}
        inter = torch.einsum("bthi,bhij->bthj", rc * torch.exp(la_prev), S)
        # intra: pairwise decay differences (exponent <= 0 where unmasked)
        D = la_prev[:, :, None] - la[:, None, :]       # [B,C(t),C(i),H,hd]
        D = torch.where(mask, D, -torch.inf)
        att = torch.einsum("bthd,bihd,btihd->btih", rc, kc, torch.exp(D))
        diag = torch.einsum("bthd,bthd,hd->bth", rc, kc, u)
        att = att + diag[:, :, None] * eye
        outs.append(inter + torch.einsum("btih,bihj->bthj", att, vc))
        la_C = la[:, -1]                               # [B,H,hd]
        kA = kc * torch.exp(la_C[:, None] - la)
        S = torch.exp(la_C)[..., None] * S + torch.einsum(
            "bthi,bthj->bhij", kA, vc)
    return torch.cat(outs, dim=1), S


def rwkv_ref_scan(r, k, v, logw, u, S_in):
    """Sequential oracle: one token at a time from state ``S_in``."""
    S = S_in
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = (a[:, t].float() for a in (r, k, v, logw))
        out = (rt[..., None, :] @ S)[..., 0, :] + \
            (rt * u * kt).sum(-1, keepdim=True) * vt
        S = torch.exp(lwt)[..., None] * S + kt[..., None] * vt[..., None, :]
        outs.append(out)
    return torch.stack(outs, dim=1), S


# ---------------------------------------------------------------------------
# The scan as ONE region with declared implementation variants
# ---------------------------------------------------------------------------

def _chunk_size(T: int, cap: int = 64) -> int:
    """Largest chunk <= cap that divides T."""
    return max(c for c in range(1, min(cap, T) + 1) if T % c == 0)


@region("rwkv6(scan)")
def RWKV6_SCAN(r, k, v, logw, u, S_in):
    """Time-mix scan from state ``S_in`` — the ``ref`` variant is the
    sequential oracle (exact recurrence, one token at a time)."""
    return rwkv_ref_scan(r, k, v, logw, u, S_in)


@RWKV6_SCAN.variant("chunked")
def _scan_chunked(r, k, v, logw, u, S_in):
    return rwkv_chunk(r, k, v, logw, u, S_in, _chunk_size(r.shape[1]))


@RWKV6_SCAN.variant("hopper")
def _scan_hopper(r, k, v, logw, u, S_in):
    # K5 takes S_in as its initial state, so the superposition pass of the
    # reference's ``pallas`` variant (a second [B,T,H,hd]x[hd,hd] product
    # and a running decay sum over all of T) is not needed
    from repro_torch.kernels.rwkv6_scan import kernel as K
    return K.rwkv6_scan(r, k, v, logw, u, S_in)


def rwkv_train(p, x, cfg, *, ctx, state=None, chunk: int = 64,
               impl: Optional[str] = None):
    """Full-sequence time-mix (train and prefill).  Returns (y, new_state).

    ``impl`` names a registered variant of :data:`RWKV6_SCAN` (``ref`` /
    ``chunked`` / ``hopper``); the default keeps the chunked closed form
    with the caller's ``chunk``, which is also the train path (plain
    torch, differentiable).  ``hopper`` has no backward: asked for a
    gradient, it raises.
    """
    B, T, d = x.shape
    x_prev_tok = state["x_prev"] if state is not None else \
        torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_shift = torch.cat([x_prev_tok[:, None], x[:, :-1]], dim=1)
    r, k, v, g, logw = _projections(p, x, x_shift, cfg)
    S_in = state["S"] if state is not None else torch.zeros(
        (B, cfg.n_heads, cfg.hd, cfg.hd), dtype=torch.float32, device=x.device)
    if impl is None:
        out, S_out = rwkv_chunk(r, k, v, logw, p["u"], S_in, chunk)
    else:
        if impl == "hopper" and torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, logw)):
            raise NotImplementedError(
                "the hopper variant of RWKV6_SCAN (K5) has no backward "
                "(ROADMAP B.3); train with impl=None, the chunked closed "
                "form, as the reference does")
        scan = RWKV6_SCAN.impl_fn(RWKV6_SCAN.resolve(impl))
        out, S_out = scan(r, k, v, logw, p["u"], S_in)
    y = _gate_out(p, out, g, x, cfg)
    y = ctx.shd(y, "batch", None, None)
    # a copy: the slice of a view would keep all of x alive in the state
    return y, {"S": S_out, "x_prev": x[:, -1].clone()}


def _gate_out(p, out, g, x, cfg):
    """Per-head groupnorm, output gate and output projection."""
    B, T = x.shape[:2]
    ones = torch.ones((cfg.hd,), dtype=torch.float32, device=x.device)
    out = rmsnorm(out.reshape(B, T, cfg.n_heads, cfg.hd), ones) * \
        p["ln_out"].to(out.dtype)
    out = out.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    return out.reshape(B, T, -1) @ p["wo"].reshape(-1, cfg.d_model)


def rwkv_decode(p, x1, cfg, *, ctx, state):
    """Single-token step: O(1) in sequence length. x1 [B,1,d]."""
    x_shift = state["x_prev"][:, None]
    r, k, v, g, logw = _projections(p, x1, x_shift, cfg)
    out, S_out = rwkv_ref_scan(r, k, v, logw, p["u"], state["S"])
    y = _gate_out(p, out, g, x1, cfg)
    return y, {"S": S_out, "x_prev": x1[:, 0]}


# ---------------------------------------------------------------------------
# RWKV channel-mix (the MLP of rwkv layers)
# ---------------------------------------------------------------------------

def channelmix_specs(cfg) -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mu_k": ParamSpec((d,), ("embed",), "float32", "zeros"),
        "mu_r": ParamSpec((d,), ("embed",), "float32", "zeros"),
        "wk": ParamSpec((d, f), ("embed", "ff"), pd),
        "wv": ParamSpec((f, d), ("ff", "embed"), pd),
        "wr": ParamSpec((d, d), ("embed", "embed2"), pd),
    }


def channelmix(p, x, x_shift, cfg, shd=noshard):
    xf, sf = x.float(), x_shift.float()
    xk = (xf + (sf - xf) * p["mu_k"]).to(x.dtype)
    xr = (xf + (sf - xf) * p["mu_r"]).to(x.dtype)
    k = torch.square(torch.relu((xk @ p["wk"]).float())).to(x.dtype)
    k = shd(k, "batch", None, "ff")
    r = torch.sigmoid((xr @ p["wr"]).float())
    y = r.to(x.dtype) * (k @ p["wv"])
    return shd(y, "batch", None, None)
