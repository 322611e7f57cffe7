"""Core layer ops of the port (counterpart of ``repro.models.layers``):
RMSNorm, rotary embeddings, the SwiGLU MLP, embedding and LM head.  Pure
functions of parameter dicts; ``shd(x, *logical_axes)`` is the
activation-sharding hook the reference threads through its model, the
identity (:func:`noshard`) on one device.  M-RoPE (``apply_mrope``) waits
for qwen2-vl (ROADMAP A.5.6)."""
from __future__ import annotations

import torch

from repro_torch.models.params import ParamSpec, torch_dtype


def noshard(x, *axes):
    return x


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), "float32", "ones")


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm computed in float32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def _rope_angles(positions, head_dim: int, theta: float):
    """positions [...] -> cos/sin [..., head_dim // 2] in f32, as the
    reference computes them: f32 exponents, f32 frequencies, f32 angles.

    The frequencies (``theta ** exponent``) and cos/sin are evaluated in
    f64 and rounded to f32, so every path gets the correctly rounded f32
    value: an f32 ``pow`` differs by an ulp from one library to another
    (torch's CPU ``pow`` from JAX's in 2 of 32 frequencies at head_dim
    64), and Triton's f32 cos/sin are approximations, while an angle
    reaches the position (1e3 rad in a 1024-token prompt), so one ulp of
    a frequency moves it by 6e-5 rad."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a fill on the positions' device: no host-to-device copy per call
    freqs = torch.pow(torch.full((), theta, dtype=torch.float64,
                                 device=positions.device),
                      exps.double()).float()
    ang = (positions.float()[..., None] * freqs).double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x, positions, theta: float):
    """x [B, T, H, hd]; positions [B, T] (ints).  Rotate-half convention,
    computed in f32 and returned in ``x``'s dtype."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)   # [B,T,half]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_specs(cfg) -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "ff"), pd),
        "wi_up": ParamSpec((d, f), ("embed", "ff"), pd),
        "wo": ParamSpec((f, d), ("ff", "embed"), pd),
    }


def mlp(p, x, shd=noshard):
    """Dense SwiGLU MLP; silu in float32."""
    h = shd(x @ p["wi_gate"], "batch", None, "ff")
    u = x @ p["wi_up"]
    h = torch.nn.functional.silu(h.float()).to(x.dtype) * u
    return shd(h @ p["wo"], "batch", None, None)


def embed_specs(cfg) -> dict:
    s = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                          cfg.param_dtype, scale=1.0)}
    if not cfg.tie_embeddings:
        s["head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                              cfg.param_dtype)
    return s


def embed(p, tokens, cfg, shd=noshard):
    """tokens [B, T] (int32 or int64) -> [B, T, d] in the compute dtype."""
    x = p["tok"][tokens].to(torch_dtype(cfg.compute_dtype))
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype) ** 0.5
    return shd(x, "batch", None, None)


def lm_logits(p, x, cfg, shd=noshard):
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return shd(x @ w.to(x.dtype), "batch", None, "vocab")
