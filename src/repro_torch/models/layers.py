"""Core layer ops of the port (counterpart of ``repro.models.layers``):
RMSNorm, the SwiGLU MLP, embedding and LM head.  Pure functions of
parameter dicts; ``shd(x, *logical_axes)`` is the activation-sharding
hook the reference threads through its model, the identity
(:func:`noshard`) on one device.  RoPE waits for the attention slice
(ROADMAP A.7)."""
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
