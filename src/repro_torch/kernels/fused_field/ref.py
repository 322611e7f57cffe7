"""Plain PyTorch versions of the fused field macros (K4).

Scalars are rounded to the output dtype first, as the Pallas wrapper does
(``jnp.asarray(s, out_dtype)``), then the expression is evaluated left to
right with separate multiply and add — the kernel's order.
"""
from __future__ import annotations

import torch


def cast_scalar(a: float, dtype: torch.dtype) -> float:
    """``a`` rounded to ``dtype`` (host-side; no device work)."""
    return torch.tensor(a, dtype=dtype).item()


def fused_axpy(a, x, y):
    return y + cast_scalar(a, x.dtype) * x


def fused_xpay(a, x, y):
    return x + cast_scalar(a, x.dtype) * y


def fused_mul(x, y):
    return x * y


def fused_axpbypz(a, x, b, y, z):
    return z + cast_scalar(a, x.dtype) * x + cast_scalar(b, x.dtype) * y
