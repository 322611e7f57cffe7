"""Plain PyTorch versions of the DIA stencil kernels (K1-K3).

Each repeats its kernel's arithmetic operation for operation (same face
order, separate multiply and add), so on the card the kernel and its plain
version agree to rounding.  The CPU tests run these; on the card they are
the yardstick ``chip_smoke.py`` holds the kernels against.
"""
from __future__ import annotations

import torch

from repro_torch.cfd.grid import NEIGHBORS, shift


def _face_sum(acc, off, v):
    for f, (ax, d) in enumerate(NEIGHBORS):
        acc = acc + off[f] * shift(v, ax, d)
    return acc


def stencil_spmv(diag, off, x):
    """y = diag*x + sum_f off[f]*x[nb_f]  (zero outside the domain)."""
    return _face_sum(diag * x, off, x)


def rb_dilu_forward(rdiag, red, off, r):
    """w = red ? r*rdiag : (r - sum_f off[f]*(red*r*rdiag)[nb_f]) * rdiag."""
    y_r = torch.where(red, r * rdiag, 0.0)
    acc = _face_sum(torch.zeros_like(r), off, y_r)
    return torch.where(red, y_r, (r - acc) * rdiag)


def rb_dilu_backward(rdiag, red, off, y):
    """z = red ? y - rdiag * sum_f off[f]*(black*y)[nb_f] : y."""
    y_b = torch.where(red, 0.0, y)
    acc = _face_sum(torch.zeros_like(y), off, y_b)
    return torch.where(red, y - rdiag * acc, y)


def rb_dilu(rdiag, red, off, r):
    """Full red-black DILU apply: forward then backward half-sweep."""
    return rb_dilu_backward(rdiag, red, off,
                            rb_dilu_forward(rdiag, red, off, r))
