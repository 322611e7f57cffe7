"""Plain PyTorch versions of the DIA stencil kernels (K1-K3).

Each repeats its kernel's arithmetic operation for operation (same face
order, separate multiply and add), so on the card the kernel and its plain
version agree to rounding.  The CPU tests run these; on the card they are
the yardstick ``chip_smoke.py`` holds the kernels against.

Also here: :func:`rb_dilu_pairs`, a plain twin that walks the K2/K3
kernel's k-pairs (tests only).
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


def rb_dilu_pairs(rdiag, red, off, x, forward=True):
    """K2 (``forward``) or K3 as the CUDA kernel computes it (tests only).

    One thread per k-pair (k, k+1) of a row, k even; when nz is odd the
    row's last cell has no partner.  A pair's swept cells (K2: black, K3:
    red, read from ``red``) take a face sum of the neighbour field v (K2
    red*x*rdiag, K3 black*x) from 0 in face order -x,+x,-y,+y,-z,+z, each
    face skipped where the neighbour leaves the domain: one sum for the
    pair's first swept cell, a second for its partner only when both are
    swept.  The other cells pass through (K2 x*rdiag, K3 x).  Equal to
    :func:`rb_dilu_forward`/:func:`rb_dilu_backward` bit for bit where
    ``off`` is finite (a skipped face is the reference's off*0)."""
    nx, ny, nz = x.shape
    red = red.bool()
    swept = ~red if forward else red
    v = torch.where(red, x * rdiag, 0.0) if forward \
        else torch.where(red, 0.0, x)
    k0 = torch.arange(0, nz, 2).view(1, 1, -1)      # each pair's cell 0
    I = torch.arange(nx).view(-1, 1, 1)
    J = torch.arange(ny).view(1, -1, 1)
    has1 = k0 + 1 < nz
    k1 = (k0 + 1).clamp(max=nz - 1)
    s0 = swept[I, J, k0]
    s1 = has1 & swept[I, J, k1]

    def face_sum(kc):
        acc = torch.zeros(s0.shape, dtype=x.dtype)
        for f, (ax, d) in enumerate(NEIGHBORS):
            nb = [I, J, kc]
            nb[ax] = nb[ax] + d
            inside = (nb[ax] >= 0) & (nb[ax] < x.shape[ax])
            nb[ax] = nb[ax].clamp(0, x.shape[ax] - 1)
            acc = torch.where(inside, acc + off[f][I, J, kc] * v[tuple(nb)],
                              acc)
        return acc

    acc_b = face_sum(torch.where(s0, k0, k1))       # the first swept cell
    acc_1 = face_sum(k1)                            # used when both are

    def half(kc, is_swept, acc):
        xs, rds = x[I, J, kc], rdiag[I, J, kc]
        if forward:
            return torch.where(is_swept, (xs - acc) * rds, xs * rds)
        return torch.where(is_swept, xs - rds * acc, xs)

    out = torch.empty_like(x)
    out[:, :, 0::2] = half(k0, s0, acc_b)
    out[:, :, 1::2] = half(k1, s1, torch.where(s0, acc_1, acc_b))[
        :, :, :nz // 2]
    return out
