"""Wrappers of the hand-written CUDA stencil kernels (``csrc/stencil.cu``).

Replaces ``src/repro/kernels/stencil_spmv/kernel.py`` of the JAX package:
``stencil_spmv`` (K1), ``rb_dilu_forward`` (K2), ``rb_dilu_backward`` (K3)
and their composition ``rb_dilu``.  All three are bound by HBM bytes (36-37
B per cell, ~0.4 flop/B); the kernels make one coalesced pass and read no
padded copy (see the note in the CUDA source).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  Given CPU tensors it runs the plain version (``ref.py``);
given CUDA tensors it launches its kernel on the current stream without
synchronising, or raises.  ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stencil_spmv import ref

#: kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = {"stencil_spmv": 0, "rb_dilu_forward": 0, "rb_dilu_backward": 0}


def _check(name, fields, off, red=None):
    """Validate operands; returns the shared device."""
    shape3 = fields[0].shape
    if len(shape3) != 3:
        raise ValueError(f"{name}: fields must be 3-D, got {tuple(shape3)}")
    tensors = list(fields) + [off] + ([red] if red is not None else [])
    dev = fields[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in fields + (off,):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    for t in fields:
        if t.shape != shape3:
            raise ValueError(f"{name}: field shapes {tuple(t.shape)} and "
                             f"{tuple(shape3)} differ")
    if off.shape != (6, *shape3):
        raise ValueError(f"{name}: off must be (6, *{tuple(shape3)}), got "
                         f"{tuple(off.shape)}")
    if red is not None and (red.dtype not in (torch.bool, torch.uint8)
                            or red.shape != shape3):
        raise TypeError(f"{name}: red must be a bool/uint8 {tuple(shape3)} "
                        f"mask, got {red.dtype} {tuple(red.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def stencil_spmv(diag, off, x):
    """diag [nx,ny,nz]; off [6,nx,ny,nz]; x [nx,ny,nz] -> y = A x."""
    if _check("stencil_spmv", (diag, x), off).type == "cpu":
        return ref.stencil_spmv(diag, off, x)
    y = torch.empty_like(x)
    if x.numel():
        build.launch("stencil_spmv_f32", (diag, off, x, y), x.shape)
        LAUNCHES["stencil_spmv"] += 1
    return y


def rb_dilu_forward(rdiag, red, off, r):
    """Forward half-sweep of the red-black DILU (K2)."""
    if _check("rb_dilu_forward", (rdiag, r), off, red).type == "cpu":
        return ref.rb_dilu_forward(rdiag, red, off, r)
    w = torch.empty_like(r)
    if r.numel():
        build.launch("rb_dilu_forward_f32", (rdiag, red, off, r, w), r.shape)
        LAUNCHES["rb_dilu_forward"] += 1
    return w


def rb_dilu_backward(rdiag, red, off, y):
    """Backward half-sweep of the red-black DILU (K3)."""
    if _check("rb_dilu_backward", (rdiag, y), off, red).type == "cpu":
        return ref.rb_dilu_backward(rdiag, red, off, y)
    z = torch.empty_like(y)
    if y.numel():
        build.launch("rb_dilu_backward_f32", (rdiag, red, off, y, z), y.shape)
        LAUNCHES["rb_dilu_backward"] += 1
    return z


def rb_dilu(rdiag, red, off, r):
    """w = M^-1 r: the forward then the backward half-sweep."""
    return rb_dilu_backward(rdiag, red, off,
                            rb_dilu_forward(rdiag, red, off, r))
