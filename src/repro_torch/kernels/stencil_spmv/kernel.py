"""Wrappers of the hand-written CUDA stencil kernels (``csrc/stencil.cu``).

Replaces ``src/repro/kernels/stencil_spmv/kernel.py`` of the JAX package:
``stencil_spmv`` (K1), ``rb_dilu_forward`` (K2), ``rb_dilu_backward`` (K3)
and their composition ``rb_dilu``.  All three are bound by HBM bytes (36-37
B per cell, ~0.4 flop/B); the kernels make one coalesced pass and read no
padded copy (see the note in the CUDA source).

Each kernel is a ``torch.library`` custom op (``repro_torch::<name>``), so
a compiled region holds it as one opaque node: its CUDA implementation
launches the kernel on the current stream without synchronising, or
raises; its CPU implementation is the plain version (``ref.py``); its fake
implementation gives the output's shape and dtype, symbolic sizes
included; its vmap rule calls it once per batch row.  Each wrapper checks
device, dtype, shape and contiguity, raises on anything else, and calls
its op.  ``LAUNCHES`` counts kernel launches only, in the op's body, so
every call of a compiled graph counts too.
"""
from __future__ import annotations

import torch
from torch import Tensor

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


def _launch(name, entry, operands):
    """One launch of ``entry`` on ``operands`` into a fresh output shaped
    like the last operand."""
    out = torch.empty_like(operands[-1])
    if out.numel():
        build.launch(entry, (*operands, out), out.shape)
        LAUNCHES[name] += 1
    return out


def _row_by_row(op):
    """vmap rule of a 3-D field op: one call (one launch) per batch row,
    the kernel unchanged."""
    def rule(info, in_dims, *args):
        rows = [op(*(a if d is None else a.select(d, b)
                     for a, d in zip(args, in_dims)))
                for b in range(info.batch_size)]
        return torch.stack(rows), 0
    return rule


def _register(op, name):
    """CPU kernel = the plain version ``ref.<name>`` (looked up at each
    call); fake = a fresh field like the last operand; vmap = row by row."""
    op.register_kernel("cpu")(lambda *args: getattr(ref, name)(*args))
    op.register_fake(lambda *args: torch.empty_like(args[-1]))
    op.register_vmap(_row_by_row(op))


@torch.library.custom_op("repro_torch::stencil_spmv", mutates_args=(),
                         device_types="cuda")
def stencil_spmv_op(diag: Tensor, off: Tensor, x: Tensor) -> Tensor:
    return _launch("stencil_spmv", "stencil_spmv_f32", (diag, off, x))


@torch.library.custom_op("repro_torch::rb_dilu_forward", mutates_args=(),
                         device_types="cuda")
def rb_dilu_forward_op(rdiag: Tensor, red: Tensor, off: Tensor,
                       r: Tensor) -> Tensor:
    return _launch("rb_dilu_forward", "rb_dilu_forward_f32",
                   (rdiag, red, off, r))


@torch.library.custom_op("repro_torch::rb_dilu_backward", mutates_args=(),
                         device_types="cuda")
def rb_dilu_backward_op(rdiag: Tensor, red: Tensor, off: Tensor,
                        y: Tensor) -> Tensor:
    return _launch("rb_dilu_backward", "rb_dilu_backward_f32",
                   (rdiag, red, off, y))


_register(stencil_spmv_op, "stencil_spmv")
_register(rb_dilu_forward_op, "rb_dilu_forward")
_register(rb_dilu_backward_op, "rb_dilu_backward")


def stencil_spmv(diag, off, x):
    """diag [nx,ny,nz]; off [6,nx,ny,nz]; x [nx,ny,nz] -> y = A x."""
    _check("stencil_spmv", (diag, x), off)
    return stencil_spmv_op(diag, off, x)


def rb_dilu_forward(rdiag, red, off, r):
    """Forward half-sweep of the red-black DILU (K2)."""
    _check("rb_dilu_forward", (rdiag, r), off, red)
    return rb_dilu_forward_op(rdiag, red, off, r)


def rb_dilu_backward(rdiag, red, off, y):
    """Backward half-sweep of the red-black DILU (K3)."""
    _check("rb_dilu_backward", (rdiag, y), off, red)
    return rb_dilu_backward_op(rdiag, red, off, y)


def rb_dilu(rdiag, red, off, r):
    """w = M^-1 r: the forward then the backward half-sweep."""
    return rb_dilu_backward(rdiag, red, off,
                            rb_dilu_forward(rdiag, red, off, r))
