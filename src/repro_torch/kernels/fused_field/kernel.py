"""Fused field macros (K4) as one hand-written Triton kernel.

Replaces ``src/repro/kernels/fused_field/kernel.py`` of the JAX package:
the ``_run_elementwise`` function behind ``fused_axpy``, ``fused_xpay``,
``fused_mul`` and ``fused_axpbypz``.  What bounds it on an H100: bytes —
each operand is read once and the result written once (12 B per element
for axpy/xpay/mul, 16 B for axpbypz in f32) for one or two flops.  The
design is therefore the plainest one: one ``@triton.jit`` body with the op
as a ``tl.constexpr``, 1024-element masked blocks (16-byte loads per
thread), no shared memory, no reuse.  Scalars are rounded to the output
dtype on the host as the Pallas wrapper does, the expression is evaluated in
f32 left to right, and FMA contraction is disabled, so in f32 the kernel
reproduces the plain version (``ref.py``) bit for bit.

``triton`` is imported at the first launch, never at module import.  The
four wrappers call one ``torch.library`` custom op,
``repro_torch::fused_field``, so a compiled region holds the kernel as one
opaque node: on CUDA tensors it launches the kernel on the current stream
or raises; on CPU tensors it runs the plain version; its fake
implementation gives the output's shape and dtype; its vmap rule launches
it once on the batched operands.  ``LAUNCHES`` counts in the op's body.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels.fused_field import ref

#: kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = {"fused_axpy": 0, "fused_xpay": 0, "fused_mul": 0,
            "fused_axpbypz": 0}

BLOCK = 1024
OPS = {"fused_axpy": 0, "fused_xpay": 1, "fused_mul": 2, "fused_axpbypz": 3}
DTYPES = (torch.float32, torch.bfloat16)

#: ``triton.language``, bound by :func:`_compiled` before the first compile
#: (the body below resolves ``tl`` from this module's globals)
tl = None
_jitted = None


def _fused_field(x_ptr, y_ptr, z_ptr, o_ptr, a, b, n,
                 OP: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
    y = tl.load(y_ptr + offs, mask=mask).to(tl.float32)
    if OP == 0:                                 # axpy: y + a*x
        o = y + a * x
    elif OP == 1:                               # xpay: x + a*y
        o = x + a * y
    elif OP == 2:                               # mul: x*y
        o = x * y
    else:                                       # axpbypz: z + a*x + b*y
        z = tl.load(z_ptr + offs, mask=mask).to(tl.float32)
        o = z + a * x + b * y
    tl.store(o_ptr + offs, o.to(o_ptr.dtype.element_ty), mask=mask)


def _compiled():
    global tl, _jitted
    if _jitted is None:
        import triton
        import triton.language
        tl = triton.language
        _jitted = triton.jit(_fused_field)
    return _jitted


def _check(name, arrays):
    x0 = arrays[0]
    if x0.dtype not in DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x0.dtype}")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x0.device}")
    for t in arrays:
        if t.shape != x0.shape or t.dtype != x0.dtype \
                or t.device != x0.device:
            raise ValueError(f"{name}: operands differ in shape/dtype/device "
                             f"({tuple(t.shape)} {t.dtype} {t.device} vs "
                             f"{tuple(x0.shape)} {x0.dtype} {x0.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return x0.device


NAMES = {v: k for k, v in OPS.items()}


def _scalar(v) -> Tensor:
    """A scalar as the 0-d float64 CPU tensor the op takes (a compiled
    region passes its Python float arguments in as such tensors already:
    a ``float`` argument of a custom op would be specialised, one compile
    per value).  Reading it back in the op's body costs no device sync."""
    if isinstance(v, Tensor):
        return v.to(torch.float64)
    return torch.full((), v, dtype=torch.float64)


@torch.library.custom_op("repro_torch::fused_field", mutates_args=(),
                         device_types="cuda")
def fused_field_op(x: Tensor, y: Tensor, z: Optional[Tensor], a: Tensor,
                   b: Tensor, op: int) -> Tensor:
    """One launch of the K4 body: ``op`` 0 axpy ``y+a*x``, 1 xpay
    ``x+a*y``, 2 mul ``x*y``, 3 axpbypz ``z+a*x+b*y``."""
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        kernel = _compiled()
        with torch.cuda.device(x.device):
            kernel[(-(-n // BLOCK),)](
                x, y, x if z is None else z, out,
                ref.cast_scalar(a.item(), x.dtype),
                ref.cast_scalar(b.item(), x.dtype), n,
                OP=op, BLOCK=BLOCK, num_warps=4, enable_fp_fusion=False)
        LAUNCHES[NAMES[op]] += 1
    return out


@fused_field_op.register_kernel("cpu")
def _fused_field_plain(x, y, z, a, b, op):
    a, b = a.item(), b.item()
    if op == 0:
        return ref.fused_axpy(a, x, y)
    if op == 1:
        return ref.fused_xpay(a, x, y)
    if op == 2:
        return ref.fused_mul(x, y)
    return ref.fused_axpbypz(a, x, b, y, z)


@fused_field_op.register_fake
def _fused_field_fake(x, y, z, a, b, op):
    return torch.empty_like(x)


@fused_field_op.register_vmap
def _fused_field_vmap(info, in_dims, x, y, z, a, b, op):
    """Elementwise: the fields go in batched as they are (an unbatched one
    broadcast over the batch) and the scalars broadcast; a batched scalar
    takes one call per batch row."""
    n = info.batch_size
    if in_dims[3] is not None or in_dims[4] is not None:
        return torch.stack([fused_field_op(
            *(t if d is None or t is None else t.select(d, i)
              for t, d in zip((x, y, z, a, b), in_dims[:5])), op)
            for i in range(n)]), 0

    def batched(t, d):
        if t is None:
            return None
        t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
        return t.contiguous()

    return fused_field_op(batched(x, in_dims[0]), batched(y, in_dims[1]),
                          batched(z, in_dims[2]), a, b, op), 0


def _launch(name, scalars, x, y, z=None):
    a, b = (*scalars, 0.0, 0.0)[:2]          # unused scalars are 0
    return fused_field_op(x, y, z, _scalar(a), _scalar(b), OPS[name])


def fused_axpy(a, x, y):
    """y + a*x"""
    _check("fused_axpy", (x, y))
    return _launch("fused_axpy", (a,), x, y)


def fused_xpay(a, x, y):
    """x + a*y"""
    _check("fused_xpay", (x, y))
    return _launch("fused_xpay", (a,), x, y)


def fused_mul(x, y):
    """x*y"""
    _check("fused_mul", (x, y))
    return _launch("fused_mul", (), x, y)


def fused_axpbypz(a, x, b, y, z):
    """z + a*x + b*y"""
    _check("fused_axpbypz", (x, y, z))
    return _launch("fused_axpbypz", (a, b), x, y, z)
