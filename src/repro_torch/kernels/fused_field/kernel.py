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

``triton`` is imported at the first launch, never at module import.  Given
CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel on the current stream or raises.
"""
from __future__ import annotations

import torch

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


def _launch(name, scalars, x, y, z=None):
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        a, b = (*scalars, 0.0, 0.0)[:2]          # unused scalars are 0
        kernel = _compiled()
        with torch.cuda.device(x.device):
            kernel[(-(-n // BLOCK),)](
                x, y, x if z is None else z, out,
                ref.cast_scalar(a, x.dtype), ref.cast_scalar(b, x.dtype), n,
                OP=OPS[name], BLOCK=BLOCK, num_warps=4,
                enable_fp_fusion=False)
        LAUNCHES[name] += 1
    return out


def fused_axpy(a, x, y):
    """y + a*x"""
    if _check("fused_axpy", (x, y)).type == "cpu":
        return ref.fused_axpy(a, x, y)
    return _launch("fused_axpy", (a,), x, y)


def fused_xpay(a, x, y):
    """x + a*y"""
    if _check("fused_xpay", (x, y)).type == "cpu":
        return ref.fused_xpay(a, x, y)
    return _launch("fused_xpay", (a,), x, y)


def fused_mul(x, y):
    """x*y"""
    if _check("fused_mul", (x, y)).type == "cpu":
        return ref.fused_mul(x, y)
    return _launch("fused_mul", (), x, y)


def fused_axpbypz(a, x, b, y, z):
    """z + a*x + b*y"""
    if _check("fused_axpbypz", (x, y, z)).type == "cpu":
        return ref.fused_axpbypz(a, x, b, y, z)
    return _launch("fused_axpbypz", (a, b), x, y, z)
