"""Field algebra — the ``TFOR_ALL_F_OP_F_OP_F`` macro family (paper
listing 4).

OpenFOAM expands field expressions into elementwise loops, each offloaded
with one directive and fired hundreds of times per time-step (Fig 3).
Here each macro is a region; the fused Triton kernel registers as each
region's ``hopper`` variant, selected per call by the executing policy.
The reductions accumulate in float32, as the reference does (it never
enables 64-bit floats, so its ``astype(float64)`` is float32).
"""
from __future__ import annotations

import torch

from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import region
from repro_torch.kernels.fused_field import kernel as field_kernel


def make_field_ops(ledger: Ledger = None):
    """Region-decorated field macros (one ledger per app instance; a fresh
    one when none is given)."""
    kw = dict(ledger=ledger or Ledger("field_ops"))

    @region("F_OP_F_OP_F(axpy)", **kw)
    def axpy(a, x, y):
        """y + a*x — the daxpy of listing 2."""
        return y + a * x

    axpy.variant("hopper", field_kernel.fused_axpy)

    @region("F_OP_F_OP_F(xpay)", **kw)
    def xpay(a, x, y):
        """x + a*y (PBiCGStab's p-update shape)."""
        return x + a * y

    xpay.variant("hopper", field_kernel.fused_xpay)

    @region("F_OP_F_OP_F(axpbypz)", **kw)
    def axpbypz(a, x, b, y, z):
        """z + a*x + b*y (momentum corrector shape, listing 3 line 32)."""
        return z + a * x + b * y

    axpbypz.variant("hopper", field_kernel.fused_axpbypz)

    @region("F_MUL_F", **kw)
    def fmul(x, y):
        return x * y

    fmul.variant("hopper", field_kernel.fused_mul)

    @region("dot", **kw)
    def dot(x, y):
        return torch.sum(x * y, dtype=torch.float32)

    @region("norm2", **kw)
    def norm2(x):
        return torch.sqrt(torch.sum(x * x, dtype=torch.float32))

    @region("sumMag", **kw)
    def summag(x):
        return torch.sum(torch.abs(x), dtype=torch.float32)

    class Ops:
        pass

    ops = Ops()
    ops.axpy, ops.xpay, ops.axpbypz = axpy, xpay, axpbypz
    ops.fmul, ops.dot, ops.norm2, ops.summag = fmul, dot, norm2, summag
    return ops
