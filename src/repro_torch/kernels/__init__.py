"""Hand-written Hopper kernel packages and their implementation-variant
tables.

Each subpackage ``<name>/`` is one compute hot-spot:

* ``kernel.py`` — the kernel (CUDA C++ from ``csrc/`` built by
  :mod:`repro_torch.kernels.build`, or Triton) as a ``torch.library`` custom
  op with fake and vmap rules, its checking wrappers, and launch counters;
* ``ref.py``    — the plain PyTorch version: what the wrappers run on CPU
  tensors and what every kernel is held against on the card.

The packages do not wire themselves into application code: regions
register the wrappers as their ``hopper`` variant (``repro_torch.cfd.dia``
/ ``precond`` / ``fields`` / ``solvers``, ``repro_torch.models.rwkv6``) and
the executing policy's selector picks one per call.

Contract: every op carries a ``ref`` entry in :func:`variant_tables`, and
every live kernel-backed region carries ``ref`` plus a kernel variant
(:func:`check_ref_variants`).
"""
from __future__ import annotations

from typing import Callable, Dict

#: the variant every kernel package must provide (the fallback target)
REQUIRED_VARIANT = "ref"

#: the variant name every hand-written kernel registers under
KERNEL_VARIANT = "hopper"

#: kernel subpackages participating in the variant contract
PACKAGES = ("stencil_spmv", "fused_field", "rwkv6_scan")


def variant_tables() -> Dict[str, Dict[str, Dict[str, Callable]]]:
    """``{package: {op: {variant: callable}}}`` for every kernel package."""
    from repro_torch.kernels.fused_field import kernel as ffk, ref as ffr
    from repro_torch.kernels.rwkv6_scan import kernel as rwk, ref as rwr
    from repro_torch.kernels.stencil_spmv import kernel as ssk, ref as ssr

    return {
        "stencil_spmv": {
            "amul": {"ref": ssr.stencil_spmv, "hopper": ssk.stencil_spmv},
            "rb_dilu": {"ref": ssr.rb_dilu, "hopper": ssk.rb_dilu},
        },
        "fused_field": {
            "axpy": {"ref": ffr.fused_axpy, "hopper": ffk.fused_axpy},
            "xpay": {"ref": ffr.fused_xpay, "hopper": ffk.fused_xpay},
            "mul": {"ref": ffr.fused_mul, "hopper": ffk.fused_mul},
            "axpbypz": {"ref": ffr.fused_axpbypz,
                        "hopper": ffk.fused_axpbypz},
        },
        "rwkv6_scan": {
            "scan": {"ref": rwr.rwkv6_scan, "hopper": rwk.rwkv6_scan},
        },
    }


def _live_kernel_regions():
    """The Region objects that register kernel variants."""
    from repro_torch.cfd.dia import AMUL
    from repro_torch.cfd.fields import make_field_ops
    from repro_torch.cfd.precond import RB_DILU
    from repro_torch.cfd.solvers import make_solver_regions
    from repro_torch.models.rwkv6 import RWKV6_SCAN
    ops = make_field_ops()
    solver = make_solver_regions()
    return [AMUL, RB_DILU, RWKV6_SCAN,
            solver.amul, solver.precond, solver.saxpy, solver.update_x,
            ops.axpy, ops.xpay, ops.axpbypz, ops.fmul]


def check_ref_variants() -> Dict[str, int]:
    """Fail (SystemExit) unless every op of every kernel package ships a
    ``ref`` entry AND every live kernel-backed region carries both ``ref``
    and the kernel variant; returns ``{package: op count}``."""
    tables = variant_tables()
    missing = [pkg for pkg in PACKAGES if pkg not in tables]
    missing += [f"{pkg}.{op}" for pkg, ops in tables.items()
                for op, table in ops.items()
                if REQUIRED_VARIANT not in table]
    for r in _live_kernel_regions():
        if REQUIRED_VARIANT not in r.variants:
            missing.append(f"region:{r.name}")
        if KERNEL_VARIANT not in r.variants:
            missing.append(f"region:{r.name} (no kernel variant)")
    if missing:
        raise SystemExit(
            f"kernel packages/regions without a {REQUIRED_VARIANT!r} "
            f"variant: {missing}")
    return {pkg: len(ops) for pkg, ops in tables.items()}
