"""Krylov solvers: region-granular PBiCGStab (paper listing 5) and the
fused one.

:func:`pbicgstab_regions` is faithful to the paper's porting model: every
region (Amul, preconditioner, each field macro, each reduction) is a
separate offloaded region run through an executor.  Under the discrete
policy each region pays staging — the page-migration storm of Fig 6; under
the unified policy the alternation is free — the APU claim.  The scalars
(``rho``, ``alpha``, ``omega``...) come back to the host each iteration,
as in the reference.

:func:`pbicgstab_fused` is the same iteration as one torch loop with no
regions and no ledger rows, the counterpart of the reference's jitted
``while_loop``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.cfd.dia import (DiaMatrix, STENCIL_OFFSETS, amul_hopper,
                                 amul_ref, compose_offsets)
from repro_torch.cfd.precond import (RBDilu, _rb_dilu_ref, jacobi_apply,
                                     rb_dilu_factor, rb_dilu_hopper)
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import region
from repro_torch.kernels.fused_field import kernel as field_kernel
from repro_torch.kernels.stencil_spmv import kernel as stencil_kernel

SMALL = 1e-20


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iters: int
    initial_residual: float
    final_residual: float
    converged: bool


def make_solver_regions(ledger: Optional[Ledger] = None):
    """The solver's regions, each with its ``hopper`` variant where the
    reference has a kernel (a fresh Ledger when none is given)."""
    kw = dict(ledger=ledger or Ledger("solver_regions"))

    @region("Amul", stencil=STENCIL_OFFSETS, halo_args=("x",), **kw)
    def amul_r(diag, off, x):
        return amul_ref(DiaMatrix(diag, off), x)

    amul_r.variant("hopper", amul_hopper)

    # the two half-sweeps chain (black reads updated red reads r): reach 2
    @region("precondition(DILU)",
            stencil=compose_offsets(STENCIL_OFFSETS, STENCIL_OFFSETS),
            halo_args=("r",), **kw)
    def precond_r(rdiag, red, off, r):
        return _rb_dilu_ref(rdiag, red, off, r)

    precond_r.variant("hopper", rb_dilu_hopper)

    @region("sA=rA-alpha*AyA", **kw)
    def saxpy_r(a, x, y):
        return y - a * x

    @saxpy_r.variant("hopper")
    def _saxpy_k(a, x, y):
        # y - a*x is fused_axpy with the scale negated (exact)
        return field_kernel.fused_axpy(-a, x, y)

    @region("x+=a*yA+w*zA", **kw)
    def update_x_r(x, a, yA, w, zA):
        return x + a * yA + w * zA

    @update_x_r.variant("hopper")
    def _update_x_k(x, a, yA, w, zA):
        return field_kernel.fused_axpbypz(a, yA, w, zA, x)

    @region("p=r+beta*(p-w*v)", **kw)
    def update_p_r(r, beta, p, w, v):
        return r + beta * (p - w * v)

    @region("dot", **kw)
    def dot_r(x, y):
        return torch.sum(x * y, dtype=torch.float32)

    @region("sumMag", **kw)
    def summag_r(x):
        return torch.sum(torch.abs(x), dtype=torch.float32)

    class R:
        amul, precond = amul_r, precond_r
        saxpy, update_x, update_p = saxpy_r, update_x_r, update_p_r
        dot, summag = dot_r, summag_r

    return R


def pbicgstab_regions(executor, regions, A: DiaMatrix, b, x0, P: RBDilu,
                      tol: float = 1e-6, rel_tol: float = 0.0,
                      max_iter: int = 500) -> SolveResult:
    """OpenFOAM PBiCGStab, one ``executor.run`` per offloaded region."""
    run = executor.run
    x = x0
    # r = b - 1.0*Ax through the saxpy region, so the residual dataflow is
    # region-visible
    r = run(regions.saxpy, 1.0, run(regions.amul, A.diag, A.off, x), b)
    rA0 = r
    norm = float(run(regions.summag, b)) + SMALL
    res0 = float(run(regions.summag, r)) / norm
    res = res0
    rho_old = alpha = omega = 1.0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    it = 0
    while res > tol and (rel_tol <= 0 or res / max(res0, SMALL) > rel_tol) \
            and it < max_iter:
        rho = float(run(regions.dot, rA0, r))
        if abs(rho) < SMALL:
            break
        beta = (rho / rho_old) * (alpha / max(omega, SMALL))
        p = run(regions.update_p, r, beta, p, omega, v)
        yA = run(regions.precond, P.rdiag, P.red, A.off, p)
        v = run(regions.amul, A.diag, A.off, yA)
        denom = float(run(regions.dot, rA0, v))
        alpha = rho / (denom if abs(denom) > SMALL else SMALL)
        s = run(regions.saxpy, alpha, v, r)
        zA = run(regions.precond, P.rdiag, P.red, A.off, s)
        t = run(regions.amul, A.diag, A.off, zA)
        tt = float(run(regions.dot, t, t))
        ts = float(run(regions.dot, t, s))
        omega = ts / (tt if abs(tt) > SMALL else SMALL)
        x = run(regions.update_x, x, alpha, yA, omega, zA)
        r = run(regions.saxpy, omega, t, s)
        rho_old = rho
        res = float(run(regions.summag, r)) / norm
        it += 1
    return SolveResult(x, it, res0, res, res <= tol)


# ---------------------------------------------------------------------------
# Fused PBiCGStab (one torch loop)
# ---------------------------------------------------------------------------

def pbicgstab_fused(A: DiaMatrix, b, x0, rdiag, red, tol: float = 1e-6,
                    max_iter: int = 500, use_dilu: bool = True):
    """PBiCGStab as one loop of torch ops, no regions and no ledger rows.
    Returns (x, iterations, initial residual, final residual), the last
    two as 0-d tensors.

    A is applied through the stencil kernel's wrapper (K1) and the DILU
    preconditioner through the half-sweep kernels' wrappers (K2/K3): on
    CUDA operands they launch the kernels, on CPU operands they run the
    plain versions.  ``use_dilu=False`` takes Jacobi.  The scalars stay
    0-d float32 tensors on the operands' device and every reduction
    accumulates in float32, as the reference's do (its ``astype(float64)``
    is float32 there, since it never enables 64-bit floats).  Unlike the
    reference's ``while_loop``, which tests convergence on the device, the
    loop reads the residual on the host once per iteration to decide
    whether to go on."""
    def amul(x):
        return stencil_kernel.stencil_spmv(A.diag, A.off, x)

    def precond(r):
        return stencil_kernel.rb_dilu(rdiag, red, A.off, r) if use_dilu \
            else jacobi_apply(A, r)

    def dot(a, c):
        return torch.sum(a * c, dtype=torch.float32)

    def guard(d, small):
        return torch.where(small, SMALL, d)

    norm = torch.sum(torch.abs(b), dtype=torch.float32) + SMALL

    def res_of(r):
        return torch.sum(torch.abs(r), dtype=torch.float32) / norm

    x, r = x0, b - amul(x0)
    rA0 = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=torch.float32, device=b.device)
    rho_old, alpha, omega = one, one, one
    res0 = res = res_of(r)
    it = 0
    while it < max_iter and bool(res > tol):
        rho = dot(rA0, r)
        beta = (rho / guard(rho_old, rho_old.abs() < SMALL)) \
            * (alpha / guard(omega, omega.abs() < SMALL))
        p = r + beta * (p - omega * v)
        yA = precond(p)
        v = amul(yA)
        denom = dot(rA0, v)
        alpha = rho / guard(denom, denom.abs() < SMALL)
        s = r - alpha * v
        zA = precond(s)
        t = amul(zA)
        tt = dot(t, t)
        omega = dot(t, s) / guard(tt, tt < SMALL)
        x = x + alpha * yA + omega * zA
        r = s - omega * t
        rho_old = rho
        res = res_of(r)
        it += 1
    return x, it, res0, res


def solve(A: DiaMatrix, b, x0, red, tol: float = 1e-6, max_iter: int = 500,
          use_dilu: bool = True) -> SolveResult:
    """Factor the red-black DILU preconditioner, then run
    :func:`pbicgstab_fused`."""
    P = rb_dilu_factor(A, red)
    x, it, r0, res = pbicgstab_fused(A, b, x0, P.rdiag, P.red, tol=tol,
                                     max_iter=max_iter, use_dilu=use_dilu)
    return SolveResult(x, it, float(r0), float(res), float(res) <= tol)
