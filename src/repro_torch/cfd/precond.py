"""Preconditioners: two-colour (red-black) DILU, and Jacobi.

OpenFOAM's DILUPreconditioner (paper listing 6) does sequential forward /
backward substitution.  Under a red-black ordering of the 7-point stencil
the triangular solves decompose into two fully parallel half-sweeps, each
a shifted-stencil FMA — a DILU factorisation for the two-colour ordering.
With red cells ordered before black:

    D*_red   = diag(A)_red
    D*_black = diag(A)_black - sum_f  A_bf * A_fb / D*_red(neighbour)
    (L+D*) y = r :  y_r = r_r / D*_r ;  y_b = (r_b - sum L_br y_r) / D*_b
    (D*+U) z = D* y :  z_b = y_b ;      z_r = y_r - (sum U_rb z_b) / D*_r
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cfd.dia import (DiaMatrix, STENCIL_OFFSETS, compose_offsets,
                                 to_dense)
from repro_torch.cfd.grid import NEIGHBORS, shift
from repro_torch.core.regions import region
from repro_torch.kernels.stencil_spmv import kernel as stencil_kernel
from repro_torch.kernels.stencil_spmv import ref as stencil_ref


@dataclasses.dataclass
class RBDilu:
    rdiag: torch.Tensor       # 1 / D*  (reciprocal, fused into the sweeps)
    red: torch.Tensor         # red mask (bool)


def rb_dilu_factor(A: DiaMatrix, red) -> RBDilu:
    """D* for the red-black ordering (black rows update off red D*)."""
    redf = red.to(A.diag.dtype)
    dstar_red = A.diag
    inv_red = redf / torch.where(dstar_red == 0, 1.0, dstar_red)
    corr = torch.zeros_like(A.diag)
    for f, (ax, d) in enumerate(NEIGHBORS):
        g = f + 1 if f % 2 == 0 else f - 1
        a_fb = shift(A.off[g], ax, d)              # neighbour -> me
        corr = corr + A.off[f] * a_fb * shift(inv_red, ax, d)
    dstar = torch.where(red, A.diag, A.diag - corr)
    rdiag = 1.0 / torch.where(dstar == 0, 1.0, dstar)
    return RBDilu(rdiag=rdiag, red=red)


def _rb_dilu_ref(rdiag, red, off, r):
    """w = M^-1 r with M = (L+D*) D*^-1 (D*+U) in red-black ordering: the
    forward then the backward half-sweep (the ``ref`` variant of
    :data:`RB_DILU`)."""
    return stencil_ref.rb_dilu(rdiag, red, off, r)


# the two half-sweeps chain (black reads updated red): composed reach 2
@region("rb_dilu(dia)",
        stencil=compose_offsets(STENCIL_OFFSETS, STENCIL_OFFSETS),
        halo_args=("r",))
def RB_DILU(rdiag, red, off, r):
    """The canonical red-black DILU apply region; the CUDA half-sweep
    kernels register as its ``hopper`` variant."""
    return _rb_dilu_ref(rdiag, red, off, r)


#: the ONE wrapper of the half-sweep kernel composition; per-app DILU
#: regions register this same callable
rb_dilu_hopper = RB_DILU.variant("hopper", stencil_kernel.rb_dilu)


def rb_dilu_apply(P: RBDilu, A: DiaMatrix, r, impl: str = "ref"):
    """Variant-dispatched preconditioner apply for direct callers."""
    return RB_DILU.impl_fn(RB_DILU.resolve(impl))(P.rdiag, P.red, A.off, r)


def jacobi_apply(A: DiaMatrix, r):
    """w = D^-1 r (zero diagonal entries taken as 1)."""
    return r / torch.where(A.diag == 0, 1.0, A.diag)


def dilu_seq_ref(A: DiaMatrix, r) -> np.ndarray:
    """Sequential (natural-ordering) DILU oracle on the dense form —
    O(N^2); small-grid tests only."""
    M = to_dense(A)
    N = M.shape[0]
    rr = r.detach().cpu().double().numpy().reshape(N)
    dstar = np.zeros(N)
    for i in range(N):
        s = M[i, i]
        for j in range(i):
            if M[i, j] != 0 and M[j, i] != 0:
                s -= M[i, j] * M[j, i] / dstar[j]
        dstar[i] = s
    y = np.zeros(N)
    for i in range(N):
        y[i] = (rr[i] - M[i, :i] @ y[:i]) / dstar[i]
    z = np.zeros(N)
    for i in reversed(range(N)):
        z[i] = y[i] - (M[i, i + 1:] @ z[i + 1:]) / dstar[i]
    return z.reshape(tuple(r.shape))
