"""DIA (diagonal-offset) sparse matrix over a structured grid.

OpenFOAM's lduMatrix on a structured grid: the face-list gather/scatter
Amul becomes 7 shifted-vector FMAs.  Coefficients are stored per cell:
``diag [nx,ny,nz]`` and ``off [6,nx,ny,nz]`` where ``off[f]`` multiplies
the neighbour in ``grid.NEIGHBORS[f]``; entries for non-existent
(boundary) neighbours are zero.

``amul_ref`` is the plain oracle and the ``ref`` variant of :data:`AMUL`;
the hand-written CUDA stencil kernel registers as its ``hopper`` variant.
Which one runs is decided per call by the executing policy's selector.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cfd.grid import NEIGHBORS, shift
from repro_torch.core.regions import region
from repro_torch.kernels.stencil_spmv import kernel as stencil_kernel
from repro_torch.kernels.stencil_spmv import ref as stencil_ref

#: the DIA offset table in (grid_axis, offset) form — one entry per band
STENCIL_OFFSETS = NEIGHBORS


def compose_offsets(a, b):
    """Offset table of a stencil applied after another (Minkowski sum)."""
    out = {(ax, d) for ax, d in a} | {(ax, d) for ax, d in b}
    for ax1, d1 in a:
        for ax2, d2 in b:
            if ax1 == ax2 and d1 + d2 != 0:
                out.add((ax1, d1 + d2))
    return tuple(sorted(out))


@dataclasses.dataclass
class DiaMatrix:
    diag: torch.Tensor           # [nx,ny,nz]
    off: torch.Tensor            # [6,nx,ny,nz]

    def transpose(self) -> "DiaMatrix":
        """A^T: off[f] becomes the opposite face's coefficient, shifted."""
        new_off = []
        for f, (ax, d) in enumerate(NEIGHBORS):
            g = f + 1 if f % 2 == 0 else f - 1        # opposite face index
            new_off.append(shift(self.off[g], ax, d))
        return DiaMatrix(self.diag, torch.stack(new_off))


def amul_ref(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x — diag*x, then the faces -x,+x,-y,+y,-z,+z (the stencil
    kernel's plain version)."""
    return stencil_ref.stencil_spmv(A.diag, A.off, x)


@region("Amul(dia)", stencil=STENCIL_OFFSETS, halo_args=("x",))
def AMUL(diag, off, x):
    """The canonical DIA SpMV region: ``ref`` is the 7-FMA oracle, the
    CUDA stencil kernel registers as ``hopper``."""
    return amul_ref(DiaMatrix(diag, off), x)


#: the ONE wrapper of the stencil kernel; per-app Amul regions
#: (``solvers.make_solver_regions``) register this same callable
amul_hopper = AMUL.variant("hopper", stencil_kernel.stencil_spmv)


def to_dense(A: DiaMatrix) -> np.ndarray:
    """O(N^2) dense float64 form for small-grid tests only."""
    nx, ny, nz = A.diag.shape
    N = nx * ny * nz
    M = np.zeros((N, N), np.float64)
    diag = A.diag.detach().cpu().double().numpy()
    off = A.off.detach().cpu().double().numpy()

    def idx(i, j, k):
        return (i * ny + j) * nz + k

    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                r = idx(i, j, k)
                M[r, r] = diag[i, j, k]
                for f, (ax, d) in enumerate(NEIGHBORS):
                    nb = [i, j, k]
                    nb[ax] += d
                    if 0 <= nb[0] < nx and 0 <= nb[1] < ny and 0 <= nb[2] < nz:
                        M[r, idx(*nb)] = off[f, i, j, k]
    return M
