"""Implicit finite-volume operators (fvm::) — build DiaMatrix systems.

Mirrors the OpenFOAM operators used by simpleFoam (paper listing 3):
``laplacian`` (momentum diffusion, pressure Poisson) and ``div_upwind``
(first-order upwind convection).  Uniform grid, per-unit-volume scaling;
Dirichlet or zero-gradient (Neumann) boundaries.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.cfd.dia import DiaMatrix
from repro_torch.cfd.grid import Grid, NEIGHBORS, interior_mask, shift


def laplacian(grid: Grid, gamma, *, dirichlet: Sequence[bool] = None):
    """Matrix for  -gamma * laplace(x)  (positive-definite form).

    dirichlet[axis*2+dir]: True -> wall value enters the rhs via bc_rhs;
    False -> zero-gradient (no face flux).
    Returns (A, bc_coeff [6,...]) where bc_coeff[f] * wall_value adds to rhs.
    """
    h = grid.h
    diag = grid.zeros()
    offs = []
    bcs = []
    dirichlet = dirichlet if dirichlet is not None else [True] * 6
    for f, (ax, d) in enumerate(NEIGHBORS):
        coef = gamma / (h[ax] * h[ax])
        mask = interior_mask(grid, ax, d)
        off = -coef * mask
        diag = diag + coef * mask
        boundary = 1.0 - mask
        if dirichlet[f]:
            # ghost value = 2*wall - cell  =>  diag += 2c, rhs += 2c*wall
            diag = diag + 2.0 * coef * boundary
            bcs.append(2.0 * coef * boundary)
        else:
            bcs.append(grid.zeros())
        offs.append(off)
    return DiaMatrix(diag, torch.stack(offs)), torch.stack(bcs)


def div_upwind(grid: Grid, phi_faces):
    """Matrix for  div(phi, x)  with first-order upwind.

    phi_faces[f] = volumetric flux across face f (positive = outflow),
    shape [6, nx,ny,nz].  Off-diagonals pull from the upwind neighbour when
    flow enters the cell; the diagonal collects outflow."""
    diag = grid.zeros()
    offs = []
    for f, (ax, d) in enumerate(NEIGHBORS):
        mask = interior_mask(grid, ax, d)
        out = torch.clamp(phi_faces[f], min=0.0)    # leaving through face f
        inn = torch.clamp(phi_faces[f], max=0.0)    # entering (upwind nb)
        diag = diag + out / grid.vol
        offs.append(inn * mask / grid.vol)
    return DiaMatrix(diag, torch.stack(offs))


def face_fluxes(grid: Grid, u, v, w):
    """Volumetric face fluxes from cell-centred velocity (linear interp).
    Returns [6, nx,ny,nz]; sign convention: positive = out of the cell."""
    h = grid.h
    areas = (h[1] * h[2], h[1] * h[2], h[0] * h[2], h[0] * h[2],
             h[0] * h[1], h[0] * h[1])
    comps = (u, u, v, v, w, w)
    fluxes = []
    for f, (ax, d) in enumerate(NEIGHBORS):
        c = comps[f]
        mask = interior_mask(grid, ax, d)
        face_vel = 0.5 * (c + shift(c, ax, d)) * mask
        sign = -1.0 if d < 0 else 1.0
        fluxes.append(sign * face_vel * areas[f])
    return torch.stack(fluxes)


def relax(A: DiaMatrix, x, b, alpha: float):
    """OpenFOAM-style implicit under-relaxation: diag /= alpha and
    rhs += (1-alpha)/alpha * diag * x_old."""
    new_diag = A.diag / alpha
    new_b = b + (new_diag - A.diag) * x
    return DiaMatrix(new_diag, A.off), new_b
