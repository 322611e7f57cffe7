"""Explicit finite-volume operators (fvc::) — gradients and divergence."""
from __future__ import annotations

import torch

from repro_torch.cfd.grid import Grid, interior_mask, shift


def grad(grid: Grid, p):
    """Cell-centred gradient, central differences, one-sided at walls."""
    out = []
    for ax in range(3):
        h = grid.h[ax]
        m_lo = interior_mask(grid, ax, -1)
        m_hi = interior_mask(grid, ax, +1)
        lo = shift(p, ax, -1)
        hi = shift(p, ax, +1)
        both = (m_lo * m_hi) > 0
        # central where both neighbours exist; one-sided at boundaries
        g = torch.where(both, (hi - lo) / (2 * h),
                        torch.where(m_lo > 0, (p - lo) / h,
                                    torch.where(m_hi > 0, (hi - p) / h, 0.0)))
        out.append(g)
    return out


def div_flux(grid: Grid, phi_faces):
    """div of face fluxes (sum of signed fluxes / volume)."""
    return torch.sum(phi_faces, dim=0) / grid.vol
