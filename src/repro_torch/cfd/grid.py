"""Structured 3-D finite-volume grid (the computational substrate of the
OpenFOAM case study).

A structured grid lets the LDU operator re-lay into DIA form (7 shifted
diagonals); the systems claims (directive-per-loop offload, unified
memory, pooling) are insensitive to mesh topology.  Fields are float32
tensors of shape ``(nx, ny, nz)`` on ``Grid.device``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.core.umem import resolve_device


@dataclasses.dataclass(frozen=True)
class Grid:
    shape: Tuple[int, int, int]          # (nx, ny, nz) cells
    lengths: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    device: Any = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    @property
    def h(self) -> Tuple[float, float, float]:
        return tuple(L / s for L, s in zip(self.lengths, self.shape))

    @property
    def vol(self) -> float:
        hx, hy, hz = self.h
        return hx * hy * hz

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=torch.float32,
                           device=self.device)

    def red_black_masks(self):
        """Two-colouring of the 7-point stencil (for the two-colour DILU)."""
        idx = [torch.arange(s, device=self.device) for s in self.shape]
        i, j, k = torch.meshgrid(*idx, indexing="ij")
        red = (i + j + k) % 2 == 0
        return red, ~red


# face-neighbour shift table: axis, direction
NEIGHBORS = (
    (0, -1), (0, +1),   # -x, +x
    (1, -1), (1, +1),   # -y, +y
    (2, -1), (2, +1),   # -z, +z
)


def shift(f: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """Neighbour value with zero padding outside the domain.
    ``shift(f, 0, -1)[i] == f[i-1]`` (the -x neighbour)."""
    n = f.shape[axis]
    out = torch.zeros_like(f)
    if direction < 0:
        out.narrow(axis, 1, n - 1).copy_(f.narrow(axis, 0, n - 1))
    else:
        out.narrow(axis, 0, n - 1).copy_(f.narrow(axis, 1, n - 1))
    return out


def interior_mask(grid: Grid, axis: int, direction: int) -> torch.Tensor:
    """1.0 where the neighbour in (axis, direction) exists."""
    m = torch.ones(grid.shape, dtype=torch.float32, device=grid.device)
    m.select(axis, 0 if direction < 0 else grid.shape[axis] - 1).zero_()
    return m
