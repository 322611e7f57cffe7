"""Unified-memory abstraction (paper C1): one logical space, placement by
policy.

On MI300A one physical memory serves CPU cores and GPU CUs.  On a discrete
H100 the three spaces are real and distinct:

* ``DEVICE``        — CUDA HBM,
* ``HOST``          — page-locked (pinned) CPU memory, DMA-able,
* ``HOST_UNPINNED`` — pageable CPU memory.

Application code names a :class:`MemSpace`; :func:`place` maps it onto a
``torch.device`` (and pinning).  A CPU-only torch cannot pin, so there
``HOST`` degrades to pageable memory and ``DEVICE`` is the CPU.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import torch


class MemSpace(enum.Enum):
    DEVICE = "device"            # HBM
    HOST = "pinned_host"         # DMA-able host DRAM
    HOST_UNPINNED = "unpinned_host"


def resolve_device(device: Any = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent — the port never carries on silently on the CPU."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return d


def can_pin() -> bool:
    """Page-locked host memory needs a CUDA runtime (``pin_memory()``
    raises on a CPU-only torch)."""
    return torch.cuda.is_available()


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of nested tuples / lists / dicts."""
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def place(x, space: MemSpace, device: Any = "cuda"):
    """Move one tensor to a memory space (identity for non-tensors and for
    tensors already there).  ``device`` is the accelerator ``DEVICE``
    means."""
    if not isinstance(x, torch.Tensor):
        return x
    if space is MemSpace.DEVICE:
        return x.to(resolve_device(device))
    if space is MemSpace.HOST and can_pin():
        return x if x.is_pinned() else x.cpu().pin_memory()
    return x.cpu()


def tree_place(tree, space: MemSpace, device: Any = "cuda"):
    """Place every tensor leaf of a tree into a memory space."""
    return tree_map(lambda x: place(x, space, device), tree)


def nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


@dataclasses.dataclass
class UnifiedArena:
    """Two named spaces over one address map: ``device`` (what DEVICE
    means) and ``host_space`` (pinned where CUDA is present).  The
    *discrete-memory* policy stages data between them with real copies; the
    *unified* policy never does — that asymmetry is the paper's measured
    effect."""
    device: Any = "cuda"
    host_space: MemSpace = MemSpace.HOST

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.host_space is MemSpace.HOST and not can_pin():
            self.host_space = MemSpace.HOST_UNPINNED

    def bytes_of(self, tree) -> int:
        return sum(nbytes(x) for x in tree_leaves(tree))
