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
from typing import Any, Callable, Optional

import torch


class MemSpace(enum.Enum):
    DEVICE = "device"            # HBM
    HOST = "pinned_host"         # DMA-able host DRAM
    HOST_UNPINNED = "unpinned_host"


def resolve_device(device: Any = "cuda") -> torch.device:
    """``torch.device`` for ``device``, a CUDA device with its index (the
    current device's for a bare ``"cuda"``, so that it compares equal to
    the ``.device`` of the tensors made on it); raises when CUDA is asked
    for and absent — the port never carries on silently on the CPU."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
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
        if x.is_pinned():
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x)                 # one copy, straight into pages
    return x.cpu()


def tree_place(tree, space: MemSpace, device: Any = "cuda",
               min_bytes: int = 0):
    """Place every tensor leaf of a tree into a memory space.

    ``min_bytes`` is a placement threshold (paper C4's "pool only buffers
    above 5K elements", applied to placement): leaves smaller than it stay
    where they are — moving a scalar across spaces costs more than it
    saves."""
    def maybe(x):
        if min_bytes and nbytes(x) < min_bytes:
            return x
        return place(x, space, device)
    return tree_map(maybe, tree)


def default_spill_space() -> MemSpace:
    """Where a leaf lands when the device budget lacks room: pinned host
    memory on a CUDA build, pageable CPU memory otherwise."""
    return MemSpace.HOST if can_pin() else MemSpace.HOST_UNPINNED


def tree_place_budgeted(tree, budget, device: Any = "cuda",
                        min_bytes: int = 0,
                        device_space: MemSpace = MemSpace.DEVICE,
                        spill_space: Optional[MemSpace] = None,
                        charge: bool = True):
    """Place leaves into ``device_space`` while ``budget`` (a
    :class:`~repro_torch.core.oversub.MemoryBudget`, duck-typed ``admit``/
    ``consult``) has headroom; leaves beyond it land in ``spill_space``
    (:func:`default_spill_space` when None) instead of failing — the
    oversubscription model: exceeding device capacity degrades placement,
    never correctness.  ``charge=True`` accounts admitted leaves as
    device-resident (``budget.admit``; the caller releases them);
    ``charge=False`` only consults — the advisory form used for per-call
    placement hints.  Leaves are visited in :func:`tree_map` order, so the
    same tree under the same budget always splits the same way (``None``
    is no leaf, as in ``jax.tree.map``)."""
    spill = spill_space or default_spill_space()

    def maybe(x):
        if x is None:
            return x
        n = nbytes(x)
        if min_bytes and n < min_bytes:
            return x
        ok = budget.admit(n) if charge else budget.consult(n)
        return place(x, device_space if ok else spill, device)
    return tree_map(maybe, tree)


def canonical(x):
    """``x`` with the strides of a fresh tensor of its shape, size-1 axes
    included (a copy only where they differ; anything but a tensor as it
    is).  ``Tensor.contiguous`` keeps any stride on a size-1 axis, and a
    compiled executable guards on every stride, so two callers passing
    one shape in two layouts would run two graphs, which may round
    differently."""
    if not isinstance(x, torch.Tensor):
        return x
    want, acc = [], 1
    for n in reversed(x.shape):
        want.append(acc)
        acc *= max(n, 1)
    if x.stride() == tuple(reversed(want)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


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
