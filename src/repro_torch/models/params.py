"""Parameter-spec machinery (counterpart of ``repro.models.params``).

A model is described as a tree (nested dicts) of :class:`ParamSpec`:
shape, logical axis names and init law.  :func:`init_params` turns it into
tensors from an explicit ``torch.Generator`` on an explicit device.  The
init laws are the reference's: ``zeros``, ``ones``, the ``rwkv_decay``
ramp, and ``normal`` scaled by ``1/sqrt(fan_in)`` with ``fan_in =
shape[0]`` (for a spec stacked by :func:`stack_specs` that is the layer
count, as in the reference).  ``jax.random`` and ``torch.Generator`` draw
different numbers from one seed, so tests that compare the two packages
convert one parameter tree (``repro_torch.models.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.umem import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names (len == ndim)
    dtype: str = "bfloat16"
    init: str = "normal"                 # normal | zeros | ones | rwkv_decay
    scale: Optional[float] = None        # default: 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the configs name dtypes as the
    reference does)."""
    return getattr(torch, name)


def init_one(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "rwkv_decay":
        # w0 so that exp(-exp(w0)) spans a useful decay range per channel
        n = math.prod(spec.shape)
        ramp = torch.linspace(-6.0, 1.0, n, device=device)
        return ramp.reshape(spec.shape).to(dt)
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else \
        max(spec.shape[-1] if spec.shape else 1, 1)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dt)


def init_params(gen: torch.Generator, specs, device):
    """Tensors for every :class:`ParamSpec` of ``specs`` (same tree)."""
    return tree_map(lambda s: init_one(gen, s, device), specs)


def stack_specs(specs, n: int, axis_name: str = "layers"):
    """Add a leading stacking dimension of size ``n`` to every spec."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes,
                                        s.dtype, s.init, s.scale), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
