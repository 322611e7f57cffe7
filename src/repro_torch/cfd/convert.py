"""Carry state across from the JAX package.

The system has no weights; its state is ``SimpleState(u, v, w, p)`` and
the DIA systems.  :func:`from_numpy` turns that state, given as numpy
arrays (``np.asarray`` of the JAX package's arrays), into the port's
tensors, so both sides can be fed the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.cfd.dia import DiaMatrix
from repro_torch.cfd.precond import RBDilu
from repro_torch.cfd.simple import SimpleState
from repro_torch.core.umem import resolve_device

#: the port's class for each convertible class name of the JAX package
_CLASSES = {"DiaMatrix": DiaMatrix, "RBDilu": RBDilu,
            "SimpleState": SimpleState}


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """Convert arrays and the JAX package's ``DiaMatrix`` / ``RBDilu`` /
    ``SimpleState`` objects (matched by class name and fields) into the
    port's tensors on ``device``.  Tuples, lists and dicts are walked;
    other leaves pass through.  ``RBDilu.red`` becomes ``torch.bool``."""
    device = resolve_device(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    cls = _CLASSES.get(type(tree).__name__)
    if cls is not None:
        kw = {f.name: from_numpy(getattr(tree, f.name), device)
              for f in dataclasses.fields(cls)}
        if cls is RBDilu:
            kw["red"] = kw["red"].to(torch.bool)
        return cls(**kw)
    if hasattr(tree, "__array__"):
        return _tensor(tree, device)
    return tree
