"""Carry a parameter tree and a recurrent state across from the JAX
package.

The reference keeps per-layer weights stacked per cycle position
(``cycles/p{j}``, leading axis = cycle index) plus the remainder layers
``rest{r}``; the port keeps one dict per layer.  :func:`params_from_jax`
and :func:`cache_from_jax` take the reference's trees with numpy leaves
(``np.asarray`` of its arrays, bfloat16 included) and return the port's,
so both packages can be run on the same weights and state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.umem import resolve_device, tree_map
from repro_torch.models.transformer import layers_of


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's parameter tree -> ``{"embed", "layers",
    "final_norm"}`` of the port."""
    device = resolve_device(device)
    t = tree_map(lambda a: _tensor(a, device), tree)
    return {"embed": t["embed"], "layers": layers_of(cfg, t),
            "final_norm": t["final_norm"]}


def cache_from_jax(tree, cfg, device="cuda") -> list:
    """The reference's cache tree -> one state dict per layer."""
    device = resolve_device(device)
    return layers_of(cfg, tree_map(lambda a: _tensor(a, device), tree))
