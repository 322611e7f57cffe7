"""AdamW of the port (counterpart of ``repro.optim.adamw``).

The optimizer state is a plain tree mirroring the parameters (moments in
``moment_dtype``, f32 by default) plus a 0-d int32 step counter.  Under
``--offload-optimizer`` the ``ADAMW_UPDATE`` region
(:func:`repro_torch.train.step.make_train_regions`) carries host-space
placement hints on the state; the math here is the same either way.

Two implementations of one update ship as region variants:
:func:`apply_updates` (one pass over the leaves, ``ref``) and
:func:`apply_updates_leafwise` (three passes, one kind of op at a time:
the ``host`` variant).  Both walk the leaves in one order with the same
per-leaf operations, in f32, cast back to each leaf's dtype, so their
results are bit for bit equal on one device when both run eagerly.

Outside :func:`~repro_torch.core.regions.disable_compile`,
:func:`apply_updates` runs each leaf through two executables compiled
once per config and dtype (:func:`_leaf_executables`): the leaf's sum of
squares and its update, on the flattened leaf with its length dynamic.
A model of 200 leaves then compiles four small graphs, not one graph of
200 updates (which Inductor took 368 s to compile for tinyllama-1.1b on
an H100).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.regions import (CompileStats, compile_disabled,
                                      compile_region_fn)
from repro_torch.models.params import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def init_state(params, cfg: AdamWConfig):
    """Zero moments like ``params`` (on each leaf's device) and step 0."""
    dt = torch_dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    step_dev = pytree.tree_leaves(params)[0].device
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def _sumsq(leaf):
    return torch.sum(torch.square(leaf.float()))


def global_norm(tree, sumsq=_sumsq) -> torch.Tensor:
    """sqrt of the sum, leaf after leaf, of each leaf's f32 sum of
    squares."""
    total = None
    for leaf in pytree.tree_leaves(tree):
        sq = sumsq(leaf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _schedule(state, gnorm, cfg: AdamWConfig, lr_scale):
    """(clip, step, bc1, bc2, lr) of one update, as the reference computes
    them: f32 scalars on the step counter's device."""
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    t = step.float()
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    return clip, step, bc1, bc2, cfg.lr * lr_scale


def _update_param(p, m, v, bc1, bc2, lr, cfg: AdamWConfig):
    u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    pf = p.float()
    return (pf - lr * (u + cfg.weight_decay * pf)).to(p.dtype)


def _leaf_update(cfg: AdamWConfig, lr: float):
    """The update of one leaf: (p, g, m, v, clip, bc1, bc2) -> (p, m,
    v)."""
    state_dt = torch_dtype(cfg.moment_dtype)

    def upd(p, g, m, v, clip, bc1, bc2):
        g = g.float() * clip
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        return (_update_param(p, m, v, bc1, bc2, lr, cfg), m.to(state_dt),
                v.to(state_dt))
    return upd


#: (config, lr, dtype) -> (sum of squares, update) compiled executables
_EXECUTABLES: Dict[tuple, tuple] = {}


def _leaf_executables(cfg: AdamWConfig, lr: float, dtype) -> tuple:
    key = (cfg, lr, dtype)
    if key not in _EXECUTABLES:
        name = str(dtype).removeprefix("torch.")
        _EXECUTABLES[key] = (
            compile_region_fn(_sumsq, f"adamw_sumsq_{name}",
                              stats=CompileStats()),
            compile_region_fn(_leaf_update(cfg, lr), f"adamw_leaf_{name}",
                              stats=CompileStats()))
    return _EXECUTABLES[key]


def compile_stats() -> Dict[str, CompileStats]:
    """The compile records of the per-leaf executables made so far."""
    return {fn.stats.code.co_name: fn.stats
            for pair in _EXECUTABLES.values() for fn in pair}


def _flat(t):
    """``t`` as one dynamic-length axis (one graph for every leaf)."""
    t = t.reshape(-1)
    torch._dynamo.mark_dynamic(t, 0)
    return t


def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step.  Returns (new_params, new_state, grad_norm)."""
    lr = cfg.lr * lr_scale
    if compile_disabled():
        gnorm = global_norm(grads)
        upd = _leaf_update(cfg, lr)
    else:
        def sumsq(g):
            return _leaf_executables(cfg, lr, g.dtype)[0](_flat(g))
        gnorm = global_norm(grads, sumsq)

        def upd(p, g, m, v, clip, bc1, bc2):
            out = _leaf_executables(cfg, lr, p.dtype)[1](
                *map(_flat, (p, g, m, v)), clip, bc1, bc2)
            return tuple(o.reshape(p.shape) for o in out)
    clip, step, bc1, bc2, _ = _schedule(state, gnorm, cfg, lr_scale)
    out = pytree.tree_map(
        lambda p, g, m, v: upd(p, g, m, v, *(t.to(p.device)
                                             for t in (clip, bc1, bc2))),
        params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (pytree.tree_map(
        lambda o, j=j: o[j], out, is_leaf=lambda o: isinstance(o, tuple))
        for j in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm


def apply_updates_leafwise(params, grads, state, cfg: AdamWConfig,
                           lr_scale=1.0):
    """The ``host`` variant of :func:`apply_updates`: the same per-leaf
    math and leaf order, as three passes over the leaves (clipped
    gradients, then the moments, then the parameters), so each pass is one
    small op per leaf."""
    gnorm = global_norm(grads)
    clip, step, bc1, bc2, lr = _schedule(state, gnorm, cfg, lr_scale)
    state_dt = torch_dtype(cfg.moment_dtype)
    tm = pytree.tree_map
    gclip = tm(lambda g: g.float() * clip.to(g.device), grads)
    new_m = tm(lambda g, m: cfg.b1 * m.float() + (1 - cfg.b1) * g,
               gclip, state["m"])
    new_v = tm(lambda g, v: cfg.b2 * v.float() + (1 - cfg.b2) * g * g,
               gclip, state["v"])
    new_p = tm(lambda p, m, v: _update_param(
        p, m, v, bc1.to(p.device), bc2.to(p.device), lr, cfg),
        params, new_m, new_v)

    def cast(t):
        return tm(lambda x: x.to(state_dt), t)
    return new_p, {"m": cast(new_m), "v": cast(new_v), "step": step}, gnorm
