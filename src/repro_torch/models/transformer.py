"""Decoder LM of the port over a *layer program* (counterpart of
``repro.models.transformer``).

A config's ``layer_cycle`` is tiled to ``n_layers``; :func:`layer_plan`
splits it, as the reference does, into full cycles and a remainder.  The
reference scans over weights stacked per cycle position; the port keeps
that layout only for specs and init (so the init laws see the same
shapes) and runs the layers as a Python loop over per-layer parameter
dicts (``params["layers"][i]``, cache ``caches[i]``), which
:func:`layers_of` unstacks.

Two entry points share the layer interpreter: :func:`prefill` (full
prompt, fills the recurrent state) and :func:`decode_step` (one token
against it).  The port runs the ``rwkv`` mixer with its channel-mix MLP;
every other mixer raises ``NotImplementedError`` (ROADMAP A.7).

``Ctx.rwkv_impl`` carries the reference's ``rwkv_train(impl=...)``
selection through to the entry point: ``None`` keeps the chunked closed
form with ``Ctx.rwkv_chunk``; a name picks that variant of
``RWKV6_SCAN`` (``hopper`` is the CUDA kernel K5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.umem import tree_map
from repro_torch.models import rwkv6 as R
from repro_torch.models.layers import (embed, embed_specs, lm_logits, noshard,
                                       rmsnorm, rmsnorm_spec)
from repro_torch.models.params import (ParamSpec, init_params, stack_specs,
                                       torch_dtype)


@dataclasses.dataclass
class Ctx:
    mode: str = "train"                  # train | prefill | decode
    shd: Callable = noshard
    rwkv_chunk: int = 32
    pos: Optional[int] = None            # decode position
    rwkv_impl: Optional[str] = None      # RWKV6_SCAN variant; None: rwkv_chunk


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A.7); the "
                               "port runs the rwkv mixer with its channel-mix")


# ---------------------------------------------------------------------------
# Layer program
# ---------------------------------------------------------------------------

def _effective_cycle(cfg):
    """Cycle of (mixer_kind, mlp_kind), extended to lcm with moe periodicity."""
    base = cfg.layer_cycle
    period = math.lcm(len(base), cfg.moe_every if cfg.moe else 1)
    cyc = []
    for i in range(period):
        mixer = base[i % len(base)]
        if cfg.moe is not None and (i % cfg.moe_every) == cfg.moe_offset:
            mlp_kind = "moe"
        elif mixer == "rwkv":
            mlp_kind = "cm"
        else:
            mlp_kind = "dense"
        cyc.append((mixer, mlp_kind))
    return tuple(cyc)


def layer_plan(cfg):
    """Returns (cycle, n_full_cycles, remainder_kinds)."""
    cyc = _effective_cycle(cfg)
    n_full = cfg.n_layers // len(cyc)
    rem = [cyc[i % len(cyc)] for i in range(n_full * len(cyc), cfg.n_layers)]
    return cyc, n_full, tuple(rem)


def layer_kinds(cfg):
    """(mixer, mlp_kind) of every layer, in order."""
    cyc, n_full, rem = layer_plan(cfg)
    return list(cyc) * n_full + list(rem)


def layers_of(cfg, tree) -> list:
    """Per-layer subtrees, in layer order, of a tree in the reference's
    layout: ``cycles/p{j}`` stacked along axis 0 (layer ``i*len(cycle)+j``),
    then ``rest{r}``."""
    cyc, n_full, rem = layer_plan(cfg)
    out = [tree_map(lambda a, i=i: a[i], tree["cycles"][f"p{j}"])
           for i in range(n_full) for j in range(len(cyc))]
    return out + [tree[f"rest{r}"] for r in range(len(rem))]


def _one_layer_specs(cfg, mixer: str, mlp_kind: str) -> dict:
    if mixer != "rwkv":
        raise _not_ported(f"mixer {mixer!r}")
    if mlp_kind != "cm":
        raise _not_ported(f"mlp {mlp_kind!r}")
    d = cfg.d_model
    return {"norm1": rmsnorm_spec(d), "norm2": rmsnorm_spec(d),
            "mixer": R.rwkv_specs(cfg), "mlp": R.channelmix_specs(cfg)}


def _by_plan(cfg, one) -> dict:
    """The reference's layout of per-layer specs ``one(mixer, mlp_kind)``."""
    cyc, n_full, rem = layer_plan(cfg)
    specs: Dict[str, Any] = {}
    if n_full:
        specs["cycles"] = {f"p{j}": stack_specs(one(mk, lk), n_full)
                           for j, (mk, lk) in enumerate(cyc)}
    for r, (mk, lk) in enumerate(rem):
        specs[f"rest{r}"] = one(mk, lk)
    return specs


def param_specs(cfg) -> dict:
    return {"embed": embed_specs(cfg),
            **_by_plan(cfg, lambda mk, lk: _one_layer_specs(cfg, mk, lk)),
            "final_norm": rmsnorm_spec(cfg.d_model)}


def init(gen: torch.Generator, cfg, device) -> dict:
    """Random parameters from ``gen`` on ``device``: ``{"embed", "layers",
    "final_norm"}``."""
    t = init_params(gen, param_specs(cfg), device)
    return {"embed": t["embed"], "layers": layers_of(cfg, t),
            "final_norm": t["final_norm"]}


# ---------------------------------------------------------------------------
# Recurrent state (the rwkv "cache")
# ---------------------------------------------------------------------------

def _one_layer_cache_specs(cfg, mixer, batch):
    if mixer != "rwkv":
        raise _not_ported(f"mixer {mixer!r}")
    rs = R.rwkv_state_specs(cfg, batch)
    rs["x_cm"] = ParamSpec((batch, cfg.d_model), ("batch", None),
                           cfg.compute_dtype, "zeros")
    return rs


def cache_specs(cfg, batch: int) -> dict:
    return _by_plan(cfg, lambda mk, lk: _one_layer_cache_specs(cfg, mk, batch))


def init_cache(cfg, batch: int, device) -> list:
    """Zero state, one dict ``{"S", "x_prev", "x_cm"}`` per layer."""
    zeros = tree_map(lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                           device=device),
                     cache_specs(cfg, batch))
    return layers_of(cfg, zeros)


# ---------------------------------------------------------------------------
# Single-layer forward
# ---------------------------------------------------------------------------

def layer_fwd(p, x, cfg, mixer: str, mlp_kind: str, ctx: Ctx, cache=None):
    """Returns (x_out, new_cache)."""
    if mixer != "rwkv" or mlp_kind != "cm":
        raise _not_ported(f"layer ({mixer!r}, {mlp_kind!r})")
    h = rmsnorm(x, p["norm1"])
    state = None
    if cache is not None:
        state = {"S": cache["S"], "x_prev": cache["x_prev"]}
    if ctx.mode == "decode":
        y, ns = R.rwkv_decode(p["mixer"], h, cfg, ctx=ctx, state=state)
    else:
        y, ns = R.rwkv_train(p["mixer"], h, cfg, ctx=ctx, state=state,
                             chunk=ctx.rwkv_chunk, impl=ctx.rwkv_impl)
    x = x + y

    h2 = rmsnorm(x, p["norm2"])
    # channel-mix token shift: train shifts in-sequence; decode uses state
    if ctx.mode == "decode" and cache is not None:
        shift = cache["x_cm"][:, None]
    else:
        prev = cache["x_cm"] if (cache is not None and ctx.mode == "prefill") \
            else torch.zeros((h2.shape[0], h2.shape[-1]), dtype=h2.dtype,
                             device=h2.device)
        shift = torch.cat([prev[:, None], h2[:, :-1]], dim=1)
    y2 = R.channelmix(p["mlp"], h2, shift, cfg, ctx.shd)
    new_cache = None if cache is None else \
        {**cache, **ns, "x_cm": h2[:, -1].clone()}      # not a view of h2
    return x + y2, new_cache


# ---------------------------------------------------------------------------
# Backbone drivers
# ---------------------------------------------------------------------------

def _run_layers(params, x, cfg, ctx: Ctx, caches=None):
    """Run the layer program; returns (x, new_caches or None)."""
    new_caches = []
    for i, (mk, lk) in enumerate(layer_kinds(cfg)):
        c = caches[i] if caches is not None else None
        x, nc = layer_fwd(params["layers"][i], x, cfg, mk, lk, ctx, c)
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def prefill(params, batch, cfg, ctx: Ctx, caches):
    """Fill caches from a full prompt; returns (last-token logits, caches)."""
    ctx = dataclasses.replace(ctx, mode="prefill")
    x = embed(params["embed"], batch["tokens"], cfg, ctx.shd)
    x, caches = _run_layers(params, x, cfg, ctx, caches)
    x = rmsnorm(x[:, -1:], params["final_norm"])
    return lm_logits(params["embed"], x, cfg, ctx.shd), caches


def decode_step(params, token, caches, pos, cfg, ctx: Ctx):
    """token [B] int; pos int.  Returns (logits [B,1,V], caches)."""
    ctx = dataclasses.replace(ctx, mode="decode", pos=pos)
    x = embed(params["embed"], token[:, None], cfg, ctx.shd)
    x, caches = _run_layers(params, x, cfg, ctx, caches)
    x = rmsnorm(x, params["final_norm"])
    return lm_logits(params["embed"], x, cfg, ctx.shd), caches
