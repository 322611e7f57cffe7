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
prompt, fills the recurrent state or the KV cache) and
:func:`decode_step` (one token against it).  The port runs the ``rwkv``
mixer with its channel-mix MLP, and the global ``attn`` and
sliding-window ``attn_local`` mixers (RoPE, GQA, an optional QKV bias)
with the dense SwiGLU MLP; a local layer's KV cache is a ring of
``min(s_max, window)`` slots.  Every other mixer raises
``NotImplementedError`` (ROADMAP A.5), and so does attention in train
mode (A.7).

Given ``layers`` (:func:`layer_fns`), each layer kind runs as a
:class:`LayerOp` and the final norm and logits as a :class:`HeadOp`,
custom ops whose bodies compile once and whose vmap rules run the solo
executable once per row.

``Ctx.rwkv_impl`` carries the reference's ``rwkv_train(impl=...)``
selection through to the entry point: ``None`` keeps the chunked closed
form with ``Ctx.rwkv_chunk``; a name picks that variant of
``RWKV6_SCAN`` (``hopper`` is the CUDA kernel K5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.regions import (CompileStats, compile_disabled,
                                      compile_region_fn)
from repro_torch.core.umem import canonical, tree_map
from repro_torch.models import attention as A
from repro_torch.models import rwkv6 as R
from repro_torch.models.layers import (embed, embed_specs, lm_logits, mlp,
                                       mlp_specs, noshard, rmsnorm,
                                       rmsnorm_spec)
from repro_torch.models.params import (ParamSpec, init_params, stack_specs,
                                       torch_dtype)


@dataclasses.dataclass
class Ctx:
    mode: str = "train"                  # train | prefill | decode
    shd: Callable = noshard
    q_chunk: int = 512
    rwkv_chunk: int = 32
    pos: Any = None                      # decode position: int or 0-d tensor
    rwkv_impl: Optional[str] = None      # RWKV6_SCAN variant; None: rwkv_chunk
    flash: bool = True                   # prefill attention: flash forward


#: the attention mixers the port runs (global, sliding window)
ATTN_MIXERS = ("attn", "attn_local")

#: the layer kinds the port runs: (mixer, mlp kind)
PORTED = (("rwkv", "cm"), ("attn", "dense"), ("attn_local", "dense"))


def _not_ported(what: str, item: str = "A.5"):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item}); the port runs the rwkv "
        "mixer with its channel-mix and the attn and attn_local mixers with "
        "the dense MLP")


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
    if (mixer, mlp_kind) not in PORTED:
        raise _not_ported(f"layer ({mixer!r}, {mlp_kind!r})")
    d = cfg.d_model
    s = {"norm1": rmsnorm_spec(d), "norm2": rmsnorm_spec(d)}
    if mixer in ATTN_MIXERS:
        return {**s, "mixer": A.attn_specs(cfg), "mlp": mlp_specs(cfg)}
    return {**s, "mixer": R.rwkv_specs(cfg), "mlp": R.channelmix_specs(cfg)}


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
# Cache / state layout: the rwkv recurrent state, the attention KV cache
# ---------------------------------------------------------------------------

def _one_layer_cache_specs(cfg, mixer, batch, s_max: int):
    if mixer in ATTN_MIXERS:
        if s_max < 1:
            raise ValueError("an attention layer's KV cache needs s_max >= 1 "
                             "slots (the prompt plus the generated tokens)")
        return A.cache_specs(cfg, mixer, batch, s_max)
    if mixer != "rwkv":
        raise _not_ported(f"mixer {mixer!r}")
    rs = R.rwkv_state_specs(cfg, batch)
    rs["x_cm"] = ParamSpec((batch, cfg.d_model), ("batch", None),
                           cfg.compute_dtype, "zeros")
    return rs


def cache_specs(cfg, batch: int, s_max: int = 0) -> dict:
    """The reference's cache layout; ``s_max`` is the KV slots of a global
    attention layer (a local layer keeps ``min(s_max, window)`` of them,
    the rwkv state has no sequence axis)."""
    return _by_plan(cfg, lambda mk, lk: _one_layer_cache_specs(cfg, mk, batch,
                                                               s_max))


def init_cache(cfg, batch: int, device, s_max: int = 0) -> list:
    """The empty cache, one dict per layer: ``{"S", "x_prev", "x_cm"}``
    (zeros) for an rwkv layer, ``{"k", "v", "pos"}`` for an attention
    layer, global or local (zeros, and -1 in every ``pos`` slot:
    empty)."""
    def empty(s):
        if s.dtype == "int32":
            return torch.full(s.shape, -1, dtype=torch.int32, device=device)
        return torch.zeros(s.shape, dtype=torch_dtype(s.dtype), device=device)
    return layers_of(cfg, tree_map(empty, cache_specs(cfg, batch, s_max)))


# ---------------------------------------------------------------------------
# Single-layer forward
# ---------------------------------------------------------------------------

def layer_fwd(p, x, cfg, mixer: str, mlp_kind: str, ctx: Ctx, cache=None):
    """Returns (x_out, new_cache)."""
    if (mixer, mlp_kind) not in PORTED:
        raise _not_ported(f"layer ({mixer!r}, {mlp_kind!r})")
    if mixer in ATTN_MIXERS:
        return _attn_layer(p, x, cfg, mixer, ctx, cache)
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


def _attn_layer(p, x, cfg, mixer: str, ctx: Ctx, cache):
    """An attention layer of kind ``mixer`` (global ``attn`` or
    sliding-window ``attn_local``) and its dense MLP: (x_out, new
    cache)."""
    h = rmsnorm(x, p["norm1"])
    if ctx.mode == "prefill":
        y, new_cache = A.attn_prefill(p["mixer"], h, cfg, kind=mixer,
                                      ctx=ctx, cache=cache)
    elif ctx.mode == "decode":
        y, new_cache = A.attn_decode(p["mixer"], h, cfg, kind=mixer,
                                     ctx=ctx, cache=cache)
    else:
        raise _not_ported("attention in train mode (attn_train)", "A.7")
    x = x + y
    return x + mlp(p["mlp"], rmsnorm(x, p["norm2"]), ctx.shd), new_cache


# ---------------------------------------------------------------------------
# Backbone drivers
# ---------------------------------------------------------------------------

def _leaves(tree: dict) -> list:
    """The tensors of a nested dict, in sorted-key order."""
    return [leaf for k in sorted(tree)
            for leaf in (_leaves(tree[k]) if isinstance(tree[k], dict)
                         else [tree[k]])]


def _rebuild(template: dict, leaves) -> dict:
    """Inverse of :func:`_leaves` over ``template``'s keys (an iterator)."""
    return {k: (_rebuild(template[k], leaves) if isinstance(template[k], dict)
                else next(leaves)) for k in sorted(template)}


#: every :class:`LayerOp` made so far, by (cfg, mixer, mlp_kind, mode, shd)
#: and the context fields that mixer reads (:func:`_ctx_key`), and every
#: :class:`HeadOp`, by (cfg, "head", shd): steps of one config share them
LAYER_OPS: Dict[tuple, "_RowOp"] = {}


def _ctx_key(mixer: str, ctx: Ctx) -> tuple:
    """The context fields a mixer reads, besides ``mode``, ``shd`` and the
    decode position (an input of the op).  The mixer itself is part of
    the op's key, so ``attn`` and ``attn_local`` are two ops."""
    if mixer == "rwkv":
        return ("rwkv", ctx.rwkv_chunk, ctx.rwkv_impl)
    return ("attn", ctx.q_chunk, ctx.flash)


class _RowOp:
    """A function of ``(params, x, cache, pos)`` as a custom op,
    ``repro_torch::<label>``, whose body runs the function compiled once
    (:func:`~repro_torch.core.regions.compile_region_fn`, ``fullgraph``;
    eagerly inside ``disable_compile``), with ``fake`` giving its outputs'
    shapes.  Its vmap rule runs the compiled body once per row of the
    vmapped axis, at the rows' own (unbatched) shapes, through a second op,
    ``repro_torch::<label>_rows``: one opaque node for all rows in a traced
    graph, whose implementation loops over the rows.  So a batched replay
    or an engine tick runs each row through the very executable a solo
    call runs, and rounds as it does."""

    def __init__(self, label: str, body: Callable, fake: Callable):
        self.label = label
        self.stats = CompileStats()
        self._compiled = None
        self.body = body

        @torch.library.custom_op(f"repro_torch::{label}", mutates_args=())
        def op(params: List[torch.Tensor], x: torch.Tensor,
               cache: List[torch.Tensor],
               pos: Optional[torch.Tensor]) -> List[torch.Tensor]:
            if compile_disabled():
                outs = body(params, x, cache, pos)
            else:
                # one layout per shape (umem.canonical), so every caller of
                # a shape runs one graph; one dispatch state on every call:
                # the compiled graph's first run reaches here with
                # ADInplaceOrView excluded, a later run not, and Dynamo
                # guards on it (a recompile)
                x, cache, pos = tree_map(canonical, (x, cache, pos))
                with torch._C._AutoDispatchBelowADInplaceOrView():
                    outs = self._executable()(params, x, cache, pos)
            return [canonical(o) for o in outs]

        @op.register_fake
        def _(params, x, cache, pos):
            return fake(params, x, cache, pos)

        @torch.library.custom_op(f"repro_torch::{label}_rows",
                                 mutates_args=())
        def rows(params: List[torch.Tensor], x: torch.Tensor,
                 cache: List[torch.Tensor],
                 pos: Optional[torch.Tensor]) -> List[torch.Tensor]:
            # x, cache and pos carry a leading row axis; params do not
            outs = [op(params, x[i].contiguous(),
                       [c[i].contiguous() for c in cache],
                       None if pos is None else pos[i].contiguous())
                    for i in range(x.shape[0])]
            return [torch.stack(o) for o in zip(*outs)]

        @rows.register_fake
        def _(params, x, cache, pos):
            one = fake(params, x[0], [c[0] for c in cache],
                       None if pos is None else pos[0])
            return [t.new_empty((x.shape[0], *t.shape)) for t in one]

        @op.register_vmap
        def _(info, in_dims, params, x, cache, pos):
            n = info.batch_size
            if any(d is not None for d in in_dims[0]):
                # batched parameters: one call per row
                def row(t, d, i):
                    return t if d is None else t.select(d, i).contiguous()
                outs = [op([row(t, d, i) for t, d in zip(params, in_dims[0])],
                           row(x, in_dims[1], i),
                           [row(t, d, i) for t, d in zip(cache, in_dims[2])],
                           None if pos is None else row(pos, in_dims[3], i))
                        for i in range(n)]
                return [torch.stack(o) for o in zip(*outs)], \
                    [0] * len(outs[0])

            def lead(t, d):
                return t.movedim(d, 0) if d is not None else \
                    t.expand(n, *t.shape)
            outs = rows(params, lead(x, in_dims[1]),
                        [lead(t, d) for t, d in zip(cache, in_dims[2])],
                        None if pos is None else lead(pos, in_dims[3]))
            return outs, [0] * len(outs)

        self.op = op
        self.rows = rows

    def _executable(self):
        if self._compiled is None:
            self._compiled = compile_region_fn(self.body, self.label,
                                               stats=self.stats)
        return self._compiled


def _like_inputs(params, x, cache, pos):
    """Outputs shaped, typed and laid out as ``x`` and the cache leaves."""
    return [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in (x, *cache)]


class LayerOp(_RowOp):
    """One layer kind of ``cfg`` under ``ctx`` as a custom op (a
    :class:`_RowOp`), whose body runs the layer compiled once.

    A compiled step holds each layer call as one opaque node, so its graph
    and its compile time do not grow with the depth: the layer compiles
    once, when a step first runs it, however many layers call it.  (A
    ``torch.compiler.nested_compile_region`` keeps one graph too, but on
    torch 2.11 Dynamo traced and Inductor lowered every call of it anew,
    and it has no batching rule.)

    The op's inputs are the parameters, ``x``, the cache leaves and the
    decode position (a 0-d tensor, or None outside decode).  Its outputs
    are ``x`` and the new cache leaves, contiguous; its fake implementation
    gives each the shape, dtype and layout of the input it replaces (a
    layer maps ``x`` and its recurrent state or KV cache to tensors like
    them)."""

    def __init__(self, cfg, mixer: str, mlp_kind: str, ctx: Ctx):
        impl = (ctx.rwkv_impl or "ref") if mixer == "rwkv" else \
            ("flash" if ctx.flash else "chunked")
        template = _one_layer_specs(cfg, mixer, mlp_kind)
        self._cache_keys = tuple(_one_layer_cache_specs(cfg, mixer, 1, 1))

        def layer(params, x, cache, pos):
            p = _rebuild(template, iter(params))
            c = dict(zip(self._cache_keys, cache)) if cache else None
            lctx = ctx if pos is None else dataclasses.replace(ctx, pos=pos)
            x, nc = layer_fwd(p, x, cfg, mixer, mlp_kind, lctx, c)
            return [x] if nc is None else [x, *(nc[k] for k in
                                                self._cache_keys)]
        self.layer = layer
        super().__init__(f"layer_{mixer}_{mlp_kind}_{ctx.mode}_{impl}_"
                         f"{len(LAYER_OPS)}", layer, _like_inputs)

    def __call__(self, p, x, cache=None, pos=None):
        """``(x, new cache or None)`` of one layer with parameters ``p``;
        ``pos`` is the decode position (an int or a 0-d tensor)."""
        keys = self._cache_keys if cache is not None else ()
        if pos is not None:
            pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        x, *state = self.op(_leaves(p), x, [cache[k] for k in keys], pos)
        return x, (None if cache is None else
                   {k: state[keys.index(k)] for k in cache})


class HeadOp(_RowOp):
    """The final norm and the logits of ``cfg`` as a custom op (a
    :class:`_RowOp`): ``x [B, T, d] -> logits [B, T, vocab]``.  A decode
    tick that batches its slots under ``vmap`` runs each slot's head
    through the executable a solo decode step runs, so both round alike
    and their greedy tokens agree."""

    def __init__(self, cfg, shd):
        def head(params, x, cache, pos):
            norm, w = params
            p = {"tok": w} if cfg.tie_embeddings else {"head": w}
            return [lm_logits(p, rmsnorm(x, norm), cfg, shd)]

        def fake(params, x, cache, pos):
            return [x.new_empty((*x.shape[:-1], cfg.vocab))]
        super().__init__(f"head_{len(LAYER_OPS)}", head, fake)
        self.tied = cfg.tie_embeddings

    def __call__(self, params, x):
        """Logits of ``x`` under the model's ``params`` (``x`` copied to
        the strides of a fresh tensor, size-1 axes included: a prefill's
        last position and a decode step's token then reach one
        executable)."""
        emb = params["embed"]
        w = emb["tok"] if self.tied else emb["head"]
        x = x.clone(memory_format=torch.contiguous_format)
        return self.op([params["final_norm"], w], x, [], None)[0]


def layer_fns(cfg, ctx: Ctx) -> dict:
    """``{(mixer, mlp_kind): LayerOp, "head": HeadOp}`` for the layer kinds
    of ``cfg`` under ``ctx`` (the mode's context; its ``pos`` is not read:
    the position is an input of each call), made once per config, mode and
    the context fields its mixer reads (the head once per config).  Build
    them outside any compiled function and pass them to :func:`prefill` /
    :func:`decode_step` as ``layers``."""
    fns = {}
    for mk, lk in dict.fromkeys(layer_kinds(cfg)):
        key = (cfg, mk, lk, ctx.mode, ctx.shd, _ctx_key(mk, ctx))
        if key not in LAYER_OPS:
            LAYER_OPS[key] = LayerOp(cfg, mk, lk, ctx)
        fns[(mk, lk)] = LAYER_OPS[key]
    key = (cfg, "head", ctx.shd)
    if key not in LAYER_OPS:
        LAYER_OPS[key] = HeadOp(cfg, ctx.shd)
    fns["head"] = LAYER_OPS[key]
    return fns


def _run_layers(params, x, cfg, ctx: Ctx, caches=None, layers=None):
    """Run the layer program; returns (x, new_caches or None).  ``layers``
    (from :func:`layer_fns`) runs each layer through its kind's op, else
    each layer runs inline."""
    new_caches = []
    for i, (mk, lk) in enumerate(layer_kinds(cfg)):
        c = caches[i] if caches is not None else None
        if layers is None:
            x, nc = layer_fwd(params["layers"][i], x, cfg, mk, lk, ctx, c)
        else:
            x, nc = layers[(mk, lk)](params["layers"][i], x, c, ctx.pos)
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def prefill(params, batch, cfg, ctx: Ctx, caches, layers=None):
    """Fill caches from a full prompt; returns (last-token logits, caches).
    ``layers``: :func:`layer_fns` of ``cfg`` in prefill mode, or None."""
    ctx = dataclasses.replace(ctx, mode="prefill")
    x = embed(params["embed"], batch["tokens"], cfg, ctx.shd)
    x, caches = _run_layers(params, x, cfg, ctx, caches, layers)
    return _head(params, x[:, -1:], cfg, ctx, layers), caches


def decode_step(params, token, caches, pos, cfg, ctx: Ctx, layers=None):
    """token [B] int; pos int or 0-d int tensor (moved to the token's
    device once, for every layer).  Returns (logits [B,1,V], caches).
    ``layers``: :func:`layer_fns` of ``cfg`` in decode mode, or None."""
    x = embed(params["embed"], token[:, None], cfg, ctx.shd)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    ctx = dataclasses.replace(ctx, mode="decode", pos=pos)
    x, caches = _run_layers(params, x, cfg, ctx, caches, layers)
    return _head(params, x, cfg, ctx, layers), caches


def _head(params, x, cfg, ctx: Ctx, layers=None):
    """The final norm and the logits: through the head op of ``layers``
    when given, else inline."""
    if layers is not None:
        return layers["head"](params, x)
    return lm_logits(params["embed"], rmsnorm(x, params["final_norm"]), cfg,
                     ctx.shd)
