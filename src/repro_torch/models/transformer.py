"""Decoder LM of the port over a *layer program* (counterpart of
``repro.models.transformer``).

A config's ``layer_cycle`` is tiled to ``n_layers``; :func:`layer_plan`
splits it, as the reference does, into full cycles and a remainder.  The
reference scans over weights stacked per cycle position; the port keeps
that layout only for specs and init (so the init laws see the same
shapes) and runs the layers as a Python loop over per-layer parameter
dicts (``params["layers"][i]``, cache ``caches[i]``), which
:func:`layers_of` unstacks.

Three entry points share the layer interpreter: :func:`forward_train`
(full sequence, no cache), :func:`prefill` (full prompt, fills the
recurrent state or the KV cache) and :func:`decode_step` (one token
against it).  The port runs the ``rwkv`` mixer with its channel-mix MLP,
the global ``attn`` and sliding-window ``attn_local`` mixers (RoPE, GQA,
an optional QKV bias) and the RG-LRU ``rglru`` mixer with the dense
SwiGLU MLP, and ``attn`` with the MoE MLP (:mod:`repro_torch.models.moe`);
a local layer's KV cache is a ring of ``min(s_max, window)`` slots, an
RG-LRU layer's state its ``h`` (f32) and conv window.  Every other layer
kind raises ``NotImplementedError`` (ROADMAP A.5.6, A.5.7).  A layer
returns the MoE load-balancing loss ``aux`` beside its output, as the
reference's does (0 for a dense MLP); training sums it over the layers.

The residual stream rounds where the reference's does (ROADMAP C.2):
the reference runs a scanned layer cycle (and the remainder) as one XLA
computation, which fuses each residual add into the RMSNorm that reads
it and keeps the sum in f32 there, while the stream it stores (a scan
carry) is in the compute dtype.  So a layer takes and returns the stream
as f32 (the unrounded sum of its last residual add), every residual add
reads its rounding, and :func:`_carry` rounds it at the reference's scan
carries.

Given ``layers`` (:func:`layer_fns`), each layer kind runs as a
:class:`LayerOp` and the final norm and logits as a :class:`HeadOp`,
custom ops whose bodies compile once.  A decode-mode op runs its rows in
groups of a fixed count (:data:`DECODE_ROWS`); a decode step pads its rows
to that count once, at its boundary, and an engine keeps its slot cache at
it, so every row of a solo step, a static batch and an engine tick rounds
alike.  The ops' vmap rules call an op once for all the rows of all the
instances.

In training (``Ctx.remat``, the default, as the reference wraps each
layer cycle in ``jax.checkpoint``) each layer kind runs as a
:class:`TrainLayer`: two executables compiled once, a forward that keeps
no activations and a VJP that recomputes the layer, joined by an
``autograd.Function``.  So compile time does not grow with the depth, and
the backward holds one layer's activations at a time.

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
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
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
    flash: bool = True                   # flash attention (train: its VJP)
    remat: bool = True                   # train: recompute each layer


#: the attention mixers the port runs (global, sliding window)
ATTN_MIXERS = ("attn", "attn_local")

#: the layer kinds the port runs: (mixer, mlp kind)
PORTED = (("rwkv", "cm"), ("attn", "dense"), ("attn_local", "dense"),
          ("rglru", "dense"), ("attn", "moe"))

#: the ROADMAP item that ports each mixer still waiting
_WAITING = {"attn_enc": "A.5.7", "attn_xdec": "A.5.7"}


def _not_ported(what: str, mixer: str = ""):
    item = _WAITING.get(mixer, "A.5")
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item}); the port runs: "
        + ", ".join(f"({m}, {k})" for m, k in PORTED))


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
        raise _not_ported(f"layer ({mixer!r}, {mlp_kind!r})", mixer)
    d = cfg.d_model
    s = {"norm1": rmsnorm_spec(d), "norm2": rmsnorm_spec(d)}
    if mixer in ATTN_MIXERS:
        s["mixer"] = A.attn_specs(cfg)
    elif mixer == "rglru":
        s["mixer"] = G.rglru_specs(cfg)
    else:
        s["mixer"] = R.rwkv_specs(cfg)
    if mlp_kind == "moe":
        s["mlp"] = M.moe_specs(cfg)
    elif mlp_kind == "cm":
        s["mlp"] = R.channelmix_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


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
# Cache / state layout: the recurrent states (rwkv, RG-LRU), the attention
# KV cache
# ---------------------------------------------------------------------------

def _one_layer_cache_specs(cfg, mixer, batch, s_max: int):
    if mixer in ATTN_MIXERS:
        if s_max < 1:
            raise ValueError("an attention layer's KV cache needs s_max >= 1 "
                             "slots (the prompt plus the generated tokens)")
        return A.cache_specs(cfg, mixer, batch, s_max)
    if mixer == "rglru":
        return G.rglru_state_specs(cfg, batch)
    if mixer != "rwkv":
        raise _not_ported(f"mixer {mixer!r}", mixer)
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


def init_row_cache(cfg, rows: int, device, s_max: int = 0) -> list:
    """:func:`init_cache` at batch ``rows`` with a leading row axis on
    every leaf: a leaf without a batch axis (a KV cache's slot positions)
    is held once per row, so each row may sit at its own position (an
    engine's slots)."""
    caches = init_cache(cfg, rows, device, s_max)
    for c, (mk, _) in zip(caches, layer_kinds(cfg)):
        for k, sp in _one_layer_cache_specs(cfg, mk, rows, s_max).items():
            if "batch" not in sp.axes:
                c[k] = torch.stack([c[k]] * rows)
    return caches


def init_cache(cfg, batch: int, device, s_max: int = 0) -> list:
    """The empty cache, one dict per layer: ``{"S", "x_prev", "x_cm"}``
    (zeros) for an rwkv layer, ``{"h", "conv"}`` (zeros) for an RG-LRU
    layer, ``{"k", "v", "pos"}`` for an attention layer, global or local
    (zeros, and -1 in every ``pos`` slot: empty)."""
    def empty(s):
        if s.dtype == "int32":
            return torch.full(s.shape, -1, dtype=torch.int32, device=device)
        return torch.zeros(s.shape, dtype=torch_dtype(s.dtype), device=device)
    return layers_of(cfg, tree_map(empty, cache_specs(cfg, batch, s_max)))


# ---------------------------------------------------------------------------
# Single-layer forward
# ---------------------------------------------------------------------------

def layer_fwd(p, x, cfg, mixer: str, mlp_kind: str, ctx: Ctx, cache=None):
    """Returns (x_out, new_cache, aux_loss): ``aux`` the MoE layer's
    load-balancing loss, a 0-d f32 zero for any other MLP.

    ``x`` is the residual stream, in f32 where the reference keeps it
    unrounded (:func:`_run_layers`), and ``x_out`` is the f32 sum of the
    layer's last residual add; the stream itself, which every residual
    add reads, is their rounding to the compute dtype."""
    if (mixer, mlp_kind) not in PORTED:
        raise _not_ported(f"layer ({mixer!r}, {mlp_kind!r})", mixer)
    cdt = torch_dtype(cfg.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x.float(), p["norm1"]).to(cdt)
    x = x.to(cdt)
    new_cache = cache
    if mixer in ATTN_MIXERS:
        if ctx.mode == "prefill":
            y, new_cache = A.attn_prefill(p["mixer"], h, cfg, kind=mixer,
                                          ctx=ctx, cache=cache)
        elif ctx.mode == "decode":
            y, new_cache = A.attn_decode(p["mixer"], h, cfg, kind=mixer,
                                         ctx=ctx, cache=cache)
        else:
            y = A.attn_train(p["mixer"], h, cfg, kind=mixer, ctx=ctx)
    elif mixer == "rglru":
        state = None
        if cache is not None:
            state = {"h": cache["h"], "conv": cache["conv"]}
        if ctx.mode == "decode":
            y, ns = G.rglru_decode(p["mixer"], h, cfg, ctx=ctx, state=state)
        else:
            y, ns = G.rglru_train(p["mixer"], h, cfg, ctx=ctx, state=state)
        if cache is not None:
            new_cache = ns
    else:
        state = None
        if cache is not None:
            state = {"S": cache["S"], "x_prev": cache["x_prev"]}
        if ctx.mode == "decode":
            y, ns = R.rwkv_decode(p["mixer"], h, cfg, ctx=ctx, state=state)
        else:
            y, ns = R.rwkv_train(p["mixer"], h, cfg, ctx=ctx, state=state,
                                 chunk=ctx.rwkv_chunk, impl=ctx.rwkv_impl)
        if cache is not None:
            new_cache = {**cache, **ns}
    # the reference's XLA fuses this residual add into the norm below and
    # keeps the sum in f32 there (excess precision): the norm reads the
    # unrounded sum, the residual stream the rounded one (ROADMAP C.2)
    h2 = rmsnorm(x.float() + y.float(), p["norm2"]).to(cdt)
    x = x + y
    if mlp_kind == "moe":
        if ctx.mode == "decode":
            # a decode step's rows are padded to DECODE_ROWS (8) at its
            # boundary, so the dispatch makes 8 groups of one token each:
            # each row routes alone, and with C >= 8 >= Tg no pair of it
            # is dropped (an expert gets at most one pair of a token)
            G_, Tg, C = M.dispatch_shape(h2.shape[0] * h2.shape[1], cfg.moe)
            assert Tg <= C, (G_, Tg, C)
        y2, aux = M.moe_mlp(p["mlp"], h2, cfg, ctx.shd)
    elif mlp_kind == "cm":
        # channel-mix token shift: train shifts in-sequence; decode uses state
        if ctx.mode == "decode" and cache is not None:
            shift = cache["x_cm"][:, None]
        else:
            prev = cache["x_cm"] if (cache is not None and
                                     ctx.mode == "prefill") \
                else torch.zeros((h2.shape[0], h2.shape[-1]), dtype=h2.dtype,
                                 device=h2.device)
            shift = torch.cat([prev[:, None], h2[:, :-1]], dim=1)
        y2 = R.channelmix(p["mlp"], h2, shift, cfg, ctx.shd)
        if cache is not None:
            # not a view of h2
            new_cache = {**new_cache, "x_cm": h2[:, -1].clone()}
    else:
        y2 = mlp(p["mlp"], h2, ctx.shd)
    return x.float() + y2.float(), new_cache, aux


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


#: every :class:`LayerOp` and :class:`TrainLayer` made so far, by (cfg,
#: mixer, mlp_kind, mode, shd) and the context fields that mixer reads
#: (:func:`_ctx_key`), and every :class:`HeadOp`, by (cfg, "head", shd):
#: steps of one config share them
LAYER_OPS: Dict[tuple, Any] = {}


def _ctx_key(mixer: str, ctx: Ctx) -> tuple:
    """The context fields a mixer reads, besides ``mode``, ``shd`` and the
    decode position (an input of the op).  The mixer itself is part of
    the op's key, so ``attn`` and ``attn_local`` are two ops."""
    if mixer == "rwkv":
        return ("rwkv", ctx.rwkv_chunk, ctx.rwkv_impl)
    if mixer == "rglru":
        return ("rglru",)
    return ("attn", ctx.q_chunk, ctx.flash)


#: rows of every decode-mode layer call and head call: a call of ``B``
#: rows runs in groups of ``DECODE_ROWS``, each padded with inert rows to
#: that count, so every product and row reduction of a decode step runs at
#: one shape whatever the batch, and a row rounds alike in a solo step, a
#: static batch and an engine tick
DECODE_ROWS = 8


def padded_rows(b: int) -> int:
    """``b`` rows rounded up to a multiple of :data:`DECODE_ROWS`."""
    return -(-b // DECODE_ROWS) * DECODE_ROWS


def _pad_rows(t, rows: int, fill=0):
    """``t`` with its leading axis padded to ``rows`` by ``fill`` (one
    op: each eager op of a decode step costs host time)."""
    if t.shape[0] == rows:
        return t
    return torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 1) + (0, rows - t.shape[0]), value=fill)


class _RowOp:
    """A function of ``(params, x, cache, pos)`` as a custom op,
    ``repro_torch::<label>``, whose body runs the function compiled once
    (:func:`~repro_torch.core.regions.compile_region_fn`, ``fullgraph``;
    eagerly inside ``disable_compile``), with ``fake`` giving its outputs'
    shapes.

    With ``fixed_rows`` (decode-mode layers and the head) the op runs its
    body on :data:`DECODE_ROWS` rows at a time.  The callers on the serve
    path pad once, at the step boundary (:func:`decode_step`,
    :meth:`HeadOp.__call__`, the engine's slot cache of
    :func:`padded_rows` rows), so their calls arrive at a multiple of
    :data:`DECODE_ROWS` and split into groups without a copy; a direct
    call of another row count (``opcheck``, a test, the vmap rule's
    folded rows) has its ``B`` rows of ``x`` and of the batched cache
    leaves padded here with zero rows (position 0, empty KV slots).  A
    cache leaf with no batch axis (``shared``: the
    positions a KV cache holds) may come shared, of its spec's shape, or
    per row with a leading batch axis; the decode position ``pos`` may be
    0-d or one per row.  The body compiles once, at the padded shape, for
    every ``B`` (padding inside the graph would compile it once per
    ``B``); the padding costs an op per input and the outputs are views
    of the padded ones.  Rows never mix in the body, and every call runs
    it at one shape, so a row's result does not depend on ``B`` or on the
    other rows.  The vmap rule moves the vmapped axis to the front and
    calls ``repro_torch::<label>_rows`` once: it folds the instances'
    rows into one batch (a shared leaf becomes per row) and calls the op
    once, so an engine tick runs each layer once over all its slots.

    Without ``fixed_rows`` (prefill layers) the rows op runs the op once
    per instance: a prefill's products would round otherwise at another
    batch."""

    def __init__(self, label: str, body: Callable, fake: Callable,
                 fixed_rows: bool = False, shared: tuple = ()):
        self.label = label
        self.stats = CompileStats()
        self._compiled = None
        self.fixed_rows = fixed_rows
        #: (cache leaf index, spec ndim) of the leaves with no batch axis
        self.shared = dict(shared)
        self.body = body

        def run_body(params, x, cache, pos):
            if compile_disabled():
                return body(params, x, cache, pos)
            # one layout per shape (umem.canonical), so every caller of a
            # shape runs one graph; one dispatch state on every call: the
            # compiled graph's first run reaches here with ADInplaceOrView
            # excluded, a later run not, and Dynamo guards on it (a
            # recompile)
            x, cache, pos = tree_map(canonical, (x, cache, pos))
            with torch._C._AutoDispatchBelowADInplaceOrView():
                return self._executable()(params, x, cache, pos)

        @torch.library.custom_op(f"repro_torch::{label}", mutates_args=())
        def op(params: List[torch.Tensor], x: torch.Tensor,
               cache: List[torch.Tensor],
               pos: Optional[torch.Tensor]) -> List[torch.Tensor]:
            if fixed_rows:
                return self._fixed_rows(run_body, params, x, cache, pos)
            return [canonical(o) for o in run_body(params, x, cache, pos)]

        @op.register_fake
        def _(params, x, cache, pos):
            return fake(params, x, cache, pos)

        @torch.library.custom_op(f"repro_torch::{label}_rows",
                                 mutates_args=())
        def rows(params: List[torch.Tensor], x: torch.Tensor,
                 cache: List[torch.Tensor],
                 pos: Optional[torch.Tensor]) -> List[torch.Tensor]:
            # x, cache and pos carry a leading instance axis; params do not
            if fixed_rows:
                return self._folded(op, params, x, cache, pos)
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
                # batched parameters: one call per instance
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

    def _fixed_rows(self, run_body, params, x, cache, pos):
        """The op's outputs for ``B`` rows, the body run on groups of
        :data:`DECODE_ROWS` rows, the last padded if ``B`` is not a
        multiple (the class docstring)."""
        B = x.shape[0]
        as_shared = [j in self.shared and c.dim() == self.shared[j]
                     for j, c in enumerate(cache)]
        cache = [c.expand(B, *c.shape) if sh else c
                 for c, sh in zip(cache, as_shared)]
        if pos is not None and pos.dim() == 0:
            pos = pos.expand(B)
        R = DECODE_ROWS
        groups = []
        for g0 in range(0, B, R):
            n = min(R, B - g0)
            outs = run_body(
                params, _pad_rows(x[g0:g0 + n], R, 0),
                [_pad_rows(c[g0:g0 + n], R,
                           -1 if j in self.shared else 0)
                 for j, c in enumerate(cache)],
                None if pos is None else _pad_rows(pos[g0:g0 + n], R, 0))
            groups.append([canonical(o)[:n] for o in outs])
        outs = groups[0] if len(groups) == 1 else \
            [torch.cat(g) for g in zip(*groups)]
        # views of the padded outputs, with the strides of fresh tensors
        return [outs[0]] + [o[0] if sh else o
                            for o, sh in zip(outs[1:], as_shared)]

    def _folded(self, op, params, x, cache, pos):
        """``rows`` of a fixed-rows op: the ``n`` instances' rows (``b``
        each) folded into one batch of ``n * b`` rows, one call of the op,
        and the outputs unfolded."""
        n, b = x.shape[0], x.shape[1]

        def fold(t):
            return t.reshape(n * b, *t.shape[2:])

        def per_row(t):
            # an instance's shared leaf (or position), once for each row
            return t.repeat_interleave(b, dim=0)
        shared_in = [j in self.shared and c.dim() == self.shared[j] + 1
                     for j, c in enumerate(cache)]
        flat = [per_row(c) if sh else fold(c)
                for c, sh in zip(cache, shared_in)]
        fpos = None if pos is None else \
            (per_row(pos) if pos.dim() == 1 else fold(pos))
        outs = op(params, fold(x), flat, fpos)

        def unfold(t):
            return t.reshape(n, b, *t.shape[1:])
        res = [unfold(outs[0])]
        for o, sh in zip(outs[1:], shared_in):
            res.append(unfold(o)[:, 0].contiguous() if sh else unfold(o))
        return res

    def _executable(self):
        if self._compiled is None:
            self._compiled = compile_region_fn(self.body, self.label,
                                               stats=self.stats)
        return self._compiled


def _like_inputs(params, x, cache, pos):
    """Outputs shaped and laid out as ``x`` and the cache leaves, typed as
    the cache leaves and, for ``x``, as :func:`layer_fwd`'s f32 stream."""
    return [torch.empty_like(x, dtype=torch.float32,
                             memory_format=torch.contiguous_format)] + \
        [torch.empty_like(t, memory_format=torch.contiguous_format)
         for t in cache]


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
    decode position (a 0-d tensor or one per row, or None outside
    decode).  A decode layer runs its rows in fixed groups
    (:data:`DECODE_ROWS`, the :class:`_RowOp` docstring).  Its outputs
    are ``x`` (the f32 residual sum, :func:`layer_fwd`) and the new cache
    leaves, contiguous; its fake implementation gives each the shape and
    layout of the input it replaces and the cache leaves their dtypes (a
    layer maps ``x`` and its recurrent state or KV cache to tensors like
    them)."""

    def __init__(self, cfg, mixer: str, mlp_kind: str, ctx: Ctx):
        impl = (ctx.rwkv_impl or "ref") if mixer == "rwkv" else "scan" \
            if mixer == "rglru" else ("flash" if ctx.flash else "chunked")
        template = _one_layer_specs(cfg, mixer, mlp_kind)
        cspecs = _one_layer_cache_specs(cfg, mixer, 1, 1)
        self._cache_keys = tuple(cspecs)

        def layer(params, x, cache, pos):
            p = _rebuild(template, iter(params))
            c = dict(zip(self._cache_keys, cache)) if cache else None
            lctx = ctx if pos is None else dataclasses.replace(ctx, pos=pos)
            # the MoE loss is a training quantity: serving drops it, as the
            # reference's prefill and decode do
            x, nc, _ = layer_fwd(p, x, cfg, mixer, mlp_kind, lctx, c)
            return [x] if nc is None else [x, *(nc[k] for k in
                                                self._cache_keys)]
        self.layer = layer
        super().__init__(
            f"layer_{mixer}_{mlp_kind}_{ctx.mode}_{impl}_{len(LAYER_OPS)}",
            layer, _like_inputs, fixed_rows=ctx.mode == "decode",
            shared=tuple((j, len(sp.shape))
                         for j, sp in enumerate(cspecs.values())
                         if "batch" not in sp.axes))

    def pad_cache(self, cache: dict, rows: int) -> dict:
        """``cache`` (one layer's) with every batched leaf padded, or
        sliced, to ``rows`` rows; a leaf without a batch axis stays as it
        is, and a per-row slot-position leaf pads with empty slots."""
        out = {}
        for k, c in cache.items():
            j = self._cache_keys.index(k)
            if j in self.shared and c.dim() == self.shared[j]:
                out[k] = c
            elif c.shape[0] > rows:
                out[k] = c[:rows]
            else:
                out[k] = _pad_rows(c, rows, -1 if j in self.shared else 0)
        return out

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
    :class:`_RowOp`): ``x [B, 1, d] -> logits [B, 1, vocab]``, its rows
    in fixed groups (:data:`DECODE_ROWS`).  A solo decode step, a
    prefill's last position and an engine tick that batches its slots
    under ``vmap`` reach one executable at one shape, so they round alike
    and their greedy tokens agree."""

    def __init__(self, cfg, shd):
        def head(params, x, cache, pos):
            norm, w = params
            p = {"tok": w} if cfg.tie_embeddings else {"head": w}
            return [lm_logits(p, _final_norm(x, norm, cfg), cfg, shd)]

        def fake(params, x, cache, pos):
            return [x.new_empty((*x.shape[:-1], cfg.vocab),
                                dtype=torch_dtype(cfg.compute_dtype))]
        super().__init__(f"head_{len(LAYER_OPS)}", head, fake,
                         fixed_rows=True)
        self.tied = cfg.tie_embeddings

    def __call__(self, params, x):
        """Logits of ``x`` under the model's ``params``: ``x`` padded here
        to :func:`padded_rows` rows, or copied to the strides of a fresh
        tensor, size-1 axes included (a prefill's last position and a
        decode step's token then reach one executable at one shape)."""
        emb = params["embed"]
        w = emb["tok"] if self.tied else emb["head"]
        B = x.shape[0]
        rows = padded_rows(B)
        x = _pad_rows(x, rows) if rows != B else \
            x.clone(memory_format=torch.contiguous_format)
        logits = self.op([params["final_norm"], w], x, [], None)[0]
        return logits if rows == B else logits[:B]


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


class _Remat(torch.autograd.Function):
    """One layer of a :class:`TrainLayer`: the forward keeps only the
    layer's input and parameters; the backward recomputes the layer inside
    its compiled VJP."""

    @staticmethod
    def forward(ctx, layer, x, *params):
        ctx.layer = layer
        ctx.save_for_backward(x, *params)
        return tuple(layer.forward(list(params), x))

    @staticmethod
    def backward(ctx, dy, daux):
        x, *params = ctx.saved_tensors
        *dparams, dx = ctx.layer.vjp(params, x, dy.contiguous(), daux)
        return (None, dx, *dparams)


class TrainLayer:
    """One layer kind of ``cfg`` in train mode as two executables compiled
    once (:func:`~repro_torch.core.regions.compile_region_fn`; eager inside
    ``disable_compile``): ``forward(params, x) -> (y, aux)``, and
    ``vjp(params, x, dy, daux) -> [*dparams, dx]``, ``torch.func.vjp`` of
    the same layer, which recomputes it (``aux`` the MoE loss, its
    recomputation the forward's own ops).  ``__call__`` joins them in an
    ``autograd.Function`` (rematerialisation: the reference's
    ``jax.checkpoint`` around each layer cycle)."""

    def __init__(self, cfg, mixer: str, mlp_kind: str, ctx: Ctx):
        template = _one_layer_specs(cfg, mixer, mlp_kind)
        ctx = dataclasses.replace(ctx, mode="train")
        label = f"layer_{mixer}_{mlp_kind}_train_{len(LAYER_OPS)}"

        def fwd(params, x):
            p = _rebuild(template, iter(params))
            y, _, aux = layer_fwd(p, x, cfg, mixer, mlp_kind, ctx)
            return y, aux

        def vjp(params, x, dy, daux):
            _, pull = torch.func.vjp(fwd, params, x)
            dparams, dx = pull((dy, daux))
            return [*dparams, dx]
        self.label = label
        self.fwd_fn, self.vjp_fn = fwd, vjp
        self.stats = CompileStats()          # the forward's
        self.vjp_stats = CompileStats()
        self._fwd = self._vjp = None

    def forward(self, params, x):
        if compile_disabled():
            return self.fwd_fn(params, x)
        if self._fwd is None:
            self._fwd = compile_region_fn(self.fwd_fn, self.label,
                                          stats=self.stats)
        return self._fwd(params, canonical(x))

    def vjp(self, params, x, dy, daux):
        if compile_disabled():
            return self.vjp_fn(params, x, dy, daux)
        if self._vjp is None:
            self._vjp = compile_region_fn(self.vjp_fn, self.label + "_vjp",
                                          stats=self.vjp_stats)
        return self._vjp(params, canonical(x), canonical(dy), daux)

    def __call__(self, p, x):
        """The layer's output and MoE loss, ``(y, aux)``, for parameters
        ``p`` (a dict) and ``x``."""
        return _Remat.apply(self, x, *_leaves(p))


def train_layer_fns(cfg, ctx: Ctx) -> dict:
    """``{(mixer, mlp_kind): TrainLayer}`` for the layer kinds of ``cfg``,
    made once per config but its depth and the context fields each mixer
    reads (kept in :data:`LAYER_OPS`)."""
    fns = {}
    # a layer's body reads the widths, not the depth: models of one width
    # and another depth share its executables
    one = dataclasses.replace(cfg, n_layers=1)
    for mk, lk in dict.fromkeys(layer_kinds(cfg)):
        key = (one, mk, lk, "train", ctx.shd, _ctx_key(mk, ctx))
        if key not in LAYER_OPS:
            LAYER_OPS[key] = TrainLayer(one, mk, lk, ctx)
        fns[(mk, lk)] = LAYER_OPS[key]
    return fns


def forward_train(params, batch, cfg, ctx: Ctx):
    """batch: ``tokens`` [B, S] -> (logits [B, S, vocab], aux).  Each layer
    is rematerialised under ``ctx.remat`` (:class:`TrainLayer`), else it
    runs inline under autograd.  ``aux`` is the MoE load-balancing loss
    summed over the layers in order, as the reference's ``_run_layers``
    sums it (0 without a MoE layer)."""
    ctx = dataclasses.replace(ctx, mode="train")
    layers = train_layer_fns(cfg, ctx) if ctx.remat else None
    x = embed(params["embed"], batch["tokens"], cfg, ctx.shd)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (mk, lk) in enumerate(layer_kinds(cfg)):
        x = _carry(x, cfg, i)
        if layers is None:
            x, _, a = layer_fwd(params["layers"][i], x, cfg, mk, lk, ctx)
        else:
            x, a = layers[(mk, lk)](params["layers"][i], x)
        aux = aux + a
    x = _final_norm(_carry(x, cfg, cfg.n_layers), params["final_norm"], cfg)
    return lm_logits(params["embed"], x, cfg, ctx.shd), aux


def _carry(x, cfg, i: int):
    """The residual stream before layer ``i`` (``i = n_layers``: after the
    last), as an f32 tensor: rounded to the compute dtype where the
    reference's stream is a scan carry (the start of each scanned layer
    cycle, the start of the remainder, the end of the scan), else the
    unrounded f32 sum the previous layer returned.  The reference runs a
    cycle's layers, and the remainder's, in one XLA computation, which
    fuses each residual add into the next RMSNorm and keeps the sum in f32
    there (excess precision); the carry between scan steps is stored in
    the compute dtype (ROADMAP C.2)."""
    cyc, n_full, _ = layer_plan(cfg)
    if i <= n_full * len(cyc) and i % len(cyc) == 0:
        x = x.to(torch_dtype(cfg.compute_dtype))
    return x.float()


def _final_norm(x, scale, cfg):
    """The final RMSNorm of the f32 stream ``x``, in the compute dtype."""
    return rmsnorm(x, scale).to(torch_dtype(cfg.compute_dtype))


def _run_layers(params, x, cfg, ctx: Ctx, caches=None, layers=None):
    """Run the layer program; returns (x, new_caches or None).  ``layers``
    (from :func:`layer_fns`) runs each layer through its kind's op, else
    each layer runs inline."""
    new_caches = []
    for i, (mk, lk) in enumerate(layer_kinds(cfg)):
        c = caches[i] if caches is not None else None
        x = _carry(x, cfg, i)
        if layers is None:
            x, nc, _ = layer_fwd(params["layers"][i], x, cfg, mk, lk, ctx, c)
        else:
            x, nc = layers[(mk, lk)](params["layers"][i], x, c, ctx.pos)
        new_caches.append(nc)
    x = _carry(x, cfg, cfg.n_layers)
    return x, (new_caches if caches is not None else None)


def prefill(params, batch, cfg, ctx: Ctx, caches, layers=None):
    """Fill caches from a full prompt; returns (last-token logits, caches).
    ``layers``: :func:`layer_fns` of ``cfg`` in prefill mode, or None."""
    ctx = dataclasses.replace(ctx, mode="prefill")
    x = embed(params["embed"], batch["tokens"], cfg, ctx.shd)
    x, caches = _run_layers(params, x, cfg, ctx, caches, layers)
    return _head(params, x[:, -1:], cfg, ctx, layers), caches


def decode_step(params, token, caches, pos, cfg, ctx: Ctx, layers=None):
    """token [B] int; pos an int, a 0-d int tensor or one per row [B]
    (moved to the token's device once, for every layer).  Returns (logits
    [B,1,V], caches).  ``layers``: :func:`layer_fns` of ``cfg`` in decode
    mode, or None.

    With ``layers`` the step pads its rows once, here, to
    :func:`padded_rows` (``x``, the batched cache leaves and a per-row
    ``pos``; a leaf without a batch axis stays shared), runs every layer
    and the head on them, and slices the logits and the cache back to
    ``B`` rows: every op of the step then runs at one shape, whatever
    ``B``."""
    x = embed(params["embed"], token[:, None], cfg, ctx.shd)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    B = x.shape[0]
    rows = B if layers is None else padded_rows(B)
    if rows != B:
        x = _pad_rows(x, rows)
        if pos.dim():
            pos = _pad_rows(pos, rows)
        if caches is not None:
            caches = [layers[kind].pad_cache(c, rows)
                      for kind, c in zip(layer_kinds(cfg), caches)]
    ctx = dataclasses.replace(ctx, mode="decode", pos=pos)
    x, caches = _run_layers(params, x, cfg, ctx, caches, layers)
    logits = _head(params, x, cfg, ctx, layers)
    if rows != B:
        logits = logits[:B]
        if caches is not None:
            caches = [layers[kind].pad_cache(c, B)
                      for kind, c in zip(layer_kinds(cfg), caches)]
    return logits, caches


def _head(params, x, cfg, ctx: Ctx, layers=None):
    """The final norm and the logits: through the head op of ``layers``
    when given, else inline."""
    if layers is not None:
        return layers["head"](params, x)
    return lm_logits(params["embed"],
                     _final_norm(x, params["final_norm"], cfg), cfg, ctx.shd)
