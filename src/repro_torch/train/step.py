"""Train and serve step functions of the port (counterpart of
``repro.train.step``).

The train step ships whole (:func:`make_train_step`) and decomposed into
two regions on one ledger (:func:`make_train_regions`): ``FWD_BWD`` (the
loss and its gradients) and ``ADAMW_UPDATE`` (the optimizer), so the LM
stack rides the same Region x ExecutionPolicy spine as the CFD case
study.  Optimizer offload is a placement-axis hint on ``ADAMW_UPDATE``'s
``opt_state`` argument and on its result's state, and the update
registers a ``host`` implementation variant (the leafwise AdamW).

Both regions compile by parts, so each region's executable is its
function (``Region(compiled_by_parts=True)``).  ``FWD_BWD``: each layer
kind's train forward and VJP are executables compiled once
(:class:`~repro_torch.models.transformer.TrainLayer`), joined by autograd
with the embedding, the head and the loss run eagerly.
``ADAMW_UPDATE``: each leaf's sum of squares and update are executables
compiled once per dtype, the leaf's length dynamic
(:func:`repro_torch.optim.adamw.apply_updates`).  Their compile records:
:func:`compile_records`.

The serve steps build the model's per-kind layer functions
(:func:`~repro_torch.models.transformer.layer_fns`) once, outside the
step, so a compiled step compiles each layer kind once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.ledger import Ledger
from repro_torch.core.program import capture
from repro_torch.core.regions import CompileStats, region
from repro_torch.core.umem import MemSpace
from repro_torch.models import transformer as T
from repro_torch.models.layers import noshard
from repro_torch.optim import adamw

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits, targets, shd=noshard):
    """Next-token cross entropy in f32; logits [B,S,V] (already shifted by
    the caller), targets [B,S]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def loss_fn(params, batch, cfg, ctx: T.Ctx):
    """(loss, (ce, aux)) of one batch."""
    logits, aux = T.forward_train(params, batch, cfg, ctx)
    ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:], ctx.shd)
    return ce + MOE_AUX_WEIGHT * aux, (ce, aux)


def value_and_grad(params, batch, cfg, ctx: T.Ctx):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, (ce, aux)),
    grads), the gradients a tree like ``params`` in the parameters'
    dtypes, the values detached."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [t.detach().requires_grad_() for t in leaves]
        loss, (ce, aux) = loss_fn(pytree.tree_unflatten(live, spec), batch,
                                  cfg, ctx)
        grads = torch.autograd.grad(loss, live)
    return ((loss.detach(), (ce.detach(), aux.detach())),
            pytree.tree_unflatten(list(grads), spec))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, make_ctx=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics)."""
    make_ctx = make_ctx or (lambda: T.Ctx(mode="train"))

    def train_step(params, opt_state, batch):
        (loss, (ce, aux)), grads = value_and_grad(params, batch, cfg,
                                                  make_ctx())
        params, opt_state, gnorm = adamw.apply_updates(params, grads,
                                                       opt_state, opt_cfg)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux,
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The train step on the region spine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainRegions:
    """The train step decomposed into directive-sized regions."""
    fwd_bwd: Any            # (params, batch)             -> (grads, metrics)
    adamw_update: Any       # (params, grads, opt) -> (params, opt, gnorm)
    cfg: Any = None
    make_ctx: Any = None


def make_train_regions(cfg, opt_cfg: adamw.AdamWConfig, make_ctx=None, *,
                       ledger: Optional[Ledger] = None,
                       offload_optimizer: bool = False) -> TrainRegions:
    """``FWD_BWD`` + ``ADAMW_UPDATE`` as Regions on one ledger.

    ``offload_optimizer`` attaches host-space hints (``MemSpace.HOST``:
    pinned host memory where CUDA is present) to ``ADAMW_UPDATE``: on the
    ``opt_state`` argument and on the ``opt_state`` element of its result,
    so the policy's Placer keeps the AdamW moments in host memory between
    steps (``min_bytes``-gated, so the step counter stays put).  A call on
    the card copies them in for the update (``Placer.migrations``).  The
    math never changes; only the placement axis does."""
    make_ctx = make_ctx or (lambda: T.Ctx(mode="train"))

    @region("FWD_BWD", ledger=ledger, compiled_by_parts=True)
    def fwd_bwd(params, batch):
        (loss, (ce, aux)), grads = value_and_grad(params, batch, cfg,
                                                  make_ctx())
        return grads, {"loss": loss, "ce": ce, "moe_aux": aux}

    placement = result_hint = None
    if offload_optimizer:
        placement = {"opt_state": MemSpace.HOST}
        result_hint = {1: MemSpace.HOST}      # of (params, opt_state, gnorm)

    @region("ADAMW_UPDATE", ledger=ledger, placement=placement,
            result_space=result_hint, compiled_by_parts=True)
    def adamw_update(params, grads, opt_state):
        return adamw.apply_updates(params, grads, opt_state, opt_cfg)

    @adamw_update.variant("host")
    def _adamw_update_host(params, grads, opt_state):
        return adamw.apply_updates_leafwise(params, grads, opt_state,
                                            opt_cfg)

    return TrainRegions(fwd_bwd=fwd_bwd, adamw_update=adamw_update, cfg=cfg,
                        make_ctx=make_ctx)


def compile_records(regions: TrainRegions) -> Dict[str, Dict[str,
                                                            CompileStats]]:
    """The compile records of the regions' parts, by region and label:
    ``FWD_BWD``'s layer kinds' train forward and VJP
    (:class:`~repro_torch.models.transformer.TrainLayer`) and
    ``ADAMW_UPDATE``'s per-leaf executables (every config's made so
    far)."""
    ctx = dataclasses.replace(regions.make_ctx(), mode="train")
    fwd_bwd = {}
    for layer in T.train_layer_fns(regions.cfg, ctx).values():
        fwd_bwd[layer.label] = layer.stats
        fwd_bwd[layer.label + "_vjp"] = layer.vjp_stats
    return {"FWD_BWD": fwd_bwd, "ADAMW_UPDATE": adamw.compile_stats()}


def capture_train_program(regions: TrainRegions, example_state,
                          example_batch, name: str = "train_step",
                          selector=None):
    """One train step captured as a
    :class:`~repro_torch.core.program.RegionProgram`.

    ``state = (params, opt_state)`` and ``batch`` are program inputs;
    replaying under any executor re-issues ``FWD_BWD`` then
    ``ADAMW_UPDATE`` with the recorded dataflow, so a supervisor restart
    can re-capture against restored state while the regions, and their
    ledger rows, stay the same objects."""
    def step(run, state, batch):
        params, opt_state = state
        grads, metrics = run(regions.fwd_bwd, params, batch)
        params, opt_state, gnorm = run(regions.adamw_update, params, grads,
                                       opt_state)
        return (params, opt_state), {**metrics, "grad_norm": gnorm}

    return capture(step, example_state, example_batch, name=name,
                   selector=selector)


def demo_batch(gen: torch.Generator, cfg, batch: int, seq: int,
               device="cpu") -> Dict[str, Any]:
    """A synthetic batch (``tokens`` [batch, seq] int32 in ``[0,
    vocab)``) drawn from ``gen``, on ``device``."""
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32, device=gen.device)
    return {"tokens": toks.to(device)}


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, make_ctx=None):
    make_ctx = make_ctx or (lambda: T.Ctx(mode="prefill"))
    layers = T.layer_fns(cfg, dataclasses.replace(make_ctx(), mode="prefill"))

    def prefill_step(params, batch, caches):
        return T.prefill(params, batch, cfg, make_ctx(), caches, layers)

    return prefill_step


def make_decode_step(cfg, make_ctx=None):
    make_ctx = make_ctx or (lambda: T.Ctx(mode="decode"))
    layers = T.layer_fns(cfg, dataclasses.replace(make_ctx(), mode="decode"))

    def decode_step(params, token, caches, pos):
        return T.decode_step(params, token, caches, pos, cfg, make_ctx(),
                             layers)

    return decode_step
