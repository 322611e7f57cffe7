"""Serve step functions (counterpart of ``repro.train.step``
``make_prefill_step`` / ``make_decode_step``).  The train step, its
regions and the optimizer wait (ROADMAP A.7).

Each maker builds the model's per-kind layer functions
(:func:`~repro_torch.models.transformer.layer_fns`) once, outside the step,
so a compiled step compiles each layer kind once."""
from __future__ import annotations

import dataclasses

from repro_torch.models import transformer as T


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
