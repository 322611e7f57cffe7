"""Serve step functions (counterpart of ``repro.train.step``
``make_prefill_step`` / ``make_decode_step``).  The train step, its
regions and the optimizer wait (ROADMAP A.9)."""
from __future__ import annotations

from repro_torch.models import transformer as T


def make_prefill_step(cfg, make_ctx=None):
    make_ctx = make_ctx or (lambda: T.Ctx(mode="prefill"))

    def prefill_step(params, batch, caches):
        return T.prefill(params, batch, cfg, make_ctx(), caches)

    return prefill_step


def make_decode_step(cfg, make_ctx=None):
    make_ctx = make_ctx or (lambda: T.Ctx(mode="decode"))

    def decode_step(params, token, caches, pos):
        return T.decode_step(params, token, caches, pos, cfg, make_ctx())

    return decode_step
