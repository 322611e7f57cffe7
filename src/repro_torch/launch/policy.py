"""ExecutionPolicy construction for the LM drivers (counterpart of
``repro.launch.policy.lm_policy``): a CLI ``--policy`` choice plus the
config's :class:`~repro_torch.configs.base.MemoryPolicy` become a concrete
policy.

* ``adaptive`` takes ``MemoryPolicy.target_cutoff`` as its
  :class:`~repro_torch.core.regions.SizeRouter` cutoff: the paper's
  ``TARGET_CUT_OFF`` as a config value;
* every mode gets a ``min_bytes``-gated :class:`Placer`, so placement
  hints never bounce scalars across memory spaces;
* callers may swap in their own ``placer`` (serve's ``--offload-kv``) and
  ``selector`` (the variant axis).

A call the ``host`` or ``adaptive`` policy routes to the host runs the
``ref`` variant: a kernel variant launches a CUDA kernel and cannot run
there, so a :class:`StaticSelector` given to those modes becomes a
:class:`TargetSelector` with its variant on the card's side.

``auto`` (the tuned-profile lookup, ``repro.launch.policy.auto_policy``)
needs the tuner's profile and waits for ROADMAP A.8.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.regions import (ComposedPolicy, Placer, StaticSelector,
                                      TargetSelector, make_policy)

#: placement hints skip leaves below this (moving a scalar across spaces
#: costs more than it saves)
PLACER_MIN_BYTES = 4096

#: the CLI surface of the drivers
POLICY_CHOICES = ("unified", "discrete", "host", "adaptive")


def lm_policy(mode: str, memory=None, *, placer: Optional[Placer] = None,
              selector=None, device="cuda") -> ComposedPolicy:
    """The policy one LM driver run executes under; ``device`` is the card
    the discrete policy stages to and the placer's ``DEVICE``."""
    if mode not in POLICY_CHOICES:
        raise ValueError(f"policy {mode!r}: the port has {POLICY_CHOICES}")
    kw = {"placer": placer or Placer(min_bytes=PLACER_MIN_BYTES,
                                     device=device)}
    if mode in ("host", "adaptive") and isinstance(selector, StaticSelector):
        selector = TargetSelector(device_impl=selector.impl, host_impl="ref")
    if selector is not None:
        kw["selector"] = selector
    if mode in ("discrete", "adaptive"):
        kw["device"] = device
    if mode == "adaptive" and memory is not None:
        kw["cutoff"] = memory.target_cutoff
    return make_policy(mode, **kw)
