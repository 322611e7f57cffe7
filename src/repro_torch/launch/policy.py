"""ExecutionPolicy construction for the LM drivers (counterpart of
``repro.launch.policy.lm_policy``): a CLI ``--policy`` choice becomes a
concrete policy with the caller's variant selector.  The LM entry points
offer the ``unified`` and ``discrete`` policies; ``host``, ``adaptive``
and ``auto`` wait (ROADMAP A.6)."""
from __future__ import annotations

from repro_torch.core.regions import (ComposedPolicy, DiscretePolicy,
                                      UnifiedPolicy)

#: the CLI surface of the drivers
POLICY_CHOICES = ("unified", "discrete")


def lm_policy(mode: str, *, selector=None, device="cuda") -> ComposedPolicy:
    """The policy one LM driver run executes under; ``device`` is the card
    the discrete policy stages to."""
    if mode == "unified":
        return UnifiedPolicy(selector=selector)
    if mode == "discrete":
        return DiscretePolicy(selector=selector, device=device)
    raise ValueError(f"policy {mode!r}: the port has {POLICY_CHOICES}")
