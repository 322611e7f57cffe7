"""Fault tolerance of the port: supervised training with checkpoint and
restart, and straggler detection (counterpart of ``repro.runtime.fault``).

* Periodic checkpoints (asynchronous, atomic:
  :mod:`repro_torch.checkpoint.ckpt`), each with a ``coverage_report()``
  snapshot beside the weights when a ``report_fn`` is given.
* On a failure: restore the latest checkpoint, rebuild the data stream at
  the restored step (the pipeline is step-deterministic) and go on, so a
  run with restarts gives an uninterrupted run's results.  When the step
  function replays a captured
  :class:`~repro_torch.core.program.RegionProgram`, ``rebuild_step``
  re-captures it against the restored state: the regions, and so their
  ledger rows, are the same objects, and the accounting accumulates
  across restarts.
* Straggler detection: an EWMA of the step's wall time and a threshold;
  a flagged step is counted, not folded into the EWMA.

:class:`FaultInjector` makes deterministic failures for tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.core.regions import synchronize


class FaultInjector:
    """Raises RuntimeError at the given step numbers (once each)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.0
    ewma: Optional[float] = None
    flagged: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.flagged += 1
            self.events.append((step, dt, self.ewma))
            return True             # the outlier stays out of the EWMA
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return False


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    checkpoints: int = 0
    stragglers: int = 0
    final_step: int = 0
    metrics_last: dict = dataclasses.field(default_factory=dict)
    #: (step, metrics) of every step that completed, restarts included
    history: list = dataclasses.field(default_factory=list)


class TrainSupervisor:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with
    checkpoint and restart.

    ``state`` is any tree of tensors; ``batch_fn(step)`` must be
    deterministic; ``fault`` is an optional injector (tests).
    ``rebuild_step(state, step) -> step_fn`` (optional) is called after
    every restore; ``report_fn() -> dict`` (optional) is saved into every
    checkpoint (``coverage.json``)."""

    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 ckpt: Checkpointer, ckpt_every: int = 50,
                 fault: Optional[FaultInjector] = None,
                 straggler: Optional[StragglerMonitor] = None,
                 max_restarts: int = 10,
                 rebuild_step: Optional[Callable] = None,
                 report_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.fault = fault or FaultInjector()
        self.straggler = straggler or StragglerMonitor()
        self.max_restarts = max_restarts
        self.rebuild_step = rebuild_step
        self.report_fn = report_fn

    def _save(self, step: int, state: Any) -> None:
        report = self.report_fn() if self.report_fn is not None else None
        self.ckpt.save(step, state, extra={"step": step}, report=report)

    def run(self, state: Any, start_step: int, n_steps: int) -> tuple:
        rep = SupervisorReport()
        step = start_step
        end = start_step + n_steps
        restarts = 0
        if self.ckpt.latest_step() is None:
            # anchor: a fault before the first periodic save restarts from
            # the true initial state, not a partly advanced one
            self._save(start_step, state)
            rep.checkpoints += 1
        while step < end:
            try:
                t0 = time.perf_counter()
                self.fault.check(step)
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                synchronize()
                dt = time.perf_counter() - t0
                if self.straggler.observe(step, dt):
                    rep.stragglers += 1
                step += 1
                rep.steps_run += 1
                rep.metrics_last = {k: float(v) for k, v in
                                    metrics.items()} if metrics else {}
                rep.history.append((step - 1, rep.metrics_last))
                if step % self.ckpt_every == 0 or step == end:
                    self._save(step, state)
                    rep.checkpoints += 1
            except Exception:
                restarts += 1
                rep.restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step
                    continue
                state, manifest = self.ckpt.restore(state, step=latest)
                step = manifest["extra"]["step"]
                if self.rebuild_step is not None:
                    # re-capture against the restored state; same regions,
                    # same ledger: the accounting survives the restart
                    self.step_fn = self.rebuild_step(state, step)
        rep.final_step = step
        self.ckpt.wait()
        return state, rep
