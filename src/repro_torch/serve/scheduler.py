"""Slot-based continuous-batching scheduler on the captured region programs
(counterpart of ``repro.serve.scheduler``).

The engine runs on the serving spine of :mod:`repro_torch.launch.serve`:

* admission prefills replay the captured ``PREFILL`` + ``KV_APPEND``
  program, one program per prompt length (capture freezes shapes, so each
  distinct length owns one program that every request of that length
  replays);
* the decode tick is one captured program per engine: ``DECODE_SLOTS``,
  the ``DECODE_STEP`` body (``impl_fn("ref")``) called once on the slot
  rows with a position per row and the active mask as program inputs,
  then the same ``KV_APPEND`` commit;
* ``SLOT_ADMIT`` scatters an admitted request's gathered cache into its
  row of the slot cache, a region, so admission is accounted like
  everything else.

The slot cache is one batch of ``transformer.padded_rows(n_slots)`` rows
(:func:`~repro_torch.models.transformer.init_row_cache`: the slot
positions of a KV cache, shared by a static batch, are held per row),
where the reference stacks batch-1 caches.  So a tick runs each layer
once over all its slots, each row at its own position, and every
decode-mode op already gets a multiple of ``transformer.DECODE_ROWS``
rows: a row rounds as it does in a solo decode step, whose rows are
padded to that count too, and its greedy tokens are the solo step's.
Engines of up to ``DECODE_ROWS`` slots share one tick executable.  The
embedding (a lookup and an elementwise scale) and the argmax do not mix
rows either.  The rows past ``n_slots`` and the inactive slots compute
too (frozen shapes, as in the reference); inside ``DECODE_SLOTS`` an
inactive row keeps its previous token, and its garbage row is overwritten
whole by the next ``SLOT_ADMIT``.

Per-request state machine: QUEUED -> PREFILL (prefilled, its cache parked
in the :class:`~repro_torch.serve.paged_kv.PagedKVCache`) -> DECODE (in a
slot) -> DONE, with EVICTED on the budget path (pages dropped, the request
re-queued for a fresh prefill).  Every decision lands on the executor's
:class:`~repro_torch.core.ledger.Ledger` (the ``serve`` section of
``coverage_report()``).

The parity contract: each request's tokens equal a solo decode of the same
prompt (``repro_torch.serve.traffic.solo_reference``) under every policy.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import umem
from repro_torch.core.ledger import Ledger
from repro_torch.core.program import capture
from repro_torch.core.regions import Region, region
from repro_torch.launch.serve import (ServeRegions, capture_prefill_program,
                                      make_serve_regions)
from repro_torch.models import transformer as T
from repro_torch.serve.paged_kv import PagedKVCache

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"
EVICTED = "EVICTED"

#: legal transitions of the per-request state machine
_TRANSITIONS = {
    QUEUED: (PREFILL, DONE),            # gen==1 finishes at prefill
    PREFILL: (DECODE, EVICTED),
    DECODE: (DONE,),
    EVICTED: (QUEUED,),                 # re-queued for a fresh prefill
    DONE: (),
}


@dataclasses.dataclass
class Request:
    """One sequence moving through the engine."""
    req_id: int
    prompt: np.ndarray                  # [prompt_len] int32 token ids
    gen: int                            # tokens to generate (incl. prefill's)
    arrival_tick: int = 0
    state: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    slot: Optional[int] = None
    pos: int = 0                        # next decode position
    evictions: int = 0
    history: List[str] = dataclasses.field(default_factory=lambda: [QUEUED])

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state == DONE


def batch_for_prompt(prompt: np.ndarray, device) -> dict:
    """Batch-1 prefill inputs for one prompt.  The prompt's length is
    marked dynamic for ``torch.compile``: a compiled prefill step traces
    once for every prompt length (its layers, each an opaque op, compile
    per length inside)."""
    tokens = torch.as_tensor(np.asarray(prompt, np.int32), device=device)
    tokens = tokens[None]
    torch._dynamo.maybe_mark_dynamic(tokens, 1)
    return {"tokens": tokens}


@torch.library.custom_op("repro_torch::slot_write", mutates_args=())
def slot_write(slot_cache: List[torch.Tensor], req_cache: List[torch.Tensor],
               slot: torch.Tensor) -> List[torch.Tensor]:
    """``slot_cache`` with row ``slot`` (a 0-d integer tensor) of every leaf
    replaced by the batch-1 leaf of ``req_cache`` (a leaf without a batch
    axis fills the row whole): one opaque node in a compiled graph, whose
    copies are ATen's (a graph of one generated kernel per leaf costs a
    compile for nothing)."""
    return [sc.index_copy(0, slot.reshape(1).to(sc.device, torch.long),
                          (rc if rc.dim() == sc.dim() else rc[None])
                          .to(sc.dtype))
            for sc, rc in zip(slot_cache, req_cache)]


@slot_write.register_fake
def _(slot_cache, req_cache, slot):
    return [torch.empty_like(sc) for sc in slot_cache]


@dataclasses.dataclass
class EngineRegions:
    """The engine's regions: the serving spine's ``PREFILL`` /
    ``DECODE_STEP`` / ``KV_APPEND`` and the engine's own ``DECODE_SLOTS``
    and ``SLOT_ADMIT`` (params closed over).  Engines of one model may
    share them, and so share their compiled executables."""
    serve: ServeRegions
    decode_slots: Region        # (tok, cache, pos, active) -> (tok, cache)
    slot_admit: Region          # (slot cache, cache, slot) -> slot cache


def make_engine_regions(cfg, params, *,
                        ledger: Optional[Ledger] = None) -> EngineRegions:
    serve = make_serve_regions(cfg, params, ledger=ledger)
    raw_decode = serve.decode_step.impl_fn("ref")

    @region("DECODE_SLOTS", ledger=ledger)
    def decode_slots(tok, cache, pos, active):
        # the DECODE_STEP body once on all the slot rows, each at its own
        # position
        new_tok, new_cache = raw_decode(tok, cache, pos)
        return torch.where(active, new_tok, tok), new_cache

    @region("SLOT_ADMIT", ledger=ledger, offloaded=False)
    def slot_admit(slot_cache, req_cache, slot_idx):
        leaves, spec = pytree.tree_flatten(slot_cache)
        return pytree.tree_unflatten(
            slot_write(leaves, pytree.tree_leaves(req_cache), slot_idx),
            spec)

    return EngineRegions(serve, decode_slots, slot_admit)


class ServeEngine:
    """Continuous-batching engine: ``n_slots`` decode slots over one
    captured tick program, paged-KV parking between prefill and admission
    (the module docstring).  Tensors live on ``device``.  ``regions``
    (from :func:`make_engine_regions`) shares another engine's regions;
    by default the engine makes its own on the executor's ledger."""

    def __init__(self, cfg, params, executor, *, max_len: int,
                 n_slots: int = 4, kv: Optional[PagedKVCache] = None,
                 prefill_per_tick: int = 1, device="cuda",
                 regions: Optional[EngineRegions] = None):
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        self.cfg = cfg
        self.device = umem.resolve_device(device)
        self.executor = executor
        self.ledger = executor.ledger
        self.max_len = max_len
        self.n_slots = n_slots
        self.prefill_per_tick = prefill_per_tick
        self.kv = kv if kv is not None else PagedKVCache(device=self.device)
        self.ledger.attach_pool("kv_pages", self.kv.pool)
        self.engine_regions = regions or make_engine_regions(
            cfg, params, ledger=self.ledger)
        self.regions = self.engine_regions.serve
        self._decode_slots = self.engine_regions.decode_slots
        self._slot_admit = self.engine_regions.slot_admit
        self.selector = executor.policy.selector

        # slot state: one cache of padded_rows(n_slots) rows, and the
        # host-side token / position / active vectors of all its rows
        # (tick inputs; the rows past n_slots stay inactive)
        self.rows = T.padded_rows(n_slots)
        self.slot_cache = T.init_row_cache(cfg, self.rows, self.device,
                                           max_len)
        self._tok = np.zeros(self.rows, np.int32)
        self._pos = np.zeros(self.rows, np.int32)
        self._active = np.zeros(self.rows, bool)
        self.slot_req: List[Optional[Request]] = [None] * n_slots

        # ONE captured tick program; positions and the active mask are
        # program inputs.  Capture runs the tick once (the engine's first
        # compile); empty slots are numerically inert and every row is
        # overwritten whole at admission.
        self.tick_prog = capture(self._tick_fn, *self._tick_inputs(),
                                 name="engine_tick", selector=self.selector)

        self._prefill_progs: Dict[int, Any] = {}
        #: seconds of each prompt length's prefill capture (its first run)
        self.prefill_capture_s: Dict[int, float] = {}
        self.queued: Deque[Request] = collections.deque()
        self.waiting: Deque[Request] = collections.deque()
        self.requests: Dict[int, Request] = {}
        self.ticks = 0

    def _tick_fn(self, run, tok, cache, pos, active):
        tok, cache = run(self._decode_slots, tok, cache, pos, active)
        cache = run(self.regions.kv_append, cache)
        return tok, cache

    def _tick_inputs(self):
        d = self.device
        return (torch.as_tensor(self._tok.copy(), device=d),
                self.slot_cache, torch.as_tensor(self._pos, device=d),
                torch.as_tensor(self._active, device=d))

    # -- request intake ------------------------------------------------
    def submit(self, req: Request) -> Request:
        if req.req_id in self.requests:
            raise ValueError(f"duplicate req_id {req.req_id}")
        if req.prompt_len + req.gen > self.max_len:
            raise ValueError(
                f"request {req.req_id}: prompt {req.prompt_len} + gen "
                f"{req.gen} exceeds engine max_len {self.max_len}")
        req.submit_time = time.perf_counter()
        self.requests[req.req_id] = req
        self.queued.append(req)
        self.ledger.serve_record("submitted")
        return req

    # -- state machine -------------------------------------------------
    def _set_state(self, req: Request, state: str) -> None:
        if state not in _TRANSITIONS[req.state]:
            raise RuntimeError(f"request {req.req_id}: illegal transition "
                               f"{req.state} -> {state}")
        req.state = state
        req.history.append(state)

    # -- prefill (one program per prompt length) -----------------------
    def _prefill_program(self, prompt_len: int, example_batch,
                         example_cache):
        prog = self._prefill_progs.get(prompt_len)
        if prog is None:
            t0 = time.perf_counter()
            prog = capture_prefill_program(
                self.regions, example_batch, example_cache,
                name=f"prefill_L{prompt_len}", selector=self.selector)
            self.prefill_capture_s[prompt_len] = time.perf_counter() - t0
            self._prefill_progs[prompt_len] = prog
        return prog

    def _prefill(self, req: Request) -> None:
        batch = batch_for_prompt(req.prompt, self.device)
        cache0 = T.init_cache(self.cfg, 1, self.device, self.max_len)
        prog = self._prefill_program(req.prompt_len, batch, cache0)
        tok, cache = prog.replay(self.executor, batch, cache0)
        req.tokens = [int(tok.cpu()[0])]
        req.token_times = [time.perf_counter()]
        req.pos = req.prompt_len
        self.ledger.serve_record("prefills")
        if req.gen <= 1:                    # finished at prefill: no slot
            self._set_state(req, DONE)
            self.ledger.serve_record("retired")
            return
        evicted = self.kv.commit(req.req_id, cache, true_len=req.prompt_len)
        self._set_state(req, PREFILL)
        self.waiting.append(req)
        for rid in evicted:
            self._evict(self.requests[rid])

    def _evict(self, req: Request) -> None:
        """Total-budget eviction: the parked prefill is lost; drop its
        tokens and re-queue it for a fresh prefill (pages already
        freed)."""
        self.waiting.remove(req)
        req.evictions += 1
        req.tokens = []
        req.token_times = []
        self._set_state(req, EVICTED)
        self._set_state(req, QUEUED)
        self.queued.appendleft(req)         # it arrived first: keep order
        self.ledger.serve_record("evicted")

    # -- admission ------------------------------------------------------
    def _admit(self, req: Request, slot: int) -> None:
        cache = self.kv.gather(req.req_id)
        # under a staging policy the slot cache lives in host pages between
        # ticks: the gathered rows join it there
        cache = pytree.tree_map(lambda rc, sc: umem.canonical(
            rc.to(sc.device)), cache, self.slot_cache)
        self.slot_cache = self.executor.run(
            self._slot_admit, self.slot_cache, cache,
            torch.tensor(slot, dtype=torch.int32))
        self._tok[slot] = req.tokens[-1]
        self._pos[slot] = req.pos
        self._active[slot] = True
        self.slot_req[slot] = req
        req.slot = slot
        self._set_state(req, DECODE)
        self.ledger.serve_record("admitted")

    # -- decode tick ----------------------------------------------------
    def _decode_tick(self) -> None:
        n_active = int(self._active.sum())
        tok, self.slot_cache = self.tick_prog.replay(self.executor,
                                                     *self._tick_inputs())
        tok_np = tok.cpu().numpy()
        now = time.perf_counter()
        for s in np.nonzero(self._active)[0]:
            req = self.slot_req[s]
            t = int(tok_np[s])
            req.tokens.append(t)
            req.token_times.append(now)
            req.pos += 1
            self._tok[s] = t
            self._pos[s] = req.pos
            if len(req.tokens) >= req.gen:
                self._retire(req, int(s))
        self.ticks += 1
        self.ledger.serve_record("ticks")
        self.ledger.serve_record("decode_tokens", n_active)
        self.ledger.serve_record("active_slot_ticks", n_active)

    def _retire(self, req: Request, slot: int) -> None:
        self._active[slot] = False
        self.slot_req[slot] = None
        req.slot = None
        self._set_state(req, DONE)
        self.ledger.serve_record("retired")

    # -- the engine step ------------------------------------------------
    def step(self) -> bool:
        """One engine tick: prefill, admit, decode.  Returns whether any
        work was done (False: fully drained)."""
        did = False
        # prefills are throttled: parking more than a slot complement
        # ahead only grows the paged store (and thrashes it under a total
        # budget)
        for _ in range(self.prefill_per_tick):
            if not self.queued or len(self.waiting) >= self.n_slots:
                break
            self._prefill(self.queued.popleft())
            did = True
        while self.waiting and not self._active[:self.n_slots].all():
            slot = int(np.nonzero(~self._active[:self.n_slots])[0][0])
            self._admit(self.waiting.popleft(), slot)
            did = True
        if self._active.any():
            self._decode_tick()
            did = True
        self._push_gauges()
        return did

    def drain(self, max_ticks: int = 100_000) -> None:
        """Step until every submitted request is DONE."""
        for _ in range(max_ticks):
            if not self.step():
                return
        raise RuntimeError(f"engine did not drain in {max_ticks} ticks")

    def _push_gauges(self) -> None:
        led = self.ledger
        counters = led.serve_counters
        if counters.get("ticks"):
            # running occupancy: active slot-ticks per slot capacity
            led.serve_gauge("slot_occupancy",
                            counters.get("active_slot_ticks", 0)
                            / (counters["ticks"] * self.n_slots))
        st = self.kv.stats
        led.serve_gauge("kv_device_page_high_water_bytes",
                        st.device_high_water_bytes)
        led.serve_gauge("kv_total_page_high_water_bytes",
                        st.total_high_water_bytes)
        led.serve_gauge("kv_slot_cache_bytes", sum(
            umem.nbytes(x) for x in pytree.tree_leaves(self.slot_cache)))
        budget = self.kv.budget
        if budget is not None:
            # how hard the logical device budget was pressed
            led.serve_gauge("kv_budget_limit_bytes",
                            budget.limit_bytes or 0)
            led.serve_gauge("kv_budget_high_water_bytes",
                            budget.stats.high_water_bytes)
            led.serve_gauge("kv_budget_pressure_events",
                            budget.stats.pressure_events)
