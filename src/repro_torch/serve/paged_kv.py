"""Paged KV cache: the serving engine's parking store (counterpart of
``repro.serve.paged_kv``; paper C1 + C4).

Between prefill and slot admission a request's cache is *paged*: its
``k``/``v`` leaves (the role keying of
:func:`~repro_torch.launch.serve.kv_role`) are split along the token
axis into fixed-size pages copied into pooled buffers of a
:class:`~repro_torch.core.pool.DeviceBufferPool`; every other leaf (slot
positions, recurrent state) rides along dense.  The port's cache is a
list of per-layer dicts, so every ``k``/``v`` leaf is ``[B, S, ...]`` with
its token axis at 1; a local layer's ring of ``window`` slots pages along
its slot axis like any other.  Pages recycle through the pool's free list
(paper C4), and two budgets bound the store:

* ``device_budget_bytes`` (and a :class:`~repro_torch.core.oversub.
  MemoryBudget`'s limit, the tighter of the two): when device-resident
  page bytes exceed it, the least recently used entry's pages *spill* to
  host memory (:func:`~repro_torch.core.umem.default_spill_space`, pinned
  on a CUDA build) and their device pages go back to the pool; a spilled
  entry is fetched back at ``gather``.  The copies never change values.
* ``total_budget_bytes``: when even host spill cannot hold the store,
  whole LRU entries are *evicted* (pages freed; the scheduler re-queues
  the request for a fresh prefill).

A spill is a real copy on every build, the CPU's included, so the pool
counts device-resident pages only: ``PoolStats.bytes_in_use`` equals the
store's ``device_bytes``.  (The reference keeps a spilled page's device
buffer counted until ``gather``, since its CPU placement is a no-op.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import umem
from repro_torch.core.pool import DeviceBufferPool
from repro_torch.core.umem import MemSpace
from repro_torch.launch.serve import kv_role

DEFAULT_PAGE_TOKENS = 8

#: the token (or ring-slot) axis of every ``k``/``v`` leaf: ``[B, S, ...]``
TOKEN_AXIS = 1


@dataclasses.dataclass
class PagedKVStats:
    pages_committed: int = 0
    pages_released: int = 0
    pages_spilled: int = 0          # device -> host moves
    pages_fetched: int = 0          # host -> device, paid at admission
    evictions: int = 0              # whole entries dropped (total budget)
    device_bytes: int = 0           # page bytes device-resident
    host_bytes: int = 0             # page bytes host-resident
    device_high_water_bytes: int = 0
    total_high_water_bytes: int = 0
    role_pages: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Entry:
    """One parked request: paged k/v leaves and dense leaves, in
    ``pytree`` flatten order, so ``spec`` rebuilds the cache."""
    req_id: int
    spec: pytree.TreeSpec
    leaves: List[Tuple]             # ("page", pages, shape, valid) | ("dense", leaf)
    page_bytes: int
    last_touch: int
    on_host: bool = False


class PagedKVCache:
    """Fixed-size KV pages over a :class:`DeviceBufferPool` free list with
    LRU host spill and whole-entry eviction (the module docstring).
    ``device`` is the pool's device when no ``pool`` is given."""

    def __init__(self, page_tokens: int = DEFAULT_PAGE_TOKENS,
                 pool: Optional[DeviceBufferPool] = None,
                 device_budget_bytes: Optional[int] = None,
                 total_budget_bytes: Optional[int] = None,
                 host_space: Optional[MemSpace] = None,
                 budget=None, device="cuda"):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.page_tokens = page_tokens
        # min_elems=0: every page pools; the free list is the point
        self.pool = pool if pool is not None else \
            DeviceBufferPool(min_elems=0, device=device)
        self.device_budget_bytes = device_budget_bytes
        self.total_budget_bytes = total_budget_bytes
        self.host_space = host_space or umem.default_spill_space()
        # a MemoryBudget is the oversubscription form of
        # device_budget_bytes: its limit caps device-resident page bytes
        # (the tighter of the two wins) and the store mirrors its device
        # byte changes into it.  Do not also give it to self.pool: that
        # would charge every page twice.
        self.budget = budget
        self.stats = PagedKVStats()
        self._entries: Dict[int, _Entry] = {}
        self._clock = 0

    def _device_limit(self) -> Optional[int]:
        lims = [b for b in (self.device_budget_bytes,
                            getattr(self.budget, "limit_bytes", None))
                if b is not None]
        return min(lims) if lims else None

    def _device_delta(self, nbytes: int) -> None:
        """Mirror a device-resident byte change into the budget (charge on
        +, release on -); a commit that lands over the limit is a pressure
        event until the LRU spill sheds it."""
        if self.budget is None or nbytes == 0:
            return
        if nbytes > 0:
            self.budget.charge(nbytes)
        else:
            self.budget.release(-nbytes)

    # -- bookkeeping ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, req_id: int) -> bool:
        return req_id in self._entries

    @property
    def total_bytes(self) -> int:
        return self.stats.device_bytes + self.stats.host_bytes

    def touch(self, req_id: int) -> None:
        e = self._entries.get(req_id)
        if e is not None:
            self._clock += 1
            e.last_touch = self._clock

    def _lru(self, *, exclude: Optional[int] = None,
             on_host: Optional[bool] = None) -> Optional[_Entry]:
        best = None
        for e in self._entries.values():
            if e.req_id == exclude:
                continue
            if on_host is not None and e.on_host != on_host:
                continue
            if best is None or e.last_touch < best.last_touch:
                best = e
        return best

    def _water_marks(self) -> None:
        s = self.stats
        s.device_high_water_bytes = max(s.device_high_water_bytes,
                                        s.device_bytes)
        s.total_high_water_bytes = max(s.total_high_water_bytes,
                                       s.device_bytes + s.host_bytes)

    # -- commit: cache -> pages ----------------------------------------
    def _page_leaf(self, leaf: torch.Tensor, true_len: int):
        """Pooled pages covering the first ``min(true_len, S)`` tokens of a
        k/v leaf (a local layer's ring has S = window slots); the rest of
        the last page is the leaf's own tail, and gather rebuilds the tail
        beyond ``valid`` as zeros (what ``init_cache`` left there)."""
        S = leaf.shape[TOKEN_AXIS]
        valid = min(max(int(true_len), 1), S)
        pt = self.page_tokens
        page_shape = (leaf.shape[0], pt, *leaf.shape[2:])
        pages = []
        for start in range(0, valid, pt):
            chunk = leaf[:, start:min(start + pt, S)]
            buf = self.pool.acquire(page_shape, leaf.dtype)
            n = chunk.shape[TOKEN_AXIS]
            buf[:, :n].copy_(chunk)
            if n < pt:
                buf[:, n:].zero_()
            pages.append(buf)
        return pages, tuple(leaf.shape), valid

    def commit(self, req_id: int, cache, true_len: int) -> List[int]:
        """Park a prefilled cache: page the k/v leaves, keep the rest
        dense.  Returns the req_ids of the entries the total budget forced
        out (the scheduler re-queues them)."""
        if req_id in self._entries:
            raise ValueError(f"request {req_id} already committed")
        flat, spec = pytree.tree_flatten_with_path(cache)
        leaves: List[Tuple] = []
        page_bytes = n_pages = 0
        for path, leaf in flat:
            role = kv_role(path)
            if role is not None and isinstance(leaf, torch.Tensor) \
                    and leaf.dim() > TOKEN_AXIS:
                pages, shape, valid = self._page_leaf(leaf, true_len)
                leaves.append(("page", pages, shape, valid))
                page_bytes += sum(umem.nbytes(p) for p in pages)
                n_pages += len(pages)
                self.stats.role_pages[role] = \
                    self.stats.role_pages.get(role, 0) + len(pages)
            else:
                leaves.append(("dense", leaf))
        self._clock += 1
        self._entries[req_id] = _Entry(req_id=req_id, spec=spec,
                                       leaves=leaves, page_bytes=page_bytes,
                                       last_touch=self._clock)
        self.stats.pages_committed += n_pages
        self.stats.device_bytes += page_bytes
        self._device_delta(page_bytes)
        self._water_marks()
        self._spill_to_budget()
        return self._evict_to_budget(newest=req_id)

    # -- budgets: LRU spill, then LRU eviction -------------------------
    def _to_host(self, page: torch.Tensor) -> torch.Tensor:
        """A host copy of one page in ``host_space`` (a copy even where
        host and device memory are one, so the device page can go back to
        the pool)."""
        pin = self.host_space is MemSpace.HOST and umem.can_pin()
        return torch.empty(page.shape, dtype=page.dtype,
                           pin_memory=pin).copy_(page)

    def _spill_entry(self, e: _Entry) -> None:
        if e.on_host:
            return
        n = 0
        for i, rec in enumerate(e.leaves):
            if rec[0] == "page":
                _, pages, shape, valid = rec
                host = [self._to_host(p) for p in pages]
                for p in pages:
                    self.pool.release(p)
                e.leaves[i] = ("page", host, shape, valid)
                n += len(pages)
        e.on_host = True
        self.stats.pages_spilled += n
        self.stats.device_bytes -= e.page_bytes
        self.stats.host_bytes += e.page_bytes
        self._device_delta(-e.page_bytes)
        self._water_marks()

    def _spill_to_budget(self) -> None:
        limit = self._device_limit()
        if limit is None:
            return
        while self.stats.device_bytes > limit:
            victim = self._lru(on_host=False)
            if victim is None:
                break
            self._spill_entry(victim)

    def _evict_to_budget(self, newest: int) -> List[int]:
        evicted: List[int] = []
        if self.total_budget_bytes is None:
            return evicted
        while self.total_bytes > self.total_budget_bytes \
                and len(self._entries) > 1:
            victim = self._lru(exclude=newest)
            if victim is None:
                break
            self.free(victim.req_id)
            self.stats.evictions += 1
            evicted.append(victim.req_id)
        return evicted

    # -- gather: pages -> cache (admission) ----------------------------
    def gather(self, req_id: int):
        """Reassemble and remove a parked cache, on the pool's device.
        Spilled pages pay the host->device copy here; device pages go back
        to the pool for the next commit."""
        e = self._entries.pop(req_id)
        if e.on_host:
            self.stats.host_bytes -= e.page_bytes
        else:
            self.stats.device_bytes -= e.page_bytes
            self._device_delta(-e.page_bytes)
        out = []
        pt = self.page_tokens
        for rec in e.leaves:
            if rec[0] == "dense":
                out.append(rec[1])
                continue
            _, pages, shape, valid = rec
            full = torch.zeros(shape, dtype=pages[0].dtype,
                               device=self.pool.device)
            for k, page in enumerate(pages):
                n = min(pt, valid - k * pt)
                full[:, k * pt:k * pt + n].copy_(page[:, :n],
                                                 non_blocking=e.on_host)
            out.append(full)
            if e.on_host:
                self.stats.pages_fetched += len(pages)
            else:
                for p in pages:
                    self.pool.release(p)
            self.stats.pages_released += len(pages)
        return pytree.tree_unflatten(out, e.spec)

    def free(self, req_id: int) -> None:
        """Drop a parked cache without gathering it (eviction, abort)."""
        e = self._entries.pop(req_id, None)
        if e is None:
            return
        if e.on_host:
            self.stats.host_bytes -= e.page_bytes
        else:
            self.stats.device_bytes -= e.page_bytes
            self._device_delta(-e.page_bytes)
        for rec in e.leaves:
            if rec[0] == "page":
                if not e.on_host:
                    for p in rec[1]:
                        self.pool.release(p)
                self.stats.pages_released += len(rec[1])
