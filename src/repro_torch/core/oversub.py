"""Device-budget enforcement: run workloads that don't fit (paper C1 at
production scale; counterpart of ``repro.core.oversub``).

The MI300A's headline capability is *transparent oversubscription*: one
HBM3 space means a working set bigger than the GPU partition degrades —
pages migrate — instead of OOMing.  A :class:`MemoryBudget` is the
*logical* device capacity: every device-resident byte a consumer holds is
charged against it, and the layers that consult it degrade by moving
bytes host-side through the placement axis (``umem.place``) rather than
failing.  Its consumers:

* :class:`~repro_torch.core.pool.DeviceBufferPool` charges/releases its
  pooled buffers, so pool accounting (``PoolStats.bytes_in_use``) and
  budget accounting agree byte for byte;
* :class:`~repro_torch.core.regions.MigrationStager` bounds its transient
  staging granule to :meth:`MemoryBudget.staging_chunk_bytes`, so a grid
  bigger than the budget streams through it in slabs;
* :class:`BudgetedPlacer` demotes ``MemSpace.DEVICE`` placement hints to
  host space while the budget lacks headroom;
* :class:`~repro_torch.serve.paged_kv.PagedKVCache` mirrors its
  device-resident KV page bytes into it and spills LRU entries to host
  memory while it is over the limit (serve's ``--kv-oversub-ratio``);
* :class:`~repro_torch.models.moe.ExpertPager` charges each expert slab
  it pages in from pinned host memory and evicts LRU slabs while it is
  over the limit (the MoE leg: oversubscribed decode);
* still to port: the sharded scatter of ``ShardExecutor`` (ROADMAP A.9).

The budget stays logical on the card, as in the reference: nothing caps
what CUDA allocates.  Chunking bounds the copy granule, not what the pool
holds, so ``torch.cuda.max_memory_allocated()`` can read far above
``BudgetStats.high_water_bytes``.

Enforcement is *degradation, not denial* — ``charge`` never raises.  A
charge that lands over the limit records a pressure event, and the policy
layer that caused it is responsible for shedding bytes (spill, evict,
chunk).  Placement never changes values, so a budgeted run is bit for bit
its unbudgeted run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.core import umem
from repro_torch.core.regions import Placer
from repro_torch.core.umem import MemSpace

#: floor for budget-derived staging slabs — chunking below one page of
#: work costs more dispatches than it saves residency
MIN_CHUNK_BYTES = 4096

#: fraction of the budget one in-flight staging slab may occupy
CHUNK_FRACTION = 4


@dataclasses.dataclass
class BudgetStats:
    charged_bytes: int = 0          # currently device-resident (logical)
    high_water_bytes: int = 0       # peak charged
    charges: int = 0
    releases: int = 0
    admitted: int = 0               # admit()/consult() yeses
    denials: int = 0                # admit()/consult() refusals
    spilled_bytes: int = 0          # bytes a denial redirected host-side
    pressure_events: int = 0        # unconditional charges landing over
    staging_chunks: int = 0         # budget-bounded staging slabs issued

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class MemoryBudget:
    """A logical device-capacity budget that policies consult.

    ``limit_bytes=None`` is the unbudgeted reference (everything fits;
    every query says yes).  All methods are thread-safe: a stager may
    charge from one thread while another releases."""

    def __init__(self, limit_bytes: Optional[int] = None, *,
                 name: str = "device"):
        if limit_bytes is not None and limit_bytes < 1:
            raise ValueError("limit_bytes must be >= 1 (None = unlimited)")
        self.limit_bytes = limit_bytes
        self.name = name
        self.stats = BudgetStats()
        self._lock = threading.Lock()

    @classmethod
    def for_ratio(cls, footprint_bytes: int, ratio: float, *,
                  name: str = "device") -> "MemoryBudget":
        """The budget that makes ``footprint_bytes`` a ``ratio``-times
        oversubscribed working set: ``limit = footprint / ratio``.  Ratio
        1.0 is the everything-fits reference point of the degradation
        curve; 4.0 means only a quarter of the workload is device-resident
        at once."""
        if ratio <= 0:
            raise ValueError("oversubscription ratio must be > 0")
        return cls(max(1, int(footprint_bytes / ratio)), name=name)

    def __repr__(self) -> str:
        lim = "unlimited" if self.limit_bytes is None else self.limit_bytes
        return (f"MemoryBudget({self.name}: {lim}, "
                f"charged={self.stats.charged_bytes})")

    # -- queries ---------------------------------------------------------
    def fits(self, nbytes: int) -> bool:
        """Would charging ``nbytes`` stay within the limit?"""
        return self.limit_bytes is None or \
            self.stats.charged_bytes + int(nbytes) <= self.limit_bytes

    def headroom(self) -> Optional[int]:
        """Bytes left under the limit (None = unlimited)."""
        if self.limit_bytes is None:
            return None
        return max(0, self.limit_bytes - self.stats.charged_bytes)

    @property
    def over(self) -> bool:
        return self.limit_bytes is not None and \
            self.stats.charged_bytes > self.limit_bytes

    def utilization(self) -> float:
        if not self.limit_bytes:
            return 0.0
        return self.stats.charged_bytes / self.limit_bytes

    def oversubscription_ratio(self, footprint_bytes: int) -> float:
        """How oversubscribed ``footprint_bytes`` is against this limit
        (1.0 when unlimited: everything fits by definition)."""
        if self.limit_bytes is None:
            return 1.0
        return footprint_bytes / self.limit_bytes

    # -- accounting ------------------------------------------------------
    def admit(self, nbytes: int) -> bool:
        """Charge ``nbytes`` if it fits; otherwise record the denial (and
        the bytes the caller will keep host-side) and charge nothing —
        the resident-set protocol of the KV store and expert pager."""
        nbytes = int(nbytes)
        with self._lock:
            if self.limit_bytes is not None and \
                    self.stats.charged_bytes + nbytes > self.limit_bytes:
                self.stats.denials += 1
                self.stats.spilled_bytes += nbytes
                return False
            self.stats.admitted += 1
            self._charge_locked(nbytes)
            return True

    def consult(self, nbytes: int) -> bool:
        """Would-it-fit without charging — the advisory form placement
        hints use (a placed region argument is per-call transient, not a
        resident-set member).  Denials and redirected bytes are still
        counted."""
        with self._lock:
            ok = self.limit_bytes is None or \
                self.stats.charged_bytes + int(nbytes) <= self.limit_bytes
            if ok:
                self.stats.admitted += 1
            else:
                self.stats.denials += 1
                self.stats.spilled_bytes += int(nbytes)
            return ok

    def charge(self, nbytes: int) -> bool:
        """Unconditionally account ``nbytes`` as device-resident.  Never
        raises — the unified-memory model degrades instead of OOMing; a
        charge landing over the limit records a pressure event and returns
        False so the caller's policy layer can shed bytes."""
        with self._lock:
            self._charge_locked(int(nbytes))
            if self.over:
                self.stats.pressure_events += 1
                return False
            return True

    def _charge_locked(self, nbytes: int) -> None:
        self.stats.charges += 1
        self.stats.charged_bytes += nbytes
        self.stats.high_water_bytes = max(self.stats.high_water_bytes,
                                          self.stats.charged_bytes)

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.stats.releases += 1
            self.stats.charged_bytes = max(
                0, self.stats.charged_bytes - int(nbytes))

    # -- staging granularity --------------------------------------------
    def staging_chunk_bytes(self) -> Optional[int]:
        """Largest transient staging slab this budget tolerates: a quarter
        of the limit (floored at :data:`MIN_CHUNK_BYTES`), None when
        unlimited.  Bounding the in-flight granule is how a grid larger
        than device capacity streams through it — the managed-memory
        page-migration model with the page size set by the budget."""
        if self.limit_bytes is None:
            return None
        return max(MIN_CHUNK_BYTES, self.limit_bytes // CHUNK_FRACTION)

    def note_chunks(self, n: int) -> None:
        with self._lock:
            self.stats.staging_chunks += int(n)

    def as_dict(self) -> dict:
        return {"name": self.name, "limit_bytes": self.limit_bytes,
                "utilization": self.utilization(), **self.stats.as_dict()}


@dataclasses.dataclass
class BudgetedPlacer(Placer):
    """Placement axis that consults a :class:`MemoryBudget`: a
    ``MemSpace.DEVICE`` hint is honored only while the budget has
    headroom; leaves beyond it land in ``spill_space`` (pinned host
    memory on a CUDA build by default) instead.  Values never change —
    only residency — so any policy carrying this placer keeps the §2
    parity contract under oversubscription.  A demoted leaf of a call
    that runs on the card migrates in for that call
    (:class:`~repro_torch.core.regions.Executor`)."""
    budget: Optional[MemoryBudget] = None
    spill_space: Optional[MemSpace] = None

    def _place_tree(self, tree, space: MemSpace):
        if self.budget is None or space != MemSpace.DEVICE:
            return super()._place_tree(tree, space)
        return umem.tree_place_budgeted(
            tree, self.budget, self.device, min_bytes=self.min_bytes,
            spill_space=self.spill_space, charge=False)


def workload_bytes(tree) -> int:
    """Device footprint of a tree of tensors — the numerator of the
    oversubscription ratio (``MemoryBudget.for_ratio(workload_bytes(x),
    r)`` makes ``x`` an r-times-oversubscribed working set).  Dataclasses
    such as the CFD ``SimpleState`` are walked field by field."""
    total = 0
    for x in umem.tree_leaves(tree):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            total += workload_bytes(
                [getattr(x, f.name) for f in dataclasses.fields(x)])
        elif isinstance(x, torch.Tensor):
            total += umem.nbytes(x)
    return total
