"""Incremental-acceleration ledger (paper C2, Figs 2 & 4).

Every region is registered; executors report where each call ran, which
variant ran and how much staging it cost; ``coverage_report()`` reproduces
the Fig 2 (partial) vs Fig 4 (near-total) comparison.  The report keeps the
key schema of the JAX package's ledger, so the two can be diffed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class RegionRecord:
    name: str
    offloaded: bool = True              # does this region carry a directive?
    calls: int = 0
    device_calls: int = 0
    host_calls: int = 0
    compute_s: float = 0.0
    device_compute_s: float = 0.0       # compute split by routing side
    host_compute_s: float = 0.0
    staging_s: float = 0.0              # discrete-policy copy time
    staging_bytes: int = 0
    overlap_s: float = 0.0              # staging/exchange hidden behind compute
    exchange_s: float = 0.0             # inter-device halo traffic time
    exchange_bytes: int = 0
    host_elems: int = 0                 # routing accounting
    device_elems: int = 0
    cutoff: Optional[int] = None        # calibrated TARGET_CUT_OFF, if any
    #: calls per selected implementation variant ("ref", "hopper", ...)
    impl_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: autotune winners per (target, size-bucket) cell; survive reset_timings()
    calibrated_variants: Dict[str, str] = dataclasses.field(
        default_factory=dict)

    @property
    def total_s(self) -> float:
        """Wall-clock this row cost: overlapped seconds ran concurrently
        with compute and are not booked twice."""
        return (self.compute_s + self.staging_s + self.exchange_s
                - self.overlap_s)

    @property
    def exposed_exchange_s(self) -> float:
        """Exchange seconds not hidden behind compute (overlap attributes
        to staging first, the remainder to exchange)."""
        return self.exchange_s - max(0.0, self.overlap_s - self.staging_s)


class Ledger:
    def __init__(self, name: str = "default"):
        self.name = name
        self.regions: Dict[str, RegionRecord] = {}
        # serving-engine accounting (repro_torch.serve): scheduler
        # decisions land here, so coverage_report() carries the serve story
        # next to the region rows it is made of; gauges keep their peak
        self.serve_counters: Dict[str, float] = {}
        self.serve_gauges: Dict[str, float] = {}
        # pools attached for byte-level accounting (paper C4): their live
        # PoolStats are snapshotted into every coverage_report()
        self._pools: Dict[str, object] = {}

    def region(self, name: str, offloaded: bool = True) -> RegionRecord:
        if name not in self.regions:
            self.regions[name] = RegionRecord(name=name, offloaded=offloaded)
        return self.regions[name]

    def register(self, name: str, offloaded: bool = True) -> str:
        """Register a NEW region under a unique name (``dot``, ``dot#2``,
        ...), so every region owns its own row in the coverage report."""
        unique = name
        k = 2
        while unique in self.regions:
            unique = f"{name}#{k}"
            k += 1
        self.regions[unique] = RegionRecord(name=unique, offloaded=offloaded)
        return unique

    def record(self, name: str, *, device: bool, compute_s: float,
               staging_s: float = 0.0, staging_bytes: int = 0,
               offloaded: bool = True, elems: int = 0,
               overlap_s: float = 0.0, exchange_s: float = 0.0,
               exchange_bytes: int = 0,
               impl: Optional[str] = None) -> None:
        r = self.region(name, offloaded)
        r.calls += 1
        if impl is not None:
            r.impl_counts[impl] = r.impl_counts.get(impl, 0) + 1
        r.device_calls += int(device)
        r.host_calls += int(not device)
        r.compute_s += compute_s
        r.staging_s += staging_s
        r.staging_bytes += staging_bytes
        r.overlap_s += min(overlap_s, staging_s + exchange_s)
        r.exchange_s += exchange_s
        r.exchange_bytes += exchange_bytes
        if device:
            r.device_compute_s += compute_s
            r.device_elems += elems
        else:
            r.host_compute_s += compute_s
            r.host_elems += elems

    def set_cutoff(self, name: str, cutoff: int) -> None:
        """Store a calibrated TARGET_CUT_OFF with the region it governs."""
        self.region(name).cutoff = cutoff

    def serve_record(self, event: str, n: float = 1) -> None:
        """Count one scheduler decision (``admitted``, ``retired``,
        ``evicted``, ...) into the report's ``serve`` section."""
        self.serve_counters[event] = self.serve_counters.get(event, 0) + n

    def serve_gauge(self, key: str, value: float) -> None:
        """Record a level (slot occupancy, KV page high-water bytes); the
        ledger keeps the largest value seen."""
        self.serve_gauges[key] = max(self.serve_gauges.get(key, value), value)

    def attach_pool(self, name: str, pool) -> None:
        """Surface a pool's PoolStats in coverage_report() (``pools``
        section).  Re-attaching under the same name replaces."""
        self._pools[name] = pool

    def reset_timings(self) -> None:
        for r in self.regions.values():
            r.calls = r.device_calls = r.host_calls = 0
            r.compute_s = r.staging_s = r.overlap_s = 0.0
            r.exchange_s = 0.0
            r.staging_bytes = r.exchange_bytes = 0
            r.device_compute_s = r.host_compute_s = 0.0
            r.host_elems = r.device_elems = 0
            r.impl_counts = {}          # cutoff/calibrated_variants persist
        self.serve_counters.clear()     # per-run accounting, like timings;
        self.serve_gauges.clear()       # attached pools persist

    def clear(self) -> None:
        """Drop every region row, the serve accounts and the attached
        pools."""
        self.regions.clear()
        self.serve_counters.clear()
        self.serve_gauges.clear()
        self._pools.clear()

    # ------------------------------------------------------------------
    def coverage_report(self) -> dict:
        rows = self.regions.values()
        total = sum(r.total_s for r in rows)
        dev = sum(r.device_compute_s for r in rows if r.offloaded)
        compute = sum(r.compute_s for r in rows)
        staging = sum(r.staging_s for r in rows)
        overlap = sum(r.overlap_s for r in rows)
        exchange = sum(r.exchange_s for r in rows)
        exposed_exchange = sum(r.exposed_exchange_s for r in rows)
        hideable = staging + exchange
        host_elems = sum(r.host_elems for r in rows)
        device_elems = sum(r.device_elems for r in rows)
        elems = host_elems + device_elems
        impl_counts: Dict[str, int] = {}
        for r in rows:
            for impl, n in r.impl_counts.items():
                impl_counts[impl] = impl_counts.get(impl, 0) + n
        calibrated = {r.name: dict(r.calibrated_variants)
                      for r in rows if r.calibrated_variants}
        variant_wins: Dict[str, int] = {}
        for cells in calibrated.values():
            for winner in cells.values():
                variant_wins[winner] = variant_wins.get(winner, 0) + 1
        extra: Dict[str, dict] = {}
        if self.serve_counters or self.serve_gauges:
            extra["serve"] = {**self.serve_counters, **self.serve_gauges}
        if self._pools:
            pools = {}
            for pname, pool in self._pools.items():
                st = pool.stats.as_dict()
                st["free_bytes"] = pool.free_bytes
                pools[pname] = st
            extra["pools"] = pools
        return {
            **extra,
            "regions": len(self.regions),
            "offloaded_regions": sum(1 for r in rows if r.offloaded),
            "total_s": total,
            "compute_s": compute,
            "device_compute_s": dev,
            "staging_s": staging,
            "device_fraction": dev / total if total else 0.0,
            "staging_fraction": staging / total if total else 0.0,  # Fig 6
            "exchange_s": exchange,
            "exchange_bytes": sum(r.exchange_bytes for r in rows),
            "exchange_fraction": exposed_exchange / total if total else 0.0,
            "exposed_exchange_s": exposed_exchange,
            "overlap_s": overlap,
            "overlap_fraction": overlap / hideable if hideable else 0.0,
            "staging_saved_s": sum(min(r.overlap_s, r.staging_s)
                                   for r in rows),
            "host_calls": sum(r.host_calls for r in rows),
            "device_calls": sum(r.device_calls for r in rows),
            "offload_elem_fraction": device_elems / elems if elems else 0.0,
            "cutoffs": {r.name: r.cutoff for r in rows
                        if r.cutoff is not None},
            "impl_counts": impl_counts,
            "calibrated_variants": calibrated,
            "variant_wins": variant_wins,
        }


GLOBAL_LEDGER = Ledger()
