"""Continuous-batching serving engine on the region-program spine
(counterpart of ``repro.serve``).

* :mod:`repro_torch.serve.paged_kv`: fixed-size KV pages drawn from a
  :class:`~repro_torch.core.pool.DeviceBufferPool`, LRU spill to host
  memory and eviction under budgets (paper C1 + C4).
* :mod:`repro_torch.serve.scheduler`: the slot scheduler driving the
  captured ``PREFILL`` / ``DECODE_SLOTS`` / ``KV_APPEND`` / ``SLOT_ADMIT``
  regions, every decision accounted on the executor's ledger.
* :mod:`repro_torch.serve.traffic`: seeded Poisson traffic, its metrics,
  and the solo-decode parity oracle.
"""
from repro_torch.serve.paged_kv import PagedKVCache, PagedKVStats
from repro_torch.serve.scheduler import Request, ServeEngine
from repro_torch.serve.traffic import make_traffic, run_traffic, \
    solo_reference

__all__ = ["PagedKVCache", "PagedKVStats", "Request", "ServeEngine",
           "make_traffic", "run_traffic", "solo_reference"]
