"""Umpire-style pooled allocation (paper C4, §5).

The paper pools every buffer larger than 5K elements and reuses allocations
instead of alloc/free churn.  Two pools here, both free-lists with byte
accounting in :class:`PoolStats`:

* :class:`HostStagingPool` — host staging pages (pinned where CUDA is
  present), binned by power-of-two byte class, handed out as typed tensors.
* :class:`DeviceBufferPool` — device tensors keyed by (shape, dtype,
  device), the destinations of the discrete policy's inbound copies.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.umem import can_pin, resolve_device

POOL_MIN_ELEMS = 5120            # the paper's "buffers larger than 5K elements"


def _size_class(nbytes: int) -> int:
    """Round up to the next power-of-two byte class (min 4 KiB)."""
    c = 4096
    while c < nbytes:
        c <<= 1
    return c


@dataclasses.dataclass
class PoolStats:
    hits: int = 0
    misses: int = 0
    unpooled: int = 0
    bytes_reused: int = 0
    bytes_allocated: int = 0
    high_water_bytes: int = 0           # peak pool footprint: in-use + free
    bytes_in_use: int = 0               # currently acquired, not yet released

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class HostStagingPool:
    """Host pages recycled in place.  ``acquire`` returns a typed tensor
    over a pooled byte buffer; ``release`` takes that tensor back.  Buffers below
    ``min_elems`` bypass the pool (paper threshold)."""

    def __init__(self, min_elems: int = POOL_MIN_ELEMS):
        self.min_elems = min_elems
        self.pin = can_pin()
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._outstanding_bytes = 0
        self.stats = PoolStats()

    def acquire(self, shape: Tuple[int, ...], dtype) -> torch.Tensor:
        elems = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = elems * itemsize
        if elems < self.min_elems:
            self.stats.unpooled += 1
            return torch.empty(shape, dtype=dtype, pin_memory=self.pin)
        cls = _size_class(nbytes)
        with self._lock:
            bucket = self._free.get(cls)
            if bucket:
                raw = bucket.pop()
                self.stats.hits += 1
                self.stats.bytes_reused += nbytes
            else:
                raw = None
                self.stats.misses += 1
                self.stats.bytes_allocated += cls
            self._outstanding_bytes += cls
            self.stats.bytes_in_use = self._outstanding_bytes
            self.stats.high_water_bytes = max(self.stats.high_water_bytes,
                                              self._outstanding_bytes
                                              + self._free_bytes_locked())
        if raw is None:
            raw = torch.empty(cls, dtype=torch.uint8, pin_memory=self.pin)
        # a tensor of its own over the page's storage, not a view of
        # ``raw``: a view taken of it keeps IT alive, so a finalizer on the
        # handed-out tensor fires only once no view reads the page
        arr = torch.empty(0, dtype=dtype).set_(raw.untyped_storage(), 0, shape)
        arr._pool_raw = raw                 # backing page, found by release()
        return arr

    def release(self, arr: torch.Tensor) -> None:
        raw = getattr(arr, "_pool_raw", None)
        if raw is None:
            return
        self.release_raw(raw)

    def release_raw(self, raw: torch.Tensor) -> None:
        """Return a backing page (what a staged result's finalizer calls)."""
        cls = raw.numel()
        with self._lock:
            self._free.setdefault(cls, []).append(raw)
            self._outstanding_bytes -= cls
            self.stats.bytes_in_use = self._outstanding_bytes

    def _free_bytes_locked(self) -> int:
        return sum(cls * len(v) for cls, v in self._free.items())

    @property
    def free_bytes(self) -> int:
        with self._lock:
            return self._free_bytes_locked()


class DeviceBufferPool:
    """Free-lists of device tensors keyed by (shape, dtype, device)."""

    def __init__(self, min_elems: int = POOL_MIN_ELEMS, device="cuda"):
        self.min_elems = min_elems
        self.device = resolve_device(device)
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._free_bytes = 0
        self.stats = PoolStats()

    @staticmethod
    def _key(shape, dtype, device) -> tuple:
        return (tuple(shape), dtype, str(device))

    def acquire(self, shape, dtype) -> torch.Tensor:
        """A pooled (uninitialised) device tensor."""
        elems = math.prod(shape)
        if elems < self.min_elems:
            with self._lock:
                self.stats.unpooled += 1
            return torch.empty(shape, dtype=dtype, device=self.device)
        key = self._key(shape, dtype, self.device)
        nbytes = elems * torch.empty((), dtype=dtype).element_size()
        with self._lock:
            bucket = self._free.get(key)
            if bucket:
                self.stats.hits += 1
                self.stats.bytes_reused += nbytes
                self._free_bytes -= nbytes
                self._account_acquire_locked(nbytes)
                return bucket.pop()
            self.stats.misses += 1
            self.stats.bytes_allocated += nbytes
            self._account_acquire_locked(nbytes)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _account_acquire_locked(self, nbytes: int) -> None:
        self.stats.bytes_in_use += nbytes
        self.stats.high_water_bytes = max(self.stats.high_water_bytes,
                                          self.stats.bytes_in_use
                                          + self._free_bytes)

    def release(self, buf: torch.Tensor) -> None:
        if buf.numel() < self.min_elems or buf.device != self.device:
            return
        nbytes = buf.numel() * buf.element_size()
        with self._lock:
            self._free.setdefault(self._key(buf.shape, buf.dtype, buf.device),
                                  []).append(buf)
            self._free_bytes += nbytes
            self.stats.bytes_in_use = max(0, self.stats.bytes_in_use - nbytes)

    @property
    def free_bytes(self) -> int:
        with self._lock:
            return self._free_bytes
