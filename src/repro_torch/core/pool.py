"""Umpire-style pooled allocation (paper C4, §5).

The paper pools every buffer larger than 5K elements and reuses allocations
instead of alloc/free churn.  Two pools here, both free-lists with byte
accounting in :class:`PoolStats`:

* :class:`HostStagingPool` — host staging pages (pinned where CUDA is
  present), binned by power-of-two byte class, handed out as typed tensors.
* :class:`DeviceBufferPool` — device tensors keyed by (shape, dtype,
  device), the destinations of the discrete policy's inbound copies.

:class:`BufferRotation` banks device buffers for the async replay's
lookahead copies (``repro_torch.core.program.AsyncExecutor``).  On a card
a bank is filled on a side stream and read on the compute stream, and the
caching allocator does not see that cross-stream use, since the pool, not
the allocator, recycles the buffers.  So a bank that retires records an
event on the stream retiring it (the compute stream, after its reads), and
the pool makes the next ``acquire`` of each of its buffers wait on that
event on the acquiring stream.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

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


def _record_event(device: torch.device) -> Optional[Any]:
    """An event recorded on ``device``'s current stream (None on the CPU,
    where work is done when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class DeviceBufferPool:
    """Free-lists of device tensors keyed by (shape, dtype, device).  A
    buffer released with a ``ready`` event is handed out again only behind
    that event: ``acquire`` makes the current stream wait on it.

    ``budget`` (a :class:`~repro_torch.core.oversub.MemoryBudget`,
    duck-typed: ``charge``/``release``) mirrors the pool's in-use bytes
    into a logical device-capacity budget: every ``acquire`` of a pooled
    buffer, free-list hits included, charges it and every ``release``
    releases it, so budget accounting and ``PoolStats.bytes_in_use`` agree
    byte for byte.  Unpooled buffers (below ``min_elems``) are never
    charged."""

    def __init__(self, min_elems: int = POOL_MIN_ELEMS, device="cuda",
                 budget=None):
        self.min_elems = min_elems
        self.device = resolve_device(device)
        self.budget = budget
        #: key -> [(buffer, ready event or None)]
        self._free: Dict[tuple, List[Tuple[torch.Tensor, Any]]] = {}
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
        buf = ready = None
        with self._lock:
            bucket = self._free.get(key)
            if bucket:
                self.stats.hits += 1
                self.stats.bytes_reused += nbytes
                self._free_bytes -= nbytes
                buf, ready = bucket.pop()
            else:
                self.stats.misses += 1
                self.stats.bytes_allocated += nbytes
            self._account_acquire_locked(nbytes)
            if self.budget is not None:
                self.budget.charge(nbytes)
        if buf is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        return buf

    def _account_acquire_locked(self, nbytes: int) -> None:
        self.stats.bytes_in_use += nbytes
        self.stats.high_water_bytes = max(self.stats.high_water_bytes,
                                          self.stats.bytes_in_use
                                          + self._free_bytes)

    def release(self, buf: torch.Tensor, ready: Optional[Any] = None) -> None:
        """Take ``buf`` back; ``ready`` is an event after the last read of
        it on the stream that read it (None: no read is pending)."""
        if buf.numel() < self.min_elems or buf.device != self.device:
            return
        nbytes = buf.numel() * buf.element_size()
        with self._lock:
            self._free.setdefault(self._key(buf.shape, buf.dtype, buf.device),
                                  []).append((buf, ready))
            self._free_bytes += nbytes
            self.stats.bytes_in_use = max(0, self.stats.bytes_in_use - nbytes)
            if self.budget is not None:
                self.budget.release(nbytes)

    @property
    def free_bytes(self) -> int:
        with self._lock:
            return self._free_bytes


class BufferRotation:
    """Double-buffered (depth-N) rotation over a :class:`DeviceBufferPool`.

    The async replay copies region *k+1*'s operands while region *k* still
    computes out of ITS staged buffers, so the two operand sets must come
    from disjoint pooled buffers.  A rotation gives each in-flight region
    its own *bank*: ``acquire`` lands in the active bank, ``advance`` opens
    a fresh bank for the next region, and ``retire`` returns the oldest
    bank's buffers to the pool once its region has finished computing,
    behind an event on the retiring stream (the module docstring).  With
    ``depth=2`` this is classic double buffering.

    Banks are generation-tagged: ``drain`` (end of a replay) bumps the
    generation, and a registration carrying a stale generation (a staging
    task that outlived the replay that submitted it) releases its buffer
    straight back to the pool instead of parking it in a bank the next
    replay would recycle mid-use.  Staging tasks get their tag through
    :meth:`handle`."""

    def __init__(self, pool: Optional[DeviceBufferPool] = None,
                 depth: int = 2):
        if depth < 2:
            raise ValueError("rotation needs >= 2 banks to double-buffer")
        self.pool = pool or DeviceBufferPool()
        self.depth = depth
        self._banks: List[list] = [[]]
        self._lock = threading.Lock()
        self.rotations = 0
        self.generation = 0

    def register(self, buf, generation: Optional[int] = None) -> None:
        """Track an already-acquired buffer in the active bank; a
        ``generation`` minted before the last ``drain`` returns it to the
        pool instead."""
        with self._lock:
            if generation is not None and generation != self.generation:
                self.pool.release(buf, _record_event(self.pool.device))
                return
            self._banks[-1].append(buf)

    def acquire(self, shape, dtype):
        buf = self.pool.acquire(shape, dtype)
        self.register(buf)
        return buf

    def handle(self) -> "_RotationHandle":
        """A view pinned to the current generation, for a staging task."""
        return _RotationHandle(self)

    def advance(self) -> None:
        """Open a new active bank (staging for the NEXT region begins); a
        full rotation retires its oldest bank first."""
        with self._lock:
            while len(self._banks) >= self.depth:
                self._retire_locked()
            self._banks.append([])
            self.rotations += 1

    def retire(self) -> None:
        """Release the oldest bank (its region has finished computing)."""
        with self._lock:
            self._retire_locked()

    def _release_bank_locked(self) -> None:
        bank = self._banks.pop(0)
        ready = _record_event(self.pool.device) if bank else None
        for buf in bank:
            self.pool.release(buf, ready)

    def _retire_locked(self) -> None:
        if len(self._banks) > 1 or (self._banks and self._banks[0]):
            self._release_bank_locked()
            if not self._banks:
                self._banks.append([])

    def drain(self) -> None:
        """Retire every bank (end of a replay) and open a new generation."""
        with self._lock:
            self.generation += 1
            while self._banks and (len(self._banks) > 1 or self._banks[0]):
                self._release_bank_locked()
            if not self._banks:
                self._banks.append([])

    @property
    def in_flight(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._banks)


class _RotationHandle:
    """Generation-tagged proxy of a :class:`BufferRotation` for a staging
    task (:meth:`BufferRotation.handle`)."""

    __slots__ = ("_rot", "generation", "pool")

    def __init__(self, rot: BufferRotation):
        self._rot = rot
        self.generation = rot.generation
        self.pool = rot.pool

    def register(self, buf) -> None:
        self._rot.register(buf, generation=self.generation)

    def acquire(self, shape, dtype):
        buf = self.pool.acquire(shape, dtype)
        self.register(buf)
        return buf
