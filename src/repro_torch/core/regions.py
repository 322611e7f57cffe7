"""One region, one policy: the canonical offload API (paper C1+C2+C3).

The paper's claim is that unified memory lets a *single* abstraction — "a
region with a directive" — be retargeted across host, discrete-managed
and APU execution without touching application code.  This module is that
abstraction, in PyTorch's eager idiom:

* :class:`Region` — one directive-sized unit of work: the function, its
  named implementation variants (``ref`` is always the function itself;
  hand-written kernels register as ``hopper``), a problem-size measure, the
  offload hint and the stencil metadata of sharded replay.
  :meth:`Region.executable` is the callable of one (routing target,
  variant) pair.
* An execution policy of four axes: placement (:class:`Placer`), routing
  (:class:`StaticRouter`, or :class:`SizeRouter` — the paper's
  ``if(target: n > TARGET_CUT_OFF)``), staging (:class:`NullStager` — the
  APU, or :class:`MigrationStager` — real copies through pooled buffers on
  a discrete card) and selection (:class:`StaticSelector`,
  :class:`TargetSelector`: which variant runs, OpenMP ``declare variant``).
  The four memory models of the paper are :class:`HostPolicy`,
  :class:`DiscretePolicy`, :class:`UnifiedPolicy` and
  :class:`AdaptivePolicy` (:func:`make_policy`).
* :class:`Executor` — runs regions under a policy and accounts every call
  into one :class:`~repro_torch.core.ledger.Ledger`.

What ``host`` means on a discrete card.  The reference's host and device
share one memory in its CPU runs; an H100's do not.  So a call routed to
the ``host`` target copies its CUDA operands to the CPU, runs there, and
copies its results back to the operands' device.  Those crossings are
real: the executor times them and books them on the call's ledger row as
``staging_s``/``staging_bytes``.  CPU operands cross nothing.  This is the
one place where the port's accounting departs from the reference's, whose
``Executor.run`` stages only when the target is not ``host``.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import umem
from repro_torch.core.ledger import GLOBAL_LEDGER, Ledger
from repro_torch.core.pool import DeviceBufferPool, HostStagingPool
from repro_torch.core.umem import UnifiedArena
from repro_torch.kernels import KERNEL_VARIANT


DEFAULT_CUTOFF = 16384          # the paper's empirical TARGET_CUT_OFF

#: routing targets: where the operands live (APU), the CPU, the card
TARGETS = ("default", "host", "device")

_CPU = torch.device("cpu")


def _home_device(tree) -> Optional[torch.device]:
    """The device of the first tensor leaf that is not on the CPU (None
    when every tensor leaf is on the CPU)."""
    for x in umem.tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.device
    return None


def _move(tree, device: torch.device):
    """Copy every tensor leaf not on ``device`` there; returns (tree,
    bytes moved)."""
    moved = [0]

    def one(x):
        if not isinstance(x, torch.Tensor) or x.device == device:
            return x
        moved[0] += umem.nbytes(x)
        return x.to(device)

    return umem.tree_map(one, tree), moved[0]


def default_size(args, kwargs) -> int:
    """Problem size of a call = element count of the LARGEST tensor leaf
    (a leading scalar such as ``alpha`` must not set the size)."""
    return max((x.numel() for x in umem.tree_leaves((args, kwargs))
                if isinstance(x, torch.Tensor)), default=0)


def synchronize() -> None:
    """Wait for queued device work, so a host clock around it measures the
    work and not its enqueue (``block_until_ready`` in the JAX package)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Region
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)        # identity semantics: hashable
class Region:
    """One directive-sized region: fn + variants + hints.

    ``stencil`` declares the neighbour-access pattern as ``(grid_axis,
    offset)`` pairs and ``halo_args`` the arguments whose neighbours are
    read — plain metadata for a domain-decomposed replay."""
    name: str
    fn: Callable
    offloaded: bool = True
    size_fn: Callable = default_size
    stencil: Optional[Sequence[Tuple[int, int]]] = None
    halo_args: Optional[Sequence[Any]] = None
    ledger: Ledger = dataclasses.field(default_factory=lambda: GLOBAL_LEDGER)

    def __post_init__(self):
        self.name = self.ledger.register(self.name, self.offloaded)
        self.__name__ = getattr(self.fn, "__name__", "region")
        self._variants: Dict[str, Callable] = {"ref": self.fn}

    @property
    def variants(self) -> Tuple[str, ...]:
        return tuple(self._variants)

    def variant(self, name: str, fn: Optional[Callable] = None):
        """Register a named implementation (``declare variant``); usable as
        a decorator.  Variants take the base function's arguments and
        return the same structure.  Re-registering ``ref`` replaces the
        base function."""
        def register(f: Callable) -> Callable:
            self._variants[name] = f
            if name == "ref":
                self.fn = f
            return f
        return register(fn) if fn is not None else register

    def impl_fn(self, name: str = "ref") -> Callable:
        try:
            return self._variants[name]
        except KeyError:
            raise KeyError(f"region {self.name!r} has no variant {name!r}; "
                           f"registered: {self.variants}") from None

    def resolve(self, name: str) -> str:
        """Declare-variant fallback: an unregistered name runs ``ref``."""
        return name if name in self._variants else "ref"

    def executable(self, target: str = "default",
                   impl: str = "ref") -> Callable:
        """The callable of one (routing target, variant) pair, run eagerly
        (compiling it is ROADMAP A.2).  ``default`` and ``device`` run the
        variant on the operands as they are: where they live (the APU), or
        on the card where the policy's stager or the caller put them.
        ``host`` runs on the CPU: CUDA operands cross to it and the results
        cross back (the module docstring).  Unknown names fall back to
        ``ref``; a kernel variant on the host target raises."""
        if target not in TARGETS:
            raise ValueError(f"target {target!r} is not one of {TARGETS}")
        impl = self.resolve(impl)
        fn = self.impl_fn(impl)
        if target != "host":
            return fn
        if impl == KERNEL_VARIANT:
            raise ValueError(
                f"region {self.name!r}: variant {impl!r} launches a CUDA "
                "kernel and cannot run on the host target")

        def on_host(*args, **kwargs):
            home = _home_device((args, kwargs))
            if home is None:
                return fn(*args, **kwargs)
            (args, kwargs), _ = _move((args, kwargs), _CPU)
            return _move(fn(*args, **kwargs), home)[0]

        return on_host


def region(name: Optional[str] = None, *, offloaded: bool = True,
           ledger: Optional[Ledger] = None, size_fn: Optional[Callable] = None,
           stencil: Optional[Sequence[Tuple[int, int]]] = None,
           halo_args: Optional[Sequence[Any]] = None):
    """Decorator: mark a function as one offloadable region (listings 4-6).

        @region("Amul", stencil=dia.STENCIL_OFFSETS, halo_args=("x",))
        def amul(diag, off, x): ...
    """
    def wrap(fn: Callable) -> Region:
        return Region(name=name or getattr(fn, "__name__", "region"),
                      fn=fn, offloaded=offloaded,
                      size_fn=size_fn or default_size,
                      stencil=stencil, halo_args=halo_args,
                      ledger=ledger or GLOBAL_LEDGER)
    return wrap


# ---------------------------------------------------------------------------
# Policy axes: routing, staging, placement, selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StaticRouter:
    """Mode-style routing: offloaded regions go one place, the rest another.
    ``default`` means "run wherever the operands live" — the APU model."""
    offloaded_target: str = "default"
    fallback_target: str = "default"

    def target(self, region: Region, args, kwargs,
               size: Optional[int] = None) -> str:
        return self.offloaded_target if region.offloaded \
            else self.fallback_target


@dataclasses.dataclass
class SizeRouter:
    """The ``if(target: n > TARGET_CUT_OFF)`` clause (paper C3) inside an
    executor: calls larger than ``cutoff`` go to the card, the rest and
    every region without a directive to the host."""
    cutoff: int = DEFAULT_CUTOFF

    def target(self, region: Region, args, kwargs,
               size: Optional[int] = None) -> str:
        if not region.offloaded:
            return "host"
        n = region.size_fn(args, kwargs) if size is None else size
        return "device" if n > self.cutoff else "host"


class NullStager:
    """APU model: crossing the boundary moves no bytes."""
    stages = False

    def stage_in(self, region, args, kwargs):
        return (args, kwargs), 0.0, 0

    def stage_out(self, region, out, staged_in=None):
        return out, 0.0, 0


def _storage_ptr(x: torch.Tensor) -> int:
    return x.untyped_storage().data_ptr()


@dataclasses.dataclass
class MigrationStager:
    """Managed-memory dGPU model: every host<->device crossing is a REAL
    out-of-place copy (paper §5, the >65% migration fraction of Fig 6).

    Inbound, operands are copied into device buffers recycled through the
    :class:`DeviceBufferPool`.  Outbound, results are copied into pooled
    host staging pages (pinned on a CUDA build) and handed to the caller as
    those pages, so the next offloaded region pays the migration again.

    Every wait is on the current stream's own work (``_sync``), never a
    device-wide synchronise, so a lookahead copy queued on a side stream
    (:class:`~repro_torch.core.program.AsyncExecutor`) neither waits for
    these copies nor holds them up.  Inbound copies from pooled host pages
    (pinned on a CUDA build) are asynchronous; a pageable source is copied
    by the CUDA runtime before the call returns.

    Lifetimes: a page goes back to the host pool only when the result
    tensor handed out, and every view taken of it, is garbage
    (``weakref.finalize``), so the next result never lands in bytes a
    caller still reads.  Inbound buffers
    return to the device pool after the region, except those an output
    aliases.  On a CPU-only torch both sides are CPU memory, and the copies
    are still real, pooled and timed."""
    arena: UnifiedArena = dataclasses.field(default_factory=UnifiedArena)
    host_pool: HostStagingPool = dataclasses.field(
        default_factory=HostStagingPool)
    device_pool: Optional[DeviceBufferPool] = None
    stages = True

    def __post_init__(self):
        if self.device_pool is None:
            self.device_pool = DeviceBufferPool(device=self.arena.device)

    def _sync(self) -> None:
        """Wait for the work queued on the current stream, and no other."""
        if self.arena.device.type == "cuda":
            torch.cuda.current_stream(self.arena.device).synchronize()

    def _migrate_in(self, x, rotation=None):
        """One leaf into a pooled device buffer (a bank of ``rotation`` when
        given), copied on the current stream."""
        if not isinstance(x, torch.Tensor):
            return x
        pool = rotation if rotation is not None else self.device_pool
        dst = pool.acquire(x.shape, x.dtype)
        dst.copy_(x, non_blocking=True)             # host -> device copy
        return dst

    def _migrate_out(self, x):
        if not isinstance(x, torch.Tensor):
            return x
        page = self.host_pool.acquire(tuple(x.shape), x.dtype)
        page.copy_(x, non_blocking=True)            # device -> host page
        return page

    def stage_in(self, region, args, kwargs):
        t0 = time.perf_counter()
        nbytes = self.arena.bytes_of((args, kwargs))
        staged = umem.tree_map(self._migrate_in, (args, kwargs))
        self._sync()
        return staged, time.perf_counter() - t0, nbytes

    def enqueue_leaves(self, leaves, rotation=None):
        """Queue the copies of a flat list of leaves on the current stream
        through ``rotation``'s banks, without waiting for them; returns
        (staged leaves, bytes).  The async replay's lookahead path."""
        return ([self._migrate_in(x, rotation) for x in leaves],
                self.arena.bytes_of(leaves))

    def stage_leaves(self, leaves, rotation=None):
        """:meth:`enqueue_leaves`, then wait for the copies; returns
        (staged leaves, seconds, bytes)."""
        t0 = time.perf_counter()
        staged, nbytes = self.enqueue_leaves(leaves, rotation)
        self._sync()
        return staged, time.perf_counter() - t0, nbytes

    def stage_out(self, region, out, staged_in=None):
        t0 = time.perf_counter()
        nbytes = self.arena.bytes_of(out)
        staged = umem.tree_map(self._migrate_out, out)
        self._sync()                    # the D2H copies land before any read
        for page in umem.tree_leaves(staged):
            raw = getattr(page, "_pool_raw", None)
            if raw is not None:
                weakref.finalize(page, self.host_pool.release_raw, raw)
        if staged_in is not None:                       # recycle dead inputs
            live = {_storage_ptr(y) for y in umem.tree_leaves(out)
                    if isinstance(y, torch.Tensor)}
            for x in umem.tree_leaves(staged_in):
                if isinstance(x, torch.Tensor) and _storage_ptr(x) not in live:
                    self.device_pool.release(x)
        return staged, time.perf_counter() - t0, nbytes


class Placer:
    """Placement axis.  No region of the port declares a
    :class:`~repro_torch.core.umem.MemSpace` hint yet, so placement leaves operands and results
    where they are; the hint fields and their application come with the
    first region that needs one."""

    def place_args(self, region: Region, args, kwargs):
        return args, kwargs

    def place_result(self, region: Region, out):
        return out


@dataclasses.dataclass
class StaticSelector:
    """One named implementation everywhere; regions that never registered
    the name run ``ref`` (the declare-variant fallback)."""
    impl: str = "ref"

    def select(self, region: Region, target: str, args, kwargs,
               size: Optional[int] = None) -> str:
        return region.resolve(self.impl)


@dataclasses.dataclass
class TargetSelector:
    """Target-conditioned defaults (``declare variant match(device)``):
    calls routed to the card (``device``, or ``default`` — resident on the
    APU) prefer ``device_impl``, host-routed calls ``host_impl``, each with
    the usual fallback to ``ref``.  No region registers a ``host`` variant,
    so host-routed calls run ``ref`` and never a kernel."""
    device_impl: str = "hopper"
    host_impl: str = "host"

    def select(self, region: Region, target: str, args, kwargs,
               size: Optional[int] = None) -> str:
        want = self.host_impl if target == "host" else self.device_impl
        return region.resolve(want)


# ---------------------------------------------------------------------------
# ExecutionPolicy = placement x routing x staging x selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ComposedPolicy:
    """A concrete execution policy assembled from the four axes."""
    name: str
    router: Any = dataclasses.field(default_factory=StaticRouter)
    stager: Any = dataclasses.field(default_factory=NullStager)
    placer: Any = dataclasses.field(default_factory=Placer)
    selector: Any = dataclasses.field(
        default_factory=lambda: StaticSelector("ref"))


class UnifiedPolicy(ComposedPolicy):
    """APU model (paper §3): operands stay where they are, regions run
    back-to-back, zero staging by construction."""

    def __init__(self, placer: Optional[Placer] = None,
                 selector: Optional[Any] = None):
        super().__init__("unified", StaticRouter("default", "default"),
                         NullStager(), placer or Placer(),
                         selector or StaticSelector("ref"))


class HostPolicy(ComposedPolicy):
    """dCPU model: every region, directive or not, runs on the host and no
    kernel is launched.  Its fields belong on the CPU; CUDA operands would
    pay a crossing on every call."""

    def __init__(self, placer: Optional[Placer] = None,
                 selector: Optional[Any] = None):
        super().__init__("host", StaticRouter("host", "host"), NullStager(),
                         placer or Placer(),
                         selector or StaticSelector("ref"))


class DiscretePolicy(ComposedPolicy):
    """Managed-memory dGPU model: offloaded regions run on ``device`` and
    pay real staging copies both ways (paper Fig 6)."""

    def __init__(self, arena: Optional[UnifiedArena] = None,
                 host_pool: Optional[HostStagingPool] = None,
                 device_pool: Optional[DeviceBufferPool] = None,
                 placer: Optional[Placer] = None,
                 selector: Optional[Any] = None,
                 device: Any = "cuda"):
        arena = arena or UnifiedArena(device)
        super().__init__("discrete", StaticRouter("device", "default"),
                         MigrationStager(arena,
                                         host_pool or HostStagingPool(),
                                         device_pool),
                         placer or Placer(),
                         selector or StaticSelector("ref"))
        self.arena = arena


class AdaptivePolicy(ComposedPolicy):
    """Calibrated size-based routing inside an executor: the
    ``TARGET_CUT_OFF`` clause as a policy axis.  Calls above the cutoff run
    where the operands live (on the card), the rest on the host."""

    def __init__(self, cutoff: int = DEFAULT_CUTOFF,
                 placer: Optional[Placer] = None,
                 selector: Optional[Any] = None):
        super().__init__("adaptive", SizeRouter(cutoff), NullStager(),
                         placer or Placer(),
                         selector or StaticSelector("ref"))
        #: {size: {"host": s, "device": s}} of the last calibration
        self.calibration: Dict[int, Dict[str, float]] = {}

    @property
    def cutoff(self) -> int:
        return self.router.cutoff

    @cutoff.setter
    def cutoff(self, value: int) -> None:
        self.router.cutoff = value

    def calibrate(self, target_region: Region,
                  make_args: Callable[[int], tuple],
                  sizes: Sequence[int] = (256, 1024, 4096, 16384, 65536),
                  reps: int = 20, ledger: Optional[Ledger] = None) -> int:
        """The paper's empirical TARGET_CUT_OFF: time the host and the
        device executable (each with the variant this policy's selector
        picks for that target) over a size ladder, set the cutoff at the
        first size where the device wins, and record it on the region's
        ledger row (and on ``ledger``'s row of the same name).

        ``make_args(n)`` builds operands whose ``size_fn`` is ``n``, where
        the application keeps them (on the card, the host executable pays
        the crossing).  Each timed loop of ``reps`` calls follows one
        warm-up call and ends in a device synchronise."""
        r = target_region
        self.calibration = {}
        crossover = None
        for n in sorted(sizes):
            args = make_args(n)
            ts = {}
            for tgt in ("host", "device"):
                impl = self.selector.select(r, tgt, args, {}, size=n)
                call = r.executable(tgt, impl)
                call(*args)
                synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    call(*args)
                synchronize()
                ts[tgt] = (time.perf_counter() - t0) / reps
            self.calibration[n] = ts
            if ts["device"] < ts["host"]:
                crossover = n
                break
        if crossover is None:
            crossover = max(sizes) + 1
        self.cutoff = crossover
        r.ledger.set_cutoff(r.name, crossover)
        if ledger is not None and ledger is not r.ledger:
            ledger.set_cutoff(r.name, crossover)
        return crossover


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class Executor:
    """Runs regions under one execution policy, accounting every call into
    one Ledger.  ``run`` returns the region's outputs as tensors wherever
    the policy landed them (host pages under the discrete policy)."""

    def __init__(self, policy: ComposedPolicy,
                 ledger: Optional[Ledger] = None):
        self.policy = policy
        self.ledger = ledger or Ledger(policy.name)
        self.mode = policy.name
        stager = policy.stager
        for pool_name, attr in (("host_staging", "host_pool"),
                                ("device_buffer", "device_pool")):
            pool = getattr(stager, attr, None)
            if pool is not None:
                self.ledger.attach_pool(pool_name, pool)
        # region -> (ledger -> row name), weak at both levels
        self._row_names = weakref.WeakKeyDictionary()

    def _row_name(self, r: Region) -> str:
        """Ledger row for this region in THIS executor's ledger; regions of
        another ledger get a uniquified row here on first record."""
        per_region = self._row_names.get(r)
        if per_region is None:
            per_region = weakref.WeakKeyDictionary()
            self._row_names[r] = per_region
        name = per_region.get(self.ledger)
        if name is None:
            name = r.name if r.ledger is self.ledger \
                else self.ledger.register(r.name, r.offloaded)
            per_region[self.ledger] = name
        return name

    def run(self, r: Region, *args, **kwargs):
        pol = self.policy
        n = r.size_fn(args, kwargs)
        tgt = pol.router.target(r, args, kwargs, size=n)
        impl = r.resolve(pol.selector.select(r, tgt, args, kwargs, size=n))
        args, kwargs = pol.placer.place_args(r, args, kwargs)
        staging_s = 0.0
        staging_b = 0
        stage = pol.stager.stages and r.offloaded and tgt != "host"
        staged_in = None
        home = None
        if stage:
            (args, kwargs), s, b = pol.stager.stage_in(r, args, kwargs)
            staged_in = (args, kwargs)
            staging_s += s
            staging_b += b
        elif tgt == "host":
            home = _home_device((args, kwargs))
            if home is not None:                    # the crossing to the CPU
                t0 = time.perf_counter()
                (args, kwargs), b = _move((args, kwargs), _CPU)
                staging_s += time.perf_counter() - t0
                staging_b += b
        t0 = time.perf_counter()
        out = r.executable(tgt, impl)(*args, **kwargs)
        synchronize()
        compute_s = time.perf_counter() - t0
        if stage:
            out, s, b = pol.stager.stage_out(r, out, staged_in)
            staging_s += s
            staging_b += b
        elif home is not None:                      # ... and back
            t0 = time.perf_counter()
            out, b = _move(out, home)
            synchronize()
            staging_s += time.perf_counter() - t0
            staging_b += b
        out = pol.placer.place_result(r, out)
        device = r.offloaded if tgt == "default" else (tgt == "device")
        self.ledger.record(self._row_name(r), device=device,
                           offloaded=r.offloaded,
                           compute_s=compute_s, staging_s=staging_s,
                           staging_bytes=staging_b, elems=n, impl=impl)
        return out

    def report(self) -> dict:
        rep = self.ledger.coverage_report()
        rep["mode"] = self.mode
        return rep


POLICIES = {
    "unified": UnifiedPolicy,
    "discrete": DiscretePolicy,
    "host": HostPolicy,
    "adaptive": AdaptivePolicy,
}


def make_policy(mode: str, **kw) -> ComposedPolicy:
    return POLICIES[mode](**kw)
