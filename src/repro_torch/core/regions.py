"""One region, one policy: the canonical offload API (paper C1+C2+C3).

The paper's claim is that unified memory lets a *single* abstraction — "a
region with a directive" — be retargeted across host, discrete-managed
and APU execution without touching application code.  This module is that
abstraction, in PyTorch's eager idiom:

* :class:`Region` — one directive-sized unit of work: the function, its
  named implementation variants (``ref`` is always the function itself;
  hand-written kernels register as ``hopper``), a problem-size measure, the
  offload hint, the donated arguments and the stencil metadata of sharded
  replay.  :meth:`Region.executable` is the compiled callable of one
  (routing target, variant, donation) triple: ``torch.compile`` with
  ``fullgraph=True``, the counterpart of the reference's ``jax.jit`` with
  ``donate_argnums``.  Inside :func:`disable_compile` (the counterpart of
  ``jax.disable_jit()``) it is the variant itself, run eagerly.
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
``staging_s``/``staging_bytes``.  CPU operands cross nothing.  The
reference's ``Executor.run`` stages only when the target is not ``host``.

What a demoted placement hint means on a discrete card.  In the
reference a leaf that :class:`~repro_torch.core.oversub.BudgetedPlacer`
sends to host space still feeds the device call, since its CPU runs share
one memory.  On an H100 the demoted leaf is a pinned host tensor that a
compiled CUDA region cannot take, so for a call that runs on the card the
executor copies each leaf that placement moved off the card back in for
that call alone, as managed memory migrates a page on touch, and books
the copy as ``staging_s``/``staging_bytes`` on the call's row.  The call
runs on the card, and the leaf stays demoted.  A placer may keep other
leaves in host memory between calls (serve's ``KVCachePlacer`` keeps the
k/v cache there): :meth:`Placer.migrations` names the leaves a call on
the card copies in, booked the same way.

These two are the places where the port's accounting departs from the
reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import itertools
import os
import re
import shutil
import subprocess
import time
import types
import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import umem
from repro_torch.core.ledger import GLOBAL_LEDGER, Ledger
from repro_torch.core.pool import DeviceBufferPool, HostStagingPool
from repro_torch.core.umem import UnifiedArena
from repro_torch.kernels import KERNEL_VARIANT, build


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


def _param_indices(fn: Callable) -> Dict[str, int]:
    """Positional index of each named parameter."""
    try:
        return {name: i for i, name
                in enumerate(inspect.signature(fn).parameters)}
    except (ValueError, TypeError):         # builtins, odd callables
        return {}


def synchronize() -> None:
    """Wait for queued device work, so a host clock around it measures the
    work and not its enqueue (``block_until_ready`` in the JAX package)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Compiled executables
# ---------------------------------------------------------------------------

#: Inductor's on-disk cache, under the checkout's ``build/`` (unless the
#: caller's environment names another); set at import, before anything
#: asks Inductor for its cache directory
COMPILE_CACHE = build.BUILD_DIR.parent / "inductor"
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(COMPILE_CACHE))

_eager_depth = 0
_configured = False
_executable_ids = itertools.count()


@contextlib.contextmanager
def disable_compile():
    """Run regions eagerly inside the block: :meth:`Region.executable`
    returns the variant itself, uncompiled, as ``jax.disable_jit()`` makes
    the reference's jitted executables run op by op."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def compile_disabled() -> bool:
    """True inside :func:`disable_compile`."""
    return _eager_depth > 0


def _builds_openmp(cxx: str) -> bool:
    """Whether ``cxx`` compiles and links an OpenMP program."""
    try:
        return subprocess.run(
            [cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
            input="int main() { return 0; }", capture_output=True,
            text=True, timeout=120).returncode == 0
    except OSError:
        return False


def _openmp_cxx() -> str:
    """The C++ compiler for Inductor's CPU code, which it always builds
    with ``-fopenmp``: its configured one (``$CXX``, else ``g++``) when
    that builds OpenMP code, else the first ``g++`` on ``PATH`` that does
    (a toolchain set up for ``nvcc`` may ship without ``libgomp``).
    Raises if none does."""
    from torch._inductor import config as inductor_config
    tried = [inductor_config.cpp.cxx[1]]
    tried += [p for p in (shutil.which("g++", path=d) for d in
                          os.environ.get("PATH", "").split(os.pathsep))
              if p and p not in tried]
    for cxx in tried:
        if cxx and _builds_openmp(cxx):
            return cxx
    raise RuntimeError(f"no C++ compiler builds OpenMP code (tried {tried}); "
                       "Inductor needs one for the regions' CPU code")


def _configure_compile() -> None:
    """Once, before the first compile: give Inductor a C++ compiler that
    builds OpenMP code (:func:`_openmp_cxx`), let the CPU's flags name the
    vector ISA of its C++ code (unless ``TORCHINDUCTOR_VEC_ISA_OK`` says
    otherwise), and make a region that hits Dynamo's recompile limit raise
    instead of running on eagerly.

    Without ``vec_isa_ok``, Inductor's first C++ kernel of a process
    probes each ISA the CPU lists by building and loading a test of ATen's
    vector headers with g++: an H100 host's first compiled 200^3 SIMPLE
    step took 172.72 s with the probe and 122.67 s without it
    (``tools/profile_first_step.py``; PERF.md)."""
    global _configured
    if _configured:
        return
    from torch._inductor import config as inductor_config
    inductor_config.cpp.cxx = (None, _openmp_cxx())
    if "TORCHINDUCTOR_VEC_ISA_OK" not in os.environ:
        inductor_config.cpp.vec_isa_ok = True
    if hasattr(torch._dynamo.config, "fail_on_recompile_limit_hit"):
        torch._dynamo.config.fail_on_recompile_limit_hit = True
    _configured = True


@dataclasses.dataclass
class CompileStats:
    """One compiled executable's compile record."""
    first_call_s: float = 0.0  # wall seconds of the first call: trace,
    calls: int = 0             # compile and run
    code: Optional[types.CodeType] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def compiles(self) -> int:
        """Graphs Dynamo keeps for the executable (its code object's cache
        entries): the first, then one per recompile.  A trace that Dynamo
        restarts before keeping it is not a compile."""
        if self.code is None:
            return 0
        from torch._dynamo.eval_frame import _debug_get_cache_entry_list
        return len(_debug_get_cache_entry_list(self.code))

    @property
    def recompiles(self) -> int:
        return max(0, self.compiles - 1)


def _alias_results(out, args, donate: Tuple[int, ...]):
    """XLA's buffer rules on a compiled region's results.  A result leaf
    that is a donated argument leaf stays that leaf; any other result leaf
    whose shape, dtype and device match a donated leaf not yet taken (in
    leaf order) is written into that leaf's storage (``copy_``, which
    Inductor folds into the producer's store), so the result lives where
    the argument lived; a result leaf that is an argument leaf not donated
    is a fresh copy.  A result that is a *view* of a donated argument is
    not supported (donate such an argument only if no result views it)."""
    leaves, spec = pytree.tree_flatten(out)
    donated = [x for i in donate if i < len(args)
               for x in pytree.tree_leaves(args[i])
               if isinstance(x, torch.Tensor)]
    inputs = [x for x in pytree.tree_leaves(args)
              if isinstance(x, torch.Tensor)]
    # plain loops, no generators: Dynamo traces this body on every
    # compile, and an inlined generator costs it far more than a loop
    taken = set()
    for o in leaves:                        # identity first
        for k, d in enumerate(donated):
            if k not in taken and o is d:
                taken.add(k)
                break
    for j, o in enumerate(leaves):
        if not isinstance(o, torch.Tensor) or _is_one_of(o, donated):
            continue
        for k, d in enumerate(donated):
            if k not in taken and d.shape == o.shape \
                    and d.dtype == o.dtype and d.device == o.device:
                d.copy_(o)
                leaves[j] = d
                taken.add(k)
                break
        else:
            if _is_one_of(o, inputs):
                leaves[j] = o.clone()
    return pytree.tree_unflatten(leaves, spec)


def _is_one_of(x, items) -> bool:
    for y in items:
        if x is y:
            return True
    return False


def _entry_point(fn: Callable, donate: Tuple[int, ...], label: str):
    """``fn`` with :func:`_alias_results` applied, under a code object of
    its own named ``label``: Dynamo keeps its cache, its recompiles and its
    recompile limit per code object, and its automatic-dynamic record of
    which sizes changed per code name, so each executable gets its own
    code object and ``label`` must be unique."""
    def entry(*args, **kwargs):
        return _alias_results(fn(*args, **kwargs), args, donate)
    code = entry.__code__.replace(co_name=label, co_qualname=label)
    return types.FunctionType(code, entry.__globals__, label, None,
                              entry.__closure__)


def _host_scalar(a):
    """A Python float argument as a 0-d float64 CPU tensor, so the compiled
    graph takes it as an input and not as a constant to specialise on (one
    compile per value), as ``jax.jit`` traces a Python scalar argument;
    anything else as it is."""
    return torch.tensor(a, dtype=torch.float64) if type(a) is float else a


def compile_region_fn(fn: Callable, label: str,
                      donate: Sequence[int] = (),
                      stats: Optional[CompileStats] = None) -> Callable:
    """``fn`` compiled with ``torch.compile(fullgraph=True)`` (a graph
    break raises), the arguments at ``donate`` donated as in
    :func:`_alias_results` and Python float arguments passed as 0-d
    tensors (:func:`_host_scalar`); compiles and first-call time go to
    ``stats``."""
    _configure_compile()
    stats = stats if stats is not None else CompileStats()
    entry = _entry_point(fn, tuple(donate), "region_" + re.sub(
        r"\W", "_", label) + f"_{next(_executable_ids)}")
    stats.code = entry.__code__
    compiled = torch.compile(entry, fullgraph=True)

    def call(*args, **kwargs):
        args = tuple(_host_scalar(a) for a in args)
        kwargs = {k: _host_scalar(v) for k, v in kwargs.items()}
        if stats.calls:
            stats.calls += 1
            return compiled(*args, **kwargs)
        t0 = time.perf_counter()
        out = compiled(*args, **kwargs)
        stats.first_call_s = time.perf_counter() - t0
        stats.calls = 1
        return out

    call.stats = stats
    return call


def _on_host(fn: Callable) -> Callable:
    """``fn`` run on the CPU: CUDA operands cross to it and the results
    cross back to the operands' device."""
    def on_host(*args, **kwargs):
        home = _home_device((args, kwargs))
        if home is None:
            return fn(*args, **kwargs)
        (args, kwargs), _ = _move((args, kwargs), _CPU)
        return _move(fn(*args, **kwargs), home)[0]

    return on_host


# ---------------------------------------------------------------------------
# Region
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)        # identity semantics: hashable
class Region:
    """One directive-sized region: fn + variants + compiled executables +
    hints.

    ``arg_spaces`` maps positional index or keyword name to a
    :class:`~repro_torch.core.umem.MemSpace` placement hint;
    ``result_space`` hints where results should land — either one
    ``MemSpace`` for the whole result, or a mapping from top-level tuple
    index / dict key to a space.  Hints are *advisory*: the executing
    policy's placement axis (:class:`Placer`) decides whether (and above
    what byte threshold) to honor them.

    ``stencil`` declares the neighbour-access pattern as ``(grid_axis,
    offset)`` pairs and ``halo_args`` the arguments whose neighbours are
    read — plain metadata for a domain-decomposed replay.

    ``donate_args`` lists the positional arguments donated to the compiled
    executable (``jax.jit(donate_argnums=...)`` in the reference): results
    take over their storage (:func:`_alias_results`), so a pass-through
    region such as serve's ``KV_APPEND`` commit returns its argument at
    O(1) instead of copying it.  Donate only where the region is the last
    reader of that argument.  Executors under a staging policy run
    non-donating executables (``executable(donate=False)``): staged pages
    belong to the pool.

    ``compiled_by_parts`` marks a function that compiles its own parts and
    cannot be traced whole (the train step's ``FWD_BWD``, which runs
    autograd over executables compiled per layer kind): its executable is
    the function itself, on every target."""
    name: str
    fn: Callable
    offloaded: bool = True
    size_fn: Callable = default_size
    arg_spaces: Optional[Mapping[Any, umem.MemSpace]] = None
    result_space: Any = None      # MemSpace | {tuple index / dict key: MemSpace}
    stencil: Optional[Sequence[Tuple[int, int]]] = None
    halo_args: Optional[Sequence[Any]] = None
    donate_args: Optional[Sequence[int]] = None
    ledger: Ledger = dataclasses.field(default_factory=lambda: GLOBAL_LEDGER)
    compiled_by_parts: bool = False

    def __post_init__(self):
        self.name = self.ledger.register(self.name, self.offloaded)
        self.__name__ = getattr(self.fn, "__name__", "region")
        self._variants: Dict[str, Callable] = {"ref": self.fn}
        #: (kind, variant, donating) -> compiled callable; kind is "host"
        #: (CPU operands) or "device" (the ``default`` and ``device``
        #: targets, which run on the operands as they are)
        self._compiled: Dict[Tuple[str, str, bool], Callable] = {}
        self._exec: Dict[Tuple[str, str, bool], Callable] = {}
        #: compile record of each compiled callable, same keys
        self.compile_stats: Dict[Tuple[str, str, bool], CompileStats] = {}
        self._param_index = _param_indices(self.fn)
        self._validate_donate_args()

    def _validate_donate_args(self) -> None:
        """Fail at declaration, not at compile time: donate_args must be
        non-negative positional indices inside the signature (when it is
        introspectable and takes no *args), and must not overlap halo_args
        (a donated buffer is overwritten while a halo exchange still reads
        its neighbours).  The errors are the reference's."""
        if not self.donate_args:
            return
        bad = [d for d in self.donate_args
               if not isinstance(d, int) or d < 0]
        if bad:
            raise ValueError(
                f"region {self.name!r}: donate_args must be non-negative "
                f"positional indices, got {bad!r}")
        try:
            params = list(inspect.signature(self.fn).parameters.values())
        except (TypeError, ValueError):
            params = None                      # not introspectable: skip
        if params is not None and not any(
                p.kind is inspect.Parameter.VAR_POSITIONAL for p in params):
            n_pos = sum(1 for p in params if p.kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD))
            out = [d for d in self.donate_args if d >= n_pos]
            if out:
                raise ValueError(
                    f"region {self.name!r}: donate_args {out} out of range "
                    f"for a function with {n_pos} positional parameters "
                    f"({tuple(self._param_index)})")
        if self.halo_args:
            halo_idx = {h for h in self.halo_args if isinstance(h, int)}
            halo_idx |= {self._param_index[h] for h in self.halo_args
                         if isinstance(h, str) and h in self._param_index}
            clash = sorted(halo_idx & set(self.donate_args))
            if clash:
                raise ValueError(
                    f"region {self.name!r}: donate_args {clash} overlap "
                    f"halo_args {tuple(self.halo_args)}; a donated operand "
                    "is deleted by XLA while the sharded halo exchange "
                    "still reads its ghost cells — donate a different "
                    "argument or drop it from halo_args")

    @property
    def variants(self) -> Tuple[str, ...]:
        return tuple(self._variants)

    def variant(self, name: str, fn: Optional[Callable] = None):
        """Register a named implementation (``declare variant``); usable as
        a decorator.  Variants take the base function's arguments and
        return the same structure.  Re-registering ``ref`` replaces the
        base function.  Re-registering a variant drops its compiled
        executables."""
        def register(f: Callable) -> Callable:
            self._variants[name] = f
            if name == "ref":
                self.fn = f
            for table in (self._compiled, self._exec, self.compile_stats):
                for key in [k for k in table if k[1] == name]:
                    del table[key]
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

    def _compiled_fn(self, kind: str, impl: str, donating: bool) -> Callable:
        key = (kind, impl, donating)
        call = self._compiled.get(key)
        if call is None:
            stats = self.compile_stats[key] = CompileStats()
            call = self._compiled[key] = compile_region_fn(
                self.impl_fn(impl), f"{self.name}_{impl}_{kind}",
                tuple(self.donate_args or ()) if donating else (), stats)
        return call

    def executable(self, target: str = "default", impl: str = "ref",
                   donate: bool = True) -> Callable:
        """The compiled callable of one (routing target, variant, donation)
        triple, cached.  ``default`` and ``device`` run the variant on the
        operands as they are: where they live (the APU), or on the card
        where the policy's stager or the caller put them; they share one
        compiled callable.  ``host`` runs a callable compiled for the CPU:
        CUDA operands cross to it and the results cross back (the module
        docstring).  ``donate=False`` compiles without ``donate_args``
        (staging executors, calibration loops).  Unknown names fall back
        to ``ref``; a kernel variant on the host target raises.  Inside
        :func:`disable_compile` the variant runs eagerly."""
        if target not in TARGETS:
            raise ValueError(f"target {target!r} is not one of {TARGETS}")
        impl = self.resolve(impl)
        if target == "host" and impl == KERNEL_VARIANT:
            raise ValueError(
                f"region {self.name!r}: variant {impl!r} launches a CUDA "
                "kernel and cannot run on the host target")
        if compile_disabled() or self.compiled_by_parts:
            fn = self.impl_fn(impl)
            return _on_host(fn) if target == "host" else fn
        donating = bool(donate and self.donate_args)
        key = (target, impl, donating)
        call = self._exec.get(key)
        if call is None:
            kind = "host" if target == "host" else "device"
            call = self._compiled_fn(kind, impl, donating)
            if target == "host":
                call = _on_host(call)
            self._exec[key] = call
        return call


def region(name: Optional[str] = None, *, offloaded: bool = True,
           ledger: Optional[Ledger] = None, size_fn: Optional[Callable] = None,
           placement: Optional[Mapping[Any, umem.MemSpace]] = None,
           result_space: Any = None,
           stencil: Optional[Sequence[Tuple[int, int]]] = None,
           halo_args: Optional[Sequence[Any]] = None,
           donate_args: Optional[Sequence[int]] = None,
           compiled_by_parts: bool = False):
    """Decorator: mark a function as one offloadable region (listings 4-6).

        @region("Amul", placement={0: MemSpace.DEVICE},
                stencil=dia.STENCIL_OFFSETS, halo_args=("x",))
        def amul(diag, off, x): ...
    """
    def wrap(fn: Callable) -> Region:
        return Region(name=name or getattr(fn, "__name__", "region"),
                      fn=fn, offloaded=offloaded,
                      size_fn=size_fn or default_size,
                      arg_spaces=placement, result_space=result_space,
                      stencil=stencil, halo_args=halo_args,
                      donate_args=donate_args,
                      ledger=ledger or GLOBAL_LEDGER,
                      compiled_by_parts=compiled_by_parts)
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


def _chunked_copy_into(h: torch.Tensor, dst: torch.Tensor, chunk_bytes: int):
    """Stage ``h`` into the pooled device buffer ``dst`` in leading-axis
    slabs of at most ``chunk_bytes`` (at least one row each) — the
    managed-memory page-migration model with the page size set by a
    :class:`~repro_torch.core.oversub.MemoryBudget`.  Each slab is one
    ``copy_`` on the current stream, asynchronous from pinned pages.
    Values are those of one whole copy (same bytes, another copy
    granularity).  Returns ``(dst, n_slabs)``; the slab count is the
    reference's."""
    rows = int(h.shape[0]) if h.dim() else 0
    row_bytes = umem.nbytes(h) // rows if rows else umem.nbytes(h)
    slab = max(1, int(chunk_bytes) // max(int(row_bytes), 1))
    if not rows or rows <= slab:
        dst.copy_(h, non_blocking=True)
        return dst, 1
    n = 0
    for start in range(0, rows, slab):
        dst[start:start + slab].copy_(h[start:start + slab],
                                      non_blocking=True)
        n += 1
    return dst, n


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
    are still real, pooled and timed.

    ``budget`` (a :class:`~repro_torch.core.oversub.MemoryBudget`) bounds
    the transient staging granule: a leaf larger than the budget's
    ``staging_chunk_bytes()`` migrates in leading-axis slabs
    (:func:`_chunked_copy_into`), each slab counted with ``note_chunks``.
    Chunking changes the copy granularity, never values; a slab's source
    is a view of the leaf, which the caller keeps alive until the copies
    are waited on."""
    arena: UnifiedArena = dataclasses.field(default_factory=UnifiedArena)
    host_pool: HostStagingPool = dataclasses.field(
        default_factory=HostStagingPool)
    device_pool: Optional[DeviceBufferPool] = None
    budget: Optional[Any] = None
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
        given), copied on the current stream, in slabs under a budget."""
        if not isinstance(x, torch.Tensor):
            return x
        pool = rotation if rotation is not None else self.device_pool
        dst = pool.acquire(x.shape, x.dtype)
        chunk = self.budget.staging_chunk_bytes() \
            if self.budget is not None else None
        if chunk is not None and umem.nbytes(x) > chunk:
            dst, n = _chunked_copy_into(x, dst, chunk)  # budgeted slabs
            self.budget.note_chunks(n)
        else:
            dst.copy_(x, non_blocking=True)         # host -> device copy
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


@dataclasses.dataclass
class Placer:
    """Placement axis: apply a region's MemSpace hints through umem.

    ``min_bytes`` is the paper-C4-style threshold: leaves smaller than it
    stay where they are (placing a scalar across spaces costs more than it
    saves).  ``device`` is the accelerator that ``MemSpace.DEVICE`` means.

    ``_place_tree`` is the single placement primitive every hint flows
    through — subclasses override it to make placement *conditional*
    (:class:`~repro_torch.core.oversub.BudgetedPlacer` demotes device
    hints to host space when a memory budget lacks headroom)."""
    min_bytes: int = 0
    honor_hints: bool = True
    device: Any = "cuda"

    def _place_tree(self, tree, space: umem.MemSpace):
        return umem.tree_place(tree, space, self.device,
                               min_bytes=self.min_bytes)

    def place_args(self, region: Region, args, kwargs):
        if not (self.honor_hints and region.arg_spaces):
            return args, kwargs
        args = list(args)
        kwargs = dict(kwargs)
        for key, space in region.arg_spaces.items():
            if isinstance(key, str):
                if key in kwargs:
                    kwargs[key] = self._place_tree(kwargs[key], space)
                    continue
                # name hint for a positionally-passed argument
                key = region._param_index.get(key, -1)
            if isinstance(key, int) and 0 <= key < len(args):
                args[key] = self._place_tree(args[key], space)
        return tuple(args), kwargs

    def migrations(self, region: Region, unplaced, placed) -> list:
        """``(leaf index, device)`` of each leaf of the placed call
        (``pytree`` leaf order of ``(args, kwargs)``) that a call run on
        the card copies in for itself: each leaf the region's hints moved
        off the card goes back to its device, and each leaf of an argument
        hinted to a host space that already lives in host memory (kept
        there between calls, as offloaded AdamW moments are) goes to the
        placer's card (the module docstring)."""
        if not region.arg_spaces:
            return []
        homes = pytree.tree_leaves(unplaced)
        moves = [(i, homes[i].device) for i in _demoted(unplaced, placed)]
        card = torch.device(self.device)
        if card.type == "cpu":
            return moves        # on the CPU host memory is the device's
        hinted = {k for k, space in region.arg_spaces.items()
                  if space is not umem.MemSpace.DEVICE}
        hinted |= {region._param_index[k] for k in hinted
                   if k in region._param_index}
        taken = {i for i, _ in moves}
        for i, (path, x) in enumerate(pytree.tree_flatten_with_path(
                placed)[0]):
            arg = getattr(path[1], "idx", getattr(path[1], "key", None))
            if i not in taken and arg in hinted and isinstance(
                    x, torch.Tensor) and x.device.type == "cpu":
                moves.append((i, card))
        return moves

    def place_result(self, region: Region, out):
        if not (self.honor_hints and region.result_space is not None):
            return out
        rs = region.result_space
        if isinstance(rs, Mapping):
            # keyed form: place only the named top-level result elements
            if isinstance(out, tuple):
                placed = list(out)
                for key, space in rs.items():
                    if isinstance(key, int) and 0 <= key < len(placed):
                        placed[key] = self._place_tree(placed[key], space)
                return tuple(placed)
            if isinstance(out, dict):
                return {k: self._place_tree(v, rs[k])
                        if k in rs else v for k, v in out.items()}
            return out
        return self._place_tree(out, rs)


def _demoted(before, after) -> list:
    """Leaf indices of ``after`` that placement moved off the card: a
    tensor leaf on a non-CPU device in ``before`` and on the CPU in
    ``after`` (the two trees have one structure)."""
    return [i for i, (b, a) in enumerate(zip(pytree.tree_leaves(before),
                                             pytree.tree_leaves(after)))
            if isinstance(b, torch.Tensor) and b.device.type != "cpu"
            and isinstance(a, torch.Tensor) and a.device.type == "cpu"]


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
    pay real staging copies both ways (paper Fig 6).

    ``budget`` (a :class:`~repro_torch.core.oversub.MemoryBudget`) makes
    the policy oversubscription-aware: the device pool charges its
    in-use bytes against it and the stager migrates in budget-sized
    slabs."""

    def __init__(self, arena: Optional[UnifiedArena] = None,
                 host_pool: Optional[HostStagingPool] = None,
                 device_pool: Optional[DeviceBufferPool] = None,
                 placer: Optional[Placer] = None,
                 selector: Optional[Any] = None,
                 device: Any = "cuda",
                 budget: Optional[Any] = None):
        arena = arena or UnifiedArena(device)
        if device_pool is None:
            device_pool = DeviceBufferPool(device=arena.device, budget=budget)
        super().__init__("discrete", StaticRouter("device", "default"),
                         MigrationStager(arena,
                                         host_pool or HostStagingPool(),
                                         device_pool, budget=budget),
                         placer or Placer(device=arena.device),
                         selector or StaticSelector("ref"))
        self.arena = arena
        self.budget = budget


class AdaptivePolicy(ComposedPolicy):
    """Calibrated size-based routing inside an executor: the
    ``TARGET_CUT_OFF`` clause as a policy axis.  Calls above the cutoff run
    where the operands live (on the card), the rest on the host.

    With a ``budget`` and no ``stager``, device-routed calls pay
    budget-chunked staging like the discrete model: a
    :class:`MigrationStager` to ``device`` whose pool charges the
    budget."""

    def __init__(self, cutoff: int = DEFAULT_CUTOFF,
                 stager: Optional[Any] = None,
                 placer: Optional[Placer] = None,
                 selector: Optional[Any] = None,
                 budget: Optional[Any] = None,
                 device: Any = "cuda"):
        if stager is None and budget is not None:
            arena = UnifiedArena(device)
            stager = MigrationStager(
                arena, device_pool=DeviceBufferPool(device=arena.device,
                                                    budget=budget),
                budget=budget)
        super().__init__("adaptive", SizeRouter(cutoff),
                         stager or NullStager(), placer or Placer(),
                         selector or StaticSelector("ref"))
        self.budget = budget
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
        warm-up call, which absorbs any compile at that size (the first,
        and the recompile for dynamic shapes at the second), and ends in a
        device synchronise."""
        r = target_region
        self.calibration = {}
        crossover = None
        for n in sorted(sizes):
            args = make_args(n)
            ts = {}
            for tgt in ("host", "device"):
                impl = self.selector.select(r, tgt, args, {}, size=n)
                call = r.executable(tgt, impl, donate=False)
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
        unplaced = (args, kwargs)
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
        elif tgt != "host":
            # leaves that placement keeps off the card migrate in for this
            # call alone (the module docstring)
            moves = pol.placer.migrations(r, unplaced, (args, kwargs))
            if moves:
                t0 = time.perf_counter()
                (args, kwargs), b = self._migrate_in((args, kwargs), moves)
                synchronize()
                staging_s += time.perf_counter() - t0
                staging_b += b
        elif tgt == "host":
            home = _home_device((args, kwargs))
            if home is not None:                    # the crossing to the CPU
                t0 = time.perf_counter()
                (args, kwargs), b = _move((args, kwargs), _CPU)
                staging_s += time.perf_counter() - t0
                staging_b += b
        t0 = time.perf_counter()
        # staged operands are pool pages: under a staging policy nothing
        # is donated
        out = r.executable(tgt, impl,
                           donate=not pol.stager.stages)(*args, **kwargs)
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

    @staticmethod
    def _migrate_in(placed, moves):
        """``placed`` with each leaf of ``moves`` (``(leaf index,
        device)``) copied to that device; returns (tree, bytes copied)."""
        leaves, spec = pytree.tree_flatten(placed)
        moved = 0
        for i, device in moves:
            moved += umem.nbytes(leaves[i])
            leaves[i] = leaves[i].to(device, non_blocking=True)
        return pytree.tree_unflatten(leaves, spec), moved

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
