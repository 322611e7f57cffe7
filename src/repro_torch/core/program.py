"""Captured region programs: record one step, replay it through any
executor (counterpart of ``repro.core.program``).

* :func:`capture` runs a step function once under a recording ``run``
  callable and records every region call plus the dataflow between calls
  (which output leaf feeds which later argument leaf).  Capture runs each
  call as it comes (through the region's compiled ``default``
  executable, as the reference's runs ``r.jitted``), so host-side control
  flow proceeds normally and is *frozen* into the trace, CUDA-graph style:
  loop counts and host scalars become program constants.  It runs the
  variant that the caller's ``selector`` picks (``ref`` when none is
  given), so on the card a captured step runs the kernels that its
  replays will run and no plain version.
* :class:`RegionProgram` is the trace: ops, input slots, constants and
  the output spec.  ``replay(executor, *inputs)`` re-issues the calls
  through an :class:`~repro_torch.core.regions.Executor` under any policy,
  dropping each output leaf after its last use, so a decode loop holds
  two recurrent states at a time and not one per generated token.
  The trace stores the *Region*, never a callable, so every replay
  re-resolves each op's variant through the executing policy's selector:
  one captured step replays under ``StaticSelector("ref")`` or
  ``StaticSelector("hopper")`` without re-capturing.
* :meth:`RegionProgram.as_fn` composes the ops' variants along the
  recorded dataflow into one function of the inputs, and
  :meth:`RegionProgram.replay_batch` runs N independent instances through
  ``torch.compile(torch.func.vmap(as_fn))``, booked as one ledger row.
* :class:`AsyncExecutor` replays a program with one-op lookahead staging:
  while op *k* computes on the compute stream, op *k+1*'s operands that are
  already available are copied on a side CUDA stream into the next bank of
  a :class:`~repro_torch.core.pool.BufferRotation`, and the compute stream
  waits on the copies' event before op *k+1*.  The same kernels run on
  the same copies as under the synchronous ``Executor``, so results are
  bit for bit the same; only the schedule of the copies changes.

Capture semantics: tensor leaves returned by a region and passed to a
later region become dataflow edges that replay recomputes; tensor leaves
of the example inputs become input slots that replay fills positionally;
everything else (Python scalars, tensors computed outside any region) is
captured as a constant.

A leaf whose region carries a placement hint is placed by it before the
async replay stages it (``_leaf_space``), as the reference places it.

Trees are flattened with ``torch.utils._pytree``.  Still to come (ROADMAP
A.3): ``verify``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import umem
from repro_torch.core.ledger import Ledger
from repro_torch.core.pool import BufferRotation
from repro_torch.core.regions import (Executor, Region, compile_disabled,
                                      compile_region_fn, synchronize)


@dataclasses.dataclass(frozen=True)
class Ref:
    """Output leaf ``leaf`` of a previous op ``op``."""
    op: int
    leaf: int


@dataclasses.dataclass(frozen=True)
class In:
    """Leaf ``slot`` of the program's flattened inputs."""
    slot: int


class Lit:
    """A captured constant (host scalar, frozen control-flow value, or a
    tensor computed outside any region)."""
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


@dataclasses.dataclass
class OpCall:
    """One recorded region call."""
    region: Region
    in_tree: Any                 # TreeSpec of (args, kwargs)
    leaves: List[Any]            # Ref | In | Lit per argument leaf
    arg_keys: List[Any]          # per-leaf top-level arg index / kwarg name
    example_size: int            # size_fn at capture (routing prediction)


def _resolver(env: List[List[Any]], in_leaves: List[Any]) -> Callable:
    """The one Ref/In/Lit resolution rule, shared by every replay path."""
    def resolve(d):
        if isinstance(d, Ref):
            return env[d.op][d.leaf]
        if isinstance(d, In):
            return in_leaves[d.slot]
        return d.value
    return resolve


def _flatten_call(args, kwargs) -> Tuple[List[Any], List[Any], Any]:
    """Flatten (args, kwargs), keeping per leaf the top-level positional
    index or keyword name it belongs to.  Leaf order is that of
    ``pytree.tree_flatten((args, kwargs))``: tuples in order, dicts in
    insertion order."""
    leaves, tree = pytree.tree_flatten((args, kwargs))
    keys: List[Any] = []
    for idx, a in enumerate(args):
        keys += [idx] * len(pytree.tree_leaves(a))
    for name, a in kwargs.items():
        keys += [name] * len(pytree.tree_leaves(a))
    return leaves, keys, tree


class RegionProgram:
    """A recorded trace of region calls with explicit dataflow."""

    def __init__(self, name: str = "program"):
        self.name = name
        self.ops: List[OpCall] = []
        self.in_tree = None
        self.n_inputs = 0
        self.out_tree = None
        self.out_leaves: List[Any] = []
        #: op index -> (op, leaf) outputs whose last reader is that op
        self._dead_after: Dict[int, List[Tuple[int, int]]] = {}
        #: (in_dims, variant per op) -> compiled vmapped composite
        self._batched: Dict[Any, Callable] = {}
        #: ledger -> its ``<name>[batch]`` row, weak at the ledger
        self._batch_rows = weakref.WeakKeyDictionary()

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def n_constants(self) -> int:
        return sum(1 for op in self.ops for d in op.leaves
                   if isinstance(d, Lit))

    def summary(self) -> str:
        edges = sum(1 for op in self.ops for d in op.leaves
                    if isinstance(d, Ref))
        return (f"RegionProgram({self.name!r}: {len(self.ops)} ops, "
                f"{self.n_inputs} input leaves, {edges} dataflow edges, "
                f"{self.n_constants} constants)")

    def _input_leaves(self, inputs: tuple) -> List[Any]:
        leaves, tree = pytree.tree_flatten(inputs)
        if tree != self.in_tree:
            raise ValueError(
                f"replay inputs structure {tree} != captured {self.in_tree}")
        return leaves

    def replay(self, executor, *inputs):
        """Re-issue the trace through ``executor`` on ``inputs``, which have
        the structure of the capture's examples.  ``executor`` is an
        :class:`~repro_torch.core.regions.Executor` (any policy) or an
        :class:`AsyncExecutor` (same results, overlapped staging)."""
        if hasattr(executor, "replay_program"):
            return executor.replay_program(self, *inputs)
        return self._replay_sequential(executor.run, inputs)

    def _drop_dead(self, env: List[List[Any]], i: int) -> None:
        """Drop the output leaves whose last reader is op ``i``."""
        for k, j in self._dead_after.get(i, ()):
            env[k][j] = None

    def _replay_sequential(self, run: Callable, inputs: tuple):
        in_leaves = self._input_leaves(inputs)
        env: List[List[Any]] = []
        resolve = _resolver(env, in_leaves)
        for i, op in enumerate(self.ops):
            args, kwargs = pytree.tree_unflatten(
                [resolve(d) for d in op.leaves], op.in_tree)
            env.append(pytree.tree_leaves(run(op.region, *args, **kwargs)))
            del args, kwargs
            self._drop_dead(env, i)
        return pytree.tree_unflatten([resolve(d) for d in self.out_leaves],
                                     self.out_tree)

    # -- batched replay --------------------------------------------------
    def _op_impls(self, selector=None) -> Tuple[str, ...]:
        """One variant name per op under ``selector`` (None: ``ref``
        everywhere).  The composite has no routing step, so selection sees
        the ``default`` target and the captured example size, the
        prediction the async lookahead uses too."""
        if selector is None:
            return tuple("ref" for _ in self.ops)
        return tuple(
            op.region.resolve(selector.select(op.region, "default", (), {},
                                              size=op.example_size))
            for op in self.ops)

    def as_fn(self, selector=None) -> Callable:
        """The program as one function of its inputs: the ops' variants
        (picked by ``selector``) composed along the recorded dataflow,
        captured constants closed over.  No executor and no staging.  Each
        call holds its environment for that call only: every output leaf
        lives until the call returns (the sequential replay's liveness drop
        is not needed, since a compiled composite frees by its own
        analysis)."""
        impls = self._op_impls(selector)
        fns = [op.region.impl_fn(impl) for op, impl in zip(self.ops, impls)]

        def fn(*inputs):
            in_leaves = self._input_leaves(inputs)
            env: List[List[Any]] = []
            resolve = _resolver(env, in_leaves)
            for op, f in zip(self.ops, fns):
                args, kwargs = pytree.tree_unflatten(
                    [resolve(d) for d in op.leaves], op.in_tree)
                env.append(pytree.tree_leaves(f(*args, **kwargs)))
            return pytree.tree_unflatten(
                [resolve(d) for d in self.out_leaves], self.out_tree)
        return fn

    def replay_batch(self, *stacked_inputs, executor=None, in_axes=0,
                     selector=None):
        """Replay N independent instances through one vmapped composite:
        ``torch.compile(torch.func.vmap(as_fn(selector), in_dims=in_axes))``
        (eager inside :func:`~repro_torch.core.regions.disable_compile`).

        ``stacked_inputs`` mirror the captured input structure with a
        batch axis on every tensor leaf (``in_axes`` as ``vmap``'s
        ``in_dims``); captured constants broadcast.  One compiled
        composite per (``in_axes``, variant mix).  The call is timed to a
        synchronise and booked as one ``<name>[batch]`` row on the
        executor's ledger (when one is given)."""
        impls = self._op_impls(selector)
        batched_fn = torch.func.vmap(self.as_fn(selector), in_dims=in_axes)
        if compile_disabled():
            batched = batched_fn
        else:
            key = (repr(in_axes), impls)
            batched = self._batched.get(key)
            if batched is None:
                batched = self._batched[key] = compile_region_fn(
                    batched_fn, f"{self.name}_batch")
        t0 = time.perf_counter()
        out = batched(*stacked_inputs)
        synchronize()
        dt = time.perf_counter() - t0
        if executor is not None:
            sizes = [a.numel() for a in pytree.tree_leaves(stacked_inputs)
                     if isinstance(a, torch.Tensor)]
            executor.ledger.record(
                self._batch_row(executor.ledger), device=True, offloaded=True,
                compute_s=dt, elems=max(sizes, default=0))
        return out

    def _batch_row(self, ledger: Ledger) -> str:
        """This program's ``<name>[batch]`` row on ``ledger``, weak-keyed
        by the ledger object, so a recycled address never resurrects a
        stale row name."""
        name = self._batch_rows.get(ledger)
        if name is None:
            name = self._batch_rows[ledger] = ledger.register(
                f"{self.name}[batch]", True)
        return name


def capture(fn: Callable, *example_inputs, name: str = "program",
            selector: Optional[Any] = None) -> RegionProgram:
    """Record ``fn(run, *example_inputs)`` into a :class:`RegionProgram`.

    ``fn`` receives a recording ``run(region, *args, **kwargs)`` callable in
    place of ``Executor.run``; every call runs when it is made (so Python
    control flow sees concrete values), through the region's ``default``
    executable (compiled and donating, as the reference's capture runs
    ``r.jitted``; eager inside ``disable_compile``), and is recorded with
    its dataflow.  Each call runs the variant ``selector`` picks for the
    ``default`` target at the call's size (the executing policy's
    selector, so that on the card capture launches the kernels its replays
    launch); without a selector, the base function ``ref``."""
    prog = RegionProgram(name)
    in_leaves, prog.in_tree = pytree.tree_flatten(example_inputs)
    prog.n_inputs = len(in_leaves)
    # id -> descriptor of every live tensor whose origin is known; an
    # entry leaves with its tensor, so a recycled id is never mistaken
    origin: Dict[int, Any] = {}
    n_out: List[int] = []

    def track(x, desc):
        origin[id(x)] = desc
        weakref.finalize(x, origin.pop, id(x), None)

    for i, leaf in enumerate(in_leaves):
        if isinstance(leaf, torch.Tensor):
            track(leaf, In(i))

    def describe(x):
        if isinstance(x, torch.Tensor) and id(x) in origin:
            return origin[id(x)]
        return Lit(x)

    def run(r: Region, *args, **kwargs):
        leaves, keys, tree = _flatten_call(args, kwargs)
        size = r.size_fn(args, kwargs)
        op = OpCall(r, tree, [describe(x) for x in leaves], keys, size)
        impl = "ref" if selector is None else r.resolve(
            selector.select(r, "default", args, kwargs, size=size))
        out = r.executable("default", impl)(*args, **kwargs)
        k = len(prog.ops)
        out_leaves = pytree.tree_leaves(out)
        for j, ol in enumerate(out_leaves):
            if isinstance(ol, torch.Tensor):
                track(ol, Ref(k, j))
        prog.ops.append(op)
        n_out.append(len(out_leaves))
        return out

    res_leaves, prog.out_tree = pytree.tree_flatten(fn(run, *example_inputs))
    prog.out_leaves = [describe(x) for x in res_leaves]
    # liveness: each op's output leaf dies after its last reader (a leaf
    # nothing reads dies after its own op); program outputs never die
    last = {(k, j): k for k, n in enumerate(n_out) for j in range(n)}
    for i, op in enumerate(prog.ops):
        for d in op.leaves:
            if isinstance(d, Ref):
                last[(d.op, d.leaf)] = i
    for d in prog.out_leaves:
        if isinstance(d, Ref):
            del last[(d.op, d.leaf)]
    for key, i in last.items():
        prog._dead_after.setdefault(i, []).append(key)
    return prog


# ---------------------------------------------------------------------------
# AsyncExecutor: one-op lookahead staging on a side stream
# ---------------------------------------------------------------------------

def _leaf_space(region: Region, key) -> Optional[umem.MemSpace]:
    """The MemSpace hint (if any) governing the top-level arg/kwarg ``key``
    — per-leaf mirror of ``Placer.place_args``."""
    spaces = region.arg_spaces
    if not spaces:
        return None
    sp = spaces.get(key)
    if sp is None and isinstance(key, int):
        for pname, idx in region._param_index.items():
            if idx == key and pname in spaces:
                return spaces[pname]
    return sp


def interval_overlap(t0: float, t1: float, spans) -> float:
    """Seconds of the interval ``[t0, t1]`` covered by the (disjoint)
    compute intervals ``spans``: staging hidden behind compute."""
    return sum(max(0.0, min(t1, b1) - max(t0, b0)) for b0, b1 in spans)


@dataclasses.dataclass
class _Prefetch:
    """The lookahead copies queued for one upcoming op."""
    staged: Dict[int, Any]       # leaf index -> staged device leaf
    nbytes: int
    start: Any                   # stamps (see _Streams) around the copies
    done: Any
    sources: List[Any]           # the copies' sources, alive until read


class _Streams:
    """Where the async replay's work runs, and when.  On a card: the
    compute stream, a side stream for the lookahead copies, and CUDA-event
    stamps timed against one reference event.  On the CPU both are the
    host, a copy is done when it returns, and stamps are the host clock,
    so a copy never overlaps compute."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)
            self.side.wait_stream(self.compute)   # inputs queued before us
        self._ref = self.stamp()

    def stamp(self):
        """A timestamp on the current stream."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, stamp) -> float:
        """Seconds from the reference stamp to ``stamp`` (waits for it)."""
        if not self.cuda:
            return stamp - self._ref
        stamp.synchronize()
        return self._ref.elapsed_time(stamp) / 1e3

    def finish(self, stamp) -> None:
        """Wait on the host until ``stamp``'s stream has reached it."""
        if self.cuda:
            stamp.synchronize()

    def prefetch(self, stager, ready: List[Tuple[int, Any]],
                 rotation) -> _Prefetch:
        """Queue the copies of ``ready`` (leaf index, leaf) on the side
        stream into ``rotation``'s active bank; returns at once."""
        sources = [x for _, x in ready]
        side = torch.cuda.stream(self.side) if self.cuda \
            else contextlib.nullcontext()
        with side:
            start = self.stamp()
            staged, nbytes = stager.enqueue_leaves(sources, rotation)
            done = self.stamp()
        return _Prefetch({i: y for (i, _), y in zip(ready, staged)}, nbytes,
                         start, done, sources)

    def consume(self, pf: _Prefetch) -> None:
        """Make the compute stream wait for a prefetch's copies, and tell
        the allocator that the compute stream reads its buffers."""
        if self.cuda:
            self.compute.wait_event(pf.done)
            for y in pf.staged.values():
                if isinstance(y, torch.Tensor):
                    y.record_stream(self.compute)

    def close(self) -> None:
        """Order the compute stream after every queued copy."""
        if self.cuda:
            self.compute.wait_stream(self.side)


class AsyncExecutor:
    """Replays :class:`RegionProgram`\\ s under one policy with one-op
    staging lookahead, double-buffered through a
    :class:`~repro_torch.core.pool.BufferRotation`.

    While op *k* computes, op *k+1*'s operand leaves that are already
    available (program inputs, constants, outputs of ops before *k*) are
    copied on a side stream into the next bank; leaves that op *k* itself
    produces are staged at issue time on the compute stream.  The overlap
    of the copies with op *k*'s compute, both timed by CUDA events against
    one reference event, is booked as ``overlap_s`` on op *k+1*'s ledger
    row.  On the CPU the copies run when queued, before op *k* is waited
    on, and the overlap is 0.

    Ops that do not stage (a policy without a staging stager, a host
    target, a region without a directive) run through a synchronous inner
    ``Executor``, which is also what ``run`` delegates to, so an
    AsyncExecutor stands anywhere an Executor does."""

    def __init__(self, policy, ledger: Optional[Ledger] = None,
                 lookahead_depth: int = 2):
        self.policy = policy
        self.ledger = ledger or Ledger(policy.name + "+async")
        self.mode = policy.name + "+async"
        self.lookahead_depth = lookahead_depth
        self._inner = Executor(policy, self.ledger)

    def run(self, target_region, *args, **kwargs):
        return self._inner.run(target_region, *args, **kwargs)

    def report(self) -> dict:
        rep = self.ledger.coverage_report()
        rep["mode"] = self.mode
        return rep

    def replay_program(self, prog: RegionProgram, *inputs):
        stager = self.policy.stager
        if not getattr(stager, "stages", False) or \
                not hasattr(stager, "enqueue_leaves"):
            # nothing to overlap (APU/host model): plain sequential replay
            return prog._replay_sequential(self._inner.run, inputs)
        return self._replay_overlapped(prog, inputs)

    def _replay_overlapped(self, prog: RegionProgram, inputs: tuple):
        pol = self.policy
        stager = pol.stager
        in_leaves = prog._input_leaves(inputs)
        env: List[List[Any]] = []
        resolve = _resolver(env, in_leaves)
        rotation = BufferRotation(stager.device_pool,
                                  depth=self.lookahead_depth)
        streams = _Streams(stager.arena.device)

        def will_stage(op: OpCall) -> bool:
            """Predicted from the captured example size; a wrong
            prediction only wastes one prefetch."""
            tgt = pol.router.target(op.region, (), {}, size=op.example_size)
            return op.region.offloaded and tgt != "host"

        def placed(op: OpCall, i: int, leaf):
            """A leaf placed by its region's hint before it is staged."""
            sp = _leaf_space(op.region, op.arg_keys[i])
            if sp is not None and pol.placer.honor_hints:
                return umem.tree_place(leaf, sp, pol.placer.device,
                                       min_bytes=pol.placer.min_bytes)
            return leaf

        pending: Optional[Tuple[int, _Prefetch]] = None
        prev_compute = (0.0, 0.0)
        for k, op in enumerate(prog.ops):
            r = op.region
            raw = [resolve(d) for d in op.leaves]
            args, kwargs = pytree.tree_unflatten(raw, op.in_tree)
            n = r.size_fn(args, kwargs)
            tgt = pol.router.target(r, args, kwargs, size=n)
            pf = None
            if pending is not None and pending[0] == k:
                pf = pending[1]
                pending = None
                streams.consume(pf)
            if not (r.offloaded and tgt != "host"):
                # not staging: the synchronous path; a mispredicted
                # prefetch is dropped (its bank drains at the end)
                env.append(pytree.tree_leaves(self._inner.run(r, *args,
                                                              **kwargs)))
                del args, kwargs
                prog._drop_dead(env, k)
                continue
            impl = r.resolve(pol.selector.select(r, tgt, args, kwargs,
                                                 size=n))
            staging_s, staging_b = 0.0, 0
            staged_map = dict(pf.staged) if pf else {}
            todo = [(i, x) for i, x in enumerate(raw)
                    if isinstance(x, torch.Tensor) and i not in staged_map]
            if todo:
                staged, s, b = stager.stage_leaves(
                    [placed(op, i, x) for i, x in todo], rotation)
                staging_s += s
                staging_b += b
                staged_map.update({i: y for (i, _), y in zip(todo, staged)})
            args, kwargs = pytree.tree_unflatten(
                [staged_map.get(i, x) for i, x in enumerate(raw)], op.in_tree)
            t0 = time.perf_counter()
            c0 = streams.stamp()
            # a staging policy donates nothing: staged pages are the pool's
            out = r.executable(tgt, impl, donate=False)(*args, **kwargs)
            c1 = streams.stamp()
            # queue the NEXT op's copies before waiting on this op's
            # compute: this ordering is the whole overlap
            if k + 1 < len(prog.ops) and will_stage(prog.ops[k + 1]):
                nxt = prog.ops[k + 1]
                ready = []
                for i, d in enumerate(nxt.leaves):
                    if isinstance(d, Ref) and d.op >= k:
                        continue                # depends on op k: not ready
                    x = resolve(d)
                    if isinstance(x, torch.Tensor):
                        ready.append((i, placed(nxt, i, x)))
                if ready:
                    rotation.advance()
                    pending = (k + 1, streams.prefetch(stager, ready,
                                                       rotation.handle()))
            streams.finish(c1)
            t1 = time.perf_counter()
            overlap_s = 0.0
            if pf is not None:
                p0, p1 = streams.seconds(pf.start), streams.seconds(pf.done)
                staging_s += p1 - p0
                staging_b += pf.nbytes
                overlap_s = interval_overlap(p0, p1, (prev_compute,))
            prev_compute = (streams.seconds(c0), streams.seconds(c1))
            out, s, b = stager.stage_out(r, out, None)
            staging_s += s
            staging_b += b
            rotation.retire()           # this op's staged inputs are dead
            out = pol.placer.place_result(r, out)
            self.ledger.record(self._inner._row_name(r), device=True,
                               offloaded=r.offloaded, compute_s=t1 - t0,
                               staging_s=staging_s, staging_bytes=staging_b,
                               elems=n, overlap_s=overlap_s, impl=impl)
            env.append(pytree.tree_leaves(out))
            del args, kwargs, out, pf
            prog._drop_dead(env, k)
        streams.close()
        rotation.drain()
        return pytree.tree_unflatten([resolve(d) for d in prog.out_leaves],
                                     prog.out_tree)
