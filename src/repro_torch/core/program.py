"""Captured region programs: record one step, replay it through any
executor (counterpart of ``repro.core.program``).

* :func:`capture` runs a step function once under a recording ``run``
  callable and records every region call plus the dataflow between calls
  (which output leaf feeds which later argument leaf).  Capture executes
  each region's base (``ref``) function eagerly, so host-side control flow
  proceeds normally and is *frozen* into the trace, CUDA-graph style:
  loop counts and host scalars become program constants.
* :class:`RegionProgram` is the trace: ops, input slots, constants and
  the output spec.  ``replay(executor, *inputs)`` re-issues the calls
  through an :class:`~repro_torch.core.regions.Executor` under any policy,
  dropping each output leaf after its last use, so a decode loop holds
  two recurrent states at a time and not one per generated token.
  The trace stores the *Region*, never a callable, so every replay
  re-resolves each op's variant through the executing policy's selector:
  one captured step replays under ``StaticSelector("ref")`` or
  ``StaticSelector("hopper")`` without re-capturing.

Capture semantics: tensor leaves returned by a region and passed to a
later region become dataflow edges that replay recomputes; tensor leaves
of the example inputs become input slots that replay fills positionally;
everything else (Python scalars, tensors computed outside any region) is
captured as a constant.

Trees are flattened with ``torch.utils._pytree``.  Still to come (ROADMAP
A.5): ``replay_batch``, ``as_fn``, ``AsyncExecutor``, ``interval_overlap``
and ``verify``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.regions import Region


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
        """Re-issue the trace, in order, through ``executor.run`` on
        ``inputs``, which have the structure of the capture's examples."""
        in_leaves = self._input_leaves(inputs)
        env: List[List[Any]] = []

        def resolve(d):
            if isinstance(d, Ref):
                return env[d.op][d.leaf]
            if isinstance(d, In):
                return in_leaves[d.slot]
            return d.value

        for i, op in enumerate(self.ops):
            args, kwargs = pytree.tree_unflatten(
                [resolve(d) for d in op.leaves], op.in_tree)
            env.append(pytree.tree_leaves(executor.run(op.region, *args,
                                                       **kwargs)))
            del args, kwargs
            for k, j in self._dead_after.get(i, ()):
                env[k][j] = None
        return pytree.tree_unflatten([resolve(d) for d in self.out_leaves],
                                     self.out_tree)


def capture(fn: Callable, *example_inputs,
            name: str = "program") -> RegionProgram:
    """Record ``fn(run, *example_inputs)`` into a :class:`RegionProgram`.

    ``fn`` receives a recording ``run(region, *args, **kwargs)`` callable in
    place of ``Executor.run``; every call runs the region's base function
    eagerly (so Python control flow sees concrete values) and is recorded
    with its dataflow."""
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
        leaves, tree = pytree.tree_flatten((args, kwargs))
        op = OpCall(r, tree, [describe(x) for x in leaves])
        out = r.fn(*args, **kwargs)
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
