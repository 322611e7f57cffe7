"""Captured programs and their async replay on the port: capture fidelity
(against the JAX package's capture of the same SIMPLE step), replay equal
to the eager step, synchronous and async replay bit for bit equal under
every policy, the overlap accounting, and the pooled buffer rotation
(the ports of tests/test_program.py).

On the CPU the async replay copies when it queues, before it waits on the
op before, so its overlap is 0; the side-stream overlap is checked on the
card (``tests/test_torch_gpu.py``).
"""
import gc

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.cfd.grid import Grid as JGrid
from repro.cfd.simple import (SimpleConfig as JSimpleConfig,
                              SimpleFoam as JSimpleFoam,
                              init_state as j_init_state)
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
from repro_torch.core.ledger import Ledger
from repro_torch.core.pool import BufferRotation, DeviceBufferPool
from repro_torch.core.program import (AsyncExecutor, In, Lit, Ref,
                                      _flatten_call, capture,
                                      interval_overlap)
from repro_torch.core.regions import (AdaptivePolicy, DiscretePolicy, Executor,
                                      HostPolicy, StaticSelector,
                                      TargetSelector, UnifiedPolicy, region,
                                      disable_compile)


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


N = 1 << 15           # big enough to exceed the pools' 5K-element threshold
POLICIES = {"unified": UnifiedPolicy, "host": HostPolicy,
            "discrete": lambda: DiscretePolicy(device="cpu"),
            "adaptive": lambda: AdaptivePolicy(cutoff=1024)}


def make_program(ledger=None, selector=None):
    """A small solver-shaped program: dataflow edges, a host-extracted
    scalar (frozen as a constant), and a two-output region."""
    kw = dict(ledger=ledger or Ledger("prog_test"))

    @region("scale", **kw)
    def scale(d, x):
        return d * x

    @region("saxpy", **kw)
    def saxpy(a, x, y):
        return y - a * x

    @saxpy.variant("hopper")
    def _saxpy_variant(a, x, y):
        saxpy.variant_calls += 1
        return y - a * x

    saxpy.variant_calls = 0

    @region("split", **kw)
    def split(x):
        return x * 0.5, x * 2.0

    @region("dot", **kw)
    def dot(x, y):
        return torch.sum(x * y)

    def step(run, d, x, b):
        r = run(saxpy, 1.0, run(scale, d, x), b)
        lo, hi = run(split, r)
        s = float(run(dot, lo, hi))            # frozen control-flow scalar
        return run(saxpy, s / (abs(s) + 1.0), lo, y=hi)

    d = torch.linspace(1.0, 2.0, N)
    x = torch.full((N,), 0.3)
    b = torch.linspace(0.0, 1.0, N)
    prog = capture(step, d, x, b, name="mini", selector=selector)
    return prog, (d, x, b), saxpy


def test_capture_records_dataflow_constants_and_call_shape():
    prog, _, _ = make_program()
    assert len(prog) == 5 and prog.n_inputs == 3
    kinds = [type(l) for op in prog.ops for l in op.leaves]
    assert Ref in kinds and In in kinds and Lit in kinds
    assert isinstance(prog.out_leaves[0], Ref)
    assert "5 ops" in prog.summary()
    last = prog.ops[-1]
    assert last.arg_keys == [0, 1, "y"]           # a, x, then the kwarg
    assert [op.example_size for op in prog.ops] == [N, N, N, N, N]


def test_flatten_call_keys_follow_pytree_order():
    args = (1.0, (torch.ones(2), torch.zeros(3)), [torch.ones(4)])
    kwargs = {"z": torch.ones(5), "a": {"q": torch.ones(6), "p": 2}}
    leaves, keys, tree = _flatten_call(args, kwargs)
    assert leaves == pytree.tree_flatten((args, kwargs))[0]
    assert tree == pytree.tree_flatten((args, kwargs))[1]
    assert keys == [0, 1, 1, 2, "z", "a", "a"]


def test_capture_runs_the_selected_variant():
    """Without a selector capture runs ``ref`` (CPU results unchanged);
    with the policy's selector it runs what replays will run."""
    _, _, saxpy = make_program()
    assert saxpy.variant_calls == 0
    prog, inputs, saxpy = make_program(selector=TargetSelector())
    assert saxpy.variant_calls == 2
    ref_prog, _, _ = make_program(selector=StaticSelector("ref"))
    ex = Executor(UnifiedPolicy())
    assert torch.equal(prog.replay(ex, *inputs), ref_prog.replay(ex, *inputs))


@pytest.mark.parametrize("name", list(POLICIES))
def test_async_matches_sync_under_every_policy(name):
    prog, inputs, _ = make_program()
    out_s = prog.replay(Executor(POLICIES[name]()), *inputs)
    out_a = prog.replay(AsyncExecutor(POLICIES[name]()), *inputs)
    assert torch.equal(out_s, out_a)


def test_replay_with_fresh_inputs_recomputes_dataflow():
    prog, (d, x, b), _ = make_program()
    ex = Executor(UnifiedPolicy())
    out = prog.replay(ex, d, torch.full((N,), 0.9), b)
    assert not torch.allclose(out, prog.replay(ex, d, x, b))


def test_async_discrete_accounts_like_sync():
    prog, inputs, _ = make_program()
    asyn = AsyncExecutor(DiscretePolicy(device="cpu"))
    sync = Executor(DiscretePolicy(device="cpu"))
    assert torch.equal(prog.replay(asyn, *inputs), prog.replay(sync, *inputs))
    rep_a, rep_s = asyn.report(), sync.report()
    assert rep_a["staging_s"] > 0 and "+async" in rep_a["mode"]
    for name, r in asyn.ledger.regions.items():
        assert r.staging_bytes == sync.ledger.regions[name].staging_bytes
        assert 0.0 <= r.overlap_s <= r.staging_s, name
    assert rep_a["overlap_s"] <= rep_a["staging_s"]
    assert rep_a["overlap_fraction"] == pytest.approx(
        rep_a["overlap_s"] / rep_a["staging_s"])
    assert rep_a["staging_saved_s"] == rep_a["overlap_s"]
    assert rep_s["overlap_s"] == 0.0 and rep_s["overlap_fraction"] == 0.0
    assert rep_a["overlap_s"] == 0.0          # CPU copies never overlap


def test_async_prefetches_through_the_rotation(monkeypatch):
    """Every op after the first gets its ready leaves from a prefetch; the
    leaves its predecessor produces are staged at issue time."""
    from repro_torch.core.regions import MigrationStager
    calls = []
    enqueue = MigrationStager.enqueue_leaves

    def spy(self, leaves, rotation=None):
        calls.append((len(leaves), type(rotation).__name__))
        return enqueue(self, leaves, rotation)

    monkeypatch.setattr(MigrationStager, "enqueue_leaves", spy)
    prog, inputs, _ = make_program()
    prog.replay(AsyncExecutor(DiscretePolicy(device="cpu")), *inputs)
    assert ("_RotationHandle" in {kind for _, kind in calls})
    assert sum(n for n, _ in calls) == sum(
        1 for op in prog.ops for d in op.leaves
        if not isinstance(d, Lit) or isinstance(d.value, torch.Tensor))


def test_null_stager_policies_report_zero_overlap():
    prog, inputs, _ = make_program()
    asyn = AsyncExecutor(UnifiedPolicy())
    prog.replay(asyn, *inputs)
    rep = asyn.report()
    assert rep["staging_s"] == 0.0 and rep["overlap_fraction"] == 0.0


def test_async_executor_run_falls_back_to_sync():
    ldg = Ledger("fallback")
    twice = region("twice", ledger=ldg)(lambda x: x * 2.0)
    asyn = AsyncExecutor(UnifiedPolicy(), ldg)
    assert torch.equal(asyn.run(twice, torch.ones(8)), 2.0 * torch.ones(8))
    assert asyn.report()["mode"] == "unified+async"


def test_interval_overlap():
    assert interval_overlap(0.0, 1.0, [(0.5, 2.0)]) == 0.5
    assert interval_overlap(0.0, 1.0, [(1.0, 2.0), (-1.0, 0.0)]) == 0.0
    assert interval_overlap(1.0, 3.0, [(0.0, 1.5), (2.0, 2.5)]) == 1.0


# -- the SIMPLE step ---------------------------------------------------------

SETTINGS = dict(nu=0.1, inner_max=6)


def _app(policy=None):
    cfg = SimpleConfig(grid=Grid((8, 8, 8), device="cpu"), **SETTINGS)
    app = SimpleFoam(cfg, executor=Executor(policy or UnifiedPolicy()))
    st, _, _ = app.run_steps(init_state(cfg), 1)
    return app, st


def test_captured_step_records_the_same_calls_as_jax():
    app, st = _app()
    prog = app.capture_step(st)
    jcfg = JSimpleConfig(grid=JGrid((8, 8, 8)), **SETTINGS)
    japp = JSimpleFoam(jcfg)
    jst, _, _ = japp.run_steps(j_init_state(jcfg), 1)
    jprog = japp.capture_step(jst)
    assert [op.region.name for op in prog.ops] == \
        [op.region.name for op in jprog.ops]
    assert [op.arg_keys for op in prog.ops] == \
        [op.arg_keys for op in jprog.ops]
    assert prog.n_inputs == jprog.n_inputs == 4


@pytest.mark.parametrize("name", ["unified", "discrete", "host", "adaptive"])
def test_captured_step_replays_like_the_eager_step(name):
    """Replayed from the capture's own state under any policy, the step
    equals the eager step (tol-based inner loops: the frozen iteration
    counts are the eager step's)."""
    app, st = _app(UnifiedPolicy(selector=TargetSelector()))
    prog = app.capture_step(st)
    eager, _ = app.time_step(st)
    pol = {"unified": lambda: UnifiedPolicy(selector=TargetSelector()),
           "discrete": lambda: DiscretePolicy(selector=TargetSelector(),
                                              device="cpu"),
           "host": lambda: HostPolicy(selector=TargetSelector()),
           "adaptive": lambda: AdaptivePolicy(
               1024, selector=TargetSelector())}[name]()
    for ex in (Executor(pol), AsyncExecutor(pol)):
        got, _ = app.replay_steps(prog, st, 1, ex)
        for f in "uvwp":
            a, b = getattr(eager, f), getattr(got, f)
            assert (a - b).abs().max().item() <= \
                1e-5 * max(1.0, a.abs().max().item())


def test_cavity_step_sync_and_async_discrete_replays_are_bitwise_equal():
    """tests/test_program.py::test_cavity_step_capture_parity on the port:
    one captured step, two chained replays, sync against async under the
    discrete policy."""
    app, st = _app()
    prog = app.capture_step(st)
    assert len(prog) > 20
    sync = Executor(DiscretePolicy(device="cpu"))
    asyn = AsyncExecutor(DiscretePolicy(device="cpu"))
    s_sync, _ = app.replay_steps(prog, st, 2, sync)
    s_asyn, _ = app.replay_steps(prog, st, 2, asyn)
    for f in "uvwp":
        assert torch.equal(getattr(s_sync, f), getattr(s_asyn, f))
    rep = asyn.report()
    assert rep["staging_s"] > 0 and rep["overlap_s"] <= rep["staging_s"]


# -- recycling races -----------------------------------------------------------

def test_replay_results_survive_forced_recycling_20_of_20():
    """Sync and async executors share ONE discrete policy, so every replay
    recycles the host pages, device buffers and rotation banks of the one
    before; outputs must stay equal to the snapshots taken before the
    pools were churned again, 20 rounds of 20."""
    prog, inputs, _ = make_program()
    pol = DiscretePolicy(device="cpu")
    sync, asyn = Executor(pol), AsyncExecutor(pol)
    for i in range(20):
        out_a = prog.replay(asyn, *inputs)
        snap_a = out_a.clone()
        out_s = prog.replay(sync, *inputs)
        snap_s = out_s.clone()
        assert torch.equal(snap_s, snap_a), f"round {i}: sync != async"
        out_a2 = prog.replay(asyn, *inputs)
        assert torch.equal(out_a, snap_a), f"round {i}: first replay changed"
        assert torch.equal(out_s, snap_s), f"round {i}: sync replay changed"
        assert torch.equal(out_a2, snap_a)
    assert pol.stager.host_pool.stats.hits > 0
    assert pol.stager.device_pool.stats.hits > 0


def test_async_replay_returns_its_banks_and_pages():
    prog, inputs, _ = make_program()
    pol = DiscretePolicy(device="cpu")
    out = prog.replay(AsyncExecutor(pol), *inputs)
    del out
    gc.collect()
    assert pol.stager.host_pool.stats.bytes_in_use == 0
    assert pol.stager.device_pool.stats.bytes_in_use == 0


# -- BufferRotation ---------------------------------------------------------------

def _pool():
    return DeviceBufferPool(min_elems=1, device="cpu")


def test_rotation_banks_are_disjoint_and_retire_releases():
    pool = _pool()
    rot = BufferRotation(pool, depth=2)
    a = rot.acquire((N,), torch.float32)
    rot.advance()
    b = rot.acquire((N,), torch.float32)
    assert a.data_ptr() != b.data_ptr()
    assert rot.in_flight == 2
    rot.retire()                       # oldest bank (a) returns to the pool
    assert rot.in_flight == 1
    assert pool.acquire((N,), torch.float32) is a


def test_rotation_advance_auto_retires_when_full():
    rot = BufferRotation(_pool(), depth=2)
    rot.acquire((64,), torch.float32)
    rot.advance()
    rot.acquire((64,), torch.float32)
    assert rot.in_flight == 2
    rot.advance()          # rotation full: the oldest bank retires itself
    assert rot.in_flight == 1 and rot.rotations == 2


def test_rotation_drain_releases_everything():
    pool = _pool()
    rot = BufferRotation(pool, depth=3)
    rot.acquire((64,), torch.float32)
    rot.advance()
    rot.acquire((64,), torch.float32)
    rot.acquire((64,), torch.float32)       # same active bank
    assert rot.in_flight == 3
    rot.drain()
    assert rot.in_flight == 0 and rot.generation == 1
    hits = pool.stats.hits
    for _ in range(3):
        pool.acquire((64,), torch.float32)
    assert pool.stats.hits == hits + 3


def test_rotation_depth_validation():
    with pytest.raises(ValueError):
        BufferRotation(_pool(), depth=1)


def test_rotation_generation_tag_rejects_stale_registrations():
    """A staging task that outlives its replay (drain bumps the
    generation) hands its buffer back to the pool instead of parking it in
    the next replay's banks."""
    pool = _pool()
    rot = BufferRotation(pool, depth=2)
    handle = rot.handle()                  # minted in generation 0
    rot.acquire((64,), torch.float32)
    rot.drain()                            # replay ends: generation 1
    stale = pool.acquire((64,), torch.float32)
    handle.register(stale)                 # the stale task lands late
    assert rot.in_flight == 0              # NOT parked in a bank
    again = pool.acquire((64,), torch.float32)
    assert again.data_ptr() == stale.data_ptr()
    rot.handle().register(again)           # a fresh handle parks normally
    assert rot.in_flight == 1
    fresh = rot.handle().acquire((64,), torch.float32)
    assert rot.in_flight == 2 and fresh.data_ptr() != again.data_ptr()


def test_an_input_returned_unchanged_replays_as_the_new_input():
    prog = capture(lambda run, x, k: x, torch.ones(3), 2.0)
    assert prog.n_inputs == 2 and isinstance(prog.out_leaves[0], In)
    assert np.array_equal(prog.replay(Executor(UnifiedPolicy()),
                                      torch.zeros(3), 2.0).numpy(),
                          np.zeros(3))
