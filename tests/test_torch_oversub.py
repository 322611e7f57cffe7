"""Memory oversubscription on the port (``repro_torch.core.oversub``), held
against the JAX package's ``repro.core.oversub`` on the same byte
sequences and shapes: the budget's accounting (``BudgetStats.as_dict()``
equal to JAX's after the same calls), the device pool's charging, budgeted
placement (the same leaves admitted and spilled), the demoted placement
hints, the slab count of chunked staging, and the CFD workload of
``fig_oversub``: a captured 12^3 SIMPLE step replayed under discrete and
adaptive policies whose budget is a quarter of the state, bit for bit
equal to the unbudgeted replay and within docs/DESIGN.md §2
(``|err| <= 1e-5 * max(1, max|field|)``) of the reference's unified
replay (the ports of tests/test_oversub.py:50-166,296-320).

The reference's own demoted-hint test fails on this jax (a host and a
device operand in one jit), so the port's is held to the reference's
unhinted run and to its placement decisions.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd.grid import Grid as JGrid
from repro.cfd.simple import (SimpleConfig as JSimpleConfig,
                              SimpleFoam as JSimpleFoam,
                              init_state as j_init_state)
from repro.core import umem as jumem
from repro.core.ledger import Ledger as JLedger
from repro.core.oversub import (BudgetedPlacer as JBudgetedPlacer,
                                MemoryBudget as JMemoryBudget,
                                workload_bytes as j_workload_bytes)
from repro.core.pool import DeviceBufferPool as JDeviceBufferPool
from repro.core.regions import (DiscretePolicy as JDiscretePolicy,
                                Executor as JExecutor,
                                UnifiedPolicy as JUnifiedPolicy,
                                _chunked_copy_into as j_chunked_copy_into,
                                region as jregion)
from repro.core.umem import MemSpace as JMemSpace
from repro_torch.cfd.convert import from_numpy
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam
from repro_torch.core import umem
from repro_torch.core.ledger import Ledger
from repro_torch.core.oversub import (MIN_CHUNK_BYTES, BudgetedPlacer,
                                      MemoryBudget, workload_bytes)
from repro_torch.core.pool import DeviceBufferPool
from repro_torch.core.program import AsyncExecutor, _leaf_space
from repro_torch.core.regions import (AdaptivePolicy, DiscretePolicy,
                                      Executor, MigrationStager,
                                      UnifiedPolicy, _chunked_copy_into,
                                      disable_compile, region)
from repro_torch.core.umem import MemSpace


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


def _both(script, limit):
    """Run ``script(budget)`` on a port and a JAX budget of ``limit``;
    returns both results and asserts equal stats."""
    port, ref = MemoryBudget(limit), JMemoryBudget(limit)
    got, want = script(port), script(ref)
    assert port.as_dict() == ref.as_dict()
    assert got == want
    return port


# ---------------------------------------------------------------------------
# MemoryBudget unit contract
# ---------------------------------------------------------------------------

def test_budget_charge_release_high_water():
    def script(b):
        out = [b.charge(60), b.stats.charged_bytes, b.charge(60), b.over,
               b.stats.pressure_events, b.stats.high_water_bytes]
        b.release(60)
        out += [b.over, b.stats.charged_bytes]
        b.release(1000)                  # floors at zero, never negative
        return out + [b.stats.charged_bytes, b.stats.high_water_bytes]
    b = _both(script, 100)
    assert b.stats.charged_bytes == 0 and b.stats.high_water_bytes == 120
    assert b.stats.pressure_events == 1


def test_budget_for_ratio_headroom_and_utilization():
    def script(cls):
        b = cls.for_ratio(1000, 4.0)
        out = [b.limit_bytes, b.oversubscription_ratio(1000), b.headroom()]
        b.charge(200)
        out += [b.headroom(), b.utilization(), b.fits(50), b.fits(51),
                cls.for_ratio(1000, 1.0).limit_bytes]
        u = cls()
        out += [u.fits(10**12), u.headroom(), u.oversubscription_ratio(10**12),
                u.staging_chunk_bytes(), u.utilization()]
        return out, b.as_dict()
    assert script(MemoryBudget) == script(JMemoryBudget)
    assert script(MemoryBudget)[0][:5] == [250, 4.0, 250, 50, 0.8]
    for bad in (lambda: MemoryBudget.for_ratio(1000, 0),
                lambda: MemoryBudget(0)):
        with pytest.raises(ValueError):
            bad()


def test_budget_admit_denies_and_counts_spill():
    def script(b):
        # consult: advisory, never charges
        return [b.admit(80), b.admit(80), b.stats.charged_bytes,
                b.consult(80), b.consult(10), b.stats.charged_bytes]
    b = _both(script, 100)
    assert b.stats.denials == 2 and b.stats.spilled_bytes == 160


@pytest.mark.parametrize("limit", [None, 16, 4096, 1 << 20, 12345678])
def test_budget_staging_chunk_bytes(limit):
    got = MemoryBudget(limit).staging_chunk_bytes()
    assert got == JMemoryBudget(limit).staging_chunk_bytes()
    if limit is None:
        assert got is None
    else:
        assert got == max(MIN_CHUNK_BYTES, limit // 4)


def test_budget_note_chunks_and_repr():
    b = _both(lambda b: [b.note_chunks(3), b.note_chunks(2)], 64)
    assert b.stats.staging_chunks == 5
    assert "64" in repr(b) and "charged=0" in repr(b)


def test_budget_is_thread_safe_under_contention():
    """Threads charging and releasing at once lose no update: with a
    shortened switch interval, every charge and release is counted and
    the budget returns to zero."""
    b = MemoryBudget(1 << 20)
    n_threads, n_ops = 16, 2000

    def work():
        for _ in range(n_ops):
            b.charge(8)
            b.consult(4)
            b.release(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_ops
    assert b.stats.charges == b.stats.releases == b.stats.admitted == total
    assert b.stats.charged_bytes == 0


# ---------------------------------------------------------------------------
# DeviceBufferPool x budget: accounting agrees byte for byte
# ---------------------------------------------------------------------------

def test_device_pool_charges_and_releases_budget():
    def script(b, pool, make):
        x = pool.acquire((8,), make)             # 32 B
        out = [b.stats.charged_bytes, pool.stats.bytes_in_use]
        y = pool.acquire((16,), make)            # 96 B: over, pressure
        out += [b.stats.charged_bytes, pool.stats.bytes_in_use,
                b.stats.pressure_events]
        pool.release(x)
        pool.release(y)
        out += [b.stats.charged_bytes, pool.stats.bytes_in_use,
                b.stats.high_water_bytes]
        # free-list hits charge too: a reacquired buffer is device-resident
        z = pool.acquire((8,), make)
        out += [pool.stats.hits, b.stats.charged_bytes]
        pool.release(z)
        return out
    b, jb = MemoryBudget(64), JMemoryBudget(64)
    got = script(b, DeviceBufferPool(min_elems=0, device="cpu", budget=b),
                 torch.float32)
    want = script(jb, JDeviceBufferPool(min_elems=0, budget=jb), jnp.float32)
    assert got == want == [32, 32, 96, 96, 1, 0, 0, 96, 1, 32]
    assert b.as_dict() == jb.as_dict()


def test_device_pool_skips_budget_below_threshold():
    b = MemoryBudget(1024)
    pool = DeviceBufferPool(min_elems=100, device="cpu", budget=b)
    x = pool.acquire((8,), torch.float32)        # unpooled: not charged
    assert pool.stats.unpooled == 1 and b.stats.charged_bytes == 0
    pool.release(x)
    assert b.stats.charged_bytes == 0 and b.stats.charges == 0


def test_device_pool_without_budget_is_unchanged():
    pool = DeviceBufferPool(min_elems=0, device="cpu")
    pool.release(pool.acquire((8,), torch.float32))
    assert pool.budget is None and pool.stats.bytes_in_use == 0


# ---------------------------------------------------------------------------
# Placement axis under a budget
# ---------------------------------------------------------------------------

def _tree(lib):
    """One tree, in the port's and the reference's leaf order alike
    (dict keys inserted sorted): 32, 32, 64, 16, 128 and 8 bytes."""
    def a(n, start):
        return lib.arange(start, start + n, dtype=lib.float32)
    return {"a": a(8, 0), "b": (a(8, 8), [a(16, 16), a(4, 32)]),
            "c": {"d": a(32, 40), "e": a(2, 72)}}


@pytest.mark.parametrize("charge", [True, False])
@pytest.mark.parametrize("min_bytes", [0, 20])
@pytest.mark.parametrize("limit", [40, 100, 150, 1000])
def test_tree_place_budgeted_splits_like_jax(limit, min_bytes, charge):
    """The same tree under the same budget: the same leaves admitted, the
    same accounting, and every value unchanged (placement, not math)."""
    b, jb = MemoryBudget(limit), JMemoryBudget(limit)
    tree, jtree = _tree(torch), _tree(jnp)
    placed = umem.tree_place_budgeted(tree, b, "cpu", min_bytes=min_bytes,
                                      charge=charge)
    jplaced = jumem.tree_place_budgeted(jtree, jb, min_bytes=min_bytes,
                                        charge=charge)
    assert b.as_dict() == jb.as_dict()
    got, want = umem.tree_leaves(placed), jax.tree.leaves(jplaced)
    assert len(got) == len(want) == 6
    for g, w, x in zip(got, want, umem.tree_leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, x)


def test_tree_place_budgeted_admits_in_leaf_order():
    b = MemoryBudget(40)
    tree = {"a": torch.arange(8, dtype=torch.float32),     # 32 B: admitted
            "b": torch.arange(8, dtype=torch.float32)}     # 32 B: spilled
    umem.tree_place_budgeted(tree, b, "cpu")
    assert b.stats.charged_bytes == 32
    assert b.stats.denials == 1 and b.stats.spilled_bytes == 32


def test_tree_place_min_bytes_leaves_small_leaves_alone():
    x, y = torch.ones(2), torch.ones(64)
    out = umem.tree_place((x, y, 3.0), MemSpace.HOST_UNPINNED, "cpu",
                          min_bytes=16)
    assert out[0] is x and out[2] == 3.0 and torch.equal(out[1], y)


def test_default_spill_space_follows_pinning():
    want = MemSpace.HOST if torch.cuda.is_available() \
        else MemSpace.HOST_UNPINNED
    assert umem.default_spill_space() is want


def _hinted(region_fn, space, ledger):
    @region_fn("bp_scale", ledger=ledger, placement={0: space, 1: space})
    def bp_scale(a, x):
        return a * x
    return bp_scale


def test_budgeted_placer_demotes_hints_bitwise():
    """A 32 B operand within the budget, a 2 KiB one demoted: the result
    equals the reference's unhinted run bit for bit, the budget admits and
    denies what the reference's does, and nothing stays charged."""
    a = np.linspace(0.0, 1.0, 8).astype(np.float32)
    x = np.linspace(1.0, 2.0, 8 * 64).astype(np.float32).reshape(64, 8)
    jout = JExecutor(JUnifiedPolicy(), JLedger("bp_ref")).run(
        _hinted(jregion, JMemSpace.DEVICE, JLedger("bp_j")),
        jnp.asarray(a), jnp.asarray(x))
    budget = MemoryBudget(256)
    pol = UnifiedPolicy(placer=BudgetedPlacer(budget=budget, device="cpu"))
    ex = Executor(pol, Ledger("bp_out"))
    r = _hinted(region, MemSpace.DEVICE, Ledger("bp"))
    out = ex.run(r, torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the reference placer's decisions on the same operands
    jb = JMemoryBudget(256)
    JBudgetedPlacer(budget=jb)._place_tree(
        (jnp.asarray(a), jnp.asarray(x)), JMemSpace.DEVICE)
    assert budget.as_dict() == jb.as_dict()
    # consult-only: hints are per-call transients, nothing stays charged
    assert budget.stats.charged_bytes == 0
    assert budget.stats.admitted == 1 and budget.stats.denials == 1
    # nothing crossed: on the CPU the demotion moves no operand off a card
    assert ex.ledger.regions["bp_scale"].staging_bytes == 0


def test_placer_honors_hints_by_name_key_and_threshold():
    ldg = Ledger("hints")

    @region("named", ledger=ldg, placement={"x": MemSpace.HOST_UNPINNED})
    def named(a, x):
        return a + x
    a, x = torch.ones(4), torch.ones(4)
    placer = BudgetedPlacer(budget=MemoryBudget(8), device="cpu")
    for args, kwargs in (((a, x), {}), ((a,), {"x": x})):
        got = placer.place_args(named, args, kwargs)
        assert torch.equal(named.fn(*got[0], **got[1]), a + x)
    assert _leaf_space(named, 1) is MemSpace.HOST_UNPINNED
    assert _leaf_space(named, 0) is None
    off = BudgetedPlacer(honor_hints=False, device="cpu")
    assert off.place_args(named, (a, x), {}) == ((a, x), {})


def test_placer_result_space_keyed_and_whole():
    ldg = Ledger("results")

    @region("pair", ledger=ldg, result_space={1: MemSpace.HOST_UNPINNED})
    def pair(a):
        return a, a * 2
    @region("whole", ledger=ldg, result_space=MemSpace.HOST_UNPINNED)
    def whole(a):
        return {"k": a}
    a = torch.ones(4)
    ex = Executor(UnifiedPolicy(placer=BudgetedPlacer(device="cpu")), ldg)
    got = ex.run(pair, a)
    assert torch.equal(got[0], a) and torch.equal(got[1], a * 2)
    assert torch.equal(ex.run(whole, a)["k"], a)


# ---------------------------------------------------------------------------
# Chunked staging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,chunk", [((12, 12, 12), 4096),
                                         ((6, 12, 12, 12), 4096),
                                         ((100,), 64), ((7, 5), 20),
                                         ((3, 4), 4096), ((), 4)])
def test_chunked_copy_slab_count_and_values_match_jax(shape, chunk):
    h = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    dst = torch.empty(shape)
    got, n = _chunked_copy_into(torch.from_numpy(h), dst, chunk)
    jgot, jn = j_chunked_copy_into(h, jnp.zeros(shape, jnp.float32), chunk)
    assert n == jn and got is dst
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_migration_stager_chunks_under_a_budget():
    budget = MemoryBudget(4096)                  # chunks of 4096 B
    stager = MigrationStager(umem.UnifiedArena("cpu"), budget=budget,
                             device_pool=DeviceBufferPool(device="cpu",
                                                          budget=budget))
    # 32 KiB, above the pool's threshold: rows of 512 B, 8 to a slab
    x = torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128)
    (args, _), _, nbytes = stager.stage_in(None, (x,), {})
    assert torch.equal(args[0], x) and nbytes == x.numel() * 4
    assert budget.stats.staging_chunks == 8
    assert budget.stats.charged_bytes == nbytes       # the pooled buffer


def test_workload_bytes_walks_dataclasses_like_jax():
    jcfg = JSimpleConfig(grid=JGrid((6, 5, 4)), nu=0.1)
    jst = j_init_state(jcfg)
    st = from_numpy(jst, "cpu")
    assert workload_bytes(st) == j_workload_bytes(jst) == 4 * 6 * 5 * 4 * 4
    assert workload_bytes([st, {"x": torch.ones(3)}, 2.0]) == \
        4 * 6 * 5 * 4 * 4 + 12


# ---------------------------------------------------------------------------
# Workload (c): CFD grids beyond device capacity via budgeted staged replay
# ---------------------------------------------------------------------------

SHAPE = (12, 12, 12)
SETTINGS = dict(nu=0.1, inner_max=6)


@pytest.fixture(scope="module")
def cavity():
    """The reference's state after one step, its captured step replayed 2
    steps under unified (the oracle) and under its budgeted discrete
    policy (for the chunk count); the port's app and capture on that
    state."""
    jcfg = JSimpleConfig(grid=JGrid(SHAPE), **SETTINGS)
    japp = JSimpleFoam(jcfg)
    jst, _, _ = japp.run_steps(j_init_state(jcfg), 1)
    jprog = japp.capture_step(jst)
    jref, _ = japp.replay_steps(jprog, jst, 2, JExecutor(JUnifiedPolicy()))
    jbudget = JMemoryBudget.for_ratio(j_workload_bytes(jst), 4.0)
    japp.replay_steps(jprog, jst, 2,
                      JExecutor(JDiscretePolicy(budget=jbudget)))
    with disable_compile():
        app = SimpleFoam(SimpleConfig(grid=Grid(SHAPE, device="cpu"),
                                      **SETTINGS),
                         executor=Executor(UnifiedPolicy()))
        st = from_numpy(jst, "cpu")
        prog = app.capture_step(st)
    return (app, st, prog, {f: np.asarray(getattr(jref, f)) for f in "uvwp"},
            jbudget)


POLICIES = {
    "discrete": lambda budget=None: DiscretePolicy(device="cpu",
                                                   budget=budget),
    # a cutoff below the grid's 1728 cells routes the step's regions to the
    # card side, where the budgeted stager runs
    "adaptive": lambda budget=None: AdaptivePolicy(1024, budget=budget,
                                                   device="cpu"),
}


@pytest.mark.parametrize("executor", [Executor, AsyncExecutor])
@pytest.mark.parametrize("mode", sorted(POLICIES))
def test_cfd_budgeted_chunked_staging_bitwise(cavity, mode, executor):
    """A captured SIMPLE step replayed under a policy whose budget is 1/4
    of the state: staging happens in budget-sized slabs, the fields equal
    the unbudgeted replay bit for bit and stay within §2 of the
    reference's unified replay."""
    app, st, prog, jref, jbudget = cavity
    s_ref, _ = app.replay_steps(prog, st, 2, executor(POLICIES[mode]()))
    fp = workload_bytes(st)
    assert fp == 4 * 12 ** 3 * 4
    budget = MemoryBudget.for_ratio(fp, 4.0)
    assert budget.staging_chunk_bytes() < 12 ** 3 * 4      # < one field
    s_b, _ = app.replay_steps(prog, st, 2, executor(POLICIES[mode](budget)))
    for f in "uvwp":
        assert torch.equal(getattr(s_ref, f), getattr(s_b, f)), f
        got, want = getattr(s_b, f).numpy(), jref[f]
        assert np.abs(got - want).max() <= \
            1e-5 * max(1.0, float(np.abs(want).max())), f
    assert budget.stats.staging_chunks > 0
    assert budget.stats.pressure_events > 0          # it really didn't fit
    if mode == "discrete" and executor is Executor:
        # the same leaves staged in the same slabs as the reference's
        assert budget.stats.staging_chunks == jbudget.stats.staging_chunks


@pytest.mark.parametrize("ratio", [1.0, 2.0, 4.0])
def test_cfd_budget_curve_charges_and_releases(cavity, ratio):
    """At every ratio the replay equals the unbudgeted one, the pool's
    bytes in use and the budget's charge agree, and a replay leaves
    nothing charged."""
    app, st, prog, _, _ = cavity
    s_ref, _ = app.replay_steps(prog, st, 1,
                                Executor(DiscretePolicy(device="cpu")))
    budget = MemoryBudget.for_ratio(workload_bytes(st), ratio)
    pol = DiscretePolicy(device="cpu", budget=budget)
    s_b, _ = app.replay_steps(prog, st, 1, Executor(pol))
    for f in "uvwp":
        assert torch.equal(getattr(s_ref, f), getattr(s_b, f))
    assert budget.stats.charged_bytes == \
        pol.stager.device_pool.stats.bytes_in_use == 0
    # the off-diagonal stacks (6 fields) exceed a chunk at every ratio
    assert budget.stats.high_water_bytes > 0
    assert budget.stats.staging_chunks > 0
