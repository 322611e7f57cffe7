"""The port's routing axis and the paper's four memory models, held against
the JAX package: host and adaptive SIMPLE steps against the reference's
steps, routing per region, the policy table, the calibrated cutoff, and
the rule that a host-routed call never runs a kernel variant.

Steps run ``nu=0.1, inner_max=5, tol_u=tol_p=0`` on 8^3, so every side
takes the same iterations, and each field must agree within the step
envelope of docs/DESIGN.md §2: |err| <= 1e-5 * max(1, max|field|).  The
reference's ``HostPolicy`` and ``AdaptivePolicy`` steps equal its
``UnifiedPolicy`` step here, so each is a second oracle.
"""
import numpy as np
import pytest
import torch

from repro.cfd.grid import Grid as JGrid
from repro.cfd.simple import (SimpleConfig as JSimpleConfig,
                              SimpleFoam as JSimpleFoam,
                              init_state as j_init_state)
from repro.core.ledger import Ledger as JLedger
from repro.core.regions import (AdaptivePolicy as JAdaptivePolicy,
                                Executor as JExecutor,
                                HostPolicy as JHostPolicy,
                                POLICIES as J_POLICIES,
                                UnifiedPolicy as JUnifiedPolicy,
                                make_policy as j_make_policy,
                                region as j_region)
from repro_torch.cfd.__main__ import main
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import (AMUL_LADDER, SimpleConfig, SimpleFoam,
                                    init_state)
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import (DEFAULT_CUTOFF, AdaptivePolicy, Executor,
                                      HostPolicy, POLICIES, SizeRouter,
                                      StaticSelector, TargetSelector,
                                      UnifiedPolicy, make_policy, region,
                                      disable_compile)


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


SHAPE = (8, 8, 8)
SETTINGS = dict(nu=0.1, inner_max=5, tol_u=0.0, tol_p=0.0)
STEPS = 2
#: cutoffs below and above every region size of the 8^3 step
LOW, HIGH = 16, 1 << 30


def _jax_policy(name):
    return {"unified": JUnifiedPolicy, "host": JHostPolicy,
            "adaptive_low": lambda: JAdaptivePolicy(cutoff=LOW),
            "adaptive_high": lambda: JAdaptivePolicy(cutoff=HIGH)}[name]()


def _port_policy(name):
    sel = TargetSelector()
    return {"unified": lambda: UnifiedPolicy(selector=sel),
            "host": lambda: HostPolicy(selector=sel),
            "adaptive_low": lambda: AdaptivePolicy(LOW, selector=sel),
            "adaptive_high": lambda: AdaptivePolicy(HIGH, selector=sel)}[
                name]()


def _rows(ledger):
    return {name: (r.device_calls, r.host_calls)
            for name, r in ledger.regions.items() if r.calls}


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name in ("unified", "host", "adaptive_low", "adaptive_high"):
        cfg = JSimpleConfig(JGrid(SHAPE), **SETTINGS)
        app = JSimpleFoam(cfg, executor=JExecutor(_jax_policy(name)))
        st = j_init_state(cfg)
        for _ in range(STEPS):
            st, m = app.time_step(st)
        out[name] = ({f: np.asarray(getattr(st, f)) for f in "uvwp"}, m,
                     _rows(app.ledger))
    return out


def _port_run(policy):
    cfg = SimpleConfig(Grid(SHAPE, device="cpu"), **SETTINGS)
    app = SimpleFoam(cfg, executor=Executor(policy))
    st = init_state(cfg)
    for _ in range(STEPS):
        st, m = app.time_step(st)
    return {f: getattr(st, f).numpy() for f in "uvwp"}, m, app


def _within_envelope(got, want):
    for f in "uvwp":
        assert np.isfinite(got[f]).all()
        allowed = 1e-5 * max(1.0, float(np.abs(want[f]).max()))
        err = float(np.abs(got[f] - want[f]).max())
        assert err <= allowed, (f, err, allowed)


@pytest.mark.parametrize("name", ["host", "adaptive_low", "adaptive_high"])
def test_step_matches_jax_unified_and_own_policy(jax_runs, name):
    got, m, _ = _port_run(_port_policy(name))
    for oracle in ("unified", name):
        want, jm, _ = jax_runs[oracle]
        assert (m["iters_u"], m["iters_p"]) == (jm["iters_u"], jm["iters_p"])
        _within_envelope(got, want)


@pytest.mark.parametrize("name", ["unified", "host", "adaptive_low",
                                  "adaptive_high"])
def test_routing_per_region_equals_jax(jax_runs, name):
    _, _, app = _port_run(_port_policy(name))
    assert _rows(app.ledger) == jax_runs[name][2]


def test_adaptive_routes_by_size_like_jax():
    """The same region called below and above the cutoff: host then
    device on both sides, and a region without a directive stays on the
    host."""
    cut = 1000
    ldg, jldg = Ledger("t"), JLedger("t")
    twice = region("twice", ledger=ldg)(lambda x: x * 2.0)
    bare = region("bare", ledger=ldg, offloaded=False)(lambda x: x + 1.0)
    jtwice = j_region("twice", ledger=jldg)(lambda x: x * 2.0)
    jbare = j_region("bare", ledger=jldg, offloaded=False)(lambda x: x + 1.0)
    ex = Executor(AdaptivePolicy(cut), ldg)
    jex = JExecutor(JAdaptivePolicy(cut), jldg)
    for n in (cut, cut + 1):
        ex.run(twice, torch.ones(n))
        ex.run(bare, torch.ones(n))
        jex.run(jtwice, np.ones(n, np.float32))
        jex.run(jbare, np.ones(n, np.float32))
    assert _rows(ldg) == _rows(jldg) == {"twice": (1, 1), "bare": (0, 2)}
    assert SizeRouter().cutoff == DEFAULT_CUTOFF == \
        JAdaptivePolicy().cutoff


def test_make_policy_keys_equal_jax():
    assert set(POLICIES) == set(J_POLICIES)
    for name in POLICIES:
        kw = {"device": "cpu"} if name == "discrete" else {}
        assert make_policy(name, **kw).name == j_make_policy(name).name \
            == name


def test_calibrate_records_cutoffs():
    """A cutoff from the timing ladder lands on the region's ledger row
    and on the mirror ledger, survives reset_timings(), and then routes:
    the report's ``cutoffs`` fills as the reference's does."""
    ldg, mirror = Ledger("t"), Ledger("mirror")
    saxpy = region("saxpy", ledger=ldg)(lambda x: x * 2.0 + 1.0)
    pol = AdaptivePolicy()
    sizes = (256, 1024, 4096)
    cut = pol.calibrate(saxpy, lambda n: (torch.ones(n),), sizes=sizes,
                        reps=2, ledger=mirror)
    assert cut in sizes or cut == max(sizes) + 1
    assert pol.cutoff == cut and set(pol.calibration) <= set(sizes)
    assert all(set(t) == {"host", "device"} for t in pol.calibration.values())
    ldg.reset_timings()
    assert ldg.coverage_report()["cutoffs"] == {"saxpy": cut}
    assert mirror.coverage_report()["cutoffs"] == {"saxpy": cut}
    ex = Executor(pol, ldg)
    ex.run(saxpy, torch.ones(max(cut // 2, 1)))
    ex.run(saxpy, torch.ones(2 * cut))
    rep = ldg.coverage_report()
    assert (rep["host_calls"], rep["device_calls"]) == (1, 1)
    jldg = JLedger("t")
    jsaxpy = j_region("saxpy", ledger=jldg)(lambda x: x * 2.0 + 1.0)
    JAdaptivePolicy().calibrate(jsaxpy, lambda n: (np.ones(n, np.float32),),
                                sizes=sizes, reps=2)
    assert set(jldg.coverage_report()) == set(rep)
    assert set(jldg.coverage_report()["cutoffs"]) == set(rep["cutoffs"])


def test_simple_calibration_ladder_is_amul_sized():
    """The app's ``Amul`` calibration builds operands whose region size is
    the ladder's size, and records the cutoff on the ``Amul`` row."""
    cfg = SimpleConfig(Grid(SHAPE, device="cpu"), **SETTINGS)
    pol = AdaptivePolicy(selector=TargetSelector())
    app = SimpleFoam(cfg, executor=Executor(pol))
    cut = app.calibrate_cutoff(pol, sizes=AMUL_LADDER[:2], reps=1)
    assert cut in AMUL_LADDER[:2] or cut == AMUL_LADDER[1] + 1
    assert app.ex.report()["cutoffs"] == {"Amul": cut}
    with pytest.raises(ValueError, match="cube"):
        app.calibrate_cutoff(pol, sizes=(100,), reps=1)


@pytest.mark.parametrize("name", ["host", "adaptive_high"])
def test_host_routed_calls_never_record_a_kernel_variant(name):
    _, _, app = _port_run(_port_policy(name))
    rep = app.ex.report()
    assert "hopper" not in rep["impl_counts"]
    assert rep["device_calls"] == 0 and rep["staging_s"] == 0.0


def test_kernel_variant_on_the_host_target_raises():
    from repro_torch.cfd.dia import AMUL
    with pytest.raises(ValueError, match="host target"):
        AMUL.executable("host", "hopper")
    assert AMUL.executable("host", "nonexistent")      # falls back to ref
    cfg = SimpleConfig(Grid(SHAPE, device="cpu"), **SETTINGS)
    app = SimpleFoam(cfg, executor=Executor(
        HostPolicy(selector=StaticSelector("hopper"))))
    with pytest.raises(ValueError, match="host target"):
        app.time_step(init_state(cfg))


def test_cli_all_policies_agree_on_the_cpu(capsys):
    rows = main(["--grid", "8", "--steps", "2", "--device", "cpu",
                 "--policy", "all"])
    assert [r["policy"] for r in rows] == ["host", "discrete", "unified",
                                           "adaptive"]
    assert len(capsys.readouterr().out.strip().splitlines()) == 4
    for r in rows:
        assert r["device"] == "cpu"
        for f, err in r["max_abs_err_vs_unified"].items():
            assert err <= 1e-5, (r["policy"], f, err)
    by = {r["policy"]: r for r in rows}
    assert by["host"]["device_calls"] == 0 and \
        by["host"]["impl_counts"].keys() == {"ref"}
    assert by["discrete"]["staging_fraction"] > 0
    assert by["adaptive"]["cutoff"] == DEFAULT_CUTOFF


@pytest.mark.parametrize("replay", ["sync", "async"])
def test_cli_replays_a_captured_step(replay):
    row = main(["--grid", "6", "--steps", "2", "--device", "cpu",
                "--policy", "discrete", "--replay", replay])
    assert row["replay"] == replay and row["overlap_fraction"] == 0.0
    assert row["staging_fraction"] > 0 and "res_u" not in row
    row = main(["--grid", "6", "--steps", "1", "--device", "cpu",
                "--policy", "adaptive", "--calibrate", "--replay", replay])
    assert row["cutoff"] in AMUL_LADDER or row["cutoff"] > AMUL_LADDER[-1]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("policy", ["discrete", "unified", "adaptive",
                                   "all"])
def test_cli_every_policy_but_host_needs_cuda(no_cuda, policy):
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--grid", "4", "--steps", "1", "--policy", policy])


def test_cli_host_runs_on_the_cpu_without_device_flag(no_cuda):
    row = main(["--grid", "4", "--steps", "1", "--policy", "host"])
    assert row["device"] == "cpu" and row["staging_fraction"] == 0.0


def test_simple_regions_build_grid_tensors_on_their_operands_device():
    """A region routed to the host runs on CPU copies of CUDA operands, so
    the regions that build grid tensors (masks, Laplacians, the red-black
    colouring) must build them beside their operands.  The meta device
    stands in here for the other side of the crossing."""
    from torch.utils._pytree import tree_leaves
    cfg = SimpleConfig(Grid(SHAPE, device="cpu"), **SETTINGS)
    app = SimpleFoam(cfg)

    def field():
        return torch.zeros(SHAPE, device="meta")

    outs = (app.assemble_momentum.fn(field(), field(), field(), field()),
            app.assemble_pressure.fn(field(), field(), field(), field()),
            app.factor.fn(field(), torch.zeros((6, *SHAPE), device="meta")),
            app.grad_p.fn(field()))
    assert {t.device.type for t in tree_leaves(outs)} == {"meta"}
    assert app.red.device.type == "cpu"
