"""The whole slice: two SIMPLE time-steps of the port on an 8^3 cavity held
against the JAX package's ``SimpleFoam.time_step`` under ``UnifiedPolicy``
(the reference's only policy that runs the full step on this jax).

Both sides run ``nu=0.1, inner_max=5, tol_u=tol_p=0``, so both take the
same number of solver iterations, and each field must agree within the
step envelope of docs/DESIGN.md §2: |err| <= 1e-5 * max(1, max|field|).
Observed: |err| <= 1.8e-7 (reduction order differs between the two
frameworks; nothing else does).
"""
import numpy as np
import pytest

from repro.cfd.grid import Grid as JGrid
from repro.cfd.simple import (SimpleConfig as JSimpleConfig,
                              SimpleFoam as JSimpleFoam,
                              init_state as j_init_state)
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
from repro_torch.core.regions import (DiscretePolicy, Executor, StaticSelector,
                                      UnifiedPolicy, disable_compile)


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


@pytest.fixture(scope="module")
def jax_steps():
    cfg = JSimpleConfig(JGrid(SHAPE), **SETTINGS)
    app = JSimpleFoam(cfg)
    st = j_init_state(cfg)
    for _ in range(STEPS):
        st, m = app.time_step(st)
    return {f: np.asarray(getattr(st, f)) for f in "uvwp"}, m


def _port_steps(policy):
    cfg = SimpleConfig(Grid(SHAPE, device="cpu"), **SETTINGS)
    app = SimpleFoam(cfg, executor=Executor(policy))
    st = init_state(cfg)
    for _ in range(STEPS):
        st, m = app.time_step(st)
    return {f: getattr(st, f).numpy() for f in "uvwp"}, m, app.ex.report()


@pytest.mark.parametrize("policy,impl", [("unified", "ref"),
                                         ("unified", "hopper"),
                                         ("discrete", "hopper")])
def test_time_steps_match_jax(jax_steps, policy, impl):
    pol = UnifiedPolicy(selector=StaticSelector(impl)) if policy == "unified" \
        else DiscretePolicy(selector=StaticSelector(impl), device="cpu")
    got, m, rep = _port_steps(pol)
    want, jm = jax_steps
    assert (m["iters_u"], m["iters_p"]) == (jm["iters_u"], jm["iters_p"])
    for f in "uvwp":
        assert np.isfinite(got[f]).all()
        allowed = 1e-5 * max(1.0, float(np.abs(want[f]).max()))
        err = float(np.abs(got[f] - want[f]).max())
        assert err <= allowed, (f, err, allowed)
    assert rep["impl_counts"].get(impl, 0) > 0
    assert (rep["staging_fraction"] > 0) == (policy == "discrete")
