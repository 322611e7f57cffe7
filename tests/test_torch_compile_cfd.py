"""Compiled regions of the CFD slice (``torch.compile``,
``fullgraph=True``) on the CPU at 8^3, held against their eager
executables and the JAX package's SIMPLE step on the same inputs, and
their recompiles over a PBiCGStab solve and a cutoff calibration.  (The
rest of the compiled-region tests is in tests/test_torch_compile.py; the
two files run apart, each compiling its own regions.)

Tolerances:
* a compiled region against its eager executable: ``rtol=3e-4,
  atol=1e-4`` (DESIGN §2's region tolerance; Inductor reorders and fuses
  float32 arithmetic);
* a compiled SIMPLE step against the JAX step: the step envelope
  ``1e-5 * max(1, max|field|)`` of ``tests/test_torch_step.py``.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd.grid import Grid as JGrid
from repro.cfd.simple import (SimpleConfig as JSimpleConfig,
                              SimpleFoam as JSimpleFoam,
                              init_state as j_init_state)
from repro_torch.cfd import fvm
from repro_torch.cfd.dia import DiaMatrix
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.precond import rb_dilu_factor
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
from repro_torch.cfd.solvers import make_solver_regions, pbicgstab_regions
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import (AdaptivePolicy, Executor,
                                      TargetSelector, UnifiedPolicy,
                                      disable_compile, region)

REGION_TOL = dict(rtol=3e-4, atol=1e-4)


def _rand(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


def _laplacian_system(n=6):
    A, _ = fvm.laplacian(Grid((n,) * 3, device="cpu"), 1.0)
    A = DiaMatrix(A.diag + 0.5, A.off)
    b = _rand(n, n, n, seed=5)
    red = Grid((n,) * 3, device="cpu").red_black_masks()[0]
    return A, b, red


def test_pbicgstab_regions_recompile_at_most_twice_and_never_after_warmup():
    A, b, red = _laplacian_system()
    regions = make_solver_regions(Ledger("solve"))
    ex = Executor(UnifiedPolicy(selector=TargetSelector("hopper")))
    P = rb_dilu_factor(A, red)
    kw = dict(tol=1e-7, max_iter=6)
    warm = pbicgstab_regions(ex, regions, A, b, torch.zeros_like(b), P, **kw)
    assert warm.iters >= 3

    def compiles():
        return {(r.name, k): s.compiles for r in
                (regions.amul, regions.precond, regions.saxpy,
                 regions.update_x, regions.update_p, regions.dot,
                 regions.summag) for k, s in r.compile_stats.items()}

    after_warmup = compiles()
    assert after_warmup and max(after_warmup.values()) <= 2
    res = pbicgstab_regions(ex, regions, A, b * 1.7, b * 0.1, P, **kw)
    assert compiles() == after_warmup
    with disable_compile():
        eager = pbicgstab_regions(ex, regions, A, b * 1.7, b * 0.1, P, **kw)
    assert res.iters == eager.iters
    torch.testing.assert_close(res.x, eager.x, **REGION_TOL)


def test_adaptive_calibration_compiles_only_in_its_warmups():
    """Every compile at a size (the first, the dynamic-shape recompile at
    the second) lands in that size's warm-up call: calling each timed
    executable again compiles nothing."""
    r = region("cal", ledger=Ledger("cal"))(lambda x: x * 2.0 + 1.0)
    pol = AdaptivePolicy()
    sizes = (256, 1024, 4096)
    pol.calibrate(r, lambda n: (torch.ones(n),), sizes=sizes, reps=2)
    before = {k: s.compiles for k, s in r.compile_stats.items()}
    assert set(before) == {("host", "ref", False), ("device", "ref", False)}
    assert all(c <= 2 for c in before.values())
    for n in sizes[:len(pol.calibration)]:
        r.executable("host", donate=False)(torch.ones(n))
        r.executable("device", donate=False)(torch.ones(n))
    assert {k: s.compiles for k, s in r.compile_stats.items()} == before


# ---------------------------------------------------------------------------
# The SIMPLE step: each region compiled against its eager executable, and
# the compiled step against the JAX step
# ---------------------------------------------------------------------------

SHAPE = (8, 8, 8)
SETTINGS = dict(nu=0.1, inner_max=5, tol_u=0.0, tol_p=0.0)


@pytest.fixture(scope="module")
def cfd():
    """An app (hopper variants: the kernels' plain versions on the CPU)
    and the first call's arguments of every region in one eager step."""
    cfg = SimpleConfig(Grid(SHAPE, device="cpu"), **SETTINGS)
    app = SimpleFoam(cfg, executor=Executor(
        UnifiedPolicy(selector=TargetSelector("hopper"))))
    calls = {}

    def tap(r, *args, **kwargs):
        calls.setdefault(r.name.split("#")[0], (r, args, kwargs))
        return app.ex.run(r, *args, **kwargs)

    st = init_state(cfg)
    with disable_compile():
        st, _ = app.time_step(st)              # a nonzero state
        app.time_step(st, executor=types.SimpleNamespace(run=tap))
    return app, st, calls


CFD_REGIONS = ["assemble(momentum)", "assemble(pressure)", "DILU factor",
               "rAU=1/A", "momentum corrector", "grad(p)", "p relax", "Amul",
               "precondition(DILU)", "sA=rA-alpha*AyA", "x+=a*yA+w*zA",
               "p=r+beta*(p-w*v)", "dot", "sumMag"]


@pytest.mark.parametrize("name", CFD_REGIONS)
def test_cfd_region_compiled_matches_eager(cfd, name):
    app, _, calls = cfd
    r, args, kwargs = calls[name]
    impl = app.ex.policy.selector.select(r, "default", args, kwargs)
    got = r.executable("default", impl)(*args, **kwargs)
    with disable_compile():
        want = r.executable("default", impl)(*args, **kwargs)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(g, w, **REGION_TOL)
    assert max(s.compiles for s in r.compile_stats.values()) == 1


def test_compiled_step_matches_jax_step(cfd):
    """The whole step through the compiled executables (the regions above,
    compiled once more only where a scalar or an aliasing changes) against
    the reference's unified step from the same state."""
    app, st, _ = cfd
    new, _ = app.time_step(st)
    jcfg = JSimpleConfig(JGrid(SHAPE), **SETTINGS)
    japp = JSimpleFoam(jcfg)
    jst = j_init_state(jcfg)
    jst = dataclasses.replace(jst, **{f: jnp.asarray(getattr(st, f).numpy())
                                      for f in "uvwp"})
    jnew, _ = japp.time_step(jst)
    for f in "uvwp":
        want = np.asarray(getattr(jnew, f))
        err = np.abs(getattr(new, f).numpy() - want).max()
        assert err <= 1e-5 * max(1.0, np.abs(want).max()), (f, err)
    for r in app.solver_regions.amul, app.assemble_momentum:
        assert all(s.compiles <= 2 for s in r.compile_stats.values())
