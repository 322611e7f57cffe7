"""The port's fused PBiCGStab (``solve`` / ``pbicgstab_fused``) and Jacobi
preconditioner held against the JAX package's on the same numpy systems.

Tolerance: equal iteration counts and ``x`` within rtol=3e-4, atol=1e-4
(docs/DESIGN.md §2, as ``test_pbicgstab_regions_matches_jax_unified``
holds the region-wise solver).  Both sides run the same float32 recurrence
with float32 reductions; only the reductions' summation order differs.

Convection-diffusion with Jacobi is held iteration by iteration
(``test_trajectory_matches_jax``) rather than at convergence: at its 17th
iteration the residual reads 9.40e-7 on the reference and 1.0004e-6 on the
port, both against tol=1e-6, while ``x`` agrees to 9e-8, so summation
order alone decides whether it stops there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import dia as jdia, fvm as jfvm, precond as jprecond
from repro.cfd import solvers as jsolvers
from repro.cfd.grid import Grid as JGrid
from repro_torch.cfd import fvm, precond
from repro_torch.cfd.dia import DiaMatrix
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.precond import rb_dilu_factor
from repro_torch.cfd.solvers import (make_solver_regions, pbicgstab_fused,
                                     pbicgstab_regions, solve)
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import (Executor, TargetSelector, UnifiedPolicy,
                                      disable_compile)
from repro_torch.kernels.stencil_spmv import ref as stencil_ref


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


TOL = dict(rtol=3e-4, atol=1e-4)


def _laplacian(shape, seed):
    """The SPD pressure-type Laplacian with Dirichlet walls."""
    A, _ = jfvm.laplacian(JGrid(shape), 1.0)
    b = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return np.asarray(A.diag), np.asarray(A.off), b


def _convection_diffusion(shape, seed):
    """A non-symmetric momentum-type matrix: upwind convection of a random
    flux field plus diffusion."""
    g = JGrid(shape)
    r = np.random.RandomState(seed)
    vel = [jnp.asarray(r.randn(*shape).astype(np.float32)) for _ in range(3)]
    conv = jfvm.div_upwind(g, jfvm.face_fluxes(g, *vel))
    diff, _ = jfvm.laplacian(g, 0.1, dirichlet=[True] * 6)
    b = r.rand(*shape).astype(np.float32)
    return (np.asarray(conv.diag + diff.diag), np.asarray(conv.off + diff.off),
            b)


SYSTEMS = {"laplacian_8": lambda: _laplacian((8, 8, 8), 0),
           "laplacian_6x7x5": lambda: _laplacian((6, 7, 5), 1),
           "convdiff_8": lambda: _convection_diffusion((8, 8, 8), 2)}


def _both(system):
    diag, off, b = SYSTEMS[system]()
    shape = diag.shape
    jred = JGrid(shape).red_black_masks()[0]
    red = Grid(shape, device="cpu").red_black_masks()[0]
    jA = jdia.DiaMatrix(jnp.asarray(diag), jnp.asarray(off))
    A = DiaMatrix(torch.from_numpy(diag), torch.from_numpy(off))
    return (jA, jnp.asarray(b), jred), (A, torch.from_numpy(b), red)


@pytest.mark.parametrize("system,use_dilu", [
    ("laplacian_8", True), ("laplacian_8", False),
    ("laplacian_6x7x5", True), ("laplacian_6x7x5", False),
    ("convdiff_8", True)])
def test_solve_matches_jax(system, use_dilu):
    (jA, jb, jred), (A, b, red) = _both(system)
    want = jsolvers.solve(jA, jb, jnp.zeros_like(jb), jred, tol=1e-6,
                          max_iter=500, use_dilu=use_dilu)
    got = solve(A, b, torch.zeros_like(b), red, tol=1e-6, max_iter=500,
                use_dilu=use_dilu)
    assert got.converged and want.converged
    assert got.iters == want.iters > 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.initial_residual, want.initial_residual,
                               rtol=1e-5)
    assert got.x.dtype == torch.float32


@pytest.mark.parametrize("max_iter,use_dilu", [
    (0, True), (1, True), (3, True), (10, True),
    (0, False), (1, False), (3, False), (10, False), (17, False)])
def test_trajectory_matches_jax(max_iter, use_dilu):
    """Convection-diffusion stopped at a fixed iteration count (below the
    16 that DILU takes to reach 1e-12): the same ``x`` after every count,
    and residuals that agree while they are far above rounding (within 1 %
    up to 10 iterations)."""
    (jA, jb, jred), (A, b, red) = _both("convdiff_8")
    want = jsolvers.solve(jA, jb, jnp.zeros_like(jb), jred, tol=1e-12,
                          max_iter=max_iter, use_dilu=use_dilu)
    got = solve(A, b, torch.zeros_like(b), red, tol=1e-12, max_iter=max_iter,
                use_dilu=use_dilu)
    assert got.iters == want.iters == max_iter
    assert not got.converged
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **TOL)
    if max_iter <= 10:
        np.testing.assert_allclose(got.final_residual, want.final_residual,
                                   rtol=1e-2)


def test_jacobi_apply_matches_jax():
    diag, off, b = _laplacian((5, 4, 3), 3)
    diag = diag.copy()
    diag[0, 0, 0] = 0.0                          # a zero diagonal is taken as 1
    want = jprecond.jacobi_apply(jdia.DiaMatrix(jnp.asarray(diag),
                                                jnp.asarray(off)),
                                 jnp.asarray(b))
    got = precond.jacobi_apply(DiaMatrix(torch.from_numpy(diag),
                                         torch.from_numpy(off)),
                               torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    assert got[0, 0, 0] == torch.from_numpy(b)[0, 0, 0]


@pytest.mark.parametrize("system", ["laplacian_8", "convdiff_8"])
def test_fused_equals_region_wise_solver(system):
    """The same iteration two ways on the port: one torch loop and one
    region per operation, through the kernel wrappers on both sides."""
    _, (A, b, red) = _both(system)
    P = rb_dilu_factor(A, red)
    ldg = Ledger("t")
    want = pbicgstab_regions(Executor(UnifiedPolicy(selector=TargetSelector()),
                                      ldg), make_solver_regions(ldg), A, b,
                             torch.zeros_like(b), P, tol=1e-6, max_iter=500)
    x, it, res0, res = pbicgstab_fused(A, b, torch.zeros_like(b), P.rdiag,
                                       P.red, tol=1e-6, max_iter=500)
    assert it == want.iters
    np.testing.assert_allclose(x.numpy(), want.x.numpy(), **TOL)
    assert float(res) <= 1e-6 and res0.dtype == res.dtype == torch.float32


def test_fused_solver_keeps_no_ledger_and_takes_the_wrappers(monkeypatch):
    """No region runs, and A and DILU go through the stencil kernel's
    wrappers (here, on CPU tensors, their plain versions)."""
    calls = {"stencil_spmv": 0, "rb_dilu_forward": 0, "rb_dilu_backward": 0}
    for name in calls:
        fn = getattr(stencil_ref, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(stencil_ref, name, counted)
    _, (A, b, red) = _both("laplacian_8")
    r = solve(A, b, torch.zeros_like(b), red, tol=1e-6, max_iter=500)
    assert calls["stencil_spmv"] == 1 + 2 * r.iters
    assert calls["rb_dilu_forward"] == calls["rb_dilu_backward"] == \
        2 * r.iters
    calls.update(dict.fromkeys(calls, 0))
    r = solve(A, b, torch.zeros_like(b), red, tol=1e-6, max_iter=500,
              use_dilu=False)
    assert calls["rb_dilu_forward"] == 0
    assert calls["stencil_spmv"] == 1 + 2 * r.iters


@pytest.fixture(scope="module")
def pressure_system():
    """The pressure system of the fourth SIMPLE step on a 12^3 cavity (the
    pinned, nearly singular Laplacian that ``[fused]`` of chip_smoke.py
    solves at 200^3)."""
    import types
    from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
    cfg = SimpleConfig(Grid((12, 12, 12), device="cpu"), nu=0.1,
                       inner_max=25)
    app = SimpleFoam(cfg)
    st, _, _ = app.run_steps(init_state(cfg), 3)
    taps = {}

    def tap(r, *args, **kwargs):
        out = app.ex.run(r, *args, **kwargs)
        if r is app.assemble_pressure:
            taps["pressure"] = out
        return out

    app.time_step(st, executor=types.SimpleNamespace(run=tap))
    return [t.numpy() for t in taps["pressure"]]


@pytest.mark.parametrize("max_iter", [3, 10])
def test_pressure_system_solvers_agree_with_jax(pressure_system, max_iter):
    """Port and reference, fused and region-wise: the same ``x`` on the
    step's pressure system for the first iterations.  (Past ~10 iterations
    PBiCGStab parts on this system by O(max|x|) between any two of them,
    so ``[fused]`` holds the fused solve to the region-wise one at 3.)"""
    from repro.cfd.precond import rb_dilu_factor as j_rb_dilu_factor
    from repro.core.ledger import Ledger as JLedger
    from repro.core.regions import (Executor as JExecutor,
                                    UnifiedPolicy as JUnifiedPolicy)
    diag, off, rhs = pressure_system
    shape = diag.shape
    jred = JGrid(shape).red_black_masks()[0]
    red = Grid(shape, device="cpu").red_black_masks()[0]
    jA = jdia.DiaMatrix(jnp.asarray(diag), jnp.asarray(off))
    A = DiaMatrix(torch.from_numpy(diag), torch.from_numpy(off))
    jb, b = jnp.asarray(rhs), torch.from_numpy(rhs)
    jl, ldg = JLedger("t"), Ledger("t")
    xs = {
        "jax_fused": jsolvers.solve(jA, jb, jnp.zeros_like(jb), jred,
                                    max_iter=max_iter).x,
        "jax_regions": jsolvers.pbicgstab_regions(
            JExecutor(JUnifiedPolicy(), jl), jsolvers.make_solver_regions(jl),
            jA, jb, jnp.zeros_like(jb), j_rb_dilu_factor(jA, jred),
            max_iter=max_iter).x,
        "fused": solve(A, b, torch.zeros_like(b), red, max_iter=max_iter).x,
        "regions": pbicgstab_regions(
            Executor(UnifiedPolicy(selector=TargetSelector()), ldg),
            make_solver_regions(ldg), A, b, torch.zeros_like(b),
            rb_dilu_factor(A, red), max_iter=max_iter).x}
    want = np.asarray(xs.pop("jax_fused"))
    for name, x in xs.items():
        np.testing.assert_allclose(np.asarray(x), want, **TOL, err_msg=name)
