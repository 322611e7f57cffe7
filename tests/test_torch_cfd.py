"""The port's CFD operators held against the JAX package on the same numpy
inputs, plus the dense-algebra oracles of tests/test_cfd.py on the port.

Tolerance: rtol=3e-4, atol=1e-4 (docs/DESIGN.md §2, a variant against
``ref``); both sides compute in float32 with the same operation order, so
the observed differences are at rounding level.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import dia as jdia, fvc as jfvc, fvm as jfvm
from repro.cfd import grid as jgrid, precond as jprecond
from repro.cfd.simple import SimpleState as JSimpleState
from repro_torch.cfd import dia, fvc, fvm, grid as tgrid, precond
from repro_torch.cfd.convert import from_numpy
from repro_torch.cfd.simple import (SimpleConfig, SimpleFoam, SimpleState,
                                    init_state)
from repro_torch.core.regions import disable_compile


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


GRIDS = [(4, 3, 5), (6, 6, 6), (8, 8, 8)]
TOL = dict(rtol=3e-4, atol=1e-4)


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        x=r.rand(*shape).astype(f32),
        diag=(r.rand(*shape) + 6.0).astype(f32),
        off=(-r.rand(6, *shape)).astype(f32),
        phi=r.randn(6, *shape).astype(f32),
        u=r.randn(*shape).astype(f32), v=r.randn(*shape).astype(f32),
        w=r.randn(*shape).astype(f32), p=r.randn(*shape).astype(f32),
        red=np.asarray(jgrid.Grid(shape).red_black_masks()[0]),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(out):
    """Flatten an operator's result (tensor / jax array / DiaMatrix /
    tuples of them) to a list of float64 numpy arrays."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _np(o)]
    if hasattr(out, "diag") and hasattr(out, "off"):
        return _np((out.diag, out.off))
    if isinstance(out, torch.Tensor):
        return [out.double().numpy()]
    return [np.asarray(out, np.float64)]


def _case_shift(g, tg, d):
    return ([jgrid.shift(jnp.asarray(d["x"]), ax, s) for ax, s in
             jgrid.NEIGHBORS],
            [tgrid.shift(_t(d["x"]), ax, s) for ax, s in tgrid.NEIGHBORS])


def _case_amul(g, tg, d):
    return (jdia.amul_ref(jdia.DiaMatrix(jnp.asarray(d["diag"]),
                                         jnp.asarray(d["off"])),
                          jnp.asarray(d["x"])),
            dia.amul_ref(dia.DiaMatrix(_t(d["diag"]), _t(d["off"])),
                         _t(d["x"])))


def _case_factor(g, tg, d):
    return (jprecond.rb_dilu_factor(
                jdia.DiaMatrix(jnp.asarray(d["diag"]), jnp.asarray(d["off"])),
                jnp.asarray(d["red"])).rdiag,
            precond.rb_dilu_factor(dia.DiaMatrix(_t(d["diag"]), _t(d["off"])),
                                   _t(d["red"])).rdiag)


def _case_rb_dilu(g, tg, d):
    rdiag = 1.0 / d["diag"]
    return (jprecond._rb_dilu_ref(jnp.asarray(rdiag), jnp.asarray(d["red"]),
                                  jnp.asarray(d["off"]), jnp.asarray(d["x"])),
            precond._rb_dilu_ref(_t(rdiag), _t(d["red"]), _t(d["off"]),
                                 _t(d["x"])))


def _case_laplacian(g, tg, d):
    bcs = [True, False, True, True, False, True]
    return (jfvm.laplacian(g, 0.7, dirichlet=bcs),
            fvm.laplacian(tg, 0.7, dirichlet=bcs))


def _case_div_upwind(g, tg, d):
    return (jfvm.div_upwind(g, jnp.asarray(d["phi"])),
            fvm.div_upwind(tg, _t(d["phi"])))


def _case_face_fluxes(g, tg, d):
    return (jfvm.face_fluxes(g, *(jnp.asarray(d[k]) for k in "uvw")),
            fvm.face_fluxes(tg, *(_t(d[k]) for k in "uvw")))


def _case_relax(g, tg, d):
    return (jfvm.relax(jdia.DiaMatrix(jnp.asarray(d["diag"]),
                                      jnp.asarray(d["off"])),
                       jnp.asarray(d["x"]), jnp.asarray(d["u"]), 0.7),
            fvm.relax(dia.DiaMatrix(_t(d["diag"]), _t(d["off"])),
                      _t(d["x"]), _t(d["u"]), 0.7))


def _case_grad(g, tg, d):
    return jfvc.grad(g, jnp.asarray(d["p"])), fvc.grad(tg, _t(d["p"]))


def _case_div_flux(g, tg, d):
    return (jfvc.div_flux(g, jnp.asarray(d["phi"])),
            fvc.div_flux(tg, _t(d["phi"])))


CASES = {"shift": _case_shift, "amul_ref": _case_amul,
         "rb_dilu_factor": _case_factor, "_rb_dilu_ref": _case_rb_dilu,
         "fvm.laplacian": _case_laplacian, "fvm.div_upwind": _case_div_upwind,
         "fvm.face_fluxes": _case_face_fluxes, "fvm.relax": _case_relax,
         "fvc.grad": _case_grad, "fvc.div_flux": _case_div_flux}


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("op", list(CASES))
def test_operator_matches_jax(op, shape):
    want, got = CASES[op](jgrid.Grid(shape), tgrid.Grid(shape, device="cpu"),
                          _inputs(shape, seed=len(op)))
    want, got = _np(want), _np(got)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **TOL)


# -- the dense oracles of tests/test_cfd.py, on the port --------------------

def test_amul_matches_dense():
    g = tgrid.Grid((4, 3, 5), device="cpu")
    A, _ = fvm.laplacian(g, 2.0)
    x = torch.from_numpy(np.random.RandomState(1).rand(*g.shape)
                         .astype(np.float32))
    y = dia.amul_ref(A, x)
    yd = (dia.to_dense(A) @ x.double().numpy().ravel()).reshape(g.shape)
    np.testing.assert_allclose(y.numpy(), yd, rtol=1e-4, atol=1e-4)


def test_laplacian_spd():
    A, _ = fvm.laplacian(tgrid.Grid((4, 4, 4), device="cpu"), 1.0)
    M = dia.to_dense(A)
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    assert np.linalg.eigvalsh(M).min() > 0


def test_transpose_matches_dense():
    g = tgrid.Grid((3, 4, 2), device="cpu")
    phi = torch.from_numpy(np.random.RandomState(2).randn(6, *g.shape)
                           .astype(np.float32))
    A = fvm.div_upwind(g, phi)
    np.testing.assert_allclose(dia.to_dense(A.transpose()),
                               dia.to_dense(A).T, atol=1e-5)


def test_to_dense_matches_jax():
    d = _inputs((3, 4, 2), seed=3)
    want = jdia.to_dense(jdia.DiaMatrix(jnp.asarray(d["diag"]),
                                        jnp.asarray(d["off"])))
    got = dia.to_dense(dia.DiaMatrix(_t(d["diag"]), _t(d["off"])))
    np.testing.assert_array_equal(got, want)


def test_rb_dilu_is_exact_inverse_of_its_M():
    """M^-1 applied by the half-sweeps inverts M = (L+D*)D*^-1(D*+U)."""
    g = tgrid.Grid((4, 4, 2), device="cpu")
    A, _ = fvm.laplacian(g, 1.0)
    red, _ = g.red_black_masks()
    P = precond.rb_dilu_factor(A, red)
    r = torch.from_numpy(np.random.RandomState(4).rand(*g.shape)
                         .astype(np.float32))
    w = precond.rb_dilu_apply(P, A, r)
    N = g.n
    M = dia.to_dense(A)
    redv = red.numpy().ravel()
    dstar = np.where(redv, A.diag.numpy().ravel(),
                     1.0 / P.rdiag.numpy().ravel())
    Lm = np.zeros((N, N))
    Um = np.zeros((N, N))
    for i in range(N):
        for j in range(N):
            if i == j or M[i, j] == 0:
                continue
            if redv[j] and not redv[i]:
                Lm[i, j] = M[i, j]
            elif redv[i] and not redv[j]:
                Um[i, j] = M[i, j]
    Mfull = (Lm + np.diag(dstar)) @ np.diag(1.0 / dstar) @ (np.diag(dstar) + Um)
    w2 = np.linalg.solve(Mfull, r.double().numpy().ravel())
    np.testing.assert_allclose(w.numpy().ravel(), w2, rtol=2e-3, atol=2e-4)


def test_dilu_seq_ref_matches_jax():
    d = _inputs((3, 3, 4), seed=5)
    want = jprecond.dilu_seq_ref(
        jdia.DiaMatrix(jnp.asarray(d["diag"]), jnp.asarray(d["off"])),
        jnp.asarray(d["x"]))
    got = precond.dilu_seq_ref(dia.DiaMatrix(_t(d["diag"]), _t(d["off"])),
                               _t(d["x"]))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_from_numpy_converts_jax_state():
    d = _inputs((4, 3, 5), seed=6)
    jA = jdia.DiaMatrix(jnp.asarray(d["diag"]), jnp.asarray(d["off"]))
    jP = jprecond.RBDilu(jnp.asarray(d["x"]), jnp.asarray(d["red"]))
    jS = JSimpleState(*(jnp.asarray(d[k]) for k in "uvwp"), step=3)
    A, P, S = from_numpy((jA, jP, jS), device="cpu")
    assert isinstance(A, dia.DiaMatrix) and isinstance(P, precond.RBDilu)
    assert isinstance(S, SimpleState) and S.step == 3
    assert P.red.dtype == torch.bool and A.off.dtype == torch.float32
    np.testing.assert_array_equal(A.off.numpy(), d["off"])
    np.testing.assert_array_equal(P.red.numpy(), d["red"])
    np.testing.assert_array_equal(S.p.numpy(), d["p"])


def test_simple_foam_converges():
    """tests/test_cfd.py::test_simple_foam_converges on the port."""
    cfg = SimpleConfig(grid=tgrid.Grid((10, 10, 10), device="cpu"), nu=0.1,
                       inner_max=40)
    app = SimpleFoam(cfg)
    st = init_state(cfg)

    def div_inf(s):
        return fvc.div_flux(cfg.grid, fvm.face_fluxes(
            cfg.grid, s.u, s.v, s.w)).abs().max().item()

    st, _, _ = app.run_steps(st, 3)
    d1 = div_inf(st)
    st, _, _ = app.run_steps(st, 7)
    d2 = div_inf(st)
    assert torch.isfinite(st.u).all() and torch.isfinite(st.p).all()
    assert st.u.abs().max().item() < 2.0 * cfg.lid_velocity
    assert st.u.abs().max().item() > 0.05
    assert d2 < d1
