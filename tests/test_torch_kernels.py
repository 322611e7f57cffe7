"""Each ``hopper`` kernel wrapper of the port, called with CPU tensors (so
it runs its plain version), held against the JAX package's Pallas kernel
in interpret mode on the same numpy inputs; plus the wrappers' input
checks and the variant contract.

Tolerances are those of tests/test_kernels.py: 3e-4/1e-4 for the stencil
kernels, 1e-5/1e-6 (f32) and 2e-2/1e-2 (bf16) for the field macros.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import fvm as jfvm
from repro.cfd.grid import Grid as JGrid
from repro.cfd.precond import rb_dilu_factor as j_rb_dilu_factor
from repro.kernels.fused_field import kernel as JF
from repro.kernels.stencil_spmv import kernel as JS
from repro_torch.kernels import check_ref_variants, variant_tables
from repro_torch.kernels.fused_field import kernel as FK
from repro_torch.kernels.stencil_spmv import kernel as SK


def _stencil_inputs(shape, seed):
    g = JGrid(shape)
    A, _ = jfvm.laplacian(g, 1.0)
    red, _ = g.red_black_masks()
    P = j_rb_dilu_factor(A, red)
    r = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return (np.array(A.diag), np.array(A.off), np.array(P.rdiag),
            np.array(red), r)


@pytest.mark.parametrize("shape", [(8, 6, 10), (5, 7, 3), (6, 4, 12)])
@pytest.mark.parametrize("kernel", ["stencil_spmv", "rb_dilu_forward",
                                    "rb_dilu_backward", "rb_dilu"])
def test_stencil_wrapper_matches_pallas(kernel, shape):
    diag, off, rdiag, red, r = _stencil_inputs(shape, seed=len(kernel))
    j, t = jnp.asarray, torch.from_numpy
    if kernel == "stencil_spmv":
        want = JS.stencil_spmv(j(diag), j(off), j(r))
        got = SK.stencil_spmv(t(diag), t(off), t(r))
    else:
        want = getattr(JS, kernel)(j(rdiag), j(red), j(off), j(r))
        got = getattr(SK, kernel)(t(rdiag), t(red), t(off), t(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=1e-4)


FIELD_OPS = {
    "fused_axpy": (2.5, "x", "y"),
    "fused_xpay": (-1.25, "x", "y"),
    "fused_mul": ("x", "y"),
    "fused_axpbypz": (2.0, "x", -0.5, "y", "z"),
}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(33,), (17, 5, 9), (64 * 128 + 3,)])
@pytest.mark.parametrize("op", list(FIELD_OPS))
def test_field_wrapper_matches_pallas(op, shape, dt):
    rng = np.random.RandomState(len(op) + len(shape))
    arrays = {k: rng.rand(*shape).astype(np.float32) for k in "xyz"}
    jargs = [jnp.asarray(arrays[a], dt) if isinstance(a, str) else a
             for a in FIELD_OPS[op]]
    targs = [torch.from_numpy(arrays[a]).to(getattr(torch, dt))
             if isinstance(a, str) else a for a in FIELD_OPS[op]]
    want = np.asarray(getattr(JF, op)(*jargs), np.float32)
    got = getattr(FK, op)(*targs).float().numpy()
    assert got.shape == want.shape
    tol = dict(rtol=2e-2, atol=1e-2) if dt == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)


def _fields(shape=(4, 3, 5)):
    return torch.rand(shape), torch.rand(6, *shape), torch.rand(shape)


@pytest.mark.parametrize("bad", ["dtype", "shape", "off_shape", "contiguity",
                                 "red_dtype"])
def test_stencil_wrappers_reject_bad_operands(bad):
    diag, off, x = _fields()
    red = torch.zeros(diag.shape, dtype=torch.bool)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        x = torch.rand(4, 3, 6)
    elif bad == "off_shape":
        off = off[:5]
    elif bad == "contiguity":
        x = torch.rand(5, 3, 4).permute(2, 1, 0)
    else:
        red = red.float()
    with pytest.raises((TypeError, ValueError)):
        if bad == "red_dtype":
            SK.rb_dilu_forward(diag, red, off, x)
        else:
            SK.stencil_spmv(diag, off, x)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape",
                                 "contiguity"])
def test_field_wrappers_reject_bad_operands(bad):
    x, y = torch.rand(8, 4), torch.rand(8, 4)
    if bad == "dtype":
        x, y = x.double(), y.double()
    elif bad == "mixed_dtype":
        y = y.bfloat16()
    elif bad == "shape":
        y = torch.rand(4, 8)
    else:
        x, y = x.t(), y.t()
    with pytest.raises((TypeError, ValueError)):
        FK.fused_axpy(1.0, x, y)


def test_cpu_calls_do_not_count_as_launches():
    before = {**SK.LAUNCHES, **FK.LAUNCHES}
    diag, off, x = _fields()
    SK.stencil_spmv(diag, off, x)
    FK.fused_axpy(1.0, x, x)
    assert {**SK.LAUNCHES, **FK.LAUNCHES} == before


def test_variant_contract():
    assert check_ref_variants() == {"stencil_spmv": 2, "fused_field": 4,
                                    "rwkv6_scan": 1}
    for ops in variant_tables().values():
        for table in ops.values():
            assert set(table) == {"ref", "hopper"}
