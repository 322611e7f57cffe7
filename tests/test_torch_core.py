"""The port's spine (pools, ledger, policies, executor) and its region-wise
PBiCGStab, held against the JAX package where the two should agree."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import fvm as jfvm
from repro.cfd.grid import Grid as JGrid
from repro.cfd.precond import rb_dilu_factor as j_rb_dilu_factor
from repro.cfd.solvers import (make_solver_regions as j_make_solver_regions,
                               pbicgstab_regions as j_pbicgstab_regions)
from repro.core.ledger import Ledger as JLedger
from repro.core.regions import (DiscretePolicy as JDiscretePolicy,
                                Executor as JExecutor,
                                TargetSelector as JTargetSelector,
                                UnifiedPolicy as JUnifiedPolicy)
from repro_torch.cfd import fvm
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.precond import rb_dilu_factor
from repro_torch.cfd.solvers import make_solver_regions, pbicgstab_regions
from repro_torch.core.ledger import Ledger
from repro_torch.core.pool import DeviceBufferPool, HostStagingPool
from repro_torch.core.regions import (DiscretePolicy, Executor, StaticSelector,
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


def _system(shape, seed=0):
    g = Grid(shape, device="cpu")
    A, _ = fvm.laplacian(g, 1.0)
    red, _ = g.red_black_masks()
    b = torch.from_numpy(np.random.RandomState(seed).rand(*shape)
                         .astype(np.float32))
    return A, b, rb_dilu_factor(A, red)


def _solve(policy, shape=(6, 6, 6), tol=1e-6, max_iter=500):
    A, b, P = _system(shape)
    ldg = Ledger("t")
    ex = Executor(policy, ldg)
    r = pbicgstab_regions(ex, make_solver_regions(ldg), A, b,
                          torch.zeros_like(b), P, tol=tol, max_iter=max_iter)
    return r, ex


def _jax_solve(policy, shape=(6, 6, 6), tol=1e-6, max_iter=500):
    g = JGrid(shape)
    A, _ = jfvm.laplacian(g, 1.0)
    red, _ = g.red_black_masks()
    b = jnp.asarray(np.random.RandomState(0).rand(*shape).astype(np.float32))
    ldg = JLedger("t")
    ex = JExecutor(policy, ldg)
    r = j_pbicgstab_regions(ex, j_make_solver_regions(ldg), A, b,
                            jnp.zeros_like(b), j_rb_dilu_factor(A, red),
                            tol=tol, max_iter=max_iter)
    return r, ex


# -- pools --------------------------------------------------------------

def test_host_pool_byte_accounting():
    pool = HostStagingPool()
    a = pool.acquire((100, 100), torch.float32)         # 40 KB -> 64 KiB class
    assert pool.stats.misses == 1 and pool.stats.bytes_allocated == 65536
    assert pool.stats.bytes_in_use == 65536
    pool.release(a)
    assert pool.stats.bytes_in_use == 0 and pool.free_bytes == 65536
    b = pool.acquire((120, 100), torch.float32)         # same class: a hit
    assert pool.stats.hits == 1 and pool.stats.bytes_reused == 48000
    assert b.shape == (120, 100) and b.dtype == torch.float32
    assert pool.stats.high_water_bytes == 65536
    small = pool.acquire((10,), torch.float32)           # below 5K elements
    assert pool.stats.unpooled == 1 and not hasattr(small, "_pool_raw")


def test_device_pool_reuses_by_shape_and_dtype():
    pool = DeviceBufferPool(device="cpu")
    a = pool.acquire((80, 80), torch.float32)
    pool.release(a)
    assert pool.free_bytes == 80 * 80 * 4
    assert pool.acquire((80, 80), torch.float32) is a
    assert pool.acquire((80, 80), torch.float64) is not a
    assert pool.stats.hits == 1 and pool.stats.misses == 2


# -- ledger / report schema ----------------------------------------------

@pytest.mark.parametrize("policy", ["unified", "discrete"])
def test_coverage_report_keys_equal_jax(policy):
    _, ex = _solve(UnifiedPolicy() if policy == "unified"
                   else DiscretePolicy(device="cpu"), max_iter=2)
    _, jex = _jax_solve(JUnifiedPolicy() if policy == "unified"
                        else JDiscretePolicy(), max_iter=2)
    rep, jrep = ex.report(), jex.report()
    assert set(rep) == set(jrep)
    if "pools" in jrep:
        for name, stats in jrep["pools"].items():
            assert set(rep["pools"][name]) == set(stats)
    assert set(rep["impl_counts"]) == set(jrep["impl_counts"]) == {"ref"}
    assert rep["regions"] == jrep["regions"]


def test_reset_timings_keeps_rows_and_clears_counts():
    r, ex = _solve(UnifiedPolicy(), max_iter=2)
    rows = set(ex.ledger.regions)
    ex.ledger.reset_timings()
    rep = ex.report()
    assert set(ex.ledger.regions) == rows
    assert rep["impl_counts"] == {} and rep["total_s"] == 0.0


# -- PBiCGStab against the reference --------------------------------------

@pytest.mark.parametrize("impl", ["ref", "hopper"])
def test_pbicgstab_regions_matches_jax_unified(impl):
    r, ex = _solve(UnifiedPolicy(selector=StaticSelector(impl)),
                   shape=(8, 8, 8))
    jr, _ = _jax_solve(JUnifiedPolicy(), shape=(8, 8, 8))
    assert r.converged and jr.converged
    assert r.iters == jr.iters
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x),
                               rtol=3e-4, atol=1e-4)
    assert ex.report()["impl_counts"].get(impl, 0) > 0


@pytest.mark.parametrize("policy", ["unified", "discrete"])
def test_target_selector_picks_the_kernel_as_jax_does(policy):
    """Routed to the card (``default`` unified, ``device`` discrete), each
    region runs its kernel variant where it has one and ``ref`` elsewhere,
    call for call as JAX's TargetSelector picks ``pallas``."""
    sel = TargetSelector()
    r, ex = _solve(UnifiedPolicy(selector=sel) if policy == "unified"
                   else DiscretePolicy(selector=sel, device="cpu"),
                   max_iter=3)
    jr, jex = _jax_solve(JUnifiedPolicy(selector=JTargetSelector()),
                         max_iter=3)
    counts = ex.report()["impl_counts"]
    jcounts = jex.report()["impl_counts"]
    assert counts["hopper"] == jcounts["pallas"] > 0
    assert counts["ref"] == jcounts["ref"]
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x),
                               rtol=3e-4, atol=1e-4)


def test_policies_give_identical_results():
    outs = [_solve(p)[0].x for p in (UnifiedPolicy(),
                                     DiscretePolicy(device="cpu"))]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


def test_discrete_executor_pays_staging():
    """tests/test_cfd.py::test_discrete_executor_pays_staging on the port:
    on a CPU-only torch both sides are CPU memory, and the stager still
    makes real pooled copies."""
    r, ex = _solve(DiscretePolicy(device="cpu"), shape=(12, 12, 12))
    rep = ex.report()
    assert rep["staging_fraction"] > 0.05
    assert rep["staging_s"] > 0
    assert isinstance(r.x, torch.Tensor)


# -- staging lifetimes ------------------------------------------------------

def test_staged_result_page_returns_only_when_result_dies():
    ldg = Ledger("t")
    policy = DiscretePolicy(device="cpu")
    ex = Executor(policy, ldg)

    @region("scale", ledger=ldg)
    def scale(x, a):
        return x * a

    x = torch.ones(64, 128)
    y1 = ex.run(scale, x, 2.0)
    pool = policy.stager.host_pool
    in_use = pool.stats.bytes_in_use
    assert in_use > 0
    y2 = ex.run(scale, x, 3.0)            # must not land in y1's page
    assert torch.equal(y1, torch.full((64, 128), 2.0))
    assert torch.equal(y2, torch.full((64, 128), 3.0))
    del y1, y2
    gc.collect()
    assert pool.stats.bytes_in_use == 0 and pool.free_bytes >= in_use


def test_view_of_staged_result_keeps_its_page():
    ldg = Ledger("t")
    policy = DiscretePolicy(device="cpu")
    ex = Executor(policy, ldg)

    @region("scale", ledger=ldg)
    def scale(x, a):
        return x * a

    x = torch.ones(64, 128)
    row = ex.run(scale, x, 2.0)[3]        # the result itself dies here
    gc.collect()
    pool = policy.stager.host_pool
    assert pool.stats.bytes_in_use > 0    # the view still holds the page
    ex.run(scale, x, 7.0)                 # must not land under the view
    assert torch.equal(row, torch.full((128,), 2.0))
    del row
    gc.collect()
    assert pool.stats.bytes_in_use == 0


def test_inbound_buffer_aliased_by_output_is_not_recycled():
    ldg = Ledger("t")
    policy = DiscretePolicy(device="cpu")
    ex = Executor(policy, ldg)

    @region("identity", ledger=ldg)
    def identity(x):
        return x

    y = ex.run(identity, torch.full((64, 128), 5.0))
    assert torch.equal(y, torch.full((64, 128), 5.0))
    assert policy.stager.device_pool.free_bytes == 0
