"""Tests of the port that need an NVIDIA GPU (marker ``gpu``): each
hand-written kernel against its plain PyTorch version on the card, a
small SIMPLE step through the kernels against the ``ref`` step, and a
small serve run through the RWKV6 scan kernel.  They skip
where CUDA is absent; on a machine with a card run them with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none, which is
also why the run skips ``tests/conftest.py`` (it imports JAX).
"""
import pytest
import torch
from repro_torch.core.regions import disable_compile


@pytest.fixture(autouse=True)
def _eager(request):
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``), as before regions were compiled, except in the
    tests that ask for the ``compiled`` fixture (compiled executables on
    the CPU are tested in tests/test_torch_compile*.py)."""
    if "compiled" in request.fixturenames:
        yield
        return
    with disable_compile():
        yield


pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(37, 29, 23), (64, 64, 64),
                                   (200, 200, 200)])
@pytest.mark.parametrize("name", ["stencil_spmv", "rb_dilu_forward",
                                  "rb_dilu_backward"])
def test_stencil_kernel_matches_plain(cuda, name, shape):
    from repro_torch.cfd.grid import Grid
    from repro_torch.kernels.stencil_spmv import kernel as SK, ref as SR
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.rand(shape, generator=g, device=cuda) + 0.5
    off = torch.rand((6, *shape), generator=g, device=cuda) - 0.5
    x = torch.rand(shape, generator=g, device=cuda)
    red = Grid(shape, device=cuda).red_black_masks()[0]
    args = (a, off, x) if name == "stencil_spmv" else (a, red, off, x)
    before = SK.LAUNCHES[name]
    got = getattr(SK, name)(*args)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    torch.testing.assert_close(got, getattr(SR, name)(*args),
                               rtol=3e-4, atol=1e-4)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(37, 29, 23), (200, 200, 200), (5, 7, 3),
                                   (1, 3, 2), (11, 18, 70)])
@pytest.mark.parametrize("name", ["rb_dilu_forward", "rb_dilu_backward"])
def test_rb_dilu_kernel_equals_plain_under_a_random_mask(cuda, name, shape,
                                                         offset):
    """K2/K3 under a random red mask (they read the mask, never the parity
    of i+j+k), with every operand starting ``offset`` elements into its
    buffer (so no band starts on 16 bytes when it is 1): equal to the plain
    version bit for bit, and one launch a call."""
    import numpy as np
    from repro_torch.kernels.stencil_spmv import kernel as SK, ref as SR
    rng = np.random.RandomState(5)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)
        buf[offset:] = t.to(cuda)
        return buf[offset:].view(a.shape)

    rdiag = put(rng.rand(*shape).astype(np.float32) + 0.5)
    off = put(rng.rand(6, *shape).astype(np.float32) - 0.5)
    x = put(rng.rand(*shape).astype(np.float32))
    red = put(rng.rand(*shape) < 0.5)
    before = SK.LAUNCHES[name]
    got = getattr(SK, name)(rdiag, red, off, x)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    want = getattr(SR, name)(rdiag, red, off, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["fused_axpy", "fused_xpay", "fused_mul",
                                  "fused_axpbypz"])
def test_field_kernel_matches_plain(cuda, name, dtype):
    from repro_torch.kernels.fused_field import kernel as FK, ref as FR
    g = torch.Generator(device=cuda).manual_seed(1)
    x, y, z = (torch.rand(100003, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    args = {"fused_axpy": (1.7, x, y), "fused_xpay": (-0.3, x, y),
            "fused_mul": (x, y), "fused_axpbypz": (1.7, x, -0.3, y, z)}[name]
    got = getattr(FK, name)(*args)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), getattr(FR, name)(*args).float(),
                               **tol)


def test_wrapper_never_takes_plain_version_for_cuda_tensors(cuda):
    from repro_torch.kernels.stencil_spmv import kernel as SK
    x = torch.rand(4, 4, 4, device=cuda)
    with pytest.raises(ValueError):              # mixed devices: raise
        SK.stencil_spmv(x, torch.rand(6, 4, 4, 4), x)


def test_simple_step_hopper_matches_ref_on_card(cuda):
    from repro_torch.cfd.grid import Grid
    from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
    from repro_torch.core.regions import (Executor, StaticSelector,
                                          UnifiedPolicy)
    cfg = SimpleConfig(Grid((24, 24, 24), device=cuda), nu=0.1, inner_max=8,
                       tol_u=0.0, tol_p=0.0)
    out = {}
    for impl in ("hopper", "ref"):
        app = SimpleFoam(cfg, executor=Executor(
            UnifiedPolicy(selector=StaticSelector(impl))))
        st = init_state(cfg)
        for _ in range(2):
            st, _ = app.time_step(st)
        out[impl] = st
    for f in "uvwp":
        a, b = getattr(out["ref"], f), getattr(out["hopper"], f)
        assert (a - b).abs().max().item() <= \
            1e-5 * max(1.0, a.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(2, 128, 2, 16), (1, 64, 3, 8),
                                  (2, 96, 1, 32), (1, 192, 3, 64),
                                  (2, 100, 2, 64), (1, 1, 1, 64),
                                  (2, 1000, 4, 64), (1, 37, 2, 32),
                                  (1, 70, 3, 12)])
def test_rwkv6_scan_kernel_matches_plain(cuda, dims, dtype):
    """K5 against the sequential oracle from a nonzero state, within the
    reference's kernel tolerance (2e-4); bf16 r/k/v are widened to f32
    exactly on both sides, so the tolerance is the same.  T=100 and T=1
    leave a ragged last chunk; T=1000 and T=37 one that ends inside a
    16-row sub-chunk (40 and 37 rows).  hd=12 rows of bf16 do not start
    on 16 bytes, so the kernel loads them one element at a time."""
    from repro_torch.kernels.rwkv6_scan import kernel as K, ref as R
    B, T, H, hd = dims
    g = torch.Generator(device=cuda).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    r, k, v = (0.5 * randn(B, T, H, hd)).to(dtype), \
        (0.5 * randn(B, T, H, hd)).to(dtype), (0.5 * randn(B, T, H, hd)).to(dtype)
    logw = -2 * torch.rand((B, T, H, hd), generator=g, device=cuda) - 0.01
    u, S0 = 0.3 * randn(H, hd), 0.2 * randn(B, H, hd, hd)
    before = K.LAUNCHES["rwkv6_scan"]
    out, S = K.rwkv6_scan(r, k, v, logw, u, S0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rwkv6_scan"] == before + 1
    want_out, want_S = R.rwkv6_scan(r, k, v, logw, u, S0)
    torch.testing.assert_close(out, want_out, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(S, want_S, rtol=2e-4, atol=2e-4)


def test_rwkv6_scan_kernel_steep_decay_stays_finite(cuda):
    """Decays down to the model's floor (log w = -12) underflow inside a
    chunk; the kernel must give 0 there, never NaN."""
    from repro_torch.kernels.rwkv6_scan import kernel as K, ref as R
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 256, 4, 64)
    r, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    logw = -torch.exp(torch.rand(shape, generator=g, device=cuda) * 11 - 8)
    logw = logw.clamp(min=-12.0)
    u = torch.randn(4, 64, generator=g, device=cuda)
    out, S = K.rwkv6_scan(r, k, v, logw, u)
    want_out, want_S = R.rwkv6_scan(r, k, v, logw, u)
    assert torch.isfinite(out).all() and torch.isfinite(S).all()
    torch.testing.assert_close(out, want_out, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(S, want_S, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dims", [(2, 1000, 4, 64), (1, 37, 2, 32)])
def test_rwkv6_scan_kernel_matches_cpu_twin(cuda, dims):
    """K5 against ``ref.rwkv6_subchunk``, the plain twin of its
    arithmetic (sub-chunk-factored decays, 3xTF32 operands), run on the
    CPU on the same inputs, with steep decays down to the -12 floor."""
    from repro_torch.kernels.rwkv6_scan import kernel as K, ref as R
    B, T, H, hd = dims
    g = torch.Generator(device=cuda).manual_seed(4)
    r, k, v = (0.5 * torch.randn(dims, generator=g, device=cuda)
               for _ in range(3))
    logw = -torch.exp(torch.rand(dims, generator=g, device=cuda) * 11 - 8)
    logw = logw.clamp(min=-12.0)
    u = 0.3 * torch.randn(H, hd, generator=g, device=cuda)
    S0 = 0.2 * torch.randn(B, H, hd, hd, generator=g, device=cuda)
    out, S = K.rwkv6_scan(r, k, v, logw, u, S0)
    want_out, want_S = R.rwkv6_subchunk(
        *(t.cpu() for t in (r, k, v, logw, u, S0)))
    torch.testing.assert_close(out.cpu(), want_out, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(S.cpu(), want_S, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", ["hd_above_64", "contiguity", "mixed_device"])
def test_rwkv6_scan_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    from repro_torch.kernels.rwkv6_scan import kernel as K
    hd = 80 if bad == "hd_above_64" else 16
    r, k, v = (torch.rand(1, 8, 2, hd, device=cuda) for _ in range(3))
    logw, u = -torch.rand(1, 8, 2, hd, device=cuda), torch.rand(2, hd, device=cuda)
    if bad == "contiguity":
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mixed_device":
        u = u.cpu()
    before = K.LAUNCHES["rwkv6_scan"]
    with pytest.raises(ValueError):
        K.rwkv6_scan(r, k, v, logw, u)
    assert K.LAUNCHES["rwkv6_scan"] == before


def test_serve_reduced_on_card_runs_the_kernel(cuda):
    """The serve entry point on the card (reduced rwkv6-7b, hd=16): the
    replayed tokens equal the uncaptured path's (asserted inside main),
    each prefill (the capture's, the replay's and the oracle's) launched K5
    once per layer, and the discrete policy, whose regions hand back host
    pages, gives the same tokens."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.rwkv6_scan import kernel as K
    from repro_torch.launch.serve import main
    n_layers = reduced(get_config("rwkv6-7b")).n_layers
    before = K.LAUNCHES["rwkv6_scan"]
    seq = main(["--reduced", "--prompt-len", "96", "--gen", "4"])
    assert seq.shape == (4, 4)
    # capture + replay + oracle
    assert K.LAUNCHES["rwkv6_scan"] - before == 3 * n_layers
    before = K.LAUNCHES["rwkv6_scan"]
    seq_d = main(["--reduced", "--prompt-len", "96", "--gen", "4",
                  "--policy", "discrete"])
    assert torch.equal(seq_d, seq)
    assert K.LAUNCHES["rwkv6_scan"] - before == 2 * n_layers   # capture + replay


def test_prefill_f32_through_the_kernel_matches_ref_on_card(cuda):
    """rwkv6-7b at reduced width (32 layers, 4 heads of hd=64) in f32: the
    prefill through K5 against the prefill through ``rwkv_chunk``.  Every
    layer's S and the logits lie within 1e-4 of their largest magnitude:
    the two scans differ by f32 rounding of the decays' running sums, which
    32 layers amplify (2e-5 at this size with the plain scan on a CPU)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.rwkv6_scan import kernel as K
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(
        get_config("rwkv6-7b"), d_model=256, n_heads=4, head_dim=64,
        d_ff=512, vocab=2048, param_dtype="float32", compute_dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(0)
    params = T.init(g, cfg, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 256), generator=g,
                                     device=cuda, dtype=torch.int32)}
    out = {}
    before = K.LAUNCHES["rwkv6_scan"]
    for impl in ("hopper", None):
        step, _, make_cache = SV.build_server(cfg, 2, cuda, rwkv_impl=impl)
        out[impl] = step(params, batch, make_cache())
    assert K.LAUNCHES["rwkv6_scan"] - before == cfg.n_layers
    (lh, ch), (lr, cr) = out["hopper"], out[None]
    for a, b in zip(ch, cr):
        assert (a["S"] - b["S"]).abs().max() <= 1e-4 * b["S"].abs().max()
    assert (lh - lr).abs().max() <= 1e-4 * lr.abs().max()


def test_async_replay_prefetches_on_a_side_stream(cuda, monkeypatch):
    """A SIMPLE step captured on the card at 128^3, replayed under the
    discrete policy from pinned host memory: the lookahead copies are
    queued on a stream other than the compute stream, the replay equals the
    synchronous one bit for bit, and it hides part of its staging (overlap
    > 0, never above the staging it hides).  At 24^3 no op computes for
    longer than the host takes to queue the next op's copies, so nothing
    overlaps there."""
    from repro_torch.cfd.grid import Grid
    from repro_torch.cfd.simple import (SimpleConfig, SimpleFoam,
                                        SimpleState, init_state)
    from repro_torch.core.program import AsyncExecutor
    from repro_torch.core.regions import (DiscretePolicy, Executor,
                                          MigrationStager, TargetSelector,
                                          UnifiedPolicy)
    from repro_torch.core.umem import MemSpace, tree_place
    cfg = SimpleConfig(Grid((128, 128, 128), device=cuda), nu=0.1,
                       inner_max=2, tol_u=0.0, tol_p=0.0)
    app = SimpleFoam(cfg, executor=Executor(
        UnifiedPolicy(selector=TargetSelector())))
    st, _ = app.time_step(init_state(cfg))
    prog = app.capture_step(st)
    pinned = SimpleState(*tree_place([getattr(st, f) for f in "uvwp"],
                                     MemSpace.HOST), st.step)
    streams = []
    enqueue = MigrationStager.enqueue_leaves

    def spy(self, leaves, rotation=None):
        streams.append(torch.cuda.current_stream())
        return enqueue(self, leaves, rotation)

    monkeypatch.setattr(MigrationStager, "enqueue_leaves", spy)
    sync = Executor(DiscretePolicy(selector=TargetSelector()))
    asyn = AsyncExecutor(DiscretePolicy(selector=TargetSelector()))
    s_sync, _ = app.replay_steps(prog, pinned, 2, sync)
    compute = torch.cuda.current_stream()
    s_async, _ = app.replay_steps(prog, pinned, 2, asyn)
    assert any(s != compute for s in streams)
    for f in "uvwp":
        assert torch.equal(getattr(s_sync, f), getattr(s_async, f))
    rep = asyn.report()
    assert 0.0 < rep["overlap_s"] <= rep["staging_s"]
    assert rep["overlap_fraction"] > 0


def test_rotation_reuse_waits_for_the_compute_streams_reads(cuda):
    """A bank buffer read late on the compute stream (behind a long device
    sleep), retired, and acquired again on a side stream: the side stream's
    write waits for that read, so the read sees the old values."""
    from repro_torch.core.pool import BufferRotation, DeviceBufferPool
    rot = BufferRotation(DeviceBufferPool(device=cuda), depth=2)
    buf = rot.acquire((1 << 16,), torch.float32)
    buf.fill_(1.0)
    torch.cuda._sleep(50_000_000)               # ~25 ms before the read
    seen = buf * 1.0                            # the compute stream's read
    rot.retire()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        again = rot.acquire((1 << 16,), torch.float32)
        again.fill_(7.0)
    torch.cuda.synchronize()
    assert again.data_ptr() == buf.data_ptr()
    assert torch.equal(seen, torch.ones_like(seen))


def test_host_routed_call_on_card_operands_crosses_and_books_it(cuda):
    """Under the adaptive policy a call at or below the cutoff runs on the
    CPU: its CUDA operands cross over and its result crosses back to the
    card, both booked as staging bytes, and no kernel is launched."""
    from repro_torch.cfd.dia import AMUL
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.regions import (AdaptivePolicy, Executor,
                                          TargetSelector)
    from repro_torch.kernels.stencil_spmv import kernel as SK, ref as SR
    diag, x = torch.rand(8, 8, 8, device=cuda), torch.rand(8, 8, 8,
                                                           device=cuda)
    off = torch.rand(6, 8, 8, 8, device=cuda)
    ex = Executor(AdaptivePolicy(1 << 30, selector=TargetSelector()),
                  Ledger("t"))
    before = SK.LAUNCHES["stencil_spmv"]
    y = ex.run(AMUL, diag, off, x)
    assert y.device.type == "cuda"
    assert SK.LAUNCHES["stencil_spmv"] == before
    torch.testing.assert_close(y, SR.stencil_spmv(diag, off, x))
    row = ex.ledger.regions[AMUL.name]
    assert (row.host_calls, row.device_calls) == (1, 0)
    assert row.impl_counts == {"ref": 1}
    assert row.staging_bytes == 4 * (diag.numel() + off.numel() + 2 * x.numel())
    assert row.staging_s > 0


@pytest.mark.parametrize("argv", [["--policy", "all", "--calibrate"],
                                  ["--policy", "discrete", "--replay", "async"],
                                  ["--policy", "adaptive", "--replay", "sync"]])
def test_cfd_cli_runs_every_policy_and_replay_on_card(cuda, argv):
    """The entry point at 16^3 on the card: host on the CPU, the other
    policies on the card; a replayed step captured from a discrete step's
    host-page state."""
    from repro_torch.cfd.__main__ import main
    out = main(["--grid", "16", "--steps", "1"] + argv)
    rows = out if isinstance(out, list) else [out]
    for row in rows:
        assert row["device"] == ("cpu" if row["policy"] == "host" else "cuda")
        assert row["fom_s_per_step"] > 0
    if "--replay" in argv:
        assert 0.0 <= rows[0]["overlap_fraction"] <= 1.0


@pytest.fixture
def compiled():
    """Asked for by the tests that run the regions compiled (the module's
    ``_eager`` fixture then steps aside)."""
    return True


def test_compiled_hopper_step_matches_compiled_ref_step(cuda, compiled):
    """At 37x29x23, both steps through compiled executables (the kernels
    as custom ops in the hopper graphs): within the step envelope, and the
    hopper step launches as many kernels compiled as eagerly.  Three
    PBiCGStab iterations a solve, as ``chip_smoke.py``'s ``[policies]``:
    the compiled ``ref`` glue rounds its own way, and many iterations on
    the pinned pressure system would amplify that past the envelope."""
    from repro_torch.cfd.grid import Grid
    from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
    from repro_torch.core.regions import (Executor, StaticSelector,
                                          UnifiedPolicy, disable_compile)
    from repro_torch.kernels.fused_field import kernel as FK
    from repro_torch.kernels.stencil_spmv import kernel as SK
    cfg = SimpleConfig(Grid((37, 29, 23), device=cuda), nu=0.1, inner_max=3,
                       tol_u=0.0, tol_p=0.0)

    def step(impl):
        app = SimpleFoam(cfg, executor=Executor(
            UnifiedPolicy(selector=StaticSelector(impl))))
        before = {**SK.LAUNCHES, **FK.LAUNCHES}
        st = init_state(cfg)
        for _ in range(2):
            st, _ = app.time_step(st)
        after = {**SK.LAUNCHES, **FK.LAUNCHES}
        return st, {k: after[k] - before[k] for k in after}, app

    hop, launched, app = step("hopper")
    ref, _, _ = step("ref")
    for f in "uvwp":
        a, b = getattr(ref, f), getattr(hop, f)
        assert (a - b).abs().max().item() <= \
            1e-5 * max(1.0, a.abs().max().item())
    assert app.solver_regions.amul.compile_stats
    with disable_compile():
        _, launched_eager, _ = step("hopper")
    assert launched == launched_eager
    assert min(launched[k] for k in ("stencil_spmv", "rb_dilu_forward",
                                     "rb_dilu_backward", "fused_axpy",
                                     "fused_axpbypz")) > 0


def test_compiled_serve_reduced_tokens_and_kernel_launches(cuda, compiled):
    """The serve entry point compiled (its default) on the card: replayed
    tokens equal the uncaptured path's (asserted inside ``main``) and each
    prefill (capture, replay, uncaptured) launches K5 once per layer."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.rwkv6_scan import kernel as K
    from repro_torch.launch.serve import main
    n_layers = reduced(get_config("rwkv6-7b")).n_layers
    before = K.LAUNCHES["rwkv6_scan"]
    seq = main(["--reduced", "--prompt-len", "96", "--gen", "4"])
    assert seq.shape == (4, 4)
    assert K.LAUNCHES["rwkv6_scan"] - before == 3 * n_layers


def test_replay_batch_runs_the_field_kernels_on_card(cuda, compiled):
    """A captured PBiCGStab solve (K1-K4 through the hopper variants)
    replayed two instances wide through ``replay_batch``: the vmap rules
    launch the kernels, and each instance equals its solo replay within the
    step envelope."""
    import types
    from repro_torch.cfd import fvm
    from repro_torch.cfd.dia import DiaMatrix
    from repro_torch.cfd.grid import Grid
    from repro_torch.cfd.precond import rb_dilu_factor
    from repro_torch.cfd.solvers import make_solver_regions, pbicgstab_regions
    from repro_torch.core.program import capture
    from repro_torch.core.regions import (Executor, TargetSelector,
                                          UnifiedPolicy)
    from repro_torch.kernels.fused_field import kernel as FK
    from repro_torch.kernels.stencil_spmv import kernel as SK
    grid = Grid((24, 20, 16), device=cuda)
    A, _ = fvm.laplacian(grid, 1.0)
    A = DiaMatrix(A.diag + 0.5, A.off)
    red = grid.red_black_masks()[0]
    P = rb_dilu_factor(A, red)
    sel = TargetSelector("hopper")
    regions = make_solver_regions()

    def solve(run, b, x0):
        return pbicgstab_regions(types.SimpleNamespace(run=run), regions, A,
                                 b, x0, P, tol=0.0, max_iter=3).x

    g = torch.Generator(device=cuda).manual_seed(0)
    bs = torch.rand((2, *grid.shape), generator=g, device=cuda)
    x0 = torch.zeros_like(bs)
    prog = capture(solve, bs[0], x0[0], name="solve", selector=sel)
    ex = Executor(UnifiedPolicy(selector=sel))
    solo = torch.stack([prog.replay(ex, bs[i], x0[i]) for i in range(2)])
    before = {**SK.LAUNCHES, **FK.LAUNCHES}
    got = prog.replay_batch(bs, x0, executor=ex, selector=sel)
    after = {**SK.LAUNCHES, **FK.LAUNCHES}
    assert min(after[k] - before[k] for k in (
        "stencil_spmv", "rb_dilu_forward", "rb_dilu_backward", "fused_axpy",
        "fused_axpbypz")) > 0
    err = (got - solo).abs().max().item()
    assert err <= 1e-5 * max(1.0, solo.abs().max().item())


def test_budgeted_placer_migrates_a_demoted_operand_in_on_card(cuda):
    """Two card operands with DEVICE hints under a budget that admits the
    smaller: the larger is demoted to pinned host memory, migrates in for
    the call (booked as staging bytes), the call runs on the card and its
    result equals the unhinted run."""
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.oversub import BudgetedPlacer, MemoryBudget
    from repro_torch.core.regions import Executor, UnifiedPolicy, region
    from repro_torch.core.umem import MemSpace
    ldg = Ledger("bp_card")

    @region("bp_weighted", ledger=ldg,
            placement={0: MemSpace.DEVICE, 1: MemSpace.DEVICE})
    def weighted(d, off):
        return d * off.sum(0)
    d = torch.rand(32, 32, 32, device=cuda)
    off = torch.rand(6, 32, 32, 32, device=cuda)
    want = Executor(UnifiedPolicy(), Ledger("bp_plain")).run(weighted, d, off)
    budget = MemoryBudget(2 * d.numel() * 4)
    ex = Executor(UnifiedPolicy(placer=BudgetedPlacer(budget=budget,
                                                      device=cuda)),
                  Ledger("bp_budget"))
    got = ex.run(weighted, d, off)
    assert got.device.type == "cuda"
    assert torch.equal(got, want)
    row = ex.ledger.regions["bp_weighted"]
    assert row.staging_bytes == off.numel() * 4 and row.staging_s > 0
    assert (row.device_calls, row.host_calls) == (1, 0)
    assert budget.stats.denials == 1 and budget.stats.charged_bytes == 0


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_budgeted_replay_on_card_equals_unbudgeted(cuda, executor):
    """A 48^3 SIMPLE step captured on the card, replayed from pinned host
    memory under the discrete policy with and without a budget of a quarter
    of the state: bit for bit equal, staged in slabs, under pressure."""
    from repro_torch.cfd.grid import Grid
    from repro_torch.cfd.simple import (SimpleConfig, SimpleFoam,
                                        SimpleState, init_state)
    from repro_torch.core.oversub import MemoryBudget, workload_bytes
    from repro_torch.core.program import AsyncExecutor
    from repro_torch.core.regions import (DiscretePolicy, Executor,
                                          TargetSelector, UnifiedPolicy)
    from repro_torch.core.umem import MemSpace, tree_place
    cfg = SimpleConfig(Grid((48, 48, 48), device=cuda), nu=0.1, inner_max=3,
                       tol_u=0.0, tol_p=0.0)
    sel = TargetSelector()
    app = SimpleFoam(cfg, executor=Executor(UnifiedPolicy(selector=sel)))
    st, _ = app.time_step(init_state(cfg))
    prog = app.capture_step(st)
    pinned = SimpleState(*tree_place([getattr(st, f) for f in "uvwp"],
                                     MemSpace.HOST), st.step)
    make = Executor if executor == "sync" else AsyncExecutor
    want, _ = app.replay_steps(prog, pinned, 2,
                               make(DiscretePolicy(selector=sel)))
    budget = MemoryBudget.for_ratio(workload_bytes(pinned), 4.0)
    got, _ = app.replay_steps(prog, pinned, 2, make(
        DiscretePolicy(selector=sel, budget=budget)))
    for f in "uvwp":
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    assert budget.stats.staging_chunks > 0
    assert budget.stats.pressure_events > 0
    assert budget.stats.charged_bytes == 0


def test_compiled_attention_serve_reduced_on_card(cuda, compiled):
    """The serve entry point with an attention arch, compiled on the card:
    replayed tokens equal the uncaptured path's (asserted inside ``main``)
    for tinyllama and llama3.2 at reduced width, and each layer kind
    compiles once with the decode position an input."""
    from repro_torch.launch.serve import main
    from repro_torch.models import transformer as T
    for arch in ("tinyllama-1.1b", "llama3.2-3b"):
        seq = main(["--arch", arch, "--reduced", "--prompt-len", "96",
                    "--gen", "6"])
        assert seq.shape == (4, 6)
    ops = [op for op in T.LAYER_OPS.values()
           if op.label.startswith("layer_attn") and op.stats.calls]
    assert ops and all(op.stats.compiles == 1 for op in ops)


def test_device_pool_on_bare_cuda_recycles_and_releases_its_budget(cuda):
    """A pool made for ``"cuda"`` (no index) takes back the buffers it
    handed out (their device is ``cuda:0``): a second acquire is a
    free-list hit, and a budget it charges returns to zero."""
    from repro_torch.core.oversub import MemoryBudget
    from repro_torch.core.pool import DeviceBufferPool
    budget = MemoryBudget(1 << 20)
    pool = DeviceBufferPool(device="cuda", budget=budget)
    buf = pool.acquire((64, 128), torch.float32)
    assert buf.is_cuda and budget.stats.charged_bytes == buf.numel() * 4
    pool.release(buf)
    assert budget.stats.charged_bytes == 0 and pool.free_bytes > 0
    again = pool.acquire((64, 128), torch.float32)
    assert pool.stats.hits == 1 and again.data_ptr() == buf.data_ptr()
    pool.release(again)


def test_compiled_engine_reduced_gemma3_on_card_equals_solo(cuda, compiled):
    """Reduced gemma3-1b (local and global layers) through the
    continuous-batching engine on the card, compiled, with a device page
    budget that spills: every request's tokens equal its solo decode's."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.regions import Executor, StaticSelector
    from repro_torch.launch.policy import lm_policy
    from repro_torch.models import transformer as T
    from repro_torch.serve import (PagedKVCache, ServeEngine, make_traffic,
                                   run_traffic, solo_reference)
    from repro_torch.serve.traffic import assert_parity
    cfg = reduced(get_config("gemma3-1b"))
    params = T.init(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    reqs = make_traffic(3, 6, cfg.vocab, arrival_rate=2.0,
                        prompt_lens=(12, 40), gen_lens=(1, 6, 10))
    ex = Executor(lm_policy("unified", cfg.memory,
                            selector=StaticSelector("hopper"), device=cuda),
                  Ledger("engine_card"))
    kv = PagedKVCache(page_tokens=8, device_budget_bytes=1, device=cuda)
    engine = ServeEngine(cfg, params, ex, max_len=50, n_slots=2, kv=kv,
                         device=cuda)
    run_traffic(engine, reqs)
    oracle, _ = solo_reference(cfg, params, reqs, 50, device=cuda,
                               rwkv_impl="hopper")
    assert_parity(reqs, oracle)
    assert kv.stats.pages_spilled > 0 and kv.stats.pages_fetched > 0
    assert engine.slot_cache[0]["k"].is_cuda


def test_spilled_pages_go_to_pinned_host_and_come_back_bitwise(cuda):
    """A page set spilled under a one-byte device budget sits in pinned
    host memory, its device pages back in the pool, and returns to the
    card bit for bit at gather."""
    from repro_torch.serve import PagedKVCache
    g = torch.Generator(device=cuda).manual_seed(1)
    cache = [{"k": torch.randn(1, 40, 2, 16, generator=g, device=cuda,
                               dtype=torch.bfloat16),
              "v": torch.randn(1, 40, 2, 16, generator=g, device=cuda,
                               dtype=torch.bfloat16),
              "pos": torch.arange(40, dtype=torch.int32, device=cuda)}]
    kv = PagedKVCache(page_tokens=8, device_budget_bytes=1, device=cuda)
    kv.commit(0, cache, true_len=40)
    entry = kv._entries[0]
    pages = [p for rec in entry.leaves if rec[0] == "page" for p in rec[1]]
    assert entry.on_host and len(pages) == 10
    assert all(p.device.type == "cpu" and p.is_pinned() for p in pages)
    assert kv.pool.stats.bytes_in_use == 0 and kv.pool.free_bytes > 0
    back = kv.gather(0)
    torch.cuda.synchronize()
    for key in ("k", "v", "pos"):
        assert back[0][key].is_cuda
        assert torch.equal(back[0][key], cache[0][key]), key
    assert kv.stats.pages_fetched == 10


def test_offload_kv_on_card_migrates_in_for_a_compiled_region(cuda,
                                                              compiled):
    """``--offload-kv`` on the card: a compiled region fed k/v leaves that
    live in pinned host memory gets them copied in for the call (the
    executor's migrate-in, booked as staging), runs on the card, and its
    k/v results are re-homed to pinned host memory; values unchanged."""
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.regions import Executor, UnifiedPolicy, region
    from repro_torch.launch.serve import offload_kv_cache
    ldg = Ledger("offload_card")

    @region("kv_scale", ledger=ldg)
    def kv_scale(cache, s):
        return [{**c, "k": c["k"] * s, "v": c["v"] + s} for c in cache]
    g = torch.Generator(device=cuda).manual_seed(2)
    cache = [{"k": torch.randn(1, 64, 2, 64, generator=g, device=cuda),
              "v": torch.randn(1, 64, 2, 64, generator=g, device=cuda),
              "pos": torch.arange(64, dtype=torch.int32, device=cuda)}]
    s = torch.tensor(2.0, device=cuda)
    want = Executor(UnifiedPolicy(), Ledger("plain")).run(kv_scale, cache, s)
    ex = Executor(UnifiedPolicy(placer=offload_kv_cache(device=cuda)),
                  Ledger("offload"))
    host = ex.policy.placer.place_result(kv_scale, cache)  # re-homed once
    assert host[0]["k"].is_pinned() and host[0]["pos"].is_cuda
    got = ex.run(kv_scale, host, s)
    assert got[0]["k"].device.type == "cpu" and got[0]["k"].is_pinned()
    assert got[0]["pos"].is_cuda
    for key in ("k", "v", "pos"):
        assert torch.equal(got[0][key].to(cuda), want[0][key]), key
    row = ex.ledger.regions["kv_scale"]
    assert row.staging_bytes == 2 * cache[0]["k"].numel() * 4
    assert row.staging_s > 0 and (row.device_calls, row.host_calls) == (1, 0)


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_compiled_decode_rows_are_bit_for_bit_their_solo_rows_on_card(
        cuda, compiled, arch):
    """The card twin of tests/test_torch_engine_rows.py: every compiled
    decode layer kind under ``vmap`` at n = 1..4 rows, and the compiled
    head at n = 1..4 rows, give each row bit for bit its n = 1 output
    (bf16, reduced)."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    cfg = reduced(get_config(arch))
    params = T.init(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    ops = T.layer_fns(cfg, T.Ctx(mode="decode"))
    kinds = T.layer_kinds(cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    n_rows = 4
    pos = torch.tensor([5, 9, 6, 12], dtype=torch.int32, device=cuda)
    for kind in dict.fromkeys(kinds):
        layer = kinds.index(kind)
        op = ops[kind]
        cache = T.init_cache(cfg, 1, cuda, 24)[layer]
        leaves = []
        for k in op._cache_keys:
            c = cache[k]
            if k == "pos":
                slots = torch.arange(c.shape[0], dtype=torch.int32,
                                     device=cuda)
                leaves.append(torch.stack([torch.where(slots < p, slots, -1)
                                           for p in pos.tolist()]))
            else:
                leaves.append(torch.randn((n_rows, *c.shape), generator=g,
                                          device=cuda).to(c.dtype))
        x = torch.randn((n_rows, 1, 1, cfg.d_model), generator=g,
                        device=cuda).to(torch.bfloat16)
        p = T._leaves(params["layers"][layer])
        solo = [op.op(p, x[i], [c[i] for c in leaves], pos[i])
                for i in range(n_rows)]
        for n in range(1, n_rows + 1):
            got = torch.func.vmap(op.op, in_dims=(None, 0, [0] * len(leaves),
                                                  0))(
                p, x[:n], [c[:n] for c in leaves], pos[:n])
            for i in range(n):
                for a, b in zip(got, solo[i]):
                    assert torch.equal(a[i], b), (kind, n, i)
    hx = torch.randn((n_rows, 1, cfg.d_model), generator=g,
                     device=cuda).to(torch.bfloat16)
    solo = [ops["head"](params, hx[i:i + 1]) for i in range(n_rows)]
    for n in range(1, n_rows + 1):
        got = ops["head"](params, hx[:n])
        for i in range(n):
            assert torch.equal(got[i:i + 1], solo[i]), ("head", n, i)


def test_expert_pager_on_card_is_bit_for_bit_under_every_budget(cuda):
    """The card twin of tests/test_torch_moe.py's pager check: the experts
    parked in pinned host memory, slabs copied on a side stream; at
    ratios 1, 2 and 4 and with the lookahead off every output equals the
    unbudgeted run's bit for bit, and the unbudgeted run is within 2e-2 of
    the largest magnitude of ``moe_ref`` (bf16)."""
    import dataclasses
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.oversub import MemoryBudget
    from repro_torch.models import moe as M
    from repro_torch.models.params import init_params
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, top_k=2, d_ff=32))
    p = init_params(torch.Generator(device=cuda).manual_seed(0),
                    M.moe_specs(cfg), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn((1, 1, cfg.d_model), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(16)]

    def stream(budget=None, lookahead=True):
        pager = M.ExpertPager(p, cfg, budget=budget, lookahead=lookahead)
        assert all(t.is_pinned() for t in pager._host.values())
        ys = [M.moe_decode_paged(pager, x, cfg)[0] for x in xs]
        pager.close()
        return pager, ys

    pager0, ys0 = stream()
    for x, y in zip(xs, ys0):
        want = M.moe_ref(p, x, cfg)[0].float()
        assert (y.float() - want).abs().max() <= \
            2e-2 * max(1.0, want.abs().max().item())
    for ratio, lookahead in ((1.0, True), (2.0, True), (4.0, True),
                             (4.0, False)):
        budget = MemoryBudget.for_ratio(pager0.footprint_bytes, ratio)
        pager, ys = stream(budget, lookahead)
        assert all(torch.equal(a, b) for a, b in zip(ys0, ys)), ratio
        assert pager.stats.fetches > 0
        if ratio == 4.0:
            assert pager.stats.evictions > 0
            assert (pager.stats.prefetch_hits > 0) == lookahead


def test_compiled_train_step_matches_eager_on_card(cuda, compiled):
    """Reduced tinyllama-1.1b in f32 on the card (TF32 off), compiled
    (each layer kind's forward and VJP) against eager
    (``disable_compile``) on the same inputs: the loss within 1e-5
    relative; each gradient leaf's distance to the f64 gradient (an eager
    f64 run of the same model) within the larger of 4 times the eager f32
    leaf's and 1e-5 of the leaf's largest magnitude; two AdamW steps on
    the same gradients, every parameter within 1e-6 of its leaf's largest
    magnitude."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as S
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        c64 = dataclasses.replace(cfg, param_dtype="float64",
                                  compute_dtype="float64")
        params = T.init(torch.Generator(device=cuda).manual_seed(0), cfg,
                        cuda)
        batch = S.demo_batch(torch.Generator(device=cuda).manual_seed(1),
                             cfg, 2, 64, cuda)
        ctx = T.Ctx(mode="train")
        (lc, _), gc = S.value_and_grad(params, batch, cfg, ctx)
        with disable_compile():
            (le, _), ge = S.value_and_grad(params, batch, cfg, ctx)
            _, g64 = S.value_and_grad(
                pytree.tree_map(lambda t: t.double(), params), batch, c64,
                ctx)
        assert abs(float(lc) - float(le)) <= 1e-5 * abs(float(le))

        def rel(a, b):
            return float((a.double() - b.double()).abs().max()
                         / b.double().abs().max())
        for a, b, r in zip(pytree.tree_leaves(gc), pytree.tree_leaves(ge),
                           pytree.tree_leaves(g64)):
            assert rel(a, r) <= max(4 * rel(b, r), 1e-5)
        opt_cfg = adamw.AdamWConfig()
        pc = pe = params
        sc = se = adamw.init_state(params, opt_cfg)
        for _ in range(2):
            pc, sc, _ = adamw.apply_updates(pc, ge, sc, opt_cfg)
            with disable_compile():
                pe, se, _ = adamw.apply_updates(pe, ge, se, opt_cfg)
        for a, b in zip(pytree.tree_leaves(pc), pytree.tree_leaves(pe)):
            assert rel(a, b) <= 1e-6
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    layers = [op for op in T.LAYER_OPS.values()
              if isinstance(op, T.TrainLayer) and op.stats.calls]
    assert layers and all(op.stats.compiles == 1 for op in layers)
