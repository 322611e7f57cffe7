"""Tests of the port that need an NVIDIA GPU (marker ``gpu``): each
hand-written kernel against its plain PyTorch version on the card, and a
small SIMPLE step through the kernels against the ``ref`` step.  They skip
where CUDA is absent; on a machine with a card run them with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none, which is
also why the run skips ``tests/conftest.py`` (it imports JAX).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(37, 29, 23), (64, 64, 64)])
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
