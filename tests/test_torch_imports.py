"""Rules of the port that hold for every module: it never imports ``jax``
or the JAX package ``repro`` (it keeps its own copy of what it needs), and
every entry point asks for CUDA by default and raises when CUDA is absent
instead of carrying on on the CPU."""
import ast
import importlib
import pathlib
import pkgutil
import sys

import pytest
import torch

import repro_torch
from repro_torch.core.regions import disable_compile


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                        "repro_torch."))


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def test_walk_finds_the_slice():
    for name in ("repro_torch.core.regions", "repro_torch.cfd.simple",
                 "repro_torch.cfd.__main__", "repro_torch.kernels.build",
                 "repro_torch.kernels.stencil_spmv.kernel",
                 "repro_torch.kernels.fused_field.kernel",
                 "repro_torch.configs.base", "repro_torch.configs.reduced",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.rwkv6_7b",
                 "repro_torch.models.params", "repro_torch.models.layers",
                 "repro_torch.models.rwkv6", "repro_torch.models.transformer",
                 "repro_torch.models.convert", "repro_torch.core.program",
                 "repro_torch.kernels.rwkv6_scan.kernel",
                 "repro_torch.kernels.rwkv6_scan.ref",
                 "repro_torch.train.step", "repro_torch.launch.policy",
                 "repro_torch.launch.serve", "repro_torch.core.oversub",
                 "repro_torch.models.attention", "repro_torch.models.flash",
                 "repro_torch.configs.tinyllama_1_1b",
                 "repro_torch.configs.llama3_2_3b",
                 "repro_torch.configs.gemma3_1b",
                 "repro_torch.configs.qwen2_5_32b",
                 "repro_torch.serve", "repro_torch.serve.paged_kv",
                 "repro_torch.serve.scheduler",
                 "repro_torch.serve.traffic",
                 "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.ckpt", "repro_torch.runtime.fault",
                 "repro_torch.launch.train",
                 "repro_torch.launch.compile_depth",
                 "repro_torch.models.rglru", "repro_torch.models.moe",
                 "repro_torch.configs.recurrentgemma_9b",
                 "repro_torch.configs.qwen3_moe_30b_a3b",
                 "repro_torch.configs.llama4_scout_17b_a16e"):
        assert name in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_neither_jax_nor_repro(name):
    mod = importlib.import_module(name)
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert not [m for m in imported if _forbidden(m)], (name, imported)


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module] if isinstance(node, ast.ImportFrom) else []
        assert not [m for m in names if _forbidden(m)]


@pytest.fixture
def no_cuda(monkeypatch):
    """Make CUDA absent, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_grid_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.cfd.grid import Grid
    with pytest.raises(RuntimeError, match="cuda"):
        Grid((4, 4, 4))
    assert Grid((4, 4, 4), device="cpu").device.type == "cpu"


def test_simple_foam_entry_raises_without_cuda(no_cuda):
    from repro_torch.cfd.grid import Grid
    from repro_torch.cfd.simple import SimpleConfig, SimpleFoam
    with pytest.raises(RuntimeError, match="cuda"):
        SimpleFoam(SimpleConfig(Grid((4, 4, 4))))


def test_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.cfd.__main__ import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--grid", "4", "--steps", "1"])


def test_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.cfd.__main__ import main
    out = main(["--grid", "4", "--steps", "1", "--device", "cpu",
                "--policy", "discrete"])
    assert out["device"] == "cpu" and out["staging_fraction"] > 0
    assert '"impl": "hopper"' in capsys.readouterr().out


def test_serve_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--reduced", "--prompt-len", "8", "--gen", "2"])


def test_train_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--reduced", "--steps", "1"])


def test_discrete_policy_raises_without_cuda(no_cuda):
    from repro_torch.core.regions import DiscretePolicy
    with pytest.raises(RuntimeError, match="cuda"):
        DiscretePolicy()


def test_chip_smoke_exits_nonzero_without_cuda(no_cuda, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
