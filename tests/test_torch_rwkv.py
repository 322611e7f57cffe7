"""The RWKV6 modules of the port held against the JAX package on the same
numpy inputs: the scan kernel's plain versions against the Pallas kernel
(interpret mode), the ``RWKV6_SCAN`` variants against the reference's
``ref`` with a nonzero state, the time-mix, decode step and channel-mix
against their JAX functions, and the configs, init laws, layers and
parameter conversion the slice rests on.

Parameters come from the reference's init, converted with
``repro_torch.models.convert``; ``u``, ``mu_*`` and the LoRA ``B_*`` are
overwritten with nonzero values (their inits are zero and would hide
their terms).

Tolerances: 2e-4 for the scan against the Pallas kernel
(tests/test_kernels.py), 3e-4 for the region variants
(tests/test_variants.py), 1e-5 for the float32 model functions, whose
only difference is the order of float32 sums, and 5e-4 where the port's
time-mix runs another scan than the reference's default (the tolerance
of tests/test_variants.py::test_rwkv_train_impl_dispatch_matches_default).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.rwkv6_scan import ops as JK
from repro.models import layers as JL
from repro.models import rwkv6 as JR
from repro.models.params import init_params as j_init_params
from repro.models.transformer import Ctx as JCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import kernel as K, ref as KR
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.models.convert import _tensor
from repro_torch.models.params import ParamSpec, init_params, param_count
from repro_torch.models.transformer import Ctx
from repro_torch.core.umem import tree_map
from repro_torch.core.regions import disable_compile


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


MODEL = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=2,
             n_kv_heads=2, d_ff=48, vocab=64, head_dim=16,
             layer_cycle=("rwkv",), param_dtype="float32",
             compute_dtype="float32")
F32 = dict(rtol=1e-5, atol=1e-5)
OTHER_SCAN = dict(rtol=5e-4, atol=5e-4)


def nonzero_adapters(tree, seed):
    """The reference's params with ``u``, ``mu_*`` and ``B_*`` made
    nonzero (numpy leaves)."""
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "u":
            return (0.3 * rng.randn(*a.shape)).astype(a.dtype)
        if name.startswith("mu_"):
            return rng.rand(*a.shape).astype(a.dtype)
        if name.startswith("B_"):
            return (0.2 * rng.randn(*a.shape)).astype(np.float32).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


def to_torch(tree):
    return tree_map(lambda a: _tensor(a, "cpu"), tree)


def _scan_inputs(B, T, H, hd, seed):
    rng = np.random.RandomState(seed)
    r, k, v = (0.5 * rng.randn(B, T, H, hd).astype(np.float32)
               for _ in range(3))
    logw = (-2 * rng.rand(B, T, H, hd) - 0.01).astype(np.float32)
    u = (0.3 * rng.randn(H, hd)).astype(np.float32)
    S0 = (0.2 * rng.randn(B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, S0


@pytest.mark.parametrize("plain", ["sequential", "chunked"])
@pytest.mark.parametrize("dims", [(2, 128, 2, 16, 32), (1, 64, 3, 8, 64),
                                  (2, 96, 1, 32, 16), (1, 32, 2, 8, 8)])
def test_plain_scan_matches_pallas_kernel(dims, plain):
    B, T, H, hd, C = dims
    r, k, v, logw, u, _ = _scan_inputs(B, T, H, hd, seed=C)
    want_out, want_S = JK.rwkv6_scan(*map(jnp.asarray, (r, k, v, logw, u)),
                                     chunk=C)
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    if plain == "sequential":
        out, S = K.rwkv6_scan(*t)                  # CPU: the plain version
    else:
        out, S = KR.rwkv6_chunked(*t, chunk=C)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dims", [(2, 32, 2, 8), (1, 96, 3, 16)])
@pytest.mark.parametrize("variant", ["ref", "chunked", "hopper"])
def test_scan_variants_match_jax_ref_with_nonzero_state(variant, dims):
    inputs = _scan_inputs(*dims, seed=3)
    want_out, want_S = JR.RWKV6_SCAN.impl_fn("ref")(*map(jnp.asarray, inputs))
    assert set(R.RWKV6_SCAN.variants) == {"ref", "chunked", "hopper"}
    out, S = R.RWKV6_SCAN.impl_fn(variant)(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S),
                               rtol=3e-4, atol=3e-4)


def _steep_logw(shape, seed):
    """Decays down to the model's floor, log w = -12, which underflow to 0
    inside a 64-row chunk."""
    rng = np.random.RandomState(seed)
    return np.maximum(-np.exp(rng.rand(*shape) * 11 - 8), -12.0).astype(
        np.float32)


@pytest.mark.parametrize("dims", [(2, 128, 2, 16), (1, 128, 2, 64),
                                  (1, 64, 3, 32)])
def test_subchunk_twin_matches_pallas_kernel(dims):
    """The kernel's arithmetic (sub-chunk-factored decays, 3xTF32
    operands) against the Pallas kernel in interpret mode, from the zero
    state it starts from, at the reference's kernel tolerance."""
    r, k, v, logw, u, _ = _scan_inputs(*dims, seed=7)
    want_out, want_S = JK.rwkv6_scan(*map(jnp.asarray, (r, k, v, logw, u)),
                                     chunk=64)
    out, S = KR.rwkv6_subchunk(*map(torch.from_numpy, (r, k, v, logw, u)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["serve_hd", "floor", "ragged_T100",
                                  "ragged_floor_hd32"])
def test_subchunk_twin_matches_oracle_with_nonzero_state(case):
    """Against the reference's sequential oracle from a nonzero state.
    T=100 leaves a last chunk of 36 rows, which ends inside its third
    16-row sub-chunk; at the -12 floor the factored decays underflow and
    must give 0, never NaN."""
    dims = {"serve_hd": (2, 128, 2, 64), "floor": (2, 128, 2, 64),
            "ragged_T100": (1, 100, 2, 64),
            "ragged_floor_hd32": (2, 100, 3, 32)}[case]
    r, k, v, logw, u, S0 = _scan_inputs(*dims, seed=8)
    if "floor" in case:
        logw = _steep_logw(dims, seed=9)
    inputs = (r, k, v, logw, u, S0)
    want_out, want_S = JR.RWKV6_SCAN.impl_fn("ref")(*map(jnp.asarray, inputs))
    out, S = KR.rwkv6_subchunk(*map(torch.from_numpy, inputs))
    assert torch.isfinite(out).all() and torch.isfinite(S).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S),
                               rtol=2e-4, atol=2e-4)


def test_subchunk_twin_needs_the_3xtf32_split():
    """One TF32 pass (operands rounded to 11 bits) misses the 2e-4
    tolerance at the serve cell's B=4, T=1024 and hd=64 (2 of its 64
    heads); the 3xTF32 split meets it with room.  ``-s`` prints both."""
    inputs = [torch.from_numpy(a) for a in _scan_inputs(4, 1024, 2, 64, 10)]
    want, want_S = KR.rwkv6_scan(*inputs)
    err = {}
    for split in (True, False):
        out, S = KR.rwkv6_subchunk(*inputs, tf32_split=split)
        err[split] = ((out - want).abs().max().item(),
                      (S - want_S).abs().max().item())
    print(f"twin max|err| (out, S) vs the oracle: 3xTF32 {err[True]}, "
          f"one TF32 pass {err[False]}")
    assert max(err[True]) < 5e-5 < 2e-4 < err[False][0]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                                  # exact in TF32
    x = torch.tensor([one, 1.0 + 2.0 ** -11,                # tie: away
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      0.0, -3.0], dtype=torch.float32)
    want = [one, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 0.0, -3.0]
    assert KR.tf32(x).tolist() == want


def test_scan_wrapper_cpu_calls_are_not_launches():
    before = dict(K.LAUNCHES)
    K.rwkv6_scan(*map(torch.from_numpy, _scan_inputs(1, 8, 1, 4, seed=0)))
    assert K.LAUNCHES == before


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed_dtype", "logw_dtype",
                                 "u_shape", "state_shape", "contiguity"])
def test_scan_wrapper_rejects_bad_operands(bad):
    r, k, v, logw, u, S0 = map(torch.from_numpy, _scan_inputs(1, 8, 2, 4, 0))
    if bad == "rank":
        r = r[0]
    elif bad == "dtype":
        r, k, v = r.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "logw_dtype":
        logw = logw.bfloat16()
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "state_shape":
        S0 = S0[:, :1]
    else:
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        K.rwkv6_scan(r, k, v, logw, u, S0)


# ---------------------------------------------------------------------------
# Time-mix, decode step and channel-mix against the JAX functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def timemix():
    jcfg = JModelConfig(**MODEL)
    jp = nonzero_adapters(j_init_params(jax.random.PRNGKey(0),
                                        JR.rwkv_specs(jcfg)), seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, MODEL["d_model"]).astype(np.float32)
    state = {"S": (0.2 * rng.randn(2, 2, 16, 16)).astype(np.float32),
             "x_prev": rng.randn(2, MODEL["d_model"]).astype(np.float32)}
    return jcfg, jp, x, state


@pytest.mark.parametrize("impl", [None, "ref", "chunked", "hopper"])
def test_rwkv_train_matches_jax(timemix, impl):
    jcfg, jp, x, state = timemix
    jctx = JCtx()
    want_y, want_s = JR.rwkv_train(jp, jnp.asarray(x), jcfg, ctx=jctx,
                                   state=jax.tree.map(jnp.asarray, state),
                                   chunk=8)
    y, s = R.rwkv_train(to_torch(jp), torch.from_numpy(x),
                        ModelConfig(**MODEL), ctx=Ctx(),
                        state=to_torch(state), chunk=8, impl=impl)
    tol = F32 if impl is None else OTHER_SCAN
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **tol)
    for key in ("S", "x_prev"):
        np.testing.assert_allclose(s[key].numpy(), np.asarray(want_s[key]),
                                   **tol)


def test_rwkv_decode_matches_jax(timemix):
    jcfg, jp, x, state = timemix
    x1 = x[:, :1]
    want_y, want_s = JR.rwkv_decode(jp, jnp.asarray(x1), jcfg, ctx=JCtx(),
                                    state=jax.tree.map(jnp.asarray, state))
    y, s = R.rwkv_decode(to_torch(jp), torch.from_numpy(x1),
                         ModelConfig(**MODEL), ctx=Ctx(),
                         state=to_torch(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
    for key in ("S", "x_prev"):
        np.testing.assert_allclose(s[key].numpy(), np.asarray(want_s[key]),
                                   **F32)


def test_channelmix_matches_jax(timemix):
    jcfg, _, x, _ = timemix
    jp = nonzero_adapters(j_init_params(jax.random.PRNGKey(4),
                                        JR.channelmix_specs(jcfg)), seed=5)
    shift = np.roll(x, 1, axis=1)
    want = JR.channelmix(jp, jnp.asarray(x), jnp.asarray(shift), jcfg)
    got = R.channelmix(to_torch(jp), torch.from_numpy(x),
                       torch.from_numpy(shift), ModelConfig(**MODEL))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# Layers, init laws, configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["rmsnorm", "mlp", "embed", "lm_logits"])
def test_layers_match_jax(op):
    rng = np.random.RandomState(6)
    cfg = dict(MODEL, tie_embeddings=(op == "embed"))
    jcfg, tcfg = JModelConfig(**cfg), ModelConfig(**cfg)
    x = rng.randn(2, 5, MODEL["d_model"]).astype(np.float32)
    tx = torch.from_numpy(x)
    if op == "rmsnorm":
        scale = rng.rand(MODEL["d_model"]).astype(np.float32)
        want = JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
        got = L.rmsnorm(tx, torch.from_numpy(scale))
    elif op == "mlp":
        jp = j_init_params(jax.random.PRNGKey(7), JL.mlp_specs(jcfg))
        want = JL.mlp(jp, jnp.asarray(x))
        got = L.mlp(to_torch(jp), tx)
    else:
        jp = j_init_params(jax.random.PRNGKey(8), JL.embed_specs(jcfg))
        if op == "embed":
            tokens = rng.randint(0, MODEL["vocab"], (2, 5)).astype(np.int32)
            want = JL.embed(jp, jnp.asarray(tokens), jcfg)
            got = L.embed(to_torch(jp), torch.from_numpy(tokens), tcfg)
        else:
            want = JL.lm_logits(jp, jnp.asarray(x), jcfg)
            got = L.lm_logits(to_torch(jp), tx, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("law", ["zeros", "ones", "rwkv_decay", "normal"])
def test_init_laws_match_reference(law):
    from repro.models.params import ParamSpec as JParamSpec
    shape, axes = (3, 64, 8), ("layers", "q_heads", "head_dim")
    jspec = JParamSpec(shape, axes, "float32", law)
    want = np.asarray(j_init_params(jax.random.PRNGKey(0), {"w": jspec})["w"])
    got = init_params(torch.Generator().manual_seed(0),
                      {"w": ParamSpec(shape, axes, "float32", law)}, "cpu")["w"]
    if law == "normal":      # other generators: the law, not the draws
        assert abs(got.std().item() * np.sqrt(3) - 1) < 0.1
        assert abs(want.std() * np.sqrt(3) - 1) < 0.1
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_param_count_and_config_match_reference():
    from repro.configs.registry import get_config as j_get_config
    from repro.models.params import param_count as j_param_count
    from repro.models.transformer import param_specs as j_param_specs
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import param_specs
    cfg, jcfg = get_config("rwkv6-7b"), j_get_config("rwkv6-7b")
    for f in dataclasses.fields(jcfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name) or \
            f.name == "memory", f.name
    assert param_count(param_specs(cfg)) == j_param_count(j_param_specs(jcfg))
