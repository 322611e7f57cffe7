"""The serve slice of the port as a whole, held against the JAX package:
prefill + greedy decode of reduced ``rwkv6-7b`` against
``repro.models.transformer.prefill`` / ``decode_step`` under a plain
``Ctx()`` (the reference's ``make_sharder`` fails on this jax, so its
``serve.main`` cannot be the oracle), captured programs against the
uncaptured path under both policies, and the CLI.

Tolerances:
* float32: every logit and every state tensor (S, x_prev, x_cm) within
  1e-4 * max(1, its largest magnitude) of the reference (observed: 4e-6
  of the logits' and 2.3e-6 of S's largest magnitude; the two frameworks
  differ only in the order of float32 sums), and equal greedy tokens.
* bfloat16: within 0.15 of the largest magnitude of each compared tensor,
  with the reference's tokens fed to both sides.  XLA fuses chains of
  elementwise ops and rounds to bf16 only at the end of each fusion, the
  port rounds after every op; a one-ulp difference (2^-8) in a layer's
  output is amplified by the next layers' random weights (initialised at
  the reference's stacked scale, 1/sqrt(layer count)).  Observed: at most
  0.10 of max|logits| and 0.08 of max|S| over four seeds.  Greedy tokens
  are not compared in bf16: one flip sends the two decodes apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.regions import Executor, StaticSelector
from repro_torch.launch import serve as SV
from repro_torch.launch.policy import lm_policy
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.core.regions import disable_compile


@pytest.fixture(autouse=True)
def _eager():
    """Regions run eagerly here (``disable_compile``, the counterpart of
    ``jax.disable_jit()``): compiling every region would cost seconds per
    test on the CPU.  Compiled executables are tested in
    tests/test_torch_compile.py."""
    with disable_compile():
        yield


B, PROMPT, GEN = 2, 32, 8


def within(got, want, rel):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def nonzero_adapters(tree, seed):
    """The reference's params with ``u``, ``mu_*`` and ``B_*`` made
    nonzero (their inits are zero and would hide their terms)."""
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


def _configs(dtype):
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(j_reduced(j_get_config("rwkv6-7b")), **over),
            dataclasses.replace(reduced(get_config("rwkv6-7b")), **over))


def _decode_both(dtype, impl, teacher_forced):
    """Prefill + GEN-1 decode steps on both sides; returns per-step logits
    and tokens of each side, and the final caches (port layout)."""
    jcfg, cfg = _configs(dtype)
    jp = jax.tree.map(jnp.asarray, nonzero_adapters(
        JT.init(jax.random.PRNGKey(0), jcfg), seed=1))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (B, PROMPT))
    prompts = prompts.astype(np.int32)
    jlog, jc = jax.jit(JS.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(prompts)},
        JT.init_cache(jcfg, B, PROMPT + GEN))
    tlog, tc = T.prefill(params, {"tokens": torch.from_numpy(prompts)}, cfg,
                         T.Ctx(rwkv_impl=impl), T.init_cache(cfg, B, "cpu"))
    jdec = jax.jit(JS.make_decode_step(jcfg))
    logits, tokens = [], []
    for i in range(GEN):
        jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1), np.int32)
        ttok = SV.greedy(tlog).numpy()
        logits.append((np.asarray(jlog, np.float32), tlog.float().numpy()))
        tokens.append((jtok, ttok))
        if i == GEN - 1:
            break
        feed = (jtok if teacher_forced else ttok).copy()
        jlog, jc = jdec(jp, jnp.asarray(jtok), jc, jnp.int32(PROMPT + i))
        tlog, tc = T.decode_step(params, torch.from_numpy(feed), tc,
                                 PROMPT + i, cfg, T.Ctx())
    return logits, tokens, cache_from_jax(jax.tree.map(np.asarray, jc), cfg,
                                          "cpu"), tc


@pytest.mark.parametrize("impl", [None, "hopper"])
def test_prefill_and_decode_match_jax_float32(impl):
    """Ctx.rwkv_impl=None runs the reference's own chunked form;
    "hopper" runs K5's plain version here (CPU tensors)."""
    logits, tokens, jcache, tcache = _decode_both("float32", impl,
                                                  teacher_forced=False)
    for want, got in logits:
        within(got, want, 1e-4)
    for want, got in tokens:
        np.testing.assert_array_equal(got, want)
    assert len(tcache) == len(jcache) == 2
    for jl, tl in zip(jcache, tcache):
        assert set(tl) == {"S", "x_prev", "x_cm"}
        for key in tl:
            within(tl[key].float(), jl[key].float(), 1e-4)


def test_prefill_and_decode_match_jax_bfloat16():
    logits, _, jcache, tcache = _decode_both("bfloat16", "hopper",
                                             teacher_forced=True)
    for want, got in logits:
        within(got, want, 0.15)
    for jl, tl in zip(jcache, tcache):
        within(tl["S"], jl["S"], 0.15)


# ---------------------------------------------------------------------------
# Captured programs against the uncaptured path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = reduced(get_config("rwkv6-7b"))
    gen = torch.Generator().manual_seed(0)
    params = T.init(gen, cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                            dtype=torch.int32)
    return cfg, params, {"tokens": prompts}


@pytest.mark.parametrize("impl", ["ref", "hopper"])
@pytest.mark.parametrize("policy", ["unified", "discrete"])
def test_replay_tokens_equal_uncaptured_path(served, policy, impl):
    cfg, params, batch = served
    ex = Executor(lm_policy(policy, selector=StaticSelector(impl),
                            device="cpu"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    prog = SV.capture_prefill_program(regions, batch,
                                      T.init_cache(cfg, B, "cpu"))
    tok, cache = prog.replay(ex, batch, T.init_cache(cfg, B, "cpu"))
    dprog = SV.capture_decode_program(regions, PROMPT, GEN, tok, cache)
    toks = dprog.replay(ex, tok, cache)

    prefill, decode, make_cache = SV.build_server(
        cfg, B, "cpu", rwkv_impl=SV.PREFILL_RWKV_IMPL[impl])
    logits, cache_j = prefill(params, batch, make_cache())
    toks_j, _ = SV.decode_stream(decode, params, SV.greedy(logits), cache_j,
                                 PROMPT, GEN)
    assert torch.equal(torch.stack(toks, 1), torch.stack(toks_j, 1))
    rows = ex.ledger.regions
    assert rows["PREFILL"].impl_counts == {impl: 1}
    assert rows["DECODE_STEP"].impl_counts == {"ref": GEN - 1}
    rep = ex.report()
    assert (rep["staging_fraction"] > 0) == (policy == "discrete")


def test_captured_programs_record_the_dataflow(served):
    cfg, params, batch = served
    regions = SV.make_serve_regions(cfg, params)
    prog = SV.capture_prefill_program(regions, batch,
                                      T.init_cache(cfg, B, "cpu"))
    n_state = 3 * cfg.n_layers                 # S, x_prev, x_cm per layer
    assert len(prog) == 2 and prog.n_inputs == 1 + n_state
    tok, cache = prog.replay(Executor(lm_policy("unified")), batch,
                             T.init_cache(cfg, B, "cpu"))
    dprog = SV.capture_decode_program(regions, PROMPT, GEN, tok, cache)
    assert len(dprog) == 2 * (GEN - 1)
    # positions are frozen constants; everything else flows by Ref/In
    assert dprog.n_constants == GEN - 1
    assert "14 ops" in dprog.summary()
    with pytest.raises(ValueError, match="structure"):
        dprog.replay(Executor(lm_policy("unified")), tok, cache[:1])


def test_decode_replay_holds_two_states_not_one_per_token(served):
    """Replay drops each output after its last reader: while the decode
    loop runs, at most the previous and the current state are alive."""
    import weakref
    cfg, params, batch = served
    ex = Executor(lm_policy("unified"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    tok, cache = SV.capture_prefill_program(
        regions, batch, T.init_cache(cfg, B, "cpu")).replay(
            ex, batch, T.init_cache(cfg, B, "cpu"))
    dprog = SV.capture_decode_program(regions, PROMPT, GEN, tok, cache)
    states, alive = [], []

    class Spy:
        def run(self, r, *args, **kwargs):
            out = ex.run(r, *args, **kwargs)
            if r is regions.decode_step:
                states.append(weakref.ref(out[1][0]["S"]))
                alive.append(sum(s() is not None for s in states))
            return out
    toks = dprog.replay(Spy(), tok, cache)
    assert len(toks) == GEN and max(alive) <= 2


def test_prefill_state_holds_no_activations(served):
    """The state after prefill owns its [B, d] rows; a view of the
    [B, T, d] activations would keep all of them alive (2.1 GB at the
    full width of rwkv6-7b with a 4x1024 prompt)."""
    cfg, params, batch = served
    _, cache = T.prefill(params, batch, cfg, T.Ctx(),
                         T.init_cache(cfg, B, "cpu"))
    for layer in cache:
        for key in ("x_prev", "x_cm", "S"):
            t = layer[key]
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_cli_runs_on_cpu(capsys):
    seq = SV.main(["--reduced", "--device", "cpu", "--impl", "ref",
                   "--prompt-len", "32", "--gen", "4", "--report"])
    out = capsys.readouterr().out
    assert seq.shape == (4, 4) and seq.dtype == torch.int32
    assert "[serve] rwkv6-7b (reduced) [unified, ref, cpu]" in out
    assert '"impl_counts"' in out


def test_replay_request_groups_returns_every_groups_solo_replay():
    """``replay_request_groups`` (the ``--replay-batch`` path) replays each
    group alone as well: in f32 the batched tokens equal every group's solo
    replay, and each group starts from its own prefill's token."""
    import types
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.regions import UnifiedPolicy
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b")),
                              param_dtype="float32", compute_dtype="float32")
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    ex = Executor(UnifiedPolicy(), Ledger("groups"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    prefill, _, make_cache = SV.build_server(cfg, 2, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    logits, cache = prefill(params, {"tokens": prompts}, make_cache())
    prog = SV.capture_decode_program(regions, 8, 3, SV.greedy(logits), cache)
    args = types.SimpleNamespace(seed=0, batch=2, prompt_len=8, gen=3)
    seqs, solo, dt = SV.replay_request_groups(cfg, ex, prog, prefill,
                                              make_cache, params, args, 2,
                                              "cpu")
    assert seqs.shape == solo.shape == (2, 2, 3) and dt > 0
    assert torch.equal(seqs, solo)
    assert not torch.equal(solo[0], solo[1])


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-large-v3",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_registry_refuses_archs_not_ported(arch):
    """The registry refuses exactly the archs whose mixers wait, naming
    their ROADMAP item (M-RoPE A.5.6, the whisper encoder A.5.7); the
    RG-LRU and MoE archs of A.5.4/A.5.5 resolve to the reference's
    config."""
    assert j_get_config(arch) is not None         # known to the reference
    item = {"qwen2-vl-72b": "A.5.6", "whisper-large-v3": "A.5.7"}.get(arch)
    if item is None:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(j_get_config(arch))
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.5\b"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match=item):
        get_config(arch)
