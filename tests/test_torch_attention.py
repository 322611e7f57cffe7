"""The attention slice of the port (``repro_torch.models.attention``,
``models.flash``'s forward, ``layers.apply_rope``, the ``("attn",
"dense")`` and ``("attn_local", "dense")`` layer kinds and the
tinyllama / llama3.2 / gemma3 / qwen2.5 serve path), held against the JAX
package on the same numpy inputs.

Tolerances:
* each function in float32 within ``1e-5 * max(1, max|ref|)`` of the
  reference's (the two differ in the order of f32 sums), on a ragged last
  query chunk, a sliding window with a banded KV strip, and grouped query
  heads (G > 1);
* reduced tinyllama-1.1b, llama3.2-3b, gemma3-1b (local layers with a
  ring of ``window`` = 16 slots, outgrown by the 24-token prompt) and
  qwen2.5-32b (a QKV bias) prefill and decode, the
  reference's weights carried over by ``params_from_jax``, under ``Ctx()``
  (the flash forward) and ``Ctx(flash=False)`` (query chunks): in float32
  every logit and every cache leaf within ``1e-4 * max(1, max|ref|)``, the
  cache positions and greedy tokens equal (observed: at most 4.7e-6 of
  the logits' and 7.4e-6 of a cache leaf's largest magnitude); in
  bfloat16, teacher-forced, at the full reduced depth, within 0.15 of the
  largest magnitude (ROADMAP C.2's envelope; the port keeps the residual
  sums unrounded where the reference's XLA fuses them into the next
  RMSNorm; observed: at most 0.023 of the logits' and 0.018 of k/v's,
  gemma3-1b's 14 layers with the chunked prefill).
The reference's serve CLI and engine fail on this jax (its sharder), so
the oracles call ``prefill`` / ``decode_step`` under a plain ``Ctx()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.flash import get_flash
from repro.models.layers import apply_rope as j_apply_rope
from repro.train import step as JS
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import (Executor, StaticSelector, UnifiedPolicy,
                                      disable_compile)
from repro_torch.launch import serve as SV
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import param_count
from repro_torch.train import step as S

ARCHS = ("tinyllama-1.1b", "llama3.2-3b", "gemma3-1b", "qwen2.5-32b")


@pytest.fixture(autouse=True)
def _eager(request):
    """Regions and layer ops run eagerly here (``disable_compile``), except
    in the tests that ask for the ``compiled`` fixture."""
    if "compiled" in request.fixturenames:
        yield
        return
    with disable_compile():
        yield


@pytest.fixture
def compiled():
    """Marks a test that compiles (the autouse fixture leaves it alone)."""


def within(got, want, rel):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [16, 64, 128])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta, head_dim):
    """f32 angles: rope_theta=500000 at position 1055 rounds as the
    reference's does, at the reduced head width and at tinyllama's and
    llama3.2's."""
    x = rand(2, 5, 3, head_dim, seed=1)
    pos = np.array([[0, 1, 7, 1055, 4095], [3, 100, 511, 1054, 1055]],
                   np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    within(apply_rope(t(x), t(pos), theta), want, 1e-5)
    # bf16 in, bf16 out, computed in f32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = apply_rope(xb, t(pos), theta)
    assert got.dtype == torch.bfloat16
    within(got.float(), j_apply_rope(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(pos), theta).astype(jnp.float32), 1e-2)


# ---------------------------------------------------------------------------
# Prefill attention: chunked and flash forward
# ---------------------------------------------------------------------------

# (Tq, Hq, Hkv, chunk, window): ragged last chunk, GQA G = 4 and 1, a
# band (a window is a causal mask), causal and not
_SHAPES = [(13, 4, 1, 5, 0), (16, 4, 2, 4, 0), (12, 2, 2, 12, 0),
           (40, 4, 2, 8, 6), (23, 6, 3, 7, 5), (9, 4, 1, 4, 16)]
CASES = [(*c, causal) for c in _SHAPES for causal in (True, False)
         if causal or not c[-1]]


def _qkv(Tq, Hq, Hkv, hd=8, B=2, seed=0):
    return (rand(B, Tq, Hq, hd, seed=seed), rand(B, Tq, Hkv, hd, seed=seed + 1),
            rand(B, Tq, Hkv, hd, seed=seed + 2))


@pytest.mark.parametrize("Tq,Hq,Hkv,chunk,window,causal", CASES)
def test_chunked_attention_matches_jax(Tq, Hq, Hkv, chunk, window, causal):
    q, k, v = _qkv(Tq, Hq, Hkv)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, chunk=chunk)
    got = A.chunked_attention(t(q), t(k), t(v), causal=causal, window=window,
                              chunk=chunk)
    within(got, want, 1e-5)


@pytest.mark.parametrize("Tq,Hq,Hkv,chunk,window,causal", CASES)
def test_flash_forward_matches_jax(Tq, Hq, Hkv, chunk, window, causal):
    q, k, v = _qkv(Tq, Hq, Hkv, seed=3)
    want = get_flash(causal, window, chunk)(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    got = flash_attention(t(q), t(k), t(v), causal=causal, window=window,
                          chunk=chunk)
    within(got, want, 1e-5)
    # mathematically the chunked softmax
    within(got, A.chunked_attention(t(q), t(k), t(v), causal=causal,
                                    window=window, chunk=chunk), 1e-5)


def test_grouped_logits_and_attend_match_jax():
    q, k, v = _qkv(6, 4, 2, seed=5)
    within(A._grouped_logits(t(q), t(k)),
           JA._grouped_logits(jnp.asarray(q), jnp.asarray(k)), 1e-5)
    mask = np.tril(np.ones((6, 6), bool))
    for m in (mask, None):
        want = JA._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if m is None else jnp.asarray(m))
        within(A._attend(t(q), t(k), t(v), None if m is None else t(m)),
               want, 1e-5)


# ---------------------------------------------------------------------------
# Decode: the cache
# ---------------------------------------------------------------------------

def _cache(B=2, slots=6, Hkv=2, hd=8, seed=7, filled=4):
    ck, cv = rand(B, slots, Hkv, hd, seed=seed), rand(B, slots, Hkv, hd,
                                                      seed=seed + 1)
    cpos = np.where(np.arange(slots) < filled, np.arange(slots), -1)
    return ck, cv, cpos.astype(np.int32)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("pos", [2, 3])
def test_decode_attend_matches_jax(window, pos):
    ck, cv, cpos = _cache()
    q1 = rand(2, 1, 4, 8, seed=9)
    want = JA.decode_attend(jnp.asarray(q1), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(cpos), jnp.int32(pos), window=window)
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        within(A.decode_attend(t(q1), t(ck), t(cv), t(cpos), p,
                               window=window), want, 1e-5)


@pytest.mark.parametrize("window,pos", [(0, 4), (0, 0), (4, 9), (4, 2)])
def test_cache_insert_matches_jax(window, pos):
    ck, cv, cpos = _cache(slots=6 if window == 0 else 4)
    k1, v1 = rand(2, 1, 2, 8, seed=11), rand(2, 1, 2, 8, seed=12)
    want = JA.cache_insert({"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                            "pos": jnp.asarray(cpos)},
                           jnp.asarray(k1), jnp.asarray(v1), pos,
                           window=window)
    got = A.cache_insert({"k": t(ck), "v": t(cv), "pos": t(cpos)}, t(k1),
                         t(v1), torch.tensor(pos, dtype=torch.int32),
                         window=window)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("window,T,slots", [(0, 5, 8), (0, 8, 8),
                                            (4, 10, 4), (4, 3, 4)])
def test_cache_fill_prefill_matches_jax(window, T, slots):
    """The bulk load, with the ring branch where a local layer's prompt
    outgrows its slots."""
    ck, cv, cpos = _cache(slots=slots, filled=0)
    k, v = rand(2, T, 2, 8, seed=13), rand(2, T, 2, 8, seed=14)
    want = JA.cache_fill_prefill({"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                                  "pos": jnp.asarray(cpos)},
                                 jnp.asarray(k), jnp.asarray(v),
                                 window=window)
    got = A.cache_fill_prefill({"k": t(ck), "v": t(cv), "pos": t(cpos)},
                               t(k), t(v), window=window)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["pos"].dtype == torch.int32


def test_cache_fill_prefill_refuses_a_prompt_beyond_the_cache():
    ck, cv, cpos = _cache(slots=4, filled=0)
    with pytest.raises(ValueError, match="does not fit"):
        A.cache_fill_prefill({"k": t(ck), "v": t(cv), "pos": t(cpos)},
                             t(rand(2, 5, 2, 8)), t(rand(2, 5, 2, 8)))


# ---------------------------------------------------------------------------
# The mixer: projections, RoPE, attend
# ---------------------------------------------------------------------------

def _configs(arch, dtype="float32", **over):
    over = dict(param_dtype=dtype, compute_dtype=dtype, **over)
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _mixer_params(jcfg, seed=0):
    p = {}
    for i, (name, s) in enumerate(sorted(JA.attn_specs(jcfg).items())):
        p[name] = rand(*s.shape, seed=seed + i, scale=0.3)
    return p


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv_and_out_proj_match_jax(qkv_bias):
    jcfg, cfg = _configs("tinyllama-1.1b", qkv_bias=qkv_bias)
    jspecs, specs = JA.attn_specs(jcfg), A.attn_specs(cfg)
    assert {k: (s.shape, s.dtype, s.init) for k, s in jspecs.items()} == \
        {k: (s.shape, s.dtype, s.init) for k, s in specs.items()}
    p = _mixer_params(jcfg)
    x = rand(2, 5, cfg.d_model, seed=20)
    want = JA.qkv({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                  jcfg)
    got = A.qkv({k: t(a) for k, a in p.items()}, t(x), cfg)
    for g, w in zip(got, want):
        within(g, w, 1e-5)
    o = rand(2, 5, cfg.n_heads, cfg.hd, seed=21)
    within(A.out_proj({"wo": t(p["wo"])}, t(o)),
           JA.out_proj({"wo": jnp.asarray(p["wo"])}, jnp.asarray(o)), 1e-5)


@pytest.mark.parametrize("ctx_kw", [{}, {"flash": False}, {"q_chunk": 5},
                                    {"q_chunk": 5, "flash": False}])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_prefill_and_decode_match_jax(arch, ctx_kw):
    jcfg, cfg = _configs(arch)
    p = _mixer_params(jcfg, seed=30)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: t(a) for k, a in p.items()}
    B, T_, slots = 2, 12, 16
    x = rand(B, T_, cfg.d_model, seed=31)
    z = np.zeros((B, slots, cfg.n_kv_heads, cfg.hd), np.float32)
    empty = np.full((slots,), -1, np.int32)
    jcache = {"k": jnp.asarray(z), "v": jnp.asarray(z),
              "pos": jnp.asarray(empty)}
    tcache = {"k": t(z), "v": t(z), "pos": t(empty)}
    jctx, tctx = JT.Ctx(mode="prefill", **ctx_kw), T.Ctx(mode="prefill",
                                                        **ctx_kw)
    wy, wc = JA.attn_prefill(jp, jnp.asarray(x), jcfg, kind="attn", ctx=jctx,
                             cache=jcache)
    gy, gc = A.attn_prefill(tp, t(x), cfg, kind="attn", ctx=tctx,
                            cache=tcache)
    within(gy, wy, 1e-5)
    for key in ("k", "v"):
        within(gc[key], wc[key], 1e-5)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    x1 = rand(B, 1, cfg.d_model, seed=32)
    wy, wc = JA.attn_decode(jp, jnp.asarray(x1), jcfg, kind="attn",
                            ctx=JT.Ctx(mode="decode", pos=jnp.int32(T_)),
                            cache=wc)
    gy, gc = A.attn_decode(tp, t(x1), cfg, kind="attn",
                           ctx=T.Ctx(mode="decode", pos=torch.tensor(T_)),
                           cache=gc)
    within(gy, wy, 1e-5)
    for key in ("k", "v"):
        within(gc[key], wc[key], 1e-5)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


# ---------------------------------------------------------------------------
# The model: reduced tinyllama / llama3.2 against the reference
# ---------------------------------------------------------------------------

B, PROMPT, GEN = 2, 24, 6


def _decode_both(arch, dtype, ctx_kw, teacher_forced, depth=None):
    """Prefill + GEN-1 decode steps on both sides from the reference's
    weights; returns per-step (reference, port) logits and tokens, and the
    final caches (port layout).  ``depth="cycle"`` cuts the reduced
    config to one layer cycle, and to no fewer than two layers."""
    jcfg, cfg = _configs(arch, dtype)
    if depth == "cycle":
        n = max(2, len(cfg.layer_cycle))
        jcfg, cfg = (dataclasses.replace(c, n_layers=min(c.n_layers, n))
                     for c in (jcfg, cfg))
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    jlog, jc = jax.jit(JS.make_prefill_step(jcfg, lambda: JT.Ctx(**ctx_kw)))(
        jp, {"tokens": jnp.asarray(prompts)},
        JT.init_cache(jcfg, B, PROMPT + GEN))
    tlog, tc = T.prefill(params, {"tokens": torch.from_numpy(prompts)}, cfg,
                         T.Ctx(**ctx_kw), T.init_cache(cfg, B, "cpu",
                                                       PROMPT + GEN))
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
                                 PROMPT + i, cfg, T.Ctx(**ctx_kw))
    return logits, tokens, cache_from_jax(jax.tree.map(np.asarray, jc), cfg,
                                          "cpu"), tc


@pytest.mark.parametrize("ctx_kw", [{}, {"flash": False}])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_float32(arch, ctx_kw):
    logits, tokens, jcache, tcache = _decode_both(arch, "float32", ctx_kw,
                                                  teacher_forced=False)
    for want, got in logits:
        within(got, want, 1e-4)
    for want, got in tokens:
        np.testing.assert_array_equal(got, want)
    kinds = T.layer_kinds(reduced(get_config(arch)))
    assert len(tcache) == len(jcache) == len(kinds)
    window = reduced(get_config(arch)).window
    for jl, tl, (mixer, _) in zip(jcache, tcache, kinds):
        assert set(tl) == {"k", "v", "pos"}
        for key in ("k", "v"):
            within(tl[key], jl[key], 1e-4)
        assert torch.equal(tl["pos"], jl["pos"])
        if mixer == "attn":
            assert tl["pos"].tolist() == list(range(PROMPT + GEN - 1)) + [-1]
        else:          # the ring: position p in slot p % window
            written = range(PROMPT + GEN - 1 - window, PROMPT + GEN - 1)
            assert sorted(tl["pos"].tolist()) == list(written)
            assert all(tl["pos"][p % window] == p for p in written)


@pytest.mark.parametrize("ctx_kw", [{}, {"flash": False}])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_bfloat16(arch, ctx_kw):
    """At the full reduced depth (gemma3-1b: 14 layers, two cycles of 5
    local layers and a global one, and two more).  The port rounds its
    residual stream where the reference's XLA computation does (ROADMAP
    C.2, repaired): before, the difference grew with depth, to 0.19 of
    k/v's largest magnitude and 0.13 of the logits' at gemma3's 14
    layers, so this test ran at one layer cycle."""
    logits, _, jcache, tcache = _decode_both(arch, "bfloat16", ctx_kw,
                                             teacher_forced=True)
    for want, got in logits:
        within(got, want, 0.15)
    for jl, tl in zip(jcache, tcache):
        for key in ("k", "v"):
            within(tl[key].float(), jl[key].float(), 0.15)


def test_llama_ties_embeddings_and_tinyllama_does_not():
    for arch, tied in (("llama3.2-3b", True), ("tinyllama-1.1b", False)):
        cfg = reduced(get_config(arch))
        assert cfg.tie_embeddings is tied
        params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
        assert ("head" in params["embed"]) is not tied


def test_full_configs_equal_the_reference():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(j_get_config(arch))
    cfg = get_config("tinyllama-1.1b")
    assert 1.09e9 < param_count(T.param_specs(cfg)) < 1.11e9


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-32b",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_new_configs_equal_the_reference_full_and_reduced(arch):
    """The configs of the later slices (local attention and the QKV bias;
    RG-LRU and MoE), field for field, at full size and reduced, with their
    layer plans and parameter counts."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(j_reduced(jcfg))
    assert T.layer_plan(cfg) == JT.layer_plan(jcfg)
    assert param_count(T.param_specs(cfg)) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(
            JT.param_specs(jcfg),
            is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "axes")))


def test_gemma3_local_layers_keep_a_ring_of_window_slots():
    cfg = get_config("gemma3-1b")
    assert 0.99e9 < param_count(T.param_specs(cfg)) < 1.01e9
    kinds = T.layer_kinds(cfg)
    assert kinds.count(("attn_local", "dense")) == 22
    assert kinds.count(("attn", "dense")) == 4
    cache = T.init_cache(cfg, 1, "meta", 1056)
    for (mixer, _), s in zip(kinds, cache):
        slots = 512 if mixer == "attn_local" else 1056
        assert s["k"].shape == (1, slots, 1, 256) and s["pos"].shape == \
            (slots,)
    rcfg = reduced(cfg)
    ops = T.layer_fns(rcfg, T.Ctx(mode="decode"))
    assert set(ops) == {("attn", "dense"), ("attn_local", "dense"), "head"}
    assert ops[("attn", "dense")] is not ops[("attn_local", "dense")]


def test_convert_carries_the_qkv_bias_leaves():
    jcfg, cfg = _configs("qwen2.5-32b")
    jp = JT.init(jax.random.PRNGKey(3), jcfg)
    # the reference initialises biases to zeros: give them values
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.25 if getattr(path[-1], "key", None) in
        ("bq", "bk", "bv") else a, jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jlayers = T.layers_of(cfg, jax.tree.map(np.asarray, jp))
    for tl, jl in zip(params["layers"], jlayers):
        for key in ("bq", "bk", "bv"):
            np.testing.assert_array_equal(tl["mixer"][key].numpy(),
                                          jl["mixer"][key])
            assert (tl["mixer"][key] == 0.25).all()
    assert len(params["layers"]) == cfg.n_layers


def test_cache_layout_and_refusals():
    cfg = reduced(get_config("tinyllama-1.1b"))
    cache = T.init_cache(cfg, 2, "cpu", 7)
    assert len(cache) == cfg.n_layers
    for layer in cache:
        assert layer["k"].shape == (2, 7, cfg.n_kv_heads, cfg.hd)
        assert layer["pos"].dtype == torch.int32
        assert (layer["pos"] == -1).all()
    with pytest.raises(ValueError, match="s_max"):
        T.init_cache(cfg, 2, "cpu")
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros(2, 3, cfg.d_model, dtype=torch.bfloat16)
    # train mode runs attention (attn_train, ROADMAP A.7 done) and returns
    # the MoE loss, 0 for a dense MLP; a mixer the port lacks still raises
    # (the whisper decoder's cross-attention, A.5.7; rglru is ported)
    y, new_cache, aux = T.layer_fwd(params["layers"][0], x, cfg, "attn",
                                    "dense", T.Ctx(mode="train"))
    assert y.shape == x.shape and new_cache is None and float(aux) == 0.0
    with pytest.raises(NotImplementedError, match="A.5.7"):
        T.layer_fwd(params["layers"][0], x, cfg, "attn_xdec", "dense",
                    T.Ctx(mode="train"))


# ---------------------------------------------------------------------------
# Layer ops, captured programs, the serve CLI
# ---------------------------------------------------------------------------

def _layer_case(mode, arch="llama3.2-3b", dtype="float32"):
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype,
                              compute_dtype=dtype)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = T.init_cache(cfg, 2, "cpu", 12)
    T_ = 9 if mode == "prefill" else 1
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (2, T_)).astype(np.int64))
    if mode == "decode":           # a prefilled cache to decode against
        _, cache = T.prefill(params, {"tokens": torch.randint(
            0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))},
            cfg, T.Ctx(), cache)
    return cfg, params, cache, tokens


@pytest.mark.parametrize("mode,flash", [("prefill", True),
                                        ("prefill", False),
                                        ("decode", True)])
def test_attention_layer_op_passes_opcheck(mode, flash):
    """Schema, fake implementation (the inputs' shapes, dtypes and layout;
    symbolic sizes included) and the layer run eagerly, in each mode."""
    cfg, params, cache, tokens = _layer_case(mode, dtype="bfloat16")
    op = T.layer_fns(cfg, T.Ctx(mode=mode, flash=flash))[("attn", "dense")]
    x = torch.from_numpy(rand(*tokens.shape, cfg.d_model, seed=3)).to(
        torch.bfloat16)
    pos = None if mode == "prefill" else torch.tensor(9, dtype=torch.int32)
    args = (T._leaves(params["layers"][1]), x,
            [cache[1][k] for k in op._cache_keys], pos)
    torch.library.opcheck(op.op, args)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-32b"])
def test_rows_and_head_ops_pass_opcheck(arch):
    """The rows op (a vmap rule's one node for all rows) and the head op:
    schema, fake implementation and the eager body; the rows op equals one
    solo call per row, and the head the inline final norm and logits."""
    cfg = reduced(get_config(arch))
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    ops = T.layer_fns(cfg, T.Ctx(mode="decode"))
    op, head = ops[("attn", "dense")], ops["head"]
    layer = next(i for i, (m, _) in enumerate(T.layer_kinds(cfg))
                 if m == "attn")
    cache = T.init_cache(cfg, 3, "cpu", 8)[layer]
    x = torch.from_numpy(rand(3, 1, 1, cfg.d_model, seed=4)).to(
        torch.bfloat16)
    # three rows, each a batch-1 cache
    rows = [T._leaves(params["layers"][layer]), x,
            [(cache[k][None].expand(3, -1) if k == "pos"
              else cache[k][:, None]).contiguous() for k in op._cache_keys],
            torch.tensor([2, 5, 7], dtype=torch.int32)]
    torch.library.opcheck(op.rows, rows)
    got = op.rows(*rows)
    for i in range(3):
        want = op.op(rows[0], rows[1][i], [c[i] for c in rows[2]],
                     rows[3][i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    hx = x[:, 0]
    hargs = ([params["final_norm"], params["embed"]["tok"] if
              cfg.tie_embeddings else params["embed"]["head"]], hx, [], None)
    torch.library.opcheck(head.op, hargs)
    assert torch.equal(head(params, hx), T._head(params, hx, cfg, T.Ctx()))


def test_attention_layer_ops_are_made_once_per_context():
    cfg = reduced(get_config("tinyllama-1.1b"))
    a = T.layer_fns(cfg, T.Ctx(mode="prefill"))
    # rwkv fields are not read by an attention layer: the same op
    assert T.layer_fns(cfg, T.Ctx(mode="prefill", rwkv_impl="hopper")) == a
    assert T.layer_fns(cfg, T.Ctx(mode="prefill", flash=False)) != a
    assert T.layer_fns(cfg, T.Ctx(mode="prefill", q_chunk=256)) != a


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_attention_layer_ops_equal_the_inline_layers(mode):
    cfg, params, cache, tokens = _layer_case(mode, dtype="bfloat16")
    if mode == "prefill":
        want = T.prefill(params, {"tokens": tokens}, cfg, T.Ctx(), cache)
        got = S.make_prefill_step(cfg)(params, {"tokens": tokens}, cache)
    else:
        want = T.decode_step(params, tokens[:, 0], cache, 9, cfg, T.Ctx())
        got = S.make_decode_step(cfg)(params, tokens[:, 0], cache, 9)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert list(g) == list(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_compiled_attention_step_compiles_each_layer_kind_once(mode,
                                                               compiled):
    """A compiled step's graph calls the attention layer op once per layer
    and nothing inline; the layer compiles once for all of them, the
    decode position an input (a second position recompiles nothing); the
    step agrees with the eager step within the region envelope (f32)."""
    cfg, params, cache, tokens = _layer_case(mode)
    cfg = dataclasses.replace(cfg, n_layers=3)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = T.init_cache(cfg, 2, "cpu", 12)
    op = T.layer_fns(cfg, T.Ctx(mode=mode))[("attn", "dense")]
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    if mode == "prefill":
        step = S.make_prefill_step(cfg)
        calls = [(params, {"tokens": tokens}, cache)]
    else:
        step = S.make_decode_step(cfg)
        calls = [(params, tokens[:, 0], cache, SV.position(p))
                 for p in (3, 4)]
    cstep = torch.compile(step, fullgraph=True, backend=backend)
    for args in calls:
        got = cstep(*args)
        with disable_compile():
            want = step(*args)
        torch.testing.assert_close(got[0], want[0], rtol=3e-4, atol=1e-4)
        for g, w in zip(got[1], want[1]):
            for k in w:
                torch.testing.assert_close(g[k], w[k], rtol=3e-4, atol=1e-4)
    targets = [str(n.target) for n in graphs[-1].graph.nodes
               if n.op == "call_function"]
    assert targets.count(f"repro_torch.{op.label}.default") == cfg.n_layers
    assert sum("einsum" in t or "matmul" in t for t in targets) <= 1
    assert len(graphs) == 1 and op.stats.compiles == 1


def _served(arch="tinyllama-1.1b"):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    return cfg, params, {"tokens": prompts}


@pytest.mark.parametrize("arch", ARCHS)
def test_replay_tokens_equal_uncaptured_path(arch):
    cfg, params, batch = _served(arch)
    ex = Executor(UnifiedPolicy(selector=StaticSelector("hopper")),
                  Ledger("attn_serve"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    gen = 5
    prog = SV.capture_prefill_program(regions, batch,
                                      T.init_cache(cfg, 2, "cpu", 8 + gen))
    tok, cache = prog.replay(ex, batch, T.init_cache(cfg, 2, "cpu", 8 + gen))
    dprog = SV.capture_decode_program(regions, 8, gen, tok, cache)
    toks = dprog.replay(ex, tok, cache)
    prefill, decode, make_cache = SV.build_server(cfg, 2, "cpu",
                                                  max_len=8 + gen)
    logits, cache_j = prefill(params, batch, make_cache())
    toks_j, _ = SV.decode_stream(decode, params, SV.greedy(logits), cache_j,
                                 8, gen)
    assert torch.equal(torch.stack(toks, 1), torch.stack(toks_j, 1))
    assert dprog.n_constants == gen - 1            # the frozen positions


def test_replay_batch_of_the_attention_decode_program_equals_solo_replays():
    """Two request groups through the vmapped decode program equal each
    group's solo replay (the layer op's vmap rule, the position an
    unbatched constant)."""
    import types
    cfg, params, _ = _served()
    ex = Executor(UnifiedPolicy(), Ledger("attn_groups"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    prefill, _, make_cache = SV.build_server(cfg, 2, "cpu", max_len=8 + 3)
    logits, cache = prefill(params, _served()[2], make_cache())
    prog = SV.capture_decode_program(regions, 8, 3, SV.greedy(logits), cache)
    args = types.SimpleNamespace(seed=0, batch=2, prompt_len=8, gen=3)
    seqs, solo, _ = SV.replay_request_groups(cfg, ex, prog, prefill,
                                             make_cache, params, args, 2,
                                             "cpu")
    assert seqs.shape == (2, 2, 3)
    assert torch.equal(seqs, solo)
    assert not torch.equal(solo[0], solo[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_an_attention_arch_on_cpu(arch, capsys):
    """Under the unified policy the CLI asserts the replayed tokens equal
    the uncaptured path's."""
    seq = SV.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--prompt-len", "16", "--gen", "4", "--report"])
    out = capsys.readouterr().out
    assert seq.shape == (4, 4) and seq.dtype == torch.int32
    assert f"[serve] {arch} (reduced) [unified, hopper, cpu]" in out
    assert '"impl_counts"' in out


@pytest.mark.parametrize("arch,carries", [
    ("gemma3-1b", {0, 6, 12}),                 # 2 cycles of 6, 2 more
    ("tinyllama-1.1b", {0, 1, 2}),             # a cycle of 1: every layer
    ("recurrentgemma-9b", {0, 3, 6}),          # 2 cycles of 3, 2 more
])
def test_stream_rounds_at_the_reference_scan_carries(arch, carries):
    """ROADMAP C.2: the residual stream is rounded to the compute dtype at
    the reference's scan carries (each cycle's start, the remainder's
    start, the scan's end) and stays the unrounded f32 sum elsewhere."""
    cfg = reduced(get_config(arch))
    x = torch.full((1, 1, 4), 1.0 + 2.0 ** -12)       # not a bf16 value
    rounded = {i for i in range(cfg.n_layers + 1)
               if not torch.equal(T._carry(x, cfg, i), x)}
    assert rounded == carries
    assert T._carry(x, cfg, 1).dtype == torch.float32
