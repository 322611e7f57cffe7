"""The RG-LRU slice of the port (``repro_torch.models.rglru``, the
``("rglru", "dense")`` layer kind and recurrentgemma-9b), held against
the JAX package on the same numpy inputs.

Tolerances:
* ``_conv1d``, ``_gates`` and ``rglru_decode`` in float32 within ``1e-5 *
  max(1, max|ref|)`` of the reference's (the two differ in the order of
  f32 sums of a product);
* ``rglru_train`` (the log-depth scan, with and without a carried state)
  in float32 within ``1e-5 * max(1, max|ref|)`` of the reference's
  ``associative_scan`` (the two trees round differently), and within the
  same of the port's sequential ``rglru_ref`` and of ``T`` decode steps;
  ``linear_scan`` in float64 within 1e-12 of the sequential recurrence;
* reduced recurrentgemma-9b (8 layers: two cycles of ``rglru, rglru,
  attn_local`` and two more RG-LRU layers; a ring of ``window`` = 16
  slots outgrown by the 24-token prompt) prefill and decode: in float32
  every logit and every state leaf within ``1e-4 * max(1, max|ref|)``,
  the greedy tokens equal; in bfloat16, teacher forced, within 0.15 of
  the largest magnitude (ROADMAP C.2; observed 0.0144 of the logits' and
  0.0554 of a state leaf's, h);
* ``value_and_grad`` of ``loss_fn`` against ``jax.value_and_grad`` at one
  layer cycle: the loss within 1e-5 relative; every gradient leaf, against
  its own largest magnitude, within the larger of 1e-4 and 4 times the
  reference's own f32 distance to its float64 gradient on that leaf (the
  random f32 init is steep: the loss is ~25 and both f32 stacks sit
  ~2e-3 from the f64 gradient, as gemma3-1b does in
  tests/test_torch_train.py).
The oracles call the reference under a plain ``Ctx()`` (its sharder fails
on this jax, ROADMAP "Reference limits").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs.reduced import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import rglru as JG
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.regions import disable_compile
from repro_torch.launch import serve as SV
from repro_torch.launch import train as LT
from repro_torch.models import rglru as G
from repro_torch.models import transformer as T
from repro_torch.train import step as S
from test_torch_attention import _decode_both, within
from test_torch_train import (_as_port, _leaf_errs, _params,
                              _reference_grads_f64, _tokens)

ARCH = "recurrentgemma-9b"


@pytest.fixture(autouse=True)
def _eager():
    with disable_compile():
        yield


def _configs(dtype="float32", **over):
    over = dict(param_dtype=dtype, compute_dtype=dtype, **over)
    return (dataclasses.replace(j_reduced(j_get_config(ARCH)), **over),
            dataclasses.replace(reduced(get_config(ARCH)), **over))


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _mixer_params(jcfg, seed=0):
    """Random f32 values for every leaf of ``rglru_specs`` (the biases too,
    which the reference initialises to zeros)."""
    return {name: rand(*s.shape, seed=seed + i, scale=0.3)
            for i, (name, s) in enumerate(sorted(
                JG.rglru_specs(jcfg).items()))}


def _both(p):
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: torch.from_numpy(a) for k, a in p.items()})


def _state(cfg, B, seed):
    w = cfg.rnn_width or cfg.d_model
    return {"h": rand(B, w, seed=seed), "conv": rand(
        B, cfg.conv_width - 1, w, seed=seed + 1)}


def test_specs_equal_the_reference():
    jcfg, cfg = _configs()
    for jspecs, specs in ((JG.rglru_specs(jcfg), G.rglru_specs(cfg)),
                          (JG.rglru_state_specs(jcfg, 3),
                           G.rglru_state_specs(cfg, 3))):
        assert {k: (s.shape, s.axes, s.dtype, s.init, s.scale)
                for k, s in jspecs.items()} == \
            {k: (s.shape, s.axes, s.dtype, s.init, s.scale)
             for k, s in specs.items()}


def test_conv1d_and_gates_match_jax():
    jcfg, cfg = _configs()
    jp, tp = _both(_mixer_params(jcfg, seed=1))
    x = rand(2, 7, cfg.rnn_width, seed=2)
    st = rand(2, cfg.conv_width - 1, cfg.rnn_width, seed=3)
    want, want_state = JG._conv1d(jp, jnp.asarray(x), jnp.asarray(st))
    got, got_state = G._conv1d(tp, torch.from_numpy(x), torch.from_numpy(st))
    within(got, want, 1e-5)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))
    assert got_state.is_contiguous()
    for g, w in zip(G._gates(tp, got), JG._gates(jp, want)):
        within(g, w, 1e-5)


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_train_matches_jax_ref_and_decode_steps(carried):
    """The log-depth scan against the reference's associative scan, the
    port's sequential oracle and T one-token decode steps from the same
    state (or from zeros)."""
    jcfg, cfg = _configs()
    jp, tp = _both(_mixer_params(jcfg, seed=10))
    B, T_ = 2, 13                       # 14 elements: a ragged last doubling
    x = rand(B, T_, cfg.d_model, seed=11)
    st = _state(cfg, B, seed=12) if carried else None
    jst = None if st is None else {k: jnp.asarray(a) for k, a in st.items()}
    tst = None if st is None else {k: torch.from_numpy(a)
                                   for k, a in st.items()}
    wy, ws = JG.rglru_train(jp, jnp.asarray(x), jcfg, ctx=JT.Ctx(),
                            state=jst)
    gy, gs = G.rglru_train(tp, torch.from_numpy(x), cfg, ctx=T.Ctx(),
                           state=tst)
    within(gy, wy, 1e-5)
    for k in ("h", "conv"):
        within(gs[k], ws[k], 1e-5)
    within(gy, G.rglru_ref(tp, torch.from_numpy(x), cfg, tst), 1e-5)
    within(gy, JG.rglru_ref(jp, jnp.asarray(x), jcfg, jst), 1e-5)
    state = tst or {k: torch.from_numpy(np.zeros_like(a)) for k, a in
                    _state(cfg, B, 0).items()}
    steps = []
    for t in range(T_):
        y1, state = G.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg,
                                   ctx=T.Ctx(mode="decode"), state=state)
        steps.append(y1)
    within(gy, torch.cat(steps, 1), 1e-5)
    for k in ("h", "conv"):
        within(gs[k], state[k], 1e-5)


def test_rglru_decode_matches_jax():
    jcfg, cfg = _configs()
    jp, tp = _both(_mixer_params(jcfg, seed=20))
    x1 = rand(3, 1, cfg.d_model, seed=21)
    st = _state(cfg, 3, seed=22)
    wy, ws = JG.rglru_decode(jp, jnp.asarray(x1), jcfg, ctx=JT.Ctx(),
                             state={k: jnp.asarray(a) for k, a in st.items()})
    gy, gs = G.rglru_decode(tp, torch.from_numpy(x1), cfg, ctx=T.Ctx(),
                            state={k: torch.from_numpy(a)
                                   for k, a in st.items()})
    within(gy, wy, 1e-5)
    for k in ("h", "conv"):
        within(gs[k], ws[k], 1e-5)


@pytest.mark.parametrize("L", [1, 2, 5, 8, 33])
def test_linear_scan_is_the_recurrence(L):
    rng = np.random.RandomState(L)
    a = torch.from_numpy(rng.rand(2, L, 3))
    b = torch.from_numpy(rng.randn(2, L, 3))
    _, h = G.linear_scan(a, b)
    want, acc = [], torch.zeros(2, 3, dtype=torch.float64)
    for t in range(L):
        acc = a[:, t] * acc + b[:, t]
        want.append(acc)
    assert (h - torch.stack(want, 1)).abs().max() <= 1e-12


# ---------------------------------------------------------------------------
# The model: reduced recurrentgemma-9b against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx_kw", [{}, {"flash": False}])
def test_prefill_and_decode_match_jax_float32(ctx_kw):
    logits, tokens, jcache, tcache = _decode_both(ARCH, "float32", ctx_kw,
                                                  teacher_forced=False)
    for want, got in logits:
        within(got, want, 1e-4)
    for want, got in tokens:
        np.testing.assert_array_equal(got, want)
    kinds = T.layer_kinds(reduced(get_config(ARCH)))
    assert [m for m, _ in kinds] == ["rglru", "rglru", "attn_local"] * 2 + \
        ["rglru"] * 2
    assert len(tcache) == len(jcache) == len(kinds)
    for jl, tl, (mixer, _) in zip(jcache, tcache, kinds):
        if mixer == "rglru":
            assert set(tl) == {"h", "conv"}
            assert tl["h"].dtype == torch.float32
        for key in jl:
            if key == "pos":
                assert torch.equal(tl[key], jl[key])
            else:
                within(tl[key], jl[key], 1e-4)


@pytest.mark.parametrize("ctx_kw", [{}, {"flash": False}])
def test_prefill_and_decode_match_jax_bfloat16(ctx_kw):
    """At the full reduced depth (8 layers)."""
    logits, _, jcache, tcache = _decode_both(ARCH, "bfloat16", ctx_kw,
                                             teacher_forced=True)
    for want, got in logits:
        within(got, want, 0.15)
    for jl, tl in zip(jcache, tcache):
        for key in jl:
            if key != "pos":
                within(tl[key].float(), jl[key].float(), 0.15)


def test_cache_layout_holds_the_state_per_row():
    cfg = reduced(get_config(ARCH))
    cache = T.init_cache(cfg, 3, "cpu", 20)
    for layer, (mixer, _) in zip(cache, T.layer_kinds(cfg)):
        if mixer == "rglru":
            assert layer["h"].shape == (3, cfg.rnn_width)
            assert layer["h"].dtype == torch.float32
            assert layer["conv"].shape == (3, cfg.conv_width - 1,
                                           cfg.rnn_width)
            assert layer["conv"].dtype == torch.bfloat16
        else:
            assert layer["k"].shape[1] == cfg.window
    ops = T.layer_fns(cfg, T.Ctx(mode="decode"))
    assert set(ops) == {("rglru", "dense"), ("attn_local", "dense"), "head"}
    assert ops[("rglru", "dense")].shared == {}


def test_rglru_layer_op_passes_opcheck():
    cfg = reduced(get_config(ARCH))
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for mode, tlen in (("prefill", 9), ("decode", 1)):
        op = T.layer_fns(cfg, T.Ctx(mode=mode))[("rglru", "dense")]
        cache = T.init_cache(cfg, 2, "cpu", 16)[0]
        cache = {k: v + 0.1 for k, v in cache.items()}
        x = torch.from_numpy(rand(2, tlen, cfg.d_model, seed=5)).to(
            torch.bfloat16)
        pos = None if mode == "prefill" else torch.tensor(9,
                                                         dtype=torch.int32)
        torch.library.opcheck(op.op, (T._leaves(params["layers"][0]), x,
                                      [cache[k] for k in op._cache_keys],
                                      pos))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax_value_and_grad():
    jcfg, cfg = (dataclasses.replace(c, n_layers=len(c.layer_cycle))
                 for c in _configs())
    jp, params = _params(jcfg, cfg)
    toks = _tokens(cfg)
    (jl, (jce, _)), jg = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, JT.Ctx(mode="train"))
    (loss, (ce, aux)), grads = S.value_and_grad(
        params, {"tokens": torch.from_numpy(toks)}, cfg, T.Ctx(mode="train"))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(ce) - float(jce)) <= 1e-5 * abs(float(jce))
    assert float(aux) == 0.0

    def f64(tree):
        return pytree.tree_map(lambda t: t.double(), tree)
    want = _reference_grads_f64(jcfg, cfg, jp, toks)
    errs = _leaf_errs(f64(grads), want)
    spread = _leaf_errs(f64(_as_port(jg, cfg)), want)
    bounds = [max(1e-4, 4 * s) for s in spread]
    names = [pytree.keystr(k) for k, _ in
             pytree.tree_flatten_with_path(grads)[0]]
    bad = [(n, e, b) for n, e, b in zip(names, errs, bounds) if e > b]
    assert not bad, bad


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_serve_and_train_clis_run_on_cpu(capsys):
    seq = SV.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--prompt-len", "20", "--gen", "4"])
    assert seq.shape == (4, 4)
    losses = LT.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--layers", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (reduced)" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
