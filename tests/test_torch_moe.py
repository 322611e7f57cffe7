"""The MoE slice of the port (``repro_torch.models.moe``: the group-local
dispatch, the dense oracle, ``ExpertPager`` and ``moe_decode_paged``; the
``("attn", "moe")`` layer kind; qwen3-moe-30b-a3b and
llama4-scout-17b-a16e), held against the JAX package on the same numpy
inputs.

Tolerances:
* ``moe_mlp`` and ``moe_ref`` in float32: outputs within ``1e-5 *
  max(1, max|ref|)`` of the reference's, ``aux`` within 1e-6 relative;
  the expert ids and the kept pairs are equal, not close (reduced
  qwen3-moe-30b-a3b; the sparse variant of ``benchmarks/run.py``'s
  oversubscription figure, 16 experts, top-2; a router biased so that
  capacity drops occur; llama4-scout's shared expert); a tied router
  resolves its ties as ``jax.lax.top_k`` does (descending, the lower
  index first);
* the pager: budgeted at ratios 1, 2 and 4 and with the lookahead off,
  bit for bit the unbudgeted run; its paging counts equal to the
  reference pager's on the same inputs (12 fetches, 4 hits, 8 evictions,
  5 prefetch hits at ratio 4 on ``benchmarks/run.py``'s setup); bf16
  outputs within 2e-2 of the largest magnitude of the reference's and of
  the port's ``moe_ref``;
* reduced qwen3-moe-30b-a3b and llama4-scout-17b-a16e prefill and decode:
  in float32 every logit and cache leaf within ``1e-4 * max(1, max|ref|)``
  and the greedy tokens equal; in bfloat16 (two layers), teacher forced,
  within 0.15 of the largest magnitude (ROADMAP C.2; observed: at most
  1e-4 of the logits' and 0.0017 of k/v's);
* ``value_and_grad``: the loss and the MoE loss within 1e-5 relative;
  each gradient leaf within 2e-4 of its own largest magnitude of the
  reference's f32 gradient (each f32 stack within 1e-4 of the exact
  gradient, the bound of tests/test_torch_train.py: the reference cannot
  give its float64 gradient here, because its scan carries the MoE loss
  as f32 while x64 makes it f64); the MoE loss with remat on equal to
  remat off.
The oracles call the reference under a plain ``Ctx()`` and its pager with
``host_space=MemSpace.DEVICE`` (its default host space fails on this jax:
ROADMAP "Reference limits").
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
from repro.core.ledger import Ledger as JLedger
from repro.core.oversub import MemoryBudget as JMemoryBudget
from repro.core.umem import MemSpace as JMemSpace
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.params import init_params as j_init_params
from repro.train import step as JS
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.oversub import MemoryBudget
from repro_torch.core.regions import disable_compile
from repro_torch.launch import serve as SV
from repro_torch.launch import train as LT
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import _tensor
from repro_torch.train import step as S
from test_torch_attention import _decode_both, within
from test_torch_train import _as_port, _leaf_errs, _params, _tokens

ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True)
def _eager():
    with disable_compile():
        yield


def _configs(arch, **over):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _sparse(c):
    """``benchmarks/run.py``'s sparse router: 16 experts, top-2, d_ff 32."""
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, n_experts=16, top_k=2, d_ff=32))


def _moe_params(jcfg, seed=0):
    """The reference's MoE parameters (its initialiser), as numpy."""
    p = j_init_params(jax.random.PRNGKey(seed), JM.moe_specs(jcfg))
    return jax.tree.map(np.array, p)            # writable copies


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_port(tree):
    return pytree.tree_map(lambda a: _tensor(a, "cpu"), tree)


def _keep_oracle(idx, C):
    """numpy: for each group's pairs in token-major order, whether the
    pair is within its expert's capacity (its rank among the group's
    earlier pairs of that expert)."""
    G, Tg, k = idx.shape
    fe = idx.reshape(G, Tg * k)
    keep = np.zeros(fe.shape, bool)
    for g in range(G):
        seen = {}
        for q, e in enumerate(fe[g]):
            keep[g, q] = seen.get(e, 0) < C
            seen[e] = seen.get(e, 0) + 1
    return keep


CASES = {
    "qwen3": lambda: _configs("qwen3-moe-30b-a3b", **F32),
    "sparse": lambda: tuple(_sparse(c) for c in
                            _configs("qwen3-moe-30b-a3b", **F32)),
    "drops": lambda: tuple(_sparse(c) for c in
                           _configs("qwen3-moe-30b-a3b", **F32)),
    "llama4": lambda: _configs("llama4-scout-17b-a16e", **F32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_jax(case):
    """4 x 64 tokens: 16 groups of 16."""
    jcfg, cfg = CASES[case]()
    p = _moe_params(jcfg, seed=1)
    if case == "drops":
        # most tokens prefer experts 0 and 1: more of their pairs in a
        # group than its capacity
        p["router"][:, :2] += 2.0
    x = np.random.RandomState(2).randn(4, 64, cfg.d_model).astype(np.float32)
    wy, waux = JM.moe_mlp(_to_jax(p), jnp.asarray(x), jcfg)
    tp = _to_port(p)
    gy, gaux = M.moe_mlp(tp, torch.from_numpy(x), cfg)
    within(gy, wy, 1e-5)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))

    r = M.route(tp, torch.from_numpy(x), cfg.moe)
    G, Tg, C = r["shape"]
    assert (G, Tg) == (16, 16)
    _, jidx, _ = JM._router(_to_jax(p), jnp.asarray(x.reshape(-1,
                                                               cfg.d_model)),
                            jcfg.moe)
    jidx = np.asarray(jidx).reshape(G, Tg, -1)
    np.testing.assert_array_equal(r["idx"].numpy(), jidx)
    keep = r["keep"]
    np.testing.assert_array_equal(keep.numpy(), _keep_oracle(jidx, C))
    assert (not keep.all()) == (case == "drops")


def test_tied_router_resolves_ties_as_jax_top_k():
    """Equal probabilities: the lower expert id first, as
    ``jax.lax.top_k``; the gate values in descending order."""
    jcfg, cfg = _configs("qwen3-moe-30b-a3b", **F32)
    jcfg, cfg = _sparse(jcfg), _sparse(cfg)
    p = _moe_params(jcfg, seed=3)
    p["router"][:, 1::2] = p["router"][:, 0::2]      # experts tie in pairs
    p["router"][:, 8:] = 0.0                          # and 8 of them at 0
    x2 = np.random.RandomState(4).randn(32, cfg.d_model).astype(np.float32)
    x2[:4] = 0.0                                      # every expert ties
    wg, widx, _ = JM._router(_to_jax(p), jnp.asarray(x2), jcfg.moe)
    gg, gidx, _ = M._router(_to_port(p), torch.from_numpy(x2), cfg.moe)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(gidx[:4].numpy(), [[0, 1]] * 4)
    within(gg, wg, 1e-6)
    probs = np.random.RandomState(5).randint(0, 3, (6, 16)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 5)
    got_v, got_i = M._top_k(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ref_and_specs_match_jax(arch):
    jcfg, cfg = _configs(arch, **F32)
    jl = jax.tree_util.tree_flatten_with_path(
        JM.moe_specs(jcfg), is_leaf=lambda s: hasattr(s, "axes"))[0]
    tl = pytree.tree_flatten_with_path(M.moe_specs(cfg))[0]
    assert {tuple(k.key for k in path): (s.shape, s.axes, s.dtype, s.init)
            for path, s in jl} == \
        {tuple(k.key for k in path): (s.shape, s.axes, s.dtype, s.init)
         for path, s in tl}
    p = _moe_params(jcfg, seed=6)
    x = np.random.RandomState(7).randn(2, 8, cfg.d_model).astype(np.float32)
    wy, waux = JM.moe_ref(_to_jax(p), jnp.asarray(x), jcfg)
    gy, gaux = M.moe_ref(_to_port(p), torch.from_numpy(x), cfg)
    within(gy, wy, 1e-5)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))
    # with no drops (capacity factor 2 at 4 tokens a group) the dispatch
    # computes the oracle's function
    my, _ = M.moe_mlp(_to_port(p), torch.from_numpy(x), cfg)
    within(my, gy, 1e-5)


# ---------------------------------------------------------------------------
# The pager
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pager_setup():
    """``benchmarks/run.py``'s setup: reduced qwen3-moe-30b-a3b (bf16)
    with the sparse router, 8 decode tokens of batch 1."""
    jcfg, cfg = (_sparse(c) for c in _configs("qwen3-moe-30b-a3b"))
    p = j_init_params(jax.random.PRNGKey(0), JM.moe_specs(jcfg))
    xs = [jax.random.normal(jax.random.PRNGKey(100 + t), (1, 1, jcfg.d_model),
                            jcfg.compute_dtype) for t in range(8)]
    return dict(jcfg=jcfg, cfg=cfg, jp=p, tp=_to_port(jax.tree.map(
        np.asarray, p)), jxs=xs,
        xs=[_tensor(np.asarray(x), "cpu") for x in xs])


def _port_stream(s, budget=None, lookahead=True, ledger=None):
    pager = M.ExpertPager(s["tp"], s["cfg"], budget=budget,
                          lookahead=lookahead)
    ys = []
    for x in s["xs"]:
        y, _ = M.moe_decode_paged(pager, x, s["cfg"], ledger=ledger)
        if budget is not None:
            assert pager.resident_bytes <= budget.limit_bytes
        ys.append(y)
    pager.close()
    return pager, ys


def _ref_stream(s, budget=None, ledger=None):
    pager = JM.ExpertPager(s["jp"], s["jcfg"], budget=budget,
                           host_space=JMemSpace.DEVICE)
    ys = [np.asarray(JM.moe_decode_paged(pager, x, s["jcfg"],
                                         ledger=ledger)[0]).astype(np.float32)
          for x in s["jxs"]]
    return pager, ys


STATS = ("fetches", "hits", "evictions", "bytes_fetched", "prefetch_hits")


def test_pager_budgeted_runs_are_bit_for_bit_and_count_as_jax(pager_setup):
    s = pager_setup
    pager0, ys0 = _port_stream(s)
    jpager0, jys0 = _ref_stream(s)
    fp = pager0.footprint_bytes
    assert fp == jpager0.footprint_bytes
    for a, b in zip(ys0, jys0):
        within(a.float(), b, 2e-2)
    for x, y in zip(s["xs"], ys0):
        within(y.float(), M.moe_ref(s["tp"], x, s["cfg"])[0].float(), 2e-2)
    runs = {}
    for ratio in (1.0, 2.0, 4.0):
        budget = MemoryBudget.for_ratio(fp, ratio, name="moe")
        pager, ys = _port_stream(s, budget)
        jpager, _ = _ref_stream(s, JMemoryBudget.for_ratio(fp, ratio,
                                                           name="moe"))
        for a, b in zip(ys0, ys):
            assert torch.equal(a, b)
        assert {k: getattr(pager.stats, k) for k in STATS} == \
            {k: getattr(jpager.stats, k) for k in STATS}, ratio
        assert budget.stats.high_water_bytes <= budget.limit_bytes \
            + pager.slab_bytes
        assert budget.stats.charged_bytes == 0          # drop() at close
        runs[ratio] = pager.stats
    st = runs[4.0]
    assert (st.fetches, st.hits, st.evictions, st.prefetch_hits) == \
        (12, 4, 8, 5)
    assert st.bytes_fetched == 12 * pager0.slab_bytes
    pager, ys = _port_stream(s, MemoryBudget.for_ratio(fp, 4.0),
                             lookahead=False)
    for a, b in zip(ys0, ys):
        assert torch.equal(a, b)
    assert (pager.stats.fetches, pager.stats.prefetch_hits) == (12, 0)


def test_pager_ledger_gauges_match_jax(pager_setup):
    s = pager_setup
    led, jled = Ledger("serve"), JLedger("serve")
    pager, _ = _port_stream(s, ledger=led)
    jpager, _ = _ref_stream(s, ledger=jled)
    assert led.serve_counters["moe_prefetch_hit"] == \
        jled.serve_counters["moe_prefetch_hit"] == pager.stats.prefetch_hits
    assert led.serve_gauges["moe_prefetch_overlap_s"] == \
        pager.stats.prefetch_overlap_s >= 0.0
    assert "moe_prefetch_overlap_s" in jled.serve_gauges


def test_pager_lru_and_accounting(pager_setup):
    s = pager_setup
    pager = M.ExpertPager(s["tp"], s["cfg"], budget=MemoryBudget(
        2 * sum(M.umem.nbytes(s["tp"][k][0]) for k in M.EXPERT_KEYS)))
    pager.get(0), pager.get(1)
    assert pager.stats.fetches == 2 and pager.stats.evictions == 0
    pager.get(0)                                     # touch: 0 is now MRU
    assert pager.stats.hits == 1
    pager.get(2)                                     # evicts LRU = 1
    assert pager.stats.evictions == 1 and set(pager._resident) == {0, 2}
    assert pager.budget.stats.charged_bytes == pager.resident_bytes
    pager.drop()
    assert pager.budget.stats.charged_bytes == 0 and not pager._resident


# ---------------------------------------------------------------------------
# The models: reduced qwen3-moe-30b-a3b and llama4-scout-17b-a16e
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_float32(arch):
    logits, tokens, jcache, tcache = _decode_both(arch, "float32", {},
                                                  teacher_forced=False)
    for want, got in logits:
        within(got, want, 1e-4)
    for want, got in tokens:
        np.testing.assert_array_equal(got, want)
    assert [k for k in T.layer_kinds(reduced(get_config(arch)))] == \
        [("attn", "moe")] * 2
    for jl, tl in zip(jcache, tcache):
        for key in ("k", "v"):
            within(tl[key], jl[key], 1e-4)
        assert torch.equal(tl["pos"], jl["pos"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_bfloat16(arch):
    logits, _, jcache, tcache = _decode_both(arch, "bfloat16", {},
                                             teacher_forced=True)
    for want, got in logits:
        within(got, want, 0.15)
    for jl, tl in zip(jcache, tcache):
        for key in ("k", "v"):
            within(tl[key].float(), jl[key].float(), 0.15)


@pytest.mark.parametrize("arch", ARCHS)
def test_new_moe_layer_op_passes_opcheck(arch):
    cfg = reduced(get_config(arch))
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for mode, tlen in (("prefill", 9), ("decode", 1)):
        op = T.layer_fns(cfg, T.Ctx(mode=mode))[("attn", "moe")]
        cache = T.init_cache(cfg, 2, "cpu", 16)[0]
        x = torch.from_numpy(np.random.RandomState(5).randn(
            2, tlen, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
        pos = None if mode == "prefill" else torch.tensor(9,
                                                         dtype=torch.int32)
        torch.library.opcheck(op.op, (T._leaves(params["layers"][0]), x,
                                      [cache[k] for k in op._cache_keys],
                                      pos))


def test_decode_routes_each_row_alone():
    """A decode step's rows (padded to ``DECODE_ROWS``) make one group
    each, with room for every pair of its token."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    assert M.dispatch_shape(T.DECODE_ROWS, cfg.moe) == (T.DECODE_ROWS, 1, 8)
    full = get_config("qwen3-moe-30b-a3b").moe
    assert M.dispatch_shape(T.DECODE_ROWS, full) == (T.DECODE_ROWS, 1, 8)
    assert M.dispatch_shape(4 * 1024, full) == (16, 256, 24)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    jcfg, cfg = _configs(arch, **F32)
    jp, params = _params(jcfg, cfg)
    toks = _tokens(cfg)
    (jl, (jce, jaux)), jg = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, JT.Ctx(mode="train"))
    batch = {"tokens": torch.from_numpy(toks)}
    (loss, (ce, aux)), grads = S.value_and_grad(params, batch, cfg,
                                                T.Ctx(mode="train"))
    for got, want in ((loss, jl), (ce, jce), (aux, jaux)):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert float(aux) > 0
    errs = _leaf_errs(grads, _as_port(jg, cfg))
    names = [pytree.keystr(k) for k, _ in
             pytree.tree_flatten_with_path(grads)[0]]
    bad = [(n, e) for n, e in zip(names, errs) if e > 2e-4]
    assert not bad, bad
    (_, (_, aux0)), _ = S.value_and_grad(params, batch, cfg,
                                         T.Ctx(mode="train", remat=False))
    assert float(aux0) == float(aux)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_and_train_clis_run_on_cpu(arch, capsys):
    seq = SV.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--prompt-len", "20", "--gen", "4"])
    assert seq.shape == (4, 4)
    SV.main(["--engine", "--arch", arch, "--reduced", "--device", "cpu",
             "--prompt-len", "20", "--gen", "4", "--requests", "4"])
    losses = LT.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "parity OK vs solo decode" in out and "moe_aux" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
