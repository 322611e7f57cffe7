"""The continuous-batching engine of the port (``repro_torch.serve``), its
launcher (``repro_torch.launch.serve --engine``), the ledger's ``serve``
accounts and the ``host`` / ``adaptive`` serve policies.

The parity contract (docs/SERVING.md): the engine may page, spill, evict,
re-prefill and batch requests across slots as its budgets dictate, but
every request's tokens equal a solo decode of the same prompt, bit for
bit, under every policy.  Here the oracle is the port's own solo decode
(``solo_reference``: the uncaptured path at batch 1), held in turn to the
JAX model's greedy ``prefill`` + ``decode_step`` under a plain ``Ctx()``
in float32 (the reference's engine and serve CLI fail on this jax, at its
sharder), token for token, with prompts longer than the local window.

Everything runs on the CPU at the reduced sizes (d_model 64, window 16),
regions eagerly (``disable_compile``) except in the tests that ask for
the ``compiled`` fixture.  Each case mirrors one of
tests/test_serve_engine.py or the engine cases of tests/test_oversub.py.
"""
import dataclasses
import types

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
from repro_torch.core.ledger import Ledger
from repro_torch.core.oversub import MemoryBudget
from repro_torch.core.regions import (Executor, StaticSelector,
                                      TargetSelector, disable_compile)
from repro_torch.launch import serve as SV
from repro_torch.launch.policy import POLICY_CHOICES, lm_policy
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (PagedKVCache, Request, ServeEngine,
                               make_traffic, run_traffic, solo_reference)
from repro_torch.serve.scheduler import (DECODE, DONE, QUEUED,
                                         batch_for_prompt)
from repro_torch.serve.traffic import assert_parity

ARCHS = ("gemma3-1b", "qwen2.5-32b", "tinyllama-1.1b", "rwkv6-7b",
         "recurrentgemma-9b", "qwen3-moe-30b-a3b")
MAX_LEN = 32
PAGE = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the engine runs thousands of tiny ops, which
    several torch thread pools fighting over the test workers' cores slow
    down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _eager(request):
    """Regions and layer ops run eagerly here, except in the tests that
    ask for the ``compiled`` fixture."""
    if "compiled" in request.fixturenames:
        yield
        return
    with disable_compile():
        yield


@pytest.fixture
def compiled():
    """Marks a test that compiles (the autouse fixture leaves it alone)."""


def _traffic(cfg, seed, id_base=0, n=6, gen_lens=(1, 5, 9)):
    """Prompts of 6 and 20 tokens (20 outgrows the local window of 16),
    1, 5 or 9 tokens each."""
    reqs = make_traffic(seed=seed, n_requests=n, vocab=cfg.vocab,
                        arrival_rate=2.0, prompt_lens=(6, 20),
                        gen_lens=gen_lens)
    for r in reqs:
        r.req_id += id_base
    return reqs


_SETUPS = {}


def _setup(arch, seed):
    """Reduced config (bf16), random params, and the solo oracle of each
    prefill variant, made once per arch."""
    if arch not in _SETUPS:
        cfg = reduced(get_config(arch))
        params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
        reqs = _traffic(cfg, seed)
        # an attention arch has no kernel: both variants run one prefill
        oracles = {impl: solo_reference(cfg, params, reqs, MAX_LEN,
                                        device="cpu", rwkv_impl=impl)[0]
                   for impl in ((None, "hopper") if arch == "rwkv6-7b"
                                else (None,))}
        oracles.setdefault("hopper", oracles[None])
        _SETUPS[arch] = dict(cfg=cfg, params=params, oracles=oracles,
                             seed=seed)
    return _SETUPS[arch]


def _policy(mode, cfg, placer=None):
    return lm_policy(mode, cfg.memory, placer=placer,
                     selector=StaticSelector("hopper"), device="cpu")


def _engine(s, policy=None, ledger_name="engine", budget=None, **kv_kwargs):
    ex = Executor(policy or _policy("unified", s["cfg"]), Ledger(ledger_name))
    kv = PagedKVCache(page_tokens=PAGE, budget=budget, device="cpu",
                      **kv_kwargs)
    eng = ServeEngine(s["cfg"], s["params"], ex, max_len=MAX_LEN, n_slots=2,
                      kv=kv, device="cpu")
    return eng, ex, kv


def _oracle(s, eng, reqs):
    """The solo oracle of the prefill variant the engine's policy runs."""
    impl = SV.prefill_rwkv_impl(
        eng.executor, eng.regions, batch_for_prompt(reqs[0].prompt, "cpu"),
        T.init_cache(s["cfg"], 1, "cpu", MAX_LEN))
    return s["oracles"][impl]


def _one_entry_bytes(s, true_len):
    probe = PagedKVCache(page_tokens=PAGE, device="cpu")
    probe.commit(0, T.init_cache(s["cfg"], 1, "cpu", MAX_LEN),
                 true_len=true_len)
    return probe.total_bytes


# ---------------------------------------------------------------------------
# Engine tokens against the port's solo decode
# ---------------------------------------------------------------------------

SCENARIOS = ("unified", "discrete", "host", "adaptive", "offload_kv",
             "spill", "evict", "oversub_ratio_2")


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_solo_decode(arch, scenario, traffic_seed):
    s = _setup(arch, traffic_seed)
    cfg = s["cfg"]
    kw, policy = {}, None
    if scenario in ("discrete", "host", "adaptive"):
        policy = _policy(scenario, cfg)
    elif scenario == "offload_kv":
        policy = _policy("unified", cfg,
                         placer=SV.offload_kv_cache(min_bytes=0,
                                                    device="cpu"))
    elif scenario == "spill":
        kw["device_budget_bytes"] = 1
    elif scenario == "evict":
        # a budget of one short entry: any two parked entries exceed it
        kw["total_budget_bytes"] = _one_entry_bytes(s, 6)
    elif scenario == "oversub_ratio_2":
        kw["budget"] = MemoryBudget.for_ratio(
            _one_entry_bytes(s, MAX_LEN) * 2, 2.0, name="kv")
    reqs = _traffic(cfg, s["seed"])
    oracle = None
    if scenario == "evict":
        # every request decodes, so that two wait while both slots are busy
        reqs = _traffic(cfg, s["seed"], n=8, gen_lens=(5, 9))
        oracle, _ = solo_reference(cfg, s["params"], reqs, MAX_LEN,
                                   device="cpu", rwkv_impl="hopper")
    eng, ex, kv = _engine(s, policy=policy, ledger_name=scenario, **kw)
    metrics = run_traffic(eng, reqs)
    assert_parity(reqs, oracle or _oracle(s, eng, reqs))
    assert metrics["tokens"] == sum(len(r.tokens) for r in reqs)
    assert all(r.done for r in reqs)
    serve = ex.report()["serve"]
    has_kv = arch != "rwkv6-7b"            # rwkv's state pages as dense
    if scenario == "spill" and has_kv:
        assert kv.stats.pages_spilled > 0 and kv.stats.pages_fetched > 0
        assert kv.stats.device_high_water_bytes <= max(
            1, kv.stats.total_high_water_bytes)
    if scenario == "evict" and has_kv:
        assert serve.get("evicted", 0) == sum(r.evictions for r in reqs) > 0
    if scenario == "oversub_ratio_2":
        assert serve["kv_budget_limit_bytes"] == kw["budget"].limit_bytes
        assert serve["kv_budget_high_water_bytes"] == \
            kw["budget"].stats.high_water_bytes
        if has_kv:
            assert serve["kv_budget_high_water_bytes"] > 0
    if scenario == "discrete":
        assert {"kv_pages", "host_staging", "device_buffer"} <= \
            set(ex.report()["pools"])
        assert ex.report()["staging_s"] > 0
    if scenario in ("host", "adaptive"):
        # the reduced operands all sit below the cutoff: every call runs on
        # the host, the ref variant
        rows = ex.ledger.regions
        assert rows["DECODE_SLOTS"].host_calls > 0
        assert rows["DECODE_SLOTS"].device_calls == 0
        assert set(ex.report()["impl_counts"]) == {"ref"}


def test_rwkv_engine_prefill_runs_the_kernel_variant(traffic_seed):
    """Under the unified policy the engine's PREFILL runs the ``hopper``
    variant (the CUDA kernel K5 on the card, its plain version on CPU
    tensors), and its tokens equal the solo decode's with the same
    variant."""
    s = _setup("rwkv6-7b", traffic_seed)
    reqs = _traffic(s["cfg"], s["seed"])
    eng, ex, _ = _engine(s, ledger_name="k5")
    run_traffic(eng, reqs)
    assert _oracle(s, eng, reqs) is s["oracles"]["hopper"]
    assert_parity(reqs, s["oracles"]["hopper"])
    assert ex.ledger.regions["PREFILL"].impl_counts == {"hopper": len(reqs)}


def test_engine_compiled_tokens_equal_compiled_solo_decode(compiled,
                                                           traffic_seed):
    """Compiled regions and layer ops: ``DECODE_SLOTS`` is
    ``torch.compile`` of ``torch.func.vmap`` of the decode step, its layers
    the solo decode's compiled layer ops at batch 1.  Each executable
    compiles once per prompt length at most."""
    cfg = dataclasses.replace(reduced(get_config("gemma3-1b")), n_layers=7)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    reqs = _traffic(cfg, traffic_seed, n=4)
    ex = Executor(_policy("unified", cfg), Ledger("compiled"))
    eng = ServeEngine(cfg, params, ex, max_len=MAX_LEN, n_slots=2,
                      kv=PagedKVCache(page_tokens=PAGE, device="cpu"),
                      device="cpu")
    run_traffic(eng, reqs)
    oracle, _ = solo_reference(cfg, params, reqs, MAX_LEN, device="cpu")
    assert_parity(reqs, oracle)
    stats = eng._decode_slots.compile_stats
    assert [st.compiles for st in stats.values()] == [1]
    for op in T.LAYER_OPS.values():
        if op.label.startswith("layer_attn") and op.stats.calls:
            assert op.stats.compiles <= 2, op.label


# ---------------------------------------------------------------------------
# The solo decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_solo_decode_equals_jax_greedy_decode_float32(arch, traffic_seed):
    """f32, the reference's weights carried over: every request's solo
    tokens equal the JAX model's greedy prefill + decode_step under
    ``Ctx()``; the 20-token prompts outgrow gemma3's local window of 16."""
    over = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    reqs = _traffic(cfg, traffic_seed)
    assert max(r.prompt_len for r in reqs) > cfg.window or not cfg.window
    oracle, _ = solo_reference(cfg, params, reqs, MAX_LEN, device="cpu")
    jpre = jax.jit(JS.make_prefill_step(jcfg, lambda: JT.Ctx()))
    jdec = jax.jit(JS.make_decode_step(jcfg))
    for r in reqs:
        logits, cache = jpre(jp, {"tokens": jnp.asarray(r.prompt)[None]},
                             JT.init_cache(jcfg, 1, MAX_LEN))
        toks = [int(jnp.argmax(logits[0, -1]))]
        for i in range(r.gen - 1):
            logits, cache = jdec(jp, jnp.asarray(toks[-1:], jnp.int32), cache,
                                 jnp.int32(r.prompt_len + i))
            toks.append(int(jnp.argmax(logits[0, -1])))
        assert oracle[r.req_id] == toks, r.req_id


# ---------------------------------------------------------------------------
# Scheduler bookkeeping
# ---------------------------------------------------------------------------

def test_serve_section_accounts_the_lifecycle(traffic_seed):
    s = _setup("gemma3-1b", traffic_seed)
    reqs = _traffic(s["cfg"], s["seed"])
    eng, ex, kv = _engine(s, ledger_name="acct")
    run_traffic(eng, reqs)
    rep = ex.ledger.coverage_report()
    serve = rep["serve"]
    n_decode = sum(1 for r in reqs if r.gen > 1)
    assert serve["submitted"] == len(reqs)
    assert serve["prefills"] == len(reqs)       # warm-up counters reset
    assert serve["admitted"] == n_decode        # gen==1 never takes a slot
    assert serve["retired"] == len(reqs)
    assert serve["decode_tokens"] == sum(r.gen - 1 for r in reqs)
    assert 0 < serve["slot_occupancy"] <= 1
    assert serve["kv_slot_cache_bytes"] > 0
    assert rep["pools"]["kv_pages"]["high_water_bytes"] > 0
    for r in reqs:
        assert r.history[0] == QUEUED and r.history[-1] == DONE
    ex.ledger.reset_timings()
    assert "serve" not in ex.ledger.coverage_report()
    ex.ledger.serve_record("admitted")
    ex.ledger.clear()
    assert "serve" not in ex.ledger.coverage_report()
    assert not ex.ledger.regions


def test_serve_gauges_keep_their_peak():
    led = Ledger("gauges")
    led.serve_gauge("slot_occupancy", 0.5)
    led.serve_gauge("slot_occupancy", 0.25)
    led.serve_record("ticks")
    led.serve_record("ticks", 2)
    assert led.coverage_report()["serve"] == {"ticks": 3,
                                              "slot_occupancy": 0.5}


def test_gen_one_finishes_at_prefill(traffic_seed):
    eng, ex, kv = _engine(_setup("gemma3-1b", traffic_seed),
                          ledger_name="gen1")
    req = eng.submit(Request(req_id=0, prompt=np.arange(6, dtype=np.int32),
                             gen=1))
    eng.drain()
    assert req.done and len(req.tokens) == 1
    assert req.history == [QUEUED, DONE]        # never PREFILL/DECODE
    assert len(kv) == 0                         # nothing parked


def test_rejects_oversized_and_duplicate(traffic_seed):
    eng, ex, kv = _engine(_setup("gemma3-1b", traffic_seed),
                          ledger_name="reject")
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit(Request(req_id=0, gen=MAX_LEN,
                           prompt=np.zeros(MAX_LEN, np.int32)))
    eng.submit(Request(req_id=1, prompt=np.zeros(4, np.int32), gen=2))
    with pytest.raises(ValueError, match="duplicate req_id"):
        eng.submit(Request(req_id=1, prompt=np.zeros(4, np.int32), gen=2))
    eng.drain()


def test_state_machine_rejects_illegal_transition(traffic_seed):
    eng, ex, kv = _engine(_setup("gemma3-1b", traffic_seed),
                          ledger_name="fsm")
    req = Request(req_id=0, prompt=np.zeros(4, np.int32), gen=2)
    with pytest.raises(RuntimeError, match="illegal transition"):
        eng._set_state(req, DECODE)             # QUEUED cannot jump slots
    with pytest.raises(ValueError, match="decode slot"):
        ServeEngine(eng.cfg, _setup("gemma3-1b", traffic_seed)["params"],
                    ex, max_len=MAX_LEN, n_slots=0, device="cpu")


def test_drain_restores_the_pool_baseline(traffic_seed):
    """After a run drains, the page pool's bytes in use return to their
    baseline and its high water never falls (the spill path's leak
    tripwire), over a second wave on the same engine."""
    s = _setup("gemma3-1b", traffic_seed)
    eng, ex, kv = _engine(s, ledger_name="drain", device_budget_bytes=1)
    baseline = kv.pool.stats.bytes_in_use
    run_traffic(eng, _traffic(s["cfg"], s["seed"]))
    assert kv.stats.pages_spilled > 0
    assert len(kv) == 0
    assert kv.pool.stats.bytes_in_use == baseline
    hw1 = kv.pool.stats.high_water_bytes
    assert hw1 > 0
    run_traffic(eng, _traffic(s["cfg"], s["seed"], id_base=100),
                warmup=False)
    assert kv.pool.stats.bytes_in_use == baseline
    assert kv.pool.stats.high_water_bytes >= hw1


def test_same_seed_traffic_is_reproducible(traffic_seed):
    s = _setup("tinyllama-1.1b", traffic_seed)
    a = make_traffic(seed=s["seed"], n_requests=4, vocab=s["cfg"].vocab)
    b = make_traffic(seed=s["seed"], n_requests=4, vocab=s["cfg"].vocab)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
        assert (ra.gen, ra.arrival_tick) == (rb.gen, rb.arrival_tick)
    streams = []
    for _ in range(2):
        reqs = _traffic(s["cfg"], s["seed"])
        eng, ex, kv = _engine(s, ledger_name="det")
        run_traffic(eng, reqs)
        streams.append([list(map(int, r.tokens)) for r in reqs])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# decode_stream's sync contract; the serve policies; the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync_every,expected_syncs", [
    (0, 1),     # never mid-stream: the one final sync
    (-3, 1),    # negative: the same contract
    (1, 4),     # a sync per token: 3 mid-stream and the final one
])
def test_decode_stream_sync_every_contract(sync_every, expected_syncs,
                                           monkeypatch, traffic_seed):
    s = _setup("tinyllama-1.1b", traffic_seed)
    cfg, params = s["cfg"], s["params"]
    prefill, decode, make_cache = SV.build_server(cfg, 1, "cpu", max_len=12)
    batch = batch_for_prompt(np.arange(8, dtype=np.int32), "cpu")

    def stream(every, syncs):
        logits, cache = prefill(params, batch, make_cache())
        monkeypatch.setattr(SV, "synchronize", lambda: syncs.append(1))
        toks, _ = SV.decode_stream(decode, params, SV.greedy(logits), cache,
                                   8, 4, sync_every=every)
        monkeypatch.undo()
        return [int(t[0]) for t in toks]

    syncs = []
    toks = stream(sync_every, syncs)
    assert len(syncs) == expected_syncs
    assert toks == stream(0, [])        # sync cadence is scheduling


def test_serve_policies_and_their_selectors():
    cfg = reduced(get_config("gemma3-1b"))
    assert POLICY_CHOICES == ("unified", "discrete", "host", "adaptive")
    pol = lm_policy("adaptive", cfg.memory,
                    selector=StaticSelector("hopper"), device="cpu")
    assert pol.cutoff == cfg.memory.target_cutoff
    assert isinstance(pol.selector, TargetSelector)
    assert pol.placer.min_bytes == 4096
    host = lm_policy("host", selector=StaticSelector("hopper"), device="cpu")
    assert host.name == "host" and host.selector.host_impl == "ref"
    assert lm_policy("unified").selector.impl == "ref"
    with pytest.raises(ValueError, match="auto"):
        lm_policy("auto")


def test_offload_kv_placer_moves_only_large_kv_leaves():
    placer = SV.offload_kv_cache(device="cpu")
    tree = {"k": torch.zeros(4, 8192), "v": torch.zeros(2),
            "pos": torch.zeros(8192 * 4)}
    out = SV.place_kv_leaves(tree, placer.kv_space, placer.kv_min_bytes,
                             "cpu")
    assert out["k"] is tree["k"] and out["pos"] is tree["pos"]  # the CPU
    region = types.SimpleNamespace(arg_spaces=None)
    assert placer.migrations(region, tree, tree) == []  # host is the device
    assert placer.min_bytes == 4096 and placer.kv_min_bytes == 32768


@pytest.mark.parametrize("extra", [[], ["--policy", "discrete"],
                                   ["--policy", "host"],
                                   ["--policy", "adaptive"],
                                   ["--offload-kv"],
                                   ["--kv-device-budget", "1"],
                                   ["--kv-oversub-ratio", "2"],
                                   ["--kv-total-budget", "20000"]])
def test_engine_cli_runs_on_cpu(extra, capsys):
    """The acceptance command at a smaller size: the launcher's
    ``[serve] engine`` line, parity asserted against the solo decode."""
    metrics = SV.main(["--engine", "--arch", "gemma3-1b", "--reduced",
                       "--device", "cpu", "--prompt-len", "20", "--gen", "6",
                       "--requests", "6", "--slots", "2", "--report",
                       *extra])
    out = capsys.readouterr().out
    assert "[serve] engine gemma3-1b (reduced)" in out
    assert "parity OK vs solo decode" in out and '"serve"' in out
    assert metrics["requests"] == 6
    if "--kv-device-budget" in extra:
        assert "pages spilled to host" in out
    if "--kv-oversub-ratio" in extra:
        assert "oversub x2 budget" in out


@pytest.mark.parametrize("flag,item", [("--verify", "A.8"),
                                       ("--mesh=2", "A.9")])
def test_cli_flags_that_wait_name_their_roadmap_item(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        SV.main(["--reduced", "--device", "cpu", flag])


def test_static_cli_offload_kv_on_cpu(capsys):
    seq = SV.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                   "--prompt-len", "20", "--gen", "4", "--offload-kv",
                   "--sync-every", "2"])
    assert seq.shape == (4, 4)
    assert "[KV in unpinned_host]" in capsys.readouterr().out
