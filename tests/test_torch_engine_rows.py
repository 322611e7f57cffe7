"""The engine's tick runs each layer once over all its slots (one
``DECODE_STEP`` body on a slot cache of ``transformer.padded_rows`` rows),
and a row's result does not depend on how many rows run with it (every
decode-mode op runs ``transformer.DECODE_ROWS`` rows at a time; a decode
step pads its rows once, and the ops' vmap rules fold their instances).

On the CPU the same code runs as on the card, with the plain versions:
one decode layer and the head, fed ``n = 1..4`` rows built from the same
seeded rows, give each row bit for bit its ``n = 1`` output (reduced
gemma3-1b, qwen2.5-32b, tinyllama-1.1b, rwkv6-7b, recurrentgemma-9b (its
RG-LRU state per row), qwen3-moe-30b-a3b and llama4-scout-17b-a16e (a
MoE layer routes each row in a group of its own), bf16).  A 4-slot engine's
tokens equal a one-slot engine's and the solo decode's on seeded traffic,
and ``replay_batch`` still agrees with the solo replays.  Layers run
eagerly (``disable_compile``); their compiled twins are in
tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import Executor, StaticSelector, disable_compile
from repro_torch.launch import serve as SV
from repro_torch.launch.policy import lm_policy
from repro_torch.models import transformer as T
from repro_torch.serve import (PagedKVCache, ServeEngine, make_traffic,
                               run_traffic, solo_reference)
from repro_torch.serve.traffic import assert_parity

ARCHS = ("gemma3-1b", "qwen2.5-32b", "tinyllama-1.1b", "rwkv6-7b",
         "recurrentgemma-9b", "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
N = 4
MAX_LEN = 32


@pytest.fixture(autouse=True)
def _eager():
    with disable_compile():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    cfg = reduced(get_config(arch))
    return cfg, T.init(torch.Generator().manual_seed(0), cfg, "cpu")


def _rows(cfg, op, layer, seed):
    """``N`` seeded decode rows for ``op``: x [N, 1, 1, d] and batch-1
    cache leaves stacked [N, ...] (a KV cache's slots filled up to each
    row's position), and positions [N]."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, 1, 1, cfg.d_model).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.tensor([5, 9, 6, 12], dtype=torch.int32)
    cache = T.init_cache(cfg, 1, "cpu", 24)[layer]
    leaves = []
    for k in op._cache_keys:
        c = cache[k]
        if k == "pos":
            slots = torch.arange(c.shape[0], dtype=torch.int32)
            leaves.append(torch.stack([
                torch.where(slots < p, slots, -1) for p in pos.tolist()]))
        else:
            leaves.append(torch.from_numpy(rng.randn(N, *c.shape).astype(
                np.float32)).to(c.dtype))
    return x, leaves, pos


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_layer_and_head_rows_are_bit_for_bit_their_solo_rows(arch):
    """Every decode layer kind, under ``vmap`` (the tick's path: one call
    of the op for all rows) at n = 1..4 rows, and the head op at n =
    1..4 rows: row i equals its own n = 1 call bit for bit."""
    cfg, params = _model(arch)
    ops = T.layer_fns(cfg, T.Ctx(mode="decode"))
    kinds = T.layer_kinds(cfg)
    for kind in dict.fromkeys(kinds):
        layer = kinds.index(kind)
        op = ops[kind]
        p = T._leaves(params["layers"][layer])
        x, cache, pos = _rows(cfg, op, layer, seed=layer)
        solo = [op.op(p, x[i], [c[i] for c in cache], pos[i])
                for i in range(N)]
        for n in range(1, N + 1):
            got = torch.func.vmap(op.op, in_dims=(None, 0, [0] * len(cache),
                                                  0))(
                p, x[:n], [c[:n] for c in cache], pos[:n])
            for i in range(n):
                for g, w in zip(got, solo[i]):
                    assert torch.equal(g[i], w), (kind, n, i)
    head = ops["head"]
    hx = torch.from_numpy(np.random.RandomState(7).randn(
        N, 1, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
    solo = [head(params, hx[i:i + 1]) for i in range(N)]
    for n in range(1, N + 1):
        got = head(params, hx[:n])
        for i in range(n):
            assert torch.equal(got[i:i + 1], solo[i]), ("head", n, i)


def test_fixed_rows_pad_and_split_past_the_row_count():
    """A call of more rows than ``DECODE_ROWS`` runs in groups; each row
    still equals its solo call, and the shared slot positions of a static
    batch come back shared."""
    cfg, params = _model("gemma3-1b")
    op = T.layer_fns(cfg, T.Ctx(mode="decode"))[("attn", "dense")]
    layer = T.layer_kinds(cfg).index(("attn", "dense"))
    B = T.DECODE_ROWS + 3
    cache = T.init_cache(cfg, B, "cpu", 16)[layer]
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(B, 1, cfg.d_model).astype(
        np.float32)).to(torch.bfloat16)
    leaves = [cache[k] for k in op._cache_keys]
    p = T._leaves(params["layers"][layer])
    pos = torch.tensor(0, dtype=torch.int32)
    out = op.op(p, x, leaves, pos)
    assert out[op._cache_keys.index("pos") + 1].shape == cache["pos"].shape
    for i in (0, T.DECODE_ROWS - 1, T.DECODE_ROWS, B - 1):
        one = op.op(p, x[i:i + 1], [c[i:i + 1] if c.dim() > 1 else c
                                    for c in leaves], pos)
        assert torch.equal(out[0][i:i + 1], one[0])


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b"])
def test_decode_step_pads_its_rows_once_at_its_boundary(arch, monkeypatch):
    """A decode step of 3 rows reaches every layer op and the head at
    ``DECODE_ROWS`` rows (padded once, in ``decode_step``), and returns
    3 rows of logits and a cache laid out as the one it was given."""
    cfg, params = _model(arch)
    layers = T.layer_fns(cfg, T.Ctx(mode="decode"))
    seen = []
    fixed = T._RowOp._fixed_rows

    def spy(self, run_body, p, x, cache, pos):
        seen.append(x.shape[0])
        return fixed(self, run_body, p, x, cache, pos)
    monkeypatch.setattr(T._RowOp, "_fixed_rows", spy)
    cache = T.init_cache(cfg, 3, "cpu", 16)
    tok = torch.tensor([3, 5, 7], dtype=torch.int32)
    logits, new = T.decode_step(params, tok, cache, 4, cfg,
                                T.Ctx(mode="decode"), layers)
    assert seen and set(seen) == {T.DECODE_ROWS}
    assert logits.shape == (3, 1, cfg.vocab)
    for c, n in zip(cache, new):
        assert {k: v.shape for k, v in c.items()} == \
            {k: v.shape for k, v in n.items()}


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b"])
def test_four_slot_engine_equals_one_slot_engine_and_solo(arch):
    """Seeded traffic through a 4-slot and a 1-slot engine (the
    reference's ``sequential`` run of ``fig_traffic``): every request's
    tokens are equal in both and equal to its solo decode; the 4-slot
    engine needs fewer ticks."""
    cfg, params = _model(arch)
    ticks = {}
    for slots in (4, 1):
        reqs = make_traffic(seed=3, n_requests=6, vocab=cfg.vocab,
                            arrival_rate=2.0, prompt_lens=(6, 20),
                            gen_lens=(1, 5, 9))
        ex = Executor(lm_policy("unified", cfg.memory,
                                selector=StaticSelector("hopper"),
                                device="cpu"), Ledger(f"slots{slots}"))
        eng = ServeEngine(cfg, params, ex, max_len=MAX_LEN, n_slots=slots,
                          kv=PagedKVCache(page_tokens=4, device="cpu"),
                          device="cpu")
        # one slot cache of DECODE_ROWS rows for either engine, so both
        # run one tick executable; every leaf per row
        assert eng.rows == T.DECODE_ROWS
        assert all(t.shape[0] == T.DECODE_ROWS
                   for c in eng.slot_cache for t in c.values())
        run_traffic(eng, reqs)
        if slots == 4:
            impl = SV.prefill_rwkv_impl(
                ex, eng.regions, {"tokens": torch.as_tensor(
                    reqs[0].prompt[None])},
                T.init_cache(cfg, 1, "cpu", MAX_LEN))
            oracle, _ = solo_reference(cfg, params, reqs, MAX_LEN,
                                       device="cpu", rwkv_impl=impl)
            four = [list(r.tokens) for r in reqs]
        assert_parity(reqs, oracle)
        ticks[slots] = eng.ticks
    assert [list(r.tokens) for r in reqs] == four
    assert ticks[4] < ticks[1]


def test_replay_batch_still_agrees_with_the_solo_replays(capsys):
    """``replay_batch`` of the decode program over two request groups
    (the layer ops' vmap rules fold the groups into one batch): the
    solo-replay agreement is 1.000."""
    SV.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
             "--batch", "2", "--prompt-len", "8", "--gen", "4",
             "--replay-batch", "2"])
    out = capsys.readouterr().out
    assert "solo-replay agreement 1.000" in out, out
