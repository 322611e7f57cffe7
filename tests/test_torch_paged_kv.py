"""The paged KV store of the port (``repro_torch.serve.paged_kv``) and its
traffic generator (``repro_torch.serve.traffic.make_traffic``), held
against the JAX package's.

Both packages page the same cache, converted from numpy, in one layout:
a list of per-layer dicts (``k``/``v`` leaves ``[1, S, Hkv, hd]`` with
their token axis at 1, a ``pos`` leaf riding dense), as the port's
``init_cache`` builds it for reduced gemma3-1b (local layers with a ring
of 16 slots, global layers with ``max_len`` slots).  Under the same
sequence of commits, gathers, frees and touches, with and without device
and total budgets, the two must gather the same trees bit for bit and
keep equal statistics: page counts, byte totals, high waters, spills,
fetches and evictions, and the same LRU eviction order.

The port's own cases mirror the store's cases of tests/test_serve_engine.py
and tests/test_oversub.py: pages recycle through the pool, a spill keeps
the bits, a duplicate commit is refused, a ``MemoryBudget`` drives the
spill, the tighter of two budgets wins, and random interleavings
(hypothesis, and a seeded fallback) keep the bits and the accounting.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.oversub import MemoryBudget as JMemoryBudget
from repro.serve import PagedKVCache as JPagedKVCache
from repro.serve import make_traffic as j_make_traffic
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.oversub import MemoryBudget
from repro_torch.models import transformer as T
from repro_torch.serve import PagedKVCache, make_traffic

MAX_LEN = 32


def _filled_cache(seed, true_len, max_len=MAX_LEN):
    """Reduced gemma3-1b's batch-1 cache (port layout) as numpy, random in
    the first ``true_len`` tokens (or ring slots) of every k/v leaf and
    zero beyond, and its positions as prefill leaves them."""
    cfg = reduced(get_config("gemma3-1b"))
    rng = np.random.default_rng(seed)
    out = []
    for layer in T.init_cache(cfg, 1, "cpu", max_len):
        S = layer["k"].shape[1]
        valid = min(true_len, S)
        d = {}
        for key in ("k", "v"):
            a = np.zeros(tuple(layer[key].shape), np.float32)
            a[:, :valid] = rng.standard_normal(a[:, :valid].shape)
            d[key] = a
        pos = np.full(S, -1, np.int32)
        pos[:valid] = np.arange(valid)
        d["pos"] = pos
        out.append(d)
    return out


def _torch_tree(tree):
    return [{k: torch.from_numpy(a.copy()) for k, a in d.items()}
            for d in tree]


def _jax_tree(tree):
    return [{k: jnp.asarray(a) for k, a in d.items()} for d in tree]


def _same_tree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def _stats(kv):
    d = dataclasses.asdict(kv.stats)
    return d


# ---------------------------------------------------------------------------
# Against the reference's store
# ---------------------------------------------------------------------------

#: (page_tokens, device budget in entries, total budget in entries)
_BUDGETS = [(4, None, None), (8, 0, None), (4, 1, None), (3, None, 2),
            (5, 1, 2), (16, 2, 3)]


def _scenario(seed):
    """A seeded sequence of (op, req_id, true_len) over 5 requests."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(24):
        op = ["commit", "commit", "gather", "free", "touch"][
            int(rng.integers(5))]
        ops.append((op, int(rng.integers(5)), int(rng.integers(1, 30))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("page_tokens,dev_entries,tot_entries", _BUDGETS)
def test_store_equals_the_reference(page_tokens, dev_entries, tot_entries,
                                    seed):
    one = None
    if dev_entries is not None or tot_entries is not None:
        probe = PagedKVCache(page_tokens=page_tokens, device="cpu")
        probe.commit(0, _torch_tree(_filled_cache(0, 20)), true_len=20)
        one = probe.total_bytes
    dev = None if dev_entries is None else max(1, dev_entries * one)
    tot = None if tot_entries is None else tot_entries * one
    port = PagedKVCache(page_tokens=page_tokens, device_budget_bytes=dev,
                        total_budget_bytes=tot, device="cpu")
    ref = JPagedKVCache(page_tokens=page_tokens, device_budget_bytes=dev,
                        total_budget_bytes=tot)
    parked = {}
    for op, rid, true_len in _scenario(seed):
        if op == "commit" and rid not in parked:
            tree = _filled_cache(100 * seed + rid, true_len)
            ev_port = port.commit(rid, _torch_tree(tree), true_len=true_len)
            ev_ref = ref.commit(rid, _jax_tree(tree), true_len=true_len)
            assert ev_port == ev_ref                 # the LRU order
            parked[rid] = tree
            for ev in ev_port:
                del parked[ev]
        elif op == "gather" and rid in parked:
            got, want = port.gather(rid), ref.gather(rid)
            _same_tree(got, want)
            _same_tree(got, parked.pop(rid))
        elif op == "free" and rid in parked:
            port.free(rid)
            ref.free(rid)
            del parked[rid]
        elif op == "touch":
            port.touch(rid)
            ref.touch(rid)
        assert _stats(port) == _stats(ref), (op, rid)
        assert len(port) == len(ref) and port.total_bytes == ref.total_bytes
    for rid in sorted(parked):
        _same_tree(port.gather(rid), ref.gather(rid))
    assert _stats(port) == _stats(ref)
    assert port.stats.device_bytes == port.stats.host_bytes == 0
    assert port.pool.stats.bytes_in_use == 0


def test_store_under_a_memory_budget_equals_the_reference():
    tree = _filled_cache(5, 20)
    port = PagedKVCache(page_tokens=4, budget=MemoryBudget(1), device="cpu")
    ref = JPagedKVCache(page_tokens=4, budget=JMemoryBudget(1))
    port.commit(0, _torch_tree(tree), true_len=20)
    ref.commit(0, _jax_tree(tree), true_len=20)
    assert _stats(port) == _stats(ref)
    assert dataclasses.asdict(port.budget.stats) == \
        dataclasses.asdict(ref.budget.stats)
    _same_tree(port.gather(0), ref.gather(0))
    assert dataclasses.asdict(port.budget.stats) == \
        dataclasses.asdict(ref.budget.stats)


def test_role_pages_count_every_layer_and_the_ring_clamp():
    """14 reduced layers: 12 local (a ring of 16 slots) and 2 global (32
    slots).  A 20-token prompt fills every ring (16 slots, 4 pages of 4)
    and 20 tokens of each global layer (5 pages)."""
    kv = PagedKVCache(page_tokens=4, device="cpu")
    kv.commit(0, _torch_tree(_filled_cache(1, 20)), true_len=20)
    assert kv.stats.role_pages == {"k": 12 * 4 + 2 * 5, "v": 12 * 4 + 2 * 5}


# ---------------------------------------------------------------------------
# The store's own cases (tests/test_serve_engine.py, tests/test_oversub.py)
# ---------------------------------------------------------------------------

def test_round_trip_bitwise():
    tree = _filled_cache(2, 10)
    kv = PagedKVCache(page_tokens=4, device="cpu")
    kv.commit(0, _torch_tree(tree), true_len=10)
    _same_tree(kv.gather(0), tree)
    assert len(kv) == 0
    assert kv.stats.device_bytes == 0 and kv.stats.host_bytes == 0


def test_pages_recycle_through_pool():
    tree = _torch_tree(_filled_cache(3, 10))
    kv = PagedKVCache(page_tokens=4, device="cpu")
    kv.commit(0, tree, true_len=10)
    kv.gather(0)                       # pages go back to the free list
    assert kv.pool.stats.misses > 0 and kv.pool.stats.hits == 0
    kv.commit(1, tree, true_len=10)    # same shapes: all hits
    assert kv.pool.stats.hits == kv.pool.stats.misses
    assert kv.pool.stats.bytes_reused > 0


def test_spill_keeps_bits_and_frees_the_device_pages():
    tree = _filled_cache(4, 10)
    kv = PagedKVCache(page_tokens=4, device_budget_bytes=1, device="cpu")
    kv.commit(0, _torch_tree(tree), true_len=10)
    n = kv.stats.pages_committed
    assert kv.stats.pages_spilled == n          # the whole entry went
    assert kv.stats.device_bytes == 0 and kv.stats.host_bytes > 0
    assert kv.pool.stats.bytes_in_use == 0      # its pages are free again
    _same_tree(kv.gather(0), tree)
    assert kv.stats.pages_fetched == n


def test_total_budget_evicts_lru():
    tree = _torch_tree(_filled_cache(5, 10))
    probe = PagedKVCache(page_tokens=4, device="cpu")
    probe.commit(0, tree, true_len=10)
    kv = PagedKVCache(page_tokens=4, total_budget_bytes=probe.total_bytes,
                      device="cpu")
    kv.commit(0, tree, true_len=10)
    assert kv.commit(1, tree, true_len=10) == [0]   # LRU out, newest stays
    assert 0 not in kv and 1 in kv
    assert kv.stats.evictions == 1


def test_rejects_duplicate_commit():
    tree = _torch_tree(_filled_cache(6, 10))
    kv = PagedKVCache(page_tokens=4, device="cpu")
    kv.commit(0, tree, true_len=10)
    with pytest.raises(ValueError, match="already committed"):
        kv.commit(0, tree, true_len=10)


def _toy_cache(rng, S, true_len):
    """A k/v cache of one layer with the zero tail beyond true_len."""
    def leaf():
        a = rng.random((1, S, 4)).astype(np.float32)
        a[:, true_len:] = 0
        return torch.from_numpy(a)
    return {"k": leaf(), "v": leaf(),
            "pos": torch.full((1,), true_len, dtype=torch.int32)}


def test_memory_budget_drives_spill_bitwise():
    cache = _toy_cache(np.random.default_rng(3), 12, 10)
    budget = MemoryBudget(1)             # nothing device-resident fits
    kv = PagedKVCache(page_tokens=4, budget=budget, device="cpu")
    kv.commit(0, cache, true_len=10)
    assert kv.stats.pages_spilled == 6 and kv.stats.device_bytes == 0
    assert budget.stats.charged_bytes == 0           # spill released it
    assert budget.stats.pressure_events >= 1
    back = kv.gather(0)
    for key in ("k", "v", "pos"):
        assert torch.equal(back[key], cache[key])
    assert budget.stats.charged_bytes == 0


def test_tightest_of_two_budgets_wins():
    cache = _toy_cache(np.random.default_rng(4), 12, 10)
    kv = PagedKVCache(page_tokens=4, device_budget_bytes=1 << 30,
                      budget=MemoryBudget(1), device="cpu")
    kv.commit(0, cache, true_len=10)
    assert kv.stats.pages_spilled == 6
    kv2 = PagedKVCache(page_tokens=4, device_budget_bytes=1,
                       budget=MemoryBudget(1 << 30), device="cpu")
    kv2.commit(0, cache, true_len=10)
    assert kv2.stats.pages_spilled == 6


def _run_interleaving(page_tokens, dev_budget, tot_entries, seed, ops):
    """Under any interleaving of commit / spill / evict / gather / free
    with random page sizes and budgets, gather stays bitwise equal to the
    original and the accounting never goes negative."""
    rng = np.random.default_rng(seed)
    trees = {}
    for rid in range(6):
        S = int(rng.integers(4, 17))
        tl = int(rng.integers(1, S + 1))
        trees[rid] = (_toy_cache(rng, S, tl), tl)
    one_entry = None
    if tot_entries is not None:
        probe = PagedKVCache(page_tokens=page_tokens, device="cpu")
        probe.commit(0, trees[0][0], true_len=trees[0][1])
        one_entry = probe.total_bytes * tot_entries
        probe.free(0)
    kv = PagedKVCache(page_tokens=page_tokens, device_budget_bytes=dev_budget,
                      total_budget_bytes=one_entry, device="cpu")
    parked = set()

    def check_invariants():
        s = kv.stats
        assert s.device_bytes >= 0 and s.host_bytes >= 0
        assert kv.pool.stats.bytes_in_use == s.device_bytes
        assert s.pages_released <= s.pages_committed
        if dev_budget is not None:
            assert s.device_bytes <= dev_budget

    def check_bits(rid, back):
        for key, a in trees[rid][0].items():
            assert torch.equal(back[key], a)

    for op, rid in ops:
        if op == "commit" and rid not in parked:
            evicted = kv.commit(rid, trees[rid][0], true_len=trees[rid][1])
            parked.add(rid)
            for ev in evicted:
                parked.discard(ev)
        elif op == "gather" and rid in parked:
            check_bits(rid, kv.gather(rid))
            parked.discard(rid)
        elif op == "free" and rid in parked:
            kv.free(rid)
            parked.discard(rid)
        elif op == "touch":
            kv.touch(rid)
        check_invariants()
    for rid in sorted(parked):
        check_bits(rid, kv.gather(rid))
    assert kv.stats.device_bytes == 0 and kv.stats.host_bytes == 0
    assert kv.pool.stats.bytes_in_use == 0


@settings(max_examples=20, deadline=None)
@given(
    page_tokens=st.integers(min_value=1, max_value=6),
    dev_budget=st.sampled_from([None, 1, 256, 4096]),
    tot_entries=st.sampled_from([None, 1, 3]),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    ops=st.lists(
        st.tuples(st.sampled_from(["commit", "gather", "free", "touch"]),
                  st.integers(min_value=0, max_value=5)),
        min_size=1, max_size=24),
)
def test_random_interleavings_property(page_tokens, dev_budget, tot_entries,
                                       seed, ops):
    _run_interleaving(page_tokens, dev_budget, tot_entries, seed, ops)


def test_random_interleavings_seeded():
    """The property above over 15 seeded draws, where hypothesis is
    absent."""
    rng = np.random.default_rng(7)
    for trial in range(15):
        ops = [(["commit", "gather", "free", "touch"][int(rng.integers(4))],
                int(rng.integers(6))) for _ in range(int(rng.integers(4, 25)))]
        _run_interleaving(int(rng.integers(1, 7)),
                          [None, 1, 256, 4096][trial % 4],
                          [None, 1, 3][trial % 3], int(rng.integers(2**31)),
                          ops)


# ---------------------------------------------------------------------------
# make_traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_make_traffic_equals_the_reference(seed):
    kw = dict(arrival_rate=0.5, prompt_lens=(512, 1024), gen_lens=(1, 16, 32))
    port = make_traffic(seed, 16, 262144, **kw)
    ref = j_make_traffic(seed, 16, 262144, **kw)
    assert len(port) == len(ref) == 16
    for p, r in zip(port, ref):
        assert (p.req_id, p.gen, p.arrival_tick) == \
            (r.req_id, r.gen, r.arrival_tick)
        np.testing.assert_array_equal(p.prompt, r.prompt)
        assert p.prompt.dtype == np.int32
    # the first n requests of a larger draw are a draw of n
    for p, q in zip(make_traffic(seed, 8, 262144, **kw), port):
        assert (p.req_id, p.gen, p.arrival_tick) == \
            (q.req_id, q.gen, q.arrival_tick)
        np.testing.assert_array_equal(p.prompt, q.prompt)


def test_make_traffic_refuses_a_rate_of_zero():
    with pytest.raises(ValueError, match="arrival_rate"):
        make_traffic(0, 4, 100, arrival_rate=0.0)
