"""Static-batch serving driver of the port: prefill + greedy decode on the
region-program spine (counterpart of ``repro.launch.serve``).

The request path is three regions, ``PREFILL``, ``DECODE_STEP`` and
``KV_APPEND``, captured as two :class:`~repro_torch.core.program.
RegionProgram`\\ s (one prefill call; the greedy decode loop, one
``DECODE_STEP`` + ``KV_APPEND`` pair per generated token) and replayed
through an ``Executor`` under ``--policy``.

``PREFILL`` registers a ``hopper`` variant whose ``Ctx`` sets
``rwkv_impl="hopper"``: under ``StaticSelector("hopper")`` (``--impl
hopper``, the default) every layer's time-mix scan in prefill runs on the
CUDA kernel K5.  This is the reference's own ``rwkv_train(impl=...)``
selection carried through to the entry point, not a new feature; the
``ref`` variant keeps the reference's chunked closed form.  Decode runs
the sequential scan with T=1, as in the reference.  An attention arch
(``tinyllama-1.1b``, ``llama3.2-3b``) has no kernel: both variants run
the same plain attention, prefill in query chunks of 256 (the reference
serve's ``q_chunk``), against a KV cache of prompt + generated slots.

Every region runs as a compiled executable (``torch.compile``,
``fullgraph=True``); ``KV_APPEND`` donates its cache, so the commit
returns the cache's own storage.  The uncaptured path (:func:`build_server`
+ :func:`decode_stream`) compiles the same step functions without
regions, its decode step with the cache donated; its decode step is the
very function ``DECODE_STEP`` runs (decode + argmax), so both compile the
same graph.  Under the unified policy the replayed tokens are asserted
equal to its tokens on every run: capture changes the schedule, never the
tokens.  ``--replay-batch N`` also prefills N request groups and replays
the captured decode program over all of them at once through
:meth:`~repro_torch.core.program.RegionProgram.replay_batch`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --reduced --device cpu --prompt-len 32 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --impl ref --prompt-len 32 --gen 8 --replay-batch 2

``--offload-kv`` is a placement choice: :func:`offload_kv_cache` builds a
role-keyed :class:`KVCachePlacer`, which re-homes the ``k``/``v`` cache
leaves above ``min_bytes`` to pinned host memory at every region boundary
(the ``KV_APPEND`` commit included).  On the card a region that reads
them copies them in for that call alone, booked as staging (the
executor's migrate-in).  The decode math never changes.

The uncaptured path syncs once per ``--sync-every`` tokens; ``K <= 0``
means one final sync at the end of the stream.

``--engine`` serves seeded Poisson traffic through the continuous-batching
engine (:mod:`repro_torch.serve`): length-bucketed prefill programs, a
paged KV store with device and total budgets (``--kv-device-budget``,
``--kv-total-budget``, or ``--kv-oversub-ratio R`` for a
:class:`~repro_torch.core.oversub.MemoryBudget` of 1/R of the slots' full
KV footprint) and one captured decode tick over ``--slots`` slots; every
request's tokens are asserted equal to its solo decode's.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --arch gemma3-1b --reduced --device cpu --prompt-len 32 --gen 8 \
        --requests 8

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA where there
is none raises.  ``--verify`` waits for ROADMAP A.8 and ``--mesh`` for
A.9.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.reduced import reduced as make_reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.program import capture
from repro_torch.core.regions import (Executor, Placer, StaticSelector,
                                      compile_disabled, compile_region_fn,
                                      region, synchronize)
from repro_torch.core import umem
from repro_torch.core.umem import MemSpace, resolve_device, tree_place
from repro_torch.launch.policy import (PLACER_MIN_BYTES, POLICY_CHOICES,
                                       lm_policy)
from repro_torch.models import transformer as T
from repro_torch.train import step as S

#: the ``Ctx.rwkv_impl`` each variant of ``PREFILL`` runs with
PREFILL_RWKV_IMPL = {"ref": None, "hopper": "hopper"}

#: prefill's attention query chunk (the reference serve's ``q_chunk``)
Q_CHUNK = 256

# placement is keyed on a leaf's role, not only its size: only the k/v
# cache leaves go to host memory; positions and recurrent state are
# decode-hot and stay on the card however large.  min_bytes also keeps
# small k/v leaves, whose crossing costs more than it saves, where they are
KV_PLACE_KEYS = ("k", "v")
KV_PLACE_MIN_BYTES = 32768


def kv_role(path) -> Optional[str]:
    """The cache role (``"k"``/``"v"``) a ``pytree`` key path names, or
    None for any other leaf."""
    for p in path:
        if getattr(p, "key", None) in KV_PLACE_KEYS:
            return p.key
    return None


def place_kv_leaves(tree, space: MemSpace, min_bytes=KV_PLACE_MIN_BYTES,
                    device="cuda"):
    """Role-keyed placement: move only the ``k``/``v`` leaves of at least
    ``min_bytes`` to ``space`` (``device`` is what ``DEVICE`` means);
    every other leaf stays put."""
    def per_leaf(path, x):
        if kv_role(path):
            return tree_place(x, space, device, min_bytes=min_bytes)
        return x
    return pytree.tree_map_with_path(per_leaf, tree)


@dataclasses.dataclass
class KVCachePlacer(Placer):
    """KV-cache offload as a placement axis (a :class:`Placer`).

    On top of the hints, every region's arguments and results get the
    role-keyed treatment of :func:`place_kv_leaves`: ``k``/``v`` leaves of
    at least ``kv_min_bytes`` are re-homed to ``kv_space`` each time they
    cross a region boundary.  A call run on the card copies the ``k``/``v``
    leaves it finds in host memory in for that call alone
    (:meth:`migrations`).  With ``kv_space=None`` this is the base
    :class:`Placer`."""
    kv_space: Optional[MemSpace] = None
    kv_min_bytes: int = KV_PLACE_MIN_BYTES

    def place_args(self, target_region, args, kwargs):
        args, kwargs = super().place_args(target_region, args, kwargs)
        if self.kv_space is None:
            return args, kwargs
        return place_kv_leaves((args, kwargs), self.kv_space,
                               self.kv_min_bytes, self.device)

    def place_result(self, target_region, out):
        out = super().place_result(target_region, out)
        if self.kv_space is None:
            return out
        return place_kv_leaves(out, self.kv_space, self.kv_min_bytes,
                               self.device)

    def migrations(self, target_region, unplaced, placed) -> list:
        moves = super().migrations(target_region, unplaced, placed)
        device = resolve_device(self.device)
        if self.kv_space is None or device.type == "cpu":
            return moves        # on the CPU host memory is the device's
        taken = {i for i, _ in moves}
        paths = pytree.tree_flatten_with_path(placed)[0]
        return moves + [(i, device) for i, (path, x) in enumerate(paths)
                        if i not in taken and kv_role(path)
                        and isinstance(x, torch.Tensor)
                        and x.device.type == "cpu"]


def offload_kv_cache(space: Optional[MemSpace] = None,
                     min_bytes: int = KV_PLACE_MIN_BYTES,
                     device="cuda") -> KVCachePlacer:
    """The ``--offload-kv`` Placer: role-keyed KV offload to host memory
    (pinned on a CUDA build, :func:`~repro_torch.core.umem.
    default_spill_space`, unless ``space`` names one)."""
    return KVCachePlacer(min_bytes=PLACER_MIN_BYTES, device=device,
                         kv_space=space or umem.default_spill_space(),
                         kv_min_bytes=min_bytes)


def prefill_ctx(rwkv_impl: Optional[str] = None):
    """The serve path's prefill context."""
    return T.Ctx(mode="prefill", rwkv_impl=rwkv_impl, q_chunk=Q_CHUNK)


def position(p: int) -> torch.Tensor:
    """A decode position as a 0-d int32 tensor on the host, as the
    reference passes ``jnp.int32(pos)``: a compiled decode step takes it as
    an input, not as a constant to compile anew for each position."""
    return torch.tensor(p, dtype=torch.int32)


def greedy(logits) -> torch.Tensor:
    """Argmax of the last position's logits, as int32 tokens [B]."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_greedy_decode(cfg):
    """``(params, tok, cache, pos) -> (next tok, cache)``: one decode step
    and its argmax, the function both ``DECODE_STEP`` and the uncaptured
    path's decode step run."""
    raw_decode = S.make_decode_step(cfg)

    def greedy_decode(params, tok, cache, pos):
        logits, cache = raw_decode(params, tok, cache, pos)
        return greedy(logits), cache

    return greedy_decode


@dataclasses.dataclass
class ServeRegions:
    """The request path as directive-sized regions (params closed over)."""
    prefill: Any        # (batch, cache)    -> (tok, cache)
    decode_step: Any    # (tok, cache, pos) -> (tok, cache)
    kv_append: Any      # (cache,)          -> cache


def make_serve_regions(cfg, params, *,
                       ledger: Optional[Ledger] = None) -> ServeRegions:
    """``PREFILL`` (variants ``ref`` and ``hopper``) / ``DECODE_STEP`` /
    ``KV_APPEND`` on one ledger.

    ``KV_APPEND`` is the cache *commit* directive: the state update runs
    inside the step, and this identity region is where the ledger
    accounts the per-token commit.  ``offloaded=False``: committing is
    bookkeeping, so no policy stages the whole state twice per token.  It
    donates its cache (``donate_args=(0,)``), as the reference's does: the
    cache fed to it is always the previous region's output, never a
    program input, and the commit is its last reader, so the commit
    returns that storage at O(1); without donation (a staging policy) it
    returns a copy."""
    prefill_steps = {
        name: S.make_prefill_step(cfg, lambda impl=impl: prefill_ctx(impl))
        for name, impl in PREFILL_RWKV_IMPL.items()}
    greedy_decode = make_greedy_decode(cfg)

    @region("PREFILL", ledger=ledger)
    def prefill_region(batch, cache):
        logits, cache = prefill_steps["ref"](params, batch, cache)
        return greedy(logits), cache

    @prefill_region.variant("hopper")
    def _prefill_hopper(batch, cache):
        logits, cache = prefill_steps["hopper"](params, batch, cache)
        return greedy(logits), cache

    @region("DECODE_STEP", ledger=ledger)
    def decode_region(tok, cache, pos):
        return greedy_decode(params, tok, cache, pos)

    @region("KV_APPEND", ledger=ledger, offloaded=False, donate_args=(0,))
    def kv_append(cache):
        return cache

    return ServeRegions(prefill=prefill_region, decode_step=decode_region,
                        kv_append=kv_append)


def capture_prefill_program(regions: ServeRegions, example_batch,
                            example_cache, name: str = "prefill_program",
                            selector=None):
    """Prefill as a RegionProgram: one ``PREFILL`` call, then the
    ``KV_APPEND`` commit of the prompt's state.  Capture runs the variants
    ``selector`` picks (the executing policy's, so that on the card it
    launches the kernel the replays launch)."""
    def prefill_fn(run, batch, cache):
        tok, cache = run(regions.prefill, batch, cache)
        cache = run(regions.kv_append, cache)
        return tok, cache

    return capture(prefill_fn, example_batch, example_cache, name=name,
                   selector=selector)


def capture_decode_program(regions: ServeRegions, prompt_len: int, gen: int,
                           example_tok, example_cache,
                           name: str = "decode_program", selector=None):
    """The greedy decode loop as one RegionProgram: each generated token
    is one ``DECODE_STEP`` whose state flows into a ``KV_APPEND`` commit
    and on to the next token; positions are frozen constants
    (:func:`position` tensors).  Returns
    the ``gen`` tokens (the first is the prefill's) as a tuple.  Capture
    runs the variants ``selector`` picks."""
    def gen_loop(run, tok, cache):
        toks = [tok]
        for i in range(gen - 1):
            tok, cache = run(regions.decode_step, tok, cache,
                             position(prompt_len + i))
            cache = run(regions.kv_append, cache)
            toks.append(tok)
        return tuple(toks)

    return capture(gen_loop, example_tok, example_cache, name=name,
                   selector=selector)


# ---------------------------------------------------------------------------
# The uncaptured path (the oracle of the captured one)
# ---------------------------------------------------------------------------

def build_server(cfg, batch: int, device, rwkv_impl: Optional[str] = None,
                 max_len: int = 0, offload_kv: bool = False):
    """(prefill, decode, make_cache) step functions without regions, each
    compiled (``fullgraph=True``) as the reference jits them, unless built
    inside ``disable_compile``.  ``prefill(params, batch, cache) ->
    (logits, cache)``; ``decode(params, tok, cache, pos) -> (next tok,
    cache)`` with the cache (argument 2) donated: the new state is written
    over the old one, which the caller must not read again.  ``max_len``
    sizes an attention arch's KV cache (prompt + generated tokens).

    ``offload_kv`` keeps the ``k``/``v`` leaves in host memory between
    steps (:func:`place_kv_leaves` into :func:`~repro_torch.core.umem.
    default_spill_space`): ``make_cache`` places them there, and each step
    copies them to ``device`` for its call and its results back."""
    prefill = S.make_prefill_step(cfg, lambda: prefill_ctx(rwkv_impl))
    decode = make_greedy_decode(cfg)
    if not compile_disabled():
        prefill = compile_region_fn(prefill, f"prefill_{rwkv_impl}")
        decode = compile_region_fn(decode, "decode", donate=(2,))
    kv_space = umem.default_spill_space() if offload_kv else None

    def make_cache():
        cache = T.init_cache(cfg, batch, device, max_len)
        if kv_space is not None:
            cache = place_kv_leaves(cache, kv_space, device=device)
        return cache

    if kv_space is not None:
        prefill, decode = (_kv_offloaded(f, kv_space, device)
                           for f in (prefill, decode))
    return prefill, decode, make_cache


def _kv_offloaded(step, kv_space: MemSpace, device):
    """``step`` with its ``k``/``v`` arguments copied to ``device`` for the
    call and its ``k``/``v`` results placed back in ``kv_space``."""
    def offloaded(*args):
        args = place_kv_leaves(args, MemSpace.DEVICE, device=device)
        return place_kv_leaves(step(*args), kv_space, device=device)
    offloaded.stats = getattr(step, "stats", None)
    return offloaded


def decode_stream(decode, params, tok, cache, prompt_len: int, gen: int,
                  sync_every: int = 0):
    """Greedy decode without regions.  ``sync_every <= 0`` never syncs
    mid-stream: the whole stream is queued and waited on once, at the
    end.  ``sync_every = K > 0`` also waits once every ``K`` tokens (1 is
    a sync per token)."""
    toks = [tok]
    for i in range(gen - 1):
        tok, cache = decode(params, tok, cache, position(prompt_len + i))
        toks.append(tok)
        if sync_every > 0 and (i + 1) % sync_every == 0:
            synchronize()
    synchronize()
    return toks, cache


def replay_request_groups(cfg, ex, decode_prog, prefill, make_cache, params,
                          args, n_groups: int, device):
    """The heavy-traffic path: prefill ``n_groups`` independent request
    groups (prompts from ``--seed`` + 1), then push all of them through the
    captured decode program at once as one vmapped composite
    (:meth:`~repro_torch.core.program.RegionProgram.replay_batch`), and
    replay each group alone through the same program.  Returns the tokens
    [N, B, gen] of the batched and of the solo replays (on the host), and
    the batched call's seconds."""
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    toks, caches = [], []
    for _ in range(n_groups):
        prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                                generator=gen, device=device,
                                dtype=torch.int32)
        logits, cache = prefill(params, {"tokens": prompts}, make_cache())
        toks.append(greedy(logits))
        caches.append(cache)
    stacked_cache = pytree.tree_map(lambda *xs: torch.stack(xs), *caches)
    t0 = time.perf_counter()
    out = decode_prog.replay_batch(torch.stack(toks), stacked_cache,
                                   executor=ex, selector=ex.policy.selector)
    dt = time.perf_counter() - t0
    seqs = torch.stack(out, dim=-1).cpu()                 # (N, B, gen)
    solo = torch.stack([torch.stack(decode_prog.replay(ex, t, c), dim=-1)
                        for t, c in zip(toks, caches)]).cpu()
    return seqs, solo, dt


def prefill_rwkv_impl(ex, regions: ServeRegions, batch, cache):
    """The ``Ctx.rwkv_impl`` that ``PREFILL`` runs under ``ex``'s policy on
    these operands: the variant its selector picks for the target its
    router picks (a host-routed call runs ``ref``)."""
    pol, r = ex.policy, regions.prefill
    n = r.size_fn((batch, cache), {})
    tgt = pol.router.target(r, (batch, cache), {}, size=n)
    return PREFILL_RWKV_IMPL[r.resolve(
        pol.selector.select(r, tgt, (batch, cache), {}, size=n))]


def _engine_demo(cfg, params, ex, args, max_len, device):
    """The continuous-batching engine under the launcher's flags: seeded
    Poisson traffic with ragged prompt and generation lengths through
    :class:`~repro_torch.serve.ServeEngine`, each request's tokens
    asserted equal to its solo decode's."""
    # imported here: repro_torch.serve runs on this module's regions
    from repro_torch.core.oversub import MemoryBudget
    from repro_torch.serve import (PagedKVCache, ServeEngine, make_traffic,
                                   run_traffic, solo_reference)
    from repro_torch.serve.scheduler import batch_for_prompt
    from repro_torch.serve.traffic import assert_parity

    budget = None
    if args.kv_oversub_ratio > 0:
        # the logical device budget is 1/R of one parked full-length entry
        # times the slots, so R=2 runs a KV working set twice the budget
        probe = PagedKVCache(page_tokens=args.page_tokens, device=device)
        probe.commit(0, T.init_cache(cfg, 1, device, max_len),
                     true_len=max_len)
        footprint = probe.total_bytes * args.slots
        probe.free(0)
        budget = MemoryBudget.for_ratio(footprint, args.kv_oversub_ratio,
                                        name="kv")
    kv = PagedKVCache(page_tokens=args.page_tokens,
                      device_budget_bytes=args.kv_device_budget or None,
                      total_budget_bytes=args.kv_total_budget or None,
                      budget=budget, device=device)
    engine = ServeEngine(cfg, params, ex, max_len=max_len,
                         n_slots=args.slots, kv=kv, device=device)
    lens = sorted({max(2, args.prompt_len // 2), args.prompt_len})
    gens = sorted({1, max(2, args.gen // 2), args.gen})
    reqs = make_traffic(args.seed, args.requests, cfg.vocab,
                        arrival_rate=args.rate, prompt_lens=lens,
                        gen_lens=gens)
    metrics = run_traffic(engine, reqs)
    impl = prefill_rwkv_impl(
        ex, engine.regions, batch_for_prompt(reqs[0].prompt, device),
        T.init_cache(cfg, 1, device, max_len))
    oracle, solo_wall = solo_reference(cfg, params, reqs, max_len,
                                       device=device, rwkv_impl=impl,
                                       offload_kv=args.offload_kv)
    assert_parity(reqs, oracle)        # the acceptance invariant
    solo_tps = metrics["tokens"] / max(solo_wall, 1e-9)
    st = kv.stats
    spill_note = (f"; {st.pages_spilled} pages spilled to host"
                  f" ({st.pages_fetched} fetched back)"
                  if st.pages_spilled else "")
    evict_note = f"; {st.evictions} evictions" if st.evictions else ""
    if budget is not None:
        evict_note += (f"; oversub x{args.kv_oversub_ratio:g} budget "
                       f"{budget.limit_bytes} B (high water "
                       f"{budget.stats.high_water_bytes} B, "
                       f"{budget.stats.pressure_events} pressure events)")
    print(f"[serve] engine {args.arch}"
          f"{' (reduced)' if args.reduced else ''} [{ex.mode}, "
          f"{device.type}]: {metrics['requests']} requests / "
          f"{metrics['tokens']} tokens in {metrics['wall_s'] * 1e3:.1f} ms: "
          f"{metrics['tokens_per_s']:.0f} tok/s engine vs {solo_tps:.0f} "
          f"tok/s sequential solo; p50 {metrics.get('p50_token_ms', 0.0):.2f}"
          f" / p99 {metrics.get('p99_token_ms', 0.0):.2f} ms/token; KV page "
          f"high water {st.device_high_water_bytes} B device{spill_note}"
          f"{evict_note}; parity OK vs solo decode")
    if args.report:
        print(json.dumps(ex.report(), indent=1, default=str))
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--policy", default="unified", choices=POLICY_CHOICES)
    ap.add_argument("--impl", choices=("hopper", "ref"), default="hopper",
                    help="variant the policy's selector picks: hopper runs "
                         "prefill's time-mix scan on the CUDA kernel K5")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--offload-kv", action="store_true",
                    help="role-keyed KV offload to host memory: a Placer in "
                         "the policy, nothing else changes")
    ap.add_argument("--sync-every", type=int, default=0, metavar="K",
                    help="uncaptured path: sync once per K tokens; K <= 0: "
                         "one final sync at the end of the stream")
    ap.add_argument("--replay-batch", type=int, default=0, metavar="N",
                    help="also prefill N request groups and replay the "
                         "captured decode program over all of them at once "
                         "(RegionProgram.replay_batch)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching instead of the static batch: "
                         "Poisson traffic through slot-scheduled decode "
                         "over a paged KV cache, each request's tokens "
                         "asserted equal to its solo decode's")
    ap.add_argument("--slots", type=int, default=4, metavar="N",
                    help="engine decode slots")
    ap.add_argument("--requests", type=int, default=8, metavar="N",
                    help="engine traffic size (seeded by --seed)")
    ap.add_argument("--rate", type=float, default=1.0, metavar="R",
                    help="engine mean arrivals per tick (Poisson)")
    ap.add_argument("--page-tokens", type=int, default=8, metavar="T",
                    help="engine KV page size along the token axis")
    ap.add_argument("--kv-device-budget", type=int, default=0, metavar="B",
                    help="engine paged-KV device budget in bytes; beyond it "
                         "LRU entries spill to host memory (0: unlimited)")
    ap.add_argument("--kv-total-budget", type=int, default=0, metavar="B",
                    help="engine paged-KV total budget in bytes; beyond it "
                         "LRU requests are evicted and re-queued (0: "
                         "unlimited)")
    ap.add_argument("--kv-oversub-ratio", type=float, default=0.0,
                    metavar="R",
                    help="engine KV oversubscription: a MemoryBudget of 1/R "
                         "of the slots' full-length KV footprint (0: off)")
    ap.add_argument("--verify", action="store_true",
                    help="lint the captured programs (waits for ROADMAP A.8)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard --replay-batch over N devices (waits for "
                         "ROADMAP A.9)")
    ap.add_argument("--report", action="store_true",
                    help="print the run's coverage_report() as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be >= 1")
    if args.replay_batch < 0:
        ap.error("--replay-batch must be >= 0")
    if args.verify:
        raise NotImplementedError("--verify needs the program verifier, "
                                  "which is not ported yet (ROADMAP A.8)")
    if args.mesh:
        raise NotImplementedError("--mesh needs the sharded replay, which is "
                                  "not ported yet (ROADMAP A.9)")
    if args.engine and args.replay_batch:
        ap.error("--engine replaces the static batch; it does not compose "
                 "with --replay-batch")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    max_len = args.prompt_len + args.gen
    device = resolve_device(args.device)
    placer = offload_kv_cache(device=device) if args.offload_kv else None
    ex = Executor(lm_policy(args.policy, cfg.memory, placer=placer,
                            selector=StaticSelector(args.impl),
                            device=device), Ledger("serve"))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init(gen, cfg, device)
    if args.engine:
        return _engine_demo(cfg, params, ex, args, max_len, device)
    regions = make_serve_regions(cfg, params, ledger=ex.ledger)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": prompts}

    # -- captured-program path (the accounted serving spine) -------------
    selector = ex.policy.selector
    prefill_prog = capture_prefill_program(
        regions, batch, T.init_cache(cfg, args.batch, device, max_len),
        selector=selector)
    t0 = time.perf_counter()
    tok, cache = prefill_prog.replay(
        ex, batch, T.init_cache(cfg, args.batch, device, max_len))
    t_prefill = time.perf_counter() - t0
    # capture runs the regions eagerly, so its examples live on the card
    # (under the discrete policy the replay handed them back in host pages)
    decode_prog = capture_decode_program(
        regions, args.prompt_len, args.gen,
        *tree_place((tok, cache), MemSpace.DEVICE, device),
        selector=selector)
    t1 = time.perf_counter()
    toks = decode_prog.replay(ex, tok, cache)
    t_decode = time.perf_counter() - t1
    seq = torch.stack([t.cpu() for t in toks], dim=1)

    # -- the uncaptured path: under the unified policy, the oracle -------
    stream_note = ""
    impl = PREFILL_RWKV_IMPL[regions.prefill.resolve(args.impl)]
    prefill, decode, make_cache = build_server(cfg, args.batch, device,
                                               rwkv_impl=impl,
                                               max_len=max_len,
                                               offload_kv=args.offload_kv)
    if args.policy == "unified":
        logits, cache_j = prefill(params, batch, make_cache())
        t2 = time.perf_counter()
        toks_j, _ = decode_stream(decode, params, greedy(logits), cache_j,
                                  args.prompt_len, args.gen,
                                  sync_every=args.sync_every)
        t_stream = time.perf_counter() - t2
        seq_j = torch.stack([t.cpu() for t in toks_j], dim=1)
        if not torch.equal(seq, seq_j):     # the acceptance invariant
            raise AssertionError("replayed tokens differ from the uncaptured "
                                 f"path's:\n{seq}\n{seq_j}")
        stream_note = (f", {args.batch * args.gen / max(t_stream, 1e-9):.0f} "
                       "tok/s uncaptured")

    total_new = args.batch * args.gen
    print(f"[serve] {args.arch}{' (reduced)' if args.reduced else ''} "
          f"[{ex.mode}, {args.impl}, {device.type}]: prefill "
          f"{args.batch}x{args.prompt_len} in {t_prefill * 1e3:.1f} ms; decode "
          f"{total_new} tokens in {t_decode * 1e3:.1f} ms "
          f"({total_new / max(t_decode, 1e-9):.0f} tok/s program{stream_note})"
          + (f" [KV in {placer.kv_space.value}]" if placer else ""))
    if args.replay_batch:
        n = args.replay_batch
        seqs, solo, dt = replay_request_groups(
            cfg, ex, decode_prog, prefill, make_cache, params, args, n,
            device)
        agree = (seqs == solo).float().mean().item()
        total = seqs.numel()
        print(f"[serve] replay_batch: {n} request groups x {args.batch}x"
              f"{args.gen} tokens = {total} tokens in {dt * 1e3:.1f} ms "
              f"({total / max(dt, 1e-9):.0f} tok/s); solo-replay agreement "
              f"{agree:.3f}")
    if args.report:
        print(json.dumps(ex.report(), indent=1, default=str))
    return seq


if __name__ == "__main__":
    main()
