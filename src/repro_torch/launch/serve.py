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

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA where there
is none raises.  The engine, ``--mesh``, ``--offload-kv``, ``--verify``,
``--sync-every`` and the KV budgets wait (ROADMAP A.6, A.8, A.9).
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
from repro_torch.core.regions import (Executor, StaticSelector,
                                      compile_disabled, compile_region_fn,
                                      region, synchronize)
from repro_torch.core.umem import MemSpace, resolve_device, tree_place
from repro_torch.launch.policy import POLICY_CHOICES, lm_policy
from repro_torch.models import transformer as T
from repro_torch.train import step as S

#: the ``Ctx.rwkv_impl`` each variant of ``PREFILL`` runs with
PREFILL_RWKV_IMPL = {"ref": None, "hopper": "hopper"}

#: prefill's attention query chunk (the reference serve's ``q_chunk``)
Q_CHUNK = 256


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
                 max_len: int = 0):
    """(prefill, decode, make_cache) step functions without regions, each
    compiled (``fullgraph=True``) as the reference jits them, unless built
    inside ``disable_compile``.  ``prefill(params, batch, cache) ->
    (logits, cache)``; ``decode(params, tok, cache, pos) -> (next tok,
    cache)`` with the cache (argument 2) donated: the new state is written
    over the old one, which the caller must not read again.  ``max_len``
    sizes an attention arch's KV cache (prompt + generated tokens)."""
    prefill = S.make_prefill_step(cfg, lambda: prefill_ctx(rwkv_impl))
    decode = make_greedy_decode(cfg)
    if not compile_disabled():
        prefill = compile_region_fn(prefill, f"prefill_{rwkv_impl}")
        decode = compile_region_fn(decode, "decode", donate=(2,))
    return prefill, decode, lambda: T.init_cache(cfg, batch, device, max_len)


def decode_stream(decode, params, tok, cache, prompt_len: int, gen: int):
    """Greedy decode without regions; one synchronise at the end."""
    toks = [tok]
    for i in range(gen - 1):
        tok, cache = decode(params, tok, cache, position(prompt_len + i))
        toks.append(tok)
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
    ap.add_argument("--replay-batch", type=int, default=0, metavar="N",
                    help="also prefill N request groups and replay the "
                         "captured decode program over all of them at once "
                         "(RegionProgram.replay_batch)")
    ap.add_argument("--report", action="store_true",
                    help="print the run's coverage_report() as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be >= 1")
    if args.replay_batch < 0:
        ap.error("--replay-batch must be >= 0")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    max_len = args.prompt_len + args.gen
    device = resolve_device(args.device)
    ex = Executor(lm_policy(args.policy, selector=StaticSelector(args.impl),
                            device=device), Ledger("serve"))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init(gen, cfg, device)
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
                                               max_len=max_len)
    if args.policy == "unified":
        logits, cache_j = prefill(params, batch, make_cache())
        t2 = time.perf_counter()
        toks_j, _ = decode_stream(decode, params, greedy(logits), cache_j,
                                  args.prompt_len, args.gen)
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
          f"({total_new / max(t_decode, 1e-9):.0f} tok/s program{stream_note})")
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
