"""Seeded synthetic serving traffic and the solo-decode parity oracle
(counterpart of ``repro.serve.traffic``).

Traffic is drawn in *tick units*: the engine has no clock of its own (one
:meth:`~repro_torch.serve.scheduler.ServeEngine.step` is one tick), so
Poisson arrivals are exponential gaps measured in ticks, and a request
joins the engine when the traffic loop reaches its arrival tick.  Prompt
and generation lengths come from small discrete mixes; each distinct
prompt length owns one captured prefill program.  :func:`make_traffic`
draws the same numpy stream as the reference's, so one seed gives the
same requests in both packages.

:func:`solo_reference` is the parity oracle and the latency yardstick:
every request decoded alone, at batch 1, on the uncaptured path
(:func:`~repro_torch.launch.serve.build_server` +
:func:`~repro_torch.launch.serve.decode_stream`).  The engine's tokens
must equal it request for request, under every policy.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.serve import build_server, decode_stream, greedy
from repro_torch.serve.scheduler import Request, ServeEngine, \
    batch_for_prompt


def make_traffic(seed: int, n_requests: int, vocab: int, *,
                 arrival_rate: float = 1.0,
                 prompt_lens: Sequence[int] = (6, 10),
                 gen_lens: Sequence[int] = (5, 9)) -> List[Request]:
    """A Poisson arrival stream with mixed prompt and generation lengths,
    seeded.  ``arrival_rate`` is the expected arrivals per engine tick;
    the requests are in arrival order, with ids in that order.  The first
    ``n`` requests of a draw of ``m >= n`` are a draw of ``n``."""
    if arrival_rate <= 0:
        raise ValueError("arrival_rate must be > 0")
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / arrival_rate)
        L = int(rng.choice(prompt_lens))
        G = int(rng.choice(gen_lens))
        prompt = rng.integers(0, vocab, size=L).astype(np.int32)
        out.append(Request(req_id=rid, prompt=prompt, gen=G,
                           arrival_tick=int(t)))
    return out


def _warm_engine(engine: ServeEngine, requests: Sequence[Request]) -> None:
    """Compile off the clock: one throwaway request per distinct prompt
    length (each length owns a prefill program) with a decode tick each,
    then reset the ledger's timings and serve accounts, so the measured
    run starts clean."""
    rng = np.random.default_rng(0)
    for k, L in enumerate(sorted({r.prompt_len for r in requests})):
        prompt = rng.integers(0, engine.cfg.vocab, size=L).astype(np.int32)
        engine.submit(Request(req_id=-1 - k, prompt=prompt, gen=2))
    engine.drain()
    engine.ledger.reset_timings()


def run_traffic(engine: ServeEngine, requests: Sequence[Request],
                max_ticks: int = 100_000, warmup: bool = True) -> dict:
    """Drive the engine through an arrival stream and measure it.

    Tokens/s counts every emitted token (the prefill's first token and the
    decoded ones) over the wall time from the first submission to the
    drain.  Per-token latency is the gap between consecutive tokens of one
    request; first-token latency is submission to first token."""
    if warmup:
        _warm_engine(engine, requests)
    pending = sorted(requests, key=lambda r: (r.arrival_tick, r.req_id))
    i = 0
    t0 = time.perf_counter()
    for tick in range(max_ticks):
        while i < len(pending) and pending[i].arrival_tick <= tick:
            engine.submit(pending[i])
            i += 1
        did = engine.step()
        if not did and i >= len(pending):
            break
    else:
        raise RuntimeError(f"traffic did not drain in {max_ticks} ticks")
    wall_s = time.perf_counter() - t0

    gaps_ms: List[float] = []
    first_ms: List[float] = []
    tokens = 0
    for r in requests:
        assert r.done, f"request {r.req_id} not done: {r.state}"
        tokens += len(r.tokens)
        if r.token_times:
            first_ms.append((r.token_times[0] - r.submit_time) * 1e3)
            gaps_ms.extend(np.diff(r.token_times) * 1e3)
    lat = {}
    if gaps_ms:
        lat = {"p50_token_ms": float(np.percentile(gaps_ms, 50)),
               "p99_token_ms": float(np.percentile(gaps_ms, 99))}
    return {
        "wall_s": wall_s,
        "tokens": tokens,
        "tokens_per_s": tokens / max(wall_s, 1e-9),
        "requests": len(requests),
        "evictions": sum(r.evictions for r in requests),
        "first_token_p50_ms": float(np.percentile(first_ms, 50))
        if first_ms else 0.0,
        **lat,
    }


def solo_reference(cfg, params, requests: Sequence[Request], max_len: int,
                   *, device="cuda", rwkv_impl: Optional[str] = None,
                   offload_kv: bool = False
                   ) -> Tuple[Dict[int, List[int]], float]:
    """Sequential solo decodes on the uncaptured path: each request
    prefilled (with ``Ctx.rwkv_impl=rwkv_impl``, the variant the engine's
    ``PREFILL`` runs) and greedily decoded alone at batch 1.  Returns the
    tokens of each request (the parity oracle) and the sequential wall
    seconds, compiles excluded by a warm-up pass over each distinct
    shape."""
    prefill, decode, make_cache = build_server(
        cfg, 1, device, rwkv_impl=rwkv_impl, max_len=max_len,
        offload_kv=offload_kv)

    def one(req: Request) -> List[int]:
        logits, cache = prefill(params, batch_for_prompt(req.prompt, device),
                                make_cache())
        tok = greedy(logits)
        if req.gen <= 1:
            return [int(tok.cpu()[0])]
        toks, _ = decode_stream(decode, params, tok, cache,
                                req.prompt_len, req.gen)
        return [int(t.cpu()[0]) for t in toks]

    # one pass per distinct (prompt length, decodes) pair compiles the
    # prefill at each length and the decode step
    seen = set()
    for req in requests:
        key = (req.prompt_len, req.gen > 1)
        if key not in seen:
            seen.add(key)
            one(req)

    t0 = time.perf_counter()
    out = {req.req_id: one(req) for req in requests}
    wall_s = time.perf_counter() - t0
    return out, wall_s


def assert_parity(requests: Sequence[Request],
                  oracle: Dict[int, List[int]]) -> None:
    """The parity contract: every engine token sequence equals the solo
    decode of the same prompt, token for token."""
    for r in requests:
        np.testing.assert_array_equal(
            np.asarray(r.tokens), np.asarray(oracle[r.req_id]),
            err_msg=f"request {r.req_id} diverged from its solo decode")
