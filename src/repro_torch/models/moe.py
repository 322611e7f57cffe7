"""Mixture-of-Experts MLP of the port (counterpart of
``repro.models.moe``): top-k routing with group-local, sort-based
capacity dispatch, and host-resident expert paging for oversubscribed
decode.

:func:`moe_mlp` splits the ``T`` tokens into ``G`` groups (the largest
divisor of ``T`` up to 16), flattens each group's (token, expert-choice)
pairs, ranks each pair within its expert from a cumulative count (the
rank the reference takes after a stable sort by expert id), scatters the
kept pairs into a dense
``[G, E*C + 1, d]`` buffer (row ``E*C`` takes the drops), runs both
expert products as batched matmuls over the experts, gathers back and
combines with the router weights in f32.  Pairs beyond an expert's
capacity ``C = ceil(Tg*k/E * cf)`` (rounded up to 8) are dropped.  Every
shape is static (no ``.item()``, no boolean-mask indexing), so the layer
compiles with ``fullgraph=True``.

Three departures from the reference keep results deterministic on a
card: ``jax.lax.top_k``'s order (descending, ties to the lower index)
comes from ``k`` rounds of ``argmax`` (:func:`_top_k`; ``torch.topk`` on
CUDA promises neither), the ranks from a cumulative count instead of a
sort (a compiled sort need not keep the order of equal keys), and the
combine sums each token's ``k`` pairs in a fixed order (ascending expert
id, as the reference's serial scatter-add on the CPU does) instead of an
atomic ``index_add_``.

``moe_ref`` is the O(T*E) dense oracle.

:class:`ExpertPager` + :func:`moe_decode_paged` are the oversubscription
path (``repro_torch.core.oversub``): the stacked expert weights live in
pinned host memory, and only the experts the router selects are paged
into an LRU device-resident working set bounded by a ``MemoryBudget``.
Compute order is fixed (ascending expert id, f32 accumulate), so a
budgeted run is bit for bit the everything-resident run.  While expert
``i`` computes, one background thread fetches expert ``i+1``'s slab on a
side CUDA stream; the fetch-behind-compute overlap is accounted with
:func:`~repro_torch.core.program.interval_overlap` (host-clock intervals:
a fetch's ends at its copies' completion, a compute span's at the
compute stream's), as ``stats.prefetch_overlap_s`` and the
``moe_prefetch_overlap_s`` ledger gauge.

The expert products are plain batched matmuls: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import umem
from repro_torch.core.program import interval_overlap
from repro_torch.core.umem import MemSpace
from repro_torch.models.layers import mlp, noshard
from repro_torch.models.params import ParamSpec

#: groups of the dispatch (the reference's ``moe_mlp(n_groups=16)``)
N_GROUPS = 16


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, pd = cfg.d_model, cfg.param_dtype
    s = {
        "router": ParamSpec((d, m.n_experts), ("embed", "experts"), "float32"),
        "wi_gate": ParamSpec((m.n_experts, d, m.d_ff), ("experts", "embed", "moe_ff"), pd),
        "wi_up": ParamSpec((m.n_experts, d, m.d_ff), ("experts", "embed", "moe_ff"), pd),
        "wo": ParamSpec((m.n_experts, m.d_ff, d), ("experts", "moe_ff", "embed"), pd),
    }
    if m.shared_expert_ff:
        f = m.shared_expert_ff
        s["shared"] = {
            "wi_gate": ParamSpec((d, f), ("embed", "ff"), pd),
            "wi_up": ParamSpec((d, f), ("embed", "ff"), pd),
            "wo": ParamSpec((f, d), ("ff", "embed"), pd),
        }
    return s


def _top_k(probs, k: int):
    """``jax.lax.top_k`` along the last axis: values in descending order,
    ties to the lower index.  ``k`` rounds of ``argmax`` (the first of
    equal maxima), each masking its pick: no sort, whose order of equal
    keys a compiled graph need not keep."""
    vals, idxs = [], []
    rest = probs
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idxs.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _one_hot(idx, n: int, dtype=torch.float32):
    """``jax.nn.one_hot``: a comparison with ``arange(n)`` (static
    shapes, no check of the values)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _aux(probs, idx, E: int):
    """Switch-style load-balancing loss of ``probs [..., E]`` and the
    experts ``idx [..., k]``, averaged over every leading axis."""
    lead = tuple(range(probs.dim() - 1))
    density = torch.mean(_one_hot(idx[..., 0], E), dim=lead)
    return E * torch.sum(density * torch.mean(probs, dim=lead))


def _router(p, x2, m):
    """x2 [T, d] -> (gate_weights [T,k], expert_ids [T,k], aux_loss)."""
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, m.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, idx, _aux(probs, idx, logits.shape[-1])


def _capacity(T: int, m) -> int:
    c = int(T * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 lanes


def _largest_divisor(T: int, G: int) -> int:
    while G > 1 and T % G:
        G -= 1
    return max(G, 1)


def dispatch_shape(T: int, m, n_groups: int = N_GROUPS):
    """(G groups, Tg tokens a group, capacity C) of ``T`` tokens."""
    G = _largest_divisor(T, n_groups)
    return G, T // G, _capacity(T // G, m)


def route(p, x, m, n_groups: int = N_GROUPS) -> dict:
    """The group-local routing and dispatch plan of ``x [B, S, d]``:
    ``gate``/``idx`` ``[G, Tg, k]`` (normalised weights, expert ids),
    ``aux``, ``counts`` ``[G, E]`` (pairs an expert), and per (token,
    expert) pair of a group, token-major ``[G, Tg*k]``: ``keep`` (within
    capacity) and ``dst`` (its buffer row, ``E*C`` if dropped).

    A pair's rank within its expert is the count of the group's earlier
    pairs of that expert (a cumulative one-hot count): the rank the
    reference takes after a stable sort by expert id, with no sort."""
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G, Tg, C = dispatch_shape(B * S, m, n_groups)
    xg = x.reshape(G, Tg, d)
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, k)                     # [G,Tg,k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    aux = _aux(probs, idx, E)

    fe = idx.reshape(G, Tg * k)                      # expert id per pair
    oh = _one_hot(fe, E, torch.int32)                # [G, Tg*k, E]
    rank = torch.gather(torch.cumsum(oh, dim=1) - oh, 2, fe[..., None])[..., 0]
    keep = rank < C
    dst = torch.where(keep, fe * C + rank, E * C)    # [G, Tg*k]
    return dict(gate=gate, idx=idx, aux=aux, keep=keep, dst=dst,
                shape=(G, Tg, C), counts=oh.sum(1))


def _experts(h, p, dtype):
    """SwiGLU of each expert on its rows: h [E, R, d] -> [E, R, d]."""
    g_ = torch.bmm(h, p["wi_gate"])
    u = torch.bmm(h, p["wi_up"])
    o = F.silu(g_.float()).to(dtype) * u
    return torch.bmm(o, p["wo"])


def moe_mlp(p, x, cfg, shd=noshard, n_groups: int = N_GROUPS):
    """x [B, S, d] -> (y [B, S, d], aux_loss), the reference's group-local
    dispatch (module docstring)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    r = route(p, x, m, n_groups)
    G, Tg, C = r["shape"]
    xg = shd(x.reshape(G, Tg, d), "expert_group", None, None)

    # scatter the kept pairs into their rows; every dropped pair writes
    # zeros to the overflow row E*C, which is discarded, so the order of
    # those colliding writes does not matter
    pairs = xg[:, :, None].expand(G, Tg, k, d).reshape(G, Tg * k, d)
    upd = torch.where(r["keep"][..., None], pairs,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, r["dst"][..., None].expand(-1, -1, d), upd)
    # [G, E*C, d] -> [E, G*C, d]: each expert's rows of every group, one
    # batched product per expert weight
    h = buf[:, :E * C].reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    o = _experts(h, p, x.dtype)
    o = o.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    o_flat = torch.cat([o, torch.zeros((G, 1, d), dtype=x.dtype,
                                       device=x.device)], dim=1)

    # combine: each pair's row gathered back, weighted in f32, and each
    # token's k pairs summed in a fixed order (ascending expert id, as the
    # reference's serial scatter-add adds them) with no atomics; a token's
    # k experts are distinct, so any sort gives the one order
    asc = torch.argsort(r["idx"], dim=-1)
    dst = torch.gather(r["dst"].reshape(G, Tg, k), 2, asc).reshape(G, Tg * k)
    per_pair = torch.gather(o_flat, 1, dst[..., None].expand(-1, -1, d))
    per_pair = per_pair.float().reshape(G, Tg, k, d) * \
        torch.gather(r["gate"], 2, asc)[..., None]
    yg = torch.zeros((G, Tg, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        yg = yg + per_pair[:, :, j]
    y = shd(yg.to(x.dtype).reshape(B, S, d), "batch", None, None)

    if m.shared_expert_ff:
        y = y + mlp(p["shared"], x)
    return y, r["aux"]


def moe_ref(p, x, cfg):
    """O(T*E) dense oracle: every expert on every token, masked combine.
    No capacity drops."""
    m = cfg.moe
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gate, idx, aux = _router(p, x2, m)
    T = x2.shape[0]
    o = _experts(x2.expand(m.n_experts, T, d), p, x.dtype)   # [E,T,d]
    mask = _one_hot(idx, m.n_experts)                        # [T,k,E]
    w = (mask * gate[..., None]).sum(1)                      # [T,E]
    y = torch.einsum("etd,te->td", o.float(), w).to(x.dtype)
    y = y.reshape(B, S, d)
    if m.shared_expert_ff:
        y = y + mlp(p["shared"], x)
    return y, aux


# ---------------------------------------------------------------------------
# Host-resident expert paging (oversubscribed decode)
# ---------------------------------------------------------------------------

#: the stacked per-expert weight matrices the pager slices slabs from
EXPERT_KEYS = ("wi_gate", "wi_up", "wo")


@dataclasses.dataclass
class PagingStats:
    fetches: int = 0                # host -> device expert slab moves
    hits: int = 0                   # expert already device-resident
    evictions: int = 0              # LRU slabs dropped to fit the budget
    bytes_fetched: int = 0
    prefetch_hits: int = 0          # fetches satisfied by the lookahead
    prefetch_overlap_s: float = 0.0  # fetch time hidden behind compute

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ExpertPager:
    """LRU device-resident working set of expert weight slabs over
    host-resident stacks, bounded by a
    :class:`~repro_torch.core.oversub.MemoryBudget`.

    The stacked ``wi_gate``/``wi_up``/``wo`` parameters (``[E, ...]``) are
    parked in ``host_space`` (pinned host memory by default,
    ``umem.place``); :meth:`get` pages one expert's slab (``wi_gate
    [d,f]``, ``wi_up [d,f]``, ``wo [f,d]``) to ``device`` (the router's)
    and evicts least-recently-used slabs until the working set fits the
    budget again, never the slab about to be used.  The router (and a
    shared expert) stay where they are: routing runs before the pager
    knows which experts a token needs.

    On a card a slab is copied on a side CUDA stream; the copy's host
    interval ends when the stream has finished it, and the compute stream
    waits on the copy's event before it reads the slab.  On the CPU the
    moves are logical (``umem.place`` to the CPU is the tensor itself),
    as in the reference."""

    def __init__(self, p, cfg, budget=None,
                 host_space: Optional[MemSpace] = None,
                 lookahead: bool = True, device=None):
        m = cfg.moe
        self.n_experts = m.n_experts
        self.budget = budget
        self.router = p["router"]              # device-resident by design
        self.shared = p.get("shared")
        self.device = umem.resolve_device(
            device if device is not None else self.router.device)
        host = host_space or MemSpace.HOST
        self._host = {k: umem.place(p[k], host, self.device)
                      for k in EXPERT_KEYS}
        self.slab_bytes = sum(umem.nbytes(p[k][0]) for k in EXPERT_KEYS)
        self._resident: Dict[int, dict] = {}   # expert id -> slab (LRU order)
        self.stats = PagingStats()
        self.lookahead = lookahead
        self._lock = threading.Lock()
        self._pending: Dict[int, object] = {}  # expert id -> Future
        self._pf_pool = None                   # created on first prefetch
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    @property
    def footprint_bytes(self) -> int:
        """Device bytes an everything-resident run would pin — the
        numerator of the oversubscription ratio."""
        return self.slab_bytes * self.n_experts

    @property
    def resident_bytes(self) -> int:
        return self.slab_bytes * len(self._resident)

    def _fetch_slab(self, e: int) -> tuple:
        """Page expert ``e`` device-ward; returns (slab, done, t0, t1):
        ``done`` the copies' CUDA event (None on the CPU) and the fetch's
        host interval, which ends when the copies have finished."""
        t0 = time.perf_counter()
        if self._side is None:
            slab = {k: umem.place(self._host[k][e], MemSpace.DEVICE,
                                  self.device) for k in EXPERT_KEYS}
            return slab, None, t0, time.perf_counter()
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            slab = {k: self._host[k][e].to(self.device, non_blocking=True)
                    for k in EXPERT_KEYS}
            done = torch.cuda.Event()
            done.record(self._side)
        done.synchronize()
        return slab, done, t0, time.perf_counter()

    def prefetch(self, e: int) -> None:
        """Hint that expert ``e`` is needed next: start fetching its slab
        on the single staging thread while the caller computes the current
        expert.  No-op when the slab is resident, already in flight, or
        ``lookahead`` is off.  Budget charging and eviction happen when
        :meth:`get` installs the slab, so the one in-flight slab is the
        only budget slack the lookahead adds."""
        e = int(e)
        if not self.lookahead:
            return
        with self._lock:
            if e in self._resident or e in self._pending:
                return
            if self._pf_pool is None:
                self._pf_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="expert-prefetch")
            self._pending[e] = self._pf_pool.submit(self._fetch_slab, e)

    def get(self, e: int, compute_spans=None) -> dict:
        """The device-resident slab of expert ``e``, fetching and evicting
        as the budget requires.  A slab arriving via :meth:`prefetch`
        still counts as a fetch (the bytes moved); the time its fetch hid
        behind the caller's ``compute_spans`` intervals accrues to
        ``stats.prefetch_overlap_s``."""
        e = int(e)
        with self._lock:
            slab = self._resident.pop(e, None)
            if slab is not None:
                self._resident[e] = slab       # re-insert = LRU touch
                self.stats.hits += 1
                return slab
            fut = self._pending.pop(e, None)
        if fut is not None:
            slab, done, t0, t1 = fut.result()
            self.stats.prefetch_hits += 1
            if compute_spans:
                self.stats.prefetch_overlap_s += interval_overlap(
                    t0, t1, compute_spans)
        else:
            slab, done, _, _ = self._fetch_slab(e)
        if done is not None:
            # the compute stream reads the slab after its copies, and the
            # allocator keeps its memory until that stream is past it
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for v in slab.values():
                v.record_stream(compute)
        with self._lock:
            self._resident[e] = slab
            self.stats.fetches += 1
            self.stats.bytes_fetched += self.slab_bytes
            if self.budget is not None:
                self.budget.charge(self.slab_bytes)
                # shed LRU slabs until we fit again — but never the slab
                # the caller is about to compute with
                while self.budget.over and len(self._resident) > 1:
                    victim = next(iter(self._resident))
                    if victim == e:
                        break
                    self._resident.pop(victim)
                    self.budget.release(self.slab_bytes)
                    self.stats.evictions += 1
        return slab

    def drop(self) -> None:
        """Release the whole resident set (end of a decode stream)."""
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            fut.cancel()                       # running fetches just expire
        if self.budget is not None:
            self.budget.release(self.resident_bytes)
        self._resident.clear()

    def close(self) -> None:
        """:meth:`drop`, and stop the staging thread."""
        self.drop()
        if self._pf_pool is not None:
            self._pf_pool.shutdown(wait=True)
            self._pf_pool = None


def _sync(device) -> None:
    """Wait until the compute stream of ``device`` is idle (a compute
    span's end; the pager's side stream runs on)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def moe_decode_paged(pager: ExpertPager, x, cfg, ledger=None):
    """x [B, S, d] -> (y [B, S, d], aux_loss), computing only the experts
    the router selects, each through :meth:`ExpertPager.get`.

    Dense per-expert compute over all T tokens with a FIXED accumulation
    order — ascending expert id, f32 accumulate, per-token gate mask — so
    the output is a pure function of the values, not of which slabs
    happened to be resident: budgeted and unbudgeted runs are bit for bit
    equal.  Matches ``moe_ref`` to tolerance.

    The routing runs on the router's device and its decisions come to the
    host (one synchronisation), which drives the expert loop.  Before
    computing expert ``i`` the loop prefetches expert ``i+1``; each
    expert's compute interval is recorded so the pager can account how
    much of the next fetch hid behind it.  With a ``ledger``, the
    cumulative hidden time lands on the ``moe_prefetch_overlap_s`` gauge
    and new lookahead hits on the ``moe_prefetch_hit`` counter."""
    m = cfg.moe
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gate, idx, aux = _router({"router": pager.router}, x2, m)
    y = torch.zeros((B * S, d), dtype=torch.float32, device=x.device)
    experts = sorted(set(idx.reshape(-1).tolist()))
    hits0 = pager.stats.prefetch_hits
    spans = []                       # compute intervals the fetches hide in
    for i, e in enumerate(experts):
        if i + 1 < len(experts):
            pager.prefetch(experts[i + 1])
        w = pager.get(e, compute_spans=spans)
        t0 = time.perf_counter()
        # one nonzero term per token: the sum is exact in any order
        we = (gate * (idx == e)).sum(-1)
        g = x2 @ w["wi_gate"]
        u = x2 @ w["wi_up"]
        o = F.silu(g.float()).to(x.dtype) * u
        o = o @ w["wo"]
        y = y + o.float() * we[:, None]
        _sync(x.device)
        spans.append((t0, time.perf_counter()))
    y = y.to(x.dtype).reshape(B, S, d)
    if ledger is not None:
        ledger.serve_gauge("moe_prefetch_overlap_s",
                           pager.stats.prefetch_overlap_s)
        new_hits = pager.stats.prefetch_hits - hits0
        if new_hits:
            ledger.serve_record("moe_prefetch_hit", new_hits)
    if m.shared_expert_ff and pager.shared is not None:
        y = y + mlp(pager.shared, x)
    return y, aux
