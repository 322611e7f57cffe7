#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--only serve-hybrid,serve-moe,...]

Run from the root of a checkout.  Phases, each printing its own lines:

1. the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit) and the host (CPU model, cores, 1-minute load average);
2. build: one nvcc per ``src/repro_torch/kernels/csrc/*.cu``, all started
   together, for sm_90a; Triton compiles the fused-field kernel; the count
   of tensor-core instructions (HMMA) in K5's SASS, which must not be 0;
3. kernels: every hand-written kernel against its plain PyTorch version at
   its path's shape (200^3 for K1-K4; B=4, T=1024, H=64, hd=64 for the
   RWKV6 scan K5) and at ragged ones, then timed with CUDA events beside
   its plain version, its library call where one exists, and its bound;
4. the CFD path: SIMPLE steps of the 3-D lid-driven cavity at 200^3
   (8.0M cells, size M of the OpenFOAM HPC Technical Committee's
   ``Lid-driven_cavity-3d`` benchmark) under the unified policy through
   the ``hopper`` variants, every region a compiled executable
   (``[compile]``: first-call seconds and recompiles per region), with
   every kernel's launch count; the same steps run eagerly
   (``disable_compile``) in turns with the compiled ones, for the eager
   FOM and per-region ms beside the compiled; then one step held against
   the ``ref`` step, and against the eager ``hopper`` step with equal
   launch counts;
5. the four memory models of the paper's Fig 5 (``[policies]``, with the
   ``[discrete]`` line): one warm-up and one timed step each under host
   (fields on the CPU, no kernel), discrete (real staging copies), unified
   and adaptive (its cutoff calibrated on the card first), each held
   against the unified step;
6. the fused solver (``[fused]``): ``solve`` with DILU and with Jacobi on
   the step's pressure system, DILU held against ``pbicgstab_regions``;
7. capture and replay (``[async]``, Fig 6b): one SIMPLE step captured on
   the card and replayed under the discrete policy synchronously and with
   lookahead copies on a side stream, bit for bit equal, and under the
   unified policy, held against the eager step; then ``[oversub]``
   (``fig_oversub``'s CFD leg): the same step replayed under discrete and
   adaptive policies whose ``MemoryBudget`` makes the state 1, 2 and 4
   times oversubscribed (chunked staging), and under a budgeted async
   replay at 4, each equal bit for bit to its unbudgeted replay, with the
   budget's high water beside the card's peak; and one region whose
   ``DEVICE`` hints a ``BudgetedPlacer`` demotes, its operand migrated in
   for the call and booked as staging;
8. the serve path: ``rwkv6-7b`` at full width and 2 of its 32 layers
   (random weights from ``--seed``), batch 4, prompt 1024, 32 greedy
   tokens, through the
   captured prefill and decode programs under the unified policy with the
   ``hopper`` variants, compiled (each layer kind compiled once, a custom
   op in the step's graph: ``transformer.LayerOp``); the same eagerly
   beside it; K5's launches, the tokens against the uncaptured (compiled)
   path, peak memory with and without the uncaptured decode's donated
   cache, the compiled prefill (logits and every layer's state) and one
   compiled decode step's logits against the same functions run eagerly,
   the ``hopper`` prefill against the ``ref`` prefill, the discrete policy
   at 8 tokens, and the ``hopper`` prefill against the ``ref`` prefill
   again at all 32 layers with the weights widened to f32 (these two held
   eagerly, as before regions were compiled);
9. ``[batch]``: ``RegionProgram.replay_batch`` of the decode program
   (4 tokens) of the served ``rwkv6-7b`` (2 layers) over 2 request
   groups of 4, against each group's solo replay (the first decoded token
   equal in every row), and of a captured PBiCGStab solve at 200^3 over 2
   right-hand sides, whose vmap rules launch K1-K4, against the solo
   replays;
10. ``[serve-attn]``: ``tinyllama-1.1b`` at full width and the first 2
   of its 22 layers (random bf16 weights from ``--seed``, drawn for 22
   layers), batch 4, prompt 1024, 32
   greedy tokens through the captured programs, compiled (each attention
   layer kind compiled once), and eagerly beside it; the tokens against
   the uncaptured path; the compiled prefill (logits, every layer's k and
   v) and one decode step against the same functions run eagerly, in bf16
   and with the weights widened to f32; then ``llama3.2-3b`` at full width
   and 1 of its 28 layers and ``qwen2.5-32b`` (a QKV bias) at full width
   and 1 of its 64 layers, 8 tokens each, compiled, their tokens against
   the uncaptured path;
10b. ``[serve-hybrid]``: ``recurrentgemma-9b`` at full width and the
   first 3 of its 38 layers (one cycle: two RG-LRU layers and a local
   attention layer; every weight drawn at the full depth's init scale),
   4 x 1024 prompt, 32 greedy tokens, compiled and eagerly; the compiled
   prefill and decode step against the eager ones (logits, k/v and conv
   windows within the tinyllama envelope; each compiled layer alone on
   the eager layer's input, its RG-LRU state included); ``[serve-moe]``:
   ``qwen3-moe-30b-a3b`` (128 experts, top-8) at 2 of its 48 layers and
   ``llama4-scout-17b-a16e`` (16 experts, top-1, a shared expert) at 1 of
   its 48, full width, 8 tokens, compiled, held to eager, with the
   prefill's capacity drops and expert loads; the rows check of every new
   decode layer kind; ``[oversub-moe]``: one qwen3-moe-30b-a3b layer's
   experts (1.2 GB) in pinned host memory through ``ExpertPager`` and
   ``moe_decode_paged``, 32 tokens, unbudgeted and under budgets at
   ratios 1, 2, 4 (and 4 with the lookahead off), every output bit for
   bit the unbudgeted run's, which is held to the dense ``moe_ref``.
   These three phases are compile-bound: a child process
   (``chip_smoke.py --only ...``, at the lowest CPU priority) runs them
   once from phase 3 on, so that their compiles land in the on-disk
   Inductor and Triton caches, and this process runs them again after
   ``[serve-attn]`` (the readings printed are this process's);
11. ``[engine]``: ``gemma3-1b`` at full width and depth (26 layers, 5:1
   local:global, random bf16 weights from ``--seed``) through the
   continuous-batching engine (``repro_torch.serve.ServeEngine``: 4
   slots, pages of 64 tokens, compiled regions) under seeded Poisson
   traffic (16 requests, prompts of 512 and 1024 tokens, 1, 16 or 32
   tokens each), every request's tokens held to its solo decode, with
   tokens/s against the sequential solo decodes, per-token p50/p99,
   first-token p50, slot occupancy, KV page high water and the first-call
   seconds of the engine's regions; the same traffic through a one-slot
   engine (the reference's ``sequential`` run of ``fig_traffic``), with
   tokens/s, ticks, decode tokens a tick and ms a tick of both, the
   engine gated above it; then the first 8 requests of the same draw
   under the discrete policy, ``--offload-kv``, a device page budget that
   spills, a
   ``MemoryBudget`` at ratio 2 and a total budget that evicts, each held
   to the same oracle; then ``rwkv6-7b`` at 8 layers through the engine,
   its prefills launching K5, and through a one-slot engine, with the
   ticks of both.  For both models one decode
   layer of each kind and the head, compiled, fed
   n = 1..4 rows from the same seeded rows, give each row bit for bit its
   n = 1 output (the tick runs each layer once over all its slots);
12. ``[train]``: ``tinyllama-1.1b`` at full width (22 layers, bf16
   parameters, f32 AdamW moments, random from ``--seed``), 4 x 1024
   synthetic tokens a step from the ported pipeline, through the captured
   ``FWD_BWD``/``ADAMW_UPDATE`` program under the unified policy,
   compiled (each layer kind's forward and VJP once): a warm-up step, 5
   timed steps (s a step, tok/s, losses, grad norm, compile seconds, peak
   memory), 5 steps on one fixed batch (the loss must fall); then at 2
   layers in f32, compiled against eager: one layer's VJP, ``FWD_BWD``'s
   loss and every gradient leaf (also against an f64 run) and two
   ``ADAMW_UPDATE`` steps on the same gradients; then the optimizer
   offloaded to host memory, one discrete step, and a supervised run with
   a fault, bit for bit an uninterrupted one;
13. a ``kernels`` JSON line (kernels of both paths) and a ``port_status``
   JSON line (every TPU kernel of the reference and whether it is ported).

Each path's kernel launches are counted from 0 just before it and read
just after, and so are the plain versions of the kernels with operands on
the card (the ``ref`` variant of a region that has a kernel variant, or a
function of a kernel package's ``ref.py``): a plain version called
eagerly counts at each call, one traced into a compiled graph counts when
it is traced; on every card path, capture included, that count must stay
0.  A region variant run eagerly on the card outside ``disable_compile``
counts too, and must stay 0: every region runs compiled.  Every compiled
executable recompiles at most twice over the run.

The last line is ``{"ok": true, "device": {...}}``; ``--only`` runs the
named phases alone (a partial run, which ends with a ``partial`` line
instead).  Nothing is caught: a
failed phase ends the run with a non-zero exit code and no result line.
Without CUDA, or outside a checkout, it exits non-zero at once.
"""
import argparse
import atexit
import collections
import dataclasses
import json
import math
import os
import pathlib
import platform
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM, NVIDIA data sheet: HBM3 bandwidth and dense f32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_TOL = dict(rtol=3e-4, atol=1e-4)           # K1-K3 vs plain
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)    # K5 vs plain (tests/test_kernels.py)
# hopper vs ref prefill of the full model, relative to the reference's
# largest magnitude: the two scans differ by f32 rounding (~1e-6), but each
# layer rounds its output to bf16 (8 bits), so a one-ulp flip reaches the
# next layer and 32 layers of random weights amplify it (3-4 % on logits
# and S at d_model=256 on a CPU, 6-9 % at full width on an H100)
PREFILL_TOL = 0.2
# layer 0 of that prefill: both scans get the same r, k, v, log w, so only
# their f32 rounding differs (~3e-6 of max|S| at d_model=256 on a CPU)
SCAN_ON_MODEL_TOL = 1e-4
# the same prefill with the weights widened to f32 and f32 activations:
# f32 rounding of the decays' running sums amplified by 32 layers
# (2e-5 of max|S| and of max|logit| at d_model=256 on a CPU)
F32_PREFILL_TOL = 1e-4
# rwkv6-7b serve (and [batch]) at 2 of its 32 layers: each served model
# compiles its steps several times (captured regions, the uncaptured path,
# the batched composite), and a step's graph grows by one layer op a layer
# (cut from 8 layers for [train]'s time)
SERVE = dict(batch=4, prompt_len=1024, gen=32, gen_discrete=8, layers=2)
# tinyllama-1.1b at the first 2 of its 22 layers (drawn at 22: the init's
# scale follows the depth), llama3.2-3b at 1 of its 28 and qwen2.5-32b (a
# QKV bias) at 1 of its 64, for the time limit: a whole-model graph
# compiles in about a second a layer, and [engine] and [train] need the
# time (cut from 8, 4 and 4 layers)
SERVE_ATTN = dict(batch=4, prompt_len=1024, gen=32, llama_gen=8,
                  tinyllama_layers=2, llama_layers=1, qwen_layers=1)
# the [engine] phase: gemma3-1b at full width and depth through the
# continuous-batching engine under seeded Poisson traffic (make_traffic's
# arguments), then the budget and policy runs on the first `sub` requests
# of the same draw, and rwkv6-7b at 8 of its 32 layers
ENGINE = dict(slots=4, page_tokens=64, requests=16, rate=0.5,
              prompt_lens=(512, 1024), gen_lens=(1, 16, 32), sub=8,
              rwkv_layers=8, rwkv_requests=8, rwkv_gen_lens=(1, 8, 16))
# [serve-hybrid]: recurrentgemma-9b at full width and the first `layers`
# of its 38 (one layer cycle: rglru, rglru, attn_local), 4 x 1024 prompt,
# 32 greedy tokens, compiled and eager: each layer kind compiles once, but
# every step graph grows by a layer op a layer, and four of them compile
# (the captured prefill and decode, the uncaptured ones)
SERVE_HYBRID = dict(arch="recurrentgemma-9b", layers=3, batch=4,
                    prompt_len=1024, gen=32)
# [serve-moe]: qwen3-moe-30b-a3b (128 experts, top-8; 1.25 GB a layer) at
# 2 of its 48 layers and llama4-scout-17b-a16e (16 experts, top-1, a
# shared expert; 4.40 GB a layer) at 1 of its 48, full width, 4 x 1024
# prompt, 8 greedy tokens, compiled, held to eager
SERVE_MOE = dict(batch=4, prompt_len=1024, gen=8,
                 models=(("qwen3-moe-30b-a3b", 2),
                         ("llama4-scout-17b-a16e", 1)))
# [oversub-moe]: one qwen3-moe-30b-a3b layer's experts (128 slabs of
# 9.44 MB) in pinned host memory, `tokens` seeded bf16 hidden states of
# batch 1 through moe_decode_paged: unbudgeted, then under a MemoryBudget
# at each ratio, then at the last ratio with the lookahead off
OVERSUB_MOE = dict(arch="qwen3-moe-30b-a3b", tokens=32,
                   ratios=(1.0, 2.0, 4.0))
# the pager's bf16 output against the port's dense moe_ref on the card,
# of max(1, max|ref|): the two sum the experts in another order, and the
# dense oracle rounds every expert's product in one batched matmul
MOE_REF_TOL = 2e-2
# [serve-hybrid], each compiled prefill layer alone against the eager layer
# on the eager layer's input, every output (x, and h, conv or k, v), of
# max(1, max|x|): both run the same cuBLAS products, and the f32
# elementwise math rounds in another order, so an output may round to the
# next bf16 value (2^-8 of its magnitude): 5 such steps of the largest.
# Printed beside it, not held, as is an RG-LRU layer's state h in the
# whole-model checks (which hold the logits, k/v and the conv windows to
# ATTN_MODEL_TOL in bf16 and in f32): at this init the recurrence gates
# sit near 0 or 1 (|W_a x| ~ 300), a one-ulp change of a layer's input
# tips some of them, and h (an average over up to 1024 steps, whose
# sqrt(1 - a^2) cancels as a nears 1) then moves by O(|h|) in those
# channels
HYBRID_LAYER_TOL = 2e-2
# the [train] phase: tinyllama-1.1b at full width, batch x seq tokens a
# step, `steps` timed steps after one warm-up; the checks run at
# `check_layers` layers (full width), the supervised run `sup_steps` steps
# with a checkpoint every `ckpt_every` and a fault at step `fail_at`
TRAIN = dict(arch="tinyllama-1.1b", layers=22, batch=4, seq=1024, steps=5,
             check_layers=2, sup_steps=5, ckpt_every=2, fail_at=3)
# compiled against eager f32 at 2 layers (TF32 off), on the same inputs:
# one attention layer's VJP alone, FWD_BWD's loss and gradients, and two
# ADAMW_UPDATE steps on the same gradients, each leaf against its own
# largest magnitude.  The random init is steep, so f32 rounding alone
# moves a gradient leaf far more than a layer's output: each leaf's
# compiled gradient is held to the f64 gradient within TRAIN_GRAD_RATIO
# times the eager one's distance to it (or TRAIN_GRAD_FLOOR), as is the
# grad norm
TRAIN_VJP_TOL = 1e-4           # of each leaf's largest magnitude
TRAIN_LOSS_TOL = 1e-5          # relative
TRAIN_GRAD_RATIO = 4.0
TRAIN_GRAD_FLOOR = 1e-5        # of each leaf's largest magnitude
TRAIN_PARAM_TOL = 1e-6         # of each leaf's largest magnitude
# offloaded moments against device-resident ones: the update runs on the
# card either way (the moments are copied in for the call), bit for bit
TRAIN_OFFLOAD_TOL = 0.0
# compiled against eager tinyllama prefill and decode steps, relative to
# max(1, max|x|).  In f32 (TF32 off) each compiled layer, fed the eager
# layer's input, must stay within ATTN_LAYER_TOL of it: the two differ in
# the order of f32 sums and Triton's division, so the compiled layer
# computes the same function.  End to end the model amplifies rounding: at
# this init the attention logits reach ~100, so a rounding-level change of
# q or k moves the softmax weights ~30-100 times as much, layer after
# layer, and the deepest layers' k/v differ most (on an H100 80GB HBM3 at
# 700 W: f32 layer 0 3.8e-7, 22 layers 2.6e-4; bf16 layer 0 5.0e-3, 22
# layers 0.18; logits 1.8e-4 and 0.12).  The whole-model envelopes bound
# that amplification.
# (A bf16 layer alone reads a few ulps of 2^-8 of its largest output, up
# to 0.041 at layer 0, whose MLP output reaches ~1e3: printed, not held.)
ATTN_LAYER_TOL = 1e-4
ATTN_MODEL_TOL = {"float32": dict(logits=1e-3, kv=1e-3),
                  "bfloat16": dict(logits=0.2, kv=0.3)}
FIELD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
             torch.bfloat16: dict(rtol=2e-2, atol=1e-2)}
STEP_ENVELOPE = 1e-5          # |err| <= 1e-5 * max(1, max|field|)
SOLVE_TOL = dict(rtol=3e-4, atol=1e-4)   # fused vs region-wise solve (§2)
N = 200                       # cells per axis of the cavity
POLICIES = ("host", "discrete", "unified", "adaptive")
#: kernels every device-routed SIMPLE step launches (xpay and mul are off it)
CFD_KERNELS = ("stencil_spmv", "rb_dilu_forward", "rb_dilu_backward",
               "fused_axpy", "fused_axpbypz")

#: the kernels' plain versions with operands on the card: eager calls, and
#: traces into a compiled graph
PLAIN = collections.Counter()
#: region variants run eagerly on the card outside ``disable_compile``
EAGER = collections.Counter()
#: name and compile record of every Region made in this run (for the
#: recompile check; the Region itself, whose function may close over a
#: model's weights, is not kept)
REGIONS = []
#: decode program length of the ``[batch]`` phase (its composite unrolls
#: every step)
BATCH_GEN = 4

#: where each kernel of the port replaces a TPU kernel of the reference
REPLACES = {
    "stencil_spmv": "src/repro/kernels/stencil_spmv/kernel.py:45",
    "rb_dilu_forward": "src/repro/kernels/stencil_spmv/kernel.py:114",
    "rb_dilu_backward": "src/repro/kernels/stencil_spmv/kernel.py:138",
    "fused_axpy": "src/repro/kernels/fused_field/kernel.py:84",
    "fused_xpay": "src/repro/kernels/fused_field/kernel.py:88",
    "fused_mul": "src/repro/kernels/fused_field/kernel.py:92",
    "fused_axpbypz": "src/repro/kernels/fused_field/kernel.py:96",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:71",
}


Timing = collections.namedtuple("Timing", "ms p10 p90")


def time_ms(fn, reps=25, warmup=3):
    """Device time (ms) of one call: the median of ``reps`` calls and their
    10th and 90th percentiles.  CUDA events around each call, enqueued
    behind a ~50 ms device sleep, so the host's launch overhead (tens of
    microseconds for a Triton launch) is hidden behind queued work and the
    events bracket the device's execution alone.  Before each call a 256 MB
    buffer is written outside the events, so every call finds the 50 MB L2
    cold, as the solver finds a field after other kernels have touched
    other fields."""
    flush = torch.empty(64 * 2**20, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)              # ~50 ms at ~2 GHz
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    deciles = statistics.quantiles(times, n=10, method="inclusive")
    return Timing(statistics.median(times), deciles[0], deciles[-1])


def spread(t):
    """'median [p10, p90]' of a Timing."""
    return f"{t.ms:.4f} [{t.p10:.4f}, {t.p90:.4f}]"


def timing_keys(t, lib_t):
    """The ``kernels`` line's times of a kernel and of its library call
    (None where there is none), each a median with its 10th and 90th
    percentiles."""
    keys = dict(ms=t.ms, ms_p10=t.p10, ms_p90=t.p90)
    for k in ("ms", "p10", "p90"):
        name = "library_ms" if k == "ms" else f"library_ms_{k}"
        keys[name] = None if lib_t is None else getattr(lib_t, k)
    return keys


def dilu_ms(ledger):
    """ms a call of the ``precondition(DILU)`` region in a ledger."""
    row = ledger.regions["precondition(DILU)"]
    return row.compute_s / row.calls * 1e3, row.calls


def sass_counts(lib, opcode):
    """Instructions of one opcode in each kernel function of a built
    library, read from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts.setdefault(fn, 0)
        elif fn is not None and re.search(rf"\b{opcode}\b", ln):
            counts[fn] += 1
    return counts


def bound(nbytes, flops):
    """Least time (ms) the card could take: bytes over HBM rate vs
    operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_work(B, T, H, hd, rkv_bytes):
    """(bytes, operations) of the RWKV6 scan from a given state: r, k, v
    read once, log w, S_in and u once (f32), out and S_out written once
    (f32).  Operations: the fewest that give the same out and S_out, over
    the sequential recurrence and the chunked form at every chunk length
    of 1..64 rows (the last chunk ragged), each exp counted as one."""
    n = B * T * H * hd
    nbytes = 3 * rkv_bytes * n + 4 * n + 4 * n + 2 * 4 * B * H * hd * hd \
        + 4 * H * hd
    # per token: r @ S (2 hd^2), S <- exp(w) S + k^T v (3 hd^2 + hd), the
    # u bonus r.u.k (3 hd) and its v term (2 hd)
    recurrence = T * (5 * hd * hd + 6 * hd)

    def chunked(C):
        ops = 0
        for t0 in range(0, T, C):
            L = min(C, T - t0)
            ops += (L * hd                        # running sum of log w
                    + L * (L - 1) // 2 * hd * 5   # pairwise decays into att
                    + L * hd * 3                  # u bonus on the diagonal
                    + L * hd * 5                  # r*exp(la_prev), k*exp(..)
                    + L * hd * hd * 2             # inter = rA @ S
                    + L * (L + 1) // 2 * hd * 2   # att @ v
                    + hd * hd * (2 + 2 * L) + hd)  # S update
        return ops
    ops = min(recurrence, *(chunked(C) for C in range(1, 65)))
    return nbytes, ops * B * H


def rel_errs(logits_a, caches_a, logits_b, caches_b):
    """max |a-b| / max |b| of every layer's S, and of the logits."""
    s_rel = [((a["S"] - b["S"]).abs().max() / b["S"].abs().max()).item()
             for a, b in zip(caches_a, caches_b)]
    l_rel = ((logits_a.float() - logits_b.float()).abs().max()
             / logits_b.float().abs().max()).item()
    return s_rel, l_rel


def first_diff(a, b):
    """Per row of two [B, gen] token arrays, the first step where they
    differ (None where they never do)."""
    out = []
    for ra, rb in zip(a, b):
        d = (ra != rb).nonzero()
        out.append(int(d[0]) if len(d) else None)
    return out


def host_line():
    """The host's CPU model, core count and 1-minute load average:
    host-bound readings (a decode step, the engine's tick) follow them."""
    model = None
    try:
        for ln in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if ln.startswith("model name"):
                model = ln.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    if not model and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Model name")), None)
    model = model or platform.processor() or platform.machine()
    return (f"{model}, {os.cpu_count()} cores, load average (1 min) "
            f"{os.getloadavg()[0]:.2f}")


def on_card(tree):
    from torch.utils._pytree import tree_leaves
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves(tree))


@torch._dynamo.assume_constant_result
def note_plain(key):
    """Count one plain-version call in ``PLAIN``: run at each eager call,
    and once when traced into a compiled graph (Dynamo calls a function
    marked ``assume_constant_result`` at trace time and keeps its
    result)."""
    PLAIN[key] += 1
    return 0


def count_plain_calls(Region, ref_modules, compile_disabled):
    """Count in ``PLAIN`` every call with operands on the card of a kernel
    package's plain function and of the ``ref`` variant of a region that
    has a ``hopper`` variant (what a ``hopper`` call falls back to), eager
    or traced; count in ``EAGER`` every region variant run eagerly on the
    card outside ``disable_compile``; keep every Region's compile record in ``REGIONS``."""
    for mod in ref_modules:
        for name in [n for n in dir(mod) if not n.startswith("_")]:
            fn = getattr(mod, name)
            if not callable(fn) or getattr(fn, "__module__", None) \
                    != mod.__name__:
                continue

            def counted(*a, _fn=fn, _key=f"{mod.__name__}.{name}", **k):
                if on_card((a, k)):
                    note_plain(_key)
                return _fn(*a, **k)
            setattr(mod, name, counted)
    impl_fn = Region.impl_fn

    def spied(self, name="ref"):
        fn = impl_fn(self, name)
        plain_key = f"region {self.name} ref" \
            if name == "ref" and "hopper" in self.variants else None
        eager_key = f"region {self.name} {name}"

        def call(*a, **k):
            if on_card((a, k)):
                if plain_key is not None:
                    note_plain(plain_key)
                # a region compiled by parts runs its function, whose parts
                # are compiled executables (train's FWD_BWD)
                if not torch.compiler.is_compiling() \
                        and not compile_disabled() \
                        and not self.compiled_by_parts:
                    EAGER[eager_key] += 1
            return fn(*a, **k)
        return call
    Region.impl_fn = spied
    post_init = Region.__post_init__

    def kept(self):
        post_init(self)
        REGIONS.append(types.SimpleNamespace(name=self.name,
                                             compile_stats=self.compile_stats))
    Region.__post_init__ = kept


def check_plain(path):
    if PLAIN:
        raise AssertionError(f"{path}: plain versions ran on the card: "
                             f"{dict(PLAIN)}")
    if EAGER:
        raise AssertionError(f"{path}: regions ran eagerly on the card: "
                             f"{dict(EAGER)}")


def reset_plain():
    PLAIN.clear()
    EAGER.clear()


def compile_rows(regions):
    """``name first-call s (compiles)`` of each compiled executable of
    ``regions``."""
    rows = []
    for r in regions:
        for (kind, impl, don), st in r.compile_stats.items():
            rows.append(f"{r.name}[{impl}{', host' if kind == 'host' else ''}"
                        f"{', donated' if don else ''}] {st.first_call_s:.2f} s"
                        f" ({st.compiles} compiled)")
    return "; ".join(rows)


def layer_rows():
    """``label first-call s (compiles)`` of each compiled layer
    (``transformer.LayerOp``)."""
    from repro_torch.models.transformer import LAYER_OPS
    return "; ".join(f"{op.label} {op.stats.first_call_s:.2f} s "
                     f"({op.stats.compiles} compiled)"
                     for op in LAYER_OPS.values() if op.stats.calls)


def compiles_of(regions):
    from repro_torch.models.transformer import LAYER_OPS
    out = {(id(r), k): st.compiles for r in regions
           for k, st in r.compile_stats.items()}
    out.update({op.label: op.stats.compiles for op in LAYER_OPS.values()})
    return out


def stencil_csr(diag, off):
    """The 7-point matrix of (diag, off) as one CSR tensor (int32 indices,
    columns ascending, neighbours outside the grid left out): what
    ``torch.mv`` multiplies through cuSPARSE, K1's library counterpart."""
    from repro_torch.cfd.grid import NEIGHBORS
    shape = diag.shape
    n = diag.numel()
    idx = torch.arange(n, device=diag.device).reshape(shape)
    strides = (shape[1] * shape[2], shape[2], 1)
    coords = [torch.arange(s, device=diag.device).view(
        *[-1 if a == ax else 1 for a in range(3)])
        for ax, s in enumerate(shape)]
    slots = sorted([(d * strides[ax], f, ax, d)
                    for f, (ax, d) in enumerate(NEIGHBORS)] + [(0, -1, 0, 0)])
    cols, vals, keep = [], [], []
    for delta, f, ax, d in slots:
        cols.append((idx + delta).reshape(-1))
        vals.append((diag if f < 0 else off[f]).reshape(-1))
        inside = (coords[ax] + d >= 0) & (coords[ax] + d < shape[ax])
        keep.append(inside.expand(shape).reshape(-1))
    keep = torch.stack(keep, 1)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=diag.device)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(
        crow.int(), torch.stack(cols, 1)[keep].int(),
        torch.stack(vals, 1)[keep], size=(n, n))


def envelope_err(a, b):
    """(max |a-b|, allowed) of one field under the step envelope."""
    a = a.float().cuda()
    b = b.float().cuda()
    err = (a - b).abs().max().item()
    return err, STEP_ENVELOPE * max(1.0, a.abs().max().item())


def rows_check(args, dev, arch, cfg, params, max_len):
    """One decode layer of each kind of ``cfg``, compiled, and then the
    head, fed n = 1..4 rows built from the same seeded rows (each row at
    its own position, the engine's cache shapes): each row's output must
    equal its n = 1 output bit for bit.  Prints the first op that parts,
    if one does, and raises."""
    from repro_torch.models import transformer as T
    ops = T.layer_fns(cfg, T.Ctx(mode="decode"))
    kinds = T.layer_kinds(cfg)
    g = torch.Generator(device=dev).manual_seed(args.seed + 5)
    n_rows = ENGINE["slots"]
    pos = torch.tensor([max_len // 2 + 7 * i for i in range(n_rows)],
                       dtype=torch.int32, device=dev)
    cases = []
    for kind in dict.fromkeys(kinds):
        layer = kinds.index(kind)
        op = ops[kind]
        cache = T.init_cache(cfg, 1, dev, max_len)[layer]
        leaves = []
        for k in op._cache_keys:
            c = cache[k]
            if k == "pos":
                sl = torch.arange(c.shape[0], dtype=torch.int32,
                                  device=dev)
                leaves.append(torch.stack([torch.where(sl < p, sl, -1)
                                           for p in pos.tolist()]))
            else:
                leaves.append(torch.randn((n_rows, *c.shape), generator=g,
                                          device=dev).to(c.dtype))
        # the stream a layer op takes: f32, here rounded to bf16 (a carry)
        x = torch.randn((n_rows, 1, 1, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16).float()
        p = T._leaves(params["layers"][layer])
        cases.append((f"layer {layer} {kind[0]}"
                      + ("+moe" if kind[1] == "moe" else ""),
                      lambda idx, op=op, p=p, x=x, c=leaves: torch.func.vmap(
                          op.op, in_dims=(None, 0, [0] * len(c), 0))(
                          p, x[idx], [t[idx] for t in c], pos[idx])))
    hx = torch.randn((n_rows, 1, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16).float()
    cases.append(("head", lambda idx: [ops["head"](params, hx[idx])]))
    for what, run in cases:
        solo = [run([i]) for i in range(n_rows)]
        for n in range(2, n_rows + 1):
            got = run(list(range(n)))
            for i in range(n):
                for j, (a, b) in enumerate(zip(got, solo[i])):
                    if not torch.equal(a[i], b[0]):
                        err = (a[i].float() - b[0].float()).abs().max()
                        raise AssertionError(
                            f"[engine] rows: {arch}: {what} (output {j})"
                            f" parts first, at n={n}, row {i}: max |diff|"
                            f" {float(err)}")
    print(f"[engine] rows: {arch}: "
          + ", ".join(w for w, _ in cases) + f" at n = 1..{n_rows} rows "
          "(compiled): every row bit for bit its n = 1 output: passed")


def engine_phase(args, dev, stamp):
    """``[engine]``: gemma3-1b at full width and depth, bf16, random
    weights from ``--seed``, served through ``ServeEngine`` (4 slots,
    pages of 64 tokens, compiled regions) under seeded Poisson traffic,
    every request's tokens held to its solo decode; then, on the first
    ``ENGINE["sub"]`` requests of the same draw and against the same
    oracle, the discrete policy, ``--offload-kv``, a device page budget
    below one parked 1024-token entry (spill), a ``MemoryBudget`` at ratio
    2, and a total budget that evicts; then rwkv6-7b at 8 layers, whose
    prefills run K5."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.oversub import MemoryBudget
    from repro_torch.core.regions import Executor, StaticSelector
    from repro_torch.kernels.rwkv6_scan import kernel as RK
    from repro_torch.launch import serve as SV
    from repro_torch.launch.policy import lm_policy
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    from repro_torch.serve import (PagedKVCache, ServeEngine, make_traffic,
                                   run_traffic, solo_reference)
    from repro_torch.serve.scheduler import (batch_for_prompt,
                                             make_engine_regions)
    from repro_torch.serve.traffic import assert_parity
    E = ENGINE
    sel = StaticSelector("hopper")

    def model(arch, n_layers=None):
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        g = torch.Generator(device=dev).manual_seed(args.seed)
        params = T.init(g, cfg, dev)
        n = sum(t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_leaves(params))
        print(f"[engine] {arch}: {cfg.n_layers} layers "
              f"({dict(collections.Counter(m for m, _ in T.layer_kinds(cfg)))})"
              f", d_model {cfg.d_model}, {cfg.n_heads} query / "
              f"{cfg.n_kv_heads} kv heads of {cfg.hd}, window {cfg.window}, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.compute_dtype}; "
              f"{param_count(T.param_specs(cfg))} params, {n / 1e9:.2f} GB "
              f"on the card")
        return cfg, params

    def entry_bytes(cfg, max_len, true_len):
        """Bytes of one parked batch-1 entry of ``true_len`` tokens."""
        probe = PagedKVCache(page_tokens=E["page_tokens"], device=dev)
        probe.commit(0, T.init_cache(cfg, 1, dev, max_len), true_len=true_len)
        return probe.total_bytes

    def serve(cfg, params, regions, reqs, max_len, what, policy=None,
              slots=None, **kv_kw):
        """One engine run over ``reqs`` (its own warm-up first); checks no
        plain version or eager region ran on the card."""
        ex = Executor(policy or lm_policy("unified", cfg.memory,
                                          selector=sel, device=dev),
                      Ledger("engine"))
        kv = PagedKVCache(page_tokens=E["page_tokens"], device=dev, **kv_kw)
        engine = ServeEngine(cfg, params, ex, max_len=max_len,
                             n_slots=slots or E["slots"], kv=kv, device=dev,
                             regions=regions)
        reset_plain()
        metrics = run_traffic(engine, reqs)
        check_plain(f"[engine] {what}")
        return engine, ex, kv, metrics

    def oracle_of(cfg, params, engine, reqs, max_len):
        impl = SV.prefill_rwkv_impl(
            engine.executor, engine.regions,
            batch_for_prompt(reqs[0].prompt, dev),
            T.init_cache(cfg, 1, dev, max_len))
        reset_plain()
        out = solo_reference(cfg, params, reqs, max_len, device=dev,
                             rwkv_impl=impl)
        check_plain("[engine] solo oracle")
        return out

    def tick_line(m, ex):
        srv = ex.report()["serve"]
        row = ex.ledger.regions["DECODE_SLOTS"]
        ticks = srv.get("ticks", 0)
        tick_ms = (row.compute_s + row.staging_s) / max(row.calls, 1) * 1e3
        return (f"{m['tokens_per_s']:.1f} tok/s, {ticks} ticks, "
                f"{srv.get('decode_tokens', 0) / max(ticks, 1):.2f} decode "
                f"tokens a tick, {tick_ms:.2f} ms a tick (DECODE_SLOTS)")

    def one_slot(cfg, params, regions, reqs, max_len, oracle, arch, m, ex,
                 solo_tps, gate):
        """The same traffic (``reqs()``, drawn anew) through a one-slot
        engine under the same policy
        (the reference's ``sequential`` run of ``fig_traffic``): tokens
        held to the same oracle; with ``gate``, the engine's tok/s must be
        above it (``benchmarks/run.py:533-538``)."""
        reqs1 = reqs()
        _, ex1, _, m1 = serve(cfg, params, regions, reqs1, max_len,
                              f"{arch} one slot", slots=1)
        assert_parity(reqs1, oracle)
        print(f"[engine] {arch} unified, {E['slots']} slots: "
              f"{tick_line(m, ex)}; one slot: {tick_line(m1, ex1)}; "
              f"sequential solo decode {solo_tps:.1f} tok/s; engine / one "
              f"slot {m['tokens_per_s'] / m1['tokens_per_s']:.2f}x; tokens "
              f"equal to the solo oracle's in both")
        if gate and not m["tokens_per_s"] > m1["tokens_per_s"]:
            raise AssertionError(
                f"[engine] {arch}: {E['slots']} slots read "
                f"{m['tokens_per_s']:.1f} tok/s, not above the one-slot "
                f"engine's {m1['tokens_per_s']:.1f}")

    def line(what, m, ex, kv, solo_tps=None):
        st = kv.stats
        srv = ex.report()["serve"]
        vs = "" if solo_tps is None else \
            f" against {solo_tps:.1f} tok/s sequential solo"
        print(f"[engine] {what}: {m['requests']} requests, {m['tokens']} "
              f"tokens in {m['wall_s'] * 1e3:.1f} ms, "
              f"{m['tokens_per_s']:.1f} tok/s{vs}; per token p50 "
              f"{m.get('p50_token_ms', 0.0):.2f} ms, p99 "
              f"{m.get('p99_token_ms', 0.0):.2f} ms; first token p50 "
              f"{m['first_token_p50_ms']:.1f} ms; slot occupancy "
              f"{srv.get('slot_occupancy', 0.0):.3f}; KV page high water "
              f"{st.device_high_water_bytes} B device, "
              f"{st.total_high_water_bytes} B in all; pages spilled "
              f"{st.pages_spilled}, fetched {st.pages_fetched}; evictions "
              f"{st.evictions}; staging_fraction "
              f"{ex.report()['staging_fraction']:.4f}; tokens equal to the "
              f"solo oracle's for every request")

    # gemma3-1b, full width and depth, unified
    gcfg, gparams = model("gemma3-1b")
    max_len = max(E["prompt_lens"]) + max(E["gen_lens"])
    reqs = make_traffic(args.seed, E["requests"], gcfg.vocab,
                        arrival_rate=E["rate"], prompt_lens=E["prompt_lens"],
                        gen_lens=E["gen_lens"])
    regions = make_engine_regions(gcfg, gparams, ledger=Ledger("engine"))
    torch.cuda.reset_peak_memory_stats()
    engine, ex, kv, m = serve(gcfg, gparams, regions, reqs, max_len,
                              "gemma3-1b unified")
    peak = torch.cuda.max_memory_allocated()
    stamp("[engine] gemma3-1b unified run (warm-up and compiles included)")
    oracle, solo_wall = oracle_of(gcfg, gparams, engine, reqs, max_len)
    stamp("[engine] gemma3-1b solo oracle (its compiles included)")
    assert_parity(reqs, oracle)
    solo_tps = m["tokens"] / solo_wall
    line(f"gemma3-1b unified, {E['slots']} slots, {E['requests']} requests "
         f"at {E['rate']} a tick, prompts {E['prompt_lens']}, gens "
         f"{E['gen_lens']}", m, ex, kv, solo_tps)
    rows_check(args, dev, "gemma3-1b", gcfg, gparams, max_len)
    one_slot(gcfg, gparams, regions, lambda: make_traffic(
        args.seed, E["requests"], gcfg.vocab, arrival_rate=E["rate"],
        prompt_lens=E["prompt_lens"], gen_lens=E["gen_lens"]), max_len,
        oracle, "gemma3-1b", m, ex, solo_tps, gate=True)
    print(f"[compile] [engine] first call (trace, compile, run): DECODE_SLOTS "
          + ", ".join(f"{s.first_call_s:.2f} s ({s.compiles} compiled)"
                      for s in regions.decode_slots.compile_stats.values())
          + "; SLOT_ADMIT " + ", ".join(
              f"{s.first_call_s:.2f} s ({s.compiles} compiled)"
              for s in regions.slot_admit.compile_stats.values())
          + "; prefill capture by prompt length " + ", ".join(
              f"{L}: {t:.2f} s" for L, t in
              sorted(engine.prefill_capture_s.items()))
          + "; PREFILL " + ", ".join(
              f"{s.first_call_s:.2f} s ({s.compiles} compiled)"
              for s in regions.serve.prefill.compile_stats.values())
          + f"; peak device memory {peak / 1e9:.2f} GB")
    print(f"[engine] serve ledger section: "
          f"{json.dumps(ex.report()['serve'])}")
    if m["tokens"] != sum(r.gen for r in reqs):
        raise AssertionError("[engine] token count differs from the draw")
    del engine, ex, kv

    # the same model on the first `sub` requests, held to the same oracle
    def sub():
        return make_traffic(args.seed, E["sub"], gcfg.vocab,
                            arrival_rate=E["rate"],
                            prompt_lens=E["prompt_lens"],
                            gen_lens=E["gen_lens"])

    one = entry_bytes(gcfg, max_len, max(E["prompt_lens"]))
    full = entry_bytes(gcfg, max_len, max_len)
    runs = [
        ("discrete", dict(policy=lm_policy("discrete", gcfg.memory,
                                           selector=sel, device=dev))),
        ("offload-kv", dict(policy=lm_policy(
            "unified", gcfg.memory, placer=SV.offload_kv_cache(device=dev),
            selector=sel, device=dev))),
        ("spill", dict(device_budget_bytes=one - 1)),
        ("ratio 2", dict(budget=MemoryBudget.for_ratio(
            full * E["slots"], 2.0, name="kv"))),
        ("evict", dict(total_budget_bytes=one)),
    ]
    for what, kw in runs:
        reqs_s = sub()
        torch.cuda.reset_peak_memory_stats()
        engine, ex, kv, m = serve(gcfg, gparams, regions, reqs_s, max_len,
                                  f"gemma3-1b {what}", **kw)
        assert_parity(reqs_s, oracle)
        line(f"gemma3-1b {what}, first {E['sub']} requests", m, ex, kv)
        rep = ex.report()
        staged = sum(r.staging_bytes for r in ex.ledger.regions.values())
        if what == "discrete":
            print(f"[engine] discrete: staging_fraction "
                  f"{rep['staging_fraction']:.4f} ({rep['staging_s']:.4f} s, "
                  f"{staged / 1e9:.3f} GB staged)")
            if not rep["staging_fraction"] > 0:
                raise AssertionError("[engine] discrete staged nothing")
        if what == "offload-kv":
            print(f"[engine] offload-kv: {staged / 1e9:.3f} GB of k/v copied "
                  f"in for calls on the card (booked as staging, "
                  f"{rep['staging_s']:.4f} s, staging_fraction "
                  f"{rep['staging_fraction']:.4f}); k/v leaves re-homed to "
                  f"{ex.policy.placer.kv_space.value} at every region "
                  f"boundary")
            if not staged > 0:
                raise AssertionError("[engine] offload-kv migrated nothing in")
        if what == "spill":
            print(f"[engine] spill: device page budget {one - 1} B, below one "
                  f"parked {max(E['prompt_lens'])}-token entry ({one} B): "
                  f"{kv.stats.pages_spilled} pages spilled, "
                  f"{kv.stats.pages_fetched} fetched back")
            if not kv.stats.pages_spilled > 0 < kv.stats.pages_fetched:
                raise AssertionError("[engine] the spill run spilled nothing")
        if what == "ratio 2":
            b = kw["budget"]
            print(f"[engine] ratio 2: budget {b.limit_bytes} B (footprint "
                  f"{full * E['slots']} B: {E['slots']} slots x one parked "
                  f"{max_len}-token entry); budget high water "
                  f"{b.stats.high_water_bytes} B, "
                  f"{b.stats.pressure_events} pressure events, pages "
                  f"spilled {kv.stats.pages_spilled}; "
                  f"torch.cuda.max_memory_allocated() "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if what == "evict":
            srv = rep["serve"]
            print(f"[engine] evict: total page budget {one} B: "
                  f"{kv.stats.evictions} evictions, "
                  f"{srv['prefills'] - E['sub']} re-prefills")
            if not kv.stats.evictions > 0:
                raise AssertionError("[engine] the evict run evicted nothing")
        stamp(f"[engine] gemma3-1b {what}")
        del engine, ex, kv
    print("[compile] [engine] gemma3-1b regions, first call and graphs "
          "kept: " + compile_rows([regions.decode_slots, regions.slot_admit,
                                   regions.serve.prefill,
                                   regions.serve.kv_append]))
    del gparams, regions

    stamp("engine gemma3-1b")

    # rwkv6-7b at 8 layers: K5 runs in the engine's prefills
    rcfg, rparams = model("rwkv6-7b", E["rwkv_layers"])
    rmax = max(E["prompt_lens"]) + max(E["rwkv_gen_lens"])
    rreqs = make_traffic(args.seed, E["rwkv_requests"], rcfg.vocab,
                         arrival_rate=E["rate"], prompt_lens=E["prompt_lens"],
                         gen_lens=E["rwkv_gen_lens"])
    rregions = make_engine_regions(rcfg, rparams, ledger=Ledger("engine"))
    # K5 counted from 0 over the run: the warm-up's and the captures'
    # prefills launch it too
    for k in RK.LAUNCHES:
        RK.LAUNCHES[k] = 0
    engine, ex, kv, m = serve(rcfg, rparams, rregions, rreqs, rmax,
                              "rwkv6-7b")
    k5 = RK.LAUNCHES["rwkv6_scan"]
    stamp("[engine] rwkv6-7b run")
    oracle, solo_wall = oracle_of(rcfg, rparams, engine, rreqs, rmax)
    assert_parity(rreqs, oracle)
    line(f"rwkv6-7b ({rcfg.n_layers} layers, hopper) unified, "
         f"{E['slots']} slots, {E['rwkv_requests']} requests, gens "
         f"{E['rwkv_gen_lens']}", m, ex, kv, m["tokens"] / solo_wall)
    one_slot(rcfg, rparams, rregions, lambda: make_traffic(
        args.seed, E["rwkv_requests"], rcfg.vocab, arrival_rate=E["rate"],
        prompt_lens=E["prompt_lens"], gen_lens=E["rwkv_gen_lens"]), rmax,
        oracle, "rwkv6-7b", m, ex, m["tokens"] / solo_wall, gate=False)
    rows_check(args, dev, "rwkv6-7b", rcfg, rparams, rmax)
    impl_counts = ex.ledger.regions["PREFILL"].impl_counts
    print(f"[engine] rwkv6-7b: K5 launches over the engine run {k5} (warm-up"
          f" and captures included; {rcfg.n_layers} a prefill); measured "
          f"PREFILL impl_counts {impl_counts}")
    if k5 <= 0:
        raise AssertionError("[engine] rwkv6-7b's engine run launched no K5")
    del engine, ex, kv, rparams, rregions
    return k5


def draw_cut(cfg, keep, seed, dev):
    """(``cfg`` cut to its first ``keep`` layers, random parameters from
    ``seed`` on the card): every stacked weight is drawn at the scale of
    the full depth (the init's law for a stacked weight is 1/sqrt(its
    layer cycles), so a model drawn at the cut depth would be another,
    steeper model), and only the kept layers are made.  ``keep`` is a
    multiple of the layer cycle."""
    from repro_torch.core.umem import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    cyc, n_full, _ = T.layer_plan(cfg)
    if keep % len(cyc) or not 0 < keep <= n_full * len(cyc):
        raise ValueError(f"keep {keep} is not a whole number of cycles")
    cut = dataclasses.replace(cfg, n_layers=keep)
    specs = T.param_specs(cut)
    scale = 1.0 / math.sqrt(n_full)
    specs["cycles"] = tree_map(
        lambda sp: dataclasses.replace(sp, scale=scale)
        if sp.init == "normal" and sp.scale is None else sp, specs["cycles"])
    t = init_params(torch.Generator(device=dev).manual_seed(seed), specs, dev)
    return cut, {"embed": t["embed"], "layers": T.layers_of(cut, t),
                 "final_norm": t["final_norm"]}


def rel_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def serve_cut(tag, args, dev, arch, keep, B, P, gen, eager=False):
    """Serve ``arch`` at full width and its first ``keep`` layers
    (:func:`draw_cut`), ``B`` x ``P`` prompt tokens and ``gen`` greedy
    tokens, through the captured prefill and decode programs under the
    unified policy, compiled (a warm-up replay first, then one timed
    request batch); with ``eager`` the same again eagerly; the uncaptured
    path's tokens equal to the replay's; the compiled prefill (logits and
    every layer's cache leaves) and one compiled decode step's logits held
    to the same functions run eagerly within ``ATTN_MODEL_TOL`` (bf16).
    Returns (cfg, params, batch, make_cache)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.regions import (Executor, StaticSelector,
                                          UnifiedPolicy, disable_compile)
    from repro_torch.core.umem import (MemSpace, tree_leaves, tree_map,
                                      tree_place)
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_count
    full = get_config(arch)
    t0 = time.perf_counter()
    cfg, params = draw_cut(full, keep, args.seed, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=g,
                                     device=dev, dtype=torch.int32)}
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    moe = "" if cfg.moe is None else (
        f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
        f"{cfg.moe.d_ff}" + (f", a shared expert of "
                             f"{cfg.moe.shared_expert_ff}"
                             if cfg.moe.shared_expert_ff else "")
        + f", capacity factor {cfg.moe.capacity_factor}")
    rnn = "" if "rglru" not in cfg.layer_cycle else \
        f", rnn_width {cfg.rnn_width}, conv_width {cfg.conv_width}"
    print(f"{tag} {arch}: the first {keep} of {full.n_layers} layers "
          f"({dict(collections.Counter(T.layer_kinds(cfg)))}), d_model "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} kv heads "
          f"of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}{rnn}{moe}, tied embeddings {cfg.tie_embeddings}, "
          f"{cfg.compute_dtype}; {param_count(T.param_specs(full))} params "
          f"at full depth ({param_count(T.param_specs(full)) * 2 / 1e9:.1f}"
          f" GB bf16), {n_bytes / 1e9:.2f} GB on the card, random init at "
          f"the full depth's scale in {t_init:.1f} s")

    def serve_once():
        slots = P + gen
        ex = Executor(UnifiedPolicy(selector=StaticSelector("hopper")),
                      Ledger(tag))
        n0 = len(REGIONS)
        regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
        pprog = SV.capture_prefill_program(
            regions, batch, T.init_cache(cfg, B, dev, slots),
            selector=ex.policy.selector)
        tok, cache = pprog.replay(ex, batch, T.init_cache(cfg, B, dev, slots))
        dprog = SV.capture_decode_program(
            regions, P, gen, *tree_place((tok, cache), MemSpace.DEVICE, dev),
            selector=ex.policy.selector)
        dprog.replay(ex, tok, cache)
        del tok, cache
        warm = compiles_of(REGIONS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tok, cache = pprog.replay(ex, batch, T.init_cache(cfg, B, dev, slots))
        t1 = time.perf_counter()
        toks = dprog.replay(ex, tok, cache)
        t2 = time.perf_counter()
        seq = torch.stack([t.cpu() for t in toks], 1)
        return (seq, t1 - t0, t2 - t1, torch.cuda.max_memory_allocated(),
                REGIONS[n0:], warm)

    reset_plain()
    seq, t_pre, t_dec, peak, regions, warm = serve_once()
    check_plain(f"{tag} {arch} capture and replay")
    if compiles_of(REGIONS) != warm:
        raise AssertionError(f"{tag} {arch}: a region recompiled after its "
                             f"warm-up")
    ops = [op for key, op in T.LAYER_OPS.items()
           if key[0] == cfg and op.stats.calls]
    if not ops or any(op.stats.compiles != 1 for op in ops):
        raise AssertionError(f"{tag} {arch}: a layer kind compiled more than "
                             "once: " + "; ".join(
                                 f"{op.label} {op.stats.compiles}"
                                 for op in ops))
    print(f"[compile] {tag} {arch}, per region: first call (trace, compile, "
          f"run) and graphs kept: " + compile_rows(regions)
          + "; first call of each layer kind: " + "; ".join(
              f"{op.label} {op.stats.first_call_s:.2f} s "
              f"({op.stats.compiles} compiled)" for op in ops))
    print(f"{tag} {arch} unified {B}x{P} prompt, {gen} tokens, compiled: "
          f"prefill {t_pre * 1e3:.1f} ms ({B * P / t_pre:.0f} prompt tok/s); "
          f"decode {gen - 1} steps in {t_dec * 1e3:.1f} ms "
          f"({B * (gen - 1) / t_dec:.1f} tok/s, "
          f"{t_dec / (gen - 1) * 1e3:.2f} ms/step); peak device memory "
          f"{peak / 1e9:.2f} GB")
    if eager:
        with disable_compile():
            seq_e, te_pre, te_dec, peak_e, _, _ = serve_once()
        print(f"{tag} {arch} eager: prefill {te_pre * 1e3:.1f} ms; decode "
              f"{gen - 1} steps in {te_dec * 1e3:.1f} ms "
              f"({te_dec / (gen - 1) * 1e3:.2f} ms/step); peak device memory "
              f"{peak_e / 1e9:.2f} GB; tokens agree with the compiled run's "
              f"in {(seq_e == seq).float().mean().item():.3f} of places, "
              f"first differing step of each row {first_diff(seq_e, seq)}")

    # the uncaptured path, compiled: its tokens must equal the replay's
    reset_plain()
    pre, dec, mk = SV.build_server(cfg, B, dev, max_len=P + gen)
    lg, ca = pre(params, batch, mk())
    toks_o, _ = SV.decode_stream(dec, params, SV.greedy(lg), ca, P, gen)
    if not torch.equal(seq, torch.stack([t.cpu() for t in toks_o], 1)):
        raise AssertionError(f"{tag} {arch}: replayed tokens differ from the "
                             f"uncaptured path's")
    del lg, ca, toks_o

    # compiled against eager, same inputs: bf16, then f32 (the leaves held:
    # compiled_vs_eager's docstring)
    held = None if cfg.moe is not None else ("k", "v", "conv")
    compiled_vs_eager(tag, cfg, params, batch, pre, mk, P, gen, dev, held)
    del pre, dec
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    pre32, _, mk32 = SV.build_server(cfg32, B, dev, max_len=P + gen)
    compiled_vs_eager(tag, cfg32, params32, batch, pre32, mk32, P, gen, dev,
                      () if cfg.moe is not None else ("k", "v", "conv"))
    del params32, pre32, mk32
    check_plain(f"{tag} {arch}")
    return cfg, params, batch, mk


def compiled_vs_eager(tag, cfg, params, batch, pre, mk, P, gen, dev, held):
    """The compiled prefill (``pre``: logits and every layer's cache
    leaves) and one compiled decode step's logits against the same
    functions run eagerly on the same inputs, each as max |d| / max(1,
    max|x|), all printed.  With ``held`` (cache-leaf names) the logits
    and those leaves are held to ``ATTN_MODEL_TOL`` of the dtype; None
    holds nothing.

    What is left out moves by O(1) when one rounding tips a threshold, so
    no tolerance bounds it: an RG-LRU layer's state h (``HYBRID_LAYER_TOL``'s
    note), and a MoE model's cache leaves after its first MoE layer, and
    in bf16 its logits, where a one-ulp change of a router's input flips
    an expert choice (the token moves by that expert's share, and in a
    prefill the flip also moves which pairs an expert's capacity drops).
    In f32 such a flip is rare, and one token's flip reaches the last
    position's logits only through attention."""
    from repro_torch.core.regions import compile_region_fn, disable_compile
    from repro_torch.launch import serve as SV
    from repro_torch.train import step as train_step
    B = batch["tokens"].shape[0]
    tol = ATTN_MODEL_TOL[cfg.compute_dtype]
    lc, cc = pre(params, batch, mk())
    dec_logits = compile_region_fn(train_step.make_decode_step(cfg),
                                   f"decode_logits_{cfg.name}")
    tok_c = SV.greedy(lc)
    ldc, _ = dec_logits(params, tok_c, cc, SV.position(P))
    with disable_compile():
        pre_e, _, mk_e = SV.build_server(cfg, B, dev, max_len=P + gen)
        le, ce = pre_e(params, batch, mk_e())
        lde, _ = train_step.make_decode_step(cfg)(params, tok_c, cc,
                                                 SV.position(P))
    by_leaf = {}
    for a, b in zip(cc, ce):
        for k in a:
            if a[k].is_floating_point():
                by_leaf.setdefault(k, []).append(rel_err(a[k], b[k]))
    errs = dict(prefill_logits=rel_err(lc, le), decode_logits=rel_err(ldc, lde),
                state=max([0.0] + [max(v) for k, v in by_leaf.items()
                                   if held and k in held]))
    for what, t in (("compiled prefill", lc), ("eager prefill", le),
                    ("compiled decode", ldc), ("eager decode", lde)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{tag} {cfg.name}: {what} logits are not "
                                 f"finite")
    agree = (SV.greedy(lc) == SV.greedy(le)).float().mean().item()
    limits = "printed, not held" if held is None else (
        f"limits logits {tol['logits']}" + (
            f", {'/'.join(held)} {tol['kv']}" if held else ""))
    print(f"{tag} {cfg.name} {cfg.compute_dtype} compiled vs eager, same "
          f"inputs (max |d| / max(1, max|x|)): prefill logits "
          f"{errs['prefill_logits']:.3e}, cache leaves by layer "
          + "; ".join(f"{k} " + ", ".join(f"{e:.1e}" for e in v)
                      for k, v in by_leaf.items())
          + f", one decode step's logits {errs['decode_logits']:.3e} "
          f"({limits}); first-token agreement {agree:.2f}")
    if held is not None and not (errs["prefill_logits"] <= tol["logits"]
                                 and errs["decode_logits"] <= tol["logits"]
                                 and errs["state"] <= tol["kv"]):
        raise AssertionError(f"{tag} {cfg.name}: the compiled steps leave the"
                             f" eager steps' envelope {tol}: {errs}")
    return errs


def layers_alone(tag, cfg, params, batch, mk):
    """Each compiled prefill layer op against the same op run eagerly,
    both fed the eager run's input to that layer: per layer, every
    output's max |d| / max(1, max|x|), printed beside
    ``HYBRID_LAYER_TOL`` (a few bf16 steps), not held: an RG-LRU gate that
    one rounding tips moves its channel's h by O(|h|) (1.8e-5 and 1.5e-2
    of max|h| at layer 1 in two runs on an H100)."""
    from repro_torch.core.regions import disable_compile
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed
    ops = T.layer_fns(cfg, SV.prefill_ctx())
    x = embed(params["embed"], batch["tokens"], cfg).float()
    rows = []
    with torch.no_grad():              # grad mode off, as in a compiled step
        for i, (kind, c) in enumerate(zip(T.layer_kinds(cfg), mk())):
            op = ops[kind]
            args = (T._leaves(params["layers"][i]), x,
                    [c[k] for k in op._cache_keys], None)
            got = op.op(*args)
            with disable_compile():
                want = op.op(*args)
            rows.append((i, kind[0], {k: rel_err(g, w) for k, g, w in zip(
                ("x",) + op._cache_keys, got, want)
                if g.is_floating_point()}))
            x = want[0]
    worst = max(e for _, _, d in rows for e in d.values())
    print(f"{tag} {cfg.name} {cfg.compute_dtype}: each compiled prefill layer "
          f"against the eager layer on the eager layer's input, max |d| / "
          f"max(1, max|x|): " + "; ".join(
              f"layer {i} {m} " + ", ".join(f"{k} {e:.1e}" for k, e in
                                            d.items())
              for i, m, d in rows) + f"; worst {worst:.1e} against a few "
          f"bf16 steps, {HYBRID_LAYER_TOL} (printed, not held)")


def moe_prefill_stats(cfg, params, batch, mk):
    """Per MoE layer of an eager prefill of ``batch``: (share of the
    (token, expert) pairs dropped at capacity, the largest expert's load
    over the mean load, (G, Tg, C), and on the same input the compiled
    routing's share of expert choices and of kept flags that differ from
    the eager routing's)."""
    from repro_torch.core.regions import compile_region_fn, disable_compile
    from repro_torch.launch import serve as SV
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.params import torch_dtype
    cdt = torch_dtype(cfg.compute_dtype)
    route_c = compile_region_fn(
        lambda p, h: tuple(M.route(p, h, cfg.moe)[k] for k in ("idx", "keep")),
        f"route_{cfg.name}")
    out = []
    ctx = SV.prefill_ctx()
    with disable_compile(), torch.no_grad():
        x = embed(params["embed"], batch["tokens"], cfg)
        for i, (p, c, kind) in enumerate(zip(params["layers"], mk(),
                                             T.layer_kinds(cfg))):
            x = T._carry(x, cfg, i)
            if kind[1] == "moe":
                # the MoE's input as layer_fwd makes it
                y, _ = A.attn_prefill(p["mixer"], rmsnorm(x, p["norm1"]).to(
                    cdt), cfg, kind=kind[0], ctx=ctx, cache=c)
                h2 = rmsnorm(x.to(cdt).float() + y.float(), p["norm2"]).to(cdt)
                r = M.route(p["mlp"], h2, cfg.moe)
                load = r["counts"].sum(0).float()
                idx_c, keep_c = route_c(p["mlp"], h2)
                out.append((1.0 - r["keep"].float().mean().item(),
                            (load.max() / load.mean()).item(), r["shape"],
                            (idx_c != r["idx"]).float().mean().item(),
                            (keep_c != r["keep"]).float().mean().item()))
            x, _, _ = T.layer_fwd(p, x, cfg, *kind, ctx, c)
    return out


def serve_hybrid_phase(args, dev, stamp):
    """``[serve-hybrid]``: recurrentgemma-9b (RG-LRU and local attention)
    at full width, compiled and eager, and the rows check of its decode
    layer kinds."""
    H = SERVE_HYBRID
    cfg, params, batch, mk = serve_cut(
        "[serve-hybrid]", args, dev, H["arch"], H["layers"], H["batch"],
        H["prompt_len"], H["gen"], eager=True)
    layers_alone("[serve-hybrid]", cfg, params, batch, mk)
    stamp("[serve-hybrid] recurrentgemma-9b served")
    rows_check(args, dev, H["arch"], cfg, params,
               H["prompt_len"] + H["gen"])
    del params


def serve_moe_phase(args, dev, stamp):
    """``[serve-moe]``: qwen3-moe-30b-a3b and llama4-scout-17b-a16e at full
    width, compiled, held to eager; the prefill's capacity drops and
    expert loads; the rows check of their decode layer kinds."""
    S_ = SERVE_MOE
    for arch, keep in S_["models"]:
        cfg, params, batch, mk = serve_cut(
            "[serve-moe]", args, dev, arch, keep, S_["batch"],
            S_["prompt_len"], S_["gen"])
        stats = moe_prefill_stats(cfg, params, batch, mk)
        print(f"[serve-moe] {arch} prefill of {S_['batch']}x"
              f"{S_['prompt_len']} tokens, by MoE layer: " + "; ".join(
                  f"layer {i}: {100 * d:.2f} % of (token, expert) pairs "
                  f"dropped at capacity (G {G}, Tg {Tg}, C {C}), largest "
                  f"expert load {mx:.2f}x the mean; the compiled routing of "
                  f"the same input: {100 * fi:.4f} % of expert choices and "
                  f"{100 * fk:.4f} % of kept flags differ"
                  for i, (d, mx, (G, Tg, C), fi, fk) in enumerate(stats)))
        stamp(f"[serve-moe] {arch} served")
        rows_check(args, dev, arch, cfg, params,
                   S_["prompt_len"] + S_["gen"])
        del params, batch, mk


def oversub_moe_phase(args, dev, stamp):
    """``[oversub-moe]``: one qwen3-moe-30b-a3b layer's experts in pinned
    host memory, decoded through ``moe_decode_paged`` with no budget and
    under ``MemoryBudget.for_ratio(footprint, r)``: every output bit for
    bit the unbudgeted run's, which is held to the dense ``moe_ref``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.oversub import MemoryBudget
    from repro_torch.core.umem import MemSpace, place
    from repro_torch.models import moe as M
    from repro_torch.models.params import init_params
    O = OVERSUB_MOE
    cfg = get_config(O["arch"])
    g = torch.Generator(device=dev).manual_seed(args.seed + 3)
    p = init_params(g, M.moe_specs(cfg), dev)
    xs = [torch.randn((1, 1, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(O["tokens"])]
    refs = [M.moe_ref(p, x, cfg)[0] for x in xs]
    # the expert stacks parked once in pinned host memory; the router stays
    host = {**p, **{k: place(p[k], MemSpace.HOST) for k in M.EXPERT_KEYS}}
    del p

    def stream(budget=None, lookahead=True):
        pager = M.ExpertPager(host, cfg, budget=budget, lookahead=lookahead)
        ledger = Ledger("oversub-moe")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ys = [M.moe_decode_paged(pager, x, cfg, ledger=ledger)[0] for x in xs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pager.close()
        return pager, ys, dt, ledger, torch.cuda.max_memory_allocated()

    stream()                                      # warm-up
    pager0, ys0, dt0, _, peak0 = stream()
    ref_err = max(rel_err(y, r) for y, r in zip(ys0, refs))
    print(f"[oversub-moe] {O['arch']}: one layer's experts, {cfg.moe.n_experts}"
          f" slabs of {pager0.slab_bytes / 1e6:.2f} MB "
          f"({pager0.footprint_bytes / 1e9:.3f} GB) in pinned host memory "
          f"(pinned {all(t.is_pinned() for t in pager0._host.values())}), "
          f"top-{cfg.moe.top_k}; {O['tokens']} seeded bf16 tokens of batch 1;"
          f" unbudgeted: {pager0.stats.fetches} fetches, "
          f"{pager0.stats.hits} hits, {O['tokens'] / dt0:.1f} tok/s, peak "
          f"{peak0 / 1e9:.2f} GB; against moe_ref on the card {ref_err:.3e} "
          f"of max(1, max|ref|) (limit {MOE_REF_TOL})")
    if not ref_err <= MOE_REF_TOL:
        raise AssertionError(f"[oversub-moe] the paged decode parts from "
                             f"moe_ref: {ref_err}")
    runs = [(r, True) for r in O["ratios"]] + [(O["ratios"][-1], False)]
    for ratio, lookahead in runs:
        budget = MemoryBudget.for_ratio(pager0.footprint_bytes, ratio,
                                        name="moe")
        pager, ys, dt, ledger, peak = stream(budget, lookahead)
        same = all(torch.equal(a, b) for a, b in zip(ys0, ys))
        st = pager.stats
        print(f"[oversub-moe] ratio {ratio:g}, lookahead "
              f"{'on' if lookahead else 'off'}: budget {budget.limit_bytes} B;"
              f" {st.fetches} fetches, {st.hits} hits, {st.evictions} "
              f"evictions, {st.bytes_fetched / 1e9:.3f} GB fetched, "
              f"{st.prefetch_hits} prefetch hits, prefetch_overlap_s "
              f"{st.prefetch_overlap_s:.4f} (ledger gauge "
              f"{ledger.serve_gauges.get('moe_prefetch_overlap_s', 0.0):.4f},"
              f" moe_prefetch_hit "
              f"{ledger.serve_counters.get('moe_prefetch_hit', 0)}); "
              f"{O['tokens'] / dt:.1f} tok/s; budget high water "
              f"{budget.stats.high_water_bytes} B against "
              f"torch.cuda.max_memory_allocated() {peak / 1e9:.3f} GB; "
              f"every output {'bit for bit' if same else 'NOT'} the "
              f"unbudgeted run's")
        if not same:
            raise AssertionError(f"[oversub-moe] ratio {ratio}: the budgeted "
                                 f"decode differs from the unbudgeted one")
        if ratio > 1 and not st.evictions > 0:
            raise AssertionError(f"[oversub-moe] ratio {ratio} evicted "
                                 f"nothing")
        if lookahead != (st.prefetch_hits > 0):
            raise AssertionError(f"[oversub-moe] prefetch hits {st.prefetch_hits}"
                                 f" with the lookahead {lookahead}")
    del host, refs


def train_phase(args, dev, stamp):
    """``[train]``: tinyllama-1.1b at full width, bf16 parameters and f32
    moments, random from ``--seed``, trained through the captured
    ``FWD_BWD``/``ADAMW_UPDATE`` program under the unified policy,
    compiled, on synthetic tokens from the ported pipeline: one warm-up
    step, then ``TRAIN["steps"]`` timed ones, then the same number on one
    fixed batch (the loss must fall: a sanity check).  Then, at
    ``TRAIN["check_layers"]`` layers: the compiled step in f32 against
    the eager one, ``--offload-optimizer`` (the moments in host memory
    between steps, the parameters equal to the device-resident run's),
    one step under the discrete policy, and a supervised run with a
    checkpoint every ``ckpt_every`` steps and a fault at ``fail_at``,
    its losses bit for bit an uninterrupted run's."""
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.regions import (Executor, disable_compile,
                                          synchronize)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train as LT
    from repro_torch.launch.policy import lm_policy
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed
    from repro_torch.models.params import param_count
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultInjector, TrainSupervisor
    from repro_torch.train import step as S
    TR = TRAIN
    B, L = TR["batch"], TR["seq"]
    full = get_config(TR["arch"])
    cfg = dataclasses.replace(full, n_layers=TR["layers"])
    src = SyntheticTokens(cfg.vocab, seed=args.seed)

    def batch_fn(step):
        page = src.batch_at(step, B, L)
        tokens = page.to(dev, copy=True)
        src.release(page)
        return {"tokens": tokens}

    def trainer(c, **kw):
        # a cut model is the first layers of a full-depth draw (the init's
        # scale follows the depth; drawn at 2 layers, tinyllama's f32
        # activations reach ~1e5 and its gradients lose ~5 digits)
        return LT.build_trainer(c, seed=args.seed, device=dev,
                                q_chunk=min(512, L),
                                draw_layers=full.n_layers, **kw)

    def run(step_fn, state, steps, batch=None):
        """``steps`` replays; (state, losses, grad norms, seconds)."""
        losses, gnorms = [], []
        synchronize()
        t0 = time.perf_counter()
        for s in steps:
            state, m = step_fn(state, batch or batch_fn(s))
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        synchronize()
        return (state, [float(x) for x in losses],
                [float(x) for x in gnorms], time.perf_counter() - t0)

    # -- the run at full width -------------------------------------------
    print(f"[train] {TR['arch']}: {cfg.n_layers} of {full.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} kv "
          f"heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{param_count(T.param_specs(cfg))} params, {cfg.param_dtype} "
          f"params, f32 moments; {B}x{L} tokens a step, unified, compiled")
    torch.cuda.reset_peak_memory_stats()
    init_fn, capture_fn, ex = trainer(cfg)
    regions = init_fn.regions
    state = init_fn()
    reset_plain()
    t0 = time.perf_counter()
    step_fn = capture_fn(state, batch_fn(0))
    t_capture = time.perf_counter() - t0
    state, warm, _, t_warm = run(step_fn, state, [0])
    state, losses, gnorms, dt = run(step_fn, state,
                                    range(1, TR["steps"] + 1))
    check_plain("[train]")
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {TR['steps']} steps after a warm-up: "
          f"{dt / TR['steps']:.4f} s a step, "
          f"{TR['steps'] * B * L / dt:.1f} tok/s; warm-up step {t_warm:.3f} s"
          f" (loss {warm[0]:.4f}); first loss {losses[0]:.4f}, last loss "
          f"{losses[-1]:.4f}; grad norm first {gnorms[0]:.4f}, last "
          f"{gnorms[-1]:.4f}; torch.cuda.max_memory_allocated() "
          f"{peak / 1e9:.2f} GB")
    print(f"[compile] [train] capture (first call of every part) "
          f"{t_capture:.2f} s; " + "; ".join(
              f"{name} by parts: " + ", ".join(
                  f"{k} {st.first_call_s:.2f} s ({st.recompiles} recompiles)"
                  for k, st in parts.items())
              for name, parts in S.compile_records(regions).items()))
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"[train] a loss or grad norm is not finite: "
                             f"{losses} {gnorms}")
    fixed = batch_fn(10_000)
    state, fl, _, _ = run(step_fn, state, range(TR["steps"]), fixed)
    print(f"[train] loss on one fixed batch over {TR['steps']} steps "
          f"(a sanity check): {' '.join(f'{x:.4f}' for x in fl)}")
    if not fl[-1] < fl[0]:
        raise AssertionError("[train] the loss did not fall on a fixed batch")
    check_plain("[train] fixed batch")
    del state, step_fn, init_fn, capture_fn, ex, regions
    stamp("[train] full width")

    # -- f32 at check_layers: compiled against eager -----------------------
    # FWD_BWD's gradients and ADAMW_UPDATE's parameters, compiled against
    # eager on the same inputs, each leaf against its own largest
    # magnitude; the gradients also against an f64 eager run of the same
    # model (the exact gradient up to the f32 RMSNorms), which tells the
    # f32 rounding of a steep init from a wrong compiled VJP
    c32 = dataclasses.replace(cfg, n_layers=TR["check_layers"],
                              param_dtype="float32", compute_dtype="float32")
    c64 = dataclasses.replace(c32, param_dtype="float64",
                              compute_dtype="float64")
    init_fn, _, _ = trainer(c32)
    p32 = init_fn()[0]
    p64 = pytree.tree_map(lambda t: t.double(), p32)
    fixed = batch_fn(0)
    tctx = T.Ctx(mode="train", q_chunk=min(512, L))
    names = [pytree.keystr(k) for k, _ in
             pytree.tree_flatten_with_path(p32)[0]]

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp(min=1e-300))
    # one train layer's VJP alone, compiled against eager, same inputs
    layer = T.train_layer_fns(c32, tctx)[("attn", "dense")]
    lp = T._leaves(p32["layers"][0])
    gx = torch.Generator(device=dev).manual_seed(args.seed + 11)
    x0 = embed(p32["embed"], fixed["tokens"], c32)
    dy = torch.randn(x0.shape, generator=gx, device=dev)
    daux = torch.zeros((), device=dev)       # a dense layer's MoE loss: 0
    got = layer.vjp(lp, x0, dy, daux)
    with disable_compile():
        want = layer.vjp(lp, x0, dy, daux)
    vjp_err = max(rel(a, b) for a, b in zip(got, want))
    (lc, _), gc = S.value_and_grad(p32, fixed, c32, tctx)
    with disable_compile():
        (le, _), ge = S.value_and_grad(p32, fixed, c32, tctx)
        (l64, _), g64 = S.value_and_grad(p64, fixed, c64, tctx)
    loss_err = abs(float(lc) - float(le)) / abs(float(le))
    gn = [float(adamw.global_norm(g)) for g in (gc, ge, g64)]
    gnorm_err = abs(gn[0] - gn[1]) / gn[1]
    gnorm_c64, gnorm_e64 = (abs(x - gn[2]) / gn[2] for x in gn[:2])
    leaf = []                       # (name, vs eager, compiled/eager vs f64)
    for nm, a, b, r in zip(names, pytree.tree_leaves(gc),
                           pytree.tree_leaves(ge), pytree.tree_leaves(g64)):
        leaf.append((nm, rel(a, b), rel(a, r), rel(b, r)))
    worst = sorted(leaf, key=lambda t: -t[1])
    bad = [t for t in leaf if t[2] > max(TRAIN_GRAD_RATIO * t[3],
                                         TRAIN_GRAD_FLOOR)]
    opt_cfg = adamw.AdamWConfig(lr=3e-4)
    pc = pe = p32
    sc = se = adamw.init_state(p32, opt_cfg)
    for _ in range(2):
        pc, sc, _ = adamw.apply_updates(pc, ge, sc, opt_cfg)
        with disable_compile():
            pe, se, _ = adamw.apply_updates(pe, ge, se, opt_cfg)
    param_err = max(rel(a, b) for a, b in zip(pytree.tree_leaves(pc),
                                              pytree.tree_leaves(pe)))
    print(f"[train] f32, {c32.n_layers} layers, compiled against eager "
          f"(TF32 off): one attention layer's VJP alone, same inputs: "
          f"{vjp_err:.3e} of each leaf's largest magnitude (limit "
          f"{TRAIN_VJP_TOL}); FWD_BWD: loss {loss_err:.3e} relative (limit "
          f"{TRAIN_LOSS_TOL}), grad norm {gnorm_err:.3e} (against f64: "
          f"compiled {gnorm_c64:.3e}, eager {gnorm_e64:.3e}); gradients by "
          f"leaf, compiled against eager (against f64: compiled, eager), "
          f"worst first: " + "; ".join(
              f"{nm} {e:.2e} ({c:.2e}, {r:.2e})" for nm, e, c, r in worst)
          + f"; each leaf's compiled gradient within max({TRAIN_GRAD_RATIO} "
          f"x eager's, {TRAIN_GRAD_FLOOR}) of the f64 one: "
          f"{len(leaf) - len(bad)} of {len(leaf)}; ADAMW_UPDATE on the same "
          f"gradients, 2 steps: params {param_err:.3e} of each leaf's "
          f"largest magnitude (limit {TRAIN_PARAM_TOL})")
    if vjp_err > TRAIN_VJP_TOL or loss_err > TRAIN_LOSS_TOL or bad or \
            gnorm_c64 > max(TRAIN_GRAD_RATIO * gnorm_e64,
                            TRAIN_GRAD_FLOOR) or \
            param_err > TRAIN_PARAM_TOL:
        raise AssertionError("[train] the compiled f32 step parts from the "
                             f"eager one: {[t[0] for t in bad]}")
    del p32, p64, gc, ge, g64, pc, pe, sc, se, got, want
    stamp("[train] f32 compiled against eager")

    # -- offload, discrete, supervised: bf16 at check_layers ---------------
    c2 = dataclasses.replace(cfg, n_layers=TR["check_layers"])
    init_fn, capture_fn, ex = trainer(c2)
    state = init_fn()
    base, _, _, _ = run(capture_fn(state, batch_fn(0)), state, range(2))
    init_fn, capture_fn, ex_off = trainer(c2, offload_optimizer=True)
    state = init_fn()
    step_fn = capture_fn(state, batch_fn(0))
    where = []
    for s in range(2):
        state, _, _, _ = run(step_fn, state, [s])
        where.append(sorted({str(t.device) for t in pytree.tree_leaves(
            (state[1]["m"], state[1]["v"]))}))
    off_err = max(float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp(min=1e-30))
                  for a, b in zip(pytree.tree_leaves(state[0]),
                                  pytree.tree_leaves(base[0])))
    pinned = all(t.is_pinned() for t in pytree.tree_leaves(
        (state[1]["m"], state[1]["v"])))
    rep = ex_off.report()
    print(f"[train] --offload-optimizer, unified, {c2.n_layers} layers: AdamW"
          f" moments between steps on {where} (pinned {pinned}); "
          f"staging_fraction {rep['staging_fraction']:.4f} "
          f"({rep['staging_s']:.4f} s); params against the device-resident "
          f"run's: {off_err:.3e} of the leaf's largest magnitude (limit "
          f"{TRAIN_OFFLOAD_TOL})")
    if any(w != ["cpu"] for w in where) or off_err > TRAIN_OFFLOAD_TOL:
        raise AssertionError("[train] offloaded moments left host memory or "
                             "changed the update")
    del state, step_fn, base
    d_ex = Executor(lm_policy("discrete", c2.memory, device=dev),
                    Ledger("train-discrete"))
    init_fn, capture_fn, _ = trainer(c2, executor=d_ex)
    state = init_fn()
    run(capture_fn(state, batch_fn(0)), state, [0])
    rep = d_ex.report()
    print(f"[train] one step under discrete, {c2.n_layers} layers: "
          f"staging_fraction {rep['staging_fraction']:.4f} "
          f"({rep['staging_s']:.4f} s staging)")
    if not rep["staging_fraction"] > 0:
        raise AssertionError("[train] discrete staged nothing")
    del state
    stamp("[train] offload and discrete")

    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    init_fn, capture_fn, ex_s = trainer(c2)
    hist = {}
    for name, fail in (("uninterrupted", ()), ("fault", (TR["fail_at"],))):
        state = init_fn()
        sup = TrainSupervisor(
            capture_fn(state, batch_fn(0)), batch_fn,
            Checkpointer(str(ckpt_root / name), keep=2),
            ckpt_every=TR["ckpt_every"], fault=FaultInjector(fail),
            rebuild_step=lambda st, step: capture_fn(st, batch_fn(step)),
            report_fn=ex_s.report)
        state, rep = sup.run(state, 0, TR["sup_steps"])
        hist[name] = ({s: m["loss"] for s, m in rep.history}, rep.restarts)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    rows = sorted(ex_s.ledger.regions)
    same = hist["fault"][0] == hist["uninterrupted"][0]
    print(f"[train] supervised, {c2.n_layers} layers, {TR['sup_steps']} "
          f"steps, a checkpoint every {TR['ckpt_every']}, fault at step "
          f"{TR['fail_at']}: {hist['fault'][1]} restart; losses "
          f"{'equal' if same else 'NOT equal'} bit for bit to the "
          f"uninterrupted run's ({hist['fault'][0]}); ledger rows {rows}")
    if not same or hist["fault"][1] != 1 or rows != ["ADAMW_UPDATE",
                                                    "FWD_BWD"]:
        raise AssertionError("[train] the supervised restart parts from the "
                             "uninterrupted run")
    stamp("[train] supervised")


#: the phases a child process runs once ahead of this process
#: (:func:`start_warm`): compile-bound, and needing nothing from the phases
#: before them
WARM = ("serve-hybrid", "serve-moe", "oversub-moe")


def start_warm(args):
    """Start ``chip_smoke.py --only <WARM>`` as a child process at the
    lowest CPU priority: it runs those phases once, checks included, so
    that their Inductor and Triton compiles land in the on-disk caches the
    two processes share, while this process runs the phases before them;
    this process then runs them itself, its compiles reading those caches.
    The child's output goes to ``build/chip_smoke_warm.log``.  Returns
    (process, log file, start time)."""
    path = ROOT / "build" / "chip_smoke_warm.log"
    path.parent.mkdir(parents=True, exist_ok=True)
    log = open(path, "w")
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--seed",
         str(args.seed), "--only", ",".join(WARM)],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        preexec_fn=lambda: os.nice(19))
    atexit.register(_stop, proc)
    return proc, log, time.perf_counter()


def _stop(proc):
    """End a child still running (this run failed before it was joined):
    SIGTERM first, so that it stops its own compile workers."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


def finish_warm(warm):
    """Wait for the child of :func:`start_warm` and report it (its
    failure is not this run's: this process runs and checks the same
    phases itself)."""
    proc, log, t0 = warm
    rc = proc.wait()
    log.close()
    tail = pathlib.Path(log.name).read_text().splitlines()[-3:]
    print(f"[compile] the child process that ran {', '.join(WARM)} ahead "
          f"(their compiles into the shared caches) exited {rc} after "
          f"{time.perf_counter() - t0:.0f} s" + ("" if rc == 0 else
                                                 f": {tail}"), flush=True)


#: the phases ``--only`` may run alone (each a function of (args, dev,
#: stamp) that checks what it runs)
ONLY = {"serve-hybrid": "serve_hybrid_phase", "serve-moe": "serve_moe_phase",
        "oversub-moe": "oversub_moe_phase", "engine": "engine_phase",
        "train": "train_phase"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="run only these phases, comma-separated, of "
                    f"{', '.join(ONLY)} (a partial run: it prints no result "
                    "line)")
    args = ap.parse_args(argv)
    only = None if args.only is None else args.only.split(",")
    if only and not set(only) <= set(ONLY):
        ap.error(f"--only takes {', '.join(ONLY)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(src))
    from repro_torch.cfd import fvm
    from repro_torch.cfd.dia import DiaMatrix
    from repro_torch.cfd.grid import Grid, interior_mask, NEIGHBORS
    from repro_torch.cfd.precond import rb_dilu_factor
    from repro_torch.cfd.simple import (SimpleConfig, SimpleFoam,
                                        SimpleState, init_state)
    from repro_torch.cfd.solvers import (make_solver_regions,
                                         pbicgstab_regions, solve)
    from repro_torch.core.oversub import (BudgetedPlacer, BudgetStats,
                                          MemoryBudget, workload_bytes)
    from repro_torch.core.program import AsyncExecutor
    from repro_torch.core.program import capture
    from repro_torch.core.regions import (AdaptivePolicy, DiscretePolicy,
                                          Executor, Region, StaticSelector,
                                          TargetSelector, UnifiedPolicy,
                                          compile_disabled, compile_region_fn,
                                          disable_compile, make_policy,
                                          region)
    from repro_torch.kernels import build
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import Ledger
    from repro_torch.core.umem import (MemSpace, tree_leaves, tree_map,
                                      tree_place)
    from repro_torch.kernels.fused_field import kernel as FK, ref as FR
    from repro_torch.kernels.rwkv6_scan import kernel as RK, ref as RR
    from repro_torch.kernels.stencil_spmv import kernel as SK, ref as SR
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed
    from repro_torch.models.params import param_count
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step
    count_plain_calls(Region, (SR, FR, RR), compile_disabled)

    t_start = time.perf_counter()

    def stamp(done):
        print(f"[time] {done} done, {time.perf_counter() - t_start:.0f} s "
              f"into the run", flush=True)

    # -- 1. the card ----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch: {name}  count: {torch.cuda.device_count()}  "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])
    print(f"[host] {host_line()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 comparisons below
    torch.backends.cudnn.allow_tf32 = False
    if only:
        if "engine" in only:                   # its rwkv6-7b runs K5
            build.library()
        for phase in only:
            reset_plain()
            globals()[ONLY[phase]](args, dev, stamp)
            check_plain(f"[{phase}]")
            stamp(phase)
        print(json.dumps({"partial": only}))
        return

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    t_nvcc = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16):             # JIT-compile
        x = torch.ones(1000, device=dev, dtype=dt)
        FK.fused_axpy(1.0, x, x)
        FK.fused_xpay(1.0, x, x)
        FK.fused_mul(x, x)
        FK.fused_axpbypz(1.0, x, 1.0, x, x)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"[build] nvcc {t_nvcc:.2f} s ({build.library_path().name}); "
          f"triton {t_triton:.2f} s; ptxas: {' | '.join(ptxas) or 'cached'}")
    hmma = {fn: n for fn, n in sass_counts(build.library_path(),
                                           "HMMA").items()
            if "rwkv6_scan" in fn}
    print(f"[build] HMMA instructions in K5's SASS (cuobjdump -sass): "
          f"{json.dumps(hmma)}")
    if len(hmma) != 2 or min(hmma.values()) <= 0:
        raise AssertionError("K5's f32 and bf16 kernels must both run on the "
                             f"tensor cores (HMMA): {hmma}")

    stamp("build")

    # -- 3. kernels vs plain, then timed --------------------------------
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=g, device=dev).to(dtype)

    records = {}
    for shape in ((N, N, N), (37, 29, 23)):
        grid = Grid(shape)
        n = grid.n
        red = grid.red_black_masks()[0]
        nb = sum(interior_mask(grid, ax, d) for ax, d in NEIGHBORS)
        diag, x, rdiag = rand(*shape), rand(*shape), rand(*shape) + 0.5
        off = rand(6, *shape) - 0.5
        stencil_cases = {
            # name: (kernel, plain, args, bytes, flops, library call)
            "stencil_spmv": (SK.stencil_spmv, SR.stencil_spmv,
                             (diag, off, x), 36 * n,
                             (1 + 2 * nb).sum().item(),
                             lambda d, o, x, A=stencil_csr(diag, off):
                                 torch.mv(A, x.reshape(-1)).view(x.shape)),
            "rb_dilu_forward": (SK.rb_dilu_forward, SR.rb_dilu_forward,
                                (rdiag, red, off, x), 37 * n,
                                torch.where(red, 1.0, 3 * nb + 2).sum().item(),
                                None),
            "rb_dilu_backward": (SK.rb_dilu_backward, SR.rb_dilu_backward,
                                 (rdiag, red, off, x), 37 * n,
                                 torch.where(red, 2 * nb + 2, 0.0).sum().item(),
                                 None),
        }
        cases = [(k, torch.float32, v) for k, v in stencil_cases.items()]
        for dt in (torch.float32, torch.bfloat16):
            fx, fy, fz = rand(n, dtype=dt), rand(n, dtype=dt), rand(n, dtype=dt)
            a, b = 1.7, -0.3
            size = fx.element_size() * n
            cases += [
                ("fused_axpy", dt, (FK.fused_axpy, FR.fused_axpy, (a, fx, fy),
                                    3 * size, 2 * n,
                                    lambda a, x, y: torch.add(y, x, alpha=a))),
                ("fused_xpay", dt, (FK.fused_xpay, FR.fused_xpay, (a, fx, fy),
                                    3 * size, 2 * n,
                                    lambda a, x, y: torch.add(x, y, alpha=a))),
                ("fused_mul", dt, (FK.fused_mul, FR.fused_mul, (fx, fy),
                                   3 * size, n, torch.mul)),
                ("fused_axpbypz", dt, (FK.fused_axpbypz, FR.fused_axpbypz,
                                       (a, fx, b, fy, fz), 4 * size, 4 * n,
                                       None)),
            ]
        for kname, dt, (kfn, pfn, kargs, nbytes, flops, lib) in cases:
            got = kfn(*kargs)
            want = pfn(*kargs)
            torch.cuda.synchronize()
            tol = KERNEL_TOL if kname in stencil_cases else FIELD_TOL[dt]
            torch.testing.assert_close(got.float(), want.float(), **tol)
            if lib is not None:             # the library computes the same
                torch.testing.assert_close(lib(*kargs).float(), want.float(),
                                           **tol)
            err = (got.float() - want.float()).abs().max().item()
            line = (f"[kernel] {kname} {str(dt)[6:]} {'x'.join(map(str, shape))}"
                    f" max_abs_err {err:.3e} ok")
            if shape == (N, N, N):
                t = time_ms(lambda: kfn(*kargs))
                plain_ms = time_ms(lambda: pfn(*kargs)).ms
                lib_t = time_ms(lambda: lib(*kargs)) if lib else None
                bound_ms, bound_by = bound(nbytes, flops)
                line += (f" | ms {spread(t)} plain_ms {plain_ms:.4f} "
                         f"library_ms {'-' if lib_t is None else spread(lib_t)}"
                         f" bound_ms {bound_ms:.4f} ({bound_by}) "
                         f"share_of_bound {bound_ms / t.ms:.3f}")
                if dt == torch.float32:
                    records[kname] = dict(
                        name=kname,
                        route="cuda" if kname in stencil_cases else "triton",
                        source=("src/repro_torch/kernels/csrc/stencil.cu"
                                if kname in stencil_cases else
                                "src/repro_torch/kernels/fused_field/kernel.py"),
                        replaces=REPLACES[kname], launches=0, max_abs_err=err,
                        **timing_keys(t, lib_t), plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            print(line)
        # K2/K3 read the mask, never the parity of i+j+k: a random one,
        # from its own generator so the other checks' inputs stay as they were
        g_mask = torch.Generator(device=dev).manual_seed(args.seed + 1)
        red_rand = torch.rand(shape, generator=g_mask, device=dev) < 0.5
        for kname in ("rb_dilu_forward", "rb_dilu_backward"):
            kargs = (rdiag, red_rand, off, x)
            got = getattr(SK, kname)(*kargs)
            want = getattr(SR, kname)(*kargs)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            print(f"[kernel] {kname} float32 {'x'.join(map(str, shape))} "
                  f"random mask max_abs_err "
                  f"{(got - want).abs().max().item():.3e} ok")

    # K5 at the serve path's prefill shape and at two ragged ones (T not a
    # multiple of the kernel's 64-row chunk, the last chunk of 8 and of 40
    # rows, hd=64, steep decays down to the model's floor of log w = -12,
    # which underflow inside a chunk).  In bf16 both sides widen the same
    # r/k/v to f32 exactly, so the tolerance is the f32 one.
    scfg = get_config("rwkv6-7b")
    SB, SP = SERVE["batch"], SERVE["prompt_len"]
    for dims in ((SB, SP, scfg.n_heads, scfg.hd), (1, 200, 3, 64),
                 (2, 1000, 4, 64)):
        B, Tn, H, hd = dims
        r32, k32, v32 = (0.5 * torch.randn(dims, generator=g, device=dev)
                         for _ in range(3))
        if Tn == SP:
            logw = -2 * torch.rand(dims, generator=g, device=dev) - 0.01
        else:
            logw = -torch.exp(torch.rand(dims, generator=g, device=dev) * 11
                              - 8).clamp(max=12.0)
        u = 0.3 * torch.randn(H, hd, generator=g, device=dev)
        S0 = 0.2 * torch.randn(B, H, hd, hd, generator=g, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            kargs = (r32.to(dt), k32.to(dt), v32.to(dt), logw, u, S0)
            out, S = RK.rwkv6_scan(*kargs)
            want_out, want_S = RR.rwkv6_scan(*kargs)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want_out, **SCAN_TOL)
            torch.testing.assert_close(S, want_S, **SCAN_TOL)
            err = max((out - want_out).abs().max().item(),
                      (S - want_S).abs().max().item())
            line = (f"[kernel] rwkv6_scan {str(dt)[6:]} "
                    f"{'x'.join(map(str, dims))} max_abs_err {err:.3e} ok")
            if Tn == SP:
                t = time_ms(lambda: RK.rwkv6_scan(*kargs))
                plain_ms = time_ms(lambda: RR.rwkv6_scan(*kargs), reps=5,
                                   warmup=1).ms
                bound_ms, bound_by = bound(*scan_work(
                    B, Tn, H, hd, kargs[0].element_size()))
                line += (f" | ms {spread(t)} plain_ms {plain_ms:.4f} "
                         f"library_ms - bound_ms {bound_ms:.4f} ({bound_by}) "
                         f"share_of_bound {bound_ms / t.ms:.3f}")
                if dt == torch.bfloat16:        # what the serve path feeds
                    records["rwkv6_scan"] = dict(
                        name="rwkv6_scan", route="cuda",
                        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                        replaces=REPLACES["rwkv6_scan"], launches=0,
                        max_abs_err=err, **timing_keys(t, None),
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
            print(line)
    del r32, k32, v32, logw, u, S0, kargs, out, S, want_out, want_S

    stamp("kernels")
    # the compile-bound phases after [serve-attn], run ahead in a child
    ahead = start_warm(args)

    # -- 4. CFD path: unified + hopper at 200^3 -------------------------
    def reset_launches():
        for table in (SK.LAUNCHES, FK.LAUNCHES, RK.LAUNCHES):
            for k in table:
                table[k] = 0

    def launches():
        return {**SK.LAUNCHES, **FK.LAUNCHES, **RK.LAUNCHES}

    grid = Grid((N, N, N))
    cfg = SimpleConfig(grid, nu=0.1, inner_max=25)

    def hopper_app(c):
        """An app under unified/hopper and the Regions it made."""
        n0 = len(REGIONS)
        a = SimpleFoam(c, executor=Executor(
            UnifiedPolicy(selector=StaticSelector("hopper"))))
        return a, REGIONS[n0:]

    def main_run(a):
        """One warm-up step, then 2 timed steps, from the initial state:
        (state, FOM, metrics, warm-up s, launches of the 3 steps, compiles
        after the warm-up)."""
        reset_launches()
        s0, warm_s, _ = a.run_steps(init_state(cfg), 1)
        a.ledger.reset_timings()
        warm = compiles_of(REGIONS)
        s0, fom_, m_ = a.run_steps(s0, 2)
        return s0, fom_, m_, warm_s, launches(), warm

    def region_ms(a):
        return {r.name: r.compute_s / r.calls * 1e3
                for r in a.ledger.regions.values() if r.calls}

    app, app_regions = hopper_app(cfg)
    reset_plain()
    st, fom, m, fom_warm, counts, warm = main_run(app)
    check_plain("[main]")
    if compiles_of(REGIONS) != warm:
        raise AssertionError("[main]: a region recompiled after the warm-up "
                             "step")
    rep = app.ex.report()
    print(f"[compile] [main] {N}^3 unified/hopper, per region: first call "
          f"(trace, compile, run) and graphs kept; 0 compiled after the "
          f"warm-up step: " + compile_rows(app_regions))
    # where the compile seconds went: Dynamo's and Inductor's own timers,
    # summed over every compile of the run so far (the [main] regions)
    heads, secs = torch._dynamo.utils.compile_times(repr="csv",
                                                    aggregate=True)
    top = sorted(((float(v), k) for k, v in zip(heads, secs)), reverse=True)
    print("[compile] [main] Dynamo/Inductor timers, seconds summed over the "
          "regions' compiles, largest first: " + "; ".join(
              f"{k} {v:.2f}" for v, k in top[:12]))
    print(f"[main] unified/hopper {N}^3 inner_max=25, compiled: FOM "
          f"{fom:.4f} s/step (warm-up step {fom_warm:.4f} s) res_u "
          f"{m['res_u']:.3e} iters_u {m['iters_u']} res_p {m['res_p']:.3e} "
          f"iters_p {m['iters_p']} impl_counts {rep['impl_counts']} "
          f"staging_fraction {rep['staging_fraction']:.4f}")
    print(f"[main] launches over 3 steps: {json.dumps(counts)}")
    rows = sorted(app.ledger.regions.values(), key=lambda r: -r.compute_s)
    total = sum(r.compute_s for r in rows)
    print(f"[main] 2 timed steps {2 * fom:.4f} s: outside regions "
          f"{2 * fom - total:.4f} s; region compute_s (share of "
          f"{total:.4f} s): " + "; ".join(
              f"{r.name} {r.compute_s:.4f} ({r.compute_s / total:.1%}, "
              f"{r.calls} calls)" for r in rows if r.calls))
    print("[main] precondition(DILU) %.4f ms a call (%d calls)"
          % dilu_ms(app.ledger))
    for f in "uvwp":
        if not torch.isfinite(getattr(st, f)).all():
            raise AssertionError(f"field {f} is not finite")
    if rep["impl_counts"].get("hopper", 0) <= 0:
        raise AssertionError(f"no hopper variant ran: {rep['impl_counts']}")
    on_path = CFD_KERNELS
    for k in on_path:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
        records[k]["launches"] = counts[k]

    # the same runs eagerly (disable_compile), in turns with compiled ones
    turns = {"compiled": [(fom, region_ms(app))], "eager": []}
    eager_app = None
    for mode in ("eager", "compiled", "eager"):
        if mode == "eager":
            with disable_compile():
                eager_app = eager_app or hopper_app(cfg)[0]
                fom_t = main_run(eager_app)[1]
            turns[mode].append((fom_t, region_ms(eager_app)))
        else:
            reset_plain()
            fom_t = main_run(app)[1]
            check_plain("[main] compiled turn")
            turns[mode].append((fom_t, region_ms(app)))
    ms_c, ms_e = turns["compiled"][0][1], turns["eager"][0][1]
    print("[main] in turns (compiled, eager, compiled, eager; 1 warm-up + 2 "
          "timed steps each): FOM compiled " + ", ".join(
              f"{t[0]:.4f}" for t in turns["compiled"]) + " s/step, eager "
          + ", ".join(f"{t[0]:.4f}" for t in turns["eager"]) + " s/step; "
          "ms a call compiled/eager (first turn of each): " + "; ".join(
              f"{k} {ms_c[k]:.4f}/{ms_e.get(k, float('nan')):.4f}"
              for k in sorted(ms_c, key=lambda k: -ms_c[k])))
    del eager_app

    # one step from the same state, tol=0 on both sides: hopper vs ref,
    # run eagerly as before regions were compiled (there hopper equals ref
    # bit for bit; compiled, Inductor rounds the ref glue its own way, and
    # 25 PBiCGStab iterations on the pinned pressure system turn that into
    # O(max|x|) differences, see [fused])
    cfg0 = SimpleConfig(grid, nu=0.1, inner_max=25, tol_u=0.0, tol_p=0.0)
    outs = {}
    with disable_compile():
        for impl in ("hopper", "ref"):
            a = SimpleFoam(cfg0, executor=Executor(
                UnifiedPolicy(selector=StaticSelector(impl))))
            outs[impl] = a.run_steps(st, 1)
    errs = {}
    for f in "uvwp":
        err, allowed = envelope_err(getattr(outs["ref"][0], f),
                                    getattr(outs["hopper"][0], f))
        errs[f] = err
        if not err <= allowed:
            raise AssertionError(f"hopper step leaves the ref envelope in {f}:"
                                 f" {err:.3e} > {allowed:.3e}")
    print(f"[main] tol=0 step hopper vs ref (eager): max_abs_err {errs}; "
          f"step s: hopper {outs['hopper'][1]:.4f} ref {outs['ref'][1]:.4f} "
          f"(ref/hopper {outs['ref'][1] / outs['hopper'][1]:.2f})")

    stamp("main")

    # -- 5. the four memory models (Fig 5) at 200^3 ---------------------
    # one warm-up and one timed step each, tol=0 so every policy runs the
    # same iterations; host keeps its fields on the CPU (the dCPU model)
    def steps_cfg(device):
        return SimpleConfig(Grid((N, N, N), device=device), nu=0.1,
                            inner_max=3, tol_u=0.0, tol_p=0.0)

    sel = TargetSelector("hopper")
    st_host = SimpleState(*(getattr(st, f).cpu() for f in "uvwp"), st.step)
    # the three card policies run one app's regions (and so its compiled
    # executables), each through its own executor on the app's ledger
    dev_app = SimpleFoam(steps_cfg(dev), executor=Executor(
        UnifiedPolicy(selector=sel)))
    res = {}
    for pname in POLICIES:
        policy = make_policy(pname, selector=sel,
                             **({"device": dev} if pname == "discrete" else {}))
        if pname == "host":
            a = SimpleFoam(steps_cfg("cpu"), executor=Executor(policy))
        else:
            a = dev_app
            a.ex = Executor(policy, a.ledger)
        cut_s = None
        if pname == "adaptive":
            t0 = time.perf_counter()
            a.calibrate_cutoff(policy)
            cut_s = time.perf_counter() - t0
        s0 = st_host if pname == "host" else st
        a.run_steps(s0, 1)                                 # warm-up (pools)
        a.ledger.reset_timings()
        reset_launches()
        reset_plain()
        s1, fom1, _ = a.run_steps(s0, 1)
        check_plain(f"[policies] {pname}")
        res[pname] = dict(state=s1, fom=fom1, launches=launches(),
                          rep=a.ex.report(), policy=policy, cut_s=cut_s,
                          staged=sum(x.staging_bytes
                                     for x in a.ledger.regions.values()))
        if pname == "unified":
            # the same step eagerly (disable_compile): within the step
            # envelope, with the same kernel launches (3 PBiCGStab
            # iterations: many more on the pinned pressure system would
            # amplify Inductor's rounding of the ref glue, see [fused])
            reset_launches()
            with disable_compile():
                s_e, fom_e, _ = a.run_steps(s0, 1)
            cnt_e = launches()
            errs = {}
            for f in "uvwp":
                err, allowed = envelope_err(getattr(s_e, f), getattr(s1, f))
                errs[f] = err
                if not err <= allowed:
                    raise AssertionError(
                        f"compiled step leaves the eager step's envelope in "
                        f"{f}: {err:.3e} > {allowed:.3e}")
            if cnt_e != res["unified"]["launches"]:
                raise AssertionError(f"compiled step launched "
                                     f"{res['unified']['launches']}, eager "
                                     f"step {cnt_e}")
            print(f"[policies] unified {N}^3 inner_max=3 compiled vs eager "
                  f"step: max_abs_err {errs}; FOM compiled {fom1:.4f}, eager "
                  f"{fom_e:.4f} s/step; launches equal: {json.dumps(cnt_e)}")
    fu = res["unified"]["fom"]
    for pname in POLICIES:
        r = res[pname]
        rep_p, cnt, staged = r["rep"], r["launches"], r["staged"]
        errs = {}
        for f in "uvwp":
            err, allowed = envelope_err(getattr(res["unified"]["state"], f),
                                        getattr(r["state"], f))
            errs[f] = err
            if not err <= allowed:
                raise AssertionError(f"{pname} step leaves the unified "
                                     f"envelope in {f}: {err:.3e} > "
                                     f"{allowed:.3e}")
        extra = ""
        if pname == "adaptive":
            pol = r["policy"]
            extra = (f"; cutoff {pol.cutoff} calibrated on the card in "
                     f"{r['cut_s']:.2f} s over Amul sizes (host s / device "
                     f"s a call): " + ", ".join(
                         f"{n}: {t['host']:.3e}/{t['device']:.3e}"
                         for n, t in pol.calibration.items()))
            if rep_p["cutoffs"] != {"Amul": pol.cutoff} or \
                    not pol.calibration:
                raise AssertionError(f"adaptive cutoff not calibrated: "
                                     f"{rep_p['cutoffs']}")
        print(f"[policies] {pname} {N}^3 inner_max=3: FOM {r['fom']:.4f} "
              f"s/step ({pname}/unified {r['fom'] / fu:.2f}); "
              f"staging_fraction {rep_p['staging_fraction']:.4f} "
              f"({staged / 1e9:.3f} GB); device_calls "
              f"{rep_p['device_calls']} host_calls {rep_p['host_calls']}; "
              f"impl_counts {rep_p['impl_counts']}; launches "
              f"{json.dumps(cnt)}; max_abs_err vs unified {errs}{extra}")
        if pname == "host":
            if any(cnt.values()) or "hopper" in rep_p["impl_counts"] \
                    or staged:
                raise AssertionError("the host policy launched a kernel, "
                                     "ran hopper or staged bytes")
        else:
            missing = [k for k in CFD_KERNELS if cnt[k] <= 0]
            if missing or rep_p["host_calls"]:
                raise AssertionError(f"{pname}: kernels {missing} never "
                                     f"launched, {rep_p['host_calls']} "
                                     "host-routed calls")
    rep_d = res["discrete"]["rep"]
    sf = rep_d["staging_fraction"]
    if not sf > 0.5:
        raise AssertionError(f"discrete staging_fraction {sf:.3f} <= 0.5")
    fd = res["discrete"]["fom"]
    staged = res["discrete"]["staged"]
    print(f"[discrete] {N}^3 inner_max=3: FOM discrete {fd:.4f} s/step, "
          f"unified {fu:.4f} s/step, discrete/unified {fd / fu:.2f}; "
          f"staging_fraction {sf:.4f} ({rep_d['staging_s']:.4f} s, "
          f"{staged / 1e9:.3f} GB); host pool "
          f"{json.dumps(res['discrete']['policy'].stager.host_pool.stats.as_dict())}; "
          f"launches {json.dumps(res['discrete']['launches'])}")
    dev_app.ex = Executor(UnifiedPolicy(selector=sel), dev_app.ledger)
    cutoff = res["adaptive"]["policy"].cutoff       # for [oversub]
    del res, st_host, s0, s1, a, policy, s_e

    stamp("policies")

    # -- 6. the fused solver on the step's pressure system -------------
    # timed at the step's 25 iterations; held against the region-wise
    # solve at 3 (the [policies] steps'): on this pinned, nearly singular
    # system PBiCGStab turns rounding-level differences in its scalars
    # into O(max|x|) ones within 25 iterations (tests/test_torch_solvers.py
    # holds the port's and the reference's solvers together at 3 and 10)
    taps = {}

    def tap(r, *args, **kwargs):
        out = app.ex.run(r, *args, **kwargs)
        if r is app.assemble_pressure:
            taps["pressure"] = out
        return out

    app.time_step(st, executor=types.SimpleNamespace(run=tap))
    dp, offp, rp = taps.pop("pressure")
    A = DiaMatrix(dp, offp)
    red = grid.red_black_masks()[0]
    x0 = torch.zeros_like(rp)
    fused = {}
    reset_launches()
    reset_plain()
    for precond in ("DILU", "Jacobi"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve(A, rp, x0, red, tol=cfg.tol_p, max_iter=cfg.inner_max,
                  use_dilu=precond == "DILU")
        fused[precond] = (r, time.perf_counter() - t0)
    cnt = launches()
    check_plain("[fused]")
    if min(cnt[k] for k in CFD_KERNELS[:3]) <= 0:
        raise AssertionError(f"the fused solver did not launch K1-K3: {cnt}")
    ldg = Ledger("fused_check")
    reset_plain()
    rd = solve(A, rp, x0, red, tol=cfg.tol_p, max_iter=3)
    check_plain("[fused]")
    rr = pbicgstab_regions(Executor(UnifiedPolicy(selector=sel), ldg),
                           make_solver_regions(ldg), A, rp, x0,
                           rb_dilu_factor(A, red), tol=cfg.tol_p,
                           max_iter=3)
    if rd.iters != rr.iters:
        raise AssertionError(f"fused DILU took {rd.iters} iterations, "
                             f"pbicgstab_regions {rr.iters}")
    torch.testing.assert_close(rd.x, rr.x, **SOLVE_TOL)
    err = (rd.x - rr.x).abs().max().item()
    for precond, (r, t) in fused.items():
        if not torch.isfinite(r.x).all():
            raise AssertionError(f"fused {precond} solution is not finite")
        print(f"[fused] {precond} on the {N}^3 pressure system: "
              f"{r.iters} iterations, residual {r.initial_residual:.3e} -> "
              f"{r.final_residual:.3e}, {t * 1e3:.2f} ms (factor included)")
    print("[fused] pbicgstab_regions at 3 iterations: precondition(DILU) "
          "%.4f ms a call (%d calls)" % dilu_ms(ldg))
    print(f"[fused] launches {json.dumps(cnt)}; DILU vs pbicgstab_regions "
          f"at 3 iterations: iterations equal, max_abs_err {err:.3e} of "
          f"max|x| {rr.x.abs().max().item():.3e} (rtol {SOLVE_TOL['rtol']}, "
          f"atol {SOLVE_TOL['atol']})")
    del taps, tap, dp, offp, rp, A, x0, fused, rd, rr, r

    stamp("fused")

    # -- 7. capture and replay, sync and async (Fig 6b) -----------------
    a = dev_app                       # its regions are compiled already
    reset_launches()
    reset_plain()
    prog = a.capture_step(st)
    cnt = launches()
    check_plain("[async] capture")
    if min(cnt[k] for k in CFD_KERNELS) <= 0:
        raise AssertionError(f"capture did not launch the kernels: {cnt}")
    eager, _ = a.time_step(st)
    replayed, _ = a.replay_steps(prog, st, 1,
                                 Executor(UnifiedPolicy(selector=sel)))
    errs = {}
    for f in "uvwp":
        err, allowed = envelope_err(getattr(eager, f), getattr(replayed, f))
        errs[f] = err
        if not err <= allowed:
            raise AssertionError(f"unified replay leaves the eager step's "
                                 f"envelope in {f}: {err:.3e} > "
                                 f"{allowed:.3e}")
    print(f"[async] {prog.summary()}; captured with launches "
          f"{json.dumps(cnt)}; unified replay vs eager step max_abs_err "
          f"{errs}")
    # the discrete model: the state starts in pinned host memory
    st_pin = SimpleState(*tree_place([getattr(st, f) for f in "uvwp"],
                                     MemSpace.HOST), st.step)
    out = {}
    for mode in ("sync", "async", "async", "sync"):  # in turns
        pol = DiscretePolicy(selector=sel)
        ex = Executor(pol) if mode == "sync" else AsyncExecutor(pol)
        a.replay_steps(prog, st_pin, 1, ex)              # warm-up (pools)
        ex.ledger.reset_timings()
        reset_launches()
        reset_plain()
        s2, t2 = a.replay_steps(prog, st_pin, 2, ex)
        check_plain(f"[async] {mode} replay")
        cnt = launches()
        if min(cnt[k] for k in CFD_KERNELS) <= 0:
            raise AssertionError(f"{mode} replay did not launch the "
                                 f"kernels: {cnt}")
        rep_r = ex.report()
        out.setdefault(mode, []).append((s2, t2, rep_r))
        print(f"[async] discrete {mode} replay, 2 steps: {t2:.4f} s/step; "
              f"staging_fraction {rep_r['staging_fraction']:.4f} "
              f"({rep_r['staging_s']:.4f} s); overlap_fraction "
              f"{rep_r['overlap_fraction']:.4f} (overlap_s "
              f"{rep_r['overlap_s']:.4f}, staging_saved_s "
              f"{rep_r['staging_saved_s']:.4f}); launches {json.dumps(cnt)}")
    for s_a, _, rep_a in out["async"]:
        if not rep_a["overlap_fraction"] > 0:
            raise AssertionError("async replay hid no staging")
        for s_s, _, _ in out["sync"]:
            for f in "uvwp":
                if not torch.equal(getattr(s_a, f), getattr(s_s, f)):
                    raise AssertionError(f"async replay differs from sync "
                                         f"in {f}")
    print("[async] sync and async replays equal bit for bit")
    unbudgeted = {"discrete": out["sync"][0][0]}
    del dev_app, eager, replayed, out, ex, pol, s2, s_a, s_s

    stamp("async")

    # -- 7b. oversubscription: the captured step under a device budget --
    # fig_oversub's CFD leg at 200^3: the [async] step replayed under
    # discrete and adaptive (the [policies] cutoff) policies whose budget
    # makes the state 1, 2 and 4 times oversubscribed; a budget is logical
    # (nothing caps what CUDA allocates), so the card's own peak is read
    # beside the budget's high water
    fp = workload_bytes(st_pin)
    unbudgeted["adaptive"], _ = a.replay_steps(
        prog, st, 2, Executor(AdaptivePolicy(cutoff, selector=sel)))

    def oversub_policy(mode, budget=None):
        if mode == "discrete":
            return DiscretePolicy(selector=sel, budget=budget)
        return AdaptivePolicy(cutoff, selector=sel, budget=budget, device=dev)

    def oversub_run(mode, ratio, make_ex=Executor):
        """One warm-up step (pools), then 2 timed steps from the pinned
        state under a fresh budget of ``fp / ratio``: (state, FOM, budget,
        report, launches, card peak above the run's start, card peak)."""
        budget = MemoryBudget.for_ratio(fp, ratio, name="cfd")
        ex = make_ex(oversub_policy(mode, budget))
        a.replay_steps(prog, st_pin, 1, ex)
        ex.ledger.reset_timings()
        budget.stats = BudgetStats()          # nothing is charged between
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_plain()
        s_b, fom_b = a.replay_steps(prog, st_pin, 2, ex)
        check_plain(f"[oversub] {mode} ratio {ratio:g}")
        peak = torch.cuda.max_memory_allocated()
        return s_b, fom_b, budget, ex.report(), launches(), peak - base, peak

    oversub = {}
    for ratio in (1.0, 2.0, 4.0):
        for mode in ("discrete", "adaptive"):
            s_b, fom_b, budget, rep_b, cnt, above, peak = oversub_run(
                mode, ratio)
            bs = budget.stats
            print(f"[oversub] {mode} ratio {ratio:g} (limit "
                  f"{budget.limit_bytes / 1e6:.1f} MB of {fp / 1e6:.1f} MB, "
                  f"chunk {budget.staging_chunk_bytes() / 1e6:.1f} MB): FOM "
                  f"{fom_b:.4f} s/step; staging_fraction "
                  f"{rep_b['staging_fraction']:.4f}; staging_chunks "
                  f"{bs.staging_chunks}; pressure_events "
                  f"{bs.pressure_events}; budget high water "
                  f"{bs.high_water_bytes / 1e6:.1f} MB; "
                  f"torch.cuda.max_memory_allocated {peak / 1e6:.1f} MB "
                  f"({above / 1e6:.1f} MB above the run's start); launches "
                  f"{json.dumps(cnt)}")
            for f in "uvwp":     # host pages against card fields (adaptive)
                if not torch.equal(getattr(s_b, f).cpu(),
                                   getattr(unbudgeted[mode], f).cpu()):
                    raise AssertionError(f"{mode} replay at ratio {ratio:g} "
                                         f"differs from the unbudgeted one "
                                         f"in {f}")
            missing = [k for k in CFD_KERNELS if cnt[k] <= 0]
            if missing:
                raise AssertionError(f"[oversub] {mode} ratio {ratio:g}: "
                                     f"kernels {missing} never launched")
            if ratio == 4.0 and not (bs.staging_chunks > 0
                                     and bs.pressure_events > 0):
                raise AssertionError(f"[oversub] {mode} ratio 4: no chunks or "
                                     f"no pressure: {bs.as_dict()}")
            oversub[(mode, ratio)] = s_b
    s_b, fom_b, budget, rep_b, cnt, above, peak = oversub_run(
        "discrete", 4.0, AsyncExecutor)
    for f in "uvwp":
        if not torch.equal(getattr(s_b, f),
                           getattr(oversub[("discrete", 4.0)], f)):
            raise AssertionError(f"async budgeted replay differs from the "
                                 f"sync one in {f}")
    print(f"[oversub] discrete async ratio 4: FOM {fom_b:.4f} s/step; "
          f"staging_fraction {rep_b['staging_fraction']:.4f}; overlap_fraction"
          f" {rep_b['overlap_fraction']:.4f}; staging_chunks "
          f"{budget.stats.staging_chunks}; pressure_events "
          f"{budget.stats.pressure_events}; budget high water "
          f"{budget.stats.high_water_bytes / 1e6:.1f} MB; "
          f"torch.cuda.max_memory_allocated {peak / 1e6:.1f} MB "
          f"({above / 1e6:.1f} MB above the run's start); equal bit for bit "
          f"to the sync budgeted replay and to the unbudgeted one")
    print("[oversub] every budgeted replay (ratios 1, 2, 4; discrete and "
          "adaptive; sync and async) equals its unbudgeted replay bit for bit")

    # a region whose two grid operands carry DEVICE hints, under a budget
    # that admits the field and not the 6-field stack: the stack is demoted
    # to pinned host memory and migrates in for the call, booked as staging
    hinted_ledger = Ledger("hinted")

    @region("hinted_weighted_sum", ledger=hinted_ledger,
            placement={0: MemSpace.DEVICE, 1: MemSpace.DEVICE})
    def hinted(d, off):
        return d * off.sum(0)
    d_h, off_h = rand(N, N, N), rand(6, N, N, N)
    want_h = Executor(UnifiedPolicy(), Ledger("unhinted")).run(hinted, d_h,
                                                              off_h)
    budget = MemoryBudget(2 * d_h.numel() * d_h.element_size(), name="hint")
    ex = Executor(UnifiedPolicy(placer=BudgetedPlacer(budget=budget,
                                                      device=dev)),
                  Ledger("hinted_run"))
    reset_plain()
    got_h = ex.run(hinted, d_h, off_h)
    check_plain("[oversub] BudgetedPlacer")
    row = ex.ledger.regions["hinted_weighted_sum"]
    print(f"[oversub] BudgetedPlacer: DEVICE hints on a {N}^3 field "
          f"({d_h.numel() * 4 / 1e6:.1f} MB) and its 6-field stack "
          f"({off_h.numel() * 4 / 1e6:.1f} MB) under a "
          f"{budget.limit_bytes / 1e6:.1f} MB budget: admitted "
          f"{budget.stats.admitted}, denied {budget.stats.denials}; the "
          f"demoted stack migrated in for the call: staging_bytes "
          f"{row.staging_bytes / 1e6:.1f} MB in {row.staging_s * 1e3:.2f} ms;"
          f" device_calls {row.device_calls}; result equal to the unhinted "
          f"run: {torch.equal(got_h, want_h)}")
    if not (torch.equal(got_h, want_h) and got_h.is_cuda
            and row.staging_bytes == off_h.numel() * off_h.element_size()
            and row.device_calls == 1 and budget.stats.denials == 1):
        raise AssertionError("the demoted operand was not migrated in, or "
                             "the result changed")
    del a, prog, st_pin, unbudgeted, oversub, s_b, budget, ex, d_h, off_h, \
        want_h, got_h, hinted

    stamp("oversub")

    # -- 8. serve rwkv6-7b at full width -------------------------------
    del app, outs, st
    scfg = dataclasses.replace(scfg, n_layers=SERVE["layers"])
    SG, SGD = SERVE["gen"], SERVE["gen_discrete"]
    gs = torch.Generator(device=dev).manual_seed(args.seed)
    before_serve = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init(gs, scfg, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    prompts = torch.randint(0, scfg.vocab, (SB, SP), generator=gs,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    print(f"[serve] rwkv6-7b, {scfg.n_layers} layers, d_model "
          f"{scfg.d_model}, {scfg.n_heads}x{scfg.hd} heads, d_ff {scfg.d_ff}, "
          f"vocab {scfg.vocab}, {scfg.compute_dtype}; "
          f"{param_count(T.param_specs(scfg))} params, {w_bytes / 1e9:.2f} GB"
          f" on the card, random init in {t_init:.1f} s; "
          f"{before_serve / 1e9:.2f} GB allocated before the serve phase")

    def serve_programs(policy, gen_n, regions=None):
        """Executor, regions (new ones unless given) and both captured
        programs, each replayed once as a warm-up (capture runs the
        policy's variants)."""
        ex = Executor(policy, Ledger("serve"))
        if regions is None:
            regions = SV.make_serve_regions(scfg, params, ledger=ex.ledger)
        pprog = SV.capture_prefill_program(regions, batch,
                                           T.init_cache(scfg, SB, dev),
                                           selector=policy.selector)
        tok, cache = pprog.replay(ex, batch, T.init_cache(scfg, SB, dev))
        # capture runs the regions eagerly: its examples live on the card
        dprog = SV.capture_decode_program(
            regions, SP, gen_n, *tree_place((tok, cache), MemSpace.DEVICE,
                                            dev), selector=policy.selector)
        dprog.replay(ex, tok, cache)
        ex.ledger.reset_timings()
        return ex, regions, pprog, dprog

    def serve_run(ex, pprog, dprog):
        """One request batch: (tokens [B, gen] on the host, prefill s,
        decode s)."""
        t0 = time.perf_counter()
        tok, cache = pprog.replay(ex, batch, T.init_cache(scfg, SB, dev))
        t1 = time.perf_counter()
        toks = dprog.replay(ex, tok, cache)
        t2 = time.perf_counter()
        return torch.stack([t.cpu() for t in toks], 1), t1 - t0, t2 - t1

    with_weights = torch.cuda.memory_allocated()
    reset_plain()
    n0 = len(REGIONS)
    ex, regions, pprog, dprog = serve_programs(
        UnifiedPolicy(selector=StaticSelector("hopper")), SG)
    serve_regions = REGIONS[n0:]
    held = torch.cuda.memory_allocated()
    warm = compiles_of(REGIONS)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seq, t_pre, t_dec = serve_run(ex, pprog, dprog)
    serve_counts = launches()
    check_plain("[serve] capture and replay")
    if compiles_of(REGIONS) != warm:
        raise AssertionError("[serve]: a region recompiled after its warm-up")
    peak = torch.cuda.max_memory_allocated()
    impl_prefill = ex.ledger.regions["PREFILL"].impl_counts
    rows = ex.ledger.regions.values()
    print(f"[compile] [serve] full width, per region: first call (trace, "
          f"compile, run) and graphs kept: " + compile_rows(serve_regions)
          + "; per layer kind (its first call inside the first step): "
          + layer_rows())
    print(f"[serve] unified/hopper {SB}x{SP} prompt, {SG} tokens, compiled: "
          f"prefill {t_pre * 1e3:.1f} ms ({SB * SP / t_pre:.0f} prompt "
          f"tok/s); decode {SG - 1} steps in {t_dec * 1e3:.1f} ms "
          f"({SB * (SG - 1) / t_dec:.1f} tok/s, "
          f"{t_dec / (SG - 1) * 1e3:.2f} ms/step); peak device memory "
          f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held before the run, "
          f"{(held - with_weights) / 1e9:.2f} GB of it by the captured "
          f"programs); "
          f"launches {json.dumps(serve_counts)}; PREFILL impl_counts "
          f"{impl_prefill}; region compute_s: " + "; ".join(
              f"{r.name} {r.compute_s:.4f} ({r.calls} calls)" for r in rows))
    if serve_counts["rwkv6_scan"] != scfg.n_layers:
        raise AssertionError(f"K5 launched {serve_counts['rwkv6_scan']} "
                             f"times in one prefill, not once per layer "
                             f"({scfg.n_layers})")
    if impl_prefill != {"hopper": 1}:
        raise AssertionError(f"PREFILL ran {impl_prefill}, not hopper")
    records["rwkv6_scan"]["launches"] = serve_counts["rwkv6_scan"]

    # the same run eagerly (disable_compile), beside it
    with disable_compile():
        ex_e, _, pprog_e, dprog_e = serve_programs(
            UnifiedPolicy(selector=StaticSelector("hopper")), SG)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        seq_e, te_pre, te_dec = serve_run(ex_e, pprog_e, dprog_e)
        peak_e = torch.cuda.max_memory_allocated()
    if launches()["rwkv6_scan"] != scfg.n_layers:
        raise AssertionError("the eager prefill did not launch K5 once per "
                             "layer")
    print(f"[serve] unified/hopper {SB}x{SP} prompt, {SG} tokens, eager: "
          f"prefill {te_pre * 1e3:.1f} ms; decode {SG - 1} steps in "
          f"{te_dec * 1e3:.1f} ms ({SB * (SG - 1) / te_dec:.1f} tok/s, "
          f"{te_dec / (SG - 1) * 1e3:.2f} ms/step); peak device memory "
          f"{peak_e / 1e9:.2f} GB; K5 launches equal to the compiled run's; "
          f"tokens agree with the compiled run's in "
          f"{(seq_e == seq).float().mean().item():.3f} of places, the first "
          f"decoded token in {(seq_e[:, 1] == seq[:, 1]).float().mean():.2f}"
          f" of rows; first differing step of each row "
          f"{first_diff(seq_e, seq)} (a greedy row follows its own tokens "
          f"after one flip)")
    del ex_e, pprog_e, dprog_e, seq_e

    # the uncaptured path, compiled: the replay's tokens; peak memory of
    # its decode with the cache donated and without
    prefill_h, decode, make_cache = SV.build_server(scfg, SB, dev,
                                                    rwkv_impl="hopper")
    # the same decode step without donation: the DECODE_STEP region's
    # compiled executable (the function build_server's decode compiles),
    # called outside any program
    step_kept = regions.decode_step.executable("default")

    def decode_kept(params_, tok_, cache_, pos_):
        return step_kept(tok_, cache_, pos_)

    reset_plain()
    dec_peak = {}
    for how, dec in (("donated", decode), ("kept", decode_kept),
                     ("donated", decode), ("kept", decode_kept)):
        lh, ch = prefill_h(params, batch, make_cache())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        toks_j, cache_end = SV.decode_stream(dec, params, SV.greedy(lh), ch,
                                             SP, SG)
        dec_peak[how] = (torch.cuda.max_memory_allocated() - base,
                         torch.cuda.max_memory_allocated())
        if not torch.equal(seq, torch.stack([t.cpu() for t in toks_j], 1)):
            raise AssertionError(f"replayed tokens differ from the uncaptured "
                                 f"path's ({how} cache)")
        del lh, ch
    check_plain("[serve] uncaptured")
    print(f"[serve] uncaptured path, compiled: tokens equal to the replay's; "
          f"decode of {SG - 1} steps, peak above the prefilled state: "
          f"donated cache {dec_peak['donated'][0] / 1e9:.3f} GB (peak "
          f"{dec_peak['donated'][1] / 1e9:.2f} GB), cache kept "
          f"{dec_peak['kept'][0] / 1e9:.3f} GB (peak "
          f"{dec_peak['kept'][1] / 1e9:.2f} GB); [compile] prefill "
          f"{prefill_h.stats.first_call_s:.2f} s, decode donated "
          f"{decode.stats.first_call_s:.2f} s")
    if dec_peak["donated"][0] > dec_peak["kept"][0]:
        raise AssertionError("the donated decode raised peak memory")
    # one more step's logits from the kept decode's last state
    ld, _ = T.decode_step(params, toks_j[-1], cache_end, SP + SG - 1, scfg,
                          T.Ctx())
    del decode_kept, step_kept, toks_j

    # the compiled prefill and one compiled decode step (logits) against the
    # same functions run eagerly below, on the same inputs
    lc, cc = prefill_h(params, batch, make_cache())
    decode_logits = compile_region_fn(train_step.make_decode_step(scfg),
                                      "decode_logits")
    tok_c = SV.greedy(lc)
    ldc, _ = decode_logits(params, tok_c, cc, SV.position(SP))

    # hopper prefill against ref prefill, eagerly as before compiling
    with disable_compile():
        prefill_he, _, make_cache_e = SV.build_server(scfg, SB, dev,
                                                      rwkv_impl="hopper")
        prefill_r, _, _ = SV.build_server(scfg, SB, dev)
        pre_s = {}
        for impl, step in (("hopper", prefill_he), ("ref", prefill_r)):
            t0 = time.perf_counter()
            pre_s[impl] = (*step(params, batch, make_cache_e()),)
            torch.cuda.synchronize()
            pre_s[impl] += (time.perf_counter() - t0,)
        lde, _ = train_step.make_decode_step(scfg)(params, tok_c, cc,
                                                   SV.position(SP))
    (lh, ch, th), (lr, cr, tr) = pre_s["hopper"], pre_s["ref"]
    s_ce, l_ce = rel_errs(lc, cc, lh, ch)
    d_ce = ((ldc.float() - lde.float()).abs().max()
            / lde.float().abs().max()).item()
    print(f"[serve] compiled vs eager, same inputs: hopper prefill max "
          f"|dS| / max|S| over layers {max(s_ce):.3e} (layer 0 "
          f"{s_ce[0]:.3e}), max |dlogit| / max|logit| {l_ce:.3e}, first-token "
          f"agreement {(SV.greedy(lc) == SV.greedy(lh)).float().mean():.2f}; "
          f"one decode step from the compiled prefill's state: max |dlogit| "
          f"/ max|logit| {d_ce:.3e}, token agreement "
          f"{(SV.greedy(ldc) == SV.greedy(lde)).float().mean():.2f} "
          f"(limit {PREFILL_TOL})")
    if not (max(s_ce) <= PREFILL_TOL and l_ce <= PREFILL_TOL
            and d_ce <= PREFILL_TOL):
        raise AssertionError("the compiled serve steps leave the eager "
                             "steps' envelope")
    for what, lg in (("hopper prefill", lh), ("ref prefill", lr),
                     ("decode", ld), ("compiled decode", ldc)):
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{what} logits are not finite")
    s_rel, l_rel = rel_errs(lh, ch, lr, cr)
    agree = (SV.greedy(lh) == SV.greedy(lr)).float().mean().item()
    print(f"[serve] hopper prefill {th * 1e3:.1f} ms vs ref (rwkv_chunk) "
          f"{tr * 1e3:.1f} ms, eager; max |dS| / max|S| over layers "
          f"{max(s_rel):.3e} (layer 0, whose scan inputs are equal on both "
          f"sides: {s_rel[0]:.3e}, limit {SCAN_ON_MODEL_TOL}), max |dlogit| /"
          f" max|logit| {l_rel:.3e} (limit {PREFILL_TOL}); first-token "
          f"agreement {agree:.2f}; logits finite")
    if not s_rel[0] <= SCAN_ON_MODEL_TOL:
        raise AssertionError("K5 leaves rwkv_chunk on layer 0's inputs")
    if not (max(s_rel) <= PREFILL_TOL and l_rel <= PREFILL_TOL):
        raise AssertionError("hopper prefill leaves the ref envelope")
    del lh, ch, lr, cr, pre_s, cache_end, ld, prefill_he, prefill_r, lc, \
        cc, ldc, lde, decode_logits

    # the discrete policy: every offloaded region stages the state; the
    # unified run's regions (and compiled executables) serve it
    reset_plain()
    exd, _, pprog_d, dprog_d = serve_programs(
        DiscretePolicy(selector=StaticSelector("hopper")), SGD,
        regions=regions)
    seq_d, td_pre, td_dec = serve_run(exd, pprog_d, dprog_d)
    check_plain("[serve] discrete")
    if not torch.equal(seq_d, seq[:, :SGD]):
        raise AssertionError("discrete tokens differ from the unified run's")
    rep_sd = exd.report()
    staged_sd = sum(r.staging_bytes for r in exd.ledger.regions.values())
    print(f"[serve] discrete/hopper {SGD} tokens: tokens equal to the "
          f"unified run's; prefill {td_pre * 1e3:.1f} ms; decode "
          f"{SGD - 1} steps in {td_dec * 1e3:.1f} ms "
          f"({SB * (SGD - 1) / td_dec:.1f} tok/s); staging_fraction "
          f"{rep_sd['staging_fraction']:.4f} ({rep_sd['staging_s']:.4f} s, "
          f"{staged_sd / 1e9:.3f} GB)")
    del exd, pprog_d, dprog_d, dprog

    stamp("serve")

    # -- 9. replay_batch: decode over request groups, and a CFD solve ---
    # the serve phase's regions and compiled prefill; under vmap each layer
    # op runs once per group, at the solo replay's shapes
    reset_plain()
    lg0, cache0 = prefill_h(params, batch, make_cache())
    dprog_b = SV.capture_decode_program(regions, SP, BATCH_GEN,
                                        SV.greedy(lg0), cache0,
                                        selector=ex.policy.selector)
    del lg0, cache0
    groups = types.SimpleNamespace(seed=args.seed, batch=SB, prompt_len=SP,
                                   gen=BATCH_GEN)
    SV.replay_request_groups(scfg, ex, dprog_b, prefill_h, make_cache,
                             params, groups, 2, dev)            # compiles
    seqs_b, solo_b, t_b = SV.replay_request_groups(
        scfg, ex, dprog_b, prefill_h, make_cache, params, groups, 2, dev)
    check_plain("[batch] decode")
    batched_fn = next(iter(dprog_b._batched.values()))
    n_tok = 2 * SB * BATCH_GEN
    print(f"[batch] decode program of rwkv6-7b ({scfg.n_layers} layers, "
          f"{BATCH_GEN} tokens, {len(dprog_b)} ops) over 2 request groups "
          f"of {SB}: {n_tok} tokens in "
          f"{t_b * 1e3:.1f} ms ({n_tok / t_b:.0f} tok/s) after a first call "
          f"of {batched_fn.stats.first_call_s:.1f} s (trace, compile, run; "
          f"{batched_fn.stats.compiles} compiled); against each group's solo "
          f"replay: tokens agree in {(seqs_b == solo_b).float().mean():.3f}"
          f" of places, the first decoded token in "
          f"{(seqs_b[..., 1] == solo_b[..., 1]).float().mean():.2f} of rows "
          f"(must be 1); first differing step of each row "
          f"{first_diff(seqs_b.flatten(0, 1), solo_b.flatten(0, 1))}")
    if seqs_b.shape != (2, SB, BATCH_GEN) or \
            not ((seqs_b >= 0) & (seqs_b < scfg.vocab)).all():
        raise AssertionError(f"replay_batch tokens out of range: {seqs_b}")
    if not torch.equal(seqs_b[..., :2], solo_b[..., :2]):
        raise AssertionError("replay_batch's first decoded tokens differ "
                             "from the solo replays'")
    del ex, regions, pprog, prefill_h, decode, make_cache, seqs_b, solo_b, \
        dprog_b

    # a captured PBiCGStab solve (K1-K4 through the hopper variants) on
    # the Laplacian at 200^3, replayed over 2 right-hand sides
    A_b, _ = fvm.laplacian(Grid((N, N, N)), 1.0)
    A_b = DiaMatrix(A_b.diag + 0.5, A_b.off)
    P_b = rb_dilu_factor(A_b, grid.red_black_masks()[0])
    solver = make_solver_regions(Ledger("batch"))

    def solve_fn(run, b, x0):
        return pbicgstab_regions(types.SimpleNamespace(run=run), solver, A_b,
                                 b, x0, P_b, tol=0.0, max_iter=3).x

    rhs = torch.rand((2, N, N, N), generator=g, device=dev)
    x0s = torch.zeros_like(rhs)
    prog_s = capture(solve_fn, rhs[0], x0s[0], name="solve", selector=sel)
    ex_s = Executor(UnifiedPolicy(selector=sel))
    solo_s = torch.stack([prog_s.replay(ex_s, rhs[i], x0s[i])
                          for i in range(2)])
    prog_s.replay_batch(rhs, x0s, executor=ex_s, selector=sel)   # compiles
    reset_plain()
    reset_launches()
    t0 = time.perf_counter()
    got_s = prog_s.replay_batch(rhs, x0s, executor=ex_s, selector=sel)
    t_s = time.perf_counter() - t0
    cnt_b = launches()
    check_plain("[batch] solve")
    err, allowed = envelope_err(solo_s, got_s)
    solve_fn_c = next(iter(prog_s._batched.values()))
    print(f"[batch] PBiCGStab solve ({len(prog_s)} ops, 3 iterations) on the "
          f"{N}^3 Laplacian over 2 right-hand sides: "
          f"{t_s * 1e3:.2f} ms (first call {solve_fn_c.stats.first_call_s:.1f}"
          f" s); vs "
          f"solo replays max_abs_err {err:.3e} (allowed {allowed:.3e}); "
          f"launches {json.dumps(cnt_b)}")
    if not err <= allowed:
        raise AssertionError("replay_batch of the solve leaves the envelope")
    if min(cnt_b[k] for k in CFD_KERNELS) <= 0:
        raise AssertionError(f"replay_batch did not launch K1-K4: {cnt_b}")
    del A_b, P_b, solver, rhs, x0s, prog_s, ex_s, solo_s, got_s

    # all 32 layers, random bf16 weights from --seed widened to f32, with
    # f32 activations: hopper vs ref prefill, so that only f32 rounding
    # separates them (eagerly, as before compiling: Inductor's fusions would
    # add their own rounding); no compile, so the depth costs little here
    del params
    cfg32 = dataclasses.replace(get_config("rwkv6-7b"),
                                param_dtype="float32",
                                compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), T.init(
        torch.Generator(device=dev).manual_seed(args.seed),
        get_config("rwkv6-7b"), dev))
    pre32 = {}
    with disable_compile():
        for impl in ("hopper", None):
            step, _, mk = SV.build_server(cfg32, SB, dev, rwkv_impl=impl)
            t0 = time.perf_counter()
            pre32[impl] = (*step(params32, batch, mk()),)
            torch.cuda.synchronize()
            pre32[impl] += (time.perf_counter() - t0,)
    (lh, ch, th), (lr, cr, tr) = pre32["hopper"], pre32[None]
    s_rel, l_rel = rel_errs(lh, ch, lr, cr)
    print(f"[serve] f32 weights and activations, {cfg32.n_layers} layers: "
          f"hopper prefill "
          f"{th * 1e3:.1f} ms vs ref {tr * 1e3:.1f} ms; max |dS| / max|S| "
          f"over layers {max(s_rel):.3e} (layer 0: {s_rel[0]:.3e}), max "
          f"|dlogit| / max|logit| {l_rel:.3e} (limit {F32_PREFILL_TOL})")
    if not (max(s_rel) <= F32_PREFILL_TOL and l_rel <= F32_PREFILL_TOL):
        raise AssertionError("f32 hopper prefill leaves the ref envelope")
    del params32, pre32, lh, ch, lr, cr

    stamp("batch")

    # -- 10. serve attention: tinyllama-1.1b, qwen2.5-32b ---------------
    AB, AP, AG = SERVE_ATTN["batch"], SERVE_ATTN["prompt_len"], \
        SERVE_ATTN["gen"]

    def attn_model(arch, n_layers=None, keep=None):
        """(cfg, random params from --seed on the card, prompts).  With
        ``keep`` the model is drawn at ``n_layers`` and its first ``keep``
        layers kept: the init's scale is 1/sqrt(layers) (the reference's
        law for stacked weights), so a model cut this way keeps the deep
        model's weights, and with them the compiled-vs-eager envelopes
        measured at that depth."""
        cfg_a = get_config(arch)
        if n_layers is not None:
            cfg_a = dataclasses.replace(cfg_a, n_layers=n_layers)
        ga = torch.Generator(device=dev).manual_seed(args.seed)
        t0 = time.perf_counter()
        p_a = T.init(ga, cfg_a, dev)
        if keep is not None:
            cfg_a = dataclasses.replace(cfg_a, n_layers=keep)
            p_a["layers"] = p_a["layers"][:keep]
        torch.cuda.synchronize()
        t_init_a = time.perf_counter() - t0
        prompts_a = torch.randint(0, cfg_a.vocab, (AB, AP), generator=ga,
                                  device=dev, dtype=torch.int32)
        n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(p_a))
        print(f"[serve-attn] {arch}: {cfg_a.n_layers} layers, d_model "
              f"{cfg_a.d_model}, {cfg_a.n_heads} query / {cfg_a.n_kv_heads} "
              f"kv heads of {cfg_a.hd}, d_ff {cfg_a.d_ff}, vocab "
              f"{cfg_a.vocab}, rope_theta {cfg_a.rope_theta:g}, tied "
              f"embeddings {cfg_a.tie_embeddings}, {cfg_a.compute_dtype}; "
              f"{param_count(T.param_specs(cfg_a))} params, "
              f"{n_bytes / 1e9:.2f} GB on the card, random init in "
              f"{t_init_a:.1f} s")
        return cfg_a, p_a, {"tokens": prompts_a}

    def attn_serve(cfg_a, p_a, batch_a, gen_n):
        """Both programs captured under unified/hopper and replayed once as
        a warm-up, then one timed request batch: (tokens [B, gen] on the
        host, prefill s, decode s, peak bytes, regions, compiles before
        the timed run)."""
        slots = AP + gen_n
        ex_a = Executor(UnifiedPolicy(selector=StaticSelector("hopper")),
                        Ledger("serve_attn"))
        n0 = len(REGIONS)
        regions_a = SV.make_serve_regions(cfg_a, p_a, ledger=ex_a.ledger)
        pprog_a = SV.capture_prefill_program(
            regions_a, batch_a, T.init_cache(cfg_a, AB, dev, slots),
            selector=ex_a.policy.selector)
        tok_a, cache_a = pprog_a.replay(ex_a, batch_a,
                                        T.init_cache(cfg_a, AB, dev, slots))
        dprog_a = SV.capture_decode_program(
            regions_a, AP, gen_n, *tree_place((tok_a, cache_a),
                                              MemSpace.DEVICE, dev),
            selector=ex_a.policy.selector)
        dprog_a.replay(ex_a, tok_a, cache_a)
        del tok_a, cache_a
        warm_a = compiles_of(REGIONS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tok_a, cache_a = pprog_a.replay(ex_a, batch_a,
                                        T.init_cache(cfg_a, AB, dev, slots))
        t1 = time.perf_counter()
        toks_a = dprog_a.replay(ex_a, tok_a, cache_a)
        t2 = time.perf_counter()
        seq_a = torch.stack([t.cpu() for t in toks_a], 1)
        return (seq_a, t1 - t0, t2 - t1, torch.cuda.max_memory_allocated(),
                REGIONS[n0:], warm_a)

    def attn_oracle(cfg_a, p_a, batch_a, gen_n, seq_a):
        """The uncaptured path, compiled: its tokens must equal the
        replay's.  Returns its (prefill, make_cache)."""
        pre_a, dec_a, mk_a = SV.build_server(cfg_a, AB, dev,
                                             max_len=AP + gen_n)
        lg, ca = pre_a(p_a, batch_a, mk_a())
        toks_o, _ = SV.decode_stream(dec_a, p_a, SV.greedy(lg), ca, AP,
                                     gen_n)
        if not torch.equal(seq_a, torch.stack([t.cpu() for t in toks_o], 1)):
            raise AssertionError(f"{cfg_a.name}: replayed tokens differ from "
                                 f"the uncaptured path's")
        return pre_a, mk_a

    def attn_rel(got, want):
        """max |got - want| / max(1, max |want|)."""
        got, want = got.float(), want.float()
        return ((got - want).abs().max()
                / max(1.0, want.abs().max().item())).item()

    def attn_compiled_vs_eager(cfg_a, p_a, batch_a, pre_a, mk_a, tol):
        """The compiled prefill (logits, every layer's k and v) and one
        compiled decode step's logits against the same functions run
        eagerly on the same inputs, each as max |d| / max(1, max|x|);
        the logits within ``tol["logits"]``, k and v within
        ``tol["kv"]``."""
        lc, cc = pre_a(p_a, batch_a, mk_a())
        dec_logits = compile_region_fn(train_step.make_decode_step(cfg_a),
                                       f"decode_logits_{cfg_a.name}")
        tok_c = SV.greedy(lc)
        ldc, _ = dec_logits(p_a, tok_c, cc, SV.position(AP))
        with disable_compile():
            pre_e, _, mk_e = SV.build_server(cfg_a, AB, dev,
                                             max_len=AP + AG)
            le, ce = pre_e(p_a, batch_a, mk_e())
            lde, _ = train_step.make_decode_step(cfg_a)(p_a, tok_c, cc,
                                                       SV.position(AP))
        kv = [max(attn_rel(a[k], b[k]) for k in "kv")
              for a, b in zip(cc, ce)]
        kv0 = {k: attn_rel(cc[0][k], ce[0][k]) for k in "kv"}
        errs = dict(prefill_logits=attn_rel(lc, le), kv=max(kv),
                    decode_logits=attn_rel(ldc, lde))
        for what, lg in (("compiled prefill", lc), ("eager prefill", le),
                         ("compiled decode", ldc), ("eager decode", lde)):
            if not torch.isfinite(lg).all():
                raise AssertionError(f"{cfg_a.name} {what} logits are not "
                                     f"finite")
        agree = (SV.greedy(lc) == SV.greedy(le)).float().mean().item()
        print(f"[serve-attn] {cfg_a.name} {cfg_a.compute_dtype} compiled vs "
              f"eager, same inputs (max |d| / max(1, max|x|)): prefill "
              f"logits {errs['prefill_logits']:.3e}, k/v over layers "
              f"{errs['kv']:.3e} (by layer: "
              + ", ".join(f"{e:.1e}" for e in kv) + f"; layer 0 k "
              f"{kv0['k']:.1e}, v {kv0['v']:.1e}), one decode step's "
              f"logits {errs['decode_logits']:.3e} (limits {tol}); "
              f"first-token agreement {agree:.2f}")
        return errs

    def attn_layers_alone(cfg_a, p_a, batch_a, mk_a):
        """Each compiled prefill layer (its layer op, compiled) against the
        same layer run eagerly, both fed the eager run's input to that
        layer: per layer, the worst max |d| / max(1, max|x|) over the
        layer's output and its k, v."""
        op = T.layer_fns(cfg_a, SV.prefill_ctx())[("attn", "dense")]
        # the f32 stream a layer op takes (the embedding, a carry)
        x = embed(p_a["embed"], batch_a["tokens"], cfg_a).float()
        worst = []
        # grad mode off, as inside a compiled step (the layer's guards)
        with torch.no_grad():
            for layer, c in zip(p_a["layers"], mk_a()):
                args = (T._leaves(layer), x, [c[k] for k in op._cache_keys],
                        None)
                got = op.op(*args)
                with disable_compile():
                    want = op.op(*args)
                worst.append(max(attn_rel(g, w) for g, w in zip(got, want)))
                x = want[0]
        return worst

    def attn_envelope(cfg_a, p_a, batch_a, mk_a, errs):
        """Hold one dtype's whole-model errors and each layer alone to
        their envelopes."""
        dt = cfg_a.compute_dtype
        alone = attn_layers_alone(cfg_a, p_a, batch_a, mk_a)
        tol = ATTN_MODEL_TOL[dt]
        tol_layer = ATTN_LAYER_TOL if dt == "float32" else "not held"
        print(f"[serve-attn] {cfg_a.name} {dt}: each compiled prefill layer "
              f"against the eager layer on the eager layer's input, max |d| "
              f"/ max(1, max|x|): {max(alone):.3e} (by layer: "
              + ", ".join(f"{e:.1e}" for e in alone) + f"; limit "
              f"{tol_layer}); whole model limits {tol}")
        if dt == "float32" and not max(alone) <= tol_layer:
            raise AssertionError(f"{cfg_a.name} {dt}: a compiled layer leaves "
                                 f"the eager layer's envelope: {alone}")
        if not (errs["prefill_logits"] <= tol["logits"]
                and errs["decode_logits"] <= tol["logits"]
                and errs["kv"] <= tol["kv"]):
            raise AssertionError(f"{cfg_a.name} {dt}: the compiled steps leave"
                                 f" the eager steps' envelope {tol}: {errs}")

    def attn_ops_compiled_once():
        ops = [op for op in T.LAYER_OPS.values()
               if op.label.startswith("layer_attn") and op.stats.calls]
        if not ops or any(op.stats.compiles != 1 for op in ops):
            raise AssertionError("an attention layer kind compiled more than "
                                 "once: " + "; ".join(
                                     f"{op.label} {op.stats.compiles}"
                                     for op in ops))

    # tinyllama-1.1b at full width, compiled, eagerly beside it
    acfg, aparams, abatch = attn_model("tinyllama-1.1b",
                                       keep=SERVE_ATTN["tinyllama_layers"])
    reset_plain()
    seq_a, ta_pre, ta_dec, peak_a, attn_regions, warm_a = attn_serve(
        acfg, aparams, abatch, AG)
    check_plain("[serve-attn] capture and replay")
    if compiles_of(REGIONS) != warm_a:
        raise AssertionError("[serve-attn]: a region recompiled after its "
                             "warm-up")
    attn_ops_compiled_once()
    print(f"[compile] [serve-attn] tinyllama-1.1b, per region: first call "
          f"(trace, compile, run) and graphs kept: "
          + compile_rows(attn_regions) + "; per layer kind: " + "; ".join(
              f"{op.label} {op.stats.first_call_s:.2f} s "
              f"({op.stats.compiles} compiled)" for op in T.LAYER_OPS.values()
              if op.label.startswith("layer_attn") and op.stats.calls))
    print(f"[serve-attn] tinyllama-1.1b unified {AB}x{AP} prompt, {AG} "
          f"tokens, compiled: prefill {ta_pre * 1e3:.1f} ms "
          f"({AB * AP / ta_pre:.0f} prompt tok/s); decode {AG - 1} steps in "
          f"{ta_dec * 1e3:.1f} ms ({AB * (AG - 1) / ta_dec:.1f} tok/s, "
          f"{ta_dec / (AG - 1) * 1e3:.2f} ms/step); peak device memory "
          f"{peak_a / 1e9:.2f} GB")
    with disable_compile():
        seq_ae, tae_pre, tae_dec, peak_ae, _, _ = attn_serve(
            acfg, aparams, abatch, AG)
    print(f"[serve-attn] tinyllama-1.1b eager: prefill {tae_pre * 1e3:.1f} "
          f"ms; decode {AG - 1} steps in {tae_dec * 1e3:.1f} ms "
          f"({tae_dec / (AG - 1) * 1e3:.2f} ms/step); peak device memory "
          f"{peak_ae / 1e9:.2f} GB; tokens agree with the compiled run's in "
          f"{(seq_ae == seq_a).float().mean().item():.3f} of places, first "
          f"differing step of each row {first_diff(seq_ae, seq_a)}")
    reset_plain()
    pre_a, mk_a = attn_oracle(acfg, aparams, abatch, AG, seq_a)
    print(f"[serve-attn] tinyllama-1.1b uncaptured path, compiled: tokens "
          f"equal to the replay's; [compile] prefill "
          f"{pre_a.stats.first_call_s:.2f} s")
    errs_bf16 = attn_compiled_vs_eager(acfg, aparams, abatch, pre_a, mk_a,
                                       ATTN_MODEL_TOL["bfloat16"])
    attn_envelope(acfg, aparams, abatch, mk_a, errs_bf16)
    check_plain("[serve-attn] tinyllama-1.1b")
    acfg32 = dataclasses.replace(acfg, param_dtype="float32",
                                 compute_dtype="float32")
    aparams32 = tree_map(lambda t: t.float(), aparams)
    del aparams, pre_a, mk_a
    pre32, _, mk32 = SV.build_server(acfg32, AB, dev, max_len=AP + AG)
    errs_f32 = attn_compiled_vs_eager(acfg32, aparams32, abatch, pre32, mk32,
                                      ATTN_MODEL_TOL["float32"])
    attn_envelope(acfg32, aparams32, abatch, mk32, errs_f32)
    del aparams32, pre32, mk32

    # llama3.2-3b at full width (tied embeddings, rope_theta 500000)
    lcfg, lparams, lbatch = attn_model("llama3.2-3b",
                                       SERVE_ATTN["llama_layers"])
    reset_plain()
    seq_l, tl_pre, tl_dec, peak_l, _, warm_l = attn_serve(
        lcfg, lparams, lbatch, SERVE_ATTN["llama_gen"])
    if compiles_of(REGIONS) != warm_l:
        raise AssertionError("[serve-attn] llama3.2-3b: a region recompiled "
                             "after its warm-up")
    attn_oracle(lcfg, lparams, lbatch, SERVE_ATTN["llama_gen"], seq_l)
    check_plain("[serve-attn] llama3.2-3b")
    attn_ops_compiled_once()
    print(f"[serve-attn] llama3.2-3b unified {AB}x{AP} prompt, "
          f"{SERVE_ATTN['llama_gen']} tokens, compiled: prefill "
          f"{tl_pre * 1e3:.1f} ms; decode {SERVE_ATTN['llama_gen'] - 1} steps "
          f"in {tl_dec * 1e3:.1f} ms "
          f"({tl_dec / (SERVE_ATTN['llama_gen'] - 1) * 1e3:.2f} ms/step); "
          f"peak device memory {peak_l / 1e9:.2f} GB; tokens equal to the "
          f"uncaptured path's; each attention layer kind compiled once")
    del lparams

    # qwen2.5-32b at full width (QKV bias, untied head, rope_theta 1e6)
    qcfg, qparams, qbatch = attn_model("qwen2.5-32b",
                                       SERVE_ATTN["qwen_layers"])
    reset_plain()
    seq_q, tq_pre, tq_dec, peak_q, _, warm_q = attn_serve(
        qcfg, qparams, qbatch, SERVE_ATTN["llama_gen"])
    if compiles_of(REGIONS) != warm_q:
        raise AssertionError("[serve-attn] qwen2.5-32b: a region recompiled "
                             "after its warm-up")
    attn_oracle(qcfg, qparams, qbatch, SERVE_ATTN["llama_gen"], seq_q)
    check_plain("[serve-attn] qwen2.5-32b")
    attn_ops_compiled_once()
    print(f"[serve-attn] qwen2.5-32b unified {AB}x{AP} prompt, "
          f"{SERVE_ATTN['llama_gen']} tokens, compiled: prefill "
          f"{tq_pre * 1e3:.1f} ms; decode {SERVE_ATTN['llama_gen'] - 1} steps "
          f"in {tq_dec * 1e3:.1f} ms "
          f"({tq_dec / (SERVE_ATTN['llama_gen'] - 1) * 1e3:.2f} ms/step); "
          f"peak device memory {peak_q / 1e9:.2f} GB; tokens equal to the "
          f"uncaptured path's; each attention layer kind compiled once")
    del qparams

    stamp("serve-attn")

    # -- 10b. the recurrent-hybrid and MoE families, the expert pager ----
    finish_warm(ahead)
    stamp("the child's run of the phases ahead")
    reset_plain()
    serve_hybrid_phase(args, dev, stamp)
    stamp("serve-hybrid")
    serve_moe_phase(args, dev, stamp)
    stamp("serve-moe")
    reset_plain()
    oversub_moe_phase(args, dev, stamp)
    check_plain("[oversub-moe]")
    stamp("oversub-moe")

    # -- 11. [engine]: continuous batching under Poisson traffic ----------
    engine_k5 = engine_phase(args, dev, stamp)
    stamp("engine")

    # -- 12. [train]: tinyllama-1.1b at full width ---------------------------
    train_phase(args, dev, stamp)
    stamp("train")

    # every compiled executable of the run: at most two recompiles
    worst = max([(st.recompiles, r.name) for r in REGIONS
                 for st in r.compile_stats.values()]
                + [(op.stats.recompiles, op.label)
                   for op in T.LAYER_OPS.values()]
                + [(op.vjp_stats.recompiles, op.label + "_vjp")
                   for op in T.LAYER_OPS.values()
                   if isinstance(op, T.TrainLayer)]
                + [(st.recompiles, name)
                   for name, st in adamw.compile_stats().items()])
    print(f"[compile] {sum(len(r.compile_stats) for r in REGIONS)} compiled "
          f"region executables and "
          f"{sum(1 for op in T.LAYER_OPS.values() if op.stats.calls)} "
          f"compiled layers over the run, at most {worst[0]} recompiles "
          f"({worst[1]})")
    if worst[0] > 2:
        raise AssertionError(f"region {worst[1]} recompiled {worst[0]} times")


    # -- 13. the kernels of both paths, and the port's status ------------
    print(json.dumps({"kernels": [records[k]
                                  for k in on_path + ("rwkv6_scan",)]}))
    status = [
        {"tpu_kernel": f"K{i + 1}", "replaces": REPLACES[k], "status": "ported",
         "variant": "hopper", "port": k, "launches_main_path": counts[k]}
        for i, k in enumerate(("stencil_spmv", "rb_dilu_forward",
                               "rb_dilu_backward"))]
    status += [
        {"tpu_kernel": "K4", "replaces": REPLACES[k], "status": "ported",
         "variant": "hopper", "port": k, "launches_main_path": counts[k]}
        for k in ("fused_axpy", "fused_xpay", "fused_mul", "fused_axpbypz")]
    status.append({"tpu_kernel": "K5", "replaces": REPLACES["rwkv6_scan"],
                   "status": "ported", "variant": "hopper",
                   "port": "rwkv6_scan",
                   "launches_serve_path": serve_counts["rwkv6_scan"],
                   "launches_engine_path": engine_k5})
    print(json.dumps({"port_status": status}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
