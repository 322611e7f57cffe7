"""Where a served step's time goes: a ``torch.profiler`` trace of one
compiled prefill and one compiled decode step of the captured serve
programs, summarised.

    PYTHONPATH=src python -m repro_torch.launch.profile \\
        [--arch rwkv6-7b|tinyllama-1.1b|llama3.2-3b|recurrentgemma-9b|
                qwen3-moe-30b-a3b|llama4-scout-17b-a16e|...] \\
        [--batch 4 --prompt-len 1024] [--layers N] [--reduced] \\
        [--trace-dir DIR]

Both programs are captured and replayed under the unified policy with the
``hopper`` variants (``repro_torch.launch.serve``), compiled, and warmed up
before the traced calls.  For each traced call it prints one JSON line:

* ``wall_ms``: the host clock around the call, which ends in the
  executor's synchronise;
* ``device_busy_ms`` and ``device_idle_share``: the union of the card's
  kernel and copy intervals inside that window (the window's own range,
  which the profiler also draws on the device, left out), and the share of
  the window the card ran nothing;
* ``device_ms`` by kind: the RWKV6 scan kernel (K5), matrix products
  (cuBLAS/CUTLASS), Inductor's generated Triton kernels, copies, other;
* ``host_ms`` split into ``launch`` (the CUDA runtime's launch calls),
  ``synchronise`` (its synchronise calls) and ``dispatch`` (the rest:
  Python, Dynamo's guards, the executor and Inductor's wrapper).

Runs on CUDA unless ``--device cpu`` is given (then there are no device
intervals: only the host split).  ``--trace-dir`` also writes each trace
as Chrome JSON there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import torch
from torch.autograd import DeviceType

from repro_torch.configs.reduced import reduced as make_reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import (Executor, StaticSelector,
                                      UnifiedPolicy, synchronize)
from repro_torch.core.umem import resolve_device
from repro_torch.launch import serve as SV
from repro_torch.models import transformer as T

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")


def _kind(name: str) -> str:
    """The kind of one device interval, by its kernel name."""
    low = name.lower()
    if "rwkv6" in low:
        return "rwkv6_scan"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                              "cublas", "splitkreduce", "sm90_")):
        return "matmul"
    if low.startswith("triton"):
        return "inductor_triton"
    return "other"


def _union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarise(prof, label: str) -> dict:
    """The JSON summary of the ``record_function(label)`` window of a
    finished profile (times in ms)."""
    events = prof.events()
    window = [e for e in events if e.name == label
              and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError(f"no {label!r} range in the trace")
    t0, t1 = window[0].time_range.start, window[0].time_range.end
    device, launch, sync = [], 0.0, 0.0
    by_kind: dict = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False) or e.name == label:
            continue                    # the window itself, on either side
        if e.device_type == DeviceType.CUDA:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                device.append((a, b))
                k = _kind(e.name)
                by_kind[k] = by_kind.get(k, 0.0) + (b - a) / 1e3
        elif e.device_type == DeviceType.CPU and t0 <= a and b <= t1:
            if e.name in LAUNCH_CALLS:
                launch += (b - a) / 1e3
            elif e.name in SYNC_CALLS:
                sync += (b - a) / 1e3
    wall = (t1 - t0) / 1e3
    busy = _union(device) / 1e3
    return {
        "step": label, "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": (1.0 - busy / wall) if wall > 0 else None,
        "device_ms": {k: by_kind[k] for k in sorted(by_kind)},
        "device_intervals": len(device),
        "host_ms": {"launch": launch, "synchronise": sync,
                    "dispatch": wall - launch - sync},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile")
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model's depth to this many layers (0: "
                         "all); the widths stay")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--trace-dir", default=None,
                    help="also write each trace as Chrome JSON here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init(gen, cfg, device)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    policy = UnifiedPolicy(selector=StaticSelector("hopper"))
    ex = Executor(policy, Ledger("profile"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)

    def cache():
        return T.init_cache(cfg, args.batch, device, args.prompt_len + 2)

    t0 = time.perf_counter()
    pprog = SV.capture_prefill_program(regions, batch, cache(),
                                       selector=policy.selector)
    tok, state = pprog.replay(ex, batch, cache())
    dprog = SV.capture_decode_program(regions, args.prompt_len, 2, tok,
                                      state, selector=policy.selector)
    for _ in range(2):                                  # warm-up
        tok, state = pprog.replay(ex, batch, cache())
        dprog.replay(ex, tok, state)
    synchronize()
    print(f"[profile] {cfg.name} ({cfg.n_layers} layers) "
          f"{args.batch}x{args.prompt_len}, "
          f"{device.type}: captured, compiled and warmed up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = []
    for label in ("prefill", "decode_step"):
        tok, state = pprog.replay(ex, batch, cache())
        synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(label):
                if label == "prefill":
                    pprog.replay(ex, batch, cache())
                else:
                    dprog.replay(ex, tok, state)
        summary = summarise(prof, label)
        if device.type == "cuda" and summary["device_intervals"] == 0:
            raise RuntimeError("the profiler recorded no device time")
        out.append(summary)
        print(json.dumps(summary), flush=True)
        if args.trace_dir:
            path = pathlib.Path(args.trace_dir)
            path.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path / f"{label}.json"))
    return out


if __name__ == "__main__":
    main()
