"""Compile seconds of one compiled decode step by depth, for three ways of
compiling its layer loop, and of one train step's gradients.

    PYTHONPATH=src python -m repro_torch.launch.compile_depth \\
        [--arch rwkv6-7b|recurrentgemma-9b|qwen3-moe-30b-a3b|...] \\
        [--reduced] [--depths 2,6] \\
        [--designs inline,nested,layer_op] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.compile_depth --mode train \\
        [--arch tinyllama-1.1b] [--depths 2,4,8] [--batch 4 --seq 1024]

* ``inline``: every layer traced into the step's graph (``layers=None``);
* ``nested``: each layer call a ``torch.compiler.nested_compile_region``;
* ``layer_op``: the port's design, each layer kind a custom op whose body
  is the layer compiled once (``transformer.layer_fns``).

``--mode train`` times the first call of ``train.step.value_and_grad``
(the ``FWD_BWD`` region's function) with each layer kind a
``transformer.TrainLayer`` (its forward and its VJP compiled once), at
batch ``--batch`` x ``--seq`` tokens: the design ``train_layer``, with
each part's first-call seconds and graphs.

Each (design, depth) runs in a process of its own with an empty Inductor
cache (under ``build/compile_depth/``), so no run reuses another's
compiled code.  Each prints one JSON line: the seconds of the step's
first call (trace, compile and run), and the subgraphs and layer-op calls
in the graph Dynamo hands to Inductor.  Weights are random (seed 0), batch
4, one decode step (an attention arch against a cache of 8 slots).  Runs
on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import torch

from repro_torch.configs.reduced import reduced as make_reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.umem import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import step as S

DESIGNS = ("inline", "nested", "layer_op")
#: KV slots of an attention layer's cache (the step decodes position 1)
KV_SLOTS = 8
CACHE_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "compile_depth"


def one_run(args, design: str, depth: int) -> dict:
    """Compile and run one decode step of ``depth`` layers; returns its
    record."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = dataclasses.replace(cfg, n_layers=depth)
    dev = resolve_device(args.device)
    params = T.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    if design == "train_layer":
        return train_run(args, cfg, params, dev)
    caches = T.init_cache(cfg, 4, dev, KV_SLOTS)
    tok = torch.zeros(4, dtype=torch.int32, device=dev)
    ctx = T.Ctx(mode="decode")
    if design == "layer_op":
        step = S.make_decode_step(cfg)
    else:
        layers = None
        if design == "nested":
            layers = {kind: _nested(cfg, ctx, *kind)
                      for kind in dict.fromkeys(T.layer_kinds(cfg))}

        def step(p, t, c, pos):
            return T.decode_step(p, t, c, pos, cfg, ctx, layers)
    seen = {}

    def backend(gm, example_inputs):
        from torch._inductor.compile_fx import compile_fx
        targets = [str(n.target) for n in gm.graph.nodes
                   if n.op == "call_function"]
        seen["subgraphs"] = len(list(gm.named_children()))
        seen["subgraph_calls"] = sum("invoke_subgraph" in t for t in targets)
        seen["layer_op_calls"] = sum(t.startswith("repro_torch.layer_")
                                     for t in targets)
        seen["graph_nodes"] = len(gm.graph.nodes)
        return compile_fx(gm, example_inputs)

    compiled = torch.compile(step, fullgraph=True, backend=backend)
    t0 = time.perf_counter()
    compiled(params, tok, caches, torch.tensor(1, dtype=torch.int32))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    layer_s = [op.stats.first_call_s for op in T.LAYER_OPS.values()
               if op.stats.calls]
    return {"design": design, "layers": depth, "first_call_s": first,
            "layer_first_call_s": layer_s, **seen,
            "torch": torch.__version__,
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu"}


def _nested(cfg, ctx, mk: str, lk: str):
    """A layer of kind ``(mk, lk)`` as a ``nested_compile_region`` call,
    in the signature of a layer op: ``(x, new cache)``."""
    @torch.compiler.nested_compile_region
    def layer(p, x, c, pos):   # tensors out: x, then the new cache
        x, nc, _ = T.layer_fwd(p, x, cfg, mk, lk,
                               dataclasses.replace(ctx, pos=pos), c)
        return (x, *(nc[k] for k in c))

    def nested(p, x, c, pos):
        x, *state = layer(p, x, c, pos)
        return x, dict(zip(c, state))
    return nested


def train_run(args, cfg, params, dev) -> dict:
    """The first call of ``value_and_grad`` on one batch, and its parts'
    compile records."""
    batch = S.demo_batch(torch.Generator(device=dev).manual_seed(0), cfg,
                         args.batch, args.seq, dev)
    t0 = time.perf_counter()
    S.value_and_grad(params, batch, cfg, T.Ctx(mode="train"))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    parts = {}
    for op in T.LAYER_OPS.values():
        if isinstance(op, T.TrainLayer):
            parts[op.label] = [op.stats.first_call_s, op.stats.compiles]
            parts[op.label + "_vjp"] = [op.vjp_stats.first_call_s,
                                        op.vjp_stats.compiles]
    return {"design": "train_layer", "mode": "train",
            "layers": cfg.n_layers, "tokens": [args.batch, args.seq],
            "first_call_s": first, "parts": parts,
            "torch": torch.__version__,
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.launch.compile_depth")
    ap.add_argument("--mode", choices=("decode", "train"), default="decode")
    ap.add_argument("--arch", default=None,
                    help="rwkv6-7b (decode) or tinyllama-1.1b (train) by "
                    "default; any ported arch, recurrentgemma-9b, "
                    "qwen3-moe-30b-a3b and llama4-scout-17b-a16e included")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--depths", default=None,
                    help="2,6 (decode) or 2,4,8 (train)")
    ap.add_argument("--designs", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--one", nargs=2, metavar=("DESIGN", "DEPTH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    train = args.mode == "train"
    args.arch = args.arch or ("tinyllama-1.1b" if train else "rwkv6-7b")
    args.depths = args.depths or ("2,4,8" if train else "2,6")
    args.designs = args.designs or ("train_layer" if train
                                    else ",".join(DESIGNS))
    if args.one:
        print(json.dumps(one_run(args, args.one[0], int(args.one[1]))),
              flush=True)
        return
    designs = args.designs.split(",")
    allowed = ("train_layer",) if train else DESIGNS
    bad = [d for d in designs if d not in allowed]
    if bad:
        ap.error(f"unknown designs {bad}; choose from {allowed}")
    passed = list(argv if argv is not None else sys.argv[1:])
    for depth in (int(d) for d in args.depths.split(",")):
        for design in designs:
            cache = CACHE_ROOT / f"{design}_{depth}"
            shutil.rmtree(cache, ignore_errors=True)
            env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=str(cache))
            subprocess.run([sys.executable, "-m",
                            "repro_torch.launch.compile_depth", *passed,
                            "--one", design, str(depth)], env=env,
                           check=True)


if __name__ == "__main__":
    main()
