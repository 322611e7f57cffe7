"""End-to-end training entry point of the port, on the region-program spine
(counterpart of ``repro.launch.train``).

The config registry (``--arch``, full or ``--reduced``), the
region-decomposed train step (``FWD_BWD`` + ``ADAMW_UPDATE`` captured as
one RegionProgram and replayed through an Executor under ``--policy``),
the placement axis (``--offload-optimizer`` hints the AdamW moments into
host memory between steps), atomic asynchronous checkpoints (each with a
``coverage_report()`` snapshot), the fault-tolerant supervisor (a restart
re-captures the program against the restored state and keeps the same
ledger) and the deterministic data pipeline.  ``--report`` prints the
``coverage_report()`` as JSON.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --device cpu --steps 3 --batch 2 \\
        --seq 32 [--offload-optimizer] \\
        [--policy unified|discrete|host|adaptive] \\
        [--ckpt-dir D --ckpt-every 2 --fail-at 2] [--report]

Every ported arch trains (the MoE archs ``qwen3-moe-30b-a3b`` and
``llama4-scout-17b-a16e`` add ``MOE_AUX_WEIGHT`` times their load-balancing
loss, printed as ``moe_aux``; ``recurrentgemma-9b`` runs its RG-LRU scan).
Runs on CUDA unless ``--device cpu`` is given.  ``--layers N`` cuts the
depth (printed).  ``--policy auto`` and ``--verify`` wait for the tuner
and the verifier (ROADMAP A.8); there is no mesh (A.9).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.reduced import reduced as make_reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import Executor, synchronize
from repro_torch.core.umem import resolve_device
from repro_torch.data.pipeline import make_source
from repro_torch.launch.policy import POLICY_CHOICES, lm_policy
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (FaultInjector, StragglerMonitor,
                                       TrainSupervisor)
from repro_torch.train import step as S


def build_trainer(cfg, *, lr=3e-4, offload_optimizer=False, q_chunk=512,
                  seed=0, policy: str = "unified",
                  executor: Optional[Executor] = None, device="cuda",
                  draw_layers: Optional[int] = None):
    """Returns ``(init_fn, capture_fn, ex)``.

    ``init_fn() -> state`` draws the parameters from ``seed`` on
    ``device`` and zero AdamW moments.  With ``draw_layers`` it draws a
    model of that depth and keeps its first ``cfg.n_layers`` layers: the
    init's scale follows the depth (a stacked weight's fan-in is its layer
    count, as in the reference), so a depth cut keeps the full model's
    scale.  ``capture_fn(state, batch) ->
    step_fn`` captures one train step as a RegionProgram over the
    trainer's ``FWD_BWD``/``ADAMW_UPDATE`` regions and returns
    ``step_fn(state, batch) -> (state, metrics)`` replaying it through
    ``ex``; call it again after a restore to re-capture (the regions, and
    so the ledger rows, are reused).  ``ex.report()`` is the run's
    coverage report.

    Region executables do not donate (a replayed region may be staged), so
    the parameters and moments are held twice at the ``ADAMW_UPDATE``
    boundary, as in the reference."""
    device = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(lr=lr)
    ex = executor or Executor(lm_policy(policy, cfg.memory, device=device),
                              Ledger("train"))

    def make_ctx():
        return T.Ctx(mode="train", q_chunk=q_chunk)
    regions = S.make_train_regions(cfg, opt_cfg, make_ctx, ledger=ex.ledger,
                                   offload_optimizer=offload_optimizer)

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(seed)
        depth = draw_layers or cfg.n_layers
        params = T.init(gen, dataclasses.replace(cfg, n_layers=depth),
                        device)
        params["layers"] = params["layers"][:cfg.n_layers]
        return (params, adamw.init_state(params, opt_cfg))

    def capture_fn(state, batch):
        prog = S.capture_train_program(regions, state, batch,
                                       selector=ex.policy.selector)

        def step_fn(state, batch):
            return prog.replay(ex, state, batch)
        return step_fn

    init_fn.regions = regions           # the trainer's regions, for reports
    return init_fn, capture_fn, ex


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="train the first N layers of the config's model "
                         "(drawn at its full depth; 0: all)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--offload-optimizer", action="store_true")
    ap.add_argument("--policy", default="unified",
                    choices=POLICY_CHOICES + ("auto",),
                    help="ExecutionPolicy the train-step regions run under "
                         "(auto waits for ROADMAP A.8)")
    ap.add_argument("--verify", action="store_true",
                    help="lint the captured train program (waits for "
                         "ROADMAP A.8)")
    ap.add_argument("--report", action="store_true",
                    help="print the run's coverage_report() as JSON")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", default="", help="fault injection steps, csv")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    if args.policy == "auto":
        raise NotImplementedError("--policy auto needs the tuner's profile, "
                                  "which is not ported yet (ROADMAP A.8)")
    if args.verify:
        raise NotImplementedError("--verify needs the program verifier, "
                                  "which is not ported yet (ROADMAP A.8)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    depth = cfg.n_layers
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    init_fn, capture_fn, ex = build_trainer(
        cfg, lr=args.lr, offload_optimizer=args.offload_optimizer,
        q_chunk=min(512, args.seq), seed=args.seed, policy=args.policy,
        device=device, draw_layers=depth)
    src = make_source(args.data, cfg.vocab, path=args.data_path,
                      seed=args.seed)

    def batch_fn(step):
        page = src.batch_at(step, args.batch, args.seq)
        tokens = page.to(device, copy=True)
        src.release(page)
        return {"tokens": tokens}

    print(f"[train] {args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{cfg.n_layers} layers{' (cut by --layers)' if args.layers else ''}"
          f", d_model {cfg.d_model}, {args.batch}x{args.seq} tokens a step, "
          f"policy {args.policy}, {device.type}")
    state = init_fn()
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir, keep=3)
        if args.resume and ckpt.latest_step() is not None:
            state, man = ckpt.restore(state)
            start = man["extra"]["step"]
            print(f"[train] resumed at step {start}")

    step_fn = capture_fn(state, batch_fn(start))
    t0 = time.perf_counter()
    if ckpt is not None:
        fault = FaultInjector({int(s) for s in args.fail_at.split(",") if s})
        sup = TrainSupervisor(
            step_fn, batch_fn, ckpt, ckpt_every=args.ckpt_every, fault=fault,
            straggler=StragglerMonitor(),
            rebuild_step=lambda st, step: capture_fn(st, batch_fn(step)),
            report_fn=ex.report)
        state, rep = sup.run(state, start, args.steps)
        print(f"[train] done: steps {rep.steps_run}, restarts "
              f"{rep.restarts}, checkpoints {rep.checkpoints}, final step "
              f"{rep.final_step}")
        losses = [m["loss"] for _, m in rep.history]
    else:
        losses = []
        for step in range(start, start + args.steps):
            state, metrics = step_fn(state, batch_fn(step))
            losses.append(float(metrics["loss"]))
            aux = f" moe_aux {float(metrics['moe_aux']):.4f}" \
                if cfg.moe is not None else ""
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}{aux}")
    synchronize()
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    print(f"[train] {args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{toks / dt:.0f} tok/s, first loss {losses[0]:.4f}, "
          f"last loss {losses[-1]:.4f}")
    if args.report:
        print(json.dumps(ex.report(), indent=1, default=str))
    return losses


if __name__ == "__main__":
    main()
