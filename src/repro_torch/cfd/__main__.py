"""The paper's case study: simpleFoam on a lid-driven cavity under one
memory model, with the FOM and the coverage/migration report.

    PYTHONPATH=src python -m repro_torch.cfd --grid 200 --steps 2
    PYTHONPATH=src python -m repro_torch.cfd --grid 16 --device cpu --impl ref

The default grid is 200^3 (8.0M cells, size M of the 3-D lid-driven cavity
benchmark), with ``nu=0.1`` and 25 inner iterations per solve, the settings
of ``examples/cfd_cavity.py``.  Runs on CUDA with the hand-written kernels
(``--impl hopper``) unless told otherwise; asking for CUDA where there is
none raises.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
from repro_torch.core.regions import (DiscretePolicy, Executor,
                                      StaticSelector, UnifiedPolicy)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cfd")
    ap.add_argument("--grid", type=int, default=200)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--policy", choices=("unified", "discrete"),
                    default="unified")
    ap.add_argument("--impl", choices=("hopper", "ref"), default="hopper")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    cfg = SimpleConfig(grid=Grid((args.grid,) * 3, device=args.device),
                       nu=0.1, inner_max=25)
    selector = StaticSelector(args.impl)
    policy = UnifiedPolicy(selector=selector) if args.policy == "unified" \
        else DiscretePolicy(selector=selector, device=args.device)
    app = SimpleFoam(cfg, executor=Executor(policy))
    st = init_state(cfg)
    st, _, _ = app.run_steps(st, 1)              # warm-up (kernel builds)
    app.ledger.reset_timings()
    st, fom, m = app.run_steps(st, args.steps)
    rep = app.ex.report()
    out = {"policy": args.policy, "impl": args.impl, "device": args.device,
           "grid": args.grid, "steps": args.steps, "fom_s_per_step": fom,
           "staging_fraction": rep["staging_fraction"],
           "impl_counts": rep["impl_counts"], **m}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
