"""The paper's case study: simpleFoam on a lid-driven cavity under the
memory models of Fig 5, with the FOM and the coverage/migration report.

    PYTHONPATH=src python -m repro_torch.cfd --grid 200 --steps 2
    PYTHONPATH=src python -m repro_torch.cfd --grid 200 --policy all --calibrate
    PYTHONPATH=src python -m repro_torch.cfd --grid 16 --device cpu --impl ref

The default grid is 200^3 (8.0M cells, size M of the 3-D lid-driven cavity
benchmark), with ``nu=0.1`` and 25 inner iterations per solve, the settings
of ``examples/cfd_cavity.py``.  ``--policy`` picks the memory model:
``host`` (the dCPU baseline: fields on the CPU, no kernel), ``discrete``
(managed memory: every region stages its operands), ``unified`` (the APU:
nothing is copied), ``adaptive`` (regions above ``--cutoff`` elements on
the card, the rest on the host; ``--calibrate`` sets the cutoff from a
timing ladder first) or ``all`` (one JSON line each, in that order, with
each policy's fields held against the unified run's).  ``--replay`` times
a step captured once and replayed, synchronously or with lookahead
staging on a side stream.

Every policy but ``host`` runs on CUDA with the hand-written kernels
(``--impl hopper``) unless ``--device cpu`` is given; asking for CUDA
where there is none raises.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
from repro_torch.core.program import AsyncExecutor
from repro_torch.core.regions import (DEFAULT_CUTOFF, Executor, POLICIES,
                                      TargetSelector, make_policy)

#: the order of the four rows of ``examples/cfd_cavity.py``
ALL = ("host", "discrete", "unified", "adaptive")


def run_policy(name: str, args) -> tuple:
    """One warm-up step, then ``args.steps`` timed steps (or replays of a
    step captured after the warm-up) under one policy.  Returns (JSON row,
    final state)."""
    device = "cpu" if name == "host" else args.device
    cfg = SimpleConfig(grid=Grid((args.grid,) * 3, device=device),
                       nu=0.1, inner_max=25)
    kw = {"selector": TargetSelector(device_impl=args.impl)}
    if name == "discrete":
        kw["device"] = device
    if name == "adaptive":
        kw["cutoff"] = args.cutoff
    policy = make_policy(name, **kw)
    app = SimpleFoam(cfg, executor=Executor(policy))
    if name == "adaptive" and args.calibrate:
        app.calibrate_cutoff(policy)
    st = init_state(cfg)
    st, _, _ = app.run_steps(st, 1)              # warm-up (kernel builds)
    app.ledger.reset_timings()
    row = {"policy": name, "impl": args.impl, "device": cfg.grid.device.type,
           "grid": args.grid, "steps": args.steps, "replay": args.replay}
    if args.replay == "none":
        st, fom, m = app.run_steps(st, args.steps)
        rep = app.ex.report()
    else:                           # a replay's residuals are frozen constants
        m = {}
        prog = app.capture_step(st)
        ex = Executor(policy, app.ledger) if args.replay == "sync" \
            else AsyncExecutor(policy, app.ledger)
        st, fom = app.replay_steps(prog, st, args.steps, ex)
        rep = ex.report()
        row["overlap_fraction"] = rep["overlap_fraction"]
    row.update({"fom_s_per_step": fom,
                "staging_fraction": rep["staging_fraction"],
                "device_calls": rep["device_calls"],
                "host_calls": rep["host_calls"],
                "impl_counts": rep["impl_counts"], **m})
    if name == "adaptive":
        row["cutoff"] = policy.cutoff
    return row, st


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cfd")
    ap.add_argument("--grid", type=int, default=200)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--policy", choices=tuple(POLICIES) + ("all",),
                    default="unified")
    ap.add_argument("--impl", choices=("hopper", "ref"), default="hopper",
                    help="variant of device-routed calls (host-routed calls "
                         "run ref)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of every policy but host, whose fields "
                         "are on the CPU")
    ap.add_argument("--cutoff", type=int, default=DEFAULT_CUTOFF,
                    help="adaptive: largest region size routed to the host")
    ap.add_argument("--calibrate", action="store_true",
                    help="adaptive: set the cutoff from the Amul timing "
                         "ladder first")
    ap.add_argument("--replay", choices=("none", "sync", "async"),
                    default="none",
                    help="time replays of a captured step instead of eager "
                         "steps")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.policy != "all":
        row, _ = run_policy(args.policy, args)
        print(json.dumps(row))
        return row
    runs = {name: run_policy(name, args) for name in ALL}
    unified = runs["unified"][1]
    rows = []
    for name in ALL:
        row, st = runs[name]
        row["max_abs_err_vs_unified"] = {
            f: (getattr(st, f).cpu() - getattr(unified, f).cpu())
            .abs().max().item() for f in "uvwp"}
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
