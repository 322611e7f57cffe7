"""Where the first compiled SIMPLE step's seconds go: ``cProfile`` of one
step of the 200^3 cavity under the unified policy with the ``hopper``
variants, every region compiled from a cold Inductor cache (the first
call of every region: trace, compile, run), as ``chip_smoke.py``'s
``[main]`` warm-up step.

    PYTHONPATH=src python tools/profile_first_step.py [--grid 200] \\
        [--top 60]

Needs an NVIDIA GPU and ``nvcc`` (it builds the kernels first).  Prints
the step's seconds, then the profile sorted by cumulative and by own
time.  Set ``TORCHINDUCTOR_CACHE_DIR`` to an empty directory for a cold
run, and ``TORCHINDUCTOR_VEC_ISA_OK=auto`` for Inductor's own probe of
the CPU's vector ISA (the port skips it otherwise).
"""
import argparse
import cProfile
import io
import pstats
import sys
import time

import torch

from repro_torch.cfd.grid import Grid
from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
from repro_torch.core.regions import Executor, StaticSelector, UnifiedPolicy
from repro_torch.kernels import build


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=200)
    ap.add_argument("--top", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_first_step: needs an NVIDIA GPU")
    build.library()
    torch.cuda.set_device(0)
    n = args.grid
    cfg = SimpleConfig(Grid((n, n, n)), nu=0.1, inner_max=25)
    app = SimpleFoam(cfg, executor=Executor(
        UnifiedPolicy(selector=StaticSelector("hopper"))))
    state = init_state(cfg)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    app.run_steps(state, 1)
    prof.disable()
    print(f"first step {time.perf_counter() - t0:.2f} s", flush=True)
    for key in ("cumulative", "tottime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(out.getvalue())


if __name__ == "__main__":
    main()
