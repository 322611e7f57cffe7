#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout.  Phases, each printing its own lines:

1. the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit);
2. build: nvcc compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a,
   Triton compiles the fused-field kernel;
3. kernels: every hand-written kernel against its plain PyTorch version at
   the main path's shape (200^3) and at a ragged one, then timed with CUDA
   events beside its plain version, its library call where one exists,
   and its bound;
4. the main path: SIMPLE steps of the 3-D lid-driven cavity at 200^3
   (8.0M cells, size M of the OpenFOAM HPC Technical Committee's
   ``Lid-driven_cavity-3d`` benchmark) under the unified policy through the ``hopper`` variants, with every
   kernel's launch count, then one step held against the ``ref`` step;
5. the discrete policy: one step paying real staging copies, held against
   the unified step;
6. a ``kernels`` JSON line (kernels of the path) and a ``port_status`` JSON
   line (every TPU kernel of the reference and whether it is ported).

The last line is ``{"ok": true, "device": {...}}``.  Nothing is caught: a
failed phase ends the run with a non-zero exit code and no result line.
Without CUDA, or outside a checkout, it exits non-zero at once.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM, NVIDIA data sheet: HBM3 bandwidth and dense f32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_TOL = dict(rtol=3e-4, atol=1e-4)           # K1-K3 vs plain
FIELD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
             torch.bfloat16: dict(rtol=2e-2, atol=1e-2)}
STEP_ENVELOPE = 1e-5          # |err| <= 1e-5 * max(1, max|field|)
N = 200                       # cells per axis of the cavity

#: where each kernel of the port replaces a TPU kernel of the reference
REPLACES = {
    "stencil_spmv": "src/repro/kernels/stencil_spmv/kernel.py:45",
    "rb_dilu_forward": "src/repro/kernels/stencil_spmv/kernel.py:114",
    "rb_dilu_backward": "src/repro/kernels/stencil_spmv/kernel.py:138",
    "fused_axpy": "src/repro/kernels/fused_field/kernel.py:84",
    "fused_xpay": "src/repro/kernels/fused_field/kernel.py:88",
    "fused_mul": "src/repro/kernels/fused_field/kernel.py:92",
    "fused_axpbypz": "src/repro/kernels/fused_field/kernel.py:96",
}


def time_ms(fn, reps=25, warmup=3):
    """Median device time (ms) of one call: CUDA events around each call,
    enqueued behind a ~50 ms device sleep, so the host's launch overhead
    (tens of microseconds for a Triton launch) is hidden behind queued
    work and the events bracket the device's execution alone.  Before each
    call a 256 MB buffer is written outside the events, so every call finds
    the 50 MB L2 cold, as the solver finds a field after other kernels have
    touched other fields."""
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
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, flops):
    """Least time (ms) the card could take: bytes over HBM rate vs
    operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def envelope_err(a, b):
    """(max |a-b|, allowed) of one field under the step envelope."""
    a = a.float().cuda()
    b = b.float().cuda()
    err = (a - b).abs().max().item()
    return err, STEP_ENVELOPE * max(1.0, a.abs().max().item())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(src))
    from repro_torch.cfd.grid import Grid, interior_mask, NEIGHBORS
    from repro_torch.cfd.simple import SimpleConfig, SimpleFoam, init_state
    from repro_torch.core.regions import (DiscretePolicy, Executor,
                                          StaticSelector, UnifiedPolicy)
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_field import kernel as FK, ref as FR
    from repro_torch.kernels.stencil_spmv import kernel as SK, ref as SR

    # -- 1. the card ----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch: {name}  count: {torch.cuda.device_count()}  "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

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
                             (1 + 2 * nb).sum().item(), None),
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
            err = (got.float() - want.float()).abs().max().item()
            line = (f"[kernel] {kname} {str(dt)[6:]} {'x'.join(map(str, shape))}"
                    f" max_abs_err {err:.3e} ok")
            if shape == (N, N, N):
                ms = time_ms(lambda: kfn(*kargs))
                plain_ms = time_ms(lambda: pfn(*kargs))
                lib_ms = time_ms(lambda: lib(*kargs)) if lib else None
                bound_ms, bound_by = bound(nbytes, flops)
                line += (f" | ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                         f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                         f"bound_ms {bound_ms:.4f} ({bound_by}) "
                         f"share_of_bound {bound_ms / ms:.3f}")
                if dt == torch.float32:
                    records[kname] = dict(
                        name=kname,
                        route="cuda" if kname in stencil_cases else "triton",
                        source=("src/repro_torch/kernels/csrc/stencil.cu"
                                if kname in stencil_cases else
                                "src/repro_torch/kernels/fused_field/kernel.py"),
                        replaces=REPLACES[kname], launches=0, max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib_ms)
            print(line)

    # -- 4. main path: unified + hopper at 200^3 ------------------------
    def reset_launches():
        for table in (SK.LAUNCHES, FK.LAUNCHES):
            for k in table:
                table[k] = 0

    def launches():
        return {**SK.LAUNCHES, **FK.LAUNCHES}

    grid = Grid((N, N, N))
    cfg = SimpleConfig(grid, nu=0.1, inner_max=25)
    app = SimpleFoam(cfg, executor=Executor(
        UnifiedPolicy(selector=StaticSelector("hopper"))))
    reset_launches()
    st = init_state(cfg)
    st, fom_warm, _ = app.run_steps(st, 1)               # warm-up step
    app.ledger.reset_timings()
    st, fom, m = app.run_steps(st, 2)
    counts = launches()
    rep = app.ex.report()
    print(f"[main] unified/hopper {N}^3 inner_max=25: FOM {fom:.4f} s/step "
          f"(warm-up step {fom_warm:.4f} s) res_u {m['res_u']:.3e} "
          f"iters_u {m['iters_u']} res_p {m['res_p']:.3e} iters_p "
          f"{m['iters_p']} impl_counts {rep['impl_counts']} "
          f"staging_fraction {rep['staging_fraction']:.4f}")
    print(f"[main] launches over 3 steps: {json.dumps(counts)}")
    rows = sorted(app.ledger.regions.values(), key=lambda r: -r.compute_s)
    total = sum(r.compute_s for r in rows)
    print(f"[main] 2 timed steps {2 * fom:.4f} s: outside regions "
          f"{2 * fom - total:.4f} s; region compute_s (share of "
          f"{total:.4f} s): " + "; ".join(
              f"{r.name} {r.compute_s:.4f} ({r.compute_s / total:.1%}, "
              f"{r.calls} calls)" for r in rows if r.calls))
    for f in "uvwp":
        if not torch.isfinite(getattr(st, f)).all():
            raise AssertionError(f"field {f} is not finite")
    if rep["impl_counts"].get("hopper", 0) <= 0:
        raise AssertionError(f"no hopper variant ran: {rep['impl_counts']}")
    on_path = ("stencil_spmv", "rb_dilu_forward", "rb_dilu_backward",
               "fused_axpy", "fused_axpbypz")
    for k in on_path:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
        records[k]["launches"] = counts[k]

    # one step from the same state, tol=0 on both sides: hopper vs ref
    cfg0 = SimpleConfig(grid, nu=0.1, inner_max=25, tol_u=0.0, tol_p=0.0)
    outs = {}
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
    print(f"[main] tol=0 step hopper vs ref: max_abs_err {errs}; step s: "
          f"hopper {outs['hopper'][1]:.4f} ref {outs['ref'][1]:.4f} "
          f"(ref/hopper {outs['ref'][1] / outs['hopper'][1]:.2f})")

    # -- 5. discrete policy: every region pays staging ------------------
    cfg3 = SimpleConfig(grid, nu=0.1, inner_max=3, tol_u=0.0, tol_p=0.0)
    res = {}
    for pname, policy in (
            ("discrete", DiscretePolicy(selector=StaticSelector("hopper"))),
            ("unified", UnifiedPolicy(selector=StaticSelector("hopper")))):
        a = SimpleFoam(cfg3, executor=Executor(policy))
        a.run_steps(st, 1)                               # warm-up (pools)
        a.ledger.reset_timings()
        reset_launches()
        s1, fom1, _ = a.run_steps(st, 1)
        res[pname] = (s1, fom1, a, launches())
    rep_d = res["discrete"][2].ex.report()
    sf = rep_d["staging_fraction"]
    if not sf > 0.5:
        raise AssertionError(f"discrete staging_fraction {sf:.3f} <= 0.5")
    for f in "uvwp":
        err, allowed = envelope_err(getattr(res["unified"][0], f),
                                    getattr(res["discrete"][0], f))
        if not err <= allowed:
            raise AssertionError(f"discrete step leaves the unified envelope "
                                 f"in {f}: {err:.3e} > {allowed:.3e}")
    fd, fu = res["discrete"][1], res["unified"][1]
    staged = sum(r.staging_bytes
                 for r in res["discrete"][2].ledger.regions.values())
    print(f"[discrete] {N}^3 inner_max=3: FOM discrete {fd:.4f} s/step, "
          f"unified {fu:.4f} s/step, discrete/unified {fd / fu:.2f}; "
          f"staging_fraction {sf:.4f} ({rep_d['staging_s']:.4f} s, "
          f"{staged / 1e9:.3f} GB); host pool "
          f"{json.dumps(res['discrete'][2].ex.policy.stager.host_pool.stats.as_dict())}; "
          f"launches {json.dumps(res['discrete'][3])}")

    # -- 6. the kernels of the path, and the port's status --------------
    print(json.dumps({"kernels": [records[k] for k in on_path]}))
    status = [
        {"tpu_kernel": f"K{i + 1}", "replaces": REPLACES[k], "status": "ported",
         "variant": "hopper", "port": k, "launches_main_path": counts[k]}
        for i, k in enumerate(("stencil_spmv", "rb_dilu_forward",
                               "rb_dilu_backward"))]
    status += [
        {"tpu_kernel": "K4", "replaces": REPLACES[k], "status": "ported",
         "variant": "hopper", "port": k, "launches_main_path": counts[k]}
        for k in ("fused_axpy", "fused_xpay", "fused_mul", "fused_axpbypz")]
    status.append({"tpu_kernel": "K5",
                   "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:71",
                   "status": "not yet"})
    print(json.dumps({"port_status": status}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
