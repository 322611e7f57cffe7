"""simpleFoam — the SIMPLE pressure-velocity corrector (paper listing 3).

Steady, incompressible, laminar lid-driven cavity (the geometry stand-in
for HPC_motorbike).  One time-step executes the stages of listing 3, each
built from regions so every policy can run it:

  1. momentum predictor:  solve(UEqn == -grad(p))         (PBiCGStab+DILU)
  2. pressure corrector:  laplacian(rAU, p') == div(HbyA) (PBiCGStab+DILU)
  3. momentum corrector:  U = HbyA - rAU*grad(p')         (field macros)

The FOM is average seconds per time-step over the run, the paper's figure
of merit.  A step can also be captured once (:meth:`SimpleFoam.capture_step`)
and replayed (:meth:`SimpleFoam.replay_steps`), synchronously or with
lookahead staging.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.cfd import fvc, fvm
from repro_torch.cfd.dia import DiaMatrix, STENCIL_OFFSETS
from repro_torch.cfd.fields import make_field_ops
from repro_torch.cfd.grid import Grid
from repro_torch.cfd.precond import RBDilu, rb_dilu_factor
from repro_torch.cfd.solvers import make_solver_regions, pbicgstab_regions
from repro_torch.core.ledger import Ledger
from repro_torch.core.program import capture
from repro_torch.core.regions import Executor, UnifiedPolicy, region

#: the ``Amul`` calibration ladder: region sizes 6 * s^3 for cubes of side
#: 4 to 64 (the largest operand of a call is its six off-diagonals)
AMUL_LADDER = tuple(6 * s ** 3 for s in (4, 8, 16, 32, 64))


@dataclasses.dataclass
class SimpleConfig:
    grid: Grid
    nu: float = 0.01                  # kinematic viscosity (Re = U*L/nu)
    lid_velocity: float = 1.0
    alpha_u: float = 0.7              # momentum under-relaxation
    alpha_p: float = 0.3              # pressure under-relaxation
    tol_u: float = 1e-5
    tol_p: float = 1e-6
    inner_max: int = 50
    n_correctors: int = 1


@dataclasses.dataclass
class SimpleState:
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    step: int = 0


def init_state(cfg: SimpleConfig) -> SimpleState:
    g = cfg.grid
    return SimpleState(g.zeros(), g.zeros(), g.zeros(), g.zeros())


class SimpleFoam:
    """Region-program version of the solver, runnable under any policy.
    Its tensors live on ``cfg.grid.device`` (CUDA unless the grid says
    otherwise).  A region that builds grid tensors builds them on its
    operands' device (:meth:`_on`), so it also runs when a policy routes
    it to the host and its operands cross to the CPU.  The grid and its
    red mask are built here for the CPU and the grid's device, so a
    compiled region body only looks them up."""

    def __init__(self, cfg: SimpleConfig, executor: Optional[Executor] = None):
        self.cfg = cfg
        self.ledger = Ledger("simpleFoam")
        self.ex = executor or Executor(UnifiedPolicy(), self.ledger)
        self.ex.ledger = self.ledger
        self.ops = make_field_ops(self.ledger)
        self.solver_regions = make_solver_regions(self.ledger)
        self.red = cfg.grid.red_black_masks()[0]
        #: device type -> (grid, red mask) on that device
        self._grids = {cfg.grid.device.type: (cfg.grid, self.red)}
        if "cpu" not in self._grids:
            g = dataclasses.replace(cfg.grid, device="cpu")
            self._grids["cpu"] = (g, g.red_black_masks()[0])
        asm = dict(ledger=self.ledger)

        @region("assemble(momentum)", stencil=STENCIL_OFFSETS,
                halo_args=("u", "v", "w", "p"), **asm)
        def assemble_momentum(u, v, w, p):
            g = self._on(u)[0]
            phi = fvm.face_fluxes(g, u, v, w)
            conv = fvm.div_upwind(g, phi)
            diff, bc = fvm.laplacian(g, cfg.nu, dirichlet=[True] * 6)
            A = DiaMatrix(conv.diag + diff.diag, conv.off + diff.off)
            gp = fvc.grad(g, p)
            # lid (+y face, f=3) drives u with wall value = lid_velocity
            rhs_u = -gp[0] + bc[3] * cfg.lid_velocity
            rhs_v = -gp[1]
            rhs_w = -gp[2]
            Au, ru = fvm.relax(A, u, rhs_u, cfg.alpha_u)
            Av, rv = fvm.relax(A, v, rhs_v, cfg.alpha_u)
            Aw, rw = fvm.relax(A, w, rhs_w, cfg.alpha_u)
            return (Au.diag, Au.off, ru, Av.diag, rv, Aw.diag, rw)

        @region("assemble(pressure)", stencil=STENCIL_OFFSETS,
                halo_args=("u_s", "v_s", "w_s"), **asm)
        def assemble_pressure(rAU, u_s, v_s, w_s):
            g = self._on(rAU)[0]
            # laplacian(rAU, p) with zero-gradient walls (singular -> pinned)
            Ap, _ = fvm.laplacian(g, 1.0, dirichlet=[False] * 6)
            Ap = DiaMatrix(Ap.diag * rAU, Ap.off * rAU[None])
            phi_s = fvm.face_fluxes(g, u_s, v_s, w_s)
            div_hbya = fvc.div_flux(g, phi_s)
            # pin reference cell (pEqn.setReference)
            pin = torch.zeros_like(rAU)
            pin[0, 0, 0] = 1.0
            diag = torch.where(pin > 0, 1.0, Ap.diag)
            off = Ap.off * (1.0 - pin)[None]
            # Ap == -div(rAU grad .)  =>  Ap p' = -div(HbyA)
            rhs = torch.where(pin > 0, 0.0, -div_hbya)
            return (diag, off, rhs)

        @region("DILU factor", stencil=STENCIL_OFFSETS,
                halo_args=("diag", "off"), **asm)
        def factor(diag, off):
            return rb_dilu_factor(DiaMatrix(diag, off),
                                  self._on(diag)[1]).rdiag

        @region("momentum corrector", **asm)
        def correct_u(hb_u, hb_v, hb_w, rAU, gpx, gpy, gpz):
            # U = HbyA - rAU*grad(p)   (listing 3 line 32 == listing 4 macro)
            return (hb_u - rAU * gpx, hb_v - rAU * gpy, hb_w - rAU * gpz)

        @region("grad(p)", stencil=STENCIL_OFFSETS, halo_args=("p",), **asm)
        def grad_p(p):
            return tuple(fvc.grad(self._on(p)[0], p))

        @region("rAU=1/A", **asm)
        def recip_diag(diag):
            return 1.0 / diag

        @region("p relax", **asm)
        def relax_p(p, dp):
            # dp is the pressure CORRECTION from the Poisson solve
            return p + cfg.alpha_p * dp

        self.assemble_momentum = assemble_momentum
        self.assemble_pressure = assemble_pressure
        self.factor = factor
        self.recip_diag = recip_diag
        self.correct_u = correct_u
        self.grad_p = grad_p
        self.relax_p = relax_p

    def _on(self, x: torch.Tensor) -> tuple:
        """(grid, red mask) on ``x``'s device (built on first use for a
        device other than the CPU and the grid's)."""
        got = self._grids.get(x.device.type)
        if got is None:
            g = dataclasses.replace(self.cfg.grid, device=x.device)
            got = self._grids[x.device.type] = (g, g.red_black_masks()[0])
        return got

    # ------------------------------------------------------------------
    def time_step(self, st: SimpleState, executor=None) -> tuple:
        """One SIMPLE iteration.  ``executor`` overrides ``self.ex`` for
        this call only."""
        cfg, ex = self.cfg, executor if executor is not None else self.ex
        run = ex.run
        # --- momentum predictor -------------------------------------
        du, off, ru, dv, rv, dw, rw = run(self.assemble_momentum,
                                          st.u, st.v, st.w, st.p)
        rdiag_m = run(self.factor, du, off)
        Pm = RBDilu(rdiag_m, self.red)
        res_u = pbicgstab_regions(ex, self.solver_regions, DiaMatrix(du, off),
                                  ru, st.u, Pm, tol=cfg.tol_u,
                                  max_iter=cfg.inner_max)
        res_v = pbicgstab_regions(ex, self.solver_regions, DiaMatrix(dv, off),
                                  rv, st.v, Pm, tol=cfg.tol_u,
                                  max_iter=cfg.inner_max)
        res_w = pbicgstab_regions(ex, self.solver_regions, DiaMatrix(dw, off),
                                  rw, st.w, Pm, tol=cfg.tol_u,
                                  max_iter=cfg.inner_max)
        u_s, v_s, w_s = res_u.x, res_v.x, res_w.x
        rAU = run(self.recip_diag, du)
        # --- pressure corrector (solves for the correction p') -------
        p = st.p
        for _ in range(self.cfg.n_correctors):
            dp, offp, rp = run(self.assemble_pressure, rAU, u_s, v_s, w_s)
            rdiag_p = run(self.factor, dp, offp)
            Pp = RBDilu(rdiag_p, self.red)
            res_p = pbicgstab_regions(ex, self.solver_regions,
                                      DiaMatrix(dp, offp), rp,
                                      torch.zeros_like(rp), Pp,
                                      tol=cfg.tol_p, max_iter=cfg.inner_max)
            p_corr = res_p.x
            # --- momentum corrector ----------------------------------
            gpx, gpy, gpz = run(self.grad_p, p_corr)
            u_s, v_s, w_s = run(self.correct_u, u_s, v_s, w_s, rAU,
                                gpx, gpy, gpz)
            p = run(self.relax_p, p, p_corr)
        new = SimpleState(u_s, v_s, w_s, p, st.step + 1)
        metrics = {
            "res_u": res_u.final_residual, "iters_u": res_u.iters,
            "res_p": res_p.final_residual, "iters_p": res_p.iters,
        }
        return new, metrics

    def run_steps(self, st: SimpleState, n: int) -> tuple:
        """Returns (state, fom_seconds_per_step, metrics_last)."""
        t0 = time.perf_counter()
        m = {}
        for _ in range(n):
            st, m = self.time_step(st)
        fom = (time.perf_counter() - t0) / n
        return st, fom, m

    # -- captured-program path (repro_torch.core.program) -------------
    def capture_step(self, st: SimpleState):
        """Record one SIMPLE time-step as a
        :class:`~repro_torch.core.program.RegionProgram`.

        The step executes eagerly during capture, with the variants the
        app executor's selector picks (so on the card it launches the
        kernels its replays will launch), and inner solver loops run to
        their real convergence on ``st``; iteration counts and residual
        scalars are frozen into the trace, CUDA-graph style.  The trace
        replays under any policy, synchronously or overlapped by
        :class:`~repro_torch.core.program.AsyncExecutor`.  Capture stages
        nothing, so it runs on ``st`` moved to the grid's device (under the
        discrete policy a step hands its fields back in host pages)."""
        class _Rec:                   # quacks like an Executor for time_step
            def __init__(self, run):
                self.run = run

        st = SimpleState(*(getattr(st, f).to(self.cfg.grid.device)
                           for f in "uvwp"), st.step)

        def step_fn(run, u, v, w, p):
            new, _ = self.time_step(SimpleState(u, v, w, p, st.step),
                                    executor=_Rec(run))
            return (new.u, new.v, new.w, new.p)

        return capture(step_fn, st.u, st.v, st.w, st.p, name="simple_step",
                       selector=self.ex.policy.selector)

    def replay_steps(self, prog, st: SimpleState, n: int,
                     executor) -> tuple:
        """Replay a captured step ``n`` times, chaining the state through.
        Returns (state, seconds per step)."""
        t0 = time.perf_counter()
        for _ in range(n):
            u, v, w, p = prog.replay(executor, st.u, st.v, st.w, st.p)
            st = SimpleState(u, v, w, p, st.step + 1)
        return st, (time.perf_counter() - t0) / n

    def calibrate_cutoff(self, policy, sizes=AMUL_LADDER,
                         reps: int = 20) -> int:
        """Calibrate an :class:`~repro_torch.core.regions.AdaptivePolicy`'s
        cutoff on this app's ``Amul`` region over cubes of the grid's
        device, each with the Laplacian's coefficients.  ``sizes`` are
        region sizes (``6 * cells``: the largest operand is the six
        off-diagonals); the cutoff lands on the ``Amul`` ledger row."""
        device = self.cfg.grid.device

        def make_args(n):
            side = round((n / 6) ** (1 / 3))
            if 6 * side ** 3 != n:
                raise ValueError(f"calibration size {n} is not 6 * a cube")
            A, _ = fvm.laplacian(Grid((side,) * 3, device=device), 1.0)
            return A.diag, A.off, torch.ones_like(A.diag)

        return policy.calibrate(self.solver_regions.amul, make_args,
                                sizes=sizes, reps=reps, ledger=self.ledger)
