#!/usr/bin/env python3
"""Where one time step of the port's standalone fluid goes, on one CUDA
GPU: a cylinder configuration of cases/fluid_cylinder.py through its
stepper ("r3" or "r4": InsIM; "scnsim": SCnsIM at refine 3 with the bench
knobs, as chip_smoke.py phase 12 runs it), "scnsex": SCnsEX on the
acoustic duct of cases/acoustic_duct.py (3,315 dofs, phase 13), or
"wall3d": the coupled fsi-wall-3D step of cases/fsi_wall_3d.py at full
resolution with the bench knobs (45,207 dofs, phase 15).

    python3 tools/profile_cylinder.py [--config r4] [--steps 2]

After the configuration's start (host first step or impulsive start, and
its warm-up window, as chip_smoke.py runs it), three windows:
  1. plain: `--steps` steps, host clock, one synchronise at the end;
  2. phase timers: the same window with synchronising timers around the
     solver's phases (assembly, preconditioner build, outer FGMRES, and
     inside one preconditioner apply the Mp CG, the Schur solve, B^T and
     the inner A solve with its stencil applies; for "scnsim" the Tpp
     GMRES, GalerkinMG.build, its V-cycle and the coupled stencil's
     applies; for "scnsex" the sweeps, their CGs and element matvecs;
     for "wall3d" the coupled step's solid RK4, coupling and fluid
     Newton parts (through MPIFSI.step_span), the assembly, the preconditioner build with its condensed dense blocks
     (the rest of the build is the dense Tpp product), the outer FGMRES
     and the Tpp GMRES).
     The timers nest; each
     is printed as a share of the window.  Their synchronisations slow
     the window down, so the shares are read against this window's own
     time, not the plain one's;
  3. profiled: one step under torch.profiler (CPU and CUDA activities):
     device busy time (the sum of the device kernels' durations), the idle
     share 1 - busy / wall, and the kernels that take the most device time.
     For "scnsim" the profiled window is ONE preconditioner apply at the
     stepped state (one Tpp solve: a whole step is about a hundred times
     that many device kernels, more than the profiler holds), for "scnsex"
     five steps; for "wall3d" one coupled step.
Prints one JSON line per window.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SyncTimers:
    """Synchronising wall timers that wrap attributes in place."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._undo = []

    def wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def wrap_result(self, owner, attr, name):
        """Time the function that owner.attr() returns (a closure built
        per call, as GalerkinMG.build's V-cycle)."""
        fn = getattr(owner, attr)

        def build(*args, **kw):
            holder = type("Built", (), {})()
            holder.fn = fn(*args, **kw)
            self.wrap(holder, "fn", name)
            self._undo.pop()              # nothing to restore on a holder
            return holder.fn
        setattr(owner, attr, build)
        self._undo.append((owner, attr, fn))

    @contextmanager
    def span(self, name):
        """A synchronising timer around a block."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def hook(self, owner, attr):
        """Set owner.attr, a span hook, to self.span until restore()."""
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, self.span)

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def _insim(torch, config):
    """(solver, advance, timers) of an InsIM cylinder configuration after
    its start; advance(n) steps n times and returns (worst rel res, worst
    Newton count)."""
    import chip_smoke as cs
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import krylov
    from openifem_tpu_torch.solvers.fluid import insim
    run = cs.CYLINDER_RUNS[config]
    fl = fc.cylinder_case(fc.port_package(), config, n_steps=100,
                          device="cuda")
    if run["host_first"]:
        fl.run_one_step(True, verbose=False)
    else:
        fl.present_solution = fl.nonzero_constraints.apply_increment(
            fl.present_solution)
        fl.time.increment()
    stepper = fl.make_on_device_stepper()
    state = [fl.present_solution]

    def advance(n):
        state[0], rel, it = stepper(state[0], n)
        return rel, it

    def timers(tm):
        tm.wrap(fl, "_assemble", "assemble")
        tm.wrap(fl, "_make_preconditioner", "preconditioner build")
        tm.wrap(krylov, "fgmres", "outer FGMRES")   # _outer_solve's import
        tm.wrap(insim, "cg", "Mp CG (and Schur CG)")
        tm.wrap(insim, "fgmres", "inner A FGMRES")
        tm.wrap(insim, "element_matvec_taylor_hood", "outer Jacobian apply")
        tm.wrap(insim, "element_matvec_p_to_u_nodeblock", "B^T apply")
        tm.wrap(fl._pressure_mg, "vcycle", "pressure V-cycle")
        tm.wrap(fl._u_stencil, "condensed_matvec",
                "stencil condensed_matvec")
    return fl, advance, timers, run["warm"], lambda: advance(1)


def _scnsim(torch, steps):
    """SCnsIM on the cylinder at refine 3 with the bench knobs, after the
    host first step (the inflow pulse)."""
    import chip_smoke as cs
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import krylov
    from openifem_tpu_torch.solvers.fluid import supg
    fl = fc.scnsim_case(fc.port_package(), n_steps=100, device="cuda")
    fl.run_one_step(True, verbose=False)
    fl.bc_time += fl.time.get_delta_t()
    table = fl.bc_value_table(cs.SCNSIM_WARM + 2 * steps)
    stepper = fl.make_on_device_stepper(table)
    state = [fl.present_solution, fl.stress_device, 0]

    def advance(n):
        sol, stress, rel, it = stepper(state[0], state[1], n, state[2])
        state[:] = [sol, stress, state[2] + n]
        return rel, it

    def timers(tm):
        tm.wrap(fl, "_assemble", "assemble")
        tm.wrap(fl, "_make_preconditioner", "preconditioner build")
        tm.wrap_result(fl._pressure_mg, "build", "Galerkin V-cycle")
        tm.wrap(fl._pressure_mg, "build", "GalerkinMG.build")
        tm.wrap(krylov, "fgmres", "outer FGMRES")   # _outer_solve's import
        tm.wrap(supg, "fgmres", "Tpp GMRES")
        tm.wrap(fl._sys_stencil, "build_weights", "stencil build_weights")
        tm.wrap(fl._sys_stencil, "matvec", "stencil matvec (all slices)")
        tm.wrap(fl, "_update_stress_impl", "nodal stress update")

    def one_apply():
        """One preconditioner apply at the stepped state."""
        sol, stress = state[0], state[1]
        A_loc, rhs = fl._assemble(sol, sol, fl.indicator, fl.fsi_acc_nodal,
                                  fl.fsi_stress_nodal, stress,
                                  fl._eddy_nodal())
        b = fl.zero_constraints.condense_rhs(rhs)
        P = fl._make_preconditioner(A_loc, fl.u_constraints,
                                    fl.p_constraints)
        v = b / torch.linalg.vector_norm(b)
        P(v)                                  # warm: allocations, plans
        torch.cuda.synchronize()
        return lambda: P.stats(v)[1]
    return fl, advance, timers, cs.SCNSIM_WARM, one_apply


def _scnsex(torch, steps):
    """SCnsEX on the acoustic duct, from rest; every window gets the rows
    of the BC table that follow the steps already taken."""
    from openifem_tpu_torch.cases import acoustic_duct as ad
    from openifem_tpu_torch.solvers.fluid import scnsex
    fl = ad.duct_case(ad.port_package(), "SCnsEX", n_steps=1000,
                      device="cuda")
    fl._refine_and_setup()
    table = fl.bc_value_table(10 + 2 * steps + 5)
    state = [fl.present_solution, 0]

    def advance(n):
        stepper = fl.make_on_device_stepper(table[state[1]:])
        sol, rel, it = stepper(state[0], n)
        state[:] = [sol, state[1] + n]
        return rel, it

    def timers(tm):
        tm.wrap(fl, "_iterate_impl", "sweep")
        tm.wrap(scnsex, "cg", "CG (velocity and pressure)")
        tm.wrap(scnsex, "element_matvec", "element_matvec")
        tm.wrap(scnsex, "scatter_add", "rhs scatter_add")
    return fl, advance, timers, 10, lambda: advance(5)


def _wall3d(torch, steps):
    """fsi-wall-3D at full resolution after MPIFSI.run's set-up and host
    first step (run with one step); advance(n) takes n coupled steps."""
    from openifem_tpu_torch.cases import fsi_wall_3d as fw
    from openifem_tpu_torch.la import dense, krylov
    from openifem_tpu_torch.solvers.fluid import supg
    fsi = fw.wall3d_case(fw.port_package(), n_steps=1, device="cuda")
    fsi.run(verbose=False)
    fl, so = fsi.fluid, fsi.solid

    def advance(n):
        for _ in range(n):
            fsi.run_one_coupled_step()      # raises unless converged
            fsi.time.increment()
        return 0.0, fl.newton_iters
    advance.solid_dofs = so.n_dofs

    def timers(tm):
        # the coupled step's solid RK4, coupling and fluid Newton parts
        tm.hook(fsi, "step_span")
        tm.wrap(fl, "_assemble", "assembly")
        tm.wrap(fl, "_make_preconditioner", "preconditioner build")
        tm.wrap(dense, "condensed_dense", "condensed dense blocks")
        tm.wrap(krylov, "fgmres", "outer FGMRES")   # _outer_solve's import
        tm.wrap(supg, "fgmres", "Tpp GMRES")
        tm.wrap(fl, "_update_stress_impl", "nodal stress update")
    return fl, advance, timers, 1, lambda: advance(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="r4",
                    choices=("r3", "r4", "scnsim", "scnsex", "wall3d"))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile is of the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.config == "scnsim":
        fl, advance, timers, warm, profiled = _scnsim(torch, args.steps)
    elif args.config == "scnsex":
        fl, advance, timers, warm, profiled = _scnsex(torch, args.steps)
    elif args.config == "wall3d":
        fl, advance, timers, warm, profiled = _wall3d(torch, args.steps)
    else:
        fl, advance, timers, warm, profiled = _insim(torch, args.config)

    def window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rel, it = advance(n)
        torch.cuda.synchronize()
        return rel, it, time.perf_counter() - t0

    _, _, warm_s = window(warm)
    # fluid dofs, and the solid's in a coupled configuration
    base = dict(config=args.config, device=smi,
                dofs=fl.n_dofs + getattr(advance, "solid_dofs", 0))

    def counts(k0):
        return {n: v - k0[n] for n, v in fl.krylov_iters.items()}

    k0 = dict(fl.krylov_iters)
    rel, it, plain_s = window(args.steps)
    print(json.dumps(dict(base, window="plain", steps=args.steps,
                          ms_per_step=1e3 * plain_s / args.steps,
                          warm_up_s=warm_s, worst_rel=rel, newton=it,
                          krylov=counts(k0))), flush=True)

    tm = SyncTimers(torch)
    timers(tm)
    k0 = dict(fl.krylov_iters)
    rel, it, timed_s = window(args.steps)
    tm.restore()
    print(json.dumps(dict(
        base, window="phase timers", steps=args.steps,
        ms_per_step=1e3 * timed_s / args.steps, krylov=counts(k0),
        share={n: round(s / timed_s, 4) for n, s in sorted(
            tm.seconds.items(), key=lambda kv: -kv[1])},
        calls=dict(tm.calls))), flush=True)

    from torch.profiler import ProfilerActivity, profile
    k0 = dict(fl.krylov_iters)
    if args.config == "scnsim":
        profiled = profiled()               # builds the preconditioner
    what = {"scnsim": "one preconditioner apply", "scnsex": "5 steps"}.get(
        args.config, "1 step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiled()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    by_name, busy_us, n_kernels = defaultdict(float), 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name[:90]] += us
            busy_us += us
            n_kernels += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps(dict(
        base, window="profiled", what=what, wall_ms=1e3 * prof_s,
        busy_ms=busy_us / 1e3, device_kernels=n_kernels,
        idle_share_profiled=1 - busy_us / 1e6 / prof_s,
        idle_share_against_plain_step=None if args.config in (
            "scnsim", "scnsex") else 1 - busy_us / 1e6 / (
                plain_s / args.steps),
        krylov=counts(k0),
        top_kernels_ms={n: round(us / 1e3, 2) for n, us in top})),
        flush=True)


if __name__ == "__main__":
    main()
