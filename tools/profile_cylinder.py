#!/usr/bin/env python3
"""Where one time step of the port's standalone fluid goes, on one CUDA
GPU: a cylinder configuration of cases/fluid_cylinder.py ("r3" or "r4")
through InsIM's stepper.

    python3 tools/profile_cylinder.py [--config r4] [--steps 2]

After the configuration's start (host first step or impulsive start, and
its warm-up window, as chip_smoke.py phase 9 runs it), three windows:
  1. plain: `--steps` steps, host clock, one synchronise at the end;
  2. phase timers: the same window with synchronising timers around the
     solver's phases (assembly, preconditioner build, outer FGMRES, and
     inside one preconditioner apply the Mp CG, the Schur solve, B^T and
     the inner A solve with its stencil applies).  The timers nest; each
     is printed as a share of the window.  Their synchronisations slow
     the window down, so the shares are read against this window's own
     time, not the plain one's;
  3. profiled: one step under torch.profiler (CPU and CUDA activities):
     device busy time (the sum of the device kernels' durations), the idle
     share 1 - busy / wall, and the kernels that take the most device time.
Prints one JSON line per window.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

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

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def _window(torch, stepper, sol, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, rel, it = stepper(sol, n)
    torch.cuda.synchronize()
    return sol, rel, it, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="r4", choices=("r3", "r4"))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile is of the card")
    import chip_smoke as cs
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import krylov
    from openifem_tpu_torch.solvers.fluid import insim
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    run = cs.CYLINDER_RUNS[args.config]
    fl = fc.cylinder_case(fc.port_package(), args.config, n_steps=100,
                          device="cuda")
    if run["host_first"]:
        fl.run_one_step(True, verbose=False)
    else:
        fl.present_solution = fl.nonzero_constraints.apply_increment(
            fl.present_solution)
        fl.time.increment()
    stepper = fl.make_on_device_stepper()
    sol, _, _, warm_s = _window(torch, stepper, fl.present_solution,
                                run["warm"])
    base = dict(config=args.config, dofs=fl.n_dofs, device=smi)

    def counts(k0):
        return {n: v - k0[n] for n, v in fl.krylov_iters.items()}

    k0 = dict(fl.krylov_iters)
    sol, rel, it, plain_s = _window(torch, stepper, sol, args.steps)
    print(json.dumps(dict(base, window="plain", steps=args.steps,
                          ms_per_step=1e3 * plain_s / args.steps,
                          warm_up_s=warm_s, worst_rel=rel, newton=it,
                          krylov=counts(k0))), flush=True)

    tm = SyncTimers(torch)
    tm.wrap(fl, "_assemble", "assemble")
    tm.wrap(fl, "_make_preconditioner", "preconditioner build")
    tm.wrap(krylov, "fgmres", "outer FGMRES")   # base._outer_solve's import
    tm.wrap(insim, "cg", "Mp CG (and Schur CG)")
    tm.wrap(insim, "fgmres", "inner A FGMRES")
    tm.wrap(insim, "element_matvec_taylor_hood", "outer Jacobian apply")
    tm.wrap(insim, "element_matvec_p_to_u_nodeblock", "B^T apply")
    tm.wrap(fl._pressure_mg, "vcycle", "pressure V-cycle")
    tm.wrap(fl._u_stencil, "condensed_matvec", "stencil condensed_matvec")
    k0 = dict(fl.krylov_iters)
    sol, rel, it, timed_s = _window(torch, stepper, sol, args.steps)
    tm.restore()
    print(json.dumps(dict(
        base, window="phase timers", steps=args.steps,
        ms_per_step=1e3 * timed_s / args.steps, krylov=counts(k0),
        share={n: round(s / timed_s, 4) for n, s in sorted(
            tm.seconds.items(), key=lambda kv: -kv[1])},
        calls=dict(tm.calls))), flush=True)

    from torch.profiler import ProfilerActivity, profile
    k0 = dict(fl.krylov_iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sol, rel, it, prof_s = _window(torch, stepper, sol, 1)
    by_name, busy_us, n_kernels = defaultdict(float), 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name[:90]] += us
            busy_us += us
            n_kernels += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps(dict(
        base, window="profiled", steps=1, wall_ms=1e3 * prof_s,
        busy_ms=busy_us / 1e3, device_kernels=n_kernels,
        idle_share_profiled=1 - busy_us / 1e6 / prof_s,
        idle_share_against_plain_step=1 - busy_us / 1e6 / (
            plain_s / args.steps),
        krylov=counts(k0),
        top_kernels_ms={n: round(us / 1e3, 2) for n, us in top})),
        flush=True)


if __name__ == "__main__":
    main()
