#!/usr/bin/env python3
"""Time the element-matvec kernel of one checkout of the PyTorch port at
the full-size leaflet's shapes on one CUDA GPU: chip_smoke.py's phase-2
cases (1,780 fluid cells, 256 solid cells, f64 and f32), or with --r2
its phase-7 cases (path B: the r2 fluid's 25,600 cells and the pressure
V-cycle's levels, f32), with chip_smoke.py's timing: device us per launch (CUDA events
around back-to-back launches queued behind a sleep kernel) and host us
per call (500 enqueues); and, from torch.profiler over 200 calls, the
device kernels per call and their summed execution time per call
(kernel_us: what the card spends inside kernels, without the gaps
between launches that the event time includes).

    python3 tools/time_element_matvec.py [--root DIR] [--label NAME] [--r2]

--root is the checkout whose openifem_tpu_torch is timed (default: this
one).  The timing code is always this checkout's chip_smoke.py, so two
versions of the kernel are timed the same way when the script runs once
per checkout on one machine (in turns: A, B, B, A).  Prints one JSON line
per (layout, operator, dtype).
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--r2", action="store_true",
                    help="path B's shapes instead of the 1,780-cell ones")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs only on a GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import openifem_tpu_torch
    if not openifem_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {openifem_tpu_torch.__file__}, not the "
                         f"port under {root}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for dt, cases in (_r2_cases(torch, cs, gen) if args.r2 else
                      _leaflet_cases(torch, cs, gen)):
        for layout, n_c, what, kern, _ in cases:
            kern()
            torch.cuda.synchronize()
            host_us = cs._host_us(torch, kern)
            kernels, kernel_us = _profiled(torch, kern)
            print(json.dumps(dict(
                label=args.label, layout=layout, what=what,
                dtype=cs._dt_name(dt), n_cells=n_c,
                device_us=cs._device_us(torch, kern, host_us),
                host_us=host_us, kernels_per_call=kernels,
                kernel_us=kernel_us)), flush=True)


def _leaflet_cases(torch, cs, gen):
    fl, so = cs.full_size_solvers()
    return [(dt, cs.kernel_cases(torch, fl, so, dt, gen))
            for dt in (torch.float64, torch.float32)]


def _r2_cases(torch, cs, gen):
    """Path B's cases as chip_smoke's phase 7 checks them, on the r2
    configuration set up as FSI.run sets it up."""
    fsi = cs._leaflet_solvers("cuda", cs.FULL_H, (0, 2), 4, "fsi_leaflet_r2",
                              extra_refine=2)
    fl, so, gr = fsi.fluid, fsi.solid, fsi.params.global_refinements
    so.mesh = so.mesh.refine_global(gr[1])
    so.setup()
    fl.mesh = fl.mesh.refine_global(gr[0])
    fl.setup()
    fsi._enable_fluid_mg()
    cases = cs.kernel_cases(torch, fl, so, torch.float32, gen,
                            fl._pressure_mg.levels)
    return [(torch.float32, [c for c in cases if c[0] in cs.PATH_B_LAYOUTS
                             and c[2] != "solid"])]


def _profiled(torch, fn, reps=200):
    """(device kernels per call, their execution us per call) over
    `reps` calls, from torch.profiler's device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(events) / reps,
            sum(e.time_range.elapsed_us() for e in events) / reps)


if __name__ == "__main__":
    main()
