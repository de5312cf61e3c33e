#!/usr/bin/env python3
"""Drive the PyTorch port (openifem_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero before the
last line is printed:
  0. the device (torch's name, and nvidia-smi's name and power limit);
  1. build the element-matvec kernel from csrc/ (nvcc, sm_90a);
  2. every kernel layout against its plain PyTorch version on the card, at
     the fsi_leaflet shapes, in f64 (<= 1e-12) and f32 (<= 1e-5), with
     CUDA-event timings (median of 50);
  3. the coarse leaflet (h = 0.1, refinements [0, 1]) for 3 steps on CUDA
     and on the CPU: fluid solution and solid displacement within rtol
     1e-6, equal Newton counts;
  4. the coupled fsi_leaflet at the reference size (17,249 dofs) for 10
     steps on CUDA (host first step + 9 coupled steps): finite, leaflet
     pushed downstream (1e-4 < max d_x < 0.5), every kernel layout of the
     path launched.
Then a JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.  Exits non-zero, and prints no result,
when no CUDA device is present.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SOURCE = "openifem_tpu_torch/csrc/element_matvec.cu"
REPLACES = "openifem_tpu/la/pallas_ops.py:64"
# the layouts that the main path launches; element_matvec_rect (the flat
# B / B^T layout of solvers not ported yet) is checked in phase 2 only
PATH_LAYOUTS = ("element_matvec_taylor_hood", "element_matvec_nodeblock",
                "element_matvec_u_to_p_nodeblock",
                "element_matvec_p_to_u_nodeblock", "element_matvec")
TOL = {"float64": 1e-12, "float32": 1e-5}


def say(msg):
    print(msg, flush=True)


def phase0_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"phase 0: device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(smi)
    return smi


def phase1_build():
    from openifem_tpu_torch.la import cuda_ops
    t0 = time.perf_counter()
    cuda_ops.build()
    say(f"phase 1: built {os.path.basename(cuda_ops.library_path())} in "
        f"{cuda_ops.build_seconds:.2f} s (nvcc; {time.perf_counter() - t0:.2f}"
        " s with hashing)")


def _leaflet_solvers(device, h, refinements, n_steps):
    from openifem_tpu_torch.cases.fsi_leaflet import (inflow, leaflet_fields,
                                                      leaflet_meshes)
    from openifem_tpu_torch.fsi import FSI
    from openifem_tpu_torch.mesh import generators
    from openifem_tpu_torch.parameters import AllParameters
    from openifem_tpu_torch.solvers.fluid import InsIM
    from openifem_tpu_torch.solvers.solid import HyperElasticity
    p = AllParameters(**leaflet_fields(h=h, refinements=refinements,
                                       n_steps=n_steps))
    fm, sm = leaflet_meshes(generators, h)
    fluid = InsIM(fm, p, bc=inflow, device=device)
    solid = HyperElasticity(sm, p, device=device)
    return FSI(fluid, solid, p, use_dirichlet_bc=True)


def _median_ms(torch, fn, reps=50):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def full_size_solvers():
    """The full-size leaflet's fluid and solid, set up on CUDA (their
    dof tables give the kernels' shapes)."""
    fsi = _leaflet_solvers("cuda", 0.05, (0, 2), 10)
    fl, so = fsi.fluid, fsi.solid
    gr = fsi.params.global_refinements
    fl.mesh = fl.mesh.refine_global(gr[0])
    fl.setup()
    so.mesh = so.mesh.refine_global(gr[1])
    so.setup()
    return fl, so


def kernel_cases(torch, fl, so, dt, gen):
    """{name: (kernel call, plain call)} for every layout, on random
    operands from `gen` at the shapes of the solvers' tables."""
    from openifem_tpu_torch.la import operators as ops
    d, nlu, nu = fl.dim, fl.nlu, fl.nu_loc
    n_c = fl.mesh.n_cells
    cn_u, cd_u, cd_p, cd = (fl.cell_nodes_u, fl.cell_dofs_u, fl.cell_dofs_p,
                            fl.cell_dofs)
    n_un = fl.n_u // d

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)
    A = rnd(n_c, fl.nu_loc + fl.nlp, fl.nu_loc + fl.nlp)
    x = rnd(fl.n_dofs)
    xu, xp = x[:fl.n_u].contiguous(), x[fl.n_u:].contiguous()
    Auu_b = A[:, :nu, :nu].reshape(n_c, nlu, d, nlu, d)
    Apu = A[:, nu:, :nu]
    Aup_b = A[:, :nu, nu:].reshape(n_c, nlu, d, fl.nlp)
    Mp = rnd(n_c, fl.nlp, fl.nlp)
    As = rnd(so.mesh.n_cells, 8, 8)
    xs = rnd(so.n_dofs)
    return {
        "element_matvec_taylor_hood": (
            lambda: ops.element_matvec_taylor_hood(
                A, cn_u, cd_p, nlu, d, fl.n_u, fl.n_p, x, cell_dofs=cd),
            lambda: ops.element_matvec_taylor_hood_plain(
                A, cn_u, cd_p, nlu, d, fl.n_u, fl.n_p, x)),
        "element_matvec_nodeblock": (
            lambda: ops.element_matvec_nodeblock(Auu_b, cn_u, n_un, xu),
            lambda: ops.element_matvec_nodeblock_plain(Auu_b, cn_u, n_un,
                                                       xu)),
        "element_matvec_u_to_p_nodeblock": (
            lambda: ops.element_matvec_u_to_p_nodeblock(
                Apu.reshape(n_c, fl.nlp, nlu, d), cn_u, cd_p, fl.n_p, xu),
            lambda: ops.element_matvec_u_to_p_nodeblock_plain(
                Apu.reshape(n_c, fl.nlp, nlu, d), cn_u, cd_p, fl.n_p, xu)),
        "element_matvec_p_to_u_nodeblock": (
            lambda: ops.element_matvec_p_to_u_nodeblock(
                Aup_b, cn_u, cd_p, n_un, xp),
            lambda: ops.element_matvec_p_to_u_nodeblock_plain(
                Aup_b, cn_u, cd_p, n_un, xp)),
        "element_matvec": (
            lambda: ops.element_matvec(Mp, cd_p, fl.n_p, xp),
            lambda: ops.element_matvec_plain(Mp, cd_p, fl.n_p, xp)),
        "element_matvec[solid]": (
            lambda: ops.element_matvec(As, so.cell_dofs, so.n_dofs, xs),
            lambda: ops.element_matvec_plain(As, so.cell_dofs, so.n_dofs,
                                             xs)),
        "element_matvec_rect": (
            lambda: ops.element_matvec_rect(Apu, cd_p, cd_u, fl.n_p, xu),
            lambda: ops.element_matvec_rect_plain(Apu, cd_p, cd_u, fl.n_p,
                                                  xu)),
    }


def phase2_kernels(torch):
    """Kernel vs plain at the shapes of the full-size leaflet's tables."""
    from openifem_tpu_torch.la import cuda_ops
    fl, so = full_size_solvers()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for dt in (torch.float64, torch.float32):
        cases = kernel_cases(torch, fl, so, dt, gen)
        name_dt = str(dt).replace("torch.", "")
        for name, (kern, plain) in cases.items():
            y, yp = kern(), plain()
            torch.cuda.synchronize()
            abs_err = (y - yp).abs().max().item()
            rel = abs_err / yp.abs().max().item()
            ms = _median_ms(torch, kern)
            plain_ms = _median_ms(torch, plain)
            ok = rel <= TOL[name_dt]
            say(f"phase 2: {name} {name_dt} {tuple(y.shape)}: rel err "
                f"{rel:.3e} (tol {TOL[name_dt]:.0e}) abs err {abs_err:.3e}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"{name} {name_dt} disagrees with its "
                                     f"plain version: {rel:.3e}")
            results[(name, name_dt)] = dict(max_abs_err=abs_err, ms=ms,
                                            plain_ms=plain_ms)
    cuda_ops.reset_launches()
    return results


def _run_leaflet(device, h, refinements, n_steps):
    import torch
    fsi = _leaflet_solvers(device, h, refinements, n_steps)
    t0 = time.perf_counter()
    fsi.run(verbose=False)
    if device == "cuda":
        torch.cuda.synchronize()
    return fsi, time.perf_counter() - t0


def _counts(fsi):
    return [(s["solid_newton"], s["fluid_newton"]) for s in fsi.step_log]


def phase3_coarse(torch):
    gpu, t_gpu = _run_leaflet("cuda", 0.1, (0, 1), 3)
    cpu, t_cpu = _run_leaflet("cpu", 0.1, (0, 1), 3)
    errs = {}
    for name, a, b in (
            ("fluid solution", gpu.fluid.present_solution,
             cpu.fluid.present_solution),
            ("solid displacement", gpu.solid.current_displacement,
             cpu.solid.current_displacement)):
        a, b = a.cpu(), b
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
    same = _counts(gpu) == _counts(cpu)
    ok = same and all(e <= 1e-6 for e in errs.values())
    say(f"phase 3: coarse leaflet 3 steps ({gpu.fluid.n_dofs} + "
        f"{gpu.solid.n_dofs} dofs), CUDA vs CPU: "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in errs.items())
        + f" (rtol 1e-6); Newton (solid, fluid) per step CUDA {_counts(gpu)}"
        f" CPU {_counts(cpu)}; {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("coarse leaflet: CUDA and CPU runs disagree")


def phase4_full(torch):
    from openifem_tpu_torch.la import cuda_ops
    cuda_ops.reset_launches()
    fsi, seconds = _run_leaflet("cuda", 0.05, (0, 2), 10)
    launches = dict(cuda_ops.launches)
    fl, so = fsi.fluid, fsi.solid
    n_dofs = fl.n_dofs + so.n_dofs
    u = fl.present_solution
    dsp = so.current_displacement.reshape(-1, 2)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        u, fl.stress_device, so.current_displacement, so.current_velocity,
        so.current_acceleration))
    max_dx = dsp[:, 0].max().item()
    coupled = [s for s in fsi.step_log if s["coupled"]]
    for s in fsi.step_log:
        say(f"phase 4: step {s['step']} "
            f"{'coupled' if s['coupled'] else 'host first step'}: "
            f"{1e3 * s['seconds']:.1f} ms, Newton solid {s['solid_newton']} "
            f"fluid {s['fluid_newton']}, Krylov {s['krylov']}")
    ms = [1e3 * s["seconds"] for s in coupled]
    missing = [k for k in PATH_LAYOUTS if launches[k] <= 0]
    ok = (finite and 1e-4 < max_dx < 0.5 and not missing and n_dofs == 17249
          and len(coupled) == 9)
    say(f"phase 4: fsi_leaflet {fl.n_dofs} + {so.n_dofs} = {n_dofs} dofs, "
        f"10 steps in {seconds:.2f} s; coupled steps {len(coupled)}, "
        f"{statistics.mean(ms):.1f} ms/step mean, "
        f"{statistics.median(ms):.1f} median; finite {finite}, max d_x "
        f"{max_dx:.4e}; launches "
        f"{ {k: launches[k] for k in PATH_LAYOUTS} } "
        f"{'ok' if ok else 'FAILED'} (element_matvec_rect, the flat B/B^T "
        f"layout, is off this path: {launches['element_matvec_rect']} "
        "launches; phase 2 checks it)")
    if not ok:
        raise AssertionError(
            f"full leaflet failed: finite={finite} max_dx={max_dx} "
            f"n_dofs={n_dofs} coupled={len(coupled)} unlaunched={missing}")
    return launches


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch
    phase0_device(torch)
    # raises ImportError when the script runs outside the repository
    import openifem_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the solids write their first-step VTU output to the working directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        os.chdir(work)
        phase1_build()
        times = phase2_kernels(torch)
        phase3_coarse(torch)
        launches = phase4_full(torch)
        os.chdir(root)
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES, launches=launches[name],
                    **times[(name, "float64")]) for name in PATH_LAYOUTS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
