#!/usr/bin/env python3
"""Drive the PyTorch port (openifem_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero before the
last line is printed:
  0. the device (torch's name, and nvidia-smi's name and power limit);
  1. build the element-matvec kernel from csrc/ (nvcc, sm_90a);
  2. every kernel layout against its plain PyTorch version on the card, at
     the fsi_leaflet shapes (the element path's and path A's), in f64
     (<= 1e-12) and f32 (<= 1e-5); repeated launches bitwise equal; per
     shape the device time (CUDA events around 200 back-to-back launches
     queued behind a sleep kernel, so the host's enqueue rate is not
     timed), the host time (500 enqueues), the bound (bytes or operations
     over the card's peak) and the time of a cuSPARSE CSR product of the
     same assembled blocks (timed only; the port never calls it);
  3. the coarse leaflet (h = 0.1, refinements [0, 1]) on the element-
     matvec preconditioner branch for 3 steps on CUDA and on the CPU:
     fluid solution and solid displacement within rtol 1e-6, equal Newton
     counts;
  4. that branch at the reference size (17,249 dofs) for 10 steps on CUDA
     (host first step + 9 coupled steps): finite, leaflet pushed
     downstream (1e-4 < max d_x < 0.5), all five layouts launched;
  5. the coarse versions of the two bench configurations, f64 knobs,
     CUDA vs CPU as in phase 3: the dense preconditioner (h = 0.1), and
     the stencil + pressure V-cycle + mg_direct on a uniform channel
     (h = 0.1 refined once, 2 levels);
  6. path A, fsi_leaflet with the bench knobs (dense condensed
     preconditioner, bf16 A block, f32 Jacobian), 17,249 dofs, 10 steps:
     finite, 1e-4 < max d_x < 0.5, the dense branch taken, the Taylor-Hood
     layout launched in f32 and no element layout in the preconditioner;
     then the same run again, to show whether its Newton and Krylov
     counts repeat;
  7. path B, fsi_leaflet_r2 with the bench knobs (stencil patch layout,
     one pressure V-cycle as Sm^-1), 232,997 dofs, 4 steps: the same
     state checks, the patch-layout branch and no Schur CG iterations,
     Taylor-Hood, p->u and scalar layouts launched; then each of these
     layouts against its plain version as in phase 2, in f32, at path B's
     shapes: the r2 fluid's tables (25,600 cells) and every level of the
     pressure V-cycle on the level's own blocks; the Taylor-Hood shape
     (49.6 MB of f32 A, about the L2's size) also with a cold L2.
Phases 4, 6 and 7 print ms per coupled step, Newton and Krylov counts per
step, launches per coupled step and peak device memory, and fail if a
gather plan is built after the first coupled step.  The kernels count
their launches per (layout, dtype, number of cells); the script fails if
a main path launched a shape that phases 2 and 7 did not check.  Then a
JSON line with one entry per such shape (launches summed over phases 4,
6 and 7, and per coupled step of each path; error and times measured at
that shape) and the last line {"ok": true, ...}.
Exits non-zero, and prints no result, when no CUDA device is present.
"""

import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

SOURCE = "openifem_tpu_torch/csrc/element_matvec.cu"
REPLACES = "openifem_tpu/la/pallas_ops.py:64"
# the layouts that the element-matvec branch launches; element_matvec_rect
# (the flat B / B^T layout of solvers not ported yet) is checked in phase 2
# only
PATH_LAYOUTS = ("element_matvec_taylor_hood", "element_matvec_nodeblock",
                "element_matvec_u_to_p_nodeblock",
                "element_matvec_p_to_u_nodeblock", "element_matvec")
# path A: the outer Jacobian (f32) and the solid; the preconditioner is
# dense GEMVs.  Path B: the outer Jacobian, B^T in the preconditioner
# (p->u), Mp, the V-cycle levels and the solid (scalar); B (u->p) is used
# only by the Schur CG, which mg_direct replaces with the V-cycle.
PRECOND_ELEMENT = ("element_matvec_nodeblock",
                   "element_matvec_u_to_p_nodeblock",
                   "element_matvec_p_to_u_nodeblock")
PATH_B_LAYOUTS = ("element_matvec_taylor_hood",
                  "element_matvec_p_to_u_nodeblock", "element_matvec")
TOL = {"float64": 1e-12, "float32": 1e-5}
# the card's peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): HBM3
# bytes/s, and FP64 / FP32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
# back-to-back launches timed with CUDA events, enqueues timed on the host
DEVICE_REPS, HOST_REPS = 200, 500
# dofs (fluid + solid) of each configuration at full size (h = 0.05)
FULL_DOFS = {"element": 17249, "fsi_leaflet": 17249,
             "fsi_leaflet_r2": 232997}
FULL_H = 0.05


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


def _leaflet_solvers(device, h, refinements, n_steps, config="element",
                     **kw):
    from openifem_tpu_torch.cases.fsi_leaflet import (leaflet_case,
                                                      port_package)
    return leaflet_case(port_package(), config, h=h, refinements=refinements,
                        n_steps=n_steps, device=device, **kw)


def _host_us(torch, fn, reps=HOST_REPS):
    """Host time per call: the host clock over `reps` enqueues."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def _device_us(torch, fn, host_us, reps=DEVICE_REPS, flush=None):
    """Device time per call: CUDA events around `reps` back-to-back calls
    (one call when `flush` is given, after overwriting that buffer, which
    evicts the L2).  A sleep kernel ahead of the first event holds the
    card while the host queues the calls, so the events time the device
    and not the host's enqueue rate.  Until the host finished queueing
    before the card woke up, the sleep doubles and the calls halve (the
    CUDA launch queue holds about a thousand kernels, and a plain
    version launches a dozen per call)."""
    cycles = int(2e3 * host_us * reps * 2) + 10 ** 6   # >= 2x at <= 2 GHz
    for _ in range(8):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            return 1e3 * a.elapsed_time(b) / reps
        cycles, reps = 2 * cycles, max(1, reps // 2)
    raise AssertionError("the host never queued ahead of the card")


def _launch_args(fn):
    """Call fn once and return the arguments of the cuda_ops.launch it
    made, by name."""
    from openifem_tpu_torch.la import cuda_ops
    real, seen = cuda_ops.launch, []

    def record(*args, **kw):
        bound = inspect.signature(real).bind(*args, **kw)
        bound.apply_defaults()
        seen.append(bound.arguments)
        return real(*args, **kw)
    cuda_ops.launch = record
    try:
        fn()
    finally:
        cuda_ops.launch = real
    return seen[0]


def _bound(la):
    """(bound us, bytes, "bytes" or "operations") of one apply: A, the
    index tables the kernel reads, x and y each moved once, against the
    2 nr nc flops per cell."""
    A, x = la["A"], la["x"]
    n_c, nr, nc = A.shape[0], la["nr"], la["nc"]
    tables = [la["rows"]] + ([la["cols"]] if la["cols"] is not la["rows"]
                             else [])
    nbytes = (n_c * nr * nc * A.element_size()
              + sum(t.numel() * t.element_size() for t in tables)
              + (x.numel() + la["n_out"]) * x.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n_c * nr * nc / PEAK_FLOPS[_dt_name(x.dtype)]
    return (1e6 * max(t_bytes, t_ops), nbytes,
            "bytes" if t_bytes >= t_ops else "operations")


def _library(torch, la):
    """The same apply as one cuSPARSE CSR product: the blocks assembled
    once (sparse_coo_tensor -> coalesce -> CSR), returned as a call."""
    A, x, rows, cols = la["A"], la["x"], la["rows"], la["cols"]
    n_c, nr, nc, dr, dc = (A.shape[0], la["nr"], la["nc"], la["dr"],
                           la["dc"])
    blocks = torch.as_strided(A, (n_c, nr, nc),
                              (la["cell_stride"], la["row_stride"], 1))
    i = torch.arange(nr, device=A.device)
    k = torch.arange(nc, device=A.device)
    r = (rows.long()[:, i // dr] * dr + i % dr)[:, :, None].expand(-1, -1,
                                                                   nc)
    c = (cols.long()[:, k // dc] * dc + k % dc)[:, None, :].expand(-1, nr,
                                                                   -1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # sparse CSR is a beta API
        csr = torch.sparse_coo_tensor(
            torch.stack([r.reshape(-1), c.reshape(-1)]), blocks.reshape(-1),
            (la["n_out"], x.numel())).coalesce().to_sparse_csr()
    return lambda: csr @ x


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


def _dt_name(dt):
    return str(dt).replace("torch.", "")


def kernel_cases(torch, fl, so, dt, gen, levels=()):
    """[(layout, n_cells, operator, kernel call, plain call)]: every layout
    at the shapes of the fluid's and the solid's tables (random blocks from
    `gen`), and the scalar or node-block layout on each multigrid level's
    own blocks (cast to `dt`; random x)."""
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

    def pair(name, *args, **kw):
        return (lambda: getattr(ops, name)(*args, **kw),
                lambda: getattr(ops, name + "_plain")(*args))
    cases = [
        ("element_matvec_taylor_hood", n_c, "Jacobian",
         *pair("element_matvec_taylor_hood", A, cn_u, cd_p, nlu, d, fl.n_u,
               fl.n_p, x, cell_dofs=cd)),
        ("element_matvec_nodeblock", n_c, "A block",
         *pair("element_matvec_nodeblock", Auu_b, cn_u, n_un, xu)),
        ("element_matvec_u_to_p_nodeblock", n_c, "B",
         *pair("element_matvec_u_to_p_nodeblock",
               Apu.reshape(n_c, fl.nlp, nlu, d), cn_u, cd_p, fl.n_p, xu)),
        ("element_matvec_p_to_u_nodeblock", n_c, "B^T",
         *pair("element_matvec_p_to_u_nodeblock", Aup_b, cn_u, cd_p, n_un,
               xp)),
        ("element_matvec", n_c, "Mp",
         *pair("element_matvec", Mp, cd_p, fl.n_p, xp)),
        ("element_matvec", so.mesh.n_cells, "solid",
         *pair("element_matvec", As, so.cell_dofs, so.n_dofs, xs)),
        ("element_matvec_rect", n_c, "flat B",
         *pair("element_matvec_rect", Apu, cd_p, cd_u, fl.n_p, xu)),
    ]
    for i, lv in enumerate(levels):
        Al, xl = lv.A_loc.to(dt).contiguous(), rnd(lv.n)
        if lv.ncomp > 1:
            cases.append(("element_matvec_nodeblock", Al.shape[0],
                          f"MG level {i}", *pair(
                              "element_matvec_nodeblock", lv.A_block.to(dt),
                              lv.cell_nodes, lv.n // lv.ncomp, xl)))
        else:
            cases.append(("element_matvec", Al.shape[0], f"MG level {i}",
                          *pair("element_matvec", Al, lv.cell_dofs, lv.n,
                                xl)))
    return cases


def check_kernels(torch, label, cases, dt, results, cold=()):
    """Each case's kernel against its plain version (relative error to
    TOL[dt]) and against itself (repeated launches bitwise equal), with
    device, host, bound and library times; raises on a miss.  Cases whose
    `what` is in `cold` are also timed with a cold L2.  results[(layout,
    dtype, n_cells)] keeps, per shape, the case with the largest error."""
    from openifem_tpu_torch.la import cuda_ops
    name_dt = _dt_name(dt)
    for layout, n_c, what, kern, plain in cases:
        la = _launch_args(kern)
        K = cuda_ops._row_plan(la["rows"], la["n_out"], la["nr"], la["dr"],
                               la["x"].device)[1]
        y, yp = kern(), plain()
        torch.cuda.synchronize()
        abs_err = (y - yp).abs().max().item()
        rel = abs_err / yp.abs().max().item()
        host_us = _host_us(torch, kern)
        device_us = _device_us(torch, kern, host_us)
        plain_us = _device_us(torch, plain, _host_us(torch, plain, 50))
        library = _library(torch, la)
        lib_err = ((library() - yp).abs().max() / yp.abs().max()).item()
        library_us = _device_us(torch, library, _host_us(torch, library, 50))
        bound_us, nbytes, bound_by = _bound(la)
        cold_us = None
        if what in cold:
            flush = torch.empty(2 * 64 * 2 ** 20, dtype=torch.uint8,
                                device="cuda")
            cold_us = statistics.median(
                _device_us(torch, kern, host_us, reps=1, flush=flush)
                for _ in range(20))
            del flush
        bitwise = all(torch.equal(kern(), y) for _ in range(3))
        ok = rel <= TOL[name_dt] and bitwise
        say(f"{label}: {layout} ({what}, {n_c} cells) {name_dt} -> "
            f"{tuple(y.shape)}, plan K {K}: rel err {rel:.3e} (tol {TOL[name_dt]:.0e}) "
            f"abs err {abs_err:.3e}, repeats bitwise {bitwise}; device "
            f"{device_us:.3f} us (plain {plain_us:.3f}, CSR {library_us:.3f}"
            f", CSR rel err {lib_err:.1e}), bound {bound_us:.3f} us "
            f"({nbytes} B, {bound_by}; {100 * bound_us / device_us:.1f} %)"
            + (f", cold L2 {cold_us:.3f} us" if cold_us is not None else "")
            + f", host {host_us:.2f} us/call {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{layout} ({what}) {name_dt} disagrees "
                                 f"with its plain version ({rel:.3e}) or "
                                 f"with itself (bitwise {bitwise})")
        key = (layout, name_dt, n_c)
        if key not in results or rel > results[key]["rel"]:
            results[key] = dict(
                rel=rel, what=what, max_abs_err=abs_err,
                ms=device_us / 1e3, plain_ms=plain_us / 1e3,
                bound_ms=bound_us / 1e3, bound_by=bound_by,
                library_ms=library_us / 1e3, device_us=device_us,
                host_us=host_us, bound_us=bound_us, bound_bytes=nbytes,
                library_us=library_us, plain_us=plain_us, plan_k=K,
                bitwise_repeat=bitwise, cold_l2_us=cold_us)


def phase2_kernels(torch):
    """Kernel vs plain at the shapes of the full-size leaflet's tables."""
    from openifem_tpu_torch.la import cuda_ops
    fl, so = full_size_solvers()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for dt in (torch.float64, torch.float32):
        check_kernels(torch, "phase 2", kernel_cases(torch, fl, so, dt, gen),
                      dt, results)
    cuda_ops.reset_launches()
    return results


def _run_leaflet(device, h, refinements, n_steps, config="element", **kw):
    import torch
    fsi = _leaflet_solvers(device, h, refinements, n_steps, config, **kw)
    t0 = time.perf_counter()
    fsi.run(verbose=False)
    if device == "cuda":
        torch.cuda.synchronize()
    return fsi, time.perf_counter() - t0


def _counts(fsi):
    return [(s["solid_newton"], s["fluid_newton"]) for s in fsi.step_log]


def _cuda_vs_cpu(label, h, refinements, n_steps, config, **kw):
    gpu, t_gpu = _run_leaflet("cuda", h, refinements, n_steps, config, **kw)
    cpu, t_cpu = _run_leaflet("cpu", h, refinements, n_steps, config, **kw)
    errs = {}
    for name, a, b in (
            ("fluid solution", gpu.fluid.present_solution,
             cpu.fluid.present_solution),
            ("solid displacement", gpu.solid.current_displacement,
             cpu.solid.current_displacement)):
        a, b = a.cpu(), b
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
    same = _counts(gpu) == _counts(cpu)
    branches = sorted(gpu.fluid.precond_branches)
    ok = (same and all(e <= 1e-6 for e in errs.values())
          and branches == sorted(cpu.fluid.precond_branches))
    say(f"{label} {n_steps} steps ({gpu.fluid.n_dofs} + {gpu.solid.n_dofs} "
        f"dofs, branches {branches}), CUDA vs CPU: "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in errs.items())
        + f" (rtol 1e-6); Newton (solid, fluid) per step CUDA {_counts(gpu)}"
        f" CPU {_counts(cpu)}; {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: CUDA and CPU runs disagree")


def phase3_coarse(torch):
    _cuda_vs_cpu("phase 3: coarse leaflet, element branch,", 0.1, (0, 1), 3,
                 "element")


def phase5_coarse_bench(torch):
    _cuda_vs_cpu("phase 5: coarse leaflet, dense preconditioner (f64),",
                 0.1, (0, 1), 3, "fsi_leaflet", bench_precision=False)
    _cuda_vs_cpu("phase 5: coarse r2-style leaflet, stencil + V-cycle "
                 "(f64),", 0.1, (0, 1), 3, "fsi_leaflet_r2", extra_refine=1,
                 bench_precision=False)


def _mark_coupled_steps(fsi):
    """Record (plan builds, launches) before and after every coupled
    step: marks[0] is before the first, marks[1] after it."""
    from openifem_tpu_torch.la import cuda_ops
    marks, real = [], fsi.run_one_coupled_step

    def step(*args, **kw):
        if not marks:
            marks.append((cuda_ops.plan_builds, cuda_ops.launches.copy()))
        out = real(*args, **kw)
        marks.append((cuda_ops.plan_builds, cuda_ops.launches.copy()))
        return out
    fsi.run_one_coupled_step = step
    return marks


def _full_run(torch, label, config, n_steps, **kw):
    """Drive one configuration at full size through FSI.run on CUDA with
    the launch counts zeroed just before and read just after.  Checks the
    state and that no gather plan was built after the first coupled step,
    and prints the per-step numbers; returns (fsi, launches per (layout,
    dtype, n_cells), launches per coupled step per shape)."""
    from openifem_tpu_torch.la import cuda_ops
    fsi = _leaflet_solvers("cuda", FULL_H, (0, 2), n_steps, config, **kw)
    marks = _mark_coupled_steps(fsi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    fsi.run(verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_ops.launches.copy()
    n_coupled = len(marks) - 1
    per_step = {k: n / n_coupled
                for k, n in (marks[-1][1] - marks[0][1]).items()}
    late_builds = marks[-1][0] - marks[1][0]
    peak = torch.cuda.max_memory_allocated()
    fl, so = fsi.fluid, fsi.solid
    n_dofs = fl.n_dofs + so.n_dofs
    dsp = so.current_displacement.reshape(-1, 2)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        fl.present_solution, fl.stress_device, so.current_displacement,
        so.current_velocity, so.current_acceleration))
    max_dx = dsp[:, 0].max().item()
    coupled = [s for s in fsi.step_log if s["coupled"]]
    for s in fsi.step_log:
        k = s["krylov"]
        per = {n: round(k[n] / max(k["applies"], 1), 2)
               for n in ("mp", "sm", "a")}
        say(f"{label}: step {s['step']} "
            f"{'coupled' if s['coupled'] else 'host first step'}: "
            f"{1e3 * s['seconds']:.1f} ms, Newton solid {s['solid_newton']} "
            f"fluid {s['fluid_newton']}, Krylov {k}, inner per apply {per}")
    ms = [1e3 * s["seconds"] for s in coupled]
    ok = (finite and 1e-4 < max_dx < 0.5 and n_dofs == FULL_DOFS[config]
          and len(coupled) == n_steps - 1 == n_coupled and late_builds == 0)
    say(f"{label}: {config} {fl.n_dofs} + {so.n_dofs} = {n_dofs} dofs, "
        f"{n_steps} steps in {seconds:.2f} s; coupled steps {len(coupled)}, "
        f"{statistics.mean(ms):.1f} ms/step mean, "
        f"{statistics.median(ms):.1f} median; peak device memory "
        f"{peak / 2**20:.1f} MiB; finite {finite}, max d_x {max_dx:.4e}; "
        f"branches {dict(fl.precond_branches)}; launches {dict(launches)}; "
        f"launches per coupled step "
        f"{ {k: round(v, 1) for k, v in sorted(per_step.items())} }; plan "
        f"builds {marks[-1][0]} ({late_builds} after the first coupled "
        f"step) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(
            f"{label} failed: finite={finite} max_dx={max_dx} "
            f"n_dofs={n_dofs} coupled={len(coupled)} "
            f"plan builds after the first coupled step={late_builds}")
    return fsi, launches, per_step


def _launched(launches, layout, dtype=None):
    """Launches of one layout (of one dtype) over all shapes."""
    return sum(n for (name, dt, _), n in launches.items()
               if name == layout and dtype in (None, dt))


def _require(label, cond, what):
    if not cond:
        raise AssertionError(f"{label}: {what}")


def phase4_full(torch):
    label = "phase 4"
    fsi, launches, per_step = _full_run(torch, label, "element", 10)
    missing = [k for k in PATH_LAYOUTS if not _launched(launches, k)]
    _require(label, not missing, f"layouts never launched: {missing}")
    _require(label, set(fsi.fluid.precond_branches) == {("element", "cg")},
             f"branch {dict(fsi.fluid.precond_branches)}")
    say(f"{label}: all five layouts launched ok (element_matvec_rect, the "
        f"flat B/B^T layout, is off this path: "
        f"{_launched(launches, 'element_matvec_rect')} launches; phase 2 "
        "checks it)")
    return launches, per_step


def _step_counts(fsi):
    return [(s["solid_newton"], s["fluid_newton"], s["krylov"])
            for s in fsi.step_log]


def phase6_path_a(torch):
    label = "phase 6"
    fsi, launches, per_step = _full_run(torch, label, "fsi_leaflet", 10)
    fl = fsi.fluid
    _require(label, fl.dense_precond and fl.dense_a_bf16 and fl.f32_matrix,
             "bench knobs not set")
    _require(label, set(fl.precond_branches) == {("dense", "cg")},
             f"branch {dict(fl.precond_branches)}")
    _require(label, _launched(launches, "element_matvec_taylor_hood",
                              "float32"), "Taylor-Hood f32 never launched")
    _require(label, _launched(launches, "element_matvec", "float64"),
             "the solid's scalar layout never launched")
    used = [k for k in PRECOND_ELEMENT if _launched(launches, k)]
    _require(label, not used, f"element layouts in the dense "
             f"preconditioner: {used}")
    say(f"{label}: dense branch taken, Taylor-Hood f32 launched, no element "
        "layout in the preconditioner ok")
    again, _, _ = _full_run(torch, label + " (again)", "fsi_leaflet", 10)
    first, second = _step_counts(fsi), _step_counts(again)
    diverged = [i for i, (a, b) in enumerate(zip(first, second)) if a != b]
    say(f"{label}: a second run repeats the Newton and Krylov counts of the "
        f"first: {not diverged}" + (
            f" (first differing step {diverged[0] + 1}: {first[diverged[0]]}"
            f" then {second[diverged[0]]})" if diverged else ""))
    return launches, per_step


def phase7_path_b(torch, results):
    """Path B at full size, then each of its layouts against the plain
    version at the shapes it launched: the r2 fluid's tables and the
    pressure V-cycle's levels, in the f32 of the bench knobs."""
    label = "phase 7"
    fsi, launches, per_step = _full_run(torch, label, "fsi_leaflet_r2", 4,
                                        extra_refine=2)
    fl = fsi.fluid
    _require(label, set(fl.precond_branches) == {("stencil", "vcycle")},
             f"branch {dict(fl.precond_branches)}")
    _require(label, fl.krylov_iters["sm"] == 0, "Schur CG iterations ran")
    levels = fl._pressure_mg.levels
    _require(label, len(levels) == 3, "pressure V-cycle is not 3 levels")
    missing = [k for k in PATH_B_LAYOUTS if not _launched(launches, k)]
    _require(label, not missing, f"layouts never launched: {missing}")
    say(f"{label}: stencil patch branch, Sm = one V-cycle (0 Schur CG "
        f"iterations), layouts {list(PATH_B_LAYOUTS)} launched ok")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = kernel_cases(torch, fl, fsi.solid, torch.float32, gen, levels)
    check_kernels(torch, label, [c for c in cases if c[0] in PATH_B_LAYOUTS
                                 and c[2] != "solid"], torch.float32,
                  results, cold=("Jacobian",))
    return launches, per_step


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch
    phase0_device(torch)
    # raises ImportError when the script runs outside the repository; the
    # import also sets the package's precision policy (config.py)
    import openifem_tpu_torch  # noqa: F401
    # the solids write their first-step VTU output to the working directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        os.chdir(work)
        phase1_build()
        checked = phase2_kernels(torch)
        phase3_coarse(torch)
        runs = {"element": phase4_full(torch)}
        phase5_coarse_bench(torch)
        runs["fsi_leaflet"] = phase6_path_a(torch)
        runs["fsi_leaflet_r2"] = phase7_path_b(torch, checked)
        os.chdir(root)
    launched = sum((c for c, _ in runs.values()), Counter())
    # every shape a main path launched was held against the plain version
    unchecked = sorted(k for k in launched if k not in checked)
    _require("kernels", not unchecked,
             f"launched but never checked against the plain version: "
             f"{unchecked}")
    # one entry per (layout, dtype, number of cells) that the main paths
    # launched, with the error and times measured at that shape
    kernels = [dict(name=f"{name}[{dt}, {n_c} cells]", route="cuda",
                    source=SOURCE, replaces=REPLACES, launches=n,
                    launches_per_coupled_step={
                        path: per_step.get((name, dt, n_c), 0.0)
                        for path, (_, per_step) in runs.items()},
                    **{k: v for k, v in checked[(name, dt, n_c)].items()
                       if k != "rel"})
               for (name, dt, n_c), n in sorted(launched.items())]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
