#!/usr/bin/env python3
"""Drive the PyTorch port (openifem_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py [--phases 14,15] [--wall3d-depth 1,3]
                          [--vocal-depth 1,3] [--amr-depth 10]

Phases, one line each; any failure raises and exits non-zero before the
last line is printed (--phases runs a subset, for development; phases 0
and 1 always run):
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
     matvec preconditioner branch for 2 steps on CUDA and on the CPU:
     fluid solution and solid displacement within rtol 1e-6, equal Newton
     counts;
  4. that branch at the reference size (17,249 dofs) for 4 steps on CUDA
     (host first step + 3 coupled steps): finite, leaflet pushed
     downstream (1e-4 < max d_x < 0.5), all five layouts launched;
  5. the coarse versions of the two bench configurations, f64 knobs,
     CUDA vs CPU as in phase 3: the dense preconditioner (h = 0.1), and
     the stencil + pressure V-cycle + mg_direct on a uniform channel
     (h = 0.1 refined once, 2 levels);
  6. path A, fsi_leaflet with the bench knobs (dense condensed
     preconditioner, bf16 A block, f32 Jacobian), 17,249 dofs, 10 steps:
     finite, 1e-4 < max d_x < 0.5, the dense branch taken, the Taylor-Hood
     layout launched in f32 and no element layout in the preconditioner;
  7. path B, fsi_leaflet_r2 with the bench knobs (stencil patch layout,
     one pressure V-cycle as Sm^-1), 232,997 dofs, 3 steps: the same
     state checks, the patch-layout branch and no Schur CG iterations,
     Taylor-Hood, p->u and scalar layouts launched; then each of these
     layouts against its plain version as in phase 2, in f32, at path B's
     shapes: the r2 fluid's tables (25,600 cells) and every level of the
     pressure V-cycle on the level's own blocks; the Taylor-Hood shape
     (49.6 MB of f32 A, about the L2's size) also with a cold L2;
  8. the standalone fluid, coarse, CUDA vs CPU: the Turek cylinder at
     refine 1 (3,612 dofs), all-f64 "r1" configuration, host first step
     and a 3-step window of InsIM's stepper; InsIMEX for 3 steps: within
     rtol 1e-6, equal Newton counts;
  9. the cylinder as the JAX bench runs it: "r3" (54,192 dofs: host first
     step, a 2-step warm-up window, 5 timed steps in one stepper call) and
     "r4" (214,368 dofs: no host first step, 1 warm-up step, 3 timed
     steps, one call each), with the bench knobs: every timed step
     converged, finite fields, the z-order stencil patches and the
     configuration's preconditioner branch taken;
 10. InsIMEX at refine 3 (54,192 dofs), 5 steps: finite, and
     element_matvec_rect launched on its path.
 11. the stabilised fluid family, coarse, CUDA vs CPU (rtol 1e-6, equal
     Newton or sweep counts, f64): SCnsIM on the cylinder at refine 1
     (1,284 dofs) for 2 steps on the coupled-stencil branch and 1 step
     (5 Newton iterations) on the element, dense and hybrid (stencil outer
     apply, dense Tpp) branches; SUPGInsIM and SerialSCnsIM there for 1
     step; SCnsEX on the acoustic duct refined once (255 dofs), 6 steps
     through run() and through run_on_device();
 12. SCnsIM on the cylinder as the JAX bench runs it (18,384 dofs, f32 Tpp
     preconditioner, Galerkin V-cycle on the B2pp blocks): host first
     step, then warm-up and timed steps through make_on_device_stepper
     with the BC table (--scnsim-depth warm,timed,element; default 0,1,1,
     the JAX bench's depth is 2,4,2); then the state carried into a solver
     with coupled_stencil = False for its timed steps, so the
     Taylor-Hood, p->u, u->p and scalar layouts carry a SUPG step at full
     size: every timed step converged, finite fields, the branch taken;
 13. SCnsEX on the acoustic duct (3,315 dofs) for 100 steps through
     run_on_device, then the duct refined twice more (16,384 cells, 50,115
     dofs, the time step cut by 4) for 100 steps: converged sweeps, finite
     fields, 0 < vmax < 7, element_matvec launched at 8 x 8 and 4 x 4.
 14. the MPI-semantics coupler, coarse, CUDA vs CPU (f64, rtol 1e-6, equal
     Newton and contact-retry counts per step): the 2-D block
     (cases/mpi_block.py) with SharedLinearElasticity in body-force mode,
     the same with the contact model, and SharedHyperElasticity with the
     Dirichlet coupling, 2 steps each; the fsi-wall-3D case at the
     truncated size (3,020 + 324 dofs), 2 steps; then each _MPIKernels
     function and one SharedHypoElasticity RK4 step on the CPU run's
     state (indicator and Dirichlet mask equal, the rest to 1e-12);
 15. fsi-wall-3D at full resolution (45,207 dofs) with the bench knobs
     through MPIFSI.run: the host first step, a warm-up and timed coupled
     steps (--wall3d-depth warm,timed; default 1,3, the JAX bench's depth
     is 2,10): per timed step ms, dof-steps per second, Newton, outer
     FGMRES and Tpp GMRES counts, host syncs and the split between the
     solid RK4 step, the coupling kernels and the fluid Newton loop (CUDA
     events); set-up seconds and peak memory; every step converged,
     finite fields, covered cells and nonzero stress rows.
 16. the vocal fold (cases/vocal_fold.py: SCnsIM with a Spalart-Allmaras
     eddy viscosity, a SharedLinearElasticity fold, the MPI coupler's wall
     functions and contact, per-step control-volume budgets), coarse
     (3,534 dofs), 2 steps through ControlVolumeFSI.run on CUDA and on the
     CPU (f64): fluid, nu~, solid and shear velocities within rtol 1e-6,
     every cv_history key within 1e-6 (1e-12 absolute near 0), equal
     fluid Newton, SA Newton and contact-retry counts; then the channel
     without the fold, SCnsIM + SA through run_on_device against run() on
     the card, 2 steps, within 1e-6;
 17. the vocal fold at full size (global refinements (2, 1), 52,470
     dofs) with fsi-wall-3D's bench knobs through ControlVolumeFSI.run:
     the host first step, warm-up and timed steps (--vocal-depth
     warm,timed; default 1,3): per step ms, dof-steps per second, fluid
     Newton, outer FGMRES and Tpp GMRES counts, SA Newton and FGMRES
     counts, contact retries, host syncs and the split between the solid,
     coupling, SA, fluid Newton and CV-analysis parts (CUDA events);
     set-up seconds and peak memory; every step converged, finite fields
     and budgets, present_KE >= 0, eddy viscosity finite and >= 0,
     covered cells.
 18. AMR, checkpoints and the flat shell, coarse, CUDA vs CPU (f64): the
     coarse leaflet (h = 0.1, refinements [0, 1], element branch) through
     FSI.run with interface refinement and a save every 2 steps, 4 steps
     (equal meshes and Newton counts, 1e-6), then FSI.resume on the card
     from the step-2 checkpoints to step 4 against the uninterrupted card
     run (1e-10); the disc in the cavity (cases/fsi_disc.py), whose
     interface refinement changes its mesh, the same way (4 steps, a save
     every 2, resumed from step 2); the cylinder at refine 1 through
     InsIM.run with Kelly AMR (levels 1..3) after every step, 2 steps
     (equal meshes and Newton counts, 1e-6); the 2-D MPI block (body
     force) through MPIFSI.run saved at step 2 and restarted to step 4
     (1e-6 against the CPU, 2e-10 against the uninterrupted card run);
     the shell plate (16 x 16) and bar (16 x 4): 1e-10, CG counts at most 1
     apart, the closed forms;
 19. the adaptive leaflet at full width (fsi_leaflet with the bench
     knobs, 17,249 dofs before adaptation; cases.fsi_leaflet.ADAPTIVE:
     interface refinement every 2 steps, a checkpoint every 5) through
     FSI.run for --amr-depth steps (default 10): per step ms, dofs,
     Newton and Krylov counts, plan builds and dense-block time; per
     refinement its seconds split into coarsen + refine, setup, transfer,
     coupling tables and the rest (distances and flags); checkpoint bytes
     and seconds; peak memory; every step converged, finite, 1e-4 < max
     d_x < 0.5, plans built only in the step after a refinement that
     changed the mesh; then FSI.resume on the card from the step-5
     checkpoints (load seconds, difference to the uninterrupted run
     printed); the shell plate at 64 x 64 cells (21,125 dofs): CG
     iterations and solve ms, within 4 % of Kirchhoff.
 20. the sharded paths (parallel/shard.py), coarse, f64:
     entry.dryrun_multichip with one rank (NCCL; the JAX dry run's 5-step
     windows) and with 4 ranks sharing the card (gloo, 2-step windows;
     the route of each collective printed): the
     element-sharded Newton, the padded InsIM Newton (n_u, n_p not
     multiples of 4), the sharded stepper, the padded SCnsIM Newton, the
     FSI and MPIFSI coupled windows, the plane-sharded stencil A-solve and
     the dof-sharded solid CG, each against the unsharded card run with
     the dry run's tolerances, the one-rank results also against the CPU
     (1e-6, equal Newton and Krylov counts);
 21. the sharded paths at full width: (a) make_sharded_stepper at world
     size 1 on the cavity at refine 6 (37,507 dofs), a
     2-step window against make_on_device_stepper's (1e-5 of the scale,
     converged, equal Newton counts; ms per step, all-reduces and bytes
     per step, host syncs, peak memory); (b) the plane-sharded stencil
     A-solve at refine 7 (132,098 velocity dofs) with 4 ranks sharing the
     card and at world size 1, against the replicated stencil FGMRES
     (1e-8, iterations within 2; ms per solve, halo bytes per matvec);
     (c) sharded_supg_newton at world size 1 on SCnsIM's cylinder r3
     (18,384 dofs) against the unsharded element branch (res_norm 1e-10,
     du 1e-5); (d) sharded_element_cg on 4 ranks on the 64 x 64 shell
     plate (21,125 dofs) against the unsharded Jacobi CG (1e-10, CG counts
     at most 1 apart).
Phases 8-21 then hold every kernel shape they launched against its plain
version as phase 2 does, at the path's own tables.  Phase 2 also checks
the 3-D Q1/Q1 shapes (Taylor-Hood 32 x 32, p->u 24 x 8, u->p 8 x 24) in
f32 and f64 on a 12^3 box.
Phases 4, 6 and 7 print ms per coupled step, Newton and Krylov counts per
step, launches per coupled step and peak device memory, and fail if a
gather plan is built after the first coupled step; phases 9 and 10 print
ms per step, dof-steps per second, Newton and Krylov counts, host
synchronisations per step, launches per step and peak memory, and fail
if a plan is built after the configuration's first step; phases 12 and
13 print the same with their own Krylov counts.  The kernels
count their launches per (layout, dtype, number of cells, block rows,
block columns); the script fails if a path launched a shape that no phase
checked.  Then a JSON line with one entry per such shape (launches summed
over the paths of phases 4 and 6-21, and per step of each path; error and
times measured at that shape) and the last line {"ok": true, ...}.
Exits non-zero, and prints no result, when no CUDA device is present.
"""

import argparse
import inspect
import json
import math
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
# (the flat B / B^T layout) is InsIMEX's, phase 10
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
# the cylinder configurations as bench_cylinder runs them: dofs, whether
# the host path takes the first step, warm-up steps, timed steps, whether
# the timed steps are one stepper call, and the (A-solve, Sm-solve) branch
CYLINDER_RUNS = {
    "r3": dict(dofs=54192, host_first=True, warm=2, timed=5, one_call=True,
               branch=("stencil", "cg+vcycle")),
    "r4": dict(dofs=214368, host_first=False, warm=1, timed=3,
               one_call=False, branch=("stencil", "vcycle")),
}
IMEX_REFINE, IMEX_DOFS, IMEX_STEPS = 3, 54192, 5
# SCnsIM on the cylinder (refine 3) and SCnsEX on the duct (refine 3, and
# refined twice more)
SCNSIM_DOFS = 18384
# steps of phase 12 after the host first step: warm-up, timed on the
# coupled stencil, timed on the element branch.  A step takes most of a
# minute (about 10,000 Tpp GMRES iterations), so the default is the least
# that drives both branches; --scnsim-depth 2,4,2 is the JAX bench's depth
SCNSIM_WARM, SCNSIM_TIMED, SCNSIM_ELEMENT_TIMED = 0, 1, 1
DUCT_STEPS = 100
DUCT_RUNS = {"duct": dict(extra_refine=0, dofs=3315, cells=1024),
             "duct_fine": dict(extra_refine=2, dofs=50115, cells=16384)}
# fsi-wall-3D: dofs at full resolution; coupled steps after the host first
# step, warm-up and timed (the JAX bench's depth is 2, 10)
WALL3D_DOFS = 45207
WALL3D_WARM, WALL3D_TIMED = 1, 3
# the vocal fold at full size: steps after the host first step, warm-up
# and timed
VOCAL_WARM, VOCAL_TIMED = 1, 3
# the reference's one-core CPU rate, dof-steps per second
REFERENCE_DOF_STEPS = 1505
# steps of the adaptive leaflet (phase 19): the default and the least
AMR_STEPS = 10
# the MPI block's card restart against the uninterrupted card run: the
# card's index_add_ atomics round differently from run to run; restarts
# and repeated runs of the block differed from a first run by 1.1e-11 to
# 7.9e-11 on an H100 80GB HBM3 at 700 W
BLOCK_RESTART_TOL = 2e-10
# depth of earlier phases, cut to keep the script inside its time limit
# once phases 20-21 came (PERF.md): steps of the coarse CUDA-vs-CPU
# leaflets (phases 3 and 5; 3 before), of path B (phase 7; 4 before) and of
# the Kelly cylinder (phase 18; 3 before)
COARSE_LEAFLET_STEPS = 2
PATH_B_STEPS = 3
KELLY_STEPS = 2
# ... and of the coarse MPI-coupler and vocal-fold runs (phases 14 and 16;
# 3 before)
COARSE_MPI_STEPS = COARSE_VOCAL_STEPS = 2
# phase 20: window steps of the dry run with 4 ranks sharing the card
# (the one-rank run takes the JAX dry run's 5); phase 21 (a): the cavity's
# refinements (6: 64 x 64 cells, 37,507 dofs)
DRYRUN4_STEPS = 2
CAVITY_REFINE = 6


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
    at the shapes of the fluid's tables and (unless `so` is None) the
    solid's, with random blocks from `gen`; the node-block layouts only
    where the fluid has a velocity node table (InsIMEX has none); and the
    scalar or node-block layout on each multigrid level's own blocks (cast
    to `dt`; random x).  The "flat" cases are InsIMEX's: blocks read as
    strided views of the system table."""
    from openifem_tpu_torch.la import operators as ops
    d, nlu, nu = fl.dim, fl.nlu, fl.nu_loc
    n_c = fl.mesh.n_cells
    cd_u, cd_p, cd = fl.cell_dofs_u, fl.cell_dofs_p, fl.cell_dofs
    n_un = fl.n_u // d

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)
    A = rnd(n_c, fl.nu_loc + fl.nlp, fl.nu_loc + fl.nlp)
    x = rnd(fl.n_dofs)
    xu, xp = x[:fl.n_u].contiguous(), x[fl.n_u:].contiguous()
    Auu, Aup, Apu = A[:, :nu, :nu], A[:, :nu, nu:], A[:, nu:, :nu]
    Mp = rnd(n_c, fl.nlp, fl.nlp)

    def pair(name, *args, **kw):
        return (lambda: getattr(ops, name)(*args, **kw),
                lambda: getattr(ops, name + "_plain")(*args))
    cases = []
    if hasattr(fl, "cell_nodes_u"):
        cn_u = fl.cell_nodes_u
        cases += [
            ("element_matvec_taylor_hood", n_c, "Jacobian",
             *pair("element_matvec_taylor_hood", A, cn_u, cd_p, nlu, d,
                   fl.n_u, fl.n_p, x, cell_dofs=cd)),
            ("element_matvec_nodeblock", n_c, "A block",
             *pair("element_matvec_nodeblock",
                   Auu.reshape(n_c, nlu, d, nlu, d), cn_u, n_un, xu)),
            ("element_matvec_u_to_p_nodeblock", n_c, "B",
             *pair("element_matvec_u_to_p_nodeblock",
                   Apu.reshape(n_c, fl.nlp, nlu, d), cn_u, cd_p, fl.n_p,
                   xu)),
            ("element_matvec_p_to_u_nodeblock", n_c, "B^T",
             *pair("element_matvec_p_to_u_nodeblock",
                   Aup.reshape(n_c, nlu, d, fl.nlp), cn_u, cd_p, n_un, xp)),
        ]
    cases.append(("element_matvec", n_c, "Mp",
                  *pair("element_matvec", Mp, cd_p, fl.n_p, xp)))
    if so is not None:
        As = rnd(so.mesh.n_cells, 8, 8)
        xs = rnd(so.n_dofs)
        cases.append(("element_matvec", so.mesh.n_cells, "solid",
                      *pair("element_matvec", As, so.cell_dofs, so.n_dofs,
                            xs)))
    cases += [
        ("element_matvec_rect", n_c, "flat B",
         *pair("element_matvec_rect", Apu, cd_p, cd_u, fl.n_p, xu)),
        ("element_matvec_rect", n_c, "flat B^T",
         *pair("element_matvec_rect", Aup, cd_u, cd_p, fl.n_u, xp)),
        ("element_matvec", n_c, "flat A block",
         *pair("element_matvec", Auu, cd_u, fl.n_u, xu)),
        ("element_matvec", n_c, "flat system",
         *pair("element_matvec", A, cd, fl.n_dofs, x)),
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


def check_kernels(torch, label, cases, dt, results, cold=(), only=None):
    """Each case's kernel against its plain version (relative error to
    TOL[dt]) and against itself (repeated launches bitwise equal), with
    device, host, bound and library times; raises on a miss.  Cases whose
    `what` is in `cold` are also timed with a cold L2.  results[(layout,
    dtype, n_cells, block rows, block columns)] keeps, per shape, the case
    with the largest error.  `only`: a set of such shapes; cases of other
    shapes, and of shapes that `results` holds already, are skipped."""
    from openifem_tpu_torch.la import cuda_ops
    name_dt = _dt_name(dt)
    for layout, n_c, what, kern, plain in cases:
        la = _launch_args(kern)
        key = (layout, name_dt, n_c, la["nr"], la["nc"])
        if only is not None and (key not in only or key in results):
            continue
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
        say(f"{label}: {layout} ({what}, {n_c} cells, {la['nr']} x "
            f"{la['nc']} blocks) {name_dt} -> "
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
    # off any path: the 3-D Q1/Q1 shapes of the SUPG family (nlu 8, d 3,
    # nlp 8) on a 12^3 box
    from openifem_tpu_torch.cases.fsi_leaflet import port_package
    pkg = port_package()
    box = pkg.generators.subdivided_hyper_rectangle(
        [12, 12, 12], [0, 0, 0], [1.0, 1.0, 1.0])
    fl3 = pkg.SCnsIM(box, pkg.AllParameters(
        dimension=3, fluid_velocity_degree=1, fluid_pressure_degree=1,
        gravity=[0.0, 0.0, 0.0]), device="cuda")
    fl3.coupled_stencil = False
    fl3.setup()
    box_layouts = {"element_matvec_taylor_hood": (32, 32),
                   "element_matvec_p_to_u_nodeblock": (24, 8),
                   "element_matvec_u_to_p_nodeblock": (8, 24)}
    for dt in (torch.float64, torch.float32):
        only = {(name, _dt_name(dt), box.n_cells, nr, nc)
                for name, (nr, nc) in box_layouts.items()}
        check_kernels(torch, "phase 2 (3-D)",
                      kernel_cases(torch, fl3, None, dt, gen), dt, results,
                      only=only)
        _require("phase 2 (3-D)", only <= set(results),
                 f"3-D shapes not checked: {sorted(only - set(results))}")
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
    _cuda_vs_cpu("phase 3: coarse leaflet, element branch,", 0.1, (0, 1),
                 COARSE_LEAFLET_STEPS, "element")


def phase5_coarse_bench(torch):
    _cuda_vs_cpu("phase 5: coarse leaflet, dense preconditioner (f64),",
                 0.1, (0, 1), COARSE_LEAFLET_STEPS, "fsi_leaflet",
                 bench_precision=False)
    _cuda_vs_cpu("phase 5: coarse r2-style leaflet, stencil + V-cycle "
                 "(f64),", 0.1, (0, 1), COARSE_LEAFLET_STEPS,
                 "fsi_leaflet_r2", extra_refine=1, bench_precision=False)


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
    return sum(n for (name, dt, *_), n in launches.items()
               if name == layout and dtype in (None, dt))


def _require(label, cond, what):
    if not cond:
        raise AssertionError(f"{label}: {what}")


def phase4_full(torch):
    label = "phase 4"
    fsi, launches, per_step = _full_run(torch, label, "element", 4)
    missing = [k for k in PATH_LAYOUTS if not _launched(launches, k)]
    _require(label, not missing, f"layouts never launched: {missing}")
    _require(label, set(fsi.fluid.precond_branches) == {("element", "cg")},
             f"branch {dict(fsi.fluid.precond_branches)}")
    say(f"{label}: all five layouts launched ok (element_matvec_rect, the "
        f"flat B/B^T layout, is off this path: "
        f"{_launched(launches, 'element_matvec_rect')} launches; phase 10 "
        "runs it)")
    return launches, per_step


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
    return launches, per_step


def phase7_path_b(torch, results):
    """Path B at full size, then each of its layouts against the plain
    version at the shapes it launched: the r2 fluid's tables and the
    pressure V-cycle's levels, in the f32 of the bench knobs."""
    label = "phase 7"
    fsi, launches, per_step = _full_run(torch, label, "fsi_leaflet_r2",
                                        PATH_B_STEPS, extra_refine=2)
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
                                 and c[2] != "solid"
                                 and not c[2].startswith("flat")],
                  torch.float32, results, cold=("Jacobian",))
    return launches, per_step


# -- the standalone fluid: the Turek cylinder (cases/fluid_cylinder.py) ----

def _rel(a, b):
    """max |a - b| relative to b's max norm, on the CPU."""
    a, b = a.cpu(), b.cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _check_launched(torch, label, fl, launches, results, levels=()):
    """Hold every shape in `launches` (a path's launch counts) against its
    plain version at the tables of the solver that launched it."""
    for name_dt in sorted({k[1] for k in launches}):
        dt = getattr(torch, name_dt)
        gen = torch.Generator(device="cuda").manual_seed(97)
        check_kernels(torch, label,
                      kernel_cases(torch, fl, None, dt, gen, levels), dt,
                      results, only=set(launches))


def _path(launches, n_steps):
    """(launches, launches per step) of a path that took n_steps steps."""
    return launches, {key: n / n_steps for key, n in launches.items()}


def _slug(what):
    return what.lower().replace(" ", "_")


def phase8_coarse_cylinder(torch, results):
    """InsIM's stepper and InsIMEX at refine 1, CUDA vs CPU."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import cuda_ops
    label = "phase 8"
    pkg = fc.port_package()

    def insim(dev):
        fl = fc.cylinder_case(pkg, "r1", n_steps=4, bench_precision=False,
                              device=dev)
        fl.run_one_step(True, verbose=False)
        first = fl.newton_iters
        sol, rel, it = fl.make_on_device_stepper()(fl.present_solution, 3)
        return fl, sol, rel, (first, it)

    def imex(dev):
        fl = fc.imex_case(pkg, 1, 3, device=dev)
        outer = []
        for _ in range(3):
            k0 = fl.krylov_iters["outer"]
            fl.run_one_step(fl.time.get_timestep() == 0, verbose=False)
            outer.append(fl.krylov_iters["outer"] - k0)
        return fl, outer

    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    gfl, gsol, grel, gits = insim("cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = cuda_ops.launches.copy()
    t0 = time.perf_counter()
    cfl, csol, crel, cits = insim("cpu")
    t_cpu = time.perf_counter() - t0
    err = _rel(gsol, csol)
    tol = gfl.params.fluid_tolerance
    ok = (err <= 1e-6 and gits == cits and grel < tol and crel < tol
          and gfl.precond_branches == cfl.precond_branches
          and set(gfl.precond_branches) == {("stencil", "cg+vcycle")})
    say(f"{label}: coarse cylinder r1 (f64), {gfl.n_dofs} dofs, host first "
        f"step + 3-step stepper window, CUDA vs CPU: solution rel err "
        f"{err:.3e} (rtol 1e-6); Newton (first step, worst of window) CUDA "
        f"{gits} CPU {cits}; worst rel res CUDA {grel:.3e} CPU {crel:.3e}; "
        f"branches {dict(gfl.precond_branches)}; {t_gpu:.2f} s CUDA, "
        f"{t_cpu:.2f} s CPU {'ok' if ok else 'FAILED'}")
    _require(label, ok, "InsIM stepper: CUDA and CPU runs disagree")
    _check_launched(torch, label, gfl, launches, results,
                    gfl._pressure_mg.levels)

    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    gfl, gouter = imex("cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    imex_launches = cuda_ops.launches.copy()
    t0 = time.perf_counter()
    cfl, couter = imex("cpu")
    t_cpu = time.perf_counter() - t0
    err = _rel(gfl.present_solution, cfl.present_solution)
    ok = err <= 1e-6 and _launched(imex_launches, "element_matvec_rect") > 0
    say(f"{label}: coarse InsIMEX, {gfl.n_dofs} dofs, 3 steps, CUDA vs CPU: "
        f"solution rel err {err:.3e} (rtol 1e-6); outer FGMRES iterations "
        f"per step CUDA {gouter} CPU {couter} (equal: {gouter == couter}; "
        f"not required: the sums' order differs between the kernel and "
        f"index_add_); {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "InsIMEX: CUDA and CPU runs disagree")
    _check_launched(torch, label, gfl, imex_launches, results)
    # the host first step and the stepper's 3; InsIMEX's 3
    return {"coarse_cylinder": _path(launches, 4),
            "coarse_insimex": _path(imex_launches, 3)}


def _window_report(label, what, fl, n_steps, seconds, k0, solves, newton,
                   syncs, launches0, peak):
    """Print one timed window's numbers (`solves` outer linear solves,
    `newton` a note on them); returns launches per step."""
    from openifem_tpu_torch.la import cuda_ops
    k = {n: v - k0[n] for n, v in fl.krylov_iters.items()}
    per_apply = {n: round(k[n] / max(k["applies"], 1), 2)
                 for n in ("mp", "sm", "a")}
    per_step = {key: n / n_steps
                for key, n in (cuda_ops.launches - launches0).items()}
    ms = 1e3 * seconds / n_steps
    say(f"{label}: {what}: {n_steps} timed steps in {seconds:.3f} s, "
        f"{ms:.1f} ms/step, {fl.n_dofs * n_steps / seconds:.1f} "
        f"dof-steps/s; {newton}; Krylov {k}, outer per solve "
        f"{k['outer'] / max(solves, 1):.2f}, inner per "
        f"apply {per_apply}; host syncs per step {syncs / n_steps:.1f}; "
        f"launches per step "
        f"{ {key: round(v, 1) for key, v in sorted(per_step.items())} }; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    return per_step


def _cylinder_run(torch, label, config, results):
    """One cylinder configuration at full size through InsIM's host first
    step (where the bench takes it) and make_on_device_stepper, with the
    launch counts zeroed just before and read just after."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.la.stencil import PatchGrid
    from openifem_tpu_torch.utils.timer import count_host_syncs
    run = CYLINDER_RUNS[config]
    label = f"{label} {config}"
    t0 = time.perf_counter()
    fl = fc.cylinder_case(fc.port_package(), config,
                          n_steps=1 + run["warm"] + run["timed"],
                          device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zorder = (PatchGrid._build_lattice(fl.mesh) is None
              and fl._u_stencil is not None)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    if run["host_first"]:
        fl.run_one_step(True, verbose=False)
        first = f"host first step Newton {fl.newton_iters}"
    else:
        # the impulsive start: inject the boundary values, and let the
        # stepper's warm-up step converge it
        fl.present_solution = fl.nonzero_constraints.apply_increment(
            fl.present_solution)
        fl.time.increment()
        first = "no host first step"
    stepper = fl.make_on_device_stepper()
    builds_first = None
    if run["host_first"]:
        torch.cuda.synchronize()
        builds_first = cuda_ops.plan_builds
    sol, warm_rel, warm_it = stepper(fl.present_solution, run["warm"])
    torch.cuda.synchronize()
    if builds_first is None:
        builds_first = cuda_ops.plan_builds
    start_s = time.perf_counter() - t0
    say(f"{label}: {fl.mesh.n_cells} cells, {fl.n_dofs} dofs, set up in "
        f"{setup_s:.2f} s; {first}, {run['warm']}-step warm-up window "
        f"(worst rel res {warm_rel:.3e}, Newton {warm_it}) in "
        f"{start_s:.2f} s; z-order patches {zorder}")

    k0, b0 = dict(fl.krylov_iters), sum(fl.precond_branches.values())
    l0 = cuda_ops.launches.copy()
    with count_host_syncs() as syncs:
        t0 = time.perf_counter()
        if run["one_call"]:
            sol, worst_rel, worst_it = stepper(sol, run["timed"])
        else:
            worst_rel, worst_it = 0.0, 0
            for _ in range(run["timed"]):
                sol, rel, it = stepper(sol, 1)
                worst_rel, worst_it = max(worst_rel, rel), max(worst_it, it)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = cuda_ops.launches.copy()
    late_builds = cuda_ops.plan_builds - builds_first
    solves = sum(fl.precond_branches.values()) - b0
    per_step = _window_report(
        label, "stepper" + (" (one call)" if run["one_call"]
                            else " (one call per step)"),
        fl, run["timed"], seconds, k0, solves,
        f"Newton iterations {solves / run['timed']:.2f} per step, worst "
        f"{worst_it}", syncs["syncs"], l0, torch.cuda.max_memory_allocated())
    fl.present_solution = sol
    fl.update_stress()
    finite = bool(torch.isfinite(sol).all()) and \
        bool(torch.isfinite(fl.stress_device).all())
    vmax = sol[:fl.n_u].abs().max().item()
    ok = (worst_rel < fl.params.fluid_tolerance and finite and zorder
          and fl.n_dofs == run["dofs"] and late_builds == 0
          and set(fl.precond_branches) == {run["branch"]}
          and 0.29 < vmax < 1.0
          and (config != "r4" or fl.krylov_iters["sm"] == 0))
    say(f"{label}: worst rel res {worst_rel:.3e} (< "
        f"{fl.params.fluid_tolerance:.0e}), finite {finite}, max |u| "
        f"{vmax:.4f} (inflow peak 0.3), branches "
        f"{dict(fl.precond_branches)}, plan builds {cuda_ops.plan_builds} "
        f"({late_builds} after the first step) {'ok' if ok else 'FAILED'}")
    _require(label, ok, f"cylinder {config} failed")
    _check_launched(torch, label, fl, launches, results,
                    fl._pressure_mg.levels)
    return launches, per_step


def phase9_cylinder(torch, results):
    return {f"cylinder_{config}": _cylinder_run(torch, "phase 9", config,
                                                results)
            for config in CYLINDER_RUNS}


def phase10_insimex(torch, results):
    """InsIMEX at refine 3 through run_one_step, 5 steps."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.utils.timer import count_host_syncs
    label = "phase 10"
    t0 = time.perf_counter()
    fl = fc.imex_case(fc.port_package(), IMEX_REFINE, IMEX_STEPS,
                      device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    fl.run_one_step(True, verbose=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    builds_first = cuda_ops.plan_builds
    say(f"{label}: InsIMEX {fl.mesh.n_cells} cells, {fl.n_dofs} dofs, set "
        f"up in {setup_s:.2f} s; first step (boundary values folded in) "
        f"{1e3 * first_s:.1f} ms, Krylov {fl.krylov_iters}")
    n = IMEX_STEPS - 1
    k0, l0 = dict(fl.krylov_iters), cuda_ops.launches.copy()
    with count_host_syncs() as syncs:
        t0 = time.perf_counter()
        for _ in range(n):
            fl.run_one_step(False, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = cuda_ops.launches.copy()
    late_builds = cuda_ops.plan_builds - builds_first
    per_step = _window_report(
        label, "run_one_step", fl, n, seconds, k0, n,
        "one linear solve per step", syncs["syncs"], l0,
        torch.cuda.max_memory_allocated())
    sol = fl.present_solution
    finite = bool(torch.isfinite(sol).all()) and \
        bool(torch.isfinite(fl.stress_device).all())
    vmax = sol[:fl.n_u].abs().max().item()
    rect = _launched(launches, "element_matvec_rect")
    ok = (finite and rect > 0 and fl.n_dofs == IMEX_DOFS
          and late_builds == 0 and 0.29 < vmax < 1.0
          and fl.time.get_timestep() == IMEX_STEPS)
    say(f"{label}: finite {finite}, max |u| {vmax:.4f}, "
        f"element_matvec_rect launched {rect} times on the path, plan "
        f"builds {cuda_ops.plan_builds} ({late_builds} after the first "
        f"step) {'ok' if ok else 'FAILED'}")
    _require(label, ok, "InsIMEX failed")
    _check_launched(torch, label, fl, launches, results)
    return launches, per_step


# -- the stabilised fluid family (solvers/fluid/supg.py, scnsex.py) --------

def _galerkin_levels(torch, mg):
    """The levels of a GalerkinMG as kernel_cases takes them: its blocks
    are rebuilt per Newton iteration, so each level gets random scalar
    blocks on the level's own dof table."""
    from types import SimpleNamespace
    gen = torch.Generator(device="cuda").manual_seed(53)
    levels = []
    for cd, n in zip(mg.cell_dofs_k, mg.n_nodes):
        A = torch.randn(cd.shape[0], cd.shape[1], cd.shape[1], generator=gen,
                        device="cuda", dtype=torch.float64)
        levels.append(SimpleNamespace(A_loc=A, n=n * mg.ncomp, ncomp=1,
                                      cell_dofs=cd))
    return levels


def _scnsex_cases(torch, fl, dt, gen):
    """SCnsEX's two operators at its own tables: the velocity block
    (nlu d x nlu d) and the pressure block (nlp x nlp), random blocks."""
    from openifem_tpu_torch.la import operators as ops
    n_c = fl.mesh.n_cells
    cases = []
    for what, ref, cd, n in (("Av", fl.Av_loc, fl.cell_dofs_u, fl.n_u),
                             ("Ap", fl.Ap_loc, fl.cell_dofs_p, fl.n_p)):
        A = torch.randn(*ref.shape, generator=gen, device="cuda", dtype=dt)
        x = torch.randn(n, generator=gen, device="cuda", dtype=dt)
        cases.append((
            "element_matvec", n_c, what,
            lambda A=A, cd=cd, n=n, x=x: ops.element_matvec(A, cd, n, x),
            lambda A=A, cd=cd, n=n, x=x: ops.element_matvec_plain(A, cd, n,
                                                                  x)))
    return cases


def _check_scnsex_launched(torch, label, fl, launches, results):
    for name_dt in sorted({k[1] for k in launches}):
        dt = getattr(torch, name_dt)
        gen = torch.Generator(device="cuda").manual_seed(71)
        check_kernels(torch, label, _scnsex_cases(torch, fl, dt, gen), dt,
                      results, only=set(launches))


def _timed(torch, fn, dev):
    t0 = time.perf_counter()
    out = fn(dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase11_coarse_supg(torch, results):
    """The SUPG family and SCnsEX at coarse size, CUDA vs CPU, f64."""
    from openifem_tpu_torch.cases import acoustic_duct as ad
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import cuda_ops
    label = "phase 11"
    pkg = fc.port_package()
    paths = {}

    def supg(solver, n_steps, **knobs):
        def run(dev):
            fl = fc.scnsim_case(pkg, refine=1, n_steps=n_steps,
                                bench_precision=False, solver=solver,
                                device=dev, **knobs)
            newton = []
            real = fl.run_one_step

            def step(*a, **k):
                real(*a, **k)
                newton.append(fl.newton_iters)
            fl.run_one_step = step
            fl.run(verbose=False)
            return fl, newton
        return run

    runs = [("SCnsIM coupled stencil", 2, supg("SCnsIM", 2),
             ("stencil", "stencil", "galerkin")),
            ("SCnsIM element", 1, supg("SCnsIM", 1, coupled_stencil=False),
             ("element", "nodeblock", "galerkin")),
            ("SCnsIM dense", 1, supg("SCnsIM", 1, coupled_stencil=False,
                                     dense_precond=True),
             ("element", "dense", "galerkin")),
            ("SCnsIM hybrid", 1, supg("SCnsIM", 1, dense_precond=True,
                                      stencil_outer_only=True),
             ("stencil", "dense", "galerkin")),
            ("SUPGInsIM", 1, supg("SUPGInsIM", 1),
             ("stencil", "stencil", "galerkin")),
            ("SerialSCnsIM", 1, supg("SerialSCnsIM", 1),
             ("stencil", "stencil", "galerkin"))]
    for what, n_steps, run, branch in runs:
        cuda_ops.reset_launches()
        (gfl, gn), t_gpu = _timed(torch, run, "cuda")
        launches = cuda_ops.launches.copy()
        (cfl, cn), t_cpu = _timed(torch, run, "cpu")
        err = _rel(gfl.present_solution, cfl.present_solution)
        serr = _rel(gfl.stress_device, cfl.stress_device)
        ok = (err <= 1e-6 and serr <= 1e-6 and gn == cn
              and len(gn) == n_steps
              and set(gfl.precond_branches) == {branch}
              and gfl.precond_branches == cfl.precond_branches)
        say(f"{label}: coarse cylinder {what} (f64), {gfl.n_dofs} dofs, "
            f"{n_steps} steps, CUDA vs CPU: solution rel err {err:.3e}, nodal stress "
            f"{serr:.3e} (rtol 1e-6); Newton per step CUDA {gn} CPU {cn}; "
            f"Krylov CUDA {gfl.krylov_iters} CPU {cfl.krylov_iters}; "
            f"branches {dict(gfl.precond_branches)}; {t_gpu:.2f} s CUDA, "
            f"{t_cpu:.2f} s CPU {'ok' if ok else 'FAILED'}")
        _require(label, ok, f"{what}: CUDA and CPU runs disagree")
        _check_launched(torch, label, gfl, launches, results,
                        _galerkin_levels(torch, gfl._pressure_mg))
        paths[f"coarse_{_slug(what)}"] = _path(launches, n_steps)

    def duct(entry):
        def run(dev):
            fl = ad.duct_case(pkg, "SCnsEX", refine=1, n_steps=6, device=dev)
            # the inlet BC dies after the third step
            fl.set_hard_coded_boundary_condition_time(0, 2.5 * ad.TIME_STEP)
            getattr(fl, entry)(verbose=False)
            return fl
        return run

    for entry in ("run", "run_on_device"):
        cuda_ops.reset_launches()
        gfl, t_gpu = _timed(torch, duct(entry), "cuda")
        launches = cuda_ops.launches.copy()
        cfl, t_cpu = _timed(torch, duct(entry), "cpu")
        err = _rel(gfl.present_solution, cfl.present_solution)
        ok = (err <= 1e-6 and gfl.krylov_iters["sweeps"] ==
              cfl.krylov_iters["sweeps"] and gfl.time.get_timestep() == 6
              and not gfl.hard_coded_bcs)
        say(f"{label}: coarse duct SCnsEX.{entry} (f64), {gfl.n_dofs} dofs, "
            f"6 steps, the inlet BC expiring after the third, CUDA vs CPU: "
            f"solution rel err {err:.3e} (rtol 1e-6); sweeps and CG "
            f"iterations CUDA {gfl.krylov_iters} CPU {cfl.krylov_iters}; "
            f"{t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
            f"{'ok' if ok else 'FAILED'}")
        _require(label, ok, f"SCnsEX.{entry}: CUDA and CPU runs disagree")
        _check_scnsex_launched(torch, label, gfl, launches, results)
        paths[f"coarse_duct_{entry}"] = _path(launches, 6)
    return paths


def _supg_window(torch, label, what, fl, stepper, sol, stress, n_steps,
                 start):
    """n_steps of a SUPG stepper, one call, with the counters read around
    it; prints the window's numbers and returns (solution, stress, worst
    relative residual, launches per step)."""
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.utils.timer import count_host_syncs
    k0, b0 = dict(fl.krylov_iters), sum(fl.precond_branches.values())
    l0 = cuda_ops.launches.copy()
    with count_host_syncs() as syncs:
        t0 = time.perf_counter()
        sol, stress, worst_rel, worst_it = stepper(sol, stress, n_steps,
                                                   start)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    k = {n: v - k0[n] for n, v in fl.krylov_iters.items()}
    solves = sum(fl.precond_branches.values()) - b0
    per_step = {key: n / n_steps
                for key, n in (cuda_ops.launches - l0).items()}
    say(f"{label}: {what}: {n_steps} timed steps in {seconds:.3f} s, "
        f"{1e3 * seconds / n_steps:.1f} ms/step, "
        f"{fl.n_dofs * n_steps / seconds:.1f} dof-steps/s; Newton "
        f"iterations {solves / n_steps:.2f} per step, worst {worst_it}; "
        f"Krylov {k}, outer FGMRES per Newton iteration "
        f"{k['outer'] / max(solves, 1):.2f}, Tpp GMRES per apply "
        f"{k['tpp'] / max(k['applies'], 1):.2f}; host syncs per step "
        f"{syncs['syncs'] / n_steps:.1f}; launches per step "
        f"{ {key: round(v, 1) for key, v in sorted(per_step.items())} }; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return sol, stress, worst_rel, per_step


def phase12_scnsim(torch, results, depth):
    """SCnsIM on the cylinder at refine 3 with the bench knobs: the
    coupled-stencil branch, then the element branch from the same state.
    depth: (warm-up, timed, element-branch timed) steps."""
    from openifem_tpu_torch import interop
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.la.stencil import PatchGrid
    label = "phase 12"
    pkg = fc.port_package()
    n_warm, n_timed, n_element = depth
    n_steps = 1 + n_warm + n_timed + n_element
    t0 = time.perf_counter()
    fl = fc.scnsim_case(pkg, n_steps=n_steps, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zorder = (PatchGrid._build_lattice(fl.mesh) is None
              and fl._sys_stencil is not None)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    fl.run_one_step(True, verbose=False)          # the inflow pulse
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = (fl.newton_iters, dict(fl.krylov_iters))
    vmax1 = fl.present_solution[:fl.n_u].max().item()
    pmax1 = fl.present_solution[fl.n_u:].max().item()
    builds_first = cuda_ops.plan_builds
    # the run loop's order: advance the BC clock, then the step
    fl.bc_time += fl.time.get_delta_t()
    table = fl.bc_value_table(n_warm + n_timed)
    stepper = fl.make_on_device_stepper(table)
    t0 = time.perf_counter()
    sol, stress, warm_rel, warm_it = stepper(
        fl.present_solution, fl.stress_device, n_warm)
    torch.cuda.synchronize()
    say(f"{label}: SCnsIM {fl.mesh.n_cells} cells, {fl.n_dofs} dofs, set up "
        f"in {setup_s:.2f} s; host first step (the inflow pulse) "
        f"{first_s:.2f} s, Newton {first[0]}, Krylov {first[1]}, vmax "
        f"{vmax1:.4f}, pmax {pmax1:.5f}; {n_warm}-step warm-up window "
        f"(worst rel res {warm_rel:.3e}, Newton {warm_it}) in "
        f"{time.perf_counter() - t0:.2f} s; z-order patches {zorder}")
    sol, stress, worst_rel, per_step = _supg_window(
        torch, label, "coupled stencil, stepper with the BC table (one "
        "call)", fl, stepper, sol, stress, n_timed, n_warm)
    launches = cuda_ops.launches.copy()
    late_builds = cuda_ops.plan_builds - builds_first
    tol = fl.params.fluid_tolerance
    finite = bool(torch.isfinite(sol).all()) and \
        bool(torch.isfinite(stress).all())
    vmax = sol[:fl.n_u].abs().max().item()
    branch = ("stencil", "stencil", "galerkin")
    ok = (max(worst_rel, warm_rel) < tol and finite and zorder
          and fl.n_dofs == SCNSIM_DOFS and late_builds == 0
          and set(fl.precond_branches) == {branch}
          and fl.mixed_precision_precond and not fl.f32_matrix
          and abs(vmax1 - fc.SCNSIM_UMAX) < 1e-6 and 0 < vmax < 20)
    say(f"{label}: worst rel res {worst_rel:.3e} (< {tol:.0e}), finite "
        f"{finite}, max |u| {vmax:.4f} (inflow peak {fc.SCNSIM_UMAX} on the "
        f"first step only), branches {dict(fl.precond_branches)}, plan "
        f"builds {cuda_ops.plan_builds} ({late_builds} after the first "
        f"step) {'ok' if ok else 'FAILED'}")
    _require(label, ok, "SCnsIM coupled-stencil run failed")
    _require(label, {k[0] for k in launches} == {"element_matvec"},
             f"layouts on the stencil branch: {sorted(launches)}")
    _check_launched(torch, label, fl, launches, results,
                    _galerkin_levels(torch, fl._pressure_mg))

    # the element branch from the same state
    for _ in range(n_warm + n_timed):
        fl.time.increment()
    fl.bc_time += (n_warm + n_timed - 1) * fl.time.get_delta_t()
    fl.present_solution, fl.stress_device = sol, stress
    el = fc.scnsim_case(pkg, n_steps=n_steps, device="cuda",
                        coupled_stencil=False)
    interop.load_fluid_state(el, interop.fluid_state(fl))
    el.bc_time += el.time.get_delta_t()
    table = el.bc_value_table(n_element)
    cuda_ops.reset_launches()
    builds0 = cuda_ops.plan_builds
    stepper = el.make_on_device_stepper(table)
    esol, estress, erel, el_per_step = _supg_window(
        torch, label, "element branch (coupled_stencil = False), stepper "
        "(one call)", el, stepper, el.present_solution, el.stress_device,
        n_element, 0)
    el_launches = cuda_ops.launches.copy()
    want = {"element_matvec_taylor_hood", "element_matvec_p_to_u_nodeblock",
            "element_matvec_u_to_p_nodeblock", "element_matvec"}
    finite = bool(torch.isfinite(esol).all()) and \
        bool(torch.isfinite(estress).all())
    ok = (erel < tol and finite and el._sys_stencil is None
          and set(el.precond_branches) == {
              ("element", "nodeblock", "galerkin")}
          and {k[0] for k in el_launches} == want)
    say(f"{label}: element branch worst rel res {erel:.3e}, finite {finite}, "
        f"branches {dict(el.precond_branches)}, layouts launched "
        f"{sorted({k[0] for k in el_launches})}, plan builds in the window "
        f"{cuda_ops.plan_builds - builds0} (its first steps) "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "SCnsIM element-branch run failed")
    _check_launched(torch, label, el, el_launches, results,
                    _galerkin_levels(torch, el._pressure_mg))
    return {"scnsim_r3": (launches, per_step),
            "scnsim_r3_element": (el_launches, el_per_step)}


def phase13_scnsex(torch, results):
    """SCnsEX on the acoustic duct through run_on_device, at the bench's
    size and refined twice more."""
    from openifem_tpu_torch.cases import acoustic_duct as ad
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.utils.timer import count_host_syncs
    label = "phase 13"
    pkg = ad.port_package()
    out = {}
    for name, run in DUCT_RUNS.items():
        fl = ad.duct_case(pkg, "SCnsEX", n_steps=DUCT_STEPS,
                          extra_refine=run["extra_refine"], device="cuda")
        torch.cuda.reset_peak_memory_stats()
        cuda_ops.reset_launches()
        builds0 = cuda_ops.plan_builds
        with count_host_syncs() as syncs:
            t0 = time.perf_counter()
            fl.run_on_device(verbose=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = cuda_ops.launches.copy()
        per_step = {k: n / DUCT_STEPS for k, n in launches.items()}
        k = fl.krylov_iters
        sol = fl.present_solution
        finite = bool(torch.isfinite(sol).all()) and \
            bool(torch.isfinite(fl.stress_device).all())
        vmax = sol[:fl.n_u].max().item()
        shapes = {(key[3], key[4]) for key in launches}
        ok = (finite and 0 < vmax < 7 and fl.n_dofs == run["dofs"]
              and fl.mesh.n_cells == run["cells"]
              and fl.time.get_timestep() == DUCT_STEPS
              and shapes == {(8, 8), (4, 4)}
              and {key[0] for key in launches} == {"element_matvec"}
              and cuda_ops.plan_builds - builds0 <= 2)
        say(f"{label} {name}: SCnsEX {fl.mesh.n_cells} cells, {fl.n_dofs} "
            f"dofs, time step {fl.time.get_delta_t():.3e}, {DUCT_STEPS} "
            f"steps through run_on_device (set-up and BC table included) in "
            f"{seconds:.3f} s, {1e3 * seconds / DUCT_STEPS:.2f} ms/step, "
            f"{fl.n_dofs * DUCT_STEPS / seconds:.1f} dof-steps/s; sweeps per "
            f"step {k['sweeps'] / DUCT_STEPS:.2f} (worst {fl.sweeps}), CG "
            f"iterations per sweep velocity {k['vel'] / k['sweeps']:.2f} "
            f"pressure {k['pre'] / k['sweeps']:.2f}; host syncs per step "
            f"{syncs['syncs'] / DUCT_STEPS:.1f}; launches per step "
            f"{ {key: round(v, 1) for key, v in sorted(per_step.items())} }; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; finite "
            f"{finite}, vmax {vmax:.4f} (pulse peak 6.0), plan builds "
            f"{cuda_ops.plan_builds - builds0} {'ok' if ok else 'FAILED'}")
        _require(label, ok, f"SCnsEX {name} failed")
        _check_scnsex_launched(torch, label, fl, launches, results)
        out[f"scnsex_{name}"] = (launches, per_step)
    return out


# -- the MPI-semantics coupler (fsi/mpi_fsi.py, cases/{mpi_block,
# fsi_wall_3d}.py) -----------------------------------------------------------

def _mpi_counts(fsi):
    return [(s["fluid_newton"], s["solid_retries"]) for s in fsi.step_log]


def _mpi_kernel_outputs(torch, fsi, state, dev):
    """Each _MPIKernels function and one RK4 step of the RKPM solid on
    `state` (numpy arrays), on `dev`."""
    t = {k: torch.as_tensor(v, device=dev) for k, v in state.items()}
    k, so = fsi._mpi_kernels, fsi.solid
    ind = k.indicator_all_vertices(t["x"])
    indf = ind.to(torch.float64)
    mask, vals = k.dirichlet_bc_mpi(t["x"], t["v"].reshape(-1))
    return [ind, mask, vals,
            k.fsi_stress_nodal(t["x"], t["f_stress"], t["s_stress"], indf),
            k.fsi_acc_nodal(t["x"], t["sol"], t["v"].reshape(-1),
                            t["acc"].reshape(-1), indf),
            *k.solid_bc_rows(t["disp"], t["sol"], t["f_stress"]),
            so._nodal_stress_impl(t["sigma"]),
            *so._device_step_impl(t["x"], t["v"], t["sigma"], t["rows"])]


def phase14_coarse_mpi(torch, results):
    """The 2-D block configurations and the truncated wall3d, CUDA vs
    CPU; then the coupler's kernels and the RKPM step on one state."""
    import numpy as np

    from openifem_tpu_torch.cases import fsi_wall_3d as fw
    from openifem_tpu_torch.cases import mpi_block as mb
    from openifem_tpu_torch.la import cuda_ops
    label = "phase 14"
    pkg = mb.port_package()
    paths = {}

    def block(config):
        def run(dev):
            fsi = mb.block_case(pkg, config, n_steps=COARSE_MPI_STEPS,
                                device=dev)
            fsi.run(verbose=False)
            return fsi
        return run

    def wall3d(dev):
        fsi = fw.wall3d_case(pkg, reps=fw.TRUNCATED,
                             n_steps=COARSE_MPI_STEPS,
                             bench_precision=False, device=dev)
        fsi.run(verbose=False)
        return fsi

    runs = [(f"block {c}", block(c)) for c in mb.CONFIGS]
    runs.append(("wall3d truncated", wall3d))
    for what, run in runs:
        cuda_ops.reset_launches()
        g, t_gpu = _timed(torch, run, "cuda")
        launches = cuda_ops.launches.copy()
        c, t_cpu = _timed(torch, run, "cpu")
        errs = {name: _rel(getattr(g.fluid if f else g.solid, attr),
                           getattr(c.fluid if f else c.solid, attr))
                for name, f, attr in (
                    ("fluid solution", True, "present_solution"),
                    ("nodal stress", True, "stress_device"),
                    ("solid displacement", False, "current_displacement"))}
        same = _mpi_counts(g) == _mpi_counts(c)
        ok = (same and all(e <= 1e-6 for e in errs.values())
              and len(g.step_log) == COARSE_MPI_STEPS
              and (what != "block contact"
                   or min(r for _, r in _mpi_counts(g)) >= 1)
              and torch.equal(g.fluid.indicator.cpu(), c.fluid.indicator))
        say(f"{label}: {what} (f64), {g.fluid.n_dofs} + {g.solid.n_dofs} "
            f"dofs, {COARSE_MPI_STEPS} steps (coupled "
            f"{[s['coupled'] for s in g.step_log]})"
            f", CUDA vs CPU: " + ", ".join(f"{k} rel err {v:.3e}"
                                           for k, v in errs.items())
            + f" (rtol 1e-6); (Newton, retries) per step CUDA "
            f"{_mpi_counts(g)} CPU {_mpi_counts(c)}; covered cells "
            f"{int(g.fluid.indicator.sum().item())}; launches "
            f"{dict(launches)}; {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
            f"{'ok' if ok else 'FAILED'}")
        _require(label, ok, f"{what}: CUDA and CPU runs disagree")
        fe_solid = g.solid if hasattr(g.solid, "cell_dofs") else None
        for name_dt in sorted({k[1] for k in launches}):
            dt = getattr(torch, name_dt)
            gen = torch.Generator(device="cuda").manual_seed(83)
            check_kernels(torch, label,
                          kernel_cases(torch, g.fluid, fe_solid, dt, gen),
                          dt, results, only=set(launches))
        paths[f"coarse_mpi_{_slug(what)}"] = _path(launches,
                                                   COARSE_MPI_STEPS)

    # the coupler's kernels and one RK4 step on the CPU run's state
    so, fl = c.solid, c.fluid
    rng = np.random.default_rng(14)
    d = so.dim
    state = dict(
        x=so.x.numpy(), v=so.v.numpy(), acc=so._acc.numpy(),
        sigma=so.sigma.numpy(), rows=so.fsi_stress_rows.numpy(),
        disp=so.current_displacement.numpy(),
        sol=fl.present_solution.numpy(), f_stress=fl.stress_device.numpy(),
        s_stress=so._nodal_stress_impl(so.sigma).numpy()
        + rng.normal(size=(so.n_p, d, d)))
    got = _mpi_kernel_outputs(torch, g, state, "cuda")
    ref = _mpi_kernel_outputs(torch, c, state, "cpu")
    names = ("indicator", "Dirichlet mask", "Dirichlet values",
             "fsi_stress_nodal", "fsi_acc_nodal", "solid_bc_rows rows",
             "solid_bc_rows p", "solid_bc_rows u", "_nodal_stress_impl",
             "RK4 x", "RK4 v", "RK4 sigma", "RK4 acc")
    equal = [torch.equal(a.cpu(), b) for a, b in zip(got[:2], ref[:2])]
    errs = [_rel(a, b) if b.abs().max() > 0 else
            (a.cpu() - b).abs().max().item()
            for a, b in zip(got[2:], ref[2:])]
    ok = all(equal) and all(e <= 1e-12 for e in errs) and bool(ref[0].any())
    say(f"{label}: _MPIKernels and the RKPM RK4 step on the truncated "
        f"wall3d's CPU state, CUDA vs CPU: " + ", ".join(
            [f"{n} equal {e}" for n, e in zip(names, equal)]
            + [f"{n} rel err {e:.3e}" for n, e in zip(names[2:], errs)])
        + f" (rtol 1e-12) {'ok' if ok else 'FAILED'}")
    _require(label, ok, "the coupler's kernels disagree")
    return paths


def phase15_wall3d(torch, results, depth):
    """fsi-wall-3D at full resolution with the bench knobs, through
    MPIFSI.run, with the launch counts zeroed just before and read just
    after."""
    from openifem_tpu_torch.cases import fsi_wall_3d as fw
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.utils.timer import DeviceSpans, count_host_syncs
    label = "phase 15"
    n_warm, n_timed = depth
    n_steps = 1 + n_warm + n_timed
    fsi = fw.wall3d_case(fw.port_package(), full_res=True, n_steps=n_steps,
                         device="cuda")
    # device time of the coupled step's solid RK4, coupling and fluid parts
    fsi.step_span = spans = DeviceSpans()
    per_step, real = [], fsi.run_one_coupled_step

    def coupled(*args, **kw):
        s0 = syncs["syncs"]
        k0 = dict(fsi.fluid.krylov_iters)
        l0 = cuda_ops.launches.copy()
        t0 = time.perf_counter()
        real(*args, **kw)
        torch.cuda.synchronize()
        per_step.append(dict(
            seconds=time.perf_counter() - t0, syncs=syncs["syncs"] - s0,
            newton=fsi.fluid.newton_iters, spans=spans.ms(),
            krylov={n: v - k0[n] for n, v in fsi.fluid.krylov_iters.items()},
            launches=cuda_ops.launches - l0))
    fsi.run_one_coupled_step = coupled
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    with count_host_syncs() as syncs:
        fsi.run(verbose=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = cuda_ops.launches.copy()
    peak = torch.cuda.max_memory_allocated()
    fl, so = fsi.fluid, fsi.solid
    n_dofs = fl.n_dofs + so.n_dofs
    first = fsi.step_log[0]
    setup_s = total - sum(s["seconds"] for s in fsi.step_log)
    say(f"{label}: fsi-wall-3D {fl.mesh.n_cells} fluid cells ({fl.n_u} + "
        f"{fl.n_p} dofs), {so.mesh.n_cells} solid cells ({so.n_p} particles"
        f", {so.n_dofs} dofs, K {so.idx_q.shape[1]}): {n_dofs} dofs; set up "
        f"in {setup_s:.2f} s; host first step {1e3 * first['seconds']:.1f} "
        f"ms, Newton {first['fluid_newton']}, Krylov {first['krylov']}; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    for i, s in enumerate(per_step):
        k = s["krylov"]
        sp = s["spans"]
        timed = i >= n_warm
        say(f"{label}: {'timed' if timed else 'warm-up'} coupled step "
            f"{i + 1}: {1e3 * s['seconds']:.1f} ms, "
            f"{n_dofs / s['seconds']:.1f} dof-steps/s (reference CPU "
            f"{REFERENCE_DOF_STEPS}); Newton {s['newton']}, outer FGMRES "
            f"{k['outer']} ({k['outer'] / max(s['newton'], 1):.2f} per "
            f"Newton iteration), Tpp GMRES per apply "
            f"{k['tpp'] / max(k['applies'], 1):.2f}; host syncs "
            f"{s['syncs']}; device spans solid RK4 "
            f"{sp.get('solid RK4', 0):.2f} ms, coupling "
            f"{sp.get('coupling', 0):.2f} ms, fluid Newton "
            f"{sp.get('fluid Newton', 0):.2f} ms; launches "
            f"{dict(s['launches'])}")
    timed = per_step[n_warm:]
    ms = [1e3 * s["seconds"] for s in timed]
    t_per = {key: n / len(timed) for key, n in
             sum((s["launches"] for s in timed), Counter()).items()}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        fl.present_solution, fl.stress_device, so.x, so.v, so.sigma))
    covered = int(fl.indicator.sum().item())
    rows = so.fsi_stress_rows.abs().max().item()
    vmax = fl.present_solution[:fl.n_u].abs().max().item()
    ok = (n_dofs == WALL3D_DOFS and finite and covered > 0 and rows > 0
          and len(per_step) == n_warm + n_timed
          and [s["coupled"] for s in fsi.step_log] ==
          [False] + [True] * (n_warm + n_timed)
          and fl.tpp_branch() == "dense" and fl.outer_branch() == "element"
          and so.f32_rates and fl.f32_matrix)
    say(f"{label}: {len(timed)} timed steps, {statistics.mean(ms):.1f} "
        f"ms/step mean, {statistics.median(ms):.1f} median, "
        f"{n_dofs * len(ms) / (sum(ms) / 1e3):.1f} dof-steps/s; every step "
        f"converged; finite {finite}, max |u| {vmax:.4f}, covered cells "
        f"{covered}, max |fsi_stress_rows| {rows:.4e}; branches "
        f"{dict(fl.precond_branches)} {'ok' if ok else 'FAILED'}")
    _require(label, ok, "fsi-wall-3D failed")
    _check_launched(torch, label, fl, launches, results)
    return launches, t_per


# -- the vocal fold: ControlVolumeFSI with Spalart-Allmaras ----------------

def sa_kernel_cases(torch, tm, dt, gen):
    """The scalar layout at the Spalart-Allmaras model's own table (its
    Newton matrix), with random blocks from `gen`."""
    from openifem_tpu_torch.la import operators as ops
    n_c, nl = tm.cell_dofs.shape
    A = torch.randn(n_c, nl, nl, generator=gen, device="cuda", dtype=dt)
    x = torch.randn(tm.n, generator=gen, device="cuda", dtype=dt)
    return [("element_matvec", n_c, "SA Newton",
             lambda: ops.element_matvec(A, tm.cell_dofs, tm.n, x),
             lambda: ops.element_matvec_plain(A, tm.cell_dofs, tm.n, x))]


def _check_vocal_fold_launched(torch, label, fsi, launches, results):
    """Hold every shape a vocal-fold path launched against its plain
    version: the SA model's table first, then the fluid's and the
    solid's."""
    tm = fsi.fluid.turbulence_model
    for name_dt in sorted({k[1] for k in launches}):
        dt = getattr(torch, name_dt)
        gen = torch.Generator(device="cuda").manual_seed(89)
        check_kernels(torch, label, sa_kernel_cases(torch, tm, dt, gen), dt,
                      results, only=set(launches))
        check_kernels(torch, label,
                      kernel_cases(torch, fsi.fluid, fsi.solid, dt, gen), dt,
                      results, only=set(launches))


def _vocal_counts(fsi):
    """(fluid Newton, SA Newton, contact retries) per step."""
    return [(s["fluid_newton"], s["sa_newton"], s["solid_retries"])
            for s in fsi.step_log]


def _cv_close(got, want, rtol=1e-6):
    """Budget keys of two cv_history entries that disagree beyond rtol
    (1e-12 absolute near 0)."""
    return {k: (got[k], want[k]) for k in want
            if not abs(got[k] - want[k]) <= max(rtol * abs(want[k]), 1e-12)}


def phase16_coarse_vocal_fold(torch, results):
    """The coarse vocal fold through ControlVolumeFSI.run, CUDA vs CPU;
    then the standalone SCnsIM + SA through run_on_device against run()
    on the card; every shape launched against its plain version."""
    from openifem_tpu_torch.cases import vocal_fold as vf
    from openifem_tpu_torch.la import cuda_ops
    label = "phase 16"
    pkg = vf.port_package()

    def run(dev):
        fsi = vf.vocal_fold_case(pkg, COARSE_VOCAL_STEPS, device=dev)
        fsi.run(verbose=False)
        return fsi

    cuda_ops.reset_launches()
    g, t_gpu = _timed(torch, run, "cuda")
    launches = cuda_ops.launches.copy()
    c, t_cpu = _timed(torch, run, "cpu")
    gt, ct = g.fluid.turbulence_model, c.fluid.turbulence_model
    errs = {"fluid solution": _rel(g.fluid.present_solution,
                                   c.fluid.present_solution),
            "nu~": _rel(gt.present_solution, ct.present_solution),
            "solid displacement": _rel(g.solid.current_displacement,
                                       c.solid.current_displacement),
            "shear velocities": _rel(g.shear_velocities,
                                     c.shear_velocities)}
    bad = [_cv_close(a, b) for a, b in zip(g.cv_history, c.cv_history)]
    n_dofs = g.fluid.n_dofs + gt.n + g.solid.n_dofs
    ok = (_vocal_counts(g) == _vocal_counts(c)
          and len(g.step_log) == COARSE_VOCAL_STEPS
          and all(e <= 1e-6 for e in errs.values()) and not any(bad)
          and len(g.cv_history) == len(c.cv_history) == COARSE_VOCAL_STEPS
          and n_dofs == vf.DOFS[vf.COARSE]
          and torch.equal(g.fluid.indicator.cpu(), c.fluid.indicator))
    say(f"{label}: coarse vocal fold (f64), {g.fluid.n_dofs} + {gt.n} + "
        f"{g.solid.n_dofs} = {n_dofs} dofs, {COARSE_VOCAL_STEPS} steps, CUDA "
        f"vs CPU: "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in errs.items())
        + f" (rtol 1e-6); {len(g.cv_history[-1])} cv_history keys per "
        f"step, beyond 1e-6: {bad}; (Newton, SA Newton, retries) per step "
        f"CUDA {_vocal_counts(g)} CPU {_vocal_counts(c)}; covered cells "
        f"{int(g.fluid.indicator.sum().item())}; launches "
        f"{dict(launches)}; {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "coarse vocal fold: CUDA and CPU runs disagree")
    _check_vocal_fold_launched(torch, label, g, launches, results)
    paths = {"coarse_vocal_fold": _path(launches, COARSE_VOCAL_STEPS)}

    # the standalone fluid with the model: the stepper against run()
    runs = {}
    for entry in ("run", "run_on_device"):
        fl = vf.standalone_fluid(pkg, COARSE_VOCAL_STEPS, device="cuda")
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        getattr(fl, entry)(verbose=False)
        torch.cuda.synchronize()
        runs[entry] = (fl, time.perf_counter() - t0, cuda_ops.launches.copy())
    (h, t_h, l_h), (s, t_s, l_s) = runs["run"], runs["run_on_device"]
    errs = {"fluid solution": _rel(s.present_solution, h.present_solution),
            "nu~": _rel(s.turbulence_model.present_solution,
                        h.turbulence_model.present_solution),
            "eddy viscosity": _rel(s.eddy_viscosity_nodal,
                                   h.eddy_viscosity_nodal)}
    ok = (all(e <= 1e-6 for e in errs.values())
          and s.time.get_timestep() == h.time.get_timestep()
          == COARSE_VOCAL_STEPS)
    say(f"{label}: standalone SCnsIM + SA (f64, {h.n_dofs} + "
        f"{h.turbulence_model.n} dofs), {COARSE_VOCAL_STEPS} steps, "
        f"run_on_device vs run() on "
        f"CUDA: " + ", ".join(f"{k} rel err {v:.3e}"
                              for k, v in errs.items())
        + f" (rtol 1e-6); {t_s:.2f} s vs {t_h:.2f} s; launches "
        f"{dict(l_s)} {'ok' if ok else 'FAILED'}")
    _require(label, ok, "the SA stepper disagrees with run()")
    for fl, launched in ((h, l_h), (s, l_s)):
        for name_dt in sorted({k[1] for k in launched}):
            dt = getattr(torch, name_dt)
            gen = torch.Generator(device="cuda").manual_seed(91)
            check_kernels(torch, label, sa_kernel_cases(
                torch, fl.turbulence_model, dt, gen), dt, results,
                only=set(launched))
        _check_launched(torch, label, fl, launched, results)
    paths["coarse_scnsim_sa_run"] = _path(l_h, COARSE_VOCAL_STEPS)
    paths["coarse_scnsim_sa_stepper"] = _path(l_s, COARSE_VOCAL_STEPS)
    return paths


def phase17_vocal_fold(torch, results, depth):
    """The vocal fold at full size through ControlVolumeFSI.run, with the
    launch counts zeroed just before and read just after."""
    from openifem_tpu_torch.cases import vocal_fold as vf
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.utils.timer import DeviceSpans, count_host_syncs
    label = "phase 17"
    n_warm, n_timed = depth
    n_steps = 1 + n_warm + n_timed
    fsi = vf.vocal_fold_case(vf.port_package(), n_steps, vf.FULL,
                             knobs=vf.BENCH_KNOBS, device="cuda")
    fl, so = fsi.fluid, fsi.solid
    tm = fl.turbulence_model
    # device time of the step's solid, coupling, SA, fluid Newton and CV
    # analysis parts
    fsi.step_span = spans = DeviceSpans()
    per_step, marks = [], {}
    real_phases, real_after = fsi._run_phases, fsi._after_step

    def phases(*args, **kw):
        marks.update(syncs=syncs["syncs"], krylov=dict(fl.krylov_iters),
                     launches=cuda_ops.launches.copy(),
                     sa=tm.krylov_iters["fgmres"])
        return real_phases(*args, **kw)

    def after():
        real_after()
        per_step.append(dict(
            syncs=syncs["syncs"] - marks["syncs"], spans=spans.ms(),
            newton=fl.newton_iters, sa_newton=tm.newton_iters,
            sa_fgmres=tm.krylov_iters["fgmres"] - marks["sa"],
            krylov={n: v - marks["krylov"][n]
                    for n, v in fl.krylov_iters.items()},
            launches=cuda_ops.launches - marks["launches"]))
    fsi._run_phases, fsi._after_step = phases, after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    with count_host_syncs() as syncs:
        fsi.run(verbose=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = cuda_ops.launches.copy()
    peak = torch.cuda.max_memory_allocated()
    n_dofs = fl.n_dofs + tm.n + so.n_dofs
    setup_s = total - sum(s["seconds"] for s in fsi.step_log)
    say(f"{label}: vocal fold {fl.mesh.n_cells} fluid cells ({fl.n_u} + "
        f"{fl.n_p} dofs), SA {tm.n} dofs, {so.mesh.n_cells} solid cells "
        f"({so.n_dofs} dofs): {n_dofs} dofs; knobs {vf.BENCH_KNOBS}; set up "
        f"in {setup_s:.2f} s; peak device memory {peak / 2**20:.1f} MiB")
    for i, (s, log) in enumerate(zip(per_step, fsi.step_log)):
        k, sp = s["krylov"], s["spans"]
        kind = ("host first" if i == 0 else
                "warm-up" if i <= n_warm else "timed")
        say(f"{label}: {kind} step {i + 1}: {1e3 * log['seconds']:.1f} ms, "
            f"{n_dofs / log['seconds']:.1f} dof-steps/s (reference CPU "
            f"{REFERENCE_DOF_STEPS}); Newton {s['newton']}, outer FGMRES "
            f"{k['outer']}, Tpp GMRES {k['tpp']} "
            f"({k['tpp'] / max(k['applies'], 1):.2f} per apply); SA Newton "
            f"{s['sa_newton']}, SA FGMRES {s['sa_fgmres']}; contact retries "
            f"{log['solid_retries']}; host syncs {s['syncs']}; device spans "
            + ", ".join(f"{name} {sp.get(name, 0):.2f} ms" for name in (
                "solid", "coupling", "SA", "fluid Newton", "CV analysis"))
            + f"; launches {dict(s['launches'])}")
    timed = per_step[1 + n_warm:]
    ms = [1e3 * log["seconds"] for log in fsi.step_log[1 + n_warm:]]
    t_per = {key: n / len(timed) for key, n in
             sum((s["launches"] for s in timed), Counter()).items()}
    eddy = tm.eddy_viscosity_nodal
    finite = all(bool(torch.isfinite(t).all()) for t in (
        fl.present_solution, fl.stress_device, tm.present_solution,
        so.current_displacement))
    cv_finite = all(math.isfinite(v) for h in fsi.cv_history
                    for v in h.values())
    ke = min(h["present_KE"] for h in fsi.cv_history)
    covered = int(fl.indicator.sum().item())
    eddy_ok = bool(torch.isfinite(eddy).all()) and eddy.min().item() >= 0
    ok = (n_dofs == vf.DOFS[vf.FULL] and finite and cv_finite and ke >= 0
          and eddy_ok and covered > 0 and len(per_step) == n_steps
          and len(fsi.cv_history) == n_steps
          and not any(s["coupled"] for s in fsi.step_log)
          and fl.tpp_branch() == "dense" and fl.outer_branch() == "element")
    last = fsi.cv_history[-1]
    say(f"{label}: {len(ms)} timed steps, {statistics.mean(ms):.1f} "
        f"ms/step mean, {statistics.median(ms):.1f} median, "
        f"{n_dofs * len(ms) / (sum(ms) / 1e3):.1f} dof-steps/s; every step "
        f"converged; finite {finite}, cv_history finite {cv_finite}, min "
        f"present_KE {ke:.6e}, eddy viscosity in [{eddy.min().item():.4e}, "
        f"{eddy.max().item():.4e}], covered cells {covered}, max shear "
        f"velocity {fsi.shear_velocities.max().item():.4e}; last budgets "
        + ", ".join(f"{k} {last[k]:.6e}" for k in vf.SUMMARY_KEYS)
        + f"; branches {dict(fl.precond_branches)} "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "the vocal fold at full size failed")
    _check_vocal_fold_launched(torch, label, fsi, launches, results)
    return launches, t_per


# -- AMR, checkpoints and the flat shell -----------------------------------

def _snapshot(fl, levels=()):
    """(the tables of a fluid solver's current mesh that kernel_cases
    reads, the pressure V-cycle's levels): a refinement replaces the
    solver's tables, so each mesh's are kept for the kernel checks."""
    from types import SimpleNamespace
    names = ("dim", "nlu", "nu_loc", "nlp", "n_u", "n_p", "n_dofs",
             "cell_dofs", "cell_dofs_u", "cell_dofs_p", "cell_nodes_u")
    snap = SimpleNamespace(mesh=SimpleNamespace(n_cells=fl.mesh.n_cells),
                           **{n: getattr(fl, n) for n in names
                              if hasattr(fl, n)})
    return snap, tuple(levels)


def _record_tables(fl):
    """A list holding the fluid's current tables (when set up) and, after
    every later setup(), the new mesh's."""
    snaps = []
    if getattr(fl, "_setup_done", False):
        mg = getattr(fl, "_pressure_mg", None)
        snaps.append(_snapshot(fl, mg.levels if mg is not None else ()))
    real = fl.setup

    def setup(*args, **kw):
        out = real(*args, **kw)
        snaps.append(_snapshot(fl))
        return out
    fl.setup = setup
    return snaps


def _check_snapshots(torch, label, snaps, solid, launches, results,
                     seed=181):
    """Hold every shape in `launches` against its plain version at the
    tables of each mesh a path ran on (and the solid's)."""
    for name_dt in sorted({k[1] for k in launches}):
        dt = getattr(torch, name_dt)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for snap, levels in snaps:
            check_kernels(torch, label,
                          kernel_cases(torch, snap, solid, dt, gen, levels),
                          dt, results, only=set(launches))


def shell_kernel_cases(torch, shell, dt, gen, what="shell stiffness"):
    """The scalar layout at the flat shell's own table (5 dofs x 4 nodes
    per cell: 20 x 20 blocks for Q1), or another scalar table, with random
    blocks from `gen`."""
    from openifem_tpu_torch.la import operators as ops
    n_c, nl = shell.cell_dofs.shape
    A = torch.randn(n_c, nl, nl, generator=gen, device="cuda", dtype=dt)
    x = torch.randn(shell.n_dofs, generator=gen, device="cuda", dtype=dt)
    return [("element_matvec", n_c, what,
             lambda: ops.element_matvec(A, shell.cell_dofs, shell.n_dofs, x),
             lambda: ops.element_matvec_plain(A, shell.cell_dofs,
                                              shell.n_dofs, x))]


def _check_shell(torch, label, shell, launches, results):
    for name_dt in sorted({k[1] for k in launches}):
        dt = getattr(torch, name_dt)
        gen = torch.Generator(device="cuda").manual_seed(191)
        check_kernels(torch, label, shell_kernel_cases(torch, shell, dt, gen),
                      dt, results, only=set(launches))


class _InDir:
    """Run in a fresh subdirectory of the working directory (checkpoints
    are written to the working directory)."""

    def __init__(self, name):
        self.path = os.path.abspath(name)

    def __enter__(self):
        self.back = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)
        return self.path

    def __exit__(self, *exc):
        os.chdir(self.back)


def _on_card(torch, fn, *args, **kw):
    """(fn's result, its launches, seconds) with the counts zeroed just
    before and read just after."""
    from openifem_tpu_torch.la import cuda_ops
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, cuda_ops.launches.copy(), time.perf_counter() - t0


def phase18_coarse_amr(torch, results):
    """AMR, checkpoints and the shell, coarse, CUDA against CPU (f64):
    the leaflet with interface refinement and a save every 2 steps, then
    a restart on the card; the cylinder with Kelly AMR every step; the
    2-D MPI block saved at step 2 and restarted; the shell plate and
    bar.  Then every shape launched against its plain version."""
    import numpy as np

    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.cases import fsi_disc as fd
    from openifem_tpu_torch.cases import mpi_block as mb
    from openifem_tpu_torch.cases import shell_plate as sp
    label = "phase 18"
    pkg = fc.port_package()
    paths = {}

    # (a) the coarse leaflet: FSI.run, refinement and save every 2 steps
    def leaflet(dev, stop=4, resume=False):
        fsi = _leaflet_solvers(dev, 0.1, (0, 1), 4, "element",
                               refine_every=2, save_every=2)
        # interrupted after step `stop`, its parameters unchanged (a
        # shorter end time would skip the initial refinement)
        fsi.time.time_end = stop * fsi.params.time_step
        snaps = _record_tables(fsi.fluid)
        cells = []
        real = fsi.refine_mesh

        def refine(*args, **kw):
            real(*args, **kw)
            cells.append(fsi.fluid.mesh.n_cells)
        fsi.refine_mesh = refine
        (fsi.resume if resume else fsi.run)(verbose=False)
        return fsi, snaps, cells

    with _InDir("leaflet_cuda"):
        (g, g_snaps, g_cells), launches, t_gpu = _on_card(torch, leaflet,
                                                          "cuda")
    with _InDir("leaflet_cpu"):
        t0 = time.perf_counter()
        c, _, c_cells = leaflet("cpu")
        t_cpu = time.perf_counter() - t0
    with _InDir("leaflet_restart"):
        (_, p_snaps, _), l2, _ = _on_card(torch, leaflet, "cuda", 2)
        (r, r_snaps, _), l3, _ = _on_card(torch, leaflet, "cuda", 4, True)
    errs = {"fluid solution": _rel(g.fluid.present_solution,
                                   c.fluid.present_solution),
            "solid displacement": _rel(g.solid.current_displacement,
                                       c.solid.current_displacement)}
    restart = {"fluid solution": _rel(r.fluid.present_solution,
                                      g.fluid.present_solution),
               "solid displacement": _rel(r.solid.current_displacement,
                                          g.solid.current_displacement)}
    same_mesh = (np.array_equal(g.fluid.mesh.cells, c.fluid.mesh.cells)
                 and np.array_equal(r.fluid.mesh.cells, g.fluid.mesh.cells)
                 and g_cells == c_cells)
    ok = (same_mesh and _counts(g) == _counts(c) and len(g.step_log) == 4
          and all(e <= 1e-6 for e in errs.values())
          and all(e <= 1e-10 for e in restart.values())
          and r.time.get_timestep() == 4 and len(r.step_log) == 2)
    say(f"{label}: coarse leaflet (element branch, f64) through FSI.run, "
        f"interface refinement and a save every 2 steps, 4 steps: fluid "
        f"cells after each refinement CUDA {g_cells} CPU {c_cells}, "
        f"{g.fluid.n_dofs} + {g.solid.n_dofs} dofs at the end; CUDA vs CPU "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in errs.items())
        + f" (rtol 1e-6); Newton (solid, fluid) per step CUDA {_counts(g)}"
        f" CPU {_counts(c)}; restart on the card from the step-2 "
        f"checkpoints to step 4 against the uninterrupted card run: "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in restart.items())
        + f" (rtol 1e-10); {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "coarse leaflet with AMR and restart failed")
    _check_snapshots(torch, label, g_snaps + p_snaps + r_snaps, g.solid,
                     launches + l2 + l3, results)
    # one path per run: the uninterrupted run, the run cut after step 2
    # and the restart to step 4
    paths.update(coarse_amr_leaflet=_path(launches, 4),
                 coarse_amr_leaflet_to_step2=_path(l2, 2),
                 coarse_amr_leaflet_resume=_path(l3, 2))

    # the disc in the cavity, whose interface refinement changes the mesh
    def disc(dev, stop=4, resume=False):
        fsi = fd.disc_case(pkg, 4, refine_every=2, save_every=2, device=dev)
        fsi.time.time_end = stop * fsi.params.time_step
        snaps = _record_tables(fsi.fluid)
        (fsi.resume if resume else fsi.run)(verbose=False)
        return fsi, snaps

    with _InDir("disc_cuda"):
        (gd, d_snaps), dl, t_gpu = _on_card(torch, disc, "cuda")
    with _InDir("disc_cpu"):
        t0 = time.perf_counter()
        cd, _ = disc("cpu")
        t_cpu = time.perf_counter() - t0
    with _InDir("disc_restart"):
        (_, dp_snaps), dl2, _ = _on_card(torch, disc, "cuda", 2)
        (rd, dr_snaps), dl3, _ = _on_card(torch, disc, "cuda", 4, True)
    gm, cm = gd.fluid.mesh, cd.fluid.mesh
    same_mesh = (np.array_equal(gm.cells, cm.cells)
                 and np.array_equal(gm.level, cm.level)
                 and np.array_equal(gm.vertices, cm.vertices))
    errs = {"fluid solution": _rel(gd.fluid.present_solution,
                                   cd.fluid.present_solution),
            "solid displacement": _rel(gd.solid.current_displacement,
                                       cd.solid.current_displacement)}
    restart = {"fluid solution": _rel(rd.fluid.present_solution,
                                      gd.fluid.present_solution),
               "solid displacement": _rel(rd.solid.current_displacement,
                                          gd.solid.current_displacement)}
    cells = [snap.mesh.n_cells for snap, _ in d_snaps]
    ok = (same_mesh and _counts(gd) == _counts(cd) and len(gd.step_log) == 4
          and all(e <= 1e-6 for e in errs.values()) and len(set(cells)) > 1
          and np.array_equal(rd.fluid.mesh.cells, gm.cells)
          and all(e <= 1e-10 for e in restart.values())
          and len(rd.step_log) == 2)
    say(f"{label}: disc in the cavity (f64) through FSI.run, interface "
        f"refinement x2 before the first step and after every 2 steps, a "
        f"save every 2, 4 steps: fluid cells of each mesh set up {cells}, "
        f"meshes equal {same_mesh}; CUDA vs CPU " + ", ".join(
            f"{k} rel err {v:.3e}" for k, v in errs.items())
        + f" (rtol 1e-6); Newton (solid, fluid) per step CUDA {_counts(gd)}"
        f" CPU {_counts(cd)}; FSI.resume on the card from the step-2 "
        f"checkpoints (the adapted mesh rebuilt from the file) to step 4 "
        f"against the uninterrupted card run: " + ", ".join(
            f"{k} rel err {v:.3e}" for k, v in restart.items())
        + f" (rtol 1e-10); {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "the disc with interface refinement: CUDA and CPU "
             "disagree, or the restart does")
    _check_snapshots(torch, label, d_snaps + dp_snaps + dr_snaps, gd.solid,
                     dl + dl2 + dl3, results)
    paths.update(coarse_amr_disc=_path(dl, 4),
                 coarse_amr_disc_to_step2=_path(dl2, 2),
                 coarse_amr_disc_resume=_path(dl3, 2))

    # (b) the cylinder at refine 1: InsIM.run with Kelly AMR every step
    def cylinder(dev):
        fl = fc.cylinder_case(pkg, "r1", refine=1, n_steps=KELLY_STEPS,
                              bench_precision=False, device=dev)
        dt = fl.params.time_step
        fl.params.refinement_interval = fl.time.refinement_interval = dt
        snaps = _record_tables(fl)
        per_step = []
        real = fl.run_one_step

        def step(*args, **kw):
            real(*args, **kw)
            per_step.append((fl.newton_iters, fl.mesh.n_cells, fl.n_dofs))
        fl.run_one_step = step
        fl.run(verbose=False)
        return fl, snaps, per_step

    (gc, c_snaps, g_steps), cyl, t_gpu = _on_card(torch, cylinder, "cuda")
    t0 = time.perf_counter()
    cc, _, c_steps = cylinder("cpu")
    t_cpu = time.perf_counter() - t0
    err = _rel(gc.present_solution, cc.present_solution)
    ok = (g_steps == c_steps and len(g_steps) == KELLY_STEPS and err <= 1e-6
          and np.array_equal(gc.mesh.cells, cc.mesh.cells)
          and g_steps[-1][1] > c_snaps[0][0].mesh.n_cells)
    say(f"{label}: cylinder r1 (f64) through InsIM.run, Kelly AMR (levels "
        f"1..3) after every step, {KELLY_STEPS} steps: (Newton, cells, dofs "
        f"after the "
        f"step's refinement) CUDA {g_steps} CPU {c_steps}; solution rel err"
        f" {err:.3e} (rtol 1e-6); {t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "the cylinder with Kelly AMR: CUDA and CPU disagree")
    _check_snapshots(torch, label, c_snaps, None, cyl, results)
    paths["coarse_amr_cylinder"] = _path(cyl, KELLY_STEPS)

    # (c) the 2-D MPI block: saved at step 2, restarted to step 4
    def block(dev, n_steps):
        fsi = mb.block_case(pkg, "body_force", n_steps=n_steps, device=dev)
        fsi.params.save_interval = fsi.time.save_interval = \
            2 * fsi.params.time_step
        fsi.run(verbose=False)
        return fsi

    with _InDir("block_cuda"):
        gb, b1, t_gpu = _on_card(torch, block, "cuda", 4)
    with _InDir("block_cpu"):
        t0 = time.perf_counter()
        cb = block("cpu", 4)
        t_cpu = time.perf_counter() - t0
    with _InDir("block_restart"):
        _, b2, _ = _on_card(torch, block, "cuda", 2)
        rb, b3, _ = _on_card(torch, block, "cuda", 4)
    errs = {name: _rel(getattr(f(gb), attr), getattr(f(cb), attr))
            for name, f, attr in (
                ("fluid solution", lambda x: x.fluid, "present_solution"),
                ("solid displacement", lambda x: x.solid,
                 "current_displacement"))}
    restart = {name: _rel(getattr(f(rb), attr), getattr(f(gb), attr))
               for name, f, attr in (
                   ("fluid solution", lambda x: x.fluid, "present_solution"),
                   ("solid displacement", lambda x: x.solid,
                    "current_displacement"))}
    ok = (_mpi_counts(gb) == _mpi_counts(cb) and len(rb.step_log) == 2
          and all(e <= 1e-6 for e in errs.values())
          and all(e <= BLOCK_RESTART_TOL for e in restart.values()))
    say(f"{label}: 2-D MPI block (body force, f64) through MPIFSI.run, 4 "
        f"steps with a save at steps 2 and 4, CUDA vs CPU: "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in errs.items())
        + f" (rtol 1e-6); (Newton, retries) per step CUDA {_mpi_counts(gb)}"
        f" CPU {_mpi_counts(cb)}; MPIFSI.run restarted on the card from the "
        f"step-2 checkpoints, steps {[s['step'] for s in rb.step_log]}, "
        f"against the uninterrupted card run: "
        + ", ".join(f"{k} rel err {v:.3e}" for k, v in restart.items())
        + f" (rtol {BLOCK_RESTART_TOL:.0e}); {t_gpu:.2f} s CUDA, "
        f"{t_cpu:.2f} s CPU "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "the MPI block save / restart failed")
    blk = b1 + b2 + b3
    for name_dt in sorted({k[1] for k in blk}):
        dt = getattr(torch, name_dt)
        gen = torch.Generator(device="cuda").manual_seed(183)
        check_kernels(torch, label,
                      kernel_cases(torch, gb.fluid, gb.solid, dt, gen), dt,
                      results, only=set(blk))
    paths.update(coarse_block=_path(b1, 4), coarse_block_to_step2=_path(b2, 2),
                 coarse_block_restart=_path(b3, 2))

    # (d) the flat shell: the plate (16 x 16) and the bar (16 x 4)
    for case, cells in (("plate", (16, 16)), ("bar", (16, 4))):
        def solve(dev):
            shell = sp.shell_case(pkg, case, cells, device=dev)
            shell.run()
            return shell
        gs, sl, t_gpu = _on_card(torch, solve, "cuda")
        t0 = time.perf_counter()
        cs = solve("cpu")
        t_cpu = time.perf_counter() - t0
        err = _rel(gs.get_current_solution(), cs.get_current_solution())
        # all five local dofs per node: translations and rotations
        rot = _rel(gs.local_solution, cs.local_solution)
        w, ref = sp.measured(gs, case), sp.closed_form(case)
        # the CG stops at 1e-10 ||b||; the kernel and the CPU's index_add_
        # sum in different orders, so the last residual may cross that
        # line one iteration apart
        ok = (err <= 1e-10 and rot <= 1e-10
              and abs(gs.cg_iters - cs.cg_iters) <= 1
              and abs(w - ref) / ref < (0.04 if case == "plate" else 0.02))
        say(f"{label}: shell {case} {cells[0]} x {cells[1]} ({gs.n_dofs} "
            f"dofs, {gs.mesh2.n_cells} cells of 20 x 20 f64 blocks), CUDA vs"
            f" CPU: displacement rel err {err:.3e}, local dofs with the "
            f"rotations {rot:.3e} "
            f"(rtol 1e-10); CG iterations CUDA {gs.cg_iters} CPU "
            f"{cs.cg_iters} (at most 1 apart); "
            f"{'centre deflection' if case == 'plate' else 'tip'}"
            f" {w:.6e} against {ref:.6e} ({100 * (w - ref) / ref:+.2f} %); "
            f"{t_gpu:.2f} s CUDA, {t_cpu:.2f} s CPU "
            f"{'ok' if ok else 'FAILED'}")
        _require(label, ok, f"the shell {case}: CUDA and CPU disagree")
        _check_shell(torch, label, gs, sl, results)
        paths[f"coarse_shell_{case}"] = _path(sl, 1)
    return paths


def phase19_adaptive(torch, results, n_steps):
    """The adaptive leaflet at full width (path A's configuration with
    interface refinement every 2 steps and a checkpoint every 5) through
    FSI.run, then resumed on the card from its first checkpoint; the
    shell plate at 64 x 64 cells.  Launch counts zeroed just before each
    and read just after."""
    import shutil

    from openifem_tpu_torch.cases import shell_plate as sp
    from openifem_tpu_torch.cases.fsi_leaflet import ADAPTIVE
    from openifem_tpu_torch.fe import transfer as tr
    from openifem_tpu_torch.la import cuda_ops, dense
    from openifem_tpu_torch.la import operators as ops
    from openifem_tpu_torch.mesh.mesh import Mesh
    label = "phase 19"
    knobs = {k: v for k, v in ADAPTIVE.items() if k != "config"}
    timers = Counter()

    def timed(owner, name, key):
        """Wrap owner.name to add its synchronised seconds to timers[key];
        returns the undo."""
        real = getattr(owner, name)

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            timers[key] += time.perf_counter() - t0
            return out
        setattr(owner, name, wrapper)
        return lambda: setattr(owner, name, real)

    def case(n):
        fsi = _leaflet_solvers("cuda", FULL_H, (0, 2), n, ADAPTIVE["config"],
                               **knobs)
        return fsi, _record_tables(fsi.fluid)

    undo = [timed(Mesh, "coarsen", "coarsen + refine"),
            timed(Mesh, "refine", "coarsen + refine"),
            timed(tr, "transfer_nodal_field", "transfer"),
            timed(ops, "make_gather_plan", "plan builds"),
            timed(dense, "condensed_dense", "dense blocks")]
    saved = os.path.abspath("saved")
    try:
        with _InDir("adaptive"):
            fsi, snaps = case(n_steps)
            fl, so = fsi.fluid, fsi.solid
            n0 = None
            undo.append(timed(fl, "setup", "setup"))
            undo.append(timed(fsi, "_setup_coupling", "coupling tables"))
            refinements, steps, saves = [], [], []
            real_refine, real_save = fsi.refine_mesh, fsi.save_checkpoint
            real_phases, real_coupled = fsi._run_phases, \
                fsi.run_one_coupled_step

            def refine(*args, **kw):
                before = dict(timers)
                mesh0 = fl.mesh
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                real_refine(*args, **kw)
                torch.cuda.synchronize()
                split = {k: v - before.get(k, 0.0) for k, v in timers.items()
                         if v - before.get(k, 0.0) > 0}
                refinements.append(dict(
                    step=fsi.time.get_timestep(),
                    seconds=time.perf_counter() - t0, split=split,
                    cells=(mesh0.n_cells, fl.mesh.n_cells),
                    changed=fl.mesh is not mesh0,
                    dofs=fl.n_dofs + so.n_dofs))

            def save():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                real_save()
                seconds = time.perf_counter() - t0
                step = fsi.time.get_timestep()
                files = [f"{p}-{step:06d}.checkpoint.npz"
                         for p in ("solid", "fluid")]
                saves.append(dict(step=step, seconds=seconds, bytes=sum(
                    os.path.getsize(f) for f in files)))
                if len(saves) == 1:
                    os.makedirs(saved, exist_ok=True)
                    for f in files:
                        shutil.copy(f, saved)

            def step_of(real):
                def run(*args, **kw):
                    b0, k0 = cuda_ops.plan_builds, dict(timers)
                    out = real(*args, **kw)
                    steps.append(dict(
                        dofs=fl.n_dofs + so.n_dofs,
                        plan_builds=cuda_ops.plan_builds - b0,
                        plan_s=timers["plan builds"] - k0.get("plan builds",
                                                              0.0),
                        dense_s=timers["dense blocks"] - k0.get(
                            "dense blocks", 0.0)))
                    return out
                return run
            fsi.refine_mesh, fsi.save_checkpoint = refine, save
            fsi._run_phases = step_of(real_phases)
            fsi.run_one_coupled_step = step_of(real_coupled)
            n0 = fl.mesh.n_cells
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_ops.reset_launches()
            t0 = time.perf_counter()
            fsi.run(verbose=False)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = cuda_ops.launches.copy()
            peak = torch.cuda.max_memory_allocated()
    finally:
        for u in undo:
            u()
    dofs0 = FULL_DOFS["fsi_leaflet"]
    say(f"{label}: adaptive leaflet ({ADAPTIVE}), {n0} fluid cells and "
        f"{dofs0} dofs before adaptation, {n_steps} steps through FSI.run "
        f"in {total:.2f} s; peak device memory {peak / 2**20:.1f} MiB")
    for r in refinements:
        say(f"{label}: refinement after step {r['step']}: "
            f"{r['seconds']:.3f} s, fluid cells {r['cells'][0]} -> "
            f"{r['cells'][1]} ({'a new' if r['changed'] else 'the same'} "
            f"mesh), {r['dofs']} dofs; split "
            + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
                r["split"].items()))
            + f", distances, flags and the rest "
            f"{r['seconds'] - sum(r['split'].values()):.3f} s")
    # after a refinement, plans are built in the next step only
    refined_before = {r["step"] + 1 for r in refinements if r["changed"]}
    late = []
    for i, (s, st) in enumerate(zip(fsi.step_log, steps)):
        k = s["krylov"]
        if st["plan_builds"] and i > 1 and s["step"] not in refined_before:
            late.append(s["step"])
        say(f"{label}: step {s['step']} "
            f"{'coupled' if s['coupled'] else 'host first step'}: "
            f"{1e3 * s['seconds']:.1f} ms, {st['dofs']} dofs, Newton solid "
            f"{s['solid_newton']} fluid {s['fluid_newton']}, Krylov {k}; "
            f"plan builds {st['plan_builds']} ({1e3 * st['plan_s']:.1f} ms)"
            f", dense condensed blocks {1e3 * st['dense_s']:.1f} ms")
    for s in saves:
        say(f"{label}: checkpoint at step {s['step']}: {s['bytes']} bytes "
            f"(solid + fluid npz), saved in {s['seconds']:.3f} s")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        fl.present_solution, fl.stress_device, so.current_displacement,
        so.current_velocity, so.current_acceleration))
    max_dx = so.current_displacement.reshape(-1, 2)[:, 0].max().item()
    ok = (finite and 1e-4 < max_dx < 0.5 and not late
          and len(fsi.step_log) == n_steps and len(refinements) >= 2
          and len(saves) >= 1 and set(fl.precond_branches) <= {("dense",
                                                               "cg")})
    say(f"{label}: every step converged; finite {finite}, max d_x "
        f"{max_dx:.4e}; {len(refinements)} refinements (2 before the first "
        f"step), {len(saves)} saves; plan builds after a step with no "
        f"refinement before it: {late or 'none'}; launches "
        f"{dict(launches)} {'ok' if ok else 'FAILED'}")
    _require(label, ok, "the adaptive leaflet failed")
    # the restart: resumed on the card from the first checkpoint
    with _InDir("resumed"):
        for f in os.listdir(saved):
            shutil.copy(os.path.join(saved, f), ".")
        again, r_snaps = case(n_steps)
        t_load = {}
        real_load = again.load_checkpoint

        def load():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_load()
            torch.cuda.synchronize()
            t_load["s"] = time.perf_counter() - t0
            return out
        again.load_checkpoint = load
        _, l2, t_resume = _on_card(torch, again.resume, verbose=False)
    diff = {"fluid solution": _rel(again.fluid.present_solution,
                                   fl.present_solution),
            "solid displacement": _rel(again.solid.current_displacement,
                                       so.current_displacement)}
    ok = (again.time.get_timestep() == n_steps
          and again.fluid.mesh.n_cells == fl.mesh.n_cells
          and all(bool(torch.isfinite(t).all()) for t in (
              again.fluid.present_solution,
              again.solid.current_displacement)))
    say(f"{label}: resumed on the card from the step-{saves[0]['step']} "
        f"checkpoints (loaded in {t_load['s']:.3f} s) to step "
        f"{again.time.get_timestep()} in {t_resume:.2f} s: against the "
        f"uninterrupted run " + ", ".join(
            f"{k} rel diff {v:.3e}" for k, v in diff.items())
        + f" (not gated: the bench knobs' f32 solves and the card's atomics "
        f"round differently from run to run) {'ok' if ok else 'FAILED'}")
    _require(label, ok, "the resumed adaptive leaflet failed")
    _check_snapshots(torch, label, snaps + r_snaps, so, launches + l2,
                     results)

    # the flat shell at 64 x 64 cells
    from openifem_tpu_torch.cases.fsi_leaflet import port_package
    sp_pkg = port_package()

    def solve():
        shell = sp.shell_case(sp_pkg, "plate", (64, 64), device="cuda")
        shell.setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shell.run()
        torch.cuda.synchronize()
        return shell, time.perf_counter() - t0
    (shell, solve_s), sl, total = _on_card(torch, solve)
    w, ref = sp.measured(shell, "plate"), sp.closed_form("plate")
    ok = abs(w - ref) / ref < 0.04 and shell.n_dofs == 21125
    say(f"{label}: shell plate 64 x 64 ({shell.n_nodes} nodes, "
        f"{shell.n_dofs} dofs, 4096 cells of 20 x 20 f64 blocks): "
        f"{shell.cg_iters} Jacobi CG iterations in {1e3 * solve_s:.1f} ms "
        f"({1e3 * solve_s / max(shell.cg_iters, 1):.3f} ms per iteration, "
        f"one host sync each), set-up and solve {total:.2f} s; centre "
        f"deflection {w:.6e} against Kirchhoff {ref:.6e} "
        f"({100 * (w - ref) / ref:+.2f} %, tol 4 %) "
        f"{'ok' if ok else 'FAILED'}")
    _require(label, ok, "the 64 x 64 shell plate failed")
    _check_shell(torch, label, shell, sl, results)
    return {"adaptive_leaflet": _path(launches, n_steps),
            "adaptive_leaflet_resume": _path(l2, n_steps - saves[0]["step"]),
            "shell_plate_64": _path(sl, 1)}


# -- the sharded paths (parallel/shard.py, entry.py) ------------------------

def _rank_tables_check(torch, label, tables, launched, results, seed=201):
    """Hold every shape in `launched` (and its float32 twin) against its
    plain version at the rank tables it was launched with (entry.py's
    snapshots: "fluid" tables in a solver's form, "solid" scalar
    tables)."""
    from types import SimpleNamespace

    import numpy as np
    only = set(launched) | {(lay, "float32", n, r, c)
                            for lay, _, n, r, c in launched}
    for dt in (torch.float64, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for t in tables:
            ns = SimpleNamespace(
                mesh=SimpleNamespace(n_cells=t["n_cells"]),
                **{k: torch.as_tensor(v, device="cuda")
                   if isinstance(v, np.ndarray) else v
                   for k, v in t.items() if k not in ("kind", "n_cells")})
            cases = kernel_cases(torch, ns, None, dt, gen) \
                if t["kind"] == "fluid" else \
                shell_kernel_cases(torch, ns, dt, gen, "rank scalar table")
            check_kernels(torch, label, cases, dt, results, only=only)


def _vs_cpu(name, card, cpu):
    """(relative error, counts equal) of a card check against the same
    check on the CPU."""
    import numpy as np
    key = {"element_newton": "du", "insim_newton": "du",
           "supg_newton": "du", "stepper": "u", "fsi_window": "state",
           "mpi_fsi_window": "state", "stencil_asolve": "x",
           "solid_cg": "u"}[name]
    a, b = np.asarray(card[key]), np.asarray(cpu[key])
    err = float(np.abs(a - b).max() / np.abs(b).max())
    counts = [k for k in ("iters", "newton") if k in card]
    same = all(np.array_equal(card[k], cpu[k]) for k in counts)
    return err, same


def _case_launches(launches):
    """The counts of entry.rank_run's cases (launches[case]) summed: the
    rank's whole run."""
    return sum((Counter(c) for c in launches.values()), Counter())


def phase20_dryrun(torch, results, steps4):
    """entry.dryrun_multichip on the card: one rank (NCCL) with the JAX
    dry run's 5-step windows, then 4 ranks sharing the card (gloo) with
    `steps4`-step windows; every check against the unsharded card run
    with the dry run's tolerances, the one-rank results also against the
    CPU (1e-6, equal Newton and Krylov counts); every kernel shape the
    ranks launched against its plain version at the ranks' tables.  Each
    check is a path of its own, dryrun_<ranks>_<check>: its launches summed
    over the ranks, per step of that check (entry.py's "steps": a time
    step of a window or the beam, one Newton iteration, one CG solve)."""
    from openifem_tpu_torch import entry
    label = "phase 20"
    paths = {}
    for n_ranks, steps in ((1, entry.WINDOW_STEPS), (4, steps4)):
        t0 = time.perf_counter()
        r = entry.dryrun_multichip(n_ranks, "cuda", window_steps=steps)
        total = time.perf_counter() - t0
        say(f"{label}: dryrun_multichip({n_ranks}) on the card, "
            f"{steps}-step windows, in {total:.1f} s; collective routes "
            f"{r['routes']}")
        cpu = {}
        if n_ranks == 1:
            cpu = {name: entry.run_check(name, None, torch.device("cpu"),
                                         steps) for name in entry.CHECKS}
        for name in entry.CHECKS:
            sh, ref = r["sharded"][name], r["reference"][name]
            counts = {k: sh[k] for k in ("iters", "newton") if k in sh}
            line = (f"{label}: {n_ranks} rank(s), {name}: sharded vs "
                    f"unsharded " + ", ".join(
                        f"{k} {v:.3e}" for k, v in r["errors"][name].items())
                    + f"; counts {counts}; rank {sh['run_seconds']:.2f} s, "
                    f"unsharded {ref['run_seconds']:.2f} s")
            if cpu:
                err, same = _vs_cpu(name, sh, cpu[name])
                ok = err <= 1e-6 and same
                line += (f"; against the CPU rel err {err:.3e} (1e-6), "
                         f"counts equal {same} {'ok' if ok else 'FAILED'}")
                _require(label, ok, f"{name} at one rank differs from the "
                         "CPU")
            say(line)
        launched = Counter()
        for name in entry.CHECKS:
            own = sum((Counter(c[name]) for c in r["launches"]), Counter())
            n = r["sharded"][name]["steps"]
            say(f"{label}: {n_ranks} rank(s), {name}: launches over the "
                f"ranks {dict(own)} in {n} step(s)")
            paths[f"dryrun_{n_ranks}_{name}"] = _path(own, n)
            launched += own
        _rank_tables_check(torch, label, [t for ts in r["tables"]
                                          for t in ts], launched, results)
    return paths


def phase21_full(torch, results, refine):
    """The sharded functions at full width: (a) the sharded stepper at
    world size 1 on the cavity at `refine` (6: 37,507 dofs), a 2-step
    window against make_on_device_stepper's; (b) the plane-sharded
    stencil A-solve at refine 7 (132,098 velocity dofs) with 4 ranks
    sharing the card and at world size 1, against the replicated stencil
    FGMRES; (c) sharded_supg_newton at world size 1 on SCnsIM's cylinder
    r3 (18,384 dofs) against the unsharded element branch; (d)
    sharded_element_cg with 4 ranks on the 64 x 64 shell plate (21,125
    dofs) against the unsharded Jacobi CG."""
    import numpy as np

    from openifem_tpu_torch import entry
    from openifem_tpu_torch.parallel import spawn_ranks
    label = "phase 21"
    cuda = torch.device("cuda")
    paths = {}

    def err_of(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))

    def per_step(d, n):
        return {k: v / n for k, v in d.items()}

    # (a) the sharded stepper, world size 1 (NCCL)
    n_steps = 2
    out, launches, routes = spawn_ranks(entry.rank_run, 1, "cuda", (
        ("a", "stepper_window", dict(refine=refine, n_steps=n_steps)),))
    sh = out["a"]
    ref = entry.numpy_tree(entry.stepper_window(None, cuda, refine, n_steps))
    err = err_of(sh["u"], ref["u"])
    ok = (err < 1e-5 and sh["rel"] < sh["tol"] and ref["rel"] < ref["tol"]
          and sh["newton"] == ref["newton"])
    say(f"{label} (a): cavity refine {refine} ({sh['dofs']} dofs), "
        f"{n_steps}-step window after the host first step, world size 1 "
        f"({routes['all_reduce']}): sharded stepper "
        f"{1e3 * sh['seconds'] / n_steps:.1f} ms/step, unsharded "
        f"{1e3 * ref['seconds'] / n_steps:.1f} ms/step; rel err "
        f"{err:.3e} (1e-5 of the scale); worst rel res {sh['rel']:.3e} / "
        f"{ref['rel']:.3e} (tol {sh['tol']:.0e}); max Newton "
        f"{sh['newton']} / {ref['newton']}; all-reduces per step "
        f"{per_step(sh['calls'], n_steps)}, bytes per step "
        f"{per_step(sh['nbytes'], n_steps)}; host syncs per step "
        f"{sh['syncs'] / n_steps:.0f} / {ref['syncs'] / n_steps:.0f}; peak "
        f"memory {sh['peak_bytes'] / 2**20:.1f} / "
        f"{ref['peak_bytes'] / 2**20:.1f} MiB; both windows "
        f"{sh['seconds'] + ref['seconds']:.1f} s {'ok' if ok else 'FAILED'}")
    _require(label, ok, "the sharded stepper differs from the unsharded")
    launched = _case_launches(launches)
    _rank_tables_check(torch, label, sh["tables"], launched, results)
    # launches over the rank's run; per step of the window alone
    paths["sharded_stepper"] = (launched, per_step(sh["launches"], n_steps))

    # (b) the plane-sharded stencil A-solve at refine 7
    ref = entry.numpy_tree(entry.stencil_asolve(None, cuda, 7))
    for n_ranks in (4, 1):
        out, launches, routes = spawn_ranks(entry.rank_run, n_ranks, "cuda",
                                            (("b", "stencil_asolve",
                                              dict(refine=7)),))
        sh = out["b"]
        err = err_of(sh["x"], ref["x"])
        ok = err < 1e-8 and abs(int(sh["iters"]) - int(ref["iters"])) <= 2
        P0, cx, R, k = sh["planes"]
        d = 2
        n_mv = sh["calls"].get("neighbour_exchange", 0) // 2
        say(f"{label} (b): stencil A-solve at refine 7 ({sh['n_u']} "
            f"velocity dofs, {P0} planes of {R} slots, {cx} a rank), "
            f"{n_ranks} rank(s) ({routes}): {1e3 * sh['seconds']:.1f} "
            f"ms/solve (replicated {1e3 * ref['seconds']:.1f}), iterations "
            f"{sh['iters']} / {ref['iters']}; rel err {err:.3e} (1e-8); "
            f"halo per matvec {2 * k * R * d} values "
            f"({2 * k * R * d * 8} B) per inner boundary, "
            f"{n_ranks - 1} boundaries; collectives per solve "
            f"{sh['calls']} ({n_mv} matvecs), {sh['nbytes']} B, staged "
            f"through host {sh['staged']} B {'ok' if ok else 'FAILED'}")
        _require(label, ok, "the plane-sharded A-solve differs")
        _require(label, not _case_launches(launches),
                 f"the stencil solve launched {launches}")

    # (c) sharded_supg_newton, world size 1
    out, launches, routes = spawn_ranks(entry.rank_run, 1, "cuda", (
        ("c", "supg_newton", dict(refine=3)),))
    sh = out["c"]
    t_sh = sh["run_seconds"]
    t0 = time.perf_counter()
    ref = entry.numpy_tree(entry.supg_newton(None, cuda, 3))
    t_ref = time.perf_counter() - t0
    rn, rn_ref = float(sh["res_norm"]), float(ref["res_norm"])
    err = err_of(sh["du"], ref["du"])
    ok = abs(rn - rn_ref) < 1e-10 * max(1.0, rn_ref) and err < 1e-5
    say(f"{label} (c): SCnsIM cylinder r3 ({sh['dofs']} dofs), one Newton "
        f"iteration, world size 1 ({routes['all_reduce']}): res_norm "
        f"{rn:.12e} / {rn_ref:.12e}, du rel err {err:.3e} (1e-5); FGMRES "
        f"{sh['iters']} / {ref['iters']}; {t_sh:.2f} s sharded (set-up "
        f"included), {t_ref:.2f} s unsharded {'ok' if ok else 'FAILED'}")
    _require(label, ok, "sharded_supg_newton differs from the unsharded")
    launched = _case_launches(launches)
    _rank_tables_check(torch, label, sh["tables"], launched, results)
    paths["sharded_supg_newton"] = _path(launched, 1)

    # (d) sharded_element_cg, 4 ranks sharing the card
    per_rank = spawn_ranks(entry.rank_run, 4, "cuda", (
        ("d", "element_cg", dict(cells=64)),), all_ranks=True)
    sh, routes = per_rank[0][0]["d"], per_rank[0][2]
    ref = entry.numpy_tree(entry.element_cg(None, cuda, 64))
    err = err_of(sh["x"], ref["x"])
    ok = err < 1e-10 and abs(int(sh["iters"]) - int(ref["iters"])) <= 1
    launched = sum((_case_launches(lc) for _, lc, _ in per_rank), Counter())
    say(f"{label} (d): shell plate 64 x 64 ({sh['dofs']} dofs, 20 x 20 f64 "
        f"blocks), sharded_element_cg on 4 ranks ({routes}): "
        f"{1e3 * sh['seconds']:.1f} ms/solve, {sh['iters']} iterations "
        f"({1e3 * sh['seconds'] / max(1, int(sh['iters'])):.3f} ms each); "
        f"unsharded {1e3 * ref['seconds']:.1f} ms, {ref['iters']} "
        f"iterations; rel err {err:.3e} (1e-10); collectives per solve "
        f"{sh['calls']}, bytes {sh['nbytes']}, staged through host "
        f"{sh['staged']} B {'ok' if ok else 'FAILED'}")
    _require(label, ok, "sharded_element_cg differs from the unsharded CG")
    _rank_tables_check(torch, label, [t for out, _, _ in per_rank
                                      for t in out["d"]["tables"]], launched,
                       results)
    paths["sharded_element_cg"] = _path(launched, 1)
    return paths


def _run_phase(n, fn, *args):
    """fn(*args), then one line with the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, range(2, 22))),
                    help="comma-separated phases to run besides 0 and 1 "
                         "(default: all)")
    ap.add_argument("--scnsim-depth", default=",".join(map(str, (
        SCNSIM_WARM, SCNSIM_TIMED, SCNSIM_ELEMENT_TIMED))),
        help="phase 12: warm-up, timed and element-branch steps after the "
             "host first step (default: %(default)s)")
    ap.add_argument("--wall3d-depth", default=f"{WALL3D_WARM},{WALL3D_TIMED}",
                    help="phase 15: warm-up and timed coupled steps after "
                         "the host first step (default: %(default)s)")
    ap.add_argument("--vocal-depth", default=f"{VOCAL_WARM},{VOCAL_TIMED}",
                    help="phase 17: warm-up and timed steps after the host "
                         "first step (default: %(default)s)")
    ap.add_argument("--amr-depth", type=int, default=AMR_STEPS,
                    help="phase 19: steps of the adaptive leaflet (at least "
                         "10: the flow pushes the leaflet past the gate's "
                         "1e-4 downstream only after its first steps, which "
                         "move it upstream; default: %(default)s)")
    args = ap.parse_args()
    if args.amr_depth < AMR_STEPS:
        ap.error(f"--amr-depth takes at least {AMR_STEPS} steps")
    want = {int(p) for p in args.phases.split(",") if p}
    depth = tuple(int(n) for n in args.scnsim_depth.split(","))
    if len(depth) != 3 or min(depth[1:]) < 1 or depth[0] < 0:
        ap.error("--scnsim-depth takes warm >= 0, timed >= 1, element >= 1")
    wall3d_depth = tuple(int(n) for n in args.wall3d_depth.split(","))
    if len(wall3d_depth) != 2 or wall3d_depth[0] < 0 or wall3d_depth[1] < 1:
        ap.error("--wall3d-depth takes warm >= 0, timed >= 1")
    vocal_depth = tuple(int(n) for n in args.vocal_depth.split(","))
    if len(vocal_depth) != 2 or vocal_depth[0] < 0 or vocal_depth[1] < 1:
        ap.error("--vocal-depth takes warm >= 0, timed >= 1")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch
    phase0_device(torch)
    # raises ImportError when the script runs outside the repository; the
    # import also sets the package's precision policy (config.py)
    import openifem_tpu_torch  # noqa: F401
    checked, runs = {}, {}
    # the solids write their first-step VTU output, and phases 18 and 19
    # their checkpoints, to the working directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        os.chdir(work)
        _run_phase(1, phase1_build)
        if 2 in want:
            checked = _run_phase(2, phase2_kernels, torch)
        if 3 in want:
            _run_phase(3, phase3_coarse, torch)
        if 4 in want:
            runs["element"] = _run_phase(4, phase4_full, torch)
        if 5 in want:
            _run_phase(5, phase5_coarse_bench, torch)
        if 6 in want:
            runs["fsi_leaflet"] = _run_phase(6, phase6_path_a, torch)
        if 7 in want:
            runs["fsi_leaflet_r2"] = _run_phase(7, phase7_path_b, torch,
                                               checked)
        if 8 in want:
            runs.update(_run_phase(8, phase8_coarse_cylinder, torch,
                                   checked))
        if 9 in want:
            runs.update(_run_phase(9, phase9_cylinder, torch, checked))
        if 10 in want:
            runs["insimex_r3"] = _run_phase(10, phase10_insimex, torch,
                                           checked)
        if 11 in want:
            runs.update(_run_phase(11, phase11_coarse_supg, torch,
                                   checked))
        if 12 in want:
            runs.update(_run_phase(12, phase12_scnsim, torch, checked,
                                   depth))
        if 13 in want:
            runs.update(_run_phase(13, phase13_scnsex, torch, checked))
        if 14 in want:
            runs.update(_run_phase(14, phase14_coarse_mpi, torch,
                                   checked))
        if 15 in want:
            runs["wall3d"] = _run_phase(15, phase15_wall3d, torch, checked,
                                       wall3d_depth)
        if 16 in want:
            runs.update(_run_phase(16, phase16_coarse_vocal_fold, torch,
                                   checked))
        if 17 in want:
            runs["vocal_fold"] = _run_phase(17, phase17_vocal_fold, torch,
                                           checked, vocal_depth)
        if 18 in want:
            runs.update(_run_phase(18, phase18_coarse_amr, torch, checked))
        if 19 in want:
            runs.update(_run_phase(19, phase19_adaptive, torch, checked,
                                   args.amr_depth))
        if 20 in want:
            runs.update(_run_phase(20, phase20_dryrun, torch, checked,
                                   DRYRUN4_STEPS))
        if 21 in want:
            runs.update(_run_phase(21, phase21_full, torch, checked,
                                   CAVITY_REFINE))
        os.chdir(root)
    launched = sum((c for c, _ in runs.values()), Counter())
    # every shape a path launched was held against the plain version
    unchecked = sorted(k for k in launched if k not in checked)
    _require("kernels", not unchecked,
             f"launched but never checked against the plain version: "
             f"{unchecked}")
    # one entry per (layout, dtype, number of cells, block rows, block
    # columns) that the paths launched, with the error and times measured
    # at that shape
    kernels = [dict(name=f"{name}[{dt}, {n_c} cells, {nr}x{nc}]",
                    route="cuda", source=SOURCE, replaces=REPLACES,
                    launches=n,
                    # measured on each path that launched the shape
                    launches_per_step={
                        path: per_step[key]
                        for path, (_, per_step) in runs.items()
                        if key in per_step},
                    **{k: v for k, v in checked[key].items() if k != "rel"})
               for key, n in sorted(launched.items())
               for name, dt, n_c, nr, nc in [key]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
