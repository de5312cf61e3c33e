"""Entry points of the port: one Newton iteration, and the multi-rank dry run.

Counterpart of the JAX package's entry file (__graft_entry__.py):

  entry()                 (fn, example_args): one InsIM Newton iteration
                          (assembly + block-Schur FGMRES) on the unit
                          cavity refined 3 times (8 x 8 cells, Q2/Q1, 659
                          dofs), on the card unless device="cpu";
  dryrun_multichip(n)     every sharded function of parallel/shard.py in
                          n spawned ranks against the same run unsharded,
                          with the JAX dry run's tolerances.

    python -m openifem_tpu_torch.entry [--ranks N] [--device cpu]

runs entry() and then dryrun_multichip(N) (default: one rank per card,
or 4 on the CPU).  Ranks on one card share it over gloo; NCCL needs a
card per rank (parallel/shard.py, backend_for).

The reference's parameter files are not in the repository; the
configurations are the repository's in-code stand-ins, with the same
physics in both packages:
  fluid_cavity.prm         cases/fsi_disc.py::cavity_fields (lid-driven
                           cavity, viscosity 1e-2, Newton to 1e-8);
  fluid_plane_wall_driven_mpi_insim_supg.prm
                           cases/fluid_cylinder.py::scnsim_case at refine
                           1 (SCnsIM on the Turek cylinder, 1,284 dofs);
  fsi_cavity.prm           cases/fsi_disc.py (a disc in the cavity);
  fsi-rkpm-rk4.prm         cases/mpi_block.py's body-force fields with a
                           SharedHypoElasticity (RKPM) block;
  solid_gravity_linearelastic.prm
                           the clamped LinearElasticity beam of the port's
                           solid tests.
The sharded solvers take the element branch of their preconditioners
(parallel/shard.py), and the unsharded runs here take it too.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from .cases import fsi_disc, mpi_block
from .cases.fluid_cylinder import scnsim_case
from .cases.fsi_leaflet import port_package
from .la import cuda_ops
from .parallel import (make_sharded_stepper, shard_fluid_solver,
                       shard_solid_solver, sharded_insim_newton,
                       sharded_stencil_asolve, sharded_supg_newton,
                       spawn_ranks)
from .utils.timer import count_host_syncs

CHECKS = ("element_newton", "insim_newton", "stepper", "supg_newton",
          "fsi_window", "mpi_fsi_window", "stencil_asolve", "solid_cg")
# the checks that run a window of steps, and its default depth (the JAX
# dry run's)
WINDOWS = ("stepper", "fsi_window", "mpi_fsi_window")
WINDOW_STEPS = 5
RKPM_DT = 1e-4



def _kw(device):
    return {} if device is None else dict(device=device)


def cavity(refine: int = 3, device=None, n_steps: int = 4, pkg=None):
    """The lid-driven cavity's InsIM (cavity_fields) refined `refine`
    times and set up: 8 x 8 cells at 3 (578 + 81 dofs), 64 x 64 at 6
    (33,282 + 4,225).  pkg: the classes of either package (default the
    port's; cases.fsi_leaflet.port_package)."""
    pkg = pkg or port_package()
    p = pkg.AllParameters(**fsi_disc.cavity_fields(n_steps))
    p.global_refinements[0] = refine
    s = pkg.InsIM(pkg.generators.hyper_cube(0.0, 1.0, dim=2)
                  .refine_global(refine), p, **_kw(device))
    s.setup()
    return s


def channel(device=None, n_steps: int = 4, pkg=None):
    """A 2 x 0.2 channel (20 x 4 cells, Q2/Q1, 1,891 dofs) driven by a
    pressure of 1 on its inlet, no-slip walls, the outlet free: the
    geometry of the reference's fluid_pipe_mpi (its parameter file is
    not in the repository; viscosity 0.1, density 1 and Newton to 1e-6
    stand in)."""
    pkg = pkg or port_package()
    f = fsi_disc.cavity_fields(n_steps)
    f.update(global_refinements=[0, 0], viscosity=0.1,
             fluid_tolerance=1e-6, n_fluid_dirichlet_bcs=2,
             fluid_dirichlet_bcs={2: (3, [0.0, 0.0]), 3: (3, [0.0, 0.0])},
             n_fluid_neumann_bcs=1, fluid_neumann_bcs={0: 1.0})
    s = pkg.InsIM(pkg.generators.subdivided_hyper_rectangle(
        [20, 4], [0.0, 0.0], [2.0, 0.2]), pkg.AllParameters(**f),
        **_kw(device))
    s.setup()
    return s


def newton_args(s):
    """InsIM's Newton arguments at the first iteration of a step."""
    return (s.nonzero_constraints.apply_increment(s.present_solution),
            s.present_solution, s.indicator, s.fsi_acceleration,
            s.fsi_stress_cell, s.fsi_acc_nodal)


def supg_args(s):
    """The SUPG family's Newton arguments (no eddy viscosity)."""
    eddy = torch.zeros(s.u_space.n_nodes, dtype=s.present_solution.dtype,
                       device=s.device)
    return (s.nonzero_constraints.apply_increment(s.present_solution),
            s.present_solution, s.indicator, s.fsi_acc_nodal,
            s.fsi_stress_nodal, s.stress_device, eddy)


def entry(device=None):
    """Returns (fn, example_args): one Newton iteration (assembly +
    block-Schur FGMRES solve) of the incompressible NS solver; fn returns
    (du, res_norm)."""
    s = cavity(device=device)

    def fn(eval_pt, present, indicator, fsi_acc, fsi_stress,
           fsi_acc_nodal):
        du, res_norm, _, _ = s._newton_iter_impl(
            eval_pt, present, indicator, fsi_acc, fsi_stress, fsi_acc_nodal,
            s.zero_constraints, s.u_constraints, s.p_constraints)
        return du, res_norm

    return fn, newton_args(s)


# -- the checks: each runs sharded over `mesh`, or unsharded (mesh None) ----

def _tables(kind, ns):
    """A kernel-check snapshot of the tables a rank launched with."""
    names = ("dim", "nlu", "nu_loc", "nlp", "n_u", "n_p", "n_dofs",
             "cell_dofs", "cell_dofs_u", "cell_dofs_p", "cell_nodes_u")
    snap = {n: getattr(ns, n) for n in names if hasattr(ns, n)}
    snap = {n: v.cpu().numpy() if torch.is_tensor(v) else v
            for n, v in snap.items()}
    snap["n_cells"] = int(snap["cell_dofs"].shape[0])
    snap["kind"] = kind
    return snap


def _fluid_tables(s):
    """The own-cell tables of a fluid that shard_fluid_solver sharded."""
    v = s.rank_view
    return _tables("fluid", SimpleNamespace(
        dim=s.dim, nlu=s.nlu, nu_loc=s.nu_loc, nlp=s.nlp, n_u=s.n_u,
        n_p=s.n_p, n_dofs=s.n_dofs, cell_dofs=v.cell_dofs,
        cell_dofs_u=v.cell_dofs_u, cell_dofs_p=v.cell_dofs_p,
        cell_nodes_u=v.cell_nodes_u))


def collective_counts(mesh, before):
    """The mesh's collective calls, bytes handed to them and bytes staged
    through host buffers since the snapshot `before` (Collectives.counts)."""
    now = mesh.coll.counts()
    return dict(calls=dict(now["calls"] - before["calls"]),
                nbytes=dict(now["nbytes"] - before["nbytes"]),
                staged=now["staged"] - before["staged"])


def check_element_newton(mesh, device):
    """shard_fluid_solver: one Newton iteration through the solver's own
    _newton_iter_impl, cells split over the ranks."""
    s = cavity(device=device)
    s._u_stencil = None
    args = newton_args(s)
    tables = []
    if mesh is not None:
        shard_fluid_solver(s, mesh)
        tables.append(_fluid_tables(s))
    du, rn, its, _ = s._newton_iter_impl(*args, s.zero_constraints,
                                         s.u_constraints, s.p_constraints)
    return dict(du=du, res_norm=rn, iters=its, tables=tables, steps=1)


def fluid_steps(mesh, device, n_steps=2):
    """The cavity's first n_steps steps through InsIM.run_one_step, the
    Newton iterations sharded by shard_fluid_solver."""
    s = cavity(device=device, n_steps=n_steps)
    s._u_stencil = None
    if mesh is not None:
        shard_fluid_solver(s, mesh)
    newton = []
    for i in range(n_steps):
        s.run_one_step(i == 0, verbose=False)
        newton.append(s.newton_iters)
    return dict(u=s.present_solution, newton=newton)


def check_insim_newton(mesh, device, **knobs):
    """sharded_insim_newton on the padded layout (n_u = 578 and n_p = 81
    are not multiples of 4: the pad rows run); knobs: preconditioner
    attributes set on the solver first (a_block_jacobi, a_poly, ...)."""
    s = cavity(device=device)
    s._u_stencil = None
    for name, value in knobs.items():
        setattr(s, name, value)
    args = newton_args(s)
    if mesh is None:
        du, rn, its, _ = s._newton_iter_impl(
            *args, s.zero_constraints, s.u_constraints, s.p_constraints)
        return dict(du=du, res_norm=rn, iters=its, tables=[], steps=1)
    newton = sharded_insim_newton(s, mesh)
    du, rn, its, _ = newton(*args)
    return dict(du=du, res_norm=rn, iters=its, steps=1,
                tables=[_tables("fluid", newton.tables)])


def stepper_window(mesh, device, refine=3, n_steps=WINDOW_STEPS,
                   case="cavity"):
    """The host first step, then an n_steps window of
    make_sharded_stepper (or, unsharded, make_on_device_stepper), on the
    cavity refined `refine` times or (case "channel") the channel.
    "launches" and the collective counts are the window's alone (the
    difference of the counts around it), "steps" counts the first step
    too."""
    s = channel(device, n_steps + 1) if case == "channel" else \
        cavity(refine, device=device, n_steps=n_steps + 1)
    s._u_stencil = None
    s.run_one_step(True, verbose=False)
    if mesh is None:
        run, tables = s.make_on_device_stepper(), []
    else:
        run = make_sharded_stepper(s, mesh)
        tables = [_tables("fluid", run.tables)]
        coll_before = mesh.coll.counts()
    before = cuda_ops.launches.copy()
    cuda = s.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_host_syncs() as syncs:
        u, rel, its = run(s.present_solution, n_steps)
    if cuda:
        torch.cuda.synchronize()
    out = dict(u=u, rel=rel, newton=its, tables=tables,
               seconds=time.perf_counter() - t0, syncs=syncs["syncs"],
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
               launches=dict(cuda_ops.launches - before), dofs=s.n_dofs,
               tol=s.params.fluid_tolerance, steps=n_steps + 1)
    if mesh is not None:
        out.update(collective_counts(mesh, coll_before))
    return out


def scnsim(refine=1, device=None, bench_precision=False, pkg=None):
    """SCnsIM on the Turek cylinder (scnsim_case), on the element branch
    with the B2pp diagonal (the preconditioner of the padded rank
    view)."""
    s = scnsim_case(pkg or port_package(), refine=refine, device=device,
                    bench_precision=bench_precision, coupled_stencil=False)
    s._pressure_mg = None
    return s


def supg_newton(mesh, device, refine=1, bench_precision=False):
    """One Newton iteration of scnsim(refine): sharded_supg_newton, or
    (mesh None) the solver's own _newton_iter_impl."""
    s = scnsim(refine, device, bench_precision)
    args = supg_args(s)
    if mesh is None:
        du, rn, its, _ = s._newton_iter_impl(
            *args, s.zero_constraints, s.u_constraints, s.p_constraints)
        return dict(du=du, res_norm=rn, iters=its, tables=[],
                    dofs=s.n_dofs, steps=1)
    newton = sharded_supg_newton(s, mesh)
    du, rn, its, _ = newton(*args)
    return dict(du=du, res_norm=rn, iters=its, dofs=s.n_dofs, steps=1,
                tables=[_tables("fluid", newton.tables)])


def _coupled_window(fsi, mesh):
    """Set up both solvers by hand (no interface refinement), shard the
    fluid over `mesh`, then the host first step and the fused coupled
    steps to the end time, as the JAX dry run drives them.  Returns the
    fluid solution and solid displacement, the fluid Newton count per
    step and the rank's tables."""
    fluid, solid = fsi.fluid, fsi.solid
    gr = fsi.params.global_refinements
    solid.mesh = solid.mesh.refine_global(gr[1])
    solid.setup()
    fluid.mesh = fluid.mesh.refine_global(gr[0])
    fluid.setup()
    fsi._setup_coupling()
    tables = []
    if mesh is not None:
        shard_fluid_solver(fluid, mesh)
        tables.append(_fluid_tables(fluid))
    if not fsi._can_fuse_step():
        raise RuntimeError("the fused coupled step is not eligible")
    newton = []
    first = True
    while fsi.time.end() - fsi.time.current() > 1e-12:
        if first:
            fsi.find_solid_bc()
            solid.run_one_step(True)
            fsi.update_solid_box_and_indicator()
            zero_ext, nonzero_ext = fsi.find_fluid_bc(True)
            fsi._run_fluid_step(zero_ext, nonzero_ext, verbose=False)
            first = False
        else:
            fsi.run_one_coupled_step(verbose=False)
        fsi.time.increment()
        newton.append(int(fluid.newton_iters))
    disp = getattr(solid, "current_displacement", None)
    if disp is None:
        disp = solid.get_current_solution()
    if hasattr(solid, "cell_dofs"):
        tables.append(dict(kind="solid", cell_dofs=solid.cell_dofs.cpu()
                           .numpy(), n_dofs=solid.n_dofs,
                           n_cells=int(solid.cell_dofs.shape[0])))
    return dict(state=torch.cat([fluid.present_solution, disp.reshape(-1)]),
                newton=newton, tables=tables, steps=len(newton))


def check_fsi_window(mesh, device, n_steps=WINDOW_STEPS):
    """The disc in the cavity (cases/fsi_disc.py, no interface
    refinement): HyperElasticity + InsIM through FSI's fused coupled
    step, n_steps steps."""
    fsi = fsi_disc.disc_case(port_package(), n_steps=n_steps,
                             refine_every=None, device=device)
    return _coupled_window(fsi, mesh)


def check_mpi_fsi_window(mesh, device, n_steps=WINDOW_STEPS):
    """The MPI block's body-force fields (cases/mpi_block.py; the fluid
    coarsened to 10 x 5 cells, 726 dofs) with a SharedHypoElasticity
    (RKPM) block: SCnsIM + RK4 solid through MPIFSI's fused coupled step,
    n_steps steps."""
    pkg = port_package()
    fields = mpi_block.block_fields("body_force", n_steps)
    # the explicit RK4 solid needs dt under h / sqrt(E / rho), 6e-4 here
    fields.update(time_step=RKPM_DT, end_time=n_steps * RKPM_DT)
    p = pkg.AllParameters(**fields)
    fm = pkg.generators.subdivided_hyper_rectangle([10, 5], [0.0, 0.0],
                                                   [2.0, 1.0])
    sm = pkg.generators.subdivided_hyper_rectangle([5, 5], [0.0, 0.0],
                                                   [1.0, 1.02])
    sm.vertices = sm.vertices + np.array([0.25, 0.0])
    fluid = pkg.SCnsIM(fm, p, device=device)
    fluid.coupled_stencil = False
    solid = pkg.SharedHypoElasticity(sm, p, dx=0.2, hdx=1.3, device=device)
    return _coupled_window(pkg.MPIFSI(fluid, solid, p), mesh)


def stencil_problem(refine=3, device=None, seed=12):
    """(solver, Auu, b, atol): the cavity's first Newton velocity block
    and a random rhs (zero on fixed rows); b's seed also draws x, the
    vector of the plain apply."""
    s = cavity(refine, device=device)
    st = s._u_stencil
    if st is None or st.n_shared != 0:
        raise RuntimeError("the cavity should merge into one stencil brick")
    A_loc, _ = s._assemble(*newton_args(s))
    Auu = A_loc[:, :s.nu_loc, :s.nu_loc].contiguous()
    fixed = s.u_constraints.fixed
    rng = np.random.default_rng(seed)
    b = torch.where(fixed, 0.0, torch.as_tensor(
        rng.standard_normal(s.n_u), dtype=Auu.dtype, device=s.device))
    s.stencil_x = torch.as_tensor(rng.standard_normal(s.n_u),
                                  dtype=Auu.dtype, device=s.device)
    return s, Auu, b, 1e-8 * torch.linalg.vector_norm(b).item()


def stencil_asolve(mesh, device, refine=3, repeats=1):
    """The plane-sharded A-solve (or, unsharded, the replicated stencil
    FGMRES) on stencil_problem; seconds per solve over `repeats`."""
    from .la.krylov import fgmres
    from .la.operators import element_diag
    s, Auu, b, atol = stencil_problem(refine, device)
    if mesh is None:
        st = s._u_stencil
        n_c, d, nlu = s.mesh.n_cells, s.dim, s.nlu

        def solve(Auu, b, atol):
            Ws = st.build_weights(Auu.reshape(n_c, nlu, d, nlu, d))
            fixed = s.u_constraints.fixed
            diag = torch.where(fixed, 1.0,
                               element_diag(Auu, s.cell_dofs_u, s.n_u))
            dinv = st.spread(torch.where(diag != 0, 1.0 / diag, 1.0))
            fix_st = st.spread_mask(fixed)
            res = fgmres(lambda v: st.condensed_matvec(Ws, fix_st, v),
                         st.spread(b), M=lambda r: r * dinv, atol=atol,
                         restart=s.a_inner_restart,
                         max_restarts=s.a_inner_restarts,
                         weight=st.weight(b.dtype))
            return st.unspread(res.x), res.iters
    else:
        sharded = sharded_stencil_asolve(s, mesh)

        def solve(Auu, b, atol):
            res = sharded(Auu, b, atol)
            return res.x, res.iters
    sync = torch.cuda.synchronize if s.device.type == "cuda" else \
        (lambda: None)
    x, its = solve(Auu, b, atol)
    if mesh is not None:
        coll_before = mesh.coll.counts()
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        x, its = solve(Auu, b, atol)
    sync()
    out = dict(x=x, iters=its, n_u=s.n_u, tables=[], steps=repeats + 1,
               seconds=(time.perf_counter() - t0) / repeats)
    if mesh is not None:
        out.update(collective_counts(mesh, coll_before))
    st, xv = s._u_stencil, s.stencil_x
    Ws = st.build_weights(Auu.reshape(s.mesh.n_cells, s.nlu, s.dim, s.nlu,
                                      s.dim))
    if mesh is None:
        out["y"] = st.unspread(st.matvec(Ws, st.spread(xv)))
    else:
        sst = sharded.sharded
        out["y"] = sst.unspread(sst.matvec(sst.shard_weights(Ws),
                                           sst.spread(xv)))
        out["planes"] = (sst.P0, sst.cx, sst.R, sst.k)
    return out


def beam(reps=(5, 3), size=(1.0, 0.6), n_steps=2, device=None, pkg=None):
    """A set-up clamped LinearElasticity beam of either package (gravity
    and an end traction; at 5 x 3 cells, 48 dofs and 15 cells, neither a
    multiple of 4 or 8)."""
    pkg = pkg or port_package()
    dt = 1e-2
    p = pkg.AllParameters(
        simulation_type="Solid", dimension=2, global_refinements=[0, 0],
        end_time=n_steps * dt, time_step=dt, output_interval=1e9,
        refinement_interval=1e9, save_interval=1e9, gravity=[0.0, -9.8],
        initial_velocity=[0.0, 0.0], solid_degree=1,
        solid_type="LinearElastic", solid_rho=1.0, E=[1e4], nu=[0.3],
        eta=[5.0], damping=0.1, solid_max_iterations=8, tol_d=1e-10,
        tol_f=1e-10, n_solid_dirichlet_bcs=1, solid_dirichlet_bcs={0: 3},
        n_solid_neumann_bcs=1, solid_neumann_bc_type="Traction",
        solid_neumann_bcs={1: [0.0, -50.0]})
    solid = pkg.LinearElasticity(pkg.generators.subdivided_hyper_rectangle(
        list(reps), [0.0, 0.0], list(size)), p, **_kw(device))
    solid.setup()
    return solid


def beam_steps(solid, n_steps):
    """n_steps Newmark steps; the CG count of each."""
    iters = []
    for i in range(n_steps):
        solid.run_one_step(i == 0)
        iters.append(int(solid.lin_iters))
    return iters


def check_solid_cg(mesh, device, n_steps=2, reps=(5, 3), size=(1.0, 0.6)):
    """The beam's n_steps steps with the CG sharded by dof ranges
    (shard_solid_solver)."""
    solid = beam(reps, size, n_steps, device)
    tables = []
    if mesh is not None:
        shard_solid_solver(solid, mesh)
        tb = solid._solve_A.tables
        tables.append(dict(kind="solid", cell_dofs=tb.cell_dofs.cpu()
                           .numpy(), n_dofs=tb.n_dofs,
                           n_cells=tb.mesh.n_cells))
    iters = beam_steps(solid, n_steps)
    return dict(u=solid.get_current_solution(), iters=iters, tables=tables,
                steps=n_steps)


def element_cg(mesh, device, cells=64, seed=0):
    """The shell plate's stiffness (cases/shell_plate.py, cells x cells,
    20 x 20 f64 blocks) against its load, through sharded_element_cg (or,
    unsharded, the shell's own Jacobi CG); seconds per solve, and
    "launches" of the solve alone (the difference of the counts around
    it)."""
    from .cases import shell_plate
    from .la.krylov import cg
    from .parallel import sharded_element_cg
    shell = shell_plate.shell_case(port_package(), "plate", (cells, cells),
                                   device=device)
    shell.setup()
    cons = shell.constraints
    b = cons.condense_rhs(shell.rhs)
    atol = 1e-10 * torch.linalg.vector_norm(b).item()
    tables = []
    if mesh is None:
        def solve():
            return cg(shell._op, b, M=lambda r: r * shell._dinv, atol=atol,
                      maxiter=shell.n_dofs)
    else:
        sharded = sharded_element_cg(shell.K_loc, shell.cell_dofs, cons,
                                     mesh)
        tb = sharded.tables
        tables.append(dict(kind="solid", cell_dofs=tb.cell_dofs.cpu()
                           .numpy(), n_dofs=tb.n_dofs,
                           n_cells=tb.mesh.n_cells))

        def solve():
            return sharded(b, atol)
        coll_before = mesh.coll.counts()
    sync = torch.cuda.synchronize if shell.device.type == "cuda" else \
        (lambda: None)
    before = cuda_ops.launches.copy()
    sync()
    t0 = time.perf_counter()
    res = solve()
    sync()
    out = dict(x=res.x, iters=res.iters, tables=tables, dofs=shell.n_dofs,
               seconds=time.perf_counter() - t0, steps=1,
               launches=dict(cuda_ops.launches - before))
    if mesh is not None:
        out.update(collective_counts(mesh, coll_before))
    return out


# the function of each check: fn(mesh or None, device, **kw)
CHECK_FNS = dict(element_newton="check_element_newton",
                 insim_newton="check_insim_newton", stepper="stepper_window",
                 supg_newton="supg_newton", fsi_window="check_fsi_window",
                 mpi_fsi_window="check_mpi_fsi_window",
                 stencil_asolve="stencil_asolve", solid_cg="check_solid_cg")


def numpy_tree(x):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    return x


def run_case(fn_name, mesh, device, kw):
    """entry.<fn_name>(mesh, device, **kw) as numpy, with its seconds
    under "run_seconds"."""
    t0 = time.perf_counter()
    out = numpy_tree(globals()[fn_name](mesh, device, **kw))
    out["run_seconds"] = time.perf_counter() - t0
    return out


def check_cases(checks=CHECKS, window_steps=WINDOW_STEPS):
    """The (name, fn, kw) cases of rank_run for dry-run checks."""
    return tuple((name, CHECK_FNS[name],
                  dict(n_steps=window_steps) if name in WINDOWS else {})
                 for name in checks)


def run_check(name, mesh, device, window_steps=WINDOW_STEPS):
    """One check, sharded over `mesh` or unsharded (mesh None)."""
    (_, fn, kw), = check_cases((name,), window_steps)
    return run_case(fn, mesh, device, kw)


def rank_run(mesh, cases):
    """In a rank: {name: run_case(fn, mesh, mesh.device, kw)} for each
    (name, fn, kw) of `cases`.  The kernel launch counts are zeroed once,
    just before the first case, and nothing else zeroes them; launches
    [name] is the counts of that case alone (the difference of the counts
    just before and just after it), so the cases' counts sum to the whole
    run's.  Returns (results, launches, the mesh's collective routes)."""
    cuda_ops.reset_launches()
    out, launches = {}, {}
    for name, fn, kw in cases:
        before = cuda_ops.launches.copy()
        out[name] = run_case(fn, mesh, mesh.device, kw)
        launches[name] = dict(cuda_ops.launches - before)
    return out, launches, dict(mesh.coll.routes)


def probe_collectives(mesh, device):
    """Each collective on rank-coded tensors: (rank + 1) * [1, 2, 3] in
    every rank's halo slabs, all-reduce, all-gather and reduce-scatter
    inputs."""
    r = mesh.rank + 1
    v = torch.arange(1, 4, dtype=torch.float64, device=mesh.device) * r
    coll = mesh.coll
    from_prev, from_next = coll.neighbour_exchange(-v, v)
    return dict(from_prev=from_prev, from_next=from_next,
                all_reduce=coll.all_reduce_sum(v.clone()),
                all_gather=coll.all_gather_cat(v),
                reduce_scatter=coll.reduce_scatter_sum(
                    torch.arange(4 * mesh.size, dtype=torch.float64,
                                 device=mesh.device) * r))


def close(a, b, what, tol=1e-5):
    """max |a - b| < tol * max(1, max |b|), or raise (the JAX dry run's
    check); returns the error relative to that scale."""
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    if not err < tol * scale:
        raise AssertionError(f"sharded {what} diverges from unsharded: "
                             f"{err:.3e} (tol {tol:.0e} of {scale:.3e})")
    return err / scale


def compare(name, sh, ref):
    """Hold one check's sharded result against the unsharded one with the
    JAX dry run's tolerances; returns {quantity: error relative to the
    scale}."""
    if name in ("element_newton", "insim_newton", "supg_newton"):
        rn, rn_ref = float(sh["res_norm"]), float(ref["res_norm"])
        if not abs(rn - rn_ref) < 1e-10 * max(1.0, rn_ref):
            raise AssertionError(f"sharded {name}: res_norm {rn!r} against "
                                 f"{rn_ref!r}")
        return {"du": close(sh["du"], ref["du"], name),
                "res_norm": abs(rn - rn_ref) / max(1.0, rn_ref)}
    if name == "stepper":
        err = close(sh["u"], ref["u"], "stepper window")
        if not (sh["rel"] < sh["tol"] and sh["newton"] == ref["newton"]):
            raise AssertionError(f"sharded stepper: rel {sh['rel']} (tol "
                                 f"{sh['tol']}), Newton {sh['newton']} "
                                 f"against {ref['newton']}")
        return {"u": err}
    if name in ("fsi_window", "mpi_fsi_window"):
        return {"state": close(sh["state"], ref["state"], name)}
    if name == "stencil_asolve":
        err = close(sh["x"], ref["x"], "plane-sharded stencil A-solve")
        if abs(int(sh["iters"]) - int(ref["iters"])) > 2:
            raise AssertionError(f"stencil A-solve iterations {sh['iters']}"
                                 f" against {ref['iters']}")
        return {"x": err}
    if name == "solid_cg":
        u = np.asarray(sh["u"])
        if not np.isfinite(u).all():
            raise AssertionError("sharded solid step non-finite")
        return {"u": close(u, ref["u"], "dof-sharded solid CG", tol=1e-10)}
    raise KeyError(name)


def dryrun_multichip(n_ranks: int, device=None, checks=CHECKS,
                     window_steps: int = WINDOW_STEPS,
                     timeout: float = 900.0):
    """Run each check sharded in n_ranks spawned ranks and unsharded here,
    on `device` (default the card), and hold them together (compare);
    raises on a miss.  window_steps: the depth of the WINDOWS checks.
    Returns dict(errors={check: {quantity: error}}, sharded=rank 0's
    results, reference=the unsharded results, launches=[per rank
    {check: counts}], tables=[per rank], routes=rank 0's collective
    routes).  Each check's result has "steps": the time steps it ran
    (the windows and the beam), or 1 for one Newton iteration or CG
    solve; the stencil solve counts its solves."""
    from .config import device as _device
    dev = _device(device)
    per_rank = spawn_ranks(rank_run, n_ranks, str(dev),
                           check_cases(checks, window_steps),
                           timeout=timeout, all_ranks=True)
    sharded, _, routes = per_rank[0]
    reference = {name: run_check(name, None, dev, window_steps)
                 for name in checks}
    errors = {name: compare(name, sharded[name], reference[name])
              for name in checks}
    res = float(sharded.get("element_newton", {}).get("res_norm", np.nan))
    print(f"dryrun_multichip({n_ranks}): ok, residual={res:.3e}; routes "
          f"{routes}")
    return dict(errors=errors, sharded=sharded, reference=reference,
                launches=[launches for _, launches, _ in per_rank],
                tables=[[t for name in checks for t in out[name]["tables"]]
                        for out, _, _ in per_rank],
                routes=routes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: one per card, or "
                         "4 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the card)")
    args = ap.parse_args()
    fn, example = entry(args.device)
    du, res = fn(*example)
    print(f"entry ok: du {tuple(du.shape)}, res_norm {res:.6e}")
    from .config import device as _device
    dev = _device(args.device)
    n = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                       else 4)
    dryrun_multichip(n, dev.type)


if __name__ == "__main__":
    main()
