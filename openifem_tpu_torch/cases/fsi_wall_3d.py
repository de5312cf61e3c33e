"""The fsi-wall-3D case, built in code: channel flow in a 1 x 1 x 4 box,
driven by a pressure on its inlet face, against an elastic wall slab
that spans the channel at z = 2 (OpenIFEM's tests/fsi-wall-3D,
fsi-wall-3D.cpp:29-62): 3-D SCnsIM + SharedHypoElasticity (RKPM, RK4) +
the MPI-semantics coupler.

This module uses only numpy, so the JAX package and the PyTorch port build
their `AllParameters(**wall3d_fields(...))` and meshes from the same input
and the two runs cannot drift.

Meshes as the JAX bench builds them (bench.py:691-706): the fluid box
[10, 10, 40] on [0,1] x [0,1] x [0,4], cells with centres at z in
[2, 2.4] refined once (hanging nodes on faces and edges); the solid
[20, 20, 8] on [0,1] x [0,1] x [0,0.4] shifted to z = 2; particle spacing
dx = 0.05 and smoothing ratio hdx = 1.3.  At full resolution that is 6,800
fluid cells (24,975 velocity + 8,325 pressure dofs) and 3,200 solid cells
(3,969 particles, 11,907 dofs): 45,207 dofs.  full_res=False halves the
three ([5, 5, 20], [10, 10, 4], dx 0.1); `reps` sets other sizes.

The reference's parameter file, tests/fsi-wall-3D/fsi-wall-3D.prm, is not
in the repository, so its physics are STAND-IN values, the same for both
packages: time step 1e-4; air in CGS units (viscosity 1.8e-4, density
1.3e-3, the units of the SCnsIM's atm = 1,013,250); fluid Newton at most 8
iterations to 1e-6; a pressure of 5e2 on the inlet face z = 0 (boundary
id 4), no-slip on the side walls (ids 0-3), the outlet z = 4 free; a
linear-elastic solid (solid_rho 1, E 1e6, nu 0.3) fixed on its four side
faces (ids 0-3); no gravity; output, refinement and save intervals past
the end.  What was tried, on the JAX package on the CPU:
  the truncated size of tests/test_mpi_fsi.py (fluid [4, 4, 16] refined
    to 480 cells, 3,020 dofs; solid [5, 5, 2], 324 dofs; K = 58), bench
    knobs, 3 steps through MPIFSI.run (one host step, two coupled
    steps): 3 Newton iterations each, max |u| 22.556, 128 fluid cells
    covered, 28.6 s;
  half resolution (5,012 + 1,815 dofs, K = 75), bench knobs, 2 steps
    (the host step and one coupled step): 3 Newton iterations each, max
    |u| 22.565, 300 cells covered, 32.9 s.
The full resolution is not run on a CPU here (its dense Tpp product is a
3.5 TFLOP f32 GEMM per Newton iteration); chip_smoke.py phase 15 runs it
in the port on the H100 and fails unless every step converges.

Solver knobs of the JAX bench (bench.py:662-684, `BenchSCnsIM` /
`BenchHypo`): the dense condensed p-coupled blocks and explicit dense Tpp
(`dense_precond`), the element-matvec outer Jacobian (`coupled_stencil`
off); with bench_precision also the f32 Tpp preconditioner, f32 Jacobian
and f32 outer FGMRES shell, inexact-Newton forcing (1e-4, 0.5) and the
RKPM rates in f32.  hybrid=True is the bench's BENCH_WALL3D_HYBRID probe:
the coupled stencil for the outer Jacobian apply, the dense Tpp inside.
"""

from __future__ import annotations

from .fsi_leaflet import port_package  # noqa: F401  (the port's classes)

TIME_STEP = 1e-4
INLET_PRESSURE = 5e2
# (fluid reps, solid reps, particle spacing dx) at full and half resolution
FULL = ([10, 10, 40], [20, 20, 8], 0.05)
HALF = ([5, 5, 20], [10, 10, 4], 0.1)
# the truncated size of tests/test_mpi_fsi.py::test_fsi_wall_3d_truncated
TRUNCATED = ([4, 4, 16], [5, 5, 2])
HDX = 1.3

# the JAX bench's solver structure, and its precision and tolerance knobs
STRUCTURE_KNOBS = dict(dense_precond=True, coupled_stencil=False)
HYBRID_KNOBS = dict(dense_precond=True, coupled_stencil=True,
                    stencil_outer_only=True)
BENCH_PRECISION_KNOBS = dict(mixed_precision_precond=True, f32_matrix=True,
                             newton_forcing=(1e-4, 0.5), f32_outer=True)


def wall3d_fields(n_steps: int = 12):
    """AllParameters field values of the case (either package)."""
    never = 1e9   # output / refinement / save intervals: no I/O, no AMR
    wall = [0.0, 0.0, 0.0]
    return dict(
        simulation_type="FSI", dimension=3, global_refinements=[0, 0],
        end_time=n_steps * TIME_STEP, time_step=TIME_STEP,
        output_interval=never, refinement_interval=never,
        save_interval=never,
        gravity=[0.0, 0.0, 0.0], initial_velocity=[0.0, 0.0, 0.0],
        fluid_velocity_degree=1, fluid_pressure_degree=1,
        viscosity=1.8e-4, fluid_rho=1.3e-3,
        fluid_max_iterations=8, fluid_tolerance=1e-6,
        # no-slip side walls; the inlet pressure on z = 0
        n_fluid_dirichlet_bcs=4,
        fluid_dirichlet_bcs={b: (7, list(wall)) for b in range(4)},
        n_fluid_neumann_bcs=1, fluid_neumann_bcs={4: INLET_PRESSURE},
        solid_degree=1, solid_type="LinearElastic", solid_rho=1.0,
        E=[1e6], nu=[0.3],
        # the slab clamped on its four side faces
        n_solid_dirichlet_bcs=4,
        solid_dirichlet_bcs={b: 7 for b in range(4)},
    )


def wall3d_meshes(generators, fluid_reps, solid_reps):
    """(fluid mesh, solid mesh) built with the given package's
    mesh.generators module."""
    fm = generators.subdivided_hyper_rectangle(list(fluid_reps), [0, 0, 0],
                                               [1, 1, 4])
    c = fm.cell_centers()
    fm = fm.refine((c[:, 2] >= 2) & (c[:, 2] <= 2.4))
    sm = generators.subdivided_hyper_rectangle(list(solid_reps), [0, 0, 0],
                                               [1, 1, 0.4])
    sm.vertices[:, 2] += 2.0
    return fm, sm


def wall3d_knobs(bench_precision: bool = True, hybrid: bool = False):
    """SCnsIM attribute values of the case (either package)."""
    knobs = dict(HYBRID_KNOBS if hybrid else STRUCTURE_KNOBS)
    if bench_precision:
        knobs.update(BENCH_PRECISION_KNOBS)
    return knobs


def wall3d_case(pkg, full_res: bool = True, reps=None, n_steps: int = 12,
                bench_precision: bool = True, hybrid: bool = False,
                device=None):
    """An unrun MPIFSI of the case, built with the classes of `pkg` (a
    namespace with AllParameters, generators, SCnsIM,
    SharedHypoElasticity and MPIFSI of either package; `port_package()`
    gives the port's).  reps: (fluid reps, solid reps) instead of the full
    or half resolution; dx is then 1 / solid reps[0].  device: the port's
    torch device (None: the default; leave None for the JAX package).
    MPIFSI.run sets it up and runs n_steps steps."""
    fluid_reps, solid_reps, dx = FULL if full_res else HALF
    if reps is not None:
        fluid_reps, solid_reps = reps
        dx = 1.0 / solid_reps[0]
    p = pkg.AllParameters(**wall3d_fields(n_steps))
    kw = {} if device is None else dict(device=device)
    fm, sm = wall3d_meshes(pkg.generators, fluid_reps, solid_reps)
    fluid = pkg.SCnsIM(fm, p, **kw)
    for name, value in wall3d_knobs(bench_precision, hybrid).items():
        setattr(fluid, name, value)
    solid = pkg.SharedHypoElasticity(sm, p, dx=dx, hdx=HDX, **kw)
    solid.f32_rates = bench_precision
    return pkg.MPIFSI(fluid, solid, p)
