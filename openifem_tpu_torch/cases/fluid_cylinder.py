"""The fluid_cylinder case, built in code: the Schaefer-Turek 2D-1
benchmark, laminar flow around a cylinder in a channel at Re = 20
(OpenIFEM's tests/fluid_cylinder), as a standalone fluid.

This module uses only numpy, so the JAX package and the PyTorch port build
their `AllParameters(**cylinder_fields(...))` and meshes from the same
input and the two runs cannot drift.

Geometry, mesh and boundary ids are those of
`generators.flow_around_cylinder(2)` (0 inflow, 1 outflow, 2 bottom, 3
top, 4 cylinder; 92 coarse cells); the inflow is the benchmark's parabola
with Umax = 0.3 over the channel height 0.41.  The benchmark's public
values are kept: viscosity 1e-3 and density 1 (Re = 20 with the mean
inflow 0.2 and the cylinder diameter 0.1).  The reference's parameter
file, tests/fluid_cylinder/fluid_cylinder.prm, is not in the repository,
so its numerics are replaced by STAND-IN values, the same for both
packages: time_step 1e-2, grad_div 0.1, fluid Newton at most 8 iterations
to 1e-6.  They were chosen on the JAX package so that every step
converges well inside the Newton cap and InsIMEX (explicit convection)
stays stable and within 2 % of InsIM at t = 0.15.  What was tried, to
t = 0.15 on the CPU (Newton iterations of the first step / of every later
step; InsIMEX against InsIM in the relative L2 norm of the velocity):
  time_step 1e-2, grad_div 0.1, refine 1, f64:   4 / 3, 3.434e-3  (chosen)
  the same at refine 2:                          4 / 3, 3.925e-3
  the same with the bench knobs, refine 1 and 2: 4 / 3
  time_step 5e-2, grad_div 0.1, refine 1:        4 / 3, 1.475e-2 (close to
      the 2 % that the tests allow)
  time_step 1e-2, grad_div 1.0, refine 1:        3 / 3, 3.711e-3 (the
      InsIM run 1.6 times slower: more Krylov iterations)
Matching the reference's own values, and its golden extrema, waits until
its .prm file is in the repository.

Three solver configurations of the case (`CONFIGS`), the ones the JAX
bench runs (bench.py bench_cylinder), built by `cylinder_case` for either
package:
  "r1"  refine 1 (368 cells, 3,612 dofs): f64 outer FGMRES;
  "r3"  refine 3 (5,888 cells, 54,192 dofs): f32 outer FGMRES shell
        (f32_outer), the pressure V-cycle inside the mass-Schur CG;
  "r4"  refine 4 (23,552 cells, 214,368 dofs): f32_outer and one pressure
        V-cycle as Sm^-1 (mg_direct).
With bench_precision each also takes the bench's precision and tolerance
knobs (BENCH_PRECISION_KNOBS); without, it runs in float64 throughout
with the default inner tolerances.  Every configuration with more than
one mesh level attaches the pressure V-cycle over the refinement
hierarchy.  `imex_case` builds an InsIMEX on the same mesh and fields.
"""

from __future__ import annotations

import numpy as np

from .fsi_leaflet import port_package  # noqa: F401  (the port's classes)

# peak inflow velocity and channel height
UMAX, HEIGHT = 0.3, 0.41

TIME_STEP = 1e-2


def inflow(points, component):
    """Parabolic inflow on the inlet x = 0 (hard-coded boundary values)."""
    out = np.zeros(len(points))
    if component == 0:
        m = np.abs(points[:, 0]) < 1e-10
        out[m] = 4 * UMAX * points[m, 1] * (HEIGHT - points[m, 1]) \
            / HEIGHT ** 2
    return out


def cylinder_fields(refine: int = 1, n_steps: int = 10):
    """AllParameters field values of the case (either package).  A solver
    built on the unrefined `flow_around_cylinder(2)` mesh refines it
    `refine` times in run(); `cylinder_case` and `imex_case` refine it
    themselves and hand over a solver that is set up."""
    never = 1e9  # output / refinement / save intervals: no I/O, no AMR
    return dict(
        simulation_type="Fluid", dimension=2,
        global_refinements=[refine, 0],
        end_time=n_steps * TIME_STEP, time_step=TIME_STEP,
        output_interval=never, refinement_interval=never,
        save_interval=never,
        gravity=[0.0, 0.0],
        fluid_velocity_degree=2, fluid_pressure_degree=1,
        viscosity=1e-3, fluid_rho=1.0, grad_div=0.1,
        fluid_max_iterations=8, fluid_tolerance=1e-6,
        use_hard_coded_values=1,
        # inlet (0), walls (2, 3) and cylinder (4) fully constrained;
        # outflow (1) free
        n_fluid_dirichlet_bcs=4,
        fluid_dirichlet_bcs={0: (3, [0.0, 0.0]), 2: (3, [0.0, 0.0]),
                             3: (3, [0.0, 0.0]), 4: (3, [0.0, 0.0])},
    )


def cylinder_hierarchy(generators, refine: int):
    """[base, base.refine_global(1), ...]: `refine` + 1 nested levels of
    the cylinder mesh, coarsest first, built with the given package's
    mesh.generators module.  Refined boundary vertices move onto the
    circle, so the levels are nested in topology only."""
    meshes = [generators.flow_around_cylinder(2)]
    for _ in range(refine):
        meshes.append(meshes[-1].refine_global(1))
    return meshes


CONFIGS = ("r1", "r3", "r4")
REFINE = {"r1": 1, "r3": 3, "r4": 4}

# the precision and tolerance knobs that BenchInsIM sets on every cylinder
# case (bench.py:166-177): f32 preconditioner and Jacobian, loose inner
# tolerances
BENCH_PRECISION_KNOBS = dict(
    mixed_precision_precond=True, mp_sm_rtol=1e-1, f32_matrix=True,
    a_inner_rtol=1e-2)


def insim_knobs(config: str, bench_precision: bool = True) -> dict:
    """InsIM attribute values of a configuration (either package)."""
    if config not in CONFIGS:
        raise ValueError(f"unknown configuration {config!r}; "
                         f"one of {CONFIGS}")
    knobs = dict(mg_direct=True) if config == "r4" else {}
    if bench_precision:
        knobs.update(BENCH_PRECISION_KNOBS)
        if config != "r1":
            knobs["f32_outer"] = True
    return knobs


def _kw(device):
    return {} if device is None else dict(device=device)


def cylinder_case(pkg, config: str = "r3", refine=None, n_steps: int = 10,
                  bench_precision: bool = True, device=None):
    """An InsIM of configuration `config` (one of CONFIGS), set up on the
    cylinder mesh refined `refine` times (None: the configuration's own
    size), with the classes of `pkg` (a namespace with AllParameters,
    generators and InsIM of either package; `port_package()` gives the
    port's).  device: the port's torch device (None: the default; leave
    None for the JAX package)."""
    knobs = insim_knobs(config, bench_precision)
    refine = REFINE[config] if refine is None else refine
    p = pkg.AllParameters(**cylinder_fields(refine, n_steps))
    meshes = cylinder_hierarchy(pkg.generators, refine)
    fluid = pkg.InsIM(meshes[-1], p, bc=inflow, **_kw(device))
    # before setup: f32_matrix and mixed_precision_precond decide the
    # types of the tables that setup and enable_pressure_mg build
    for name, value in knobs.items():
        setattr(fluid, name, value)
    fluid.setup()
    if len(meshes) > 1:
        fluid.enable_pressure_mg(meshes)
    return fluid


def imex_case(pkg, refine: int = 1, n_steps: int = 10, device=None):
    """An InsIMEX on the same mesh and fields, set up."""
    p = pkg.AllParameters(**cylinder_fields(refine, n_steps))
    mesh = cylinder_hierarchy(pkg.generators, refine)[-1]
    fluid = pkg.InsIMEX(mesh, p, bc=inflow, **_kw(device))
    fluid.setup()
    return fluid
