"""The acoustic duct case, built in code: a Gaussian velocity pulse sent
down a 4 x 1 duct of air (OpenIFEM's tests/acoustic_duct_wave,
acoustic_duct_wave_mpi and acoustic_duct_wave_mpi_scnsex), for the three
slightly-compressible solvers.

This module uses only numpy, so the JAX package and the PyTorch port build
their `AllParameters(**duct_fields(...))` and meshes from the same input
and the two runs cannot drift.

Geometry, mesh and pulse are those of the repo's acoustic tests and of the
JAX bench (tests/test_acoustics.py, bench.py bench_scnsex_duct):
`subdivided_hyper_rectangle([8, 2], [0, 0], [4, 1])` refined 3 times
(1,024 cells, 3,315 dofs with Q1/Q1), boundary ids 0 left, 1 right, 2
bottom, 3 top; on the inlet x = 0 the x-velocity follows
6.0 exp(-0.5 ((t - 0.5e-4) / 0.15e-4)^2).  SCnsEX imposes the value and
lets the boundary condition expire at t = 1.1e-4
(`set_hard_coded_boundary_condition_time`); SCnsIM takes the value's
increment per step with the first-step guard of the MPI test, SerialSCnsIM
the guard-free increment of the serial test.

The reference's parameter files (tests/acoustic_duct_wave*/*.prm) are not
in the repository, so the physics and numerics are STAND-IN values, the
same for both packages: air in CGS units (density 1.3e-3, viscosity
1.8e-4; with the solvers' atm = 1,013,250 and cp/cv = 1.4 the speed of
sound is about 33,000), time step 2e-7 (c dt / h = 0.11 at h = 1/16), 200
steps (to t = 0.4e-4, where the inlet has reached 4.8 of its peak 6.0),
the inlet fully constrained, zero normal velocity on the walls, the
outlet free; at most 20 fixed-point sweeps (SCnsEX) or 8 Newton
iterations (the implicit solvers) to a relative 1e-6.  Tried on the port
at refine 3 on the CPU: with a time step of 1e-6 (c dt / h = 0.53)
SCnsEX's sweeps stop converging near step 170 and the pressure blows up
(the velocity-pressure coupling is explicit); with 2e-7 every step
converges in 3-4 sweeps of about 10 CG iterations per solve.  Matching the
reference's own values, and its golden peak velocities (5.91 / 5.93 /
6.0), waits until its .prm files are in the repository.

`duct_case` refines `extra_refine` more times with the time step cut by
the same factor, so c dt / h is kept: the way to give a device more than
the 1,024-cell problem.
"""

from __future__ import annotations

import numpy as np

from .fsi_leaflet import port_package  # noqa: F401  (the port's classes)

SOLVERS = ("SCnsEX", "SCnsIM", "SerialSCnsIM")

TIME_STEP = 2e-7
REFINE = 3
# pulse amplitude, centre and width; expiry of SCnsEX's inlet BC
PEAK, CENTER, WIDTH, EXPIRY = 6.0, 0.5e-4, 0.15e-4, 1.1e-4


def pulse_value(t):
    return PEAK * np.exp(-0.5 * ((t - CENTER) / WIDTH) ** 2)


def gaussian_pulse(dt: float, incremental: bool, guard: bool = True):
    """Hard-coded inlet BC fn(points, component, t).  incremental: the
    value's change over the last step (the implicit solvers add their
    inhomogeneity to the present solution), with `guard` taking the whole
    value on the first step (t < 2 dt) as the MPI test does; the serial
    test's functor has no guard."""
    def fn(points, component, t):
        out = np.zeros(len(points))
        if component == 0:
            m = np.abs(points[:, 0]) < 1e-10
            if not incremental:
                out[m] = pulse_value(t)
            elif guard:
                prev = 0.0 if t < 2 * dt else pulse_value(t - dt)
                out[m] = pulse_value(t) - prev
            else:
                out[m] = pulse_value(t) - pulse_value(t - dt)
        return out
    return fn


def duct_fields(refine: int = REFINE, n_steps: int = 200,
                time_step: float = TIME_STEP, implicit: bool = False):
    """AllParameters field values of the case (either package)."""
    never = 1e9  # output / refinement / save intervals: no I/O, no AMR
    return dict(
        simulation_type="Fluid", dimension=2,
        global_refinements=[refine, 0],
        end_time=n_steps * time_step, time_step=time_step,
        output_interval=never, refinement_interval=never,
        save_interval=never,
        gravity=[0.0, 0.0],
        fluid_velocity_degree=1, fluid_pressure_degree=1,
        viscosity=1.8e-4, fluid_rho=1.3e-3,
        fluid_max_iterations=8 if implicit else 20, fluid_tolerance=1e-6,
        use_hard_coded_values=1,
        # inlet (0) fully constrained (the pulse); walls (2, 3): zero
        # normal velocity; outlet (1) free
        n_fluid_dirichlet_bcs=3,
        fluid_dirichlet_bcs={0: (3, [0.0, 0.0]), 2: (2, [0.0]),
                             3: (2, [0.0])},
    )


def duct_case(pkg, solver: str = "SCnsEX", refine: int = REFINE,
              n_steps: int = 200, extra_refine: int = 0, device=None,
              **knobs):
    """An unrun solver of class `solver` (one of SOLVERS) on the unrefined
    duct mesh, with the classes of `pkg` (a namespace with AllParameters,
    generators, SCnsEX, SCnsIM and SerialSCnsIM of either package;
    `port_package()` gives the port's).  run() and run_on_device() refine
    the mesh `refine + extra_refine` times, set the solver up and (the
    implicit solvers) attach the Tpp V-cycle over the refinement
    hierarchy.  knobs: class attributes to set (precision, branches).
    device: the port's torch device (None: the default; leave None for
    the JAX package)."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    implicit = solver != "SCnsEX"
    dt = TIME_STEP / 2 ** extra_refine
    p = pkg.AllParameters(**duct_fields(refine + extra_refine, n_steps, dt,
                                        implicit))
    mesh = pkg.generators.subdivided_hyper_rectangle([8, 2], [0, 0],
                                                     [4.0, 1.0])
    kw = {} if device is None else dict(device=device)
    fluid = getattr(pkg, solver)(mesh, p, **kw)
    for name, value in knobs.items():
        setattr(fluid, name, value)
    fluid.add_hard_coded_boundary_condition(
        0, gaussian_pulse(dt, incremental=implicit,
                          guard=solver == "SCnsIM"))
    if not implicit:
        fluid.set_hard_coded_boundary_condition_time(0, EXPIRY)
    return fluid
