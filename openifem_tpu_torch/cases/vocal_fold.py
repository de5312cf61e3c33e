"""The vocal-fold control-volume case, built in code: the configuration of
examples/vocal_fold_cv.py (the reference's flagship application,
OpenIFEM's cv_fsi) for either package.

A half-glottis channel of 2 x 1 (fluid [40, 20] cells); y = 1 is the
glottis centreline.  The fold, [4, 8] cells on [0, 0.3] x [0, 0.9]
shifted to x = 0.85, rises from the floor towards the centreline.
SCnsIM (Q1/Q1) with a Spalart-Allmaras eddy viscosity and its wall
functions, a SharedLinearElasticity fold, the MPI-semantics coupler with
penalty contact against y = 1, and per-step control-volume budgets over
[0.55, 1.45] x [0, 1] with a pressure probe at (0.25, 0.5) and the solid
boundary trace.  Fluid BCs: an inflow x-velocity of 5 on the inlet x = 0
(boundary id 0), no-slip floor (id 2), the outlet and the centreline
free; SA BCs: inflow on id 0, walls on ids 2 and 3, initial coefficient 3.

`global_refinements=(gf, gs)` refines the fluid gf and the solid gs times:
  (0, 0)  the example's size: fluid 800 cells, 861 nodes (2,583 dofs),
          SA 861, solid 32 cells (90 dofs): 3,534 dofs;
  (2, 1)  the full size: fluid 12,800 cells, 13,041 nodes (39,123 dofs),
          SA 13,041, solid 128 cells, 153 nodes (306 dofs): 52,470 dofs.

This module uses only numpy, so the JAX package and the PyTorch port build
the same configuration.

The reference's parameter file (fsi_contact_model_mpi.prm) is not in the
repository, so the physics are STAND-IN values, the same for both
packages, taken from cases/mpi_block.py, which converge with this solid
and the contact model: fluid viscosity 1e-2 and density 1; solid density
1, E 1e5, nu 0.3, eta 1, no damping, clamped on its floor face (id 2);
contact force multiplier 1e5; no gravity; Newton at most 8 iterations to
1e-6; the wall-function rows within 0.05 of the fold (one coarse cell;
image distance 0.01, the default); output, refinement and save intervals
past the end.
What was tried on the JAX package on the CPU, at the coarse size, for 3
steps through ControlVolumeFSI.run:
  time step 1e-2 (mpi_block's): the first fluid step does not converge
    (the inflow is squeezed through the 0.1 gap between the fold and the
    centreline; after the first Newton iteration the outer FGMRES stalls
    at 1,200 iterations and Newton gives up after 8);
  time step 1e-3 (kept): 5, 4 and 4 Newton iterations with 13-21 outer
    FGMRES iterations each, no contact retry, max nu~ 0.256, max shear
    velocity 1.13, max solid displacement 1.3e-3, 29-34 s;
  the default wall-function distance (1) makes every SA dof a wall row
    after the first step (the channel is 1 high), so nu~ stops evolving;
    0.05 (kept) pins 176 of 861 SA dofs after 3 steps and the turbulence
    dissipation rate keeps changing (0.065, 0.084, 0.163), 25 s.

Run the example's summary on the port:
    python -m openifem_tpu_torch.cases.vocal_fold [n_steps] [--full]
    [--device cpu]
"""

from __future__ import annotations

import numpy as np

from .fsi_leaflet import port_package  # noqa: F401  (the port's classes)

TIME_STEP = 1e-3
INFLOW = 5.0
L, H = 2.0, 1.0          # the channel; y = H is the glottis centreline
FLUID_REPS = [40, 20]
SOLID_REPS, SOLID_SIZE, SOLID_SHIFT = [4, 8], [0.3, 0.9], 0.85
# the reach of the wall-function rows around the moving fold
WALL_FUNCTION_DISTANCE = 0.05
CV_BOUNDARY = [0.55, 1.45, 0.0, H]
PROBE = (0.25, 0.5)
COARSE, FULL = (0, 0), (2, 1)
# SCnsIM knobs for the full size: fsi-wall-3D's bench knobs (dense
# condensed blocks and an explicit dense Tpp, element outer Jacobian, f32
# Jacobian, preconditioner and outer shell, inexact-Newton forcing)
BENCH_KNOBS = dict(dense_precond=True, coupled_stencil=False,
                   mixed_precision_precond=True, f32_matrix=True,
                   newton_forcing=(1e-4, 0.5), f32_outer=True)
# dofs (fluid + SA + solid) of the two sizes
DOFS = {COARSE: 3534, FULL: 52470}
SUMMARY_KEYS = ("inlet_volume_flow", "outlet_volume_flow", "present_KE",
                "rate_dissipation", "rate_turbulence", "gap_volume_flow",
                "contraction_end_x", "jet_start_x", "probed_pressure")


def vocal_fold_fields(n_steps: int = 3, global_refinements=COARSE):
    """AllParameters field values of the case (either package)."""
    never = 1e9
    return dict(
        simulation_type="FSI", dimension=2,
        global_refinements=list(global_refinements),
        end_time=n_steps * TIME_STEP, time_step=TIME_STEP,
        output_interval=never, refinement_interval=never,
        save_interval=never, gravity=[0.0, 0.0],
        initial_velocity=[0.0, 0.0],
        fluid_velocity_degree=1, fluid_pressure_degree=1,
        viscosity=1e-2, fluid_rho=1.0,
        fluid_max_iterations=8, fluid_tolerance=1e-6,
        n_fluid_dirichlet_bcs=2,
        fluid_dirichlet_bcs={0: (1, [INFLOW]), 2: (3, [0.0, 0.0])},
        n_spalart_allmaras_model_bcs=3,
        spalart_allmaras_model_bcs={0: 1, 2: 0, 3: 0},
        spalart_allmaras_initial_condition_coefficient=3.0,
        wall_function_effective_distance=WALL_FUNCTION_DISTANCE,
        solid_degree=1, solid_type="LinearElastic", solid_rho=1.0,
        E=[1e5], nu=[0.3], eta=[1.0], damping=0.0,
        solid_max_iterations=8, tol_d=1e-10, tol_f=1e-10,
        contact_force_multiplier=1e5,
        n_solid_dirichlet_bcs=1, solid_dirichlet_bcs={2: 3})


def penetration(points):
    """Depth of the points beyond the glottis centreline."""
    return points[:, 1] - H


def vocal_fold_case(pkg, n_steps: int = 3, global_refinements=COARSE,
                    knobs=None, device=None):
    """An unrun ControlVolumeFSI of the case, built with the classes of
    `pkg` (a namespace with AllParameters, generators, SCnsIM,
    SharedLinearElasticity, make_turbulence_model and ControlVolumeFSI of
    either package; `port_package()` gives the port's).  knobs: SCnsIM
    attribute values set before set-up.  device: the port's torch device
    (None: the default; leave None for the JAX package).
    ControlVolumeFSI.run refines, sets up and runs n_steps steps."""
    p = pkg.AllParameters(**vocal_fold_fields(n_steps, global_refinements))
    kw = {} if device is None else dict(device=device)
    fm = pkg.generators.subdivided_hyper_rectangle(FLUID_REPS, [0.0, 0.0],
                                                   [L, H])
    sm = pkg.generators.subdivided_hyper_rectangle(SOLID_REPS, [0.0, 0.0],
                                                   SOLID_SIZE)
    sm.vertices = sm.vertices + np.array([SOLID_SHIFT, 0.0])
    fluid = pkg.SCnsIM(fm, p, **kw)
    for name, value in (knobs or {}).items():
        setattr(fluid, name, value)
    pkg.make_turbulence_model("Spalart-Allmaras", fluid)
    solid = pkg.SharedLinearElasticity(sm, p, **kw)
    fsi = pkg.ControlVolumeFSI(fluid, solid, p)
    fsi.set_control_volume_boundary(CV_BOUNDARY)
    fsi.set_pressure_probe(PROBE)
    fsi.set_output_solid_boundary(True)
    fsi.set_penetration_criterion(penetration, np.array([0.0, -1.0]))
    return fsi


def standalone_fluid(pkg, n_steps: int = 3, global_refinements=COARSE,
                     knobs=None, device=None):
    """The case's channel without the fold: an unrun standalone SCnsIM
    with the Spalart-Allmaras model attached (its run() or
    run_on_device() refines, sets up and steps both)."""
    fields = vocal_fold_fields(n_steps, global_refinements)
    fields["simulation_type"] = "Fluid"
    p = pkg.AllParameters(**fields)
    kw = {} if device is None else dict(device=device)
    fm = pkg.generators.subdivided_hyper_rectangle(FLUID_REPS, [0.0, 0.0],
                                                   [L, H])
    fluid = pkg.SCnsIM(fm, p, **kw)
    for name, value in (knobs or {}).items():
        setattr(fluid, name, value)
    pkg.make_turbulence_model("Spalart-Allmaras", fluid)
    return fluid


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Run the vocal-fold "
                                 "control-volume case on the port and "
                                 "print the example's summary.")
    ap.add_argument("n_steps", nargs="?", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="the full size, global refinements (2, 1)")
    ap.add_argument("--bench-knobs", action="store_true",
                    help="SCnsIM with BENCH_KNOBS (dense Tpp, f32 "
                         "Jacobian and preconditioner) instead of its "
                         "defaults")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the port's, cuda)")
    args = ap.parse_args(argv)
    fsi = vocal_fold_case(port_package(), args.n_steps,
                          FULL if args.full else COARSE,
                          knobs=BENCH_KNOBS if args.bench_knobs else None,
                          device=args.device)
    fsi.run(verbose=True)
    for s in fsi.step_log:
        print(f"step {s['step']}: {1e3 * s['seconds']:.1f} ms, fluid "
              f"Newton {s['fluid_newton']}, SA Newton {s['sa_newton']} "
              f"(FGMRES {s['sa_fgmres']}), contact retries "
              f"{s['solid_retries']}, fluid Krylov {s['krylov']}")
    last = fsi.cv_history[-1]
    print("\ncontrol-volume summary at t =", last["time"])
    for k in SUMMARY_KEYS:
        print(f"  {k:24s} {last.get(k, float('nan')): .6e}")
    print("shear velocities: max",
          float(fsi.shear_velocities.max().item()))
    print("wrote control_volume_analysis.csv and solid_trace/")


if __name__ == "__main__":
    main()
