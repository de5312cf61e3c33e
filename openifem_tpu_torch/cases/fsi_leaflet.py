"""The fsi_leaflet case, built in code: a flexible leaflet clamped to the
bottom wall of a 2D channel with a parabolic inflow (OpenIFEM's
tests/fsi_leaflet).

This module uses only numpy, so the JAX package and the PyTorch port build
their `AllParameters(**leaflet_fields(...))` and meshes from the same
input and the two runs cannot drift.

Geometry, inflow and mesh are those of the repo's leaflet test
(tests/test_fsi.py::_leaflet_setup).  The reference's parameter file,
tests/fsi_leaflet/fsi_leaflet.prm, is not in the repository, so its
physics are replaced by STAND-IN values, the same for both packages:
viscosity 1e-2, fluid_rho 1, grad_div 1, fluid Newton at most 8
iterations to 1e-6; a NeoHookean solid with solid_rho 1, C1 = 1e5,
kappa = 1e6, solid Newton at most 8 iterations with tol_d = tol_f = 1e-10;
no gravity.  With C = [[1e3, 1e4]] the solid Newton diverges on step 2;
[[1e4, 1e5]] runs but needs 7 of 8 Newton iterations at the full size;
[[1e5, 1e6]] converges in 4-6.  Matching the reference's own values waits
until its .prm file is in the repository.

At h = 0.05 and global_refinements (0, 2) the fluid has 1,780 cells
(14,758 velocity + 1,897 pressure dofs) and the solid 256 cells (594
dofs): 17,249 dofs in all.

Three solver configurations of the case (`CONFIGS`), built by
`leaflet_case` for either package:
  "element"         the element-matvec preconditioner branch (a_stencil
                    off: the locally refined mesh would otherwise take the
                    stencil inside the constraint wrap);
  "fsi_leaflet"     the JAX bench's headline case (bench.py:502-533): the
                    dense condensed preconditioner with a bf16 A block, on
                    the same 17,249-dof mesh;
  "fsi_leaflet_r2"  the JAX bench's scaled case (bench.py:539-574): a
                    UNIFORM base mesh refined global_refinements[0] +
                    extra_refine times (232,997 dofs at h = 0.05 and
                    extra_refine = 2), the inner A-solve in the stencil
                    patch layout and one pressure V-cycle as Sm^-1
                    (mg_direct) over the nested hierarchy.
With bench_precision the two bench configurations also take the bench's
precision and tolerance knobs (BENCH_PRECISION_KNOBS); without, they run
in float64 throughout.  ADAPTIVE adds interface refinement and
checkpoints to a configuration (refine_every / save_every, in steps).
"""

from __future__ import annotations

import numpy as np

# channel length L and height H, leaflet width a and height b, base mesh
# size h, peak inflow velocity U
LEAFLET = (4.0, 1.0, 0.1, 0.4, 0.05, 1.5)   # L, H, a, b, h, U


def inflow(points, component):
    """Parabolic inflow on the inlet x = 0 (hard-coded boundary values)."""
    L, H, a, b, h, U = LEAFLET
    out = np.zeros(len(points))
    if component == 0:
        m = np.abs(points[:, 0]) < 1e-10
        out[m] = U - 4 * U / (H * H) * (points[m, 1] - H / 2) ** 2
    return out


def leaflet_fields(h: float = 0.05, refinements=(0, 2), n_steps: int = 10,
                   refine_every=None, save_every=None):
    """AllParameters field values of the case (either package).  By
    default no output, no AMR and no checkpoints; refine_every /
    save_every (in time steps) set the refinement and save intervals."""
    dt = 5e-3
    never = 1e9
    return dict(
        simulation_type="FSI", dimension=2,
        global_refinements=list(refinements),
        end_time=n_steps * dt, time_step=dt,
        output_interval=never,
        refinement_interval=never if refine_every is None
        else refine_every * dt,
        save_interval=never if save_every is None else save_every * dt,
        gravity=[0.0, 0.0],
        fluid_velocity_degree=2, fluid_pressure_degree=1,
        viscosity=1e-2, fluid_rho=1.0, grad_div=1.0,
        fluid_max_iterations=8, fluid_tolerance=1e-6,
        use_hard_coded_values=1,
        # inlet (0) and walls (2, 3) fully constrained; outflow (1) free
        n_fluid_dirichlet_bcs=3,
        fluid_dirichlet_bcs={0: (3, [0.0, 0.0]), 2: (3, [0.0, 0.0]),
                             3: (3, [0.0, 0.0])},
        solid_degree=1, solid_type="NeoHookean", solid_rho=1.0,
        C=[[1e5, 1e6]], solid_max_iterations=8, tol_d=1e-10, tol_f=1e-10,
        # clamped base
        n_solid_dirichlet_bcs=1, solid_dirichlet_bcs={2: 3},
    )


def leaflet_meshes(generators, h: float = 0.05):
    """(fluid_mesh, solid_mesh) at base size h, built with the given
    package's mesh.generators module: the channel with one level of
    refinement in a band around the leaflet, and the leaflet itself
    (max(1, int(a/h)) cells across)."""
    L, H, a, b, _, _ = LEAFLET
    fluid_mesh = generators.subdivided_hyper_rectangle(
        [int(L / h), int(H / h)], [0.0, 0.0], [L, H])
    centers = fluid_mesh.cell_centers()
    flags = ((centers[:, 0] >= L / 4 - a) & (centers[:, 0] <= L / 4 + 2 * a) &
             (centers[:, 1] < H / 2))
    fluid_mesh = fluid_mesh.refine(flags)
    solid_mesh = generators.subdivided_hyper_rectangle(
        [max(1, int(a / h)), int(b / h)], [L / 4, 0.0], [a + L / 4, b])
    return fluid_mesh, solid_mesh


CONFIGS = ("element", "fsi_leaflet", "fsi_leaflet_r2")

# the adaptive leaflet: path A's configuration ("fsi_leaflet") with the
# interface refinement of FSI.run (fluid cells within one cell diameter of
# the leaflet's boundary at level global_refinements[0] + 1, the rest
# coarsened to global_refinements[0]) every 2 steps and a checkpoint every
# 5 steps
ADAPTIVE = dict(config="fsi_leaflet", refine_every=2, save_every=5)

# the precision and tolerance knobs that BenchInsIM sets on both leaflet
# bench cases (bench.py:502-533): f32 preconditioner, f32 Jacobian and
# outer Krylov shell, inexact-Newton forcing, loose inner tolerances
BENCH_PRECISION_KNOBS = dict(
    mixed_precision_precond=True, mp_sm_rtol=1e-1, f32_matrix=True,
    newton_forcing=(1e-4, 0.5), a_inner_rtol=1e-2, f32_outer=True)


def insim_knobs(config: str, bench_precision: bool = True) -> dict:
    """InsIM attribute values of a configuration (either package)."""
    if config == "element":
        return dict(a_stencil=False)
    if config == "fsi_leaflet":
        knobs = dict(dense_precond=True, dense_a_bf16=bench_precision)
    elif config == "fsi_leaflet_r2":
        knobs = dict(mg_direct=True)
    else:
        raise ValueError(f"unknown configuration {config!r}; "
                         f"one of {CONFIGS}")
    if bench_precision:
        knobs.update(BENCH_PRECISION_KNOBS)
    return knobs


def uniform_hierarchy(generators, h: float, levels: int):
    """[base, base.refine_global(1), ..., base.refine_global(levels)] for
    the uniform channel mesh at base size h (the r2 case's fluid meshes)."""
    L, H, _, _, _, _ = LEAFLET
    meshes = [generators.subdivided_hyper_rectangle(
        [int(L / h), int(H / h)], [0.0, 0.0], [L, H])]
    for _ in range(levels):
        meshes.append(meshes[-1].refine_global(1))
    return meshes


def port_package():
    """The port's classes, in the form `leaflet_case` takes a package."""
    from types import SimpleNamespace

    from ..fsi import FSI, MPIFSI, ControlVolumeFSI
    from ..mesh import generators
    from ..parameters import AllParameters
    from ..solvers import solid
    from ..solvers.fluid import (InsIM, InsIMEX, SCnsEX, SCnsIM,
                                 SerialSCnsIM, SUPGInsIM)
    from ..solvers.turbulence import make_turbulence_model
    return SimpleNamespace(AllParameters=AllParameters,
                           generators=generators, InsIM=InsIM,
                           InsIMEX=InsIMEX, SUPGInsIM=SUPGInsIM,
                           SCnsIM=SCnsIM, SerialSCnsIM=SerialSCnsIM,
                           SCnsEX=SCnsEX, FSI=FSI, MPIFSI=MPIFSI,
                           ControlVolumeFSI=ControlVolumeFSI,
                           make_turbulence_model=make_turbulence_model,
                           **{name: getattr(solid, name)
                              for name in solid.__all__})


def leaflet_case(pkg, config: str = "fsi_leaflet", h: float = 0.05,
                 refinements=(0, 2), n_steps: int = 10,
                 extra_refine: int = 2, bench_precision: bool = True,
                 device=None, refine_every=None, save_every=None):
    """An unrun FSI of configuration `config` (one of CONFIGS), built with
    the classes of `pkg` (a namespace with AllParameters, generators,
    InsIM, HyperElasticity and FSI of either package; `port_package()`
    gives the port's).  device: the port's torch device (None: the
    default; leave None for the JAX package).  FSI.run sets it up and
    runs n_steps steps.  The adaptive leaflet (ADAPTIVE) sets
    refine_every and save_every, in time steps: FSI.run then refines the
    fluid around the leaflet twice before the first step, again every
    refine_every steps, and writes a coordinated checkpoint to the
    working directory every save_every steps."""
    knobs = insim_knobs(config, bench_precision)
    p = pkg.AllParameters(**leaflet_fields(
        h=h, refinements=refinements, n_steps=n_steps,
        refine_every=refine_every, save_every=save_every))
    kw = {} if device is None else dict(device=device)
    fluid_mesh, solid_mesh = leaflet_meshes(pkg.generators, h)
    hierarchy = None
    if config == "fsi_leaflet_r2":
        # FSI.run refines the fluid mesh global_refinements[0] more times,
        # so the finest level is hierarchy[-1], as in the bench
        hierarchy = uniform_hierarchy(pkg.generators, h,
                                      refinements[0] + extra_refine)
        fluid_mesh = hierarchy[extra_refine]
    fluid = pkg.InsIM(fluid_mesh, p, bc=inflow, **kw)
    for name, value in knobs.items():
        setattr(fluid, name, value)
    fsi = pkg.FSI(fluid, pkg.HyperElasticity(solid_mesh, p, **kw), p,
                  use_dirichlet_bc=True)
    if hierarchy is not None:
        fsi.fluid_mg_base = hierarchy[:-1]
    return fsi


def main(argv=None):
    """The JAX package's examples/fsi_leaflet.py on the port: the leaflet
    through FSI.run, then the last state's VTU/PVD output (fluid-*.vtu,
    solid-*.vtu and their .pvd collections) in the working directory, the
    timers and the leaflet's tip deflection."""
    import argparse
    ap = argparse.ArgumentParser(description="Run the fsi_leaflet case on "
                                 "the port and write its last state for "
                                 "ParaView.")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--config", default="element", choices=CONFIGS,
                    help="solver configuration (default: %(default)s, the "
                         "plain preconditioner)")
    ap.add_argument("--h", type=float, default=LEAFLET[4],
                    help="base mesh size (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the port's, cuda)")
    args = ap.parse_args(argv)
    fsi = leaflet_case(port_package(), args.config, h=args.h,
                       n_steps=args.steps, bench_precision=False,
                       device=args.device)
    fsi.run(verbose=True)
    fluid, solid = fsi.fluid, fsi.solid
    fluid.output_results()
    solid.update_strain_and_stress()
    solid.output_results()
    fsi.timer.print_summary()
    fluid.timer.print_summary()
    d = solid.current_displacement.reshape(-1, 2)
    print(f"leaflet tip deflection: {d[:, 0].max().item():.6e}")


if __name__ == "__main__":
    main()
