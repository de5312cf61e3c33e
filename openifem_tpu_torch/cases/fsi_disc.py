"""A disc in the lid-driven cavity, built in code: the geometry of the
JAX package's tests/test_fsi.py:120-137 (OpenIFEM's tests/fsi_cavity; a
disc of radius 0.1 at (0.6, 0.6) in the unit square, global refinements
(3, 1)) with the immersed coupler's interface refinement.

This module uses only numpy, so the JAX package and the PyTorch port build
the same configuration.

The reference's parameter file is not in the repository, so the physics
are STAND-IN values, the same for both packages: the cavity (InsIM,
Taylor-Hood Q2/Q1, viscosity 1e-2, density 1, no-slip on ids 0-2, the lid
(id 3) moving at 1, Newton at most 8 iterations to 1e-8, time step 1e-2),
and a NeoHookean (C 1e4, 1e5) or linear elastic (E 1e4, nu 0.3) disc of
density 2 under gravity -1, body-force coupling.  With a refinement
interval shorter than the run, FSI.run refines the fluid cells near the
disc to level 4 twice before the first step (64 -> 103 cells) and again
at the interval.
"""

from __future__ import annotations

NEVER = 1e9


def cavity_fields(n_steps: int = 4, refine_every=None, save_every=None,
                  dt: float = 0.01):
    """AllParameters field values of the cavity alone (simulation type
    "Fluid", refined twice); refine_every / save_every in time steps."""
    return dict(
        simulation_type="Fluid", dimension=2, global_refinements=[2, 0],
        end_time=n_steps * dt, time_step=dt, output_interval=NEVER,
        refinement_interval=NEVER if refine_every is None
        else refine_every * dt,
        save_interval=NEVER if save_every is None else save_every * dt,
        gravity=[0.0, 0.0], fluid_velocity_degree=2,
        fluid_pressure_degree=1, viscosity=1e-2, fluid_rho=1.0,
        fluid_max_iterations=8, fluid_tolerance=1e-8,
        n_fluid_dirichlet_bcs=4,
        fluid_dirichlet_bcs={0: (3, [0.0, 0.0]), 1: (3, [0.0, 0.0]),
                             2: (3, [0.0, 0.0]), 3: (3, [1.0, 0.0])})


def disc_fields(n_steps: int = 3, refine_every=2, save_every=None,
                solid: str = "HyperElasticity", dt: float = 0.01):
    """AllParameters field values of the disc in the cavity."""
    fields = cavity_fields(n_steps, refine_every, save_every, dt)
    fields.update(
        simulation_type="FSI", global_refinements=[3, 1],
        gravity=[0.0, -1.0], solid_degree=1,
        solid_type="NeoHookean" if solid == "HyperElasticity"
        else "LinearElastic", solid_rho=2.0, C=[[1e4, 1e5]], E=[1e4],
        nu=[0.3], solid_max_iterations=8, tol_d=1e-10, tol_f=1e-10)
    return fields


def disc_case(pkg, n_steps: int = 3, refine_every=2, save_every=None,
              solid: str = "HyperElasticity", device=None):
    """An unrun FSI of the disc in the cavity with the classes of `pkg`
    (cases.fsi_leaflet.port_package() gives the port's); `solid` is
    "HyperElasticity" or "LinearElasticity" (which also refines itself at
    the refinement interval).  device: the port's torch device (leave
    None for the JAX package)."""
    p = pkg.AllParameters(**disc_fields(n_steps, refine_every, save_every,
                                        solid))
    kw = {} if device is None else dict(device=device)
    fluid = pkg.InsIM(pkg.generators.hyper_cube(0.0, 1.0, dim=2), p, **kw)
    fluid.a_stencil = False
    disc = getattr(pkg, solid)(pkg.generators.sphere([0.6, 0.6], 0.1, dim=2),
                               p, **kw)
    return pkg.FSI(fluid, disc, p, use_dirichlet_bc=False)
