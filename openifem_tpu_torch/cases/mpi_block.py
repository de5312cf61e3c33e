"""The MPI coupler's 2-D block case, built in code: an elastic block of
1 x 1.02 standing on the floor of a 2 x 1 channel at x in [0.25, 1.25],
its top 0.02 above the channel's ceiling, with air pushed in at the inlet
(the geometry of OpenIFEM's tests/fsi_contact_model_mpi as the JAX
package's tests/test_mpi_fsi.py:304-317 builds it: fluid [20, 10], solid
[5, 5]).  SCnsIM (Q1/Q1) with the MPI-semantics coupler.

This module uses only numpy, so the JAX package and the PyTorch port build
the same configuration.

Three configurations (`CONFIGS`), built by `block_case` for either
package:
  "body_force"  SharedLinearElasticity (HHT-alpha), the body-force
                coupling;
  "contact"     the same with the penalty contact model against a rigid
                wall at y = 1.0199, 1e-4 under the block's top: the first
                step retries the solid until the penetration is under
                1e-5 (source/mpi_fsi.cpp:870-969);
  "dirichlet"   SharedHyperElasticity (NeoHookean) and the Dirichlet
                coupling (use_dirichlet_bc=True).

The reference's parameter file is not in the repository, so the physics
are STAND-IN values, the same for both packages: time step 1e-2; air-like
fluid (viscosity 1e-2, density 1), a pressure of 2 on the inlet x = 0
(boundary id 0), no-slip floor and ceiling (ids 2, 3), the outlet free;
solid density 1, E 1e5, nu 0.3, eta 1, no damping (NeoHookean C1 1e4,
kappa 1e5), clamped on its floor face (id 2); contact force multiplier
1e5; no gravity.  What was tried on the port (CPU): with damping 0.1 the
HHT-alpha scheme's two literal beta values make the stiff block's step
answer a downward contact traction with an upward displacement (dt^2 K/M
is about 250 here), and the retries diverge; with no damping and the wall
at y = 1 (0.02 of penetration) one retry moves the block 0.05 in one step
and the fluid's Newton loop stalls on the coupling acceleration.  With the
values above every step converges in a few Newton iterations and the
contact model retries (the counts are held equal between the packages in
tests/test_torch_mpi_fsi.py).
"""

from __future__ import annotations

import numpy as np

from .fsi_leaflet import port_package  # noqa: F401  (the port's classes)

TIME_STEP = 1e-2
CONFIGS = ("body_force", "contact", "dirichlet")
SOLIDS = {"body_force": ("SharedLinearElasticity", "LinearElastic"),
          "contact": ("SharedLinearElasticity", "LinearElastic"),
          "dirichlet": ("SharedHyperElasticity", "NeoHookean")}
# the rigid wall of the contact configuration
WALL = 1.0199


def block_fields(config: str = "body_force", n_steps: int = 3):
    """AllParameters field values of a configuration (either package)."""
    never = 1e9
    return dict(
        simulation_type="FSI", dimension=2, global_refinements=[0, 0],
        end_time=n_steps * TIME_STEP, time_step=TIME_STEP,
        output_interval=never, refinement_interval=never,
        save_interval=never, gravity=[0.0, 0.0],
        initial_velocity=[0.0, 0.0],
        fluid_velocity_degree=1, fluid_pressure_degree=1,
        viscosity=1e-2, fluid_rho=1.0,
        fluid_max_iterations=8, fluid_tolerance=1e-6,
        n_fluid_dirichlet_bcs=2,
        fluid_dirichlet_bcs={2: (3, [0.0, 0.0]), 3: (3, [0.0, 0.0])},
        n_fluid_neumann_bcs=1, fluid_neumann_bcs={0: 2.0},
        solid_degree=1, solid_type=SOLIDS[config][1], solid_rho=1.0,
        E=[1e5], nu=[0.3], eta=[1.0], damping=0.0, C=[[1e4, 1e5]],
        solid_max_iterations=8, tol_d=1e-10, tol_f=1e-10,
        contact_force_multiplier=1e5,
        n_solid_dirichlet_bcs=1, solid_dirichlet_bcs={2: 3})


def penetration(points):
    """Depth of the points beyond the wall."""
    return points[:, 1] - WALL


def block_case(pkg, config: str = "body_force", n_steps: int = 3,
               device=None):
    """An unrun MPIFSI of configuration `config` (one of CONFIGS), built
    with the classes of `pkg` (`port_package()` gives the port's)."""
    if config not in CONFIGS:
        raise ValueError(f"unknown configuration {config!r}; "
                         f"one of {CONFIGS}")
    p = pkg.AllParameters(**block_fields(config, n_steps))
    kw = {} if device is None else dict(device=device)
    fm = pkg.generators.subdivided_hyper_rectangle([20, 10], [0.0, 0.0],
                                                   [2.0, 1.0])
    sm = pkg.generators.subdivided_hyper_rectangle([5, 5], [0.0, 0.0],
                                                   [1.0, 1.02])
    sm.vertices = sm.vertices + np.array([0.25, 0.0])
    fluid = pkg.SCnsIM(fm, p, **kw)
    solid = getattr(pkg, SOLIDS[config][0])(sm, p, **kw)
    fsi = pkg.MPIFSI(fluid, solid, p,
                     use_dirichlet_bc=config == "dirichlet")
    if config == "contact":
        fsi.set_penetration_criterion(penetration, np.array([0.0, -1.0]))
    return fsi
