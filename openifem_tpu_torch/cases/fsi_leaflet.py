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


def leaflet_fields(h: float = 0.05, refinements=(0, 2), n_steps: int = 10):
    """AllParameters field values of the case (either package)."""
    dt = 5e-3
    never = 1e9  # output / refinement / save intervals: no I/O, no AMR
    return dict(
        simulation_type="FSI", dimension=2,
        global_refinements=list(refinements),
        end_time=n_steps * dt, time_step=dt,
        output_interval=never, refinement_interval=never,
        save_interval=never,
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
