"""The stencil + multigrid configuration of the leaflet (the JAX bench's
fsi_leaflet_r2, bench.py:539-574) as a whole, at test size: a uniform
channel (h = 0.2) refined once, so the pressure V-cycle has 2 levels;
3 steps through FSI.run in the JAX package and in the port, f64
throughout.  FSI.run attaches the V-cycle (FSI.fluid_mg_base) and the
inner A-solve runs in the stencil patch layout, one V-cycle as Sm^-1
(mg_direct).  The fluid solution, the solid displacement and the fluid
stress agree to rtol 1e-6 (relative to the reference's max norm), with
equal Newton counts in every step."""

import numpy as np

from torch_parity import leaflet_fsi, rel_err, run_pair, setup_fsi

R2 = dict(config="fsi_leaflet_r2", h=0.2, extra_refine=1,
          bench_precision=False)


def test_r2_leaflet_matches_jax():
    (jfsi, jlog), (pfsi, plog) = run_pair(**R2)
    assert len(plog) == 3 and plog == jlog
    assert set(pfsi.fluid.precond_branches) == {("stencil", "vcycle")}
    assert pfsi.fluid.krylov_iters["sm"] == 0
    assert len(pfsi.fluid._pressure_mg.levels) == 2
    for a, b in ((pfsi.fluid.present_solution, jfsi.fluid.present_solution),
                 (pfsi.solid.current_displacement,
                  jfsi.solid.current_displacement),
                 (pfsi.fluid.stress_device, jfsi.fluid.stress_device)):
        assert rel_err(a, b) <= 1e-6
    d = pfsi.solid.current_displacement.numpy().reshape(-1, 2)
    assert np.isfinite(d).all() and 1e-4 < d[:, 0].max() < 0.5


def test_r2_pressure_has_no_fixed_dofs():
    """FSI.run attaches the pressure V-cycle with fixed_prefix=False, the
    bench with fixed_prefix=True; on the uniform mesh with a free outflow
    no pressure dof is fixed, so the two cycles are the same operator."""
    fl = setup_fsi(leaflet_fsi(True, n_steps=1, **R2)).fluid
    assert not fl.p_constraints.fixed.any()
    assert not fl.u_constraints.any_hanging
