"""The dense-preconditioner configuration of the leaflet (the JAX bench's
fsi_leaflet, bench.py:502-533) as a whole: 3 steps through FSI.run (the
host first step and two coupled steps) in the JAX package and in the
port, on the coarse leaflet (h = 0.1, refinements [0, 1]) with the bench's
branch knobs (dense_precond) and f64 throughout.  The fluid solution, the
solid displacement and the fluid stress agree to rtol 1e-6 (relative to
the reference's max norm; the Newton and Krylov solves stop at relative
tolerances of 1e-6 to 1e-8), with equal Newton counts in every step."""

import numpy as np

from torch_parity import rel_err, run_pair


def test_dense_leaflet_matches_jax():
    (jfsi, jlog), (pfsi, plog) = run_pair(config="fsi_leaflet",
                                          bench_precision=False)
    assert len(plog) == 3 and plog == jlog
    assert pfsi.fluid.dense_precond and not pfsi.fluid.dense_a_bf16
    assert set(pfsi.fluid.precond_branches) == {("dense", "cg")}
    for a, b in ((pfsi.fluid.present_solution, jfsi.fluid.present_solution),
                 (pfsi.solid.current_displacement,
                  jfsi.solid.current_displacement),
                 (pfsi.fluid.stress_device, jfsi.fluid.stress_device)):
        assert rel_err(a, b) <= 1e-6
    d = pfsi.solid.current_displacement.numpy().reshape(-1, 2)
    assert np.isfinite(d).all() and 1e-4 < d[:, 0].max() < 0.5
