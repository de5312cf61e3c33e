"""The slice as a whole: the coarse fsi_leaflet (h = 0.1, refinements
[0, 1], 3 steps: the host first step and two coupled steps) run by
FSI.run in the JAX package and in the port, from the same configuration.
The fluid solution and the solid displacement agree to rtol 1e-6
(relative to the reference's max norm; the Newton and Krylov solves stop
at relative tolerances of 1e-6 to 1e-8), with equal Newton counts in
every step.  The leaflet has a free outflow, so the pressure is fixed and
needs no mean subtraction."""

import numpy as np

from torch_parity import leaflet_fsi, record_newton, rel_err


def test_coarse_leaflet_matches_jax():
    runs = {}
    for port in (False, True):
        fsi = leaflet_fsi(port, n_steps=3)
        log = record_newton(fsi)
        fsi.run(verbose=False)
        runs[port] = (fsi, log)
    (jfsi, jlog), (pfsi, plog) = runs[False], runs[True]
    assert len(plog) == 3 and plog == jlog
    assert [s["coupled"] for s in pfsi.step_log] == [False, True, True]
    assert [(s["solid_newton"], s["fluid_newton"])
            for s in pfsi.step_log] == plog
    assert rel_err(pfsi.fluid.present_solution,
                   jfsi.fluid.present_solution) <= 1e-6
    assert rel_err(pfsi.solid.current_displacement,
                   jfsi.solid.current_displacement) <= 1e-6
    assert rel_err(pfsi.fluid.stress_device, jfsi.fluid.stress_device) \
        <= 1e-6
    d = pfsi.solid.current_displacement.numpy().reshape(-1, 2)
    assert np.isfinite(d).all() and 1e-4 < d[:, 0].max() < 0.5
