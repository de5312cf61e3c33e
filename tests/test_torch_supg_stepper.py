"""The steppers of the port's SUPG family and its place in the FSI coupler,
against the port's own run() and the JAX package (float64, CPU).

- make_on_device_stepper with a bc_value_table, and run_on_device, against
  the port's own run() on the acoustic duct (a hard-coded BC that changes
  every step): 1e-12 of the solution's scale, as the JAX package's own
  test asks of it; and against the JAX stepper on a 2-step window: 1e-6
  of the reference's max norm, equal Newton counts.
- A 2-step coupled FSI run with an SCnsIM fluid and the hyperelastic
  leaflet (the SUPG branches of fsi/fsi.py; the second step is the coupled
  step): 1e-6, equal Newton counts.
"""

import pytest
import torch

from openifem_tpu_torch.cases import acoustic_duct as ad
from openifem_tpu_torch.cases import fsi_leaflet as lf
from torch_parity import JAX, PORT, record_newton, rel_err


@pytest.fixture(scope="module")
def duct_host_run():
    fl = ad.duct_case(PORT, "SCnsIM", refine=1, n_steps=4, device="cpu")
    fl.run(verbose=False)
    return fl


@pytest.mark.parametrize("solver", ["SCnsIM", "SerialSCnsIM"])
def test_run_on_device_matches_run(solver, duct_host_run):
    if solver == "SCnsIM":
        host = duct_host_run
    else:
        host = ad.duct_case(PORT, solver, refine=1, n_steps=4, device="cpu")
        host.run(verbose=False)
    dev = ad.duct_case(PORT, solver, refine=1, n_steps=4, device="cpu")
    dev.run_on_device(verbose=False)
    assert dev.time.get_timestep() == host.time.get_timestep() == 4
    assert dev.bc_time == pytest.approx(host.bc_time - 3 * ad.TIME_STEP)
    assert dev.tpp_M_branch() == "galerkin"      # attached by the run
    scale = max(1.0, float(host.present_solution.abs().max()))
    err = float((dev.present_solution - host.present_solution).abs().max())
    assert err <= 1e-12 * scale
    assert rel_err(dev.stress_device, host.stress_device) <= 1e-12


def test_stepper_with_bc_table_matches_run(duct_host_run):
    host = duct_host_run
    fl = ad.duct_case(PORT, "SCnsIM", refine=1, n_steps=4, device="cpu")
    fl._refine_setup_with_mg()
    table = fl.bc_value_table(4)
    assert float(table[3].abs().max()) > 0       # changes every step
    step = fl.make_on_device_stepper(table)
    # two calls of two steps, the second offset into the table
    sol, stress, rel1, it1 = step(fl.present_solution, fl.stress_device, 2)
    sol, stress, rel2, it2 = step(sol, stress, 2, start=2)
    assert isinstance(rel2, float) and isinstance(it2, int) and it2 > 1
    assert max(rel1, rel2) < fl.params.fluid_tolerance
    scale = max(1.0, float(host.present_solution.abs().max()))
    assert float((sol - host.present_solution).abs().max()) <= 1e-12 * scale
    # the stepper leaves the solver's own state and clock alone
    assert fl.time.get_timestep() == 0
    assert float(fl.present_solution.abs().max()) == 0
    # without a table: zero-increment stepping from the state it is given
    sol0, _, rel0, _ = fl.make_on_device_stepper()(sol, stress, 1)
    assert torch.isfinite(sol0).all() and rel0 < fl.params.fluid_tolerance


def test_stepper_window_matches_jax():
    jfl = ad.duct_case(JAX, "SCnsIM", refine=1, n_steps=2)
    pfl = ad.duct_case(PORT, "SCnsIM", refine=1, n_steps=2, device="cpu")
    jfl.run_on_device(verbose=False)
    pfl.run_on_device(verbose=False)
    assert pfl.newton_iters == int(jfl.newton_iters) > 1
    assert pfl.time.get_timestep() == jfl.time.get_timestep() == 2
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-6
    assert rel_err(pfl.stress_device, jfl.stress_device) <= 1e-6


def _scnsim_leaflet(pkg, n_steps=2, h=0.1, refinements=(0, 1), **kw):
    """The coarse leaflet with a Q1/Q1 SCnsIM fluid instead of InsIM."""
    fields = lf.leaflet_fields(h=h, refinements=refinements,
                               n_steps=n_steps)
    fields.update(fluid_velocity_degree=1, fluid_pressure_degree=1)
    p = pkg.AllParameters(**fields)
    fluid_mesh, solid_mesh = lf.leaflet_meshes(pkg.generators, h)
    fluid = pkg.SCnsIM(fluid_mesh, p, bc=lf.inflow, **kw)
    return pkg.FSI(fluid, pkg.HyperElasticity(solid_mesh, p, **kw), p,
                   use_dirichlet_bc=True)


def test_fsi_with_scnsim_fluid_matches_jax():
    runs = []
    for pkg, kw in ((JAX, {}), (PORT, dict(device="cpu"))):
        fsi = _scnsim_leaflet(pkg, **kw)
        log = record_newton(fsi)
        fsi.run(verbose=False)
        runs.append((fsi, log))
    (jfsi, jlog), (pfsi, plog) = runs
    assert plog == jlog and len(plog) == 2
    assert [s["coupled"] for s in pfsi.step_log] == [False, True]
    assert float(pfsi.fluid.indicator.sum()) > 0
    assert set(pfsi.fluid.precond_branches) == {
        ("stencil", "stencil", "diag")}
    for name in ("present_solution", "stress_device", "indicator"):
        assert rel_err(getattr(pfsi.fluid, name),
                       getattr(jfsi.fluid, name)) <= 1e-6, name
    assert rel_err(pfsi.solid.current_displacement,
                   jfsi.solid.current_displacement) <= 1e-6
