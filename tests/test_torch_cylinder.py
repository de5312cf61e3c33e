"""The standalone fluid path on the Turek cylinder (cases/fluid_cylinder.py)
in the port against the JAX package: the case itself, InsIM's
make_on_device_stepper and run_on_device, the bench knobs of the "r3" and
"r4" configurations, and the pressure V-cycle's tables on the cylinder's
refinement hierarchy (whose refined boundary vertices move onto the
circle).  Everything runs at refine 1 (368 cells, 3,612 dofs); the JAX
stepper is compiled once per configuration.

Tolerances, relative to the reference's max norm:
- all-f64 runs ("r1" without the bench knobs): solutions 1e-6 with equal
  Newton counts (each Newton system is solved to a 1e-8 relative
  residual); the final relative residuals of the two packages' windows
  agree to 1e-4 of their value;
- run_on_device against the port's own run(): 1e-9, the same arithmetic
  with other bookkeeping;
- the bench knobs (f32 preconditioner, Jacobian and outer shell, inner
  solves stopped at 1e-1 to 1e-2): 1e-3, the tolerance of
  test_torch_bench_leaflet_knobs.py for the same knobs, with equal Newton
  counts;
- multigrid tables 1e-12, their index tables equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.la.stencil import PatchGrid as JaxGrid
from openifem_tpu_torch.cases import fluid_cylinder as fc
from openifem_tpu_torch.la.stencil import PatchGrid
from torch_parity import JAX, PORT, rel_err


def _case(port, config="r1", n_steps=4, bench_precision=False):
    kw = dict(device="cpu") if port else {}
    return fc.cylinder_case(PORT if port else JAX, config, refine=1,
                            n_steps=n_steps,
                            bench_precision=bench_precision, **kw)


@pytest.fixture(scope="module")
def first_step_pair():
    """(JAX InsIM, its compiled stepper, port InsIM) of the all-f64 "r1"
    configuration after the host first step."""
    jfl, pfl = _case(False), _case(True)
    jfl.run_one_step(True, verbose=False)
    pfl.run_one_step(True, verbose=False)
    return jfl, jfl.make_on_device_stepper(), pfl


def test_case_builds_for_both_packages(first_step_pair):
    jfl, _, pfl = first_step_pair
    assert pfl.n_dofs == jfl.n_dofs == 3612
    assert pfl.mesh.n_cells == jfl.mesh.n_cells == 368
    assert pfl.params == PORT.AllParameters(**fc.cylinder_fields(1, 4))
    # not axis-aligned: the lattice decomposition gives up, the z-order
    # patches of the 92 coarse cells carry the stencil
    assert PatchGrid._build_lattice(pfl.mesh) is None
    pg, jg = PatchGrid.build(pfl.mesh), JaxGrid.build(jfl.mesh)
    assert len(pg.groups) == len(jg.groups) == 1
    np.testing.assert_array_equal(pg.groups[0], jg.groups[0])
    assert pfl._u_stencil is not None and pfl._pressure_mg is not None
    assert pfl.a_solve_branch(pfl.u_constraints) == "stencil"
    assert pfl.sm_solve_branch() == "cg+vcycle"
    # the inflow parabola on the inlet, zero elsewhere
    pts = np.array([[0.0, 0.205], [0.0, 0.0], [1.0, 0.205]])
    np.testing.assert_allclose(fc.inflow(pts, 0), [0.3, 0.0, 0.0])
    np.testing.assert_array_equal(fc.inflow(pts, 1), 0.0)


@pytest.mark.parametrize("config,want", [
    ("r1", dict(mixed_precision_precond=True, mp_sm_rtol=1e-1,
                f32_matrix=True, a_inner_rtol=1e-2)),
    ("r3", dict(mixed_precision_precond=True, mp_sm_rtol=1e-1,
                f32_matrix=True, a_inner_rtol=1e-2, f32_outer=True)),
    ("r4", dict(mixed_precision_precond=True, mp_sm_rtol=1e-1,
                f32_matrix=True, a_inner_rtol=1e-2, f32_outer=True,
                mg_direct=True))])
def test_knobs_are_the_bench_knobs(config, want):
    assert fc.insim_knobs(config) == want
    f64 = fc.insim_knobs(config, bench_precision=False)
    assert f64 == ({"mg_direct": True} if config == "r4" else {})
    with pytest.raises(ValueError):
        fc.insim_knobs("r2")


def test_first_step_matches_jax(first_step_pair):
    jfl, _, pfl = first_step_pair
    assert pfl.newton_iters == jfl.newton_iters > 1
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-6
    assert rel_err(pfl.stress_device, jfl.stress_device) <= 1e-6


def test_stepper_window_matches_jax(first_step_pair):
    jfl, jstep, pfl = first_step_pair
    jsol, jrel, jit = jstep(jfl.present_solution, 3)
    psol, prel, pit = pfl.make_on_device_stepper()(pfl.present_solution, 3)
    assert isinstance(prel, float) and isinstance(pit, int)
    assert pit == int(jit) > 1
    assert 0 < prel < pfl.params.fluid_tolerance
    assert abs(prel - float(jrel)) <= 1e-4 * float(jrel)
    assert rel_err(psol, jsol) <= 1e-6
    # the stepper leaves the solver's own state and clock alone
    assert pfl.time.get_timestep() == 1
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-6
    assert set(pfl.precond_branches) == {("stencil", "cg+vcycle")}


def test_stepper_of_zero_steps_returns_its_input(first_step_pair):
    _, _, pfl = first_step_pair
    sol, rel, it = pfl.make_on_device_stepper()(pfl.present_solution, 0)
    assert sol is pfl.present_solution and rel == 0.0 and it == 0


def test_count_host_syncs(first_step_pair):
    """Every Krylov iteration of the eager loops reads one device value
    on the host; the counter sees them, counts only the tensors it is
    asked to, and leaves torch.Tensor as it was."""
    from openifem_tpu_torch.utils.timer import count_host_syncs
    _, _, pfl = first_step_pair
    k0 = dict(pfl.krylov_iters)
    with count_host_syncs(lambda t: True) as every:
        with count_host_syncs() as on_card:
            pfl.make_on_device_stepper()(pfl.present_solution, 1)
    its = sum(pfl.krylov_iters[n] - k0[n] for n in ("outer", "mp", "sm", "a"))
    assert every["syncs"] >= its > 0
    assert on_card["syncs"] == 0      # no CUDA tensor in a CPU run
    with count_host_syncs(lambda t: True) as c:
        float(torch.ones(1)[0])
        bool(torch.ones(1)[0] > 0)
        torch.ones(2).tolist()
    assert c["syncs"] == 3
    assert not {"item", "cpu", "__bool__", "__float__"} & set(
        vars(torch.Tensor))


def test_run_on_device_matches_run_and_jax(first_step_pair):
    _, jstep, _ = first_step_pair
    host, dev, jfl = _case(True), _case(True), _case(False)
    host.run(verbose=False)
    dev.run_on_device(verbose=False)
    # the JAX run reuses the stepper that the fixture compiled
    jfl.make_on_device_stepper = lambda: jstep
    jfl.run_on_device(verbose=False)
    assert dev.time.get_timestep() == host.time.get_timestep() == 4
    assert abs(dev.time.current() - host.time.current()) <= 1e-15
    assert dev.newton_iters == int(jfl.newton_iters) == host.newton_iters
    for f in ("present_solution", "stress_device"):
        assert rel_err(getattr(dev, f), getattr(host, f)) <= 1e-9, f
        assert rel_err(getattr(dev, f), getattr(jfl, f)) <= 1e-6, f
    # the increment of the whole window, as in the JAX package
    assert rel_err(dev.solution_increment, jfl.solution_increment) <= 1e-5


def test_run_on_device_refuses_time_dependent_bcs():
    fl = _case(True)
    fl.add_hard_coded_boundary_condition(0, lambda pts, c, t: 0.0)
    with pytest.raises(AssertionError, match="static BCs"):
        fl.run_on_device(verbose=False)


def test_run_on_device_raises_when_a_step_does_not_converge():
    fl = _case(True)
    host_step = fl.run_one_step

    def first_step_then_one_newton_iteration(*args, **kw):
        host_step(*args, **kw)
        fl.params.fluid_max_iterations = 1

    fl.run_one_step = first_step_then_one_newton_iteration
    with pytest.raises(RuntimeError, match="Too many Newton iterations"):
        fl.run_on_device(verbose=False)


@pytest.mark.parametrize("config,branch", [
    ("r3", ("stencil", "cg+vcycle")), ("r4", ("stencil", "vcycle"))])
def test_bench_knobs_match_jax(config, branch):
    """The bench's windows at refine 1: "r3" takes the host first step,
    "r4" starts the stepper from the impulsive state (the boundary values
    injected, one time increment) and its first window is the warm-up."""
    jfl = _case(False, config, bench_precision=True)
    pfl = _case(True, config, bench_precision=True)
    assert pfl.f32_outer and pfl.f32_matrix and pfl.mixed_precision_precond
    assert pfl.mg_direct == (config == "r4")
    for fl in (jfl, pfl):
        if config == "r4":
            fl.present_solution = fl.nonzero_constraints.apply_increment(
                fl.present_solution)
            fl.time.increment()
        else:
            fl.run_one_step(True, verbose=False)
    jstep, pstep = jfl.make_on_device_stepper(), pfl.make_on_device_stepper()
    jsol, psol = jfl.present_solution, pfl.present_solution
    for n in (1, 2):
        jsol, jrel, jit = jstep(jsol, n)
        psol, prel, pit = pstep(psol, n)
        assert pit == int(jit), (n, pit, int(jit))
        assert rel_err(psol, jsol) <= 1e-3, n
    assert prel < pfl.params.fluid_tolerance
    assert float(jrel) < pfl.params.fluid_tolerance
    assert set(pfl.precond_branches) == {branch}
    if config == "r4":
        assert pfl.krylov_iters["sm"] == 0


def test_multigrid_tables_on_the_cylinder_hierarchy():
    """Three levels: 92, 368 and 1,472 cells."""
    from openifem_tpu.la import multigrid as jmg
    from openifem_tpu_torch.fe.space import FESpace
    from openifem_tpu_torch.la import multigrid as pmg
    jm = fc.cylinder_hierarchy(JAX.generators, 2)
    pm = fc.cylinder_hierarchy(PORT.generators, 2)
    assert [m.n_cells for m in pm] == [92, 368, 1472]
    sp = FESpace(pm[-1], 1)
    fixed = np.zeros(sp.n_nodes, dtype=bool)
    fixed[np.asarray(sp.boundary_nodes([1]))] = True
    jv = jmg.make_pressure_mg(jm, fixed, 2, jnp.float64)
    pv = pmg.make_pressure_mg(pm, fixed, 2, torch.float64, device="cpu")
    assert len(pv.levels) == len(jv.levels) == 3
    for a, b in zip(pv.levels, jv.levels):
        np.testing.assert_array_equal(a.cell_dofs.numpy(),
                                      np.asarray(b.cell_dofs))
        np.testing.assert_array_equal(a.fixed.numpy(), np.asarray(b.fixed))
        assert rel_err(a.A_loc, b.A_loc) <= 1e-12
        assert rel_err(a.dinv, b.dinv) <= 1e-12
        assert abs(a.lam_max - b.lam_max) <= 1e-12 * b.lam_max
    for (pcd, pW), (jcd, jW) in zip(pv.P, jv.P):
        np.testing.assert_array_equal(pcd.numpy(), np.asarray(jcd))
        assert rel_err(pW, jW) <= 1e-12
    assert rel_err(pv.A0_inv, jv.A0_inv) <= 1e-10
    b = np.random.default_rng(4).standard_normal(sp.n_nodes)
    assert rel_err(pv.vcycle(torch.as_tensor(b)),
                   jv.vcycle(jnp.asarray(b))) <= 1e-10
