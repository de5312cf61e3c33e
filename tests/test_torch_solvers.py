"""The port's InsIM and HyperElasticity against the JAX package on the
coarse leaflet, from the same state carried across with
openifem_tpu_torch.interop.

Tolerances (relative to the reference's max norm): element assembly
1e-12; one fluid Newton iteration 1e-7, because the outer FGMRES stops at
a 1e-8 relative residual; one solid Newmark step 1e-10 (dense f32 LU with
two f64 refinement steps, then Newton to 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu_torch import interop
from torch_parity import leaflet_fsi, rel_err, setup_fsi


@pytest.fixture(scope="module")
def pair():
    """(JAX FSI, port FSI), set up, with the same random mid-run state."""
    jfsi, pfsi = setup_fsi(leaflet_fsi(False)), setup_fsi(leaflet_fsi(True))
    jfl, jso = jfsi.fluid, jfsi.solid
    rng = np.random.default_rng(11)
    jfl.present_solution = jfl.nonzero_constraints.distribute(
        jnp.asarray(0.2 * rng.normal(size=jfl.n_dofs)))
    jfl.indicator = jnp.asarray(
        (rng.random(jfl.mesh.n_cells) < 0.05).astype(np.float64))
    jfl.update_stress()
    jso.current_displacement = jso.constraints.distribute(
        jnp.asarray(1e-3 * rng.normal(size=jso.n_dofs)))
    jso.current_velocity = jso.constraints.distribute(
        jnp.asarray(1e-2 * rng.normal(size=jso.n_dofs)))
    jso.current_acceleration = jso.constraints.distribute(
        jnp.asarray(rng.normal(size=jso.n_dofs)))
    jso.previous_displacement = jso.current_displacement
    jso.previous_velocity = jso.current_velocity
    jso.previous_acceleration = jso.current_acceleration
    jso.fsi_traction = jnp.asarray(rng.normal(size=jso.fsi_traction.shape))
    interop.load_fluid_state(pfsi.fluid, interop.fluid_state(jfl))
    interop.load_solid_state(pfsi.solid, interop.solid_state(jso))
    return jfsi, pfsi, rng


def test_interop_state_and_rebuilt_tables(pair):
    jfsi, pfsi, _ = pair
    jfl, pfl, jso, pso = jfsi.fluid, pfsi.fluid, jfsi.solid, pfsi.solid
    for f in interop.FLUID_FIELDS:
        assert rel_err(getattr(pfl, f), getattr(jfl, f)) == 0, f
    for f in interop.SOLID_FIELDS:
        assert rel_err(getattr(pso, f), getattr(jso, f)) == 0, f
    assert pfl.time.get_timestep() == jfl.time.get_timestep()
    for f in ("cell_dofs", "cell_dofs_u", "cell_dofs_p", "cell_nodes_u",
              "Mp_loc", "Mu_diag", "Mp_diag", "_A_const", "gravity_q",
              "_neumann_rhs_const"):
        assert rel_err(getattr(pfl, f).to(torch.float64),
                       np.asarray(getattr(jfl, f), dtype=np.float64)) \
            <= 1e-15, f
    for f in ("M_loc", "cell_dofs", "gravity_rhs"):
        assert rel_err(getattr(pso, f).to(torch.float64),
                       np.asarray(getattr(jso, f), dtype=np.float64)) == 0, f
    for pc, jc in ((pfl.zero_constraints, jfl.zero_constraints),
                   (pfl.nonzero_constraints, jfl.nonzero_constraints),
                   (pfl.u_constraints, jfl.u_constraints),
                   (pfl.p_constraints, jfl.p_constraints),
                   (pso.constraints, jso.constraints)):
        for f in ("hang_idx", "hang_w", "hanging", "dirichlet",
                  "dirichlet_values", "fixed"):
            assert rel_err(getattr(pc, f).to(torch.float64),
                           np.asarray(getattr(jc, f), dtype=np.float64)) \
                == 0, f


def _fields(fl, rng_state):
    """Random FSI forcing fields (same values for both packages)."""
    rng = np.random.default_rng(rng_state)
    n_c, d = fl.mesh.n_cells, fl.dim
    return (rng.normal(size=(n_c, d)), rng.normal(size=(n_c, d, d)),
            rng.normal(size=(fl.u_space.n_nodes, d)))


def test_assemble(pair):
    jfsi, pfsi, _ = pair
    jfl, pfl = jfsi.fluid, pfsi.fluid
    acc, stress, acc_n = _fields(jfl, 5)
    eval_np = np.asarray(jfl.present_solution) + 0.05 * \
        np.random.default_rng(6).normal(size=jfl.n_dofs)
    jA, jr = jax.jit(jfl._assemble)(
        jnp.asarray(eval_np), jfl.present_solution, jfl.indicator,
        jnp.asarray(acc), jnp.asarray(stress), jnp.asarray(acc_n))
    pA, pr = pfl._assemble(
        torch.from_numpy(eval_np), pfl.present_solution, pfl.indicator,
        torch.from_numpy(acc), torch.from_numpy(stress),
        torch.from_numpy(acc_n))
    assert rel_err(pA, jA) <= 1e-12
    assert rel_err(pr, jr) <= 1e-12


def test_assemble_convection_in_place(pair):
    """The velocity block's convection terms, added in place with one
    cell-sized temporary, equal their plain sum bit for bit, with a new
    matrix and written into a buffer."""
    _, pfsi, _ = pair
    pfl = pfsi.fluid
    acc, stress, acc_n = _fields(pfl, 9)
    args = (pfl.present_solution * 1.1, pfl.present_solution, pfl.indicator,
            torch.from_numpy(acc), torch.from_numpy(stress),
            torch.from_numpy(acc_n))
    A, _ = pfl._assemble(*args)
    buf = torch.full_like(A, float("nan"))
    A_buf, _ = pfl._assemble(*args, out=buf)
    assert A_buf.data_ptr() == buf.data_ptr()
    # the plain sum: both terms cell-sized, then added to A's block
    d, rho = pfl.dim, pfl.params.fluid_rho
    u = args[0][:pfl.n_u].reshape(-1, d)[pfl._u_cell_nodes]
    uc = torch.einsum("ql,cla->cqa", pfl.Nu, u)
    guc = torch.einsum("cqlx,cla->cqax", pfl.gu, u)
    Nu, gu, JxW = pfl._Nu_m, pfl._gu_m, pfl._JxW_m
    conv2 = torch.einsum("ql,cqm,cq->clm", Nu, torch.einsum(
        "cqmx,cqx->cqm", gu, uc.to(Nu.dtype)), JxW)
    conv = torch.einsum("clm,ab->clamb", rho * conv2,
                        torch.eye(d, dtype=Nu.dtype)) + torch.einsum(
        "ql,qm,cqab,cq->clamb", Nu, Nu, guc.to(Nu.dtype), JxW) * rho
    ref = pfl._A_const.clone()
    ref[:, :pfl.nu_loc, :pfl.nu_loc] += conv.reshape(
        A.shape[0], pfl.nu_loc, pfl.nu_loc)
    assert torch.equal(A, ref)
    assert torch.equal(A_buf, ref)


def test_one_newton_iteration(pair):
    jfsi, pfsi, _ = pair
    jfl, pfl = jfsi.fluid, pfsi.fluid
    acc, stress, acc_n = _fields(jfl, 8)
    j_eval = jfl.nonzero_constraints.apply_increment(jfl.present_solution)
    p_eval = pfl.nonzero_constraints.apply_increment(pfl.present_solution)
    jdu, jres, jits, _ = jfl._newton_iter(
        j_eval, jfl.present_solution, jfl.indicator, jnp.asarray(acc),
        jnp.asarray(stress), jnp.asarray(acc_n), jfl.zero_constraints,
        jfl.u_constraints, jfl.p_constraints)
    pdu, pres, pits, _ = pfl._newton_iter_impl(
        p_eval, pfl.present_solution, pfl.indicator, torch.from_numpy(acc),
        torch.from_numpy(stress), torch.from_numpy(acc_n),
        pfl.zero_constraints, pfl.u_constraints, pfl.p_constraints)
    assert abs(pres - float(jres)) <= 1e-12 * float(jres)
    assert pits == int(jits) > 0
    assert rel_err(pdu, jdu) <= 1e-7


def test_one_solid_newmark_step(pair):
    jfsi, pfsi, _ = pair
    jso, pso = jfsi.solid, pfsi.solid
    jt = jso._fsi_traction_rhs_impl(jso.fsi_traction)
    pt = pso._fsi_traction_rhs_impl(pso.fsi_traction)
    assert rel_err(pt, jt) <= 1e-14
    jout = jax.jit(jso._device_step_impl)(
        jso.current_displacement, jso.current_velocity,
        jso.current_acceleration, jt)
    pout = pso._device_step_impl(pso.current_displacement,
                                 pso.current_velocity,
                                 pso.current_acceleration, pt)
    assert pout[3] == int(jout[3]) > 1
    for got, want in zip(pout[:3], jout[:3]):
        assert rel_err(got, want) <= 1e-10


def test_solid_first_step_host_path():
    """run_one_step(first_step=True): the initial-acceleration mass solve
    (CG) and the host Newton loop, from rest under a traction."""
    jso, pso = (setup_fsi(leaflet_fsi(port)).solid for port in (False, True))
    trac = np.random.default_rng(4).normal(size=jso.fsi_traction.shape)
    jso.fsi_traction = jnp.asarray(trac)
    pso.fsi_traction = torch.from_numpy(trac)
    jso.run_one_step(True)
    pso.run_one_step(True)
    assert pso.newton_iters == jso.newton_iters
    for f in ("current_displacement", "current_velocity",
              "current_acceleration"):
        assert rel_err(getattr(pso, f), getattr(jso, f)) <= 1e-10, f


def _initial_field(points, component):
    """A smooth field that tells the components and the points apart."""
    return (component + 1.0) * np.sin(3.0 * points[:, 0]) + points[:, 1]


def test_set_initial_condition_matches_jax():
    """set_initial_condition before setup: velocity components and
    pressure sampled at their own nodes, in both packages; without it the
    solver starts from zero."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from torch_parity import JAX, PORT
    p_kw = fc.cylinder_fields(0, 1)
    out = []
    for pkg, kw in ((JAX, {}), (PORT, dict(device="cpu"))):
        fl = pkg.InsIM(pkg.generators.flow_around_cylinder(2),
                       pkg.AllParameters(**p_kw), bc=fc.inflow, **kw)
        fl.set_initial_condition(_initial_field)
        fl.setup()
        out.append(fl)
    jfl, pfl = out
    assert rel_err(pfl.present_solution, jfl.present_solution) == 0
    u = pfl.present_solution[:pfl.n_u].reshape(-1, 2).numpy()
    np.testing.assert_array_equal(
        u[:, 1], _initial_field(pfl.u_space.node_points, 1))
    np.testing.assert_array_equal(
        pfl.present_solution[pfl.n_u:].numpy(),
        _initial_field(pfl.p_space.node_points, 2))
    assert pfl.present_solution.dtype == torch.float64
    assert not bool(pfl.solution_increment.any())
    bare = PORT.InsIM(PORT.generators.flow_around_cylinder(2),
                      PORT.AllParameters(**p_kw), bc=fc.inflow, device="cpu")
    bare.setup()
    assert not bool(bare.present_solution.any())


@pytest.mark.parametrize("solver", ["InsIM", "InsIMEX"])
def test_interop_round_trip_on_a_cylinder_state(solver):
    """FLUID_FIELDS covers both fluid solvers: a JAX state after one step
    goes into the port's solver, whose next step then matches the JAX
    package's (1e-6: the outer solves stop at a 1e-8 relative
    residual)."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from torch_parity import JAX, PORT

    def build(pkg, **kw):
        if solver == "InsIM":
            return fc.cylinder_case(pkg, "r1", refine=0, n_steps=2,
                                    bench_precision=False, **kw)
        return fc.imex_case(pkg, 0, 2, **kw)
    jfl, pfl = build(JAX), build(PORT, device="cpu")
    jfl.run_one_step(True, verbose=False)
    state = interop.fluid_state(jfl)
    assert set(state) == set(interop.FLUID_FIELDS) | \
        set(interop.FLUID_OPTIONAL) | {"time"} | set(interop.BC_KEYS)
    interop.load_fluid_state(pfl, state)
    for f in interop.FLUID_FIELDS:
        assert rel_err(getattr(pfl, f), getattr(jfl, f)) == 0, f
    assert pfl.time.get_timestep() == 1
    back = interop.fluid_state(pfl)
    for f in interop.FLUID_FIELDS:
        np.testing.assert_array_equal(back[f], state[f])
    jfl.run_one_step(False, verbose=False)
    pfl.run_one_step(False, verbose=False)
    assert pfl.time.get_timestep() == jfl.time.get_timestep() == 2
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-6
    assert rel_err(pfl.stress_device, jfl.stress_device) <= 1e-6
