"""The port's Spalart-Allmaras model (solvers/turbulence/) and the SUPG
family's turbulence hooks against the JAX package, on the small locally
refined channel of torch_parity.py (hanging nodes) with SCnsIM:

- set-up: the constraint masks and values, the fixed wall distance, the
  initial nu~ and eddy viscosity, equal or within 1e-12;
- one Newton iteration on a seeded state (negative nu~ entries, an
  artificial-fluid indicator, a finite moving-wall distance): A_loc and
  the rhs within 1e-12, the update within 1e-10, equal FGMRES counts;
- the wall functions: get_shear_velocity over the zero, viscous-sublayer
  and Newton regimes within 1e-12; update_moving_wall_distance within
  1e-12, with an exact tie between an edge and a vertex that the edge
  wins; update_boundary_condition over two steps (equal masks, values
  within 1e-12);
- 3 steps of SCnsIM + SA through run() within 1e-6 with equal fluid and
  SA Newton counts per step; run_on_device (the SA step fused into the
  stepper) against the host run() within 1e-6;
- the factory's refusal of an unknown model, and the checkpoint of a
  fluid with a model attached restoring the model's state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.solvers.turbulence.spalart_allmaras import \
    KAPPA as JAX_KAPPA
from openifem_tpu_torch.solvers.turbulence import (SpalartAllmaras,
                                                   make_turbulence_model)
from openifem_tpu_torch.solvers.turbulence.spalart_allmaras import KAPPA
from torch_parity import np_, rel_err, sa_solver


@pytest.fixture(scope="module")
def pair():
    return sa_solver(False), sa_solver(True)


def test_setup_tables(pair):
    jfl, pfl = pair
    jm, pm = jfl.turbulence_model, pfl.turbulence_model
    assert isinstance(pm, SpalartAllmaras) and pm.n == jm.n
    for name in ("dirichlet", "hanging", "fixed"):
        np.testing.assert_array_equal(
            np_(getattr(pm.zero_constraints, name)),
            np.asarray(getattr(jm.zero_constraints, name)), name)
    assert np_(pm.zero_constraints.hanging).any()
    assert rel_err(pm.nonzero_constraints.dirichlet_values,
                   jm.nonzero_constraints.dirichlet_values) == 0
    assert rel_err(pm.fixed_wall_distance, jm.fixed_wall_distance) <= 1e-15
    assert np.isinf(np_(pm.moving_wall_distance)).all()
    for name in ("present_solution", "eddy_viscosity_nodal"):
        assert rel_err(getattr(pm, name), getattr(jm, name)) <= 1e-15
    assert pfl.eddy_viscosity_nodal is pm.eddy_viscosity_nodal
    np.testing.assert_array_equal(np_(pm.cell_dofs),
                                  np.asarray(jm.cell_dofs))
    assert pm.cell_dofs.dtype == torch.int32


def _seed(jm, pm, seed=3):
    """The same seeded mid-run state in both models and fluids; returns
    the Newton arguments (eval_pt, present, fluid solution, wall
    distance, indicator) as numpy arrays."""
    rng = np.random.default_rng(seed)
    lam = jm.params.viscosity / jm.params.fluid_rho
    fl = jm.fluid
    present = lam * (2.0 + 3.0 * rng.normal(size=jm.n))  # some negative
    eval_pt = present + 0.3 * lam * rng.normal(size=jm.n)
    sol = 0.3 * rng.normal(size=fl.n_dofs)
    wall = np.minimum(np.asarray(jm.fixed_wall_distance),
                      0.05 + rng.random(jm.n))
    ind = (rng.random(fl.mesh.n_cells) < 0.2).astype(float)
    assert (present < 0).any() and ind.any()
    return eval_pt, present, sol, wall, ind


def test_newton_iter_on_seeded_state(pair):
    jfl, pfl = pair
    jm, pm = jfl.turbulence_model, pfl.turbulence_model
    args = _seed(jm, pm)
    jA, jr = jm._assemble(*map(jnp.asarray, args))
    pA, pr = pm._assemble(*map(torch.as_tensor, args))
    assert rel_err(pA, jA) <= 1e-12 and rel_err(pr, jr) <= 1e-12
    jdu, jrn, jits = jm._newton_iter(*map(jnp.asarray, args),
                                     jm.zero_constraints)
    pdu, prn, pits = pm._newton_iter(*map(torch.as_tensor, args),
                                     pm.zero_constraints)
    assert isinstance(prn, float) and abs(prn - float(jrn)) <= \
        1e-12 * float(jrn)
    assert pits == int(jits) > 1
    assert rel_err(pdu, jdu) <= 1e-10


def test_shear_velocity(pair):
    jfl, pfl = pair
    jm, pm = jfl.turbulence_model, pfl.turbulence_model
    rng = np.random.default_rng(7)
    # zero and below 1e-10, the viscous sublayer, and the Newton regime
    vel = np.concatenate([[0.0, 5e-11], 1e-3 * rng.random(8),
                          10.0 ** rng.uniform(-1, 3, 40)])
    init = 10.0 ** rng.uniform(-3, 1, len(vel))
    want = jm.get_shear_velocity(vel, init)
    got = pm.get_shear_velocity(torch.as_tensor(vel), torch.as_tensor(init))
    assert rel_err(got, want) <= 1e-12
    assert np_(got)[:2].max() == 0 and np_(got)[2:].min() > 0


def test_moving_wall_distance_with_tie(pair):
    """An edge and a vertex exactly 0.25 from the corner node (0, 0): the
    edge, which comes first, wins, so y+ takes the edge's interpolated
    shear velocity."""
    jfl, pfl = pair
    jm, pm = jfl.turbulence_model, pfl.turbulence_model
    verts = np.array([[-0.25, -0.25], [0.25, -0.25], [0.0, 0.25],
                      [1.0, 0.3], [1.5, 0.1]])
    faces = np.array([[0, 1], [3, 4]])
    ut = np.array([1.0, 3.0, 10.0, 0.5, 0.7])
    jm.update_moving_wall_distance(verts, faces, ut)
    pm.update_moving_wall_distance(*map(torch.as_tensor,
                                        (verts, faces, ut)))
    assert rel_err(pm.moving_wall_distance, jm.moving_wall_distance) <= 1e-12
    assert rel_err(pm.y_plus, jm.y_plus) <= 1e-12
    corner = np.flatnonzero(
        np.abs(pfl.u_space.node_points).sum(axis=1) == 0)[0]
    nu = pfl.params.viscosity / pfl.params.fluid_rho
    assert np_(pm.moving_wall_distance)[corner] == 0.25
    assert np_(pm.y_plus)[corner] == 0.25 * 2.0 / nu


def test_update_boundary_condition_two_steps():
    jfl, pfl = sa_solver(False), sa_solver(True)
    jm, pm = jfl.turbulence_model, pfl.turbulence_model
    rng = np.random.default_rng(11)
    n_c = jfl.mesh.n_cells
    lam = jm.params.viscosity / jm.params.fluid_rho
    # wall rows only near the chain, so the two steps' rows differ
    for fl in (jfl, pfl):
        fl.params.wall_function_effective_distance = 0.08
    masks = []
    for step, first in enumerate((True, False)):
        ind = (rng.random(n_c) < 0.15).astype(float)
        jfl.indicator, pfl.indicator = jnp.asarray(ind), torch.as_tensor(ind)
        # a solid boundary chain near the floor, its shear velocities small
        # enough for y+ < 200
        x = np.linspace(0.3, 1.4, 6)
        verts = np.stack([x, 0.05 + 0.02 * step + 0.01 * np.sin(3 * x)], 1)
        faces = np.stack([np.arange(5), np.arange(1, 6)], 1)
        ut = 0.05 * rng.random(6)
        jm.update_moving_wall_distance(verts, faces, ut)
        pm.update_moving_wall_distance(*map(torch.as_tensor,
                                            (verts, faces, ut)))
        nu = lam * (1.0 + rng.random(jm.n))
        jm.present_solution = jnp.asarray(nu)
        pm.present_solution = torch.as_tensor(nu)
        jm.update_boundary_condition(first)
        pm.update_boundary_condition(first)
        np.testing.assert_array_equal(np_(pm._accum_mask), jm._accum_mask)
        for name in ("_step_zero", "_step_nonzero"):
            jc, pc = getattr(jm, name), getattr(pm, name)
            for mask in ("dirichlet", "fixed"):
                np.testing.assert_array_equal(np_(getattr(pc, mask)),
                                              np.asarray(getattr(jc, mask)))
            assert rel_err(pc.dirichlet_values, jc.dirichlet_values) <= 1e-12
        masks.append(np_(pm._accum_mask).copy())
    # rows in both steps, and the second step keeps the first step's
    assert masks[0].any() and (masks[1] >= masks[0]).all()
    assert masks[1].sum() > masks[0].sum()
    assert KAPPA == JAX_KAPPA


def _count_sa_newton(model):
    """Count the model's Newton iterations per step: calls of its
    _newton_iter, logged by the caller."""
    calls = [0]
    real = model._newton_iter

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    model._newton_iter = counted
    return calls


def _run_logged(fl):
    """run() with (fluid Newton, SA Newton) per step."""
    log, calls = [], _count_sa_newton(fl.turbulence_model)
    real = fl.run_one_step

    def step(*a, **k):
        real(*a, **k)
        log.append((int(fl.newton_iters), calls[0]))
        calls[0] = 0
    fl.run_one_step = step
    fl.run(verbose=False)
    return log


def test_run_three_steps_and_stepper_match():
    jfl, pfl = sa_solver(False), sa_solver(True)
    jlog, plog = _run_logged(jfl), _run_logged(pfl)
    assert plog == jlog and len(plog) == 3 and min(n for _, n in plog) >= 1
    jm, pm = jfl.turbulence_model, pfl.turbulence_model
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-6
    assert rel_err(pm.present_solution, jm.present_solution) <= 1e-6
    assert rel_err(pm.eddy_viscosity_nodal, jm.eddy_viscosity_nodal) <= 1e-6
    assert np_(pm.eddy_viscosity_nodal).max() > 0
    # the SA step fused into the stepper, against the host run
    dfl = sa_solver(True)
    dfl.run_on_device(verbose=False)
    dm = dfl.turbulence_model
    assert dfl.time.get_timestep() == pfl.time.get_timestep() == 3
    assert rel_err(dfl.present_solution, pfl.present_solution) <= 1e-6
    assert rel_err(dm.present_solution, pm.present_solution) <= 1e-6
    assert rel_err(dfl.stress_device, pfl.stress_device) <= 1e-6


def test_refusals(tmp_path, monkeypatch):
    """The factory refuses an unknown model; the checkpoint of a fluid
    with a model attached, which used to be refused, restores the
    model's state."""
    monkeypatch.chdir(tmp_path)
    fl = sa_solver(True)
    with pytest.raises(ValueError, match="Unknown turbulence model"):
        make_turbulence_model("k-epsilon", fl)
    fl.save_checkpoint()
    fresh = sa_solver(True)
    assert fresh.load_checkpoint()
    for name in ("present_solution", "moving_wall_distance", "y_plus",
                 "_accum_mask", "eddy_viscosity_nodal"):
        np.testing.assert_array_equal(
            np_(getattr(fresh.turbulence_model, name)),
            np_(getattr(fl.turbulence_model, name)))
