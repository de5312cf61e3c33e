"""Whole Newton iterations and steps of the port's SUPG family against the
JAX package (float64, CPU).

- One _newton_iter from a seeded state, and three steps of run_one_step,
  for SUPGInsIM, SCnsIM and SerialSCnsIM on the small locally refined
  channel of torch_parity.py: solutions and nodal stress 1e-6 of the
  reference's max norm with equal Newton counts per step (each Newton
  system is solved to outer_rtol = 1e-6, or 1e-8 for the serial variant,
  and the Tpp solve inside the preconditioner stops at 1e-3, so a Krylov
  count may differ by one while the converged step agrees).
- The coupled-stencil branch against the element branch, and the hybrid
  (stencil outer apply, dense Tpp) against the all-dense branch, inside
  the port and inside the JAX package: 1e-6, equal Newton counts.
- f32_matrix with mixed_precision_precond: 1e-5.
The steppers and the coupled FSI run are in test_torch_supg_stepper.py.
"""

import jax.numpy as jnp
import pytest
import torch

from torch_parity import (SUPG_SOLVERS, rel_err, supg_seed_state,
                          supg_solver)


def _three_steps(fl):
    """Newton counts of three steps of run_one_step."""
    its = []
    for i in range(3):
        fl.run_one_step(i == 0, verbose=False)
        its.append(int(fl.newton_iters))
    return its


@pytest.mark.parametrize("solver", SUPG_SOLVERS)
def test_newton_iter_and_three_steps_match_jax(solver):
    jfl, pfl = supg_solver(False, solver), supg_solver(True, solver)
    assert (pfl.outer_branch(), pfl.tpp_branch()) == ("stencil", "stencil")
    # one Newton iteration from a seeded state
    eddy = supg_seed_state(jfl, pfl, scale=0.05)
    tail = lambda fl, conv: (fl.present_solution, fl.indicator,  # noqa: E731
                             fl.fsi_acc_nodal, fl.fsi_stress_nodal,
                             fl.stress_device, conv(eddy),
                             fl.zero_constraints, fl.u_constraints,
                             fl.p_constraints)
    jdu, jrn, jits, _ = jfl._newton_iter(jfl.present_solution,
                                         *tail(jfl, jnp.asarray))
    pdu, prn, pits, _ = pfl._newton_iter(pfl.present_solution,
                                         *tail(pfl, torch.as_tensor))
    assert isinstance(prn, float) and isinstance(pits, int)
    assert abs(prn - float(jrn)) <= 1e-12 * float(jrn)
    assert abs(pits - int(jits)) <= 1
    assert rel_err(pdu, jdu) <= 1e-5      # one solve to outer_rtol
    # three steps from rest (a fresh pair: no indicator, no FSI fields)
    jfl, pfl = supg_solver(False, solver), supg_solver(True, solver)
    jits, pits = _three_steps(jfl), _three_steps(pfl)
    assert pits == jits and min(pits) > 1
    assert pfl.time.get_timestep() == jfl.time.get_timestep() == 3
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-6
    assert rel_err(pfl.stress_device, jfl.stress_device) <= 1e-6
    assert pfl.krylov_iters["outer"] > 0
    assert pfl.krylov_iters["applies"] >= pfl.krylov_iters["outer"]


@pytest.mark.parametrize("port", [False, True])
@pytest.mark.parametrize("a,b", [
    (dict(), dict(coupled_stencil=False)),
    (dict(dense_precond=True, stencil_outer_only=True),
     dict(dense_precond=True, coupled_stencil=False))],
    ids=["stencil-vs-element", "hybrid-vs-dense"])
def test_branches_agree(port, a, b):
    fa, fb = supg_solver(port, **a), supg_solver(port, **b)
    ia, ib = _three_steps(fa), _three_steps(fb)
    assert ia == ib
    assert rel_err(fa.present_solution, fb.present_solution) <= 1e-6
    if port:
        tpp = "dense" if "dense_precond" in a else "stencil"
        assert set(fa.precond_branches) == {("stencil", tpp, "diag")}
        assert set(fb.precond_branches) == {
            ("element", "dense" if tpp == "dense" else "nodeblock", "diag")}


def test_f32_knobs_run():
    """f32_matrix and mixed_precision_precond together (the cast points of
    the assembly and of both applies): the converged steps agree with the
    JAX package's to 1e-5, the band of an inexact Newton step in f32."""
    knobs = dict(f32_matrix=True, mixed_precision_precond=True)
    jfl, pfl = supg_solver(False, **knobs), supg_solver(True, **knobs)
    assert _three_steps(pfl) == _three_steps(jfl)
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-5
