"""The Washio incomplete-Schur ("Tpp") preconditioner of the port's SUPG
family against the JAX package, branch by branch.

One apply of the preconditioner cannot be held tightly: it solves Tpp to
1e-3 of its right-hand side, so its output moves by far more than rounding
when a Krylov count moves by one.  So the PIECES are held tightly instead:
both packages build their preconditioner from the same element matrix
(assembled by the JAX package at a seeded state), the JAX closures'
ingredients are read out of their cells (torch_parity.jax_precond_pieces),
and each is compared on seeded vectors:
  pvv_inv, apply_Avp, apply_Apv, op_App, Tpp, the B2pp diagonal, tpp_M(r)
  for the three choices (diagonal, GalerkinMG of the B2pp blocks, a frozen
  V-cycle) and the initial guess x0: 1e-12 of the reference's max norm,
  float64.  One exception, as in test_torch_multigrid.py: the GalerkinMG
  cycle is held at 1e-5, because both packages invert its coarse matrix
  by Newton-Schulz in float32.
The branches: the coupled stencil's component slices (d x 1, 1 x d,
1 x 1), the node-block element layouts, the flat rectangular layout (a
solver without a velocity node table), the dense condensed blocks with
the explicit dense Tpp, and the hybrid (stencil outer apply, dense Tpp).
The diagonal choice runs on a locally refined mesh (hanging nodes in both
constraint sets), the V-cycles on a uniform two-level hierarchy.
precond.stats(v) is held at 1e-6 with equal Tpp GMRES counts, in float64
and with the f32 preconditioner at 1e-3 (f32 rounding through a solve
stopped at 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (JAX, PORT, closure_vars, jax_precond_pieces, np_,
                          rel_err, supg_args, supg_mesh, supg_seed_state,
                          supg_solver)

# knobs, whether the velocity node table is taken away, the port's branch
BRANCHES = {
    "stencil": (dict(), False, ("stencil", "stencil")),
    "nodeblock": (dict(coupled_stencil=False), False,
                  ("element", "nodeblock")),
    "rect": (dict(coupled_stencil=False), True, ("element", "rect")),
    "dense": (dict(coupled_stencil=False, dense_precond=True), False,
              ("element", "dense")),
    "hybrid": (dict(dense_precond=True, stencil_outer_only=True), False,
               ("stencil", "dense")),
}


def _hierarchy(generators):
    base = supg_mesh(generators, local=False, nx=4, ny=2)
    return [base, base.refine_global(1)]


def _pair(branch, mg=None, solver="SCnsIM", **more):
    """(JAX solver, port solver, JAX preconditioner, port preconditioner)
    built from the JAX package's element matrix at a seeded state."""
    knobs, no_nodes, _ = BRANCHES[branch]
    knobs = dict(knobs, **more)
    out = []
    for port in (False, True):
        pkg = PORT if port else JAX
        if mg is None:
            fl = supg_solver(port, solver, **knobs)
        else:
            meshes = _hierarchy(pkg.generators)
            fl = supg_solver(port, solver, mesh=lambda g: meshes[-1],
                             **knobs)
            fl.enable_pressure_mg(meshes, galerkin=mg == "galerkin")
        if no_nodes:
            fl.cell_nodes_u = None
        out.append(fl)
    jfl, pfl = out
    eddy = supg_seed_state(jfl, pfl)
    jA, _ = jfl._assemble(*supg_args(jfl, jfl.present_solution, eddy,
                                     False))
    jP = jfl._make_preconditioner(jA, jfl.u_constraints, jfl.p_constraints)
    pP = pfl._make_preconditioner(torch.as_tensor(np.asarray(jA)),
                                  pfl.u_constraints, pfl.p_constraints)
    return jfl, pfl, jP, pP


def _vectors(pfl, seed=21):
    rng = np.random.default_rng(seed)
    vu = np_(pfl.u_constraints.set_zero(
        torch.as_tensor(rng.normal(size=pfl.n_u))))
    vp = np_(pfl.p_constraints.set_zero(
        torch.as_tensor(rng.normal(size=pfl.n_p))))
    return vu, vp


def _check_pieces(jfl, pfl, jP, pP, tol=1e-12, m_tol=1e-12):
    jp, pp = jax_precond_pieces(jP), pP.pieces
    vu, vp = _vectors(pfl)
    t, j = torch.as_tensor, jnp.asarray
    ones = np.ones(pfl.n_u)
    assert rel_err(pp["pvv_inv"], jp["Pvv_inverse"](j(ones))) <= tol
    assert rel_err(pp["apply_Avp"](t(vp)), jp["apply_Avp"](j(vp))) <= tol
    assert rel_err(pp["apply_Apv"](t(vu)), jp["apply_Apv"](j(vu))) <= tol
    assert rel_err(pp["Tpp"](t(vp)), jp["Tpp"](j(vp))) <= tol
    j_app = closure_vars(jp["Tpp"]).get("op_App")
    if j_app is not None:
        assert rel_err(pp["op_App"](t(vp)), j_app(j(vp))) <= tol
    assert rel_err(pp["tpp_M"](t(vp)), jp["tpp_M"](j(vp))) <= m_tol
    # the initial guess of the Tpp solve, from the JAX ingredients
    ptmp = j(vp) - jp["apply_Apv"](jp["Pvv_inverse"](j(vu)))
    Sc = jp["Tpp"](ptmp)
    x0 = jnp.vdot(ptmp, ptmp) / jnp.vdot(Sc, ptmp) * ptmp
    assert rel_err(pp["x0"](t(np.asarray(ptmp))), x0) <= tol
    return jp, pp


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_pieces_with_hanging_nodes(branch):
    jfl, pfl, jP, pP = _pair(branch)
    assert pfl.p_constraints.any_hanging and pfl.u_constraints.any_hanging
    assert list(pfl.precond_branches) == [BRANCHES[branch][2] + ("diag",)]
    jp, pp = _check_pieces(jfl, pfl, jP, pP)
    # the B2pp diagonal, through the JAX package's inverse of it
    b2pp_inv = closure_vars(jp["tpp_M"])["b2pp_inv"]
    assert rel_err(1.0 / pp["b2pp_diag"], b2pp_inv) <= 1e-12
    assert float(pp["b2pp_diag"][pfl.p_constraints.fixed].min()) == 1.0


@pytest.mark.parametrize("mg", ["galerkin", "vcycle"])
@pytest.mark.parametrize("branch", ["stencil", "nodeblock"])
def test_pieces_with_a_vcycle(branch, mg):
    jfl, pfl, jP, pP = _pair(branch, mg=mg)
    assert list(pfl.precond_branches) == [BRANCHES[branch][2] + (mg,)]
    _check_pieces(jfl, pfl, jP, pP,
                  m_tol=1e-5 if mg == "galerkin" else 1e-12)


@pytest.mark.parametrize("solver", ["SUPGInsIM", "SerialSCnsIM"])
def test_pieces_of_the_other_solvers(solver):
    _check_pieces(*_pair("stencil", solver=solver))


def test_stencil_slices_match_the_element_layouts():
    """The coupled stencil's rectangular component slices against the
    node-block element branch on the same matrix, inside the port."""
    _, pst, _, Pst = _pair("stencil")
    _, pel, _, Pel = _pair("nodeblock")
    vu, vp = map(torch.as_tensor, _vectors(pst))
    for name, v in (("apply_Avp", vp), ("apply_Apv", vu), ("op_App", vp),
                    ("Tpp", vp)):
        assert rel_err(Pst.pieces[name](v), Pel.pieces[name](v)) <= 1e-12, \
            name


@pytest.mark.parametrize("port", [False, True])
def test_hybrid_tpp_is_the_dense_tpp(port):
    """stencil_outer_only has no test in the reference: the hybrid's Tpp
    pieces are the all-dense branch's, in both packages."""
    jh, ph, jPh, pPh = _pair("hybrid")
    jd, pd, jPd, pPd = _pair("dense")
    vu, vp = _vectors(ph)
    if port:
        hy, de, conv = pPh.pieces, pPd.pieces, torch.as_tensor
    else:
        hy, de, conv = (jax_precond_pieces(jPh), jax_precond_pieces(jPd),
                        jnp.asarray)
        assert jh._sys_stencil is not None and jd._sys_stencil is None
    for name, v in (("apply_Avp", vp), ("apply_Apv", vu), ("Tpp", vp)):
        assert rel_err(hy[name](conv(v)), de[name](conv(v))) <= 1e-12, name


@pytest.mark.parametrize("branch,mg,f32", [
    ("stencil", None, False), ("nodeblock", None, False),
    ("dense", None, False), ("stencil", "galerkin", False),
    ("stencil", "galerkin", True)])
def test_stats_apply(branch, mg, f32):
    jfl, pfl, jP, pP = _pair(branch, mg=mg, mixed_precision_precond=f32)
    rng = np.random.default_rng(22)
    v = np_(pfl.zero_constraints.set_zero(
        torch.as_tensor(rng.normal(size=pfl.n_dofs))))
    ref, jits = jP.stats(jnp.asarray(v))
    k0 = dict(pfl.krylov_iters)
    got, pits = pP.stats(torch.as_tensor(v))
    assert got.dtype == torch.float64 and isinstance(pits, int)
    assert pits == int(jits) > 0
    assert pfl.krylov_iters["tpp"] - k0["tpp"] == pits
    assert pfl.krylov_iters["applies"] - k0["applies"] == 1
    assert rel_err(got, ref) <= (1e-3 if f32 else 1e-6)
    # the plain apply is the same map
    assert rel_err(pP(torch.as_tensor(v)), got) == 0
