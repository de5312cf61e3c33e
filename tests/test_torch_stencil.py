"""The port's structured-patch stencil (la/stencil.py), the weighted
Krylov inner product (la/krylov.py `weight=`) and the InsIM preconditioner
branch choice, against the JAX package on the same meshes and seeded
inputs.

Meshes: the locally refined leaflet channel (lattice bricks of two levels,
hanging nodes), the uniform channel of the r2 case (one lattice brick)
and the Turek cylinder grid refined once (z-order patches).  Tolerances,
relative to the reference's max norm: the stencil applies 1e-12 (the same
sums in another order); weighted CG / FGMRES equal iteration counts and
solutions within 1e-10 (they stop at a 1e-12 residual).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.fe.space import FESpace as JaxSpace
from openifem_tpu.la import krylov as jkrylov
from openifem_tpu.la.stencil import PatchGrid as JaxGrid
from openifem_tpu.la.stencil import StencilOperator as JaxStencil
from openifem_tpu.mesh import generators as jgen
from openifem_tpu_torch.cases.fsi_leaflet import (leaflet_meshes,
                                                  uniform_hierarchy)
from openifem_tpu_torch.fe.space import FESpace
from openifem_tpu_torch.la import krylov
from openifem_tpu_torch.la.stencil import PatchGrid, StencilOperator
from openifem_tpu_torch.mesh import generators as pgen
from torch_parity import JAX, PORT, leaflet_fsi, rel_err, setup_fsi

MESHES = {
    "leaflet": lambda g: leaflet_meshes(g, 0.1)[0],
    "uniform": lambda g: uniform_hierarchy(g, 0.2, 1)[-1],
    "cylinder": lambda g: g.flow_around_cylinder(2).refine_global(1),
}


def _pair(name, degree):
    jm, pm = MESHES[name](jgen), MESHES[name](pgen)
    return (JaxSpace(jm, degree), FESpace(pm, degree),
            JaxGrid.build(jm), PatchGrid.build(pm))


@pytest.mark.parametrize("name", MESHES)
def test_patch_grid_groups_equal(name):
    _, _, jg, pg = _pair(name, 1)
    assert jg is not None and pg is not None
    assert len(pg.groups) == len(jg.groups)
    for a, b in zip(pg.groups, jg.groups):
        np.testing.assert_array_equal(a, b)
    assert pg.n_patches == jg.n_patches


@pytest.mark.parametrize("degree,d", [(1, 1), (2, 2)])
@pytest.mark.parametrize("name", MESHES)
def test_stencil_applies_match_jax(name, degree, d):
    js, ps, jg, pg = _pair(name, degree)
    jst, pst = JaxStencil(jg, js, d=d), StencilOperator(pg, ps, d=d)
    np.testing.assert_array_equal(pst.pad_node.numpy(),
                                  np.asarray(jst.pad_node))
    np.testing.assert_array_equal(pst.first_slot.numpy(),
                                  np.asarray(jst.first_slot))
    assert pst.n_shared == jst.n_shared
    rng = np.random.default_rng(3)
    nl = ps.cell_dofs.shape[1]
    n = ps.n_nodes * d
    Ab = rng.standard_normal((ps.mesh.n_cells, nl, d, nl, d))
    x = rng.standard_normal(n)
    fixed = np.zeros(n, dtype=bool)
    fixed[rng.choice(n, n // 10, replace=False)] = True
    jW, pW = jst.build_weights(jnp.asarray(Ab)), \
        pst.build_weights(torch.as_tensor(Ab))
    for a, b in zip(pW, jW):
        assert rel_err(a, b) <= 1e-15
    rows, cols = slice(0, 1), slice(d - 1, d)
    for a, b in zip(pst.slice_weights(pW, rows, cols),
                    jst.slice_weights(jW, rows, cols)):
        assert rel_err(a, b) <= 1e-15
    jx, px = jnp.asarray(x), torch.as_tensor(x)
    jX, pX = jst.spread(jx), pst.spread(px)
    assert rel_err(pX, jX) == 0
    jf = jst.spread_mask(jnp.asarray(fixed))
    pf = pst.spread_mask(torch.as_tensor(fixed))
    assert np.array_equal(pf.numpy(), np.asarray(jf))
    assert rel_err(pst.matvec(pW, pX), jst.matvec(jW, jX)) <= 1e-12
    assert rel_err(pst.condensed_matvec(pW, pf, pX),
                   jst.condensed_matvec(jW, jf, jX)) <= 1e-12
    assert rel_err(pst.flat_matvec(pW, px), jst.flat_matvec(jW, jx)) \
        <= 1e-12
    assert rel_err(pst.unspread(pX), jst.unspread(jX)) == 0
    assert rel_err(pst.weight(torch.float64), jst.weight(jnp.float64)) == 0
    # the JAX package's spread_blockdiag raises (stencil.py:515 transposes
    # a 3-D array with four axes): hold the port's against the flat nodal
    # block apply, spread with the JAX package
    D = rng.standard_normal((ps.n_nodes, d, d))
    Dx = np.einsum("nab,nb->na", D, x.reshape(-1, d)).reshape(-1)
    assert rel_err(pst.spread_blockdiag(torch.as_tensor(D))(pX),
                   jst.spread(jnp.asarray(Dx))) <= 1e-15


@pytest.mark.parametrize("solver", ["cg", "fgmres"])
def test_weighted_krylov_matches_jax(solver):
    """The inner A-solve of the r2 case in miniature: a condensed SPD
    stencil operator in the duplicated patch layout, ownership-weighted,
    Jacobi-preconditioned."""
    js, ps, jg, pg = _pair("leaflet", 1)
    jst, pst = JaxStencil(jg, js, d=1), StencilOperator(pg, ps, d=1)
    rng = np.random.default_rng(5)
    nl = ps.cell_dofs.shape[1]
    B = rng.standard_normal((ps.mesh.n_cells, nl, nl))
    Ab = (np.einsum("cki,ckj->cij", B, B) + 3 * nl * np.eye(nl)
          ).reshape(-1, nl, 1, nl, 1)
    b = rng.standard_normal(ps.n_nodes)
    jW, pW = jst.build_weights(jnp.asarray(Ab)), \
        pst.build_weights(torch.as_tensor(Ab))
    jb, pb = jst.spread(jnp.asarray(b)), pst.spread(torch.as_tensor(b))
    jw, pw = jst.weight(jnp.float64), pst.weight(torch.float64)
    jd = 1.0 / jnp.maximum(jst.matvec(jW, jnp.ones_like(jb)), 1.0)
    pd = 1.0 / torch.clamp(pst.matvec(pW, torch.ones_like(pb)), min=1.0)
    kw = dict(atol=1e-12) if solver == "cg" else \
        dict(atol=1e-12, restart=20, max_restarts=8)
    ref = getattr(jkrylov, solver)(lambda v: jst.matvec(jW, v), jb,
                                   M=lambda r: r * jd, weight=jw, **kw)
    got = getattr(krylov, solver)(lambda v: pst.matvec(pW, v), pb,
                                  M=lambda r: r * pd, weight=pw, **kw)
    assert got.iters == int(ref.iters) and got.iters > 5
    assert rel_err(pst.unspread(got.x), jst.unspread(ref.x)) <= 1e-10


KNOBS = ("a_stencil", "dense_precond", "dense_a_bf16", "a_block_jacobi",
         "a_poly", "a_poly_omega", "mg_direct", "a_mg_cycles",
         "a_mg_precond", "mixed_precision_precond", "f32_matrix",
         "mp_sm_rtol", "a_inner_rtol", "a_inner_restart",
         "a_inner_restarts", "schur_cg_maxiter", "mp_cg_maxiter",
         "outer_restart", "outer_max_restarts", "newton_forcing",
         "f32_outer")


def test_insim_knob_defaults_match_jax():
    for k in KNOBS:
        assert getattr(PORT.InsIM, k) == getattr(JAX.InsIM, k), k


def _jax_a_branch(fl, ucons):
    """The JAX package's choice in InsIM._make_preconditioner
    (openifem_tpu/solvers/fluid/insim.py:569-611)."""
    if fl.dense_precond:
        return "dense"
    if fl._velocity_mg is not None:
        return "velocity_mg"
    if fl._u_stencil is not None:
        return "stencil_flat" if ucons.any_hanging else "stencil"
    return "element"


@pytest.mark.parametrize("config,h,knobs,branch", [
    ("element", 0.1, dict(a_stencil=True), "stencil_flat"),
    ("element", 0.1, dict(), "element"),
    ("fsi_leaflet_r2", 0.2, dict(mg_direct=False), "stencil"),
    ("fsi_leaflet", 0.1, dict(), "dense"),
], ids=["leaflet_default", "leaflet_element", "uniform", "dense"])
def test_preconditioner_branch_matches_jax(config, h, knobs, branch):
    """Same mesh and knobs -> the same inner A-solve branch in both
    packages; the port's preconditioner build records the branch it took.
    (The locally refined leaflet takes the stencil inside the constraint
    wrap by default; the element configuration turns the stencil off.)"""
    fl = {}
    for port in (False, True):
        fsi = leaflet_fsi(port, n_steps=1, h=h, config=config,
                          extra_refine=1, bench_precision=False)
        for k, v in knobs.items():
            setattr(fsi.fluid, k, v)
        fl[port] = setup_fsi(fsi).fluid
    jfl, pfl = fl[False], fl[True]
    assert (jfl._u_stencil is None) == (pfl._u_stencil is None)
    if pfl._u_stencil is not None:
        for a, b in zip(pfl._u_stencil.grid.groups,
                        jfl._u_stencil.grid.groups):
            np.testing.assert_array_equal(a, b)
    assert _jax_a_branch(jfl, jfl.u_constraints) == branch
    assert pfl.a_solve_branch(pfl.u_constraints) == branch
    A_loc, _ = pfl._assemble(
        pfl.present_solution, pfl.present_solution, pfl.indicator,
        pfl.fsi_acceleration, pfl.fsi_stress_cell, pfl.fsi_acc_nodal)
    pfl._make_preconditioner(A_loc, pfl.u_constraints, pfl.p_constraints)
    assert list(pfl.precond_branches) == [(branch, "cg")]
