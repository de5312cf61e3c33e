"""The port's V-cycles (la/multigrid.py) against the JAX package: one
V-cycle of each class on the same hierarchy and seeded right-hand side.

Hierarchies: the r2 case's uniform channel at base size h = 0.2 refined
twice (nested by refine_global: topological prolongation tables), and the
channel base mesh under the locally refined leaflet mesh (geometric
tables).  Tolerances, relative to the reference's max norm:
- 1e-10 in f64 for GeometricMG (pressure and velocity) and for GalerkinMG
  (scalar and node-block) with the Chebyshev coarse solve;
- 1e-5 for GalerkinMG with its dense coarse solve, and for that coarse
  inverse itself: both packages compute it by Newton-Schulz in float32 by
  design (multigrid.py:742-758), and float32 matrix products summed in
  another order agree to about cond * 6e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.fe.fevalues import cell_values as jcell_values
from openifem_tpu.fe.space import FESpace as JaxSpace
from openifem_tpu.la import multigrid as jmg
from openifem_tpu.mesh import generators as jgen
from openifem_tpu_torch.cases.fsi_leaflet import (leaflet_meshes,
                                                  uniform_hierarchy)
from openifem_tpu_torch.fe.space import FESpace
from openifem_tpu_torch.la import multigrid as pmg
from openifem_tpu_torch.mesh import generators as pgen
from torch_parity import rel_err

def _hierarchy(kind, g):
    if kind == "nested":
        return uniform_hierarchy(g, 0.2, 2)
    base = uniform_hierarchy(g, 0.2, 0)
    return base + [leaflet_meshes(g, 0.2)[0]]


def _boundary_mask(space, d=1):
    fx = np.zeros(space.n_nodes * d, dtype=bool)
    bn = np.asarray(space.boundary_nodes([0, 2, 3]))
    fx[(bn[:, None] * d + np.arange(d)).reshape(-1)] = True
    return fx


def _rhs(n, seed=4):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("kind,fixed_prefix", [("nested", True),
                                               ("nested", False),
                                               ("local", False)])
def test_geometric_pressure_vcycle(kind, fixed_prefix):
    jm, pm = _hierarchy(kind, jgen), _hierarchy(kind, pgen)
    fixed = _boundary_mask(FESpace(pm[-1], 1))
    jv = jmg.make_pressure_mg(jm, fixed, 2, jnp.float64,
                              fixed_prefix=fixed_prefix)
    pv = pmg.make_pressure_mg(pm, fixed, 2, torch.float64,
                              fixed_prefix=fixed_prefix)
    for a, b in zip(pv.levels, jv.levels):
        assert abs(a.lam_max - b.lam_max) <= 1e-12 * b.lam_max
    b = _rhs(len(fixed))
    assert rel_err(pv.vcycle(torch.as_tensor(b)),
                   jv.vcycle(jnp.asarray(b))) <= 1e-10


def test_geometric_velocity_vcycle():
    jm, pm = _hierarchy("nested", jgen), _hierarchy("nested", pgen)
    fixed = _boundary_mask(FESpace(pm[-1], 2), 2)
    args = (2, 2, 1.0, 1e-2, 1.0, 5e-3, fixed, 2)
    jv = jmg.make_velocity_mg(jm, *args, jnp.float64)
    pv = pmg.make_velocity_mg(pm, *args, torch.float64)
    b = _rhs(len(fixed))
    assert rel_err(pv.vcycle(torch.as_tensor(b)),
                   jv.vcycle(jnp.asarray(b))) <= 1e-10


def _galerkin_pair(degree, ncomp, rep):
    """(JAX GalerkinMG, port GalerkinMG, fine blocks) on the nested
    hierarchy: a shifted Laplacian (scalar) or a grad-div-stiffened
    vector operator (node-block), fixed rows/cols projected out."""
    jm, pm = _hierarchy("nested", jgen), _hierarchy("nested", pgen)
    jsp = [JaxSpace(m, degree) for m in jm]
    psp = [FESpace(m, degree) for m in pm]
    cv = jcell_values(jsp[-1], degree + 1)
    K = np.einsum("cqlx,cqmx,cq->clm", cv.grad, cv.grad, cv.JxW)
    M = np.einsum("ql,qm,cq->clm", cv.N, cv.N, cv.JxW)
    nl = K.shape[1]
    if ncomp == 1:
        A = K + 50.0 * M
    else:
        A = np.einsum("clm,ab->clamb", K + 50.0 * M, np.eye(2))
        A = A + np.einsum("cqla,cqmb,cq->clamb", cv.grad, cv.grad, cv.JxW)
        A = A.reshape(-1, nl * 2, nl * 2)
    fixed = _boundary_mask(psp[-1], ncomp)
    cd = pmg._expand_dofs(psp[-1].cell_dofs, ncomp)
    colfix = fixed[cd]
    A = np.where(colfix[:, None, :] | colfix[:, :, None], 0.0, A)
    rep_blocks = A if rep else None
    jg = jmg.GalerkinMG(jsp, jsp[-1].cell_dofs, rep_blocks, fixed,
                        dtype=jnp.float64, ncomp=ncomp)
    pg = pmg.GalerkinMG(psp, psp[-1].cell_dofs, rep_blocks, fixed,
                        dtype=torch.float64, ncomp=ncomp)
    return jg, pg, A


@pytest.mark.parametrize("degree,ncomp,rep", [(1, 1, False), (2, 2, False),
                                              (2, 2, True)],
                         ids=["scalar", "nodeblock", "nodeblock_frozen"])
def test_galerkin_vcycle_chebyshev_coarse(degree, ncomp, rep):
    jg, pg, A = _galerkin_pair(degree, ncomp, rep)
    if rep:
        np.testing.assert_allclose(pg.lam, jg.lam, rtol=1e-12)
    jg.dense_coarse_max = pg.dense_coarse_max = 0
    b = _rhs(pg.n_nodes[-1] * ncomp)
    got = pg.build(torch.as_tensor(A))(torch.as_tensor(b))
    ref = jg.build(jnp.asarray(A))(jnp.asarray(b))
    assert rel_err(got, ref) <= 1e-10


def test_galerkin_vcycle_newton_schulz_coarse():
    jg, pg, A = _galerkin_pair(1, 1, False)
    assert pg.n0 <= pg.dense_coarse_max
    b = _rhs(pg.n_nodes[-1])
    got = pg.build(torch.as_tensor(A))(torch.as_tensor(b))
    ref = jg.build(jnp.asarray(A))(jnp.asarray(b))
    assert rel_err(got, ref) <= 1e-5


def test_newton_schulz_coarse_inverse():
    """The port's coarse inverse against the JAX package's statement of it
    (multigrid.py:751-758), on a seeded SPD matrix."""
    rng = np.random.default_rng(2)
    n = 60
    B = rng.standard_normal((n, n))
    A0 = B @ B.T + n * np.eye(n)
    A32 = jnp.asarray(A0, dtype=jnp.float32)
    norm1 = jnp.max(jnp.sum(jnp.abs(A32), axis=0))
    norminf = jnp.max(jnp.sum(jnp.abs(A32), axis=1))
    X = A32.T / (norm1 * norminf)
    I0 = jnp.eye(n, dtype=jnp.float32)
    for _ in range(30):
        X = X @ (2.0 * I0 - A32 @ X)
    got = pmg.GalerkinMG.coarse_inverse(torch.as_tensor(A0))
    assert got.dtype == torch.float64
    assert rel_err(got, np.asarray(X, dtype=np.float64)) <= 1e-5
    assert rel_err(got @ torch.as_tensor(A0), np.eye(n)) <= 1e-5
