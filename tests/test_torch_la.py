"""The port's Constraints and Krylov solvers against openifem_tpu.la.

Constraints are compared on the coarse leaflet's fluid system (hanging
nodes + Dirichlet rows) to 1e-14.  cg and fgmres solve the same condensed
element operator in both packages with the same stopping tests: the
iteration counts must be equal and the solutions agree to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.la import constraints as jcons
from openifem_tpu.la import krylov as jkrylov
from openifem_tpu.la import operators as jops
from openifem_tpu.fe.space import FESpace as JaxFESpace
from openifem_tpu.fe.space import SystemSpace as JaxSystemSpace
from openifem_tpu.mesh import generators as jax_generators
from openifem_tpu_torch.cases.fsi_leaflet import leaflet_meshes
from openifem_tpu_torch.la import constraints as cons
from openifem_tpu_torch.la import krylov
from openifem_tpu_torch.la import operators as ops
from torch_parity import rel_err


@pytest.fixture(scope="module")
def system():
    """Hanging-node tables of the coarse leaflet's Q2^2 x Q1 system, a
    Dirichlet set and values, and SPD / nonsymmetric element blocks."""
    fm, _ = leaflet_meshes(jax_generators, 0.1)
    u_space, p_space = JaxFESpace(fm, 2), JaxFESpace(fm, 1)
    sys = JaxSystemSpace([(u_space, 2), (p_space, 1)])
    hidx, hw, hmask = sys.hanging_tables()
    n = sys.n_dofs
    rng = np.random.default_rng(7)
    dmask = np.zeros(n, dtype=bool)
    for bid in (0, 2, 3):
        nodes = u_space.boundary_node_map()[bid]
        dmask[nodes * 2] = dmask[nodes * 2 + 1] = True
    nl = sys.cell_dofs.shape[1]
    B = rng.normal(size=(fm.n_cells, nl, nl)) / nl
    return dict(
        n=n, hidx=hidx, hw=hw, hmask=hmask, dmask=dmask,
        dvals=rng.normal(size=n), cd=sys.cell_dofs.astype(np.int32),
        A_spd=np.einsum("cik,cjk->cij", B, B) + 0.05 * np.eye(nl),
        A_ns=B + np.eye(nl) * 0.5, x=rng.normal(size=n),
        extra=rng.random(n) < 0.05, extra_vals=rng.normal(size=n))


def _pair(s):
    args = (s["n"], s["hidx"], s["hw"], s["hmask"])
    kw = dict(dirichlet_mask=s["dmask"], dirichlet_values=s["dvals"])
    return jcons.Constraints(*args, **kw), cons.Constraints(*args, **kw)


@pytest.mark.parametrize("method", ["distribute", "set_zero",
                                    "apply_increment", "expand", "restrict",
                                    "condense_rhs"])
def test_constraints_maps(system, method):
    jc, pc = _pair(system)
    assert pc.any_hanging and jc.any_hanging
    x = system["x"]
    want = getattr(jc, method)(jnp.asarray(x))
    got = getattr(pc, method)(torch.from_numpy(x))
    assert rel_err(got, want) <= 1e-14


def test_constraints_wrap_operator_and_extra_dirichlet(system):
    jc, pc = _pair(system)
    extra, vals = system["extra"], system["extra_vals"]
    jc = jc.with_extra_dirichlet(jnp.asarray(extra), jnp.asarray(vals))
    pc = pc.with_extra_dirichlet(torch.from_numpy(extra),
                                 torch.from_numpy(vals))
    for f in ("dirichlet", "fixed", "dirichlet_values"):
        assert rel_err(getattr(pc, f).to(torch.float64),
                       np.asarray(getattr(jc, f), dtype=np.float64)) == 0
    A, cd, n, x = system["A_ns"], system["cd"], system["n"], system["x"]
    jop = jc.wrap_operator(lambda v: jops.element_matvec(
        jnp.asarray(A), jnp.asarray(cd), n, v))
    pop = pc.wrap_operator(lambda v: ops.element_matvec(
        torch.from_numpy(A), torch.from_numpy(cd), n, v))
    assert rel_err(pop(torch.from_numpy(x)), jop(jnp.asarray(x))) <= 1e-14


def _solve_pair(system, solver, A_key, **kw):
    jc, pc = _pair(system)
    A, cd, n = system[A_key], system["cd"], system["n"]
    jop = jc.wrap_operator(lambda v: jops.element_matvec(
        jnp.asarray(A), jnp.asarray(cd), n, v))
    pop = pc.wrap_operator(lambda v: ops.element_matvec(
        torch.from_numpy(A), torch.from_numpy(cd), n, v))
    jb = jc.condense_rhs(jnp.asarray(system["x"]))
    pb = pc.condense_rhs(torch.from_numpy(system["x"]))
    jdiag = jnp.where(jc.fixed, 1.0, jops.element_diag(jnp.asarray(A),
                                                       jnp.asarray(cd), n))
    pdiag = torch.where(pc.fixed, 1.0, ops.element_diag(
        torch.from_numpy(A), torch.from_numpy(cd), n))
    atol = 1e-8 * float(jnp.linalg.norm(jb))
    ref = getattr(jkrylov, solver)(jop, jb, M=lambda r: r / jdiag,
                                   atol=atol, **kw)
    got = getattr(krylov, solver)(pop, pb, M=lambda r: r / pdiag,
                                  atol=atol, **kw)
    return got, ref


def test_cg_matches_jax(system):
    got, ref = _solve_pair(system, "cg", "A_spd", maxiter=2000)
    assert got.iters == int(ref.iters) > 10
    assert rel_err(got.x, ref.x) <= 1e-10


@pytest.mark.parametrize("restart", [8, 50], ids=["restarted", "one_cycle"])
def test_fgmres_matches_jax(system, restart):
    got, ref = _solve_pair(system, "fgmres", "A_ns", restart=restart,
                           max_restarts=40)
    assert got.iters == int(ref.iters) > 5
    assert rel_err(got.x, ref.x) <= 1e-10
    assert got.residual <= 1e-8 * float(np.linalg.norm(system["x"]))


def test_fgmres_zero_rhs_takes_no_iteration():
    op = lambda v: 2.0 * v  # noqa: E731
    res = krylov.fgmres(op, torch.zeros(5, dtype=torch.float64), atol=1e-10)
    assert res.iters == 0 and float(res.x.abs().max()) == 0.0
