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


# -- iteration blocks (la/krylov.py _cg_blocks, _blocks): uncaptured
# on the CPU, the blocks take the eager loops' decisions and give their
# counts, x and residual to the bit.

class _PastConvergence(krylov.BlockGraphs):
    """Runs every CG block whose test has failed once more and requires
    that the second run changes no buffer."""
    checked = 0

    def run(self, name, fn, device):
        fn()
        if name == "next" and not bool(self._buf["status"][0]):
            before = {k: v.clone() for k, v in self._buf.items()}
            fn()
            for k, v in self._buf.items():
                assert torch.equal(before[k], v), k
            _PastConvergence.checked += 1


def _spd(n=80):
    g = torch.Generator().manual_seed(4)
    Q = torch.randn(n, n, generator=g, dtype=torch.float64)
    A = Q @ Q.T / n + torch.diag(torch.logspace(-2, 1, n,
                                                dtype=torch.float64))
    return A, torch.randn(n, generator=g, dtype=torch.float64)


def _nonsymmetric(n=120):
    """1-D convection-diffusion, upwinded: FGMRES needs restarts."""
    A = (torch.diag(torch.full((n,), 2.6, dtype=torch.float64))
         - torch.diag(torch.full((n - 1,), 1.5, dtype=torch.float64), -1)
         - torch.diag(torch.full((n - 1,), 1.0, dtype=torch.float64), 1))
    g = torch.Generator().manual_seed(5)
    return A, torch.randn(n, generator=g, dtype=torch.float64)


def _cg_case(case):
    A, b = _spd()
    M = lambda r: r / torch.diagonal(A)  # noqa: E731
    op = lambda x: A @ x  # noqa: E731
    kw = dict(atol=1e-8 * float(torch.linalg.vector_norm(b)), maxiter=500)
    if case == "cg_maxiter":
        kw["maxiter"] = krylov.CG_BLOCK + 1
    elif case == "cg_converged":
        kw["atol"] = 2.0 * float(torch.linalg.vector_norm(b))
    eager = krylov.cg(op, b, M=M, **kw)
    graphs = (_PastConvergence if case == "cg_past_convergence"
              else krylov.BlockGraphs)()
    blocks = krylov._cg_blocks(
        op, b, None, M, torch.as_tensor(kw["atol"], dtype=b.dtype),
        kw["maxiter"], None, graphs)
    return eager, blocks, kw


def _fgmres_case(case):
    from openifem_tpu_torch.utils import timer
    A, b = _nonsymmetric()
    M = lambda r: r / torch.diagonal(A)  # noqa: E731
    op = lambda x: A @ x  # noqa: E731
    restart = krylov.FGMRES_BLOCK + 3       # a shorter last block
    kw = dict(atol=1e-9, restart=restart, max_restarts=8)
    if case == "fgmres_restart_boundary":
        # the estimate after exactly one cycle as atol: convergence at the
        # cycle's last step
        kw["atol"] = krylov.fgmres(op, b, M=M, atol=0.0, restart=restart,
                                   max_restarts=1).residual
    elif case == "fgmres_max_restarts":
        kw["atol"] = 0.0
    elif case == "fgmres_converged":
        b = torch.zeros_like(b)
    elif case == "fgmres_weighted":
        kw["weight"] = (torch.arange(b.numel()) % 5 != 0).double()
    eager = krylov.fgmres(op, b, M=M, **kw)
    # a site's first solve is eager, the later ones take the blocks
    graphs = krylov.BlockGraphs()
    krylov.fgmres(op, b, M=M, graphs=graphs, **kw)
    with timer.recording() as rec:
        blocks = krylov.fgmres(op, b, M=M, graphs=graphs, **kw)
    assert rec.counts["krylov.eager_iters"] == 0
    assert rec.counts["krylov.graph_iters"] == blocks.iters
    return eager, blocks, kw


def _cylinder_case(config, monkeypatch):
    """Preconditioner applies of the cylinder at refine 1 (the stencil
    A-solve, the Mp CG and, in "r3", the Schur CG with its V-cycle) for
    two Newton matrices, the blocks (InsIM._inner_graphs, uncaptured)
    against the eager loops, apply for apply."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.cases.fsi_leaflet import port_package
    from openifem_tpu_torch.solvers.fluid import insim
    from openifem_tpu_torch.utils import timer
    fl = fc.cylinder_case(port_package(), config, refine=1, n_steps=10,
                          device="cpu")
    fl.run_one_step(True, verbose=False)
    x = fl.present_solution
    g = torch.Generator().manual_seed(6)
    states = [x, x + 1e-3 * torch.randn(x.shape, generator=g,
                                        dtype=x.dtype)]
    vs = [torch.randn(x.shape, generator=g, dtype=x.dtype)
          for _ in range(3)]

    def applies(on):
        monkeypatch.setattr(insim, "_on_card", lambda device: on)
        out = []
        for s in states:
            A_loc, _ = fl._assemble(s, s, fl.indicator, fl.fsi_acceleration,
                                    fl.fsi_stress_cell, fl.fsi_acc_nodal)
            P = fl._make_preconditioner(A_loc, fl.u_constraints,
                                        fl.p_constraints)
            for v in vs:
                k0 = dict(fl.krylov_iters)
                y = P(v)
                out.append((y, tuple(fl.krylov_iters[k] - k0[k]
                                     for k in ("mp", "sm", "a"))))
        return out

    eager = applies(False)
    with timer.recording() as rec:
        blocks = applies(True)
    assert rec.counts["krylov.graph_iters"] > 0
    return eager, blocks


KRYLOV_BLOCK_CASES = ["cg_mid_block", "cg_maxiter", "cg_converged",
                      "cg_past_convergence", "fgmres_mid_block",
                      "fgmres_restart_boundary", "fgmres_max_restarts",
                      "fgmres_converged", "fgmres_weighted",
                      "cylinder_r3", "cylinder_r4"]


@pytest.mark.parametrize("case", KRYLOV_BLOCK_CASES)
def test_krylov_blocks_match_eager(case, monkeypatch):
    if case.startswith("cylinder"):
        eager, blocks = _cylinder_case(case.split("_")[1], monkeypatch)
        for (ye, ke), (yb, kb) in zip(eager, blocks):
            assert ke == kb and ke[2] > 0
            assert torch.equal(ye, yb)
        return
    solve = _cg_case if case.startswith("cg") else _fgmres_case
    checked = _PastConvergence.checked
    eager, blocks, kw = solve(case)
    assert eager.iters == blocks.iters
    assert torch.equal(eager.x, blocks.x)
    assert eager.residual == blocks.residual
    block = krylov.CG_BLOCK if case.startswith("cg") else \
        krylov.FGMRES_BLOCK
    if case in ("cg_mid_block", "cg_past_convergence",
                "fgmres_mid_block", "fgmres_weighted"):
        # converged inside a block, not at its end, after several
        assert eager.iters > block and eager.iters % block
    elif case == "cg_maxiter":
        assert eager.iters == kw["maxiter"]
    elif case in ("cg_converged", "fgmres_converged"):
        assert eager.iters == 0
    elif case == "fgmres_restart_boundary":
        assert eager.iters == kw["restart"]
    elif case == "fgmres_max_restarts":
        assert eager.iters == kw["restart"] * kw["max_restarts"]
    if case == "cg_past_convergence":
        assert _PastConvergence.checked == checked + 1
