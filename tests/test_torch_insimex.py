"""The port's InsIMEX (solvers/fluid/insimex.py) against the JAX package on
the Turek cylinder at refine 1 (368 cells, 3,612 dofs; cases/
fluid_cylinder.py), from the same seeded state.

Tolerances, relative to the reference's max norm:
- the constant matrix, the mass tables and the right-hand side (with a
  non-zero indicator, FSI stress and acceleration): 1e-12, the same sums in
  another order;
- one preconditioner apply: 1e-7, with the three inner CGs of both
  packages run to a 1e-10 relative residual instead of their 1e-6 (at 1e-6
  one apply is rounding-sensitive: a CG that stops one iteration earlier
  moves the output by about its tolerance) and their iteration caps
  raised tenfold, so that no cap is what stops a solve;
- 3 steps through run(): 1e-6 with equal outer FGMRES counts in every
  step (each system is solved to a 1e-8 relative residual);
- the kernel's index arithmetic (la/cuda_ops.emulate) on InsIMEX's own
  tables and strided block views: 1e-12 against the plain versions;
- InsIMEX against InsIM after 15 steps (t = 0.15): 2 % in the relative L2
  norm of the velocity, as tests/test_fluid.py holds the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openifem_tpu.solvers.fluid.insimex as jax_insimex
import openifem_tpu_torch.solvers.fluid.insimex as port_insimex
from openifem_tpu_torch import interop
from openifem_tpu_torch.cases import fluid_cylinder as fc
from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import operators as ops
from torch_parity import JAX, PORT, rel_err


def _imex(port, n_steps=3):
    kw = dict(device="cpu") if port else {}
    return fc.imex_case(PORT if port else JAX, 1, n_steps, **kw)


@pytest.fixture(scope="module")
def pair():
    """(JAX InsIMEX, port InsIMEX) with the same seeded mid-run state and
    FSI forcing fields."""
    jfl, pfl = _imex(False), _imex(True)
    rng = np.random.default_rng(21)
    n_c, d = jfl.mesh.n_cells, jfl.dim
    jfl.present_solution = jfl.nonzero_constraints.distribute(
        jnp.asarray(0.1 * rng.normal(size=jfl.n_dofs)))
    jfl.indicator = jnp.asarray((rng.random(n_c) < 0.2).astype(np.float64))
    jfl.update_stress()
    interop.load_fluid_state(pfl, interop.fluid_state(jfl))
    acc, stress = rng.normal(size=(n_c, d)), rng.normal(size=(n_c, d, d))
    return jfl, pfl, acc, stress


def test_constant_matrix_and_tables(pair):
    jfl, pfl, _, _ = pair
    assert pfl.n_dofs == jfl.n_dofs == 3612
    assert pfl.A_loc.shape == (368, 22, 22)
    for f in ("A_loc", "Auu", "Aup", "Apu", "Mp_loc", "Mu_diag", "Mp_diag",
              "gravity_q", "_neumann_rhs_const"):
        assert rel_err(getattr(pfl, f), getattr(jfl, f)) <= 1e-12, f
    for f in ("cell_dofs", "cell_dofs_u", "cell_dofs_p"):
        np.testing.assert_array_equal(getattr(pfl, f).numpy(),
                                      np.asarray(getattr(jfl, f)))
    # the blocks are views of the one table the outer operator reads
    for blk in (pfl.Auu, pfl.Aup, pfl.Apu):
        assert blk.untyped_storage().data_ptr() == \
            pfl.A_loc.untyped_storage().data_ptr()
    assert not bool(pfl.A_loc[:, 18:, 18:].any())


def test_assemble_rhs_with_fsi_forcing(pair):
    jfl, pfl, acc, stress = pair
    assert float(pfl.indicator.sum()) > 0
    ref = jax.jit(jfl._assemble_rhs)(jfl.present_solution, jfl.indicator,
                                     jnp.asarray(acc), jnp.asarray(stress))
    got = pfl._assemble_rhs(pfl.present_solution, pfl.indicator,
                            torch.from_numpy(acc), torch.from_numpy(stress))
    assert rel_err(got, ref) <= 1e-12
    # the forcing reaches the right-hand side
    bare = pfl._assemble_rhs(pfl.present_solution, pfl.indicator,
                             torch.zeros_like(torch.from_numpy(acc)),
                             torch.zeros_like(torch.from_numpy(stress)))
    assert rel_err(got, bare) > 1e-3


def _converged(cg):
    """cg with its tolerance tightened from 1e-6 to 1e-10 of the norm it
    is relative to, and its cap raised tenfold."""
    def solve(op, b, **kw):
        kw["atol"] = kw["atol"] * 1e-4
        kw["maxiter"] = 10 * kw["maxiter"]
        return cg(op, b, **kw)
    return solve


def test_one_preconditioner_apply(pair, monkeypatch):
    jfl, pfl, _, _ = pair
    monkeypatch.setattr(jax_insimex, "cg", _converged(jax_insimex.cg))
    monkeypatch.setattr(port_insimex, "cg", _converged(port_insimex.cg))
    v = np.random.default_rng(22).normal(size=pfl.n_dofs)
    ref = jax.jit(jfl._make_preconditioner())(jnp.asarray(v))
    k0 = dict(pfl.krylov_iters)
    got = pfl._make_preconditioner()(torch.from_numpy(v))
    its = {k: pfl.krylov_iters[k] - k0[k] for k in ("mp", "sm", "a")}
    assert rel_err(got, ref) <= 1e-7
    # converged below the raised caps
    assert 0 < its["mp"] < 10 * pfl.mp_cg_maxiter
    assert 0 < its["sm"] < 10 * pfl.schur_cg_maxiter
    assert 0 < its["a"] < 10 * pfl.a_cg_maxiter


def test_mixed_precision_preconditioner_runs_in_f32(pair, monkeypatch):
    _, pfl, _, _ = pair
    v = torch.from_numpy(np.random.default_rng(23).normal(size=pfl.n_dofs))
    want = pfl._make_preconditioner()(v)
    seen, rect = [], port_insimex.element_matvec_rect
    monkeypatch.setattr(pfl, "mixed_precision_precond", True)
    monkeypatch.setattr(port_insimex, "element_matvec_rect",
                        lambda A, *a: (seen.append(A.dtype), rect(A, *a))[1])
    got = pfl._make_preconditioner()(v)
    assert got.dtype == torch.float64 and set(seen) == {torch.float32}
    # an f32 preconditioner with inner solves to 1e-6: a few digits
    assert rel_err(got, want) <= 1e-2


def _record_outer(fl, name):
    """Outer FGMRES iterations of every step of fl.run(), read from the
    step function `name` of the solver."""
    log, step = [], getattr(fl, name)

    def wrapped(*args):
        out = step(*args)
        log.append(int(out[2]))
        return out
    setattr(fl, name, wrapped)
    return log


def test_three_steps_match_jax():
    jfl, pfl = _imex(False), _imex(True)
    jlog = _record_outer(jfl, "_step")
    plog = _record_outer(pfl, "_step_impl")
    jfl.run(verbose=False)
    pfl.run(verbose=False)
    assert plog == jlog and len(plog) == 3 and min(plog) > 0
    assert pfl.krylov_iters["outer"] == sum(plog)
    assert pfl.time.get_timestep() == jfl.time.get_timestep() == 3
    for f in ("present_solution", "solution_increment", "stress_device"):
        assert rel_err(getattr(pfl, f), getattr(jfl, f)) <= 1e-6, f
    # no inner CG of the run stopped at its cap
    k = pfl.krylov_iters
    assert k["mp"] < k["applies"] * pfl.mp_cg_maxiter
    assert k["sm"] < k["applies"] * pfl.schur_cg_maxiter
    assert k["a"] < k["applies"] * pfl.a_cg_maxiter


def test_run_one_step_ignores_assemble_system():
    a, b = _imex(True, 1), _imex(True, 1)
    a.run_one_step(True, True, verbose=False)
    b.run_one_step(True, False, verbose=False)
    assert torch.equal(a.present_solution, b.present_solution)


class _OnCard(torch.Tensor):
    """A CPU tensor that the layouts' dispatch takes for a CUDA one, so
    that their kernel branch (with cuda_ops.launch replaced by
    cuda_ops.emulate) runs here."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("block", ["B", "BT", "A", "system"])
def test_kernel_indexing_on_insimex_tables(pair, monkeypatch, block):
    """The applies of InsIMEX's preconditioner and outer operator through
    the layouts' CUDA branch: the rect layout with 4x18 and 18x4 blocks,
    the scalar layout with 18- and 22-wide blocks, all read in place from
    the (368, 22, 22) table through its strides."""
    _, pfl, _, _ = pair
    x = torch.from_numpy(np.random.default_rng(24).normal(size=pfl.n_dofs))
    xu, xp = x[:pfl.n_u].contiguous(), x[pfl.n_u:].contiguous()
    cd, cd_u, cd_p = pfl.cell_dofs, pfl.cell_dofs_u, pfl.cell_dofs_p
    entry, plain, args = {
        "B": (ops.element_matvec_rect, ops.element_matvec_rect_plain,
              (pfl.Apu, cd_p, cd_u, pfl.n_p, xu)),
        "BT": (ops.element_matvec_rect, ops.element_matvec_rect_plain,
               (pfl.Aup, cd_u, cd_p, pfl.n_u, xp)),
        "A": (ops.element_matvec, ops.element_matvec_plain,
              (pfl.Auu, cd_u, pfl.n_u, xu)),
        "system": (ops.element_matvec, ops.element_matvec_plain,
                   (pfl.A_loc, cd, pfl.n_dofs, x)),
    }[block]
    assert not args[0].is_contiguous() or block == "system"
    want = plain(*args)
    calls = []

    def emulate(layout, *a, **kw):
        calls.append(layout)
        return cuda_ops.emulate(layout, *a, **kw)
    monkeypatch.setattr(cuda_ops, "launch", emulate)
    got = entry(*args[:-1], args[-1].as_subclass(_OnCard))
    assert calls == ["element_matvec_rect" if block in ("B", "BT")
                     else "element_matvec"]
    assert rel_err(got.as_subclass(torch.Tensor), want) <= 1e-12


def test_insimex_agrees_with_insim_to_first_order_in_time():
    """15 steps to t = 0.15 (tests/test_fluid.py holds the JAX package's
    two solvers to the same 2 %)."""
    imex = _imex(True, 15)
    imex.run(verbose=False)
    insim = fc.cylinder_case(PORT, "r1", refine=1, n_steps=15,
                             bench_precision=False, device="cpu")
    insim.run_on_device(verbose=False)
    u1, u2 = insim.velocity_part(), imex.velocity_part()
    assert np.isfinite(u2).all()
    assert np.linalg.norm(u1 - u2) / np.linalg.norm(u1) < 0.02
