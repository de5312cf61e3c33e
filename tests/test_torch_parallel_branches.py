"""shard_fluid_solver on every preconditioner branch, against the JAX
package's shard_fluid_solver and the unsharded runs of both packages.

Each case of entry.BRANCH_CASES (one per value of InsIM's a_solve_branch
and sm_solve_branch and of the SUPG family's outer_branch, tpp_branch and
tpp_M_branch) takes one Newton iteration through the solver's own
_newton_iter_impl with the solver sharded by shard_fluid_solver.  The
port side runs once for the module: four gloo ranks on the CPU
(spawn_ranks) run every case in one spawn.  The JAX side runs in this
process, sharded on four of the eight virtual CPU devices
(tests/conftest.py) and unsharded, while the ranks work.  The case
supg_rect has no velocity node table, which the outer Taylor-Hood apply
needs in both packages: it applies the preconditioner alone to a seeded
vector, built from the Newton matrix of the first iteration.

Tolerances, against the port unsharded, the JAX sharded and the JAX
unsharded run:
- du (supg_rect: the apply) within 1e-10 absolute of the scale
  max(1, max |du|); res_norm equal to 1e-10 of max(1, res_norm); the
  outer FGMRES count (supg_rect: the Tpp GMRES count) within 1, and
  against the port unsharded each inner Krylov total within 1;
- except where a case rounds through single precision, which moves the
  solve by more than the rounding of the sharded sums: the bf16 A block
  (dense_bf16: its GEMV rounds the inner vectors to bf16, so the outer
  solve ends anywhere within its tolerance of 1e-8 of ||b||) within 1e-7
  of the scale against all three; the Galerkin V-cycle on B2pp
  (supg_stencil, supg_galerkin: both packages invert its coarse matrix
  by Newton-Schulz in float32, tests/test_torch_multigrid.py) within
  1e-8 of the scale against the JAX runs.  Measured on the CPU: 6.1e-9
  and 1.4e-8 (dense_bf16 against the port and the JAX runs), 1.8e-9
  (the Galerkin cases against JAX), at most 6.1e-14 elsewhere.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openifem_tpu.parallel.shard as jshard
from openifem_tpu_torch import entry
from openifem_tpu_torch.parallel import spawn_ranks
from torch_parity import JAX

N_RANKS = 4
NAMES = tuple(entry.BRANCH_CASES)
CASES = tuple((name, "branch_newton", dict(name=name)) for name in NAMES)
# cases that round through bf16 (the dense A block) or float32 (the
# Galerkin V-cycle's coarse inverse): their tolerances (module docstring)
BF16 = ("dense_bf16",)
F32_COARSE = ("supg_stencil", "supg_galerkin")


def _jax_run(name, sharded, dmesh):
    """One Newton iteration (supg_rect: one preconditioner apply) of the
    JAX package's solver of the case: (du, res_norm, count)."""
    s = entry.branch_solver(name, pkg=JAX)
    if entry.BRANCH_CASES[name][0] == "scnsim":
        args = (s.nonzero_constraints.apply_increment(s.present_solution),
                s.present_solution, s.indicator, s.fsi_acc_nodal,
                s.fsi_stress_nodal, s.stress_device,
                jnp.zeros(s.u_space.n_nodes))
    else:
        args = entry.newton_args(s)
    if sharded:
        jshard.shard_fluid_solver(s, dmesh)
    if name == "supg_rect":
        A_loc, rhs = s._assemble(*args)
        P = s._make_preconditioner(A_loc, s.u_constraints, s.p_constraints)
        out, its = jax.jit(P.stats)(jnp.asarray(entry.rect_vector(s)))
        rn = jnp.linalg.norm(s.zero_constraints.condense_rhs(rhs))
        return np.asarray(out), float(rn), int(its)
    du, rn, its, _ = jax.jit(s._newton_iter_impl)(
        *args, s.zero_constraints, s.u_constraints, s.p_constraints)
    return np.asarray(du), float(rn), int(its)


def _jax_side():
    dmesh = jshard.make_cell_mesh(N_RANKS)
    out = {}
    for name in NAMES:
        for sharded in (False, True):
            try:
                out[name, sharded] = _jax_run(name, sharded, dmesh)
            except Exception as e:   # a fault of the reference: recorded
                out[name, sharded] = e
    return out


@pytest.fixture(scope="module")
def runs():
    """(port rank 0's results, JAX results): the ranks run in a thread
    while this process computes the JAX side."""
    box = {}

    def ranks():
        try:
            box["port"] = spawn_ranks(entry.rank_run, N_RANKS, "cpu", CASES,
                                      timeout=600)[0]
        except BaseException as e:   # re-raised in the test process
            box["error"] = e
    t = threading.Thread(target=ranks)
    t.start()
    try:
        jax_out = _jax_side()
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    return box["port"], jax_out


def _scale_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("name", NAMES)
def test_shard_fluid_solver_branch(runs, name):
    port, jax_out = runs
    got = port[name]
    ref = entry.numpy_tree(entry.branch_newton(None, torch.device("cpu"),
                                               name))
    want = entry.BRANCH_CASES[name][3]
    # the branch was taken, sharded and unsharded, and only it
    assert got["branches"] == [want] and ref["branches"] == [want]
    tol = 1e-7 if name in BF16 else 1e-10
    jax_tol = 1e-8 if name in F32_COARSE else tol
    assert _scale_err(got["du"], ref["du"]) < tol
    rn_scale = max(1.0, ref["res_norm"])
    assert abs(got["res_norm"] - ref["res_norm"]) < 1e-10 * rn_scale
    assert abs(int(got["iters"]) - int(ref["iters"])) <= 1
    for key, n in ref["krylov"].items():
        assert abs(got["krylov"][key] - n) <= 1, key
    # the JAX package's shard_fluid_solver and its unsharded run
    for sharded in (True, False):
        jout = jax_out[name, sharded]
        assert not isinstance(jout, Exception), \
            f"JAX {'sharded' if sharded else 'unsharded'} {name}: {jout!r}"
        jdu, jrn, jits = jout
        assert _scale_err(got["du"], jdu) < jax_tol
        assert abs(got["res_norm"] - jrn) < 1e-10 * rn_scale
        assert abs(int(got["iters"]) - jits) <= 1


def test_every_branch_value_is_reached():
    """The cases cover every value of the solvers' branch functions."""
    keys = [case[3] for case in entry.BRANCH_CASES.values()]
    insim = [k for k in keys if len(k) == 2]
    supg = [k for k in keys if len(k) == 3]
    assert {a for a, _ in insim} == {"dense", "velocity_mg", "stencil",
                                     "stencil_flat", "element"}
    assert {m for _, m in insim} == {"cg", "cg+vcycle", "vcycle"}
    assert {o for o, _, _ in supg} == {"stencil", "element"}
    assert {t for _, t, _ in supg} == {"stencil", "dense", "nodeblock",
                                       "rect"}
    assert {m for _, _, m in supg} == {"galerkin", "vcycle", "diag"}
