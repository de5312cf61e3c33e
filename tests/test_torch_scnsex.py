"""The explicit slightly-compressible solver of the port
(solvers/fluid/scnsex.py) against the JAX package, on the acoustic duct of
cases/acoustic_duct.py at [8, 2] refined once (64 cells, 255 dofs),
float64 on the CPU.

Tolerances, relative to the reference's max norm:
- the cached element matrices Av_loc, Ap_loc and the Jacobi diagonals:
  1e-12;
- one _iterate from a seeded state, also with a PML field, a body force
  and a Neumann pressure: 1e-10 with equal velocity and pressure CG
  counts (each CG stops at 1e-6 of its right-hand side; the two packages
  run the same iteration, so the iterates agree far below that);
- the kernel's index arithmetic (cuda_ops.emulate behind element_matvec's
  CUDA branch) at the solver's 8 x 8 and 4 x 4 blocks: 1e-12 against the
  plain version;
- a 6-step run() whose inlet BC expires mid-window: 1e-8, equal sweep
  counts, the same BC clock and expired set;
- run_on_device against the port's own run(): 1e-10 of the solution's
  scale (as the JAX package's own test asks of it), and against the JAX
  package's run_on_device: 1e-8;
- a state carried over from the JAX package mid-run (interop), continued
  in both: 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu_torch import interop
from openifem_tpu_torch.cases import acoustic_duct as ad
from torch_parity import JAX, PORT, np_, rel_err

DT = ad.TIME_STEP
# the inlet BC dies after the third step of a 6-step window
EXPIRY = 2.5 * DT


def _duct(port, n_steps=6, expiry=EXPIRY, setup=True, **extra):
    fl = ad.duct_case(PORT if port else JAX, "SCnsEX", refine=1,
                      n_steps=n_steps, **(dict(device="cpu") if port
                                          else {}))
    fl.set_hard_coded_boundary_condition_time(0, expiry)
    for name, fn in extra.items():
        getattr(fl, name)(fn)
    if setup:
        # what run() does before its first step
        fl.bc_time += DT
        fl.mesh = fl.mesh.refine_global(fl.params.global_refinements[0])
        fl.setup()
    return fl


def _sweeps(fl, log):
    """Record the number of sweeps of every step of fl.run()."""
    setup, step = fl.setup, fl.run_one_step

    def setup_then_count():
        setup()                     # (re)binds the sweep
        iterate = fl._iterate

        def counted(*a):
            log[-1] += 1
            return iterate(*a)
        fl._iterate = counted

    def run_one_step(*a, **k):
        log.append(0)
        return step(*a, **k)
    fl.setup, fl.run_one_step = setup_then_count, run_one_step


def test_cached_matrices():
    jfl, pfl = _duct(False), _duct(True)
    assert pfl.n_dofs == jfl.n_dofs == 255
    assert tuple(pfl.Av_loc.shape) == (64, 8, 8)
    assert tuple(pfl.Ap_loc.shape) == (64, 4, 4)
    for name in ("Av_loc", "Ap_loc", "_dinv_v", "_dinv_p",
                 "_neumann_rhs_u"):
        assert rel_err(getattr(pfl, name), getattr(jfl, name)) <= 1e-12, name
    for name in ("cell_dofs_u", "cell_dofs_p"):
        np.testing.assert_array_equal(np_(getattr(pfl, name)),
                                      np.asarray(getattr(jfl, name)))
    assert pfl.cg_maxiter == jfl.cg_maxiter == 2000


class _OnCard(torch.Tensor):
    """A CPU tensor that the layouts' dispatch takes for a CUDA one, so
    that their kernel branch (with cuda_ops.launch replaced by
    cuda_ops.emulate) runs here."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("block", ["Av", "Ap"])
def test_kernel_indexing_on_scnsex_tables(monkeypatch, block):
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.la import operators as ops
    pfl = _duct(True)
    A, cd, n = ((pfl.Av_loc, pfl.cell_dofs_u, pfl.n_u) if block == "Av"
                else (pfl.Ap_loc, pfl.cell_dofs_p, pfl.n_p))
    x = torch.from_numpy(np.random.default_rng(33).normal(size=n))
    want = ops.element_matvec_plain(A, cd, n, x)
    seen = []

    def emulate(layout, A_, cs, rs, rows, cols, n_out, x_, nr, nc, *dd):
        seen.append((layout, nr, nc))
        return cuda_ops.emulate(layout, A_, cs, rs, rows, cols, n_out, x_,
                                nr, nc, *dd)
    monkeypatch.setattr(cuda_ops, "launch", emulate)
    got = ops.element_matvec(A, cd, n, x.as_subclass(_OnCard))
    width = 8 if block == "Av" else 4
    assert seen == [("element_matvec", width, width)]
    assert rel_err(got.as_subclass(torch.Tensor), want) <= 1e-12


def _body_force(points):
    out = np.zeros_like(points)
    out[:, 0] = 1e6 * np.cos(points[:, 1])
    return out


def _sigma(points):
    return np.where(points[:, 0] > 3.0, 2e5 * (points[:, 0] - 3.0) ** 2, 0.0)


@pytest.mark.parametrize("forces", [False, True])
def test_one_sweep_matches_jax(forces):
    extra = dict(set_body_force=_body_force,
                 set_sigma_pml_field=_sigma) if forces else {}
    jfl, pfl = _duct(False, **extra), _duct(True, **extra)
    if forces:
        assert float(pfl.sigma_pml_q.abs().max()) > 0
        assert rel_err(pfl.gravity_q, jfl.gravity_q) == 0
    rng = np.random.default_rng(31)
    present = rng.normal(size=pfl.n_dofs)
    present[pfl.n_u:] *= 1e3                     # pressure in its units
    eval_pt = present + 0.1 * rng.normal(size=pfl.n_dofs)
    bc = rng.normal(size=pfl.n_u)
    jnew, jv, jp = jfl._iterate(*map(jnp.asarray, (eval_pt, present, bc)))
    pnew, pv, pp = pfl._iterate(*map(torch.as_tensor,
                                     (eval_pt, present, bc)))
    assert (pv, pp) == (int(jv), int(jp)) and pv > 1 and pp > 1
    assert rel_err(pnew[:pfl.n_u], jnew[:pfl.n_u]) <= 1e-10
    assert rel_err(pnew[pfl.n_u:], jnew[pfl.n_u:]) <= 1e-10
    # the Dirichlet lift: the BC values stand in the new velocity
    mask = pfl.u_constraints.dirichlet
    np.testing.assert_array_equal(np_(pnew[:pfl.n_u][mask]), bc[np_(mask)])
    assert pfl.krylov_iters == dict(vel=pv, pre=pp, sweeps=1)


@pytest.fixture(scope="module")
def host_runs():
    """(JAX solver, its sweeps per step, port solver, its sweeps per step)
    after run() over the 6-step window with the expiring BC."""
    out = []
    for port in (False, True):
        fl, log = _duct(port, setup=False), []
        _sweeps(fl, log)
        fl.run(verbose=False)
        out += [fl, log]
    return out


def test_run_with_expiring_bc_matches_jax(host_runs):
    jfl, jlog, pfl, plog = host_runs
    assert plog == jlog and len(plog) == 6 and min(plog) > 1
    assert pfl.time.get_timestep() == 6
    # expired after step 3; the clock advanced before setup and once per
    # step while the BC lived (the first step saw 2 dt)
    assert pfl.hard_coded_bcs == {} and jfl.hard_coded_bcs == {}
    assert pfl.bc_time == pytest.approx(jfl.bc_time)
    assert pfl.bc_time == pytest.approx(4 * DT)
    # the expired BC keeps its last rebuilt values
    last = float(pfl.nonzero_constraints.dirichlet_values.max())
    assert last == pytest.approx(ad.pulse_value(4 * DT))
    assert rel_err(pfl.present_solution, jfl.present_solution) <= 1e-8
    assert rel_err(pfl.stress_device, jfl.stress_device) <= 1e-8
    assert float(pfl.velocity_part().max()) > 0


def test_run_on_device_matches_run_and_jax(host_runs):
    jhost, _, phost, _ = host_runs
    pdev = _duct(True, setup=False)
    pdev.run_on_device(verbose=False)
    assert pdev.time.get_timestep() == 6
    # the solver is left where run() leaves it
    assert pdev.hard_coded_bcs == {} and pdev.bc_time_limits == {}
    assert pdev.bc_time == pytest.approx(phost.bc_time)
    assert rel_err(pdev.nonzero_constraints.dirichlet_values,
                   phost.nonzero_constraints.dirichlet_values) == 0
    scale = max(1.0, float(phost.present_solution.abs().max()))
    err = float((pdev.present_solution - phost.present_solution).abs().max())
    assert err <= 1e-10 * scale
    assert rel_err(pdev.stress_device, phost.stress_device) <= 1e-10
    jdev = _duct(False, setup=False)
    jdev.run_on_device(verbose=False)
    assert rel_err(pdev.present_solution, jdev.present_solution) <= 1e-8
    assert rel_err(pdev.solution_increment, jdev.solution_increment) <= 1e-8


def test_bc_value_table_and_stepper():
    jfl, pfl = _duct(False), _duct(True)
    jt, pt = jfl.bc_value_table(6), pfl.bc_value_table(6)
    assert tuple(pt.shape) == (6, pfl.n_u)
    assert rel_err(pt, jt) == 0
    # rows 0-2 follow the pulse from 2 dt on, rows 3-5 keep the last value
    peak = [float(r.max()) for r in pt]
    assert peak[:3] == pytest.approx([ad.pulse_value((i + 2) * DT)
                                      for i in range(3)])
    assert peak[3:] == [peak[2]] * 3
    # the table leaves the BC state where run() would
    assert pfl.hard_coded_bcs == {} and pfl.bc_time == pytest.approx(4 * DT)
    sol, rel, its = pfl.make_on_device_stepper(pt)(pfl.present_solution, 2)
    assert isinstance(rel, float) and isinstance(its, int) and its > 1
    assert rel < pfl.params.fluid_tolerance and torch.isfinite(sol).all()
    assert pfl.time.get_timestep() == 0          # the solver's own clock
    sol0, rel0, it0 = pfl.make_on_device_stepper(pt)(pfl.present_solution, 0)
    assert sol0 is pfl.present_solution and (rel0, it0) == (0.0, 0)


def test_too_many_sweeps_raises():
    pfl = _duct(True)
    pfl.params.fluid_max_iterations = 2
    with pytest.raises(RuntimeError, match="Too many iterations"):
        pfl.run_one_step(True, verbose=False)


@pytest.mark.parametrize("solver", ["SCnsEX", "SCnsIM"])
def test_interop_carries_a_run(solver):
    """Three steps in the JAX package, the state carried into the port
    (solution, nodal stress, time, BC clock, expired BCs and their last
    values), two more steps in both."""
    def build(port):
        kw = dict(device="cpu") if port else {}
        fl = ad.duct_case(PORT if port else JAX, solver, refine=1,
                          n_steps=3, **kw)
        if solver == "SCnsEX":
            fl.set_hard_coded_boundary_condition_time(0, 1.5 * DT)
        return fl
    jfl, pfl = build(False), build(True)
    jfl.run(verbose=False)
    # the port is set up on the same mesh, at rest
    if solver == "SCnsEX":
        pfl._refine_and_setup()
    else:
        pfl._refine_setup_with_mg()
    state = interop.fluid_state(jfl)
    assert state["bc_ids"] == ([] if solver == "SCnsEX" else [0])
    interop.load_fluid_state(pfl, state)
    assert pfl.time.get_timestep() == 3 and pfl.bc_time == jfl.bc_time
    assert sorted(pfl.hard_coded_bcs) == state["bc_ids"]
    assert rel_err(pfl.present_solution, jfl.present_solution) == 0
    assert rel_err(pfl.nonzero_constraints.dirichlet_values,
                   jfl.nonzero_constraints.dirichlet_values) == 0
    for fl in (jfl, pfl):
        fl.time.time_end = 5 * DT
        fl.run(verbose=False)
    assert pfl.time.get_timestep() == jfl.time.get_timestep() == 5
    assert pfl.bc_time == pytest.approx(jfl.bc_time)
    tol = 1e-8 if solver == "SCnsEX" else 1e-6
    assert rel_err(pfl.present_solution, jfl.present_solution) <= tol
    assert rel_err(pfl.stress_device, jfl.stress_device) <= tol
