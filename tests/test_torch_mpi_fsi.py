"""The port's MPI-semantics coupler (fsi/mpi_fsi.py) against the JAX
package, on configurations built in code for both
(openifem_tpu_torch.cases.mpi_block, .fsi_wall_3d):

- each _MPIKernels function on a seeded state (moved solid, fluid
  solution and nodal stress, solid velocity, acceleration and nodal
  stress), on the 2-D block and the truncated 3-D wall: the indicator and
  the Dirichlet mask equal, the rest within 1e-12 of the reference's max
  norm;
- MPIFSI.run for 3 steps on the 2-D block: SharedLinearElasticity in
  body-force mode, the same with the contact model (its retry loop runs
  every step), and SharedHyperElasticity with use_dirichlet_bc=True:
  fluid solution, fluid nodal stress and solid displacement within 1e-6,
  equal Newton counts per step and equal contact retry counts;
- the restart from checkpoints in the working directory (a lone fluid
  checkpoint raises) and interface refinement during the run
  (test_torch_checkpoint.py holds them against uninterrupted runs; the
  turbulence hooks: test_torch_cv_fsi.py).
"""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu_torch.cases.fsi_wall_3d import TRUNCATED, wall3d_case
from openifem_tpu_torch.cases.mpi_block import CONFIGS, block_case
from torch_parity import JAX, PORT, np_, rel_err, setup_fsi


def build(port, case, **kw):
    pkg, dev = (PORT, dict(device="cpu")) if port else (JAX, {})
    if case == "wall3d":
        return wall3d_case(pkg, reps=TRUNCATED, bench_precision=False,
                           **kw, **dev)
    return block_case(pkg, case, **kw, **dev)


@pytest.mark.parametrize("case", ["body_force", "wall3d"])
def test_kernels_on_seeded_state(case):
    jf, pf = setup_fsi(build(False, case)), setup_fsi(build(True, case))
    jk, pk = jf._mpi_kernels, pf._mpi_kernels
    d = jf.fluid.dim
    rng = np.random.default_rng(21)
    n_sv = jf._n_sv
    moved = np.asarray(jf._solid_ref_verts) + 0.01 * rng.normal(
        size=(n_sv, d))
    n_s = jf.solid.space.n_nodes
    sol = 0.3 * rng.normal(size=jf.fluid.n_dofs)
    f_stress = rng.normal(size=(jf.fluid.u_space.n_nodes, d, d))
    s_vel, s_acc = rng.normal(size=n_s * d), rng.normal(size=n_s * d)
    s_stress = rng.normal(size=(n_s, d, d))
    s_disp = 0.01 * rng.normal(size=n_s * d)
    J, T = jnp.asarray, torch.as_tensor

    jind = jk.indicator_all_vertices(J(moved))
    pind = pk.indicator_all_vertices(T(moved))
    assert np.array_equal(np_(pind), np_(jind)) and np_(pind).sum() > 0
    jind, pind = J(np_(jind).astype(float)), T(np_(jind).astype(float))

    pairs = [
        (jk.fsi_stress_nodal(J(moved), J(f_stress), J(s_stress), jind),
         pk.fsi_stress_nodal(T(moved), T(f_stress), T(s_stress), pind)),
        (jk.fsi_acc_nodal(J(moved), J(sol), J(s_vel), J(s_acc), jind),
         pk.fsi_acc_nodal(T(moved), T(sol), T(s_vel), T(s_acc), pind)),
    ]
    pairs += list(zip(jk.solid_bc_rows(J(s_disp), J(sol), J(f_stress)),
                      pk.solid_bc_rows(T(s_disp), T(sol), T(f_stress))))
    (jmask, jvals), (pmask, pvals) = (jk.dirichlet_bc_mpi(J(moved), J(s_vel)),
                                      pk.dirichlet_bc_mpi(T(moved), T(s_vel)))
    assert np.array_equal(np_(pmask), np_(jmask)) and np_(pmask).any()
    pairs.append((jvals, pvals))
    for ref, got in pairs:
        assert np.abs(np_(ref)).max() > 0
        assert rel_err(got, ref) <= 1e-12


def record(fsi):
    """Per step of fsi.run: (fluid Newton iterations, solid retries)."""
    log, retries = [], []
    solid = fsi.solid
    run_solid = solid.run_one_step
    run_fluid = fsi._run_fluid_step

    def solid_step(*a, **k):
        run_solid(*a, **k)
        retries[-1] += 1

    def fluid_step(*a, **k):
        run_fluid(*a, **k)
        log.append((int(fsi.fluid.newton_iters), retries[-1] - 1))

    def find_solid_bc(real=fsi.find_solid_bc):
        retries.append(0)
        real()
    solid.run_one_step = solid_step
    fsi._run_fluid_step = fluid_step
    fsi.find_solid_bc = find_solid_bc
    return log


@pytest.mark.parametrize("config", CONFIGS)
def test_run_three_steps_match_jax(config):
    runs = []
    for port in (False, True):
        fsi = build(port, config)
        log = record(fsi)
        fsi.run(verbose=False)
        runs.append((fsi, log))
    (jf, jlog), (pf, plog) = runs
    assert plog == jlog and len(plog) == 3
    assert [s["solid_retries"] for s in pf.step_log] == [r for _, r in jlog]
    if config == "contact":
        assert min(r for _, r in plog) >= 1
    for a, b in ((pf.fluid.present_solution, jf.fluid.present_solution),
                 (pf.fluid.stress_device, jf.fluid.stress_device),
                 (pf.solid.current_displacement,
                  jf.solid.current_displacement),
                 (pf.fluid.indicator, jf.fluid.indicator)):
        assert rel_err(a, b) <= 1e-6
    assert np.abs(np_(pf.solid.current_displacement)).max() > 1e-6


def test_refusals(tmp_path, monkeypatch):
    """What used to be refused now runs: a lone fluid checkpoint in the
    working directory makes the restart raise (a partial pair), and
    interface refinement runs (test_torch_checkpoint.py holds both
    against the uninterrupted runs)."""
    monkeypatch.chdir(tmp_path)
    saved = build(True, "body_force")
    saved.time.save_interval = saved.params.time_step
    saved.run(verbose=False)
    for f in glob.glob("solid-*.checkpoint.npz"):
        (tmp_path / f).unlink()
    with pytest.raises(RuntimeError, match="Inconsistent restart files"):
        build(True, "body_force").run(verbose=False)
    for f in glob.glob("*.checkpoint.npz"):
        (tmp_path / f).unlink()
    fsi = build(True, "body_force")
    fsi.params.refinement_interval = fsi.params.time_step
    fsi.time.refinement_interval = fsi.params.time_step
    fsi.run(verbose=False)
    assert fsi.fluid.mesh.n_cells > 200
    assert len(fsi.step_log) == 3
