"""Checkpoint and restart in the port (the port on the CPU, configurations
built in code), mirroring the JAX package's tests/test_io.py checkpoint
and interval cases and tests/test_mpi_fsi.py:299-460:

- fluid, solid, after-AMR and Spalart-Allmaras restarts: a run
  interrupted at the save point and restarted reproduces the
  uninterrupted run within 1e-12;
- the run loops write checkpoints at `Save interval` and refine at
  `Refinement interval`;
- MPIFSI.run: restart exactness, interface refinement during the run, a
  restart with a solid global refinement, a partial restart that raises;
- FSI.resume on the disc in the cavity with interface refinement: exact;
- a checkpoint written by the JAX package restores in the port, which
  continues within 1e-8 of the JAX package's own continuation (and the
  port's checkpoint restores in the JAX package).
Every test works in its own tmp_path: MPIFSI.run restarts from any
checkpoint in the working directory.
"""

import glob
import os

import numpy as np
import pytest

from openifem_tpu_torch.cases import mpi_block as mb
from torch_parity import JAX, PORT, cavity, disc_fsi, np_, rel_err, sa_solver

EXACT = 1e-12


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def run_to_end(fl):
    while fl.time.end() - fl.time.current() > 1e-12:
        fl.run_one_step(False, verbose=False)


def test_checkpoint_restart_fluid():
    ref = cavity(True, set_up=False)
    ref.run(verbose=False)

    fa = cavity(True)
    fa.run_one_step(True, verbose=False)
    fa.run_one_step(False, verbose=False)
    fa.save_checkpoint()
    assert glob.glob("fluid-*.checkpoint.npz") == [
        "fluid-000002.checkpoint.npz"]

    fb = cavity(True, set_up=False)
    assert fb.load_checkpoint()
    assert fb.time.get_timestep() == 2
    assert np.array_equal(np_(fb.present_solution), np_(fa.present_solution))
    run_to_end(fb)
    assert rel_err(fb.present_solution, ref.present_solution) <= EXACT


def solid_beam(pkg=PORT, n_steps=4):
    p = pkg.AllParameters(
        simulation_type="Solid", dimension=2, global_refinements=[0, 1],
        end_time=n_steps * 0.01, time_step=0.01, output_interval=1e9,
        refinement_interval=1e9, save_interval=1e9, gravity=[0.0, -1.0],
        solid_degree=1, solid_type="LinearElastic", solid_rho=1.0, E=[1e3],
        nu=[0.3], n_solid_dirichlet_bcs=1, solid_dirichlet_bcs={0: 3})
    kw = dict(device="cpu") if pkg is PORT else {}
    return pkg.LinearElasticity(pkg.generators.subdivided_hyper_rectangle(
        [4, 1], [0.0, 0.0], [1.0, 0.25]), p, **kw)


def test_checkpoint_restart_solid():
    ref = solid_beam()
    ref.run()

    s2 = solid_beam()
    s2.mesh = s2.mesh.refine_global(s2.params.global_refinements[1])
    s2.setup()
    s2.run_one_step(True)
    s2.run_one_step(False)
    s2.save_checkpoint()

    s3 = solid_beam()
    assert s3.load_checkpoint()      # applies the global refinement
    assert s3.n_dofs == ref.n_dofs and s3.time.get_timestep() == 2
    while s3.time.end() - s3.time.current() > 1e-12:
        s3.run_one_step(False)
    assert rel_err(s3.current_displacement, ref.current_displacement) \
        <= EXACT


def test_checkpoint_restart_after_amr():
    """A checkpoint saved after Kelly AMR changed the dof layout restores
    the adapted mesh exactly."""
    fa = cavity(True)
    fa.run_one_step(True, verbose=False)
    fa.refine_mesh(0, 3)
    assert fa.mesh.n_cells != 16
    fa.run_one_step(False, verbose=False)
    fa.save_checkpoint()

    fb = cavity(True, set_up=False)
    assert fb.load_checkpoint()
    assert fb.n_dofs == fa.n_dofs and fb.mesh.n_cells == fa.mesh.n_cells
    assert np.array_equal(fb.mesh.level, fa.mesh.level)
    assert np.array_equal(np_(fb.present_solution), np_(fa.present_solution))
    for f in (fa, fb):
        f.run_one_step(False, verbose=False)
    assert rel_err(fb.present_solution, fa.present_solution) <= EXACT


def test_checkpoint_restart_sa_turbulence():
    """nu~ and the wall state ride on the fluid checkpoint (reference:
    source/mpi_spalart_allmaras.cpp:569-591): 2 steps, save, restart, 2
    more equal 4 uninterrupted steps."""
    def step(fl, first):
        sa = fl.turbulence_model
        sa.update_boundary_condition(first)
        sa.run_one_step(first)
        fl.run_one_step(first, verbose=False)

    f1 = sa_solver(True, "SUPGInsIM")
    for i in range(4):
        step(f1, i == 0)
    f2 = sa_solver(True, "SUPGInsIM")
    for i in range(2):
        step(f2, i == 0)
    f2.save_checkpoint()
    with np.load("fluid-000002.checkpoint.npz") as data:
        assert {"sa_nu_tilde", "sa_moving_wall_distance", "sa_y_plus",
                "sa_accum_mask", "mesh_level"} <= set(data.files)

    f3 = sa_solver(True, "SUPGInsIM")
    assert f3.load_checkpoint()
    sa3 = f3.turbulence_model
    assert f3.time.get_timestep() == 2
    assert np.array_equal(np_(sa3.present_solution),
                          np_(f2.turbulence_model.present_solution))
    assert np.array_equal(np_(sa3._accum_mask),
                          np_(f2.turbulence_model._accum_mask))
    for _ in range(2):
        step(f3, False)
    assert rel_err(f3.present_solution, f1.present_solution) <= EXACT
    assert rel_err(sa3.present_solution,
                   f1.turbulence_model.present_solution) <= EXACT


@pytest.mark.parametrize("loop", ["outputs", "fluid", "fsi"])
def test_run_loop_saves_and_refines_at_intervals(loop):
    """Every run loop writes VTU/PVD at `Output interval` without the
    caller asking (reference: source/mpi_fluid_solver.cpp:490-579,
    source/mpi_insim.cpp:481-484); the standalone fluid's run() saves at
    `Save interval` and applies Kelly AMR at `Refinement interval`
    (:475-489); FSI.run writes coordinated checkpoints, the older ones
    removed."""
    if loop == "outputs":
        fl = cavity(True, set_up=False, n_steps=4)
        fl.params.output_interval = fl.time.output_interval = \
            2 * fl.params.time_step
        fl.run(verbose=False)
        assert sorted(glob.glob("fluid-*.vtu")) == [
            "fluid-000002.vtu", "fluid-000004.vtu"]
        assert os.path.exists("fluid.pvd")
        s = solid_beam(n_steps=2)
        s.params.output_interval = s.time.output_interval = \
            s.params.time_step
        s.run()
        assert {"solid-000001.vtu", "solid-000002.vtu"} <= set(
            glob.glob("solid-*.vtu"))
        return
    if loop == "fluid":
        fl = cavity(True, set_up=False, n_steps=4, refine_every=2,
                    save_every=2)
        fl.run(verbose=False)
        assert fl.mesh.n_cells != 16
        assert glob.glob("*.checkpoint.npz") == [
            "fluid-000004.checkpoint.npz"]
        # the step's save comes before its refinement (reference order)
        with np.load("fluid-000004.checkpoint.npz") as data:
            saved = data["present_solution"].size
        fb = cavity(True, set_up=False)
        assert fb.load_checkpoint()
        assert fb.n_dofs == saved and fb.time.get_timestep() == 4
        return
    fsi = mb.block_case(PORT, "body_force", n_steps=3, device="cpu")
    fsi.params.save_interval = fsi.time.save_interval = \
        fsi.params.time_step
    fsi.run(verbose=False)
    assert sorted(glob.glob("*.checkpoint.npz")) == [
        "fluid-000003.checkpoint.npz", "solid-000003.checkpoint.npz"]
    assert not glob.glob("*.tmp")


def block(n_steps, save_every=None, refine_every=None, refinements=None,
          config="body_force", port=True):
    pkg, dev = (PORT, dict(device="cpu")) if port else (JAX, {})
    fsi = mb.block_case(pkg, config, n_steps=n_steps, **dev)
    p, dt = fsi.params, fsi.params.time_step
    if save_every:
        p.save_interval = fsi.time.save_interval = save_every * dt
    if refine_every:
        p.refinement_interval = fsi.time.refinement_interval = \
            refine_every * dt
    if refinements:
        p.global_refinements = list(refinements)
    return fsi


def record_run(fsi):
    """Log each per-phase step's fluid Newton count and each refinement's
    fluid cell count (any package's MPIFSI.run)."""
    log = []
    run_fluid, refine = fsi._run_fluid_step, fsi.refine_mesh

    def fluid_step(*a, **k):
        run_fluid(*a, **k)
        log.append(("newton", int(fsi.fluid.newton_iters)))

    def refined(*a, **k):
        refine(*a, **k)
        log.append(("cells", int(fsi.fluid.mesh.n_cells)))
    fsi._run_fluid_step, fsi.refine_mesh = fluid_step, refined
    return log


def clear():
    for f in glob.glob("*.checkpoint.npz"):
        os.remove(f)


def test_mpi_fsi_restart_exactness():
    """MPIFSI.run loads the latest coordinated checkpoints and saves at
    `Save interval` (reference: source/mpi_fsi.cpp:1127-1133,
    1221-1225): interrupted at step 2 and restarted, it reproduces the
    uninterrupted run."""
    ref = block(4, save_every=2)
    ref.run(verbose=False)
    clear()
    first = block(2, save_every=2)
    first.run(verbose=False)
    assert glob.glob("fluid-000002.checkpoint.npz")
    again = block(4, save_every=2)
    again.run(verbose=False)
    assert again.time.get_timestep() == 4 and len(again.step_log) == 2
    assert not any(s["coupled"] for s in again.step_log)
    assert rel_err(again.fluid.present_solution, ref.fluid.present_solution) \
        <= EXACT
    assert rel_err(again.solid.current_displacement,
                   ref.solid.current_displacement) <= EXACT


def test_mpi_fsi_refine_during_run():
    """Interface refinement (levels (gr, gr + 3)) before the first step
    and every 2 steps, with the coupling tables rebuilt, against the JAX
    package's MPIFSI.run on the same block: equal meshes after every
    refinement, equal Newton counts per step, fluid and solid within
    1e-6."""
    runs = []
    for port in (False, True):
        fsi = block(3, refine_every=2, port=port)
        log = record_run(fsi)
        fsi.run(verbose=False)
        runs.append((fsi, log))
    (jf, jlog), (pf, plog) = runs
    fl = pf.fluid
    assert plog == jlog
    assert [k for k, _ in plog] == ["cells"] * 2 + ["newton"] * 2 + [
        "cells", "newton"]
    assert fl.mesh.n_cells > 200 and fl.mesh.level.max() == 3
    for name in ("cells", "level", "vertices"):
        np.testing.assert_array_equal(getattr(fl.mesh, name),
                                      getattr(jf.fluid.mesh, name))
    assert pf._fluid_centers.shape[0] == fl.mesh.n_cells
    assert len(pf.step_log) == 3
    for a, b in ((fl.present_solution, jf.fluid.present_solution),
                 (pf.solid.current_displacement,
                  jf.solid.current_displacement)):
        assert rel_err(a, b) <= 1e-6


def test_mpi_fsi_restart_with_solid_refinement():
    """With a solid global refinement the solid mesh is refined once
    (load_checkpoint applies it), not by run() and again by the load."""
    ref = block(4, save_every=2, refinements=(0, 1))
    ref.run(verbose=False)
    clear()
    block(2, save_every=2, refinements=(0, 1)).run(verbose=False)
    again = block(4, save_every=2, refinements=(0, 1))
    again.run(verbose=False)
    assert again.solid.n_dofs == ref.solid.n_dofs
    assert rel_err(again.solid.current_displacement,
                   ref.solid.current_displacement) <= 1e-10


def test_mpi_fsi_partial_restart_is_loud():
    """A lone solid checkpoint without its fluid twin raises (reference:
    unconditional AssertThrow, source/mpi_fsi.cpp:1130-1134)."""
    block(2, save_every=1).run(verbose=False)
    for f in glob.glob("fluid-*.checkpoint.npz"):
        os.remove(f)
    with pytest.raises(RuntimeError, match="Inconsistent restart"):
        block(2, save_every=1).run(verbose=False)


def test_jax_checkpoint_restores_in_port():
    """The cavity run 2 steps by the JAX package and saved; the port
    loads that file and runs 2 more steps, as the JAX package does from
    its own file: within 1e-8.  Then the port's checkpoint of the end
    state restores in the JAX package unchanged."""
    ja = cavity(False)
    ja.run_one_step(True, verbose=False)
    ja.run_one_step(False, verbose=False)
    ja.save_checkpoint()

    outs = []
    for port in (False, True):
        f = cavity(port, set_up=False)
        assert f.load_checkpoint()
        assert f.time.get_timestep() == 2
        run_to_end(f)
        outs.append(f)
    jb, pb = outs
    assert rel_err(pb.present_solution, jb.present_solution) <= 1e-8

    pb.save_checkpoint()
    jc = cavity(False, set_up=False)
    assert jc.load_checkpoint()
    assert jc.time.get_timestep() == 4
    assert np.array_equal(np.asarray(jc.present_solution),
                          np_(pb.present_solution))


def test_fsi_resume_exactness():
    """FSI.resume: the disc in the cavity with interface refinement and a
    checkpoint every 2 steps, run 2 steps, then resumed from the step-2
    checkpoints (the adapted mesh rebuilt from the file) to step 4,
    equals the uninterrupted 4-step run."""
    kw = dict(n_steps=4, refine_every=2, save_every=2)
    ref = disc_fsi(True, **kw)
    ref.run(verbose=False)
    clear()
    # the same run, interrupted after step 2 (its parameters unchanged:
    # a shorter end time would skip the initial refinement)
    cut = disc_fsi(True, **kw)
    cut.time.time_end = 2 * cut.params.time_step
    cut.run(verbose=False)
    again = disc_fsi(True, **kw)
    again.resume(verbose=False)
    assert again.time.get_timestep() == 4 and len(again.step_log) == 2
    assert all(s["coupled"] for s in again.step_log)
    assert again.fluid.mesh.n_cells != 64
    assert np.array_equal(again.fluid.mesh.cells, ref.fluid.mesh.cells)
    assert rel_err(again.fluid.present_solution, ref.fluid.present_solution) \
        <= EXACT
    assert rel_err(again.solid.current_displacement,
                   ref.solid.current_displacement) <= EXACT
    clear()
    with pytest.raises(RuntimeError, match="no coordinated checkpoints"):
        disc_fsi(True, **kw).resume(verbose=False)
