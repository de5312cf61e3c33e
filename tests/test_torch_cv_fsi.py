"""The port's ControlVolumeFSI (fsi/cv_fsi.py) with the Spalart-Allmaras
wall functions of the MPI coupler, against the JAX package, on the coarse
vocal fold (openifem_tpu_torch.cases.vocal_fold, 3,534 dofs, f64):

- the set-up tables: control-volume cells, both cut planes (cells,
  trapezoid weights, kept fractions, shape values and gradients at the
  cut endpoints, 1e-12) and the Bernoulli path and end cells;
- one control_volume_analysis on a seeded state (fluid solution and
  increment, nodal stress, eddy viscosity, a displaced fold): every
  budget key within 1e-10 of the reference (1e-12 absolute near 0);
- 3 coupled steps through ControlVolumeFSI.run: fluid solution, nu~ and
  solid displacement within 1e-6, equal fluid Newton, SA Newton and
  contact-retry counts per step, every cv_history key within 1e-6; the
  CSV's columns and the solid-trace files, written under tmp_path;
- the interop round trip: the JAX run's state after its second step
  (fluid, solid, turbulence model, shear velocities, budget history)
  loaded into a port coupler set up on the same mesh gives the JAX run's
  third step within 1e-6;
- interface refinement and coordinated checkpoints at their intervals:
  the run refines (the control-volume and model tables rebuilt) or saves.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu_torch import interop
from openifem_tpu_torch.cases import vocal_fold as vf
from torch_parity import JAX, PORT, np_, rel_err


def build(port, n_steps=3):
    return vf.vocal_fold_case(PORT if port else JAX, n_steps,
                              **(dict(device="cpu") if port else {}))


def set_up(fsi):
    """ControlVolumeFSI.run's set-up: refine, both solvers, the model,
    the coupling tables."""
    gr = fsi.params.global_refinements
    fsi.solid.mesh = fsi.solid.mesh.refine_global(gr[1])
    fsi.solid.setup()
    fsi.fluid.mesh = fsi.fluid.mesh.refine_global(gr[0])
    fsi.fluid.setup()
    fsi.fluid.turbulence_model.setup()
    fsi._setup_coupling()
    return fsi


def close(got, want, rtol):
    """Budget values agree to rtol of the reference, or 1e-12 absolute
    where the reference is near 0."""
    return abs(got - want) <= max(rtol * abs(want), 1e-12)


@pytest.fixture(scope="module")
def pair():
    return set_up(build(False)), set_up(build(True))


def test_cut_plane_tables(pair):
    jf, pf = pair
    np.testing.assert_array_equal(pf._cv_cells, jf._cv_cells)
    assert len(pf._cv_cells) > 0
    for jc, pc in ((jf._cut_in, pf._cut_in), (jf._cut_out, pf._cut_out)):
        np.testing.assert_array_equal(pc["cells"], jc["cells"])
        for name in ("w", "frac", "Nu", "Np", "gu"):
            assert rel_err(pc[name], jc[name]) <= 1e-12, name
    np.testing.assert_array_equal(np_(pf._path["cells"]), jf._path_cells)
    assert rel_err(pf._path_af, jf._path_area_fraction) <= 1e-15
    ends = jf._bernoulli_ends
    assert len(ends) == 2 and {k for _, _, k in ends} == {"contraction",
                                                           "jet"}
    np.testing.assert_array_equal(np_(pf._ends["cells"]),
                                  [c for c, _, _ in ends])
    assert rel_err(pf._ends_w, [w for _, w, _ in ends]) <= 1e-15
    np.testing.assert_array_equal(np_(pf._ends_contraction),
                                  [k == "contraction" for _, _, k in ends])


def test_control_volume_analysis_on_seeded_state(pair, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    jf, pf = pair
    rng = np.random.default_rng(17)
    fl, so = jf.fluid, jf.solid
    n_n, d = fl.u_space.n_nodes, fl.dim
    sol = 0.5 * rng.normal(size=fl.n_dofs)
    inc = 0.05 * rng.normal(size=fl.n_dofs)
    stress = 0.1 * rng.normal(size=(n_n, d, d))
    eddy = 1e-3 * rng.random(n_n)
    # the fold pushed downstream and up, its tip at the centreline gap
    ref = np.asarray(so.mesh.vertices)
    disp = np.zeros(so.n_dofs)
    disp[:ref.size] = (np.stack([0.05 * ref[:, 1], 0.1 * ref[:, 1]], 1)
                       + 1e-3 * rng.normal(size=ref.shape)).reshape(-1)
    for f, conv in ((jf, jnp.asarray), (pf, torch.as_tensor)):
        f.fluid.present_solution = conv(sol)
        f.fluid.solution_increment = conv(inc)
        f.fluid.stress_device = conv(stress)
        f._tm.eddy_viscosity_nodal = conv(eddy)
        f.solid.current_displacement = conv(disp)
        f.update_solid_box_and_indicator()
    np.testing.assert_array_equal(np_(pf.fluid.indicator),
                                  np.asarray(jf.fluid.indicator))
    assert np_(pf.fluid.indicator).sum() > 0
    want = jf.control_volume_analysis()
    got = pf.control_volume_analysis()
    assert set(got) == set(want) and len(want) == 43
    bad = {k: (got[k], want[k]) for k in want
           if not close(got[k], want[k], 1e-10)}
    assert not bad
    assert abs(want["gap_volume_flow"]) > 0 and want["VF_volume"] > 0
    assert abs(want["rate_stabilization"]) > 0


def _record(fsi, snapshot=None):
    """Per step of fsi.run: (fluid Newton, SA Newton, solid retries); with
    `snapshot` (a dict), the state after the second step's budgets."""
    log, counts = [], dict(sa=0, solid=0)
    tm, solid = fsi.fluid.turbulence_model, fsi.solid
    real_setup, real_solid = tm.setup, solid.run_one_step
    real_fluid, real_cv = fsi._run_fluid_step, fsi.control_volume_analysis

    def setup():
        real_setup()
        real = tm._newton_iter

        def counted(*a, **k):
            counts["sa"] += 1
            return real(*a, **k)
        tm._newton_iter = counted

    def solid_step(*a, **k):
        real_solid(*a, **k)
        counts["solid"] += 1

    def fluid_step(*a, **k):
        real_fluid(*a, **k)
        log.append((int(fsi.fluid.newton_iters), counts["sa"],
                    counts["solid"] - 1))
        counts.update(sa=0, solid=0)

    def analysis():
        out = real_cv()
        if snapshot is not None and len(fsi.cv_history) == 2:
            snapshot.update(
                fluid=interop.fluid_state(fsi.fluid),
                solid=interop.solid_state(solid),
                tm=interop.turbulence_state(tm, fsi),
                time=(fsi.time.timestep, fsi.time.time_current))
        return out

    if not hasattr(tm, "space"):
        tm.setup = setup
    else:
        setup()
    solid.run_one_step = solid_step
    fsi._run_fluid_step = fluid_step
    fsi.control_volume_analysis = analysis
    return log


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's 3-step run: (fsi, log, state after step 2, run
    directory)."""
    where = tmp_path_factory.mktemp("jax_cv")
    cwd = os.getcwd()
    os.chdir(where)
    try:
        fsi, snap = build(False), {}
        log = _record(fsi, snap)
        fsi.run(verbose=False)
    finally:
        os.chdir(cwd)
    return fsi, log, snap, where


def _read_csv(path):
    with open(path) as f:
        head = f.readline().strip().split(",")
        rows = [[float(x) for x in line.split(",")] for line in f]
    return head, np.array(rows)


def _read_traces(where):
    files = sorted(os.listdir(where / "solid_trace"))
    return files, [np.loadtxt(where / "solid_trace" / f) for f in files]


def test_run_three_steps_match_jax(jax_run, tmp_path, monkeypatch):
    jf, jlog, _, jdir = jax_run
    monkeypatch.chdir(tmp_path)
    pf = build(True)
    plog = _record(pf)
    pf.run(verbose=False)
    assert plog == jlog and len(plog) == 3
    assert [(s["fluid_newton"], s["sa_newton"], s["solid_retries"])
            for s in pf.step_log] == plog
    assert [s["coupled"] for s in pf.step_log] == [False] * 3
    for a, b in ((pf.fluid.present_solution, jf.fluid.present_solution),
                 (pf.fluid.turbulence_model.present_solution,
                  jf.fluid.turbulence_model.present_solution),
                 (pf.solid.current_displacement,
                  jf.solid.current_displacement),
                 (pf.shear_velocities, jf.shear_velocities)):
        assert rel_err(a, b) <= 1e-6
    assert np_(pf.shear_velocities).max() > 0
    assert len(pf.cv_history) == len(jf.cv_history) == 3
    for got, want in zip(pf.cv_history, jf.cv_history):
        assert set(got) == set(want)
        bad = {k: (got[k], want[k]) for k in want
               if not close(got[k], want[k], 1e-6)}
        assert not bad
    # the CSV: the same columns, values within 1e-6
    phead, prows = _read_csv(tmp_path / "control_volume_analysis.csv")
    jhead, jrows = _read_csv(jdir / "control_volume_analysis.csv")
    assert phead == jhead and prows.shape == jrows.shape == (3, 43)
    assert np.all(np.abs(prows - jrows) <=
                  np.maximum(1e-6 * np.abs(jrows), 1e-12))
    # the solid trace: one file per step, the same vertices, positions
    # and pressures within 1e-6
    pfiles, ptr = _read_traces(tmp_path)
    jfiles, jtr = _read_traces(jdir)
    assert pfiles == jfiles and len(pfiles) == 3
    for p, j in zip(ptr, jtr):
        np.testing.assert_array_equal(p[:, 0], j[:, 0])
        assert rel_err(p[:, 1:], j[:, 1:]) <= 1e-6


def test_interop_round_trip(jax_run, tmp_path, monkeypatch):
    """The JAX run's state after step 2 loaded into the port gives the
    JAX run's step 3."""
    jf, _, snap, _ = jax_run
    monkeypatch.chdir(tmp_path)
    pf = set_up(build(True))
    interop.load_fluid_state(pf.fluid, snap["fluid"])
    interop.load_solid_state(pf.solid, snap["solid"])
    tm = pf.fluid.turbulence_model
    interop.load_turbulence_state(tm, snap["tm"], pf)
    pf.time.timestep, pf.time.time_current = snap["time"]
    # the state went across
    for f in interop.TURBULENCE_FIELDS:
        np.testing.assert_array_equal(np_(getattr(tm, f)), snap["tm"][f])
    assert pf.cv_history == snap["tm"]["cv_history"]
    # the third step of the JAX run, in the port
    pf._run_phases(False, False)
    pf.time.increment()
    pf._after_step()
    for a, b in ((pf.fluid.present_solution, jf.fluid.present_solution),
                 (tm.present_solution,
                  jf.fluid.turbulence_model.present_solution),
                 (pf.solid.current_displacement,
                  jf.solid.current_displacement)):
        assert rel_err(a, b) <= 1e-6
    assert len(pf.cv_history) == 3
    got, want = pf.cv_history[-1], jf.cv_history[-1]
    assert all(close(got[k], want[k], 1e-6) for k in want)


def _with_interval(fsi, interval):
    """fsi with `interval` set to one time step."""
    setattr(fsi.params, interval, fsi.params.time_step)
    fsi.time = type(fsi.time)(fsi.params.end_time, fsi.params.time_step,
                              fsi.params.output_interval,
                              fsi.params.refinement_interval,
                              fsi.params.save_interval)
    return fsi


def _refine_log(fsi):
    """Log each refinement's fluid cell count and each step's fluid
    Newton count (any package's ControlVolumeFSI.run)."""
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


@pytest.mark.parametrize("interval", ["refinement_interval",
                                      "save_interval"])
def test_refinement_and_checkpoint_refusals(interval, tmp_path,
                                            monkeypatch):
    """ControlVolumeFSI.run refines and saves at its intervals (it used
    to refuse both): interface refinement after each step, with the
    control-volume and model tables rebuilt on the new mesh, against the
    JAX package's run (equal meshes and Newton counts, fields and every
    cv_history key within 1e-6); or coordinated checkpoints with the
    model's state."""
    monkeypatch.chdir(tmp_path)
    fsi = _with_interval(build(True, n_steps=2), interval)
    n0 = fsi.fluid.mesh.n_cells
    log = _refine_log(fsi)
    fsi.run(verbose=False)
    assert len(fsi.cv_history) == 2
    assert all(np.isfinite(v) for h in fsi.cv_history for v in h.values())
    if interval == "refinement_interval":
        assert fsi.fluid.mesh.n_cells != n0
        assert fsi._fluid_centers.shape[0] == fsi.fluid.mesh.n_cells
        assert fsi.fluid.turbulence_model.n == fsi.fluid.u_space.n_nodes
        (tmp_path / "jax").mkdir()
        monkeypatch.chdir(tmp_path / "jax")
        jf = _with_interval(build(False, n_steps=2), interval)
        jlog = _refine_log(jf)
        jf.run(verbose=False)
        assert log == jlog and [k for k, _ in log] == [
            "newton", "cells"] * 2
        for name in ("cells", "level", "vertices"):
            np.testing.assert_array_equal(getattr(fsi.fluid.mesh, name),
                                          getattr(jf.fluid.mesh, name))
        for a, b in ((fsi.fluid.present_solution, jf.fluid.present_solution),
                     (fsi.fluid.turbulence_model.present_solution,
                      jf.fluid.turbulence_model.present_solution),
                     (fsi.solid.current_displacement,
                      jf.solid.current_displacement)):
            assert rel_err(a, b) <= 1e-6
        for got, want in zip(fsi.cv_history, jf.cv_history):
            assert set(got) == set(want)
            assert all(close(got[k], want[k], 1e-6) for k in want)
    else:
        assert sorted(glob.glob("*.checkpoint.npz")) == [
            "fluid-000002.checkpoint.npz", "solid-000002.checkpoint.npz"]
        with np.load("fluid-000002.checkpoint.npz") as data:
            assert "sa_nu_tilde" in data.files
