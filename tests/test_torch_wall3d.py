"""The fsi-wall-3D case (openifem_tpu_torch.cases.fsi_wall_3d) in the port
against the JAX package, at the truncated size of tests/test_mpi_fsi.py
(fluid [4, 4, 16] refined to 480 cells, 3,020 dofs; solid [5, 5, 2], 324
dofs):

- wall3d_case in f64 (bench_precision=False), 3 steps through MPIFSI.run
  (the host first step, then two coupled steps): fluid solution and nodal
  stress, particle state and the nodal stress rows within 1e-6 of the
  reference's max norm, equal Newton counts, equal indicator, finite
  fields; the port's run with its step_span hook set, which each coupled
  step enters around its coupling, solid RK4 and fluid Newton parts;
- one 3-D SCnsIM Newton iteration from a seeded state with the bench
  knobs (dense Tpp, element outer Jacobian, f32 Jacobian, preconditioner
  and outer FGMRES, inexact-Newton forcing): the residual norm within
  1e-12, the update within 1e-5 (one solve to the forcing tolerance in
  f32), the outer iteration counts within one.
"""

from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import torch

from openifem_tpu_torch.cases.fsi_wall_3d import (TRUNCATED, wall3d_case,
                                                  wall3d_fields,
                                                  wall3d_knobs,
                                                  wall3d_meshes)
from torch_parity import JAX, PORT, np_, rel_err, supg_seed_state


def _newton_log(fsi):
    log = []
    for name in ("_run_fluid_step", "run_one_coupled_step"):
        real = getattr(fsi, name)

        def step(*a, real=real, **k):
            real(*a, **k)
            log.append(int(fsi.fluid.newton_iters))
        setattr(fsi, name, step)
    return log


def test_three_steps_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the solid writes VTU on step 1
    runs, spans = [], []

    @contextmanager
    def span(name):
        spans.append(name)
        yield

    for pkg, kw in ((JAX, {}), (PORT, dict(device="cpu"))):
        fsi = wall3d_case(pkg, reps=TRUNCATED, n_steps=3,
                          bench_precision=False, **kw)
        log = _newton_log(fsi)
        if pkg is PORT:
            fsi.step_span = span
        fsi.run(verbose=False)
        runs.append((fsi, log))
    (jf, jlog), (pf, plog) = runs
    assert plog == jlog and len(plog) == 3
    # the per-phase first step's parts, then two coupled steps'
    assert spans == (["coupling", "solid", "coupling", "coupling",
                      "fluid Newton"]
                     + ["coupling", "solid RK4", "coupling",
                        "fluid Newton"] * 2)
    assert [s["coupled"] for s in pf.step_log] == [False, True, True]
    assert np.array_equal(np_(pf.fluid.indicator), np_(jf.fluid.indicator))
    assert np_(pf.fluid.indicator).sum() > 0
    for a, b in ((pf.fluid.present_solution, jf.fluid.present_solution),
                 (pf.fluid.stress_device, jf.fluid.stress_device),
                 (pf.fluid.fsi_acc_nodal, jf.fluid.fsi_acc_nodal),
                 (pf.fluid.fsi_stress_nodal, jf.fluid.fsi_stress_nodal),
                 (pf.solid.x, jf.solid.x), (pf.solid.v, jf.solid.v),
                 (pf.solid.sigma, jf.solid.sigma),
                 (pf.solid.fsi_stress_rows, jf.solid.fsi_stress_rows)):
        assert np.isfinite(np_(a)).all()
        assert rel_err(a, b) <= 1e-6
    u = np_(pf.fluid.present_solution)[:pf.fluid.n_u]
    assert np.abs(u).max() > 1.0              # the inlet drives the flow
    assert np.abs(np_(pf.solid.fsi_stress_rows)).max() > 0


def _fluid(pkg, **kw):
    p = pkg.AllParameters(**wall3d_fields(1))
    fm, _ = wall3d_meshes(pkg.generators, *TRUNCATED)
    fl = pkg.SCnsIM(fm, p, **kw)
    for name, value in wall3d_knobs(bench_precision=True).items():
        setattr(fl, name, value)
    fl.setup()
    return fl


def test_newton_iteration_with_bench_knobs():
    jfl, pfl = _fluid(JAX), _fluid(PORT, device="cpu")
    assert (pfl.outer_branch(), pfl.tpp_branch()) == ("element", "dense")
    assert pfl.u_constraints.any_hanging      # faces and edges of the band
    eddy = supg_seed_state(jfl, pfl, scale=0.05)
    tail = lambda fl, conv: (fl.present_solution, fl.indicator,  # noqa: E731
                             fl.fsi_acc_nodal, fl.fsi_stress_nodal,
                             fl.stress_device, conv(eddy),
                             fl.zero_constraints, fl.u_constraints,
                             fl.p_constraints)
    jdu, jrn, jits, _ = jfl._newton_iter(jfl.present_solution,
                                         *tail(jfl, jnp.asarray))
    pdu, prn, pits, _ = pfl._newton_iter(pfl.present_solution,
                                         *tail(pfl, torch.as_tensor))
    assert abs(prn - float(jrn)) <= 1e-12 * float(jrn)
    assert abs(pits - int(jits)) <= 1 and pits > 1
    assert rel_err(pdu, jdu) <= 1e-5
