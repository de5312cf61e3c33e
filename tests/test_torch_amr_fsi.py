"""Interface refinement in the port against the JAX package (the port on
the CPU, the same configurations built in code), and the coupling after
a solid refines (test_torch_amr.py has the estimator, the transfer and
the standalone solvers):

- FSI.run with a refinement interval on a disc in the cavity: equal
  meshes, fluid and solid within 1e-6, equal Newton counts;
- FSI.refine_mesh on the coarse vocal fold: nu~ of the attached
  Spalart-Allmaras model transferred and its tables rebuilt, within
  1e-12;
- a LinearElasticity disc refines itself at the refinement interval
  inside FSI.run and the coupling tables follow it: the fluid's device
  step against its host step within 1e-10; a coupled step after a solid
  refinement against the per-phase step within 1e-10.
"""

import numpy as np

from openifem_tpu_torch.cases import vocal_fold as vf
from test_torch_amr import same_mesh
from torch_parity import JAX, PORT, disc_fsi, rel_err, record_newton


def test_fsi_refine_and_run():
    """FSI.run on the disc in the cavity with interface refinement: x2
    before the first step (levels (3, 4)) and again after step 2; equal
    meshes, the fluid and solid within 1e-6, equal Newton counts."""
    runs = []
    for port in (False, True):
        fsi = disc_fsi(port, n_steps=2, refine_every=2)
        log = record_newton(fsi)
        fsi.run(verbose=False)
        runs.append((fsi, log))
    (jf, jlog), (pf, plog) = runs
    assert plog == jlog and len(plog) == 2
    assert pf.fluid.mesh.level.max() == 4 and pf.fluid.mesh.n_cells > 64
    assert same_mesh(pf.fluid.mesh, jf.fluid.mesh)
    for a, b in ((pf.fluid.present_solution, jf.fluid.present_solution),
                 (pf.fluid.stress_device, jf.fluid.stress_device),
                 (pf.solid.current_displacement,
                  jf.solid.current_displacement)):
        assert rel_err(a, b) <= 1e-6
    # the coupling tables follow the refined mesh
    assert pf._fluid_centers.shape[0] == pf.fluid.mesh.n_cells
    assert pf.fluid.indicator.shape == (pf.fluid.mesh.n_cells,)


def test_fsi_refine_transfers_nu_tilde(tmp_path, monkeypatch):
    """FSI.refine_mesh on the coarse vocal fold after one step: nu~
    transferred and the model's tables rebuilt, within 1e-12."""
    monkeypatch.chdir(tmp_path)
    out = []
    for pkg, kw in ((JAX, {}), (PORT, dict(device="cpu"))):
        fsi = vf.vocal_fold_case(pkg, 1, **kw)
        fsi.run(verbose=False)
        n0 = fsi.fluid.mesh.n_cells
        fsi.refine_mesh(*(fsi.params.global_refinements[0] + np.array(
            [0, 3])).tolist())
        out.append((fsi, n0))
    (jf, n0), (pf, _) = out
    tm, jtm = pf.fluid.turbulence_model, jf.fluid.turbulence_model
    assert pf.fluid.mesh.n_cells != n0
    assert same_mesh(pf.fluid.mesh, jf.fluid.mesh)
    assert tm.n == pf.fluid.u_space.n_nodes == jtm.n
    assert rel_err(tm.present_solution, jtm.present_solution) <= 1e-12
    assert rel_err(tm.eddy_viscosity_nodal, jtm.eddy_viscosity_nodal) \
        <= 1e-12
    assert rel_err(pf.fluid.present_solution, jf.fluid.present_solution) \
        <= 1e-12


def test_linear_solid_refines_inside_fsi():
    """A LinearElasticity disc refines itself at the refinement interval
    inside FSI.run (reference: source/linear_elasticity.cpp:317); the
    coupling tables follow it.  The run with the fluid's device step
    agrees with the host step within 1e-10."""
    runs = []
    for device_step in (True, False):
        fsi = disc_fsi(True, n_steps=3, refine_every=2,
                       solid="LinearElasticity")
        fsi.device_fluid_stepping = device_step
        fsi.run(verbose=False)
        runs.append(fsi)
    a, b = runs
    assert a.solid.mesh.n_cells > 4 * 5
    assert a._coupling_meshes[1] is a.solid.mesh
    assert a._solid_cells.shape[0] == a.solid.mesh.n_cells
    assert [s["fluid_newton"] for s in a.step_log] == \
        [s["fluid_newton"] for s in b.step_log]
    assert rel_err(a.fluid.present_solution, b.fluid.present_solution) \
        <= 1e-10
    assert rel_err(a.solid.current_displacement,
                   b.solid.current_displacement) <= 1e-10


def test_coupled_step_after_solid_refinement():
    """The coupled step is rebuilt when the solid's mesh changes, not
    only the fluid's: after a Kelly refinement of the disc, one coupled
    step equals one per-phase step within 1e-10."""
    runs = []
    for fused in (True, False):
        fsi = disc_fsi(True, n_steps=3, refine_every=None)
        fsi.fused_coupled_stepping = fused
        fsi.params.end_time = fsi.time.time_end = 2 * fsi.params.time_step
        fsi.run(verbose=False)
        n0 = fsi.solid.mesh.n_cells
        fsi.solid.refine_mesh(1, 2)
        assert fsi.solid.mesh.n_cells > n0
        fsi.time.time_end = fsi.fluid.time.time_end = \
            fsi.solid.time.time_end = 3 * fsi.params.time_step
        fsi._time_loop(verbose=False, first_step=False)
        assert fsi.step_log[-1]["coupled"] is fused
        runs.append(fsi)
    a, b = runs
    assert rel_err(a.fluid.present_solution, b.fluid.present_solution) \
        <= 1e-10
    assert rel_err(a.solid.current_displacement,
                   b.solid.current_displacement) <= 1e-10
