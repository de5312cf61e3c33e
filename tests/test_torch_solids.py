"""The port's linear and shared FE solids against the JAX package
(solvers/solid/{materials,linear,shared}.py), built in code for both:

- the linear elasticity and viscosity tensors: equal;
- LinearElasticity (Newmark), SharedLinearElasticity (HHT-alpha with
  damping 0.1, so that its two beta values differ) and SharedHyperElasticity
  (NeoHookean, Newmark + Newton), standalone for 3 steps on a 2-D beam
  clamped at x = 0 under gravity and an end traction: displacement,
  velocity and acceleration within 1e-10 of the reference's max norm, equal
  CG or Newton counts per step;
- SharedSolidMixin._fsi_traction_rhs on a moved mesh from seeded nodal
  stress rows, in 2-D and 3-D: within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.solvers.solid import materials as jax_materials
from openifem_tpu_torch.solvers.solid import materials as port_materials
from torch_parity import JAX, PORT, np_, rel_err


def solid_fields(dim=2, n_steps=3, simulation_type="Solid", **kw):
    """A small clamped beam: gravity and a traction on its free end."""
    dt = 1e-2
    f = dict(
        simulation_type=simulation_type, dimension=dim,
        global_refinements=[0, 0], end_time=n_steps * dt, time_step=dt,
        output_interval=1e9, refinement_interval=1e9, save_interval=1e9,
        gravity=[0.0, -9.8, 0.0][:dim], initial_velocity=[0.0] * dim,
        solid_degree=1, solid_type="LinearElastic", solid_rho=1.0,
        E=[1e4], nu=[0.3], eta=[5.0], damping=0.1, C=[[1e3, 1e4]],
        solid_max_iterations=8, tol_d=1e-10, tol_f=1e-10,
        n_solid_dirichlet_bcs=1, solid_dirichlet_bcs={0: (1 << dim) - 1},
        n_solid_neumann_bcs=1, solid_neumann_bc_type="Traction",
        solid_neumann_bcs={1: [0.0, -50.0, 0.0][:dim]})
    f.update(kw)
    return f


def beam(generators, dim=2):
    if dim == 2:
        return generators.subdivided_hyper_rectangle([8, 2], [0.0, 0.0],
                                                     [4.0, 1.0])
    return generators.subdivided_hyper_rectangle([2, 2, 2], [0.0] * 3,
                                                 [1.0] * 3)


def make(port, cls, dim=2, **fields):
    pkg = PORT if port else JAX
    p = pkg.AllParameters(**solid_fields(dim, **fields))
    kw = dict(device="cpu") if port else {}
    return getattr(pkg, cls)(beam(pkg.generators, dim), p, **kw)


def test_material_tensors_equal():
    for dim in (2, 3):
        assert np.array_equal(
            port_materials.linear_elasticity_tensor(1e4, 0.3, dim),
            jax_materials.linear_elasticity_tensor(1e4, 0.3, dim))
        assert np.array_equal(port_materials.viscosity_tensor(5.0, dim),
                              jax_materials.viscosity_tensor(5.0, dim))


# (class, solid type, the per-step count it keeps)
STANDALONE = [("LinearElasticity", "LinearElastic", "lin_iters"),
              ("SharedLinearElasticity", "LinearElastic", "lin_iters"),
              ("SharedHyperElasticity", "NeoHookean", "newton_iters")]


def _run_counting(solid, count):
    counts, real = [], solid.run_one_step

    def step(*a, **k):
        real(*a, **k)
        counts.append(int(getattr(solid, count)))
    solid.run_one_step = step
    solid.run()
    return counts


@pytest.mark.parametrize("cls,solid_type,count", STANDALONE)
def test_standalone_three_steps_match_jax(cls, solid_type, count, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(tmp_path)      # the first step writes VTU output
    jsol = make(False, cls, solid_type=solid_type)
    psol = make(True, cls, solid_type=solid_type)
    jc, pc = _run_counting(jsol, count), _run_counting(psol, count)
    assert pc == jc and len(pc) == 3
    if count == "lin_iters":
        assert min(pc) > 1
    if cls == "SharedLinearElasticity":
        assert psol._beta_a != psol._beta_r
    assert psol.time.get_timestep() == jsol.time.get_timestep() == 3
    for name in ("current_displacement", "current_velocity",
                 "current_acceleration"):
        assert rel_err(getattr(psol, name), getattr(jsol, name)) <= 1e-10
    assert np.abs(np_(psol.current_displacement)).max() > 1e-4


@pytest.mark.parametrize("dim", [2, 3])
def test_fsi_traction_rhs_on_moved_faces(dim):
    """_fsi_traction_rhs from seeded nodal stress rows on a mesh moved by
    a seeded displacement."""
    jsol = make(False, "SharedLinearElasticity", dim, simulation_type="FSI")
    psol = make(True, "SharedLinearElasticity", dim, simulation_type="FSI")
    jsol.setup()
    psol.setup()
    rng = np.random.default_rng(3)
    disp = 0.05 * rng.normal(size=jsol.n_dofs)
    rows = rng.normal(size=(jsol.space.n_nodes, dim, dim))
    jsol.current_displacement = jnp.asarray(disp)
    jsol.fsi_stress_rows = jnp.asarray(rows)
    psol.current_displacement = torch.as_tensor(disp)
    psol.fsi_stress_rows = torch.as_tensor(rows)
    ref = jsol._fsi_traction_rhs()
    got = psol._fsi_traction_rhs()
    assert np.abs(np_(ref)).max() > 0
    assert rel_err(got, ref) <= 1e-12
    # the orientation signs and the reference-configuration geometry
    assert np.array_equal(np_(psol._face_orient), np_(jsol._face_orient))
