"""The port's meshfree RKPM solid (solvers/solid/hypo.py) against the JAX
package:

- rkpm_shapes and rkpm_shapes_sparse: equal to the JAX package's, and
  reproducing 1 and x to 1e-10 (values) and the gradient of x to 1e-10;
- HypoElasticity falling under gravity with an end traction, 3 steps in
  2-D and in 3-D: particle positions, velocities and quadrature stresses
  within 1e-12 of the reference's max norm;
- SharedHypoElasticity's _fsi_traction_q_impl, _nodal_stress_impl and
  _device_step_impl from one seeded state: within 1e-12;
- the f32_rates knob (rates in f32, state and RK4 sums in f64): within
  1e-5 of the JAX package's f32 rates, and of the f64 step; the
  acceleration, which is the rates alone, within 1e-6 of the JAX
  package's f32 result and off the f64 step by more than f64 rounding,
  and every rate the RK4 stages take is an f32 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.solvers.solid import hypo as jax_hypo
from openifem_tpu_torch import interop
from openifem_tpu_torch.solvers.solid import hypo as port_hypo
from torch_parity import JAX, PORT, np_, rel_err


def hypo_fields(dim, n_steps=3, simulation_type="Solid"):
    dt = 1e-4
    return dict(
        simulation_type=simulation_type, dimension=dim,
        global_refinements=[0, 0], end_time=n_steps * dt, time_step=dt,
        output_interval=1e9, refinement_interval=1e9, save_interval=1e9,
        gravity=[0.0, -9.8, 0.0][:dim], initial_velocity=[0.0] * dim,
        solid_degree=1, solid_type="LinearElastic", solid_rho=1.0,
        E=[1e5], nu=[0.3], n_solid_neumann_bcs=1,
        solid_neumann_bc_type="Traction",
        solid_neumann_bcs={1: [0.0, -2e3, 0.0][:dim]})


def block(generators, dim):
    reps = [4, 3] if dim == 2 else [3, 2, 2]
    return generators.subdivided_hyper_rectangle(reps, [0.0] * dim,
                                                 [1.0] * dim)


def make(port, cls, dim, **kw):
    pkg = PORT if port else JAX
    p = pkg.AllParameters(**hypo_fields(dim, **kw))
    dev = dict(device="cpu") if port else {}
    extra = dict(dx=0.25, hdx=1.3) if cls == "SharedHypoElasticity" else {}
    return getattr(pkg, cls)(block(pkg.generators, dim), p, **extra, **dev)


@pytest.mark.parametrize("dim", [2, 3])
def test_rkpm_shapes_match_and_reproduce_linears(dim):
    rng = np.random.default_rng(1)
    particles = rng.random((60, dim))
    points = 0.2 + 0.6 * rng.random((25, dim))
    h = 0.35
    psi, dpsi = port_hypo.rkpm_shapes(points, particles, h)
    jpsi, jdpsi = jax_hypo.rkpm_shapes(points, particles, h)
    assert np.array_equal(psi, jpsi) and np.array_equal(dpsi, jdpsi)
    idx, spsi, sdpsi = port_hypo.rkpm_shapes_sparse(points, particles, h,
                                                    chunk=7)
    jidx, jspsi, jsdpsi = jax_hypo.rkpm_shapes_sparse(points, particles, h,
                                                      chunk=7)
    assert np.array_equal(idx, jidx) and np.array_equal(spsi, jspsi)
    assert np.array_equal(sdpsi, jsdpsi)
    # dense over all particles; sparse over each point's K neighbours
    xk = particles[idx]
    for ones, lin, grad in (
            (psi.sum(axis=1), psi @ particles,
             np.einsum("qpj,pd->qdj", dpsi, particles)),
            (spsi.sum(axis=1), np.einsum("qk,qkd->qd", spsi, xk),
             np.einsum("qkj,qkd->qdj", sdpsi, xk))):
        assert np.abs(ones - 1).max() <= 1e-10
        assert np.abs(lin - points).max() <= 1e-10
        assert np.abs(grad - np.eye(dim)).max() <= 1e-10


@pytest.mark.parametrize("dim", [2, 3])
def test_free_fall_three_steps(dim, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the first step writes VTU output
    jsol, psol = make(False, "HypoElasticity", dim), \
        make(True, "HypoElasticity", dim)
    jsol.run()
    psol.run()
    assert psol.time.get_timestep() == jsol.time.get_timestep() == 3
    for name in ("x", "v", "sigma", "current_displacement",
                 "current_acceleration"):
        assert rel_err(getattr(psol, name), getattr(jsol, name)) <= 1e-12
    assert np.abs(np_(psol.sigma)).max() > 1.0      # the traction loads it


def _seeded_shared(dim, f32_rates=False):
    jsol = make(False, "SharedHypoElasticity", dim, simulation_type="FSI")
    psol = make(True, "SharedHypoElasticity", dim, simulation_type="FSI")
    jsol.setup()
    psol.setup()
    jsol.f32_rates = psol.f32_rates = f32_rates
    rng = np.random.default_rng(7)
    jsol.x = jsol.x + jnp.asarray(0.01 * rng.normal(size=jsol.x.shape))
    jsol.v = jnp.asarray(0.1 * rng.normal(size=jsol.v.shape))
    jsol.sigma = jnp.asarray(50.0 * rng.normal(size=jsol.sigma.shape))
    jsol.fsi_stress_rows = jnp.asarray(
        1e2 * rng.normal(size=jsol.fsi_stress_rows.shape))
    interop.load_solid_state(psol, interop.solid_state(jsol))
    return jsol, psol


@pytest.mark.parametrize("dim", [2, 3])
def test_shared_pieces_from_seeded_state(dim):
    jsol, psol = _seeded_shared(dim)
    ref = jsol._fsi_traction_q_impl(jsol.x, jsol.fsi_stress_rows)
    got = psol._fsi_traction_q_impl(psol.x, psol.fsi_stress_rows)
    assert rel_err(got, ref) <= 1e-12
    assert rel_err(psol._nodal_stress_impl(psol.sigma),
                   jsol._nodal_stress_impl(jsol.sigma)) <= 1e-12
    jout = jsol._device_step_impl(jsol.x, jsol.v, jsol.sigma,
                                  jsol.fsi_stress_rows)
    pout = psol._device_step_impl(psol.x, psol.v, psol.sigma,
                                  psol.fsi_stress_rows)
    for got, ref in zip(pout, jout):
        assert rel_err(got, ref) <= 1e-12
    # the moved particles are the coupler's vertex coordinates
    assert psol.moved_vertex_coords() is psol.x


def test_f32_rates():
    jsol, psol = _seeded_shared(3, f32_rates=True)
    args = lambda s: (s.x, s.v, s.sigma, s.fsi_stress_rows)  # noqa: E731
    jout = jsol._device_step_impl(*args(jsol))
    pout = psol._device_step_impl(*args(psol))
    psol.f32_rates = False
    p64 = psol._device_step_impl(*args(psol))
    for got, ref, full in zip(pout, jout, p64):
        assert got.dtype == torch.float64
        assert rel_err(got, ref) <= 1e-5
        assert rel_err(got, full) <= 1e-5
    # the acceleration is the last stage's rate alone: computed in f32, it
    # agrees with the JAX package's f32 rates and not with the f64 ones
    assert rel_err(pout[3], jout[3]) <= 1e-6
    assert rel_err(pout[3], p64[3]) > 1e-10
    # and every stage's rates are f32 values handed back in f64
    psol.f32_rates = True
    rates, seen = psol._rates, []

    def spy(*a, **kw):
        out = rates(*a, **kw)
        seen.extend(out)
        return out
    psol._rates = spy
    psol._device_step_impl(*args(psol))
    assert len(seen) == 8
    for r in seen:
        assert r.dtype == torch.float64
        assert torch.equal(r.to(torch.float32).to(torch.float64), r)
