"""The stand-in physics of openifem_tpu_torch.cases.fsi_leaflet hold on the
JAX package: the coarse case runs 10 steps (host first step + 9 fused
coupled steps) without a Newton or cell-hash-capacity error, and the
leaflet is pushed downstream as in tests/test_fsi.py."""

import dataclasses

import numpy as np

import openifem_tpu
from openifem_tpu_torch.cases import fsi_leaflet
from torch_parity import leaflet_fsi


def test_fields_build_parameters_in_both_packages():
    import openifem_tpu_torch
    f = fsi_leaflet.leaflet_fields()
    p, q = openifem_tpu.AllParameters(**f), openifem_tpu_torch.AllParameters(
        **f)
    assert dataclasses.asdict(p) == dataclasses.asdict(q)
    assert p.global_refinements == [0, 2] and p.C == [[1e5, 1e6]]
    assert abs(p.end_time - 0.05) < 1e-15 and p.time_step == 5e-3
    pts = np.array([[0.0, 0.5], [0.0, 0.0], [1.0, 0.5]])
    np.testing.assert_allclose(fsi_leaflet.inflow(pts, 0), [1.5, 0.0, 0.0])
    np.testing.assert_array_equal(fsi_leaflet.inflow(pts, 1), 0.0)


def test_stand_in_case_runs_ten_steps_on_jax():
    fsi = leaflet_fsi(False, n_steps=10)
    fsi.run(verbose=False)
    assert fsi.time.get_timestep() == 10
    u = fsi.fluid.velocity_part()
    d = np.asarray(fsi.solid.current_displacement).reshape(-1, 2)
    assert np.isfinite(u).all() and np.isfinite(d).all()
    assert 1e-4 < d[:, 0].max() < 0.5
