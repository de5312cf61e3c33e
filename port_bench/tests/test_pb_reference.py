"""The plain reference against the port on the CPU at the coarse sizes:
the port's runs pass the comparison, and the reference's own runs from
rest reach the port's states."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from conftest import BENCH, run_cell, tiny_mix


@pytest.mark.parametrize("workload", ["leaflet_tiny", "cylinder_tiny",
                                      "cylinder_mg_tiny"])
def test_pb_port_passes_the_comparison(tree, workload):
    rc, out, err = run_cell(tree, workload)
    assert rc == 0, err[-3000:]
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["fluid_res"]["value"] > 0


def port_and_reference(workload, knobs=None):
    import traffic
    config_name, mix = tiny_mix(workload)
    if knobs is not None:
        mix["knobs"] = knobs
    with open(os.path.join(BENCH, "configs", config_name + ".json")) as f:
        cfg = json.load(f)
    config = importlib.import_module("configs." + config_name)
    draw = traffic.draw(mix, 11)
    case = config.Case(cfg, mix, draw, "cpu")
    case.first_step()
    _, states = case.segment()
    reference = importlib.import_module("reference." + config_name)
    lay, ref_states = reference.run(cfg, mix, draw)
    return case.layout(), case.host(states[-1]), lay, ref_states[-1]


def gap(points, values, ref_points, ref_values):
    from reference.fem import match
    idx = match(points, ref_points)
    return np.abs(values - ref_values[idx]).max() / np.abs(ref_values).max()


def test_pb_cylinder_reaches_the_reference():
    lay, st, rlay, rst = port_and_reference("cylinder_tiny")
    assert gap(lay["u_points"], st["u"], rlay["u_points"], rst["u"]) < 1e-7
    assert gap(lay["p_points"], st["p"], rlay["p_points"], rst["p"]) < 1e-5


def test_pb_leaflet_reaches_the_reference():
    """In float64 throughout (the element branch), where the port's Newton
    solves are tight, both solids agree to 1e-8."""
    lay, st, rlay, rst = port_and_reference("leaflet_tiny",
                                            knobs={"a_stencil": False})
    for key, pts in (("u", "u_points"), ("p", "p_points"),
                     ("d", "solid_points"), ("v", "solid_points"),
                     ("traction", "face_centers")):
        assert gap(lay[pts], st[key], rlay[pts], rst[key]) < 1e-8, key
    from reference.fem import match
    idx = match(lay["cell_centers"], rlay["cell_centers"])
    assert np.array_equal(st["indicator"], rst["indicator"][idx])


def test_pb_traced_run_on_the_cpu(tree):
    """A traced run judges its replay alike and reads the counters; with
    no device trace off the card the kernel and device metrics are left
    out, never 0."""
    rc, out, err = run_cell(tree, "leaflet_tiny", trace=1)
    assert rc == 0, err[-3000:]
    assert out["correct"]
    m = out["metrics"]
    assert m["newton_per_step"]["value"] >= 1
    assert m["krylov_inner_per_step"]["value"] > 0
    for name in ("kernels_per_step", "element_matvec_roofline",
                 "device_idle_share"):
        assert name not in m
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
