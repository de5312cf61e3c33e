"""The reduction of a device trace and the roofline and idle-share
arithmetic, on a synthetic trace."""

from __future__ import annotations

import importlib

import pytest
import torch

import devtrace
import peaks


def metric(name):
    return importlib.import_module("metrics." + name).read


EVENTS = [("element_matvec_kernel<double>", 0.000, 0.002),
          ("gemv", 0.001, 0.002),             # overlaps: union 0.000-0.003
          ("Memcpy HtoD", 0.005, 0.001),      # gap 0.002 after gemv
          ("element_matvec_kernel<float>", 0.010, 0.004)]   # gap 0.004


def test_pb_reduce_union_gaps_and_kernels():
    r = devtrace.reduce(EVENTS)
    assert r["busy_s"] == pytest.approx(0.003 + 0.001 + 0.004)
    assert r["n_kernels"] == 3
    assert [g[1] for g in r["top_gaps"]] == pytest.approx([0.004, 0.002])
    assert r["top_gaps"][0][0] == "after Memcpy HtoD"
    assert r["top_ops"][0][0] == "element_matvec_kernel<float>"


def test_pb_idle_share_and_kernels_per_step():
    ctx = dict(plain_s=0.016, window_s=0.032, trace=devtrace.reduce(EVENTS),
               steps=[{}, {}])
    assert metric("device_idle_share")(ctx) == pytest.approx(50.0)
    assert metric("kernels_per_step")(ctx) == pytest.approx(1.5)
    ctx["trace"] = devtrace.reduce([])
    assert metric("device_idle_share")(ctx) is None
    assert metric("kernels_per_step")(ctx) is None


def test_pb_roofline():
    A = torch.zeros(10, 4, 4, dtype=torch.float64)
    rows = torch.zeros(10, 4, dtype=torch.int64)
    x = torch.zeros(20, dtype=torch.float64)
    t, nbytes = peaks.launch_bound(A, rows, rows, x, 20, 4, 4)
    # A, one table (rows is cols), x and y, each once
    assert nbytes == 10 * 16 * 8 + 40 * 8 + 40 * 8
    assert t == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    key = ("element_matvec", "float64", 10, 4, 4)
    ctx = dict(launches={key: 100}, launch_bounds={key: (t, nbytes)},
               trace=devtrace.reduce([("element_matvec_kernel<double>",
                                       0.0, 400 * t)]))
    assert metric("element_matvec_roofline")(ctx) == pytest.approx(25.0)
    ctx["launches"] = {}
    assert metric("element_matvec_roofline")(ctx) is None
