"""The span metrics and spanrun.py's attribution of idle time, on
synthetic spans and device events, and a traced run on the CPU that
reads the span metrics from the program's tracer."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest

import spanrun
from conftest import REPO

SPAN_METRICS = ("assemble_ms_per_step", "precond_build_ms_per_step",
                "inner_a_ms_per_step", "sync_wait_ms_per_step",
                "setup_program_s")

# (name, start, end, parent): a step holding a Newton iteration, whose
# outer FGMRES holds an inner A-solve with one sync, then a second sync
SPANS = [("step", 10, 100, -1),
         ("newton", 12, 95, 0),
         ("outer_fgmres", 20, 90, 1),
         ("inner_a", 30, 60, 2),
         ("sync", 40, 50, 3),
         ("sync", 70, 80, 2)]
# (name, start, duration): busy 0-15, 22-38, 45-48, 52-75, 110-120
EVENTS = [("k1", 0, 15), ("k2", 22, 10), ("k3", 30, 8), ("k4", 45, 3),
          ("k5", 52, 23), ("k6", 110, 10)]


def metric(name):
    return importlib.import_module("metrics." + name).read


def test_pb_innermost_covers_the_window():
    segs = spanrun.innermost(SPANS, 0, 130)
    assert [(a, b, SPANS[i][0] if i >= 0 else None) for a, b, i in segs] \
        == [(0, 10, None), (10, 12, "step"), (12, 20, "newton"),
            (20, 30, "outer_fgmres"), (30, 40, "inner_a"), (40, 50, "sync"),
            (50, 60, "inner_a"), (60, 70, "outer_fgmres"), (70, 80, "sync"),
            (80, 90, "outer_fgmres"), (90, 95, "newton"), (95, 100, "step"),
            (100, 130, None)]


def test_pb_idle_by_span_sums_to_the_idle_time():
    by_span, gaps = spanrun.attribute_idle(EVENTS, SPANS, 0, 130)
    busy = sum(b - a for a, b, _ in spanrun.busy_union(EVENTS, 0, 130))
    assert busy == 15 + 16 + 3 + 23 + 10
    assert sum(by_span.values()) == pytest.approx(130 - busy)
    # idle 15-22: newton 15-20, outer_fgmres 20-22; 38-45: inner_a
    # 38-40, sync 40-45; 48-52: sync 48-50, inner_a 50-52; 75-110: sync
    # 75-80, outer_fgmres 80-90, newton 90-95, step 95-100, outside
    # 100-110; 120-130 outside
    assert by_span == pytest.approx({
        "newton": 5 + 5, "outer_fgmres": 2 + 10, "inner_a": 2 + 2,
        "sync": 5 + 2 + 5, "step": 5, spanrun.OUTSIDE: 10 + 10})
    # the gaps between operations, longest first, named by the two
    # innermost spans open at their start and the operation before them
    assert gaps == [["outer_fgmres>sync after k5", 35],
                    ["step>newton after k1", 7],
                    ["outer_fgmres>inner_a after k3", 7],
                    ["inner_a>sync after k4", 4]]


def test_pb_gap_outside_every_span():
    by_span, gaps = spanrun.attribute_idle([("a", 0, 5), ("b", 9, 1)], [],
                                           0, 10)
    assert by_span == {spanrun.OUTSIDE: 4}
    assert gaps == [[f"{spanrun.OUTSIDE} after a", 4]]


def test_pb_inclusive_counts_a_name_inside_itself_once():
    spans = [("a", 0, 10, -1), ("a", 2, 5, 0), ("b", 3, 4, 1),
             ("a", 20, 25, -1)]
    assert spanrun.inclusive_ns(spans, "a") == 15
    assert spanrun.inclusive_ns(spans, "b") == 1
    assert spanrun.inclusive_ns(spans, "c") == 0


def test_pb_span_metrics_read_the_summary():
    summary = dict(steps=[[3, {}], [3, {}]], setup_program_s=12.5,
                   inclusive_ns=dict(assemble=40_000_000,
                                     precond_build=20_000_000,
                                     inner_a=3_000_000_000,
                                     sync=100_000_000))
    ctx = dict(spans=summary)
    got = {name: metric(name)(ctx) for name in SPAN_METRICS}
    assert got == pytest.approx(dict(
        assemble_ms_per_step=20.0, precond_build_ms_per_step=10.0,
        inner_a_ms_per_step=1500.0, sync_wait_ms_per_step=50.0,
        setup_program_s=12.5))
    summary["inclusive_ns"] = {}
    summary["setup_program_s"] = 0.0
    assert all(metric(name)(ctx) is None for name in SPAN_METRICS)


def test_pb_span_metrics_without_a_command_line(monkeypatch):
    """Called where the process's command line names no workload (a test
    driving run.main), the metrics read nothing and spawn nothing."""
    monkeypatch.setattr(sys, "argv", ["-c"])
    monkeypatch.setattr(spanrun, "_spawn", lambda *a: pytest.fail("spawned"))
    assert all(metric(name)(dict(steps=[])) is None
               for name in SPAN_METRICS)


def test_pb_traced_run_reads_the_spans_on_the_cpu(tree):
    """A traced run whose command line names the cell, as the benchmark's
    does, reads the five span metrics from spanrun.py's own process."""
    argv = ["port_bench/run.py", "--workload", "cylinder_tiny", "--seed",
            "2147483659", "--seconds", "1", "--trace", "1"]
    code = ("import sys\nsys.path.insert(0, 'port_bench')\n"
            f"sys.argv = {argv!r}\nimport run\n"
            "sys.exit(run.main(sys.argv[1:], device='cpu'))\n")
    env = dict(os.environ, OPENIFEM_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    p = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads([ln for ln in p.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert out["correct"]
    m = out["metrics"]
    for name in SPAN_METRICS:
        assert m[name]["value"] > 0, name
    assert m["inner_a_ms_per_step"]["value"] > \
        m["sync_wait_ms_per_step"]["value"]
    assert "the tracer's replay, per step" in p.stderr
