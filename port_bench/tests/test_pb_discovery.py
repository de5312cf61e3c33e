"""A configuration, a mix and a per-layer metric are added as new files
and entries, with no edit to a file the benchmark has."""

from __future__ import annotations

import json
import os
import shutil

from conftest import run_cell


def test_pb_added_files_are_found(tree):
    pb = os.path.join(tree, "port_bench")
    # a new configuration: its file, builder and reference, copies of the
    # cylinder's under a new name
    for sub, ext in (("configs", ".json"), ("configs", ".py"),
                     ("reference", ".py")):
        shutil.copy(os.path.join(pb, sub, "dfg_cylinder" + ext),
                    os.path.join(pb, sub, "cylinder_copy" + ext))
    with open(os.path.join(pb, "configs", "cylinder_copy.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "cylinder_copy"
    with open(os.path.join(pb, "configs", "cylinder_copy.json"), "w") as f:
        json.dump(cfg, f)
    # a new mix: the tiny cylinder with one step
    with open(os.path.join(pb, "mixes", "cylinder_tiny.json")) as f:
        mix = json.load(f)
    mix["segment_steps"] = 1
    with open(os.path.join(pb, "mixes", "one_step.json"), "w") as f:
        json.dump(mix, f)
    # a new per-layer metric
    with open(os.path.join(pb, "metrics", "steps_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx['steps']))\n")
    with open(os.path.join(tree, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="cylinder_copy", source="test",
                                 file="port_bench/configs/cylinder_copy.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="added", config="cylinder_copy",
                                   traffic="one_step", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="steps_traced", unit="steps", better="higher",
        source="program_counter", layer="fluid solver", moves="step_ms",
        workloads=["added"]))
    with open(os.path.join(tree, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    rc, out, err = run_cell(tree, "added", trace=1)
    assert rc == 0, err[-3000:]
    assert out["correct"], out
    # the cell reports the per-layer metrics that list it, and no other
    assert out["metrics"] == {"steps_traced": {"value": 1.0,
                                               "unit": "steps"}}
    rc, out, err = run_cell(tree, "added", trace=0)
    assert rc == 0 and out["correct"], err[-3000:]
    assert set(out["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}


def test_pb_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and port_bench/ gives no
    result and a non-zero exit."""
    from conftest import BENCH, REPO
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, os.path.join(tmp_path, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "cylinder_r3",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
