"""Shared helpers of the benchmark's CPU tests: a copy of the benchmark
with two tiny cells, and a runner that drives run.py on the CPU in a
fresh process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for path in (BENCH, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)
os.environ.setdefault("OPENIFEM_DEVICE", "cpu")

# tiny versions of the mixes: the coarse leaflet (h = 0.1; its
# configuration waits for its parameter file and runs in no cell of
# BENCHMARK.json, so the copy adds its entry), the cylinder at refine 1 on
# r3's path and at refine 2 on r4's (mg_direct)
TINY = {"leaflet_tiny": ("fsi_leaflet", "path_a_seg8",
                         dict(h=0.1, segment_steps=2)),
        "cylinder_tiny": ("dfg_cylinder", "r3_seg3",
                          dict(refine=1, segment_steps=2)),
        "cylinder_mg_tiny": ("dfg_cylinder", "r4_seg3",
                             dict(refine=2, segment_steps=2))}


def tiny_mix(workload):
    config, mix_name, change = TINY[workload]
    with open(os.path.join(BENCH, "mixes", mix_name + ".json")) as f:
        mix = json.load(f)
    mix.update(change)
    return config, mix


def make_tree(root):
    """A checkout of the benchmark at `root`: BENCHMARK.json and
    port_bench/, with the tiny cells added as new files and entries."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in TINY:
        config, mix = tiny_mix(name)
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(dict(
                name=config, source="test", reduced=[], why="test",
                file=f"port_bench/configs/{config}.json"))
        with open(os.path.join(root, "port_bench", "mixes",
                               name + ".json"), "w") as f:
            json.dump(mix, f)
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=name, chips=1, why="test"))
        for m in bench["per_layer"]:
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tree(tmp_path):
    return make_tree(str(tmp_path))


def run_cell(root, workload, seed=2147483659, trace=0, prelude=""):
    """run.py's main on the CPU in a fresh process from the checkout at
    `root`, after `prelude` (code that may patch the program): (exit
    code, last JSON line or None, standard error)."""
    code = (prelude + "\nimport sys\nsys.path.insert(0, 'port_bench')\n"
            "import run\n"
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '1', '--trace', '{trace}'], "
            "device='cpu'))\n")
    env = dict(os.environ, OPENIFEM_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr
