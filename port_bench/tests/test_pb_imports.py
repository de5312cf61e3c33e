"""Nothing the harness, the configurations' builders, the metrics or the
reference import has jax, jaxlib, flax or openifem_tpu as its top-level
name (openifem_tpu_torch begins with openifem_tpu and is not it); the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os

from conftest import BENCH, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "openifem_tpu", "bench", "chip_smoke",
             "tools"}


def imported(path):
    """Top-level names of every module a source file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_pb_no_forbidden_imports_in_sources():
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_pb_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "openifem_tpu_torch" not in imported(path), path


def test_pb_run_loads_no_jax(tree):
    """A whole run on the CPU: the process that prints the result holds
    none of the forbidden modules (run.py exits with code 4 where it
    does)."""
    rc, out, err = run_cell(tree, "cylinder_tiny")
    assert rc == 0, err[-3000:]
    assert out["correct"]


def test_pb_run_refuses_when_jax_is_loaded(tree):
    rc, out, err = run_cell(
        tree, "cylinder_tiny",
        prelude="import sys, types\nsys.modules['jax'] = "
                "types.ModuleType('jax')")
    assert rc == 4 and out is None
    assert "jax" in err
