"""The 3-D cell (dfg_cylinder_3d) on the CPU: a tiny copy of it, the 3-D
channel at refine 0 with one step, runs correct through run.py at --trace
0 and 1 and reports the cell's metrics and no other; the roofline's
arithmetic on plain numbers; the frozen 3-D generator gives the port's
mesh; the float32 control is not correct.

The control at another size, as a script:
    python3 port_bench/tests/test_pb_cylinder3d.py --refine 0 --seeds 11
prints, per seed, the numbers the comparison gives the control and their
limits, one JSON line each.  The reference's direct solves reach refine 0
in about 20 s; at refine 1 (185,998 DoF) SuperLU's factors outgrow 16 GB
and 25 minutes without finishing.  So at the cell's own size the control
is the program's states rounded to float32, the precision below the
float64 that the configuration states for the state:
    python3 port_bench/tests/test_pb_cylinder3d.py --program --refine 2 \
        --seeds 11 12 13
runs the cell's case (its mix and knobs, on the card where there is one)
through the host first step and one segment, and prints per seed the
numbers the comparison gives its states as they are and rounded."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE),
                os.path.dirname(os.path.dirname(HERE))]

from conftest import BENCH, REPO, make_tree  # noqa: E402

CELL = "cylinder3d_r2"
TINY = "cylinder3d_tiny"
NEW_METRICS = ("element_matvec_3d_roofline", "assemble_3d_ms_per_step",
               "inner_a_3d_ms_per_step")


def tiny_mix():
    """The cell's mix at refine 0 with one step and the element A-solve
    (the 3-D stencil's apply is slow on a CPU;
    tests/test_torch_cylinder3d.py holds it to the element operator)."""
    with open(os.path.join(BENCH, "mixes", "r2_3d_seg3.json")) as f:
        mix = json.load(f)
    mix.update(refine=0, segment_steps=1,
               knobs=dict(mix["knobs"], a_stencil=False))
    return mix


def config():
    with open(os.path.join(BENCH, "configs", "dfg_cylinder_3d.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tree3d(tmp_path_factory):
    """A checkout with the tiny 3-D cell added, listed by the cell's
    metrics."""
    root = make_tree(str(tmp_path_factory.mktemp("tree3d")))
    with open(os.path.join(root, "port_bench", "mixes", TINY + ".json"),
              "w") as f:
        json.dump(tiny_mix(), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name=TINY, config="dfg_cylinder_3d",
                                   traffic=TINY, chips=1, why="test"))
    for m in bench["per_layer"]:
        if CELL in m["workloads"]:
            m["workloads"].append(TINY)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_named(root, trace):
    """run.py's main on the CPU with a command line that names the cell,
    as the benchmark's does (the span metrics read it): (exit code, last
    JSON line, standard error)."""
    argv = ["port_bench/run.py", "--workload", TINY, "--seed", "2147483671",
            "--seconds", "1", "--trace", str(trace)]
    code = ("import sys\nsys.path.insert(0, 'port_bench')\n"
            f"sys.argv = {argv!r}\nimport run\n"
            "sys.exit(run.main(sys.argv[1:], device='cpu'))\n")
    env = dict(os.environ, OPENIFEM_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=900)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


def test_pb_cylinder3d_untraced_run_is_correct(tree3d):
    rc, out, err = run_named(tree3d, 0)
    assert rc == 0, err[-3000:]
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert 0 < out["checks"]["fluid_res"]["value"] <= 1e-6


def test_pb_cylinder3d_traced_run_reports_its_metrics(tree3d):
    """The cell reports its three metrics and none of the 2-D cells'; off
    the card there is no device trace, so the roofline is left out."""
    rc, out, err = run_named(tree3d, 1)
    assert rc == 0, err[-3000:]
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert set(m) == set(NEW_METRICS) - {"element_matvec_3d_roofline"}
    for name in ("assemble_3d_ms_per_step", "inner_a_3d_ms_per_step"):
        assert m[name]["value"] > 0, name


def test_pb_3d_roofline_arithmetic(monkeypatch):
    import importlib

    import devtrace
    import peaks
    import sized_bound
    key = ("element_matvec_taylor_hood", "float32", 10, 89, 89)
    sizes = dict(cells=10, nr=89, nc=89, a_elem_bytes=4, table_numel=890,
                 table_elem_bytes=4, x_numel=500, x_elem_bytes=4, n_out=500)
    nbytes = 10 * 89 * 89 * 4 + 890 * 4 + 1000 * 4
    t, b = sized_bound.least_seconds(key, sizes)
    assert b == nbytes
    assert t == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    # flops bound where they take longer: 2 * 10 * 89 * 89 against bytes
    # made few
    few = dict(sizes, a_elem_bytes=0, table_numel=0, x_numel=0, n_out=0)
    assert sized_bound.least_seconds(key, few)[0] == pytest.approx(
        2 * 10 * 89 * 89 / peaks.PEAK_FLOPS["float32"])
    read = importlib.import_module("metrics.element_matvec_3d_roofline").read
    ctx = dict(launches={key: 100}, trace=devtrace.reduce(
        [("element_matvec_kernel<float, 32, 3>", 0.0, 400 * t)]))
    monkeypatch.setattr(sized_bound, "program_sizes", lambda: {key: sizes})
    assert read(ctx) == pytest.approx(25.0)
    # a key launched only in replayed graphs has its sizes all the same
    other = ("element_matvec", "float32", 10, 8, 8)
    monkeypatch.setattr(sized_bound, "program_sizes", lambda: {
        key: sizes, other: dict(sizes, nr=8, nc=8)})
    ctx["launches"][other] = 50
    t8 = sized_bound.least_seconds(other, dict(sizes, nr=8, nc=8))[0]
    assert read(ctx) == pytest.approx(100 * (100 * t + 50 * t8) / (400 * t))
    # a program without the table, or no kernel in the trace: nothing
    monkeypatch.setattr(sized_bound, "program_sizes", lambda: None)
    assert read(ctx) is None
    monkeypatch.setattr(sized_bound, "program_sizes", lambda: {key: sizes})
    ctx["trace"] = devtrace.reduce([])
    assert read(ctx) is None


@pytest.mark.parametrize("refine", [0, 1])
def test_pb_frozen_3d_mesh_is_the_ports(refine):
    from openifem_tpu_torch.mesh import generators

    from reference.frozen_mesh import cylinder3d
    a = cylinder3d.refine_global_3d(cylinder3d.flow_around_cylinder_3d(),
                                    refine)
    b = generators.flow_around_cylinder(3).refine_global(refine)
    for name in ("vertices", "cells", "boundary_id", "material_id"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def control_numbers(refine, seed):
    import torch

    import traffic
    from reference import dfg_cylinder_3d as reference
    cfg = config()
    mix = dict(tiny_mix(), refine=refine)
    draw = traffic.draw(mix, seed)
    lay, states = reference.run(cfg, mix, draw, dtype=torch.float32)
    return reference.check(cfg, mix, draw, lay, states), mix["limits"]


def failed(numbers, limits):
    return sorted(k for k, v in numbers.items()
                  if k in limits and v > limits[k])


def test_pb_cylinder3d_control_is_not_correct():
    numbers, limits = control_numbers(0, 5)
    assert failed(numbers, limits), numbers


def rounded(state):
    """A state in the reference's terms rounded to float32."""
    return {k: v.astype(np.float32).astype(np.float64)
            for k, v in state.items()}


def program_numbers(mix, seed, device):
    """The program's run of the cell's case with `mix` (the host first
    step and one segment), judged by the reference as it is and with its
    states rounded to float32: (numbers, rounded numbers)."""
    import traffic
    from configs import dfg_cylinder_3d as module
    from reference import dfg_cylinder_3d as reference
    cfg = config()
    draw = traffic.draw(mix, seed)
    case = module.Case(cfg, mix, draw, device)
    case.first_step()
    first = case.state()
    _, states = case.segment()
    judged = [case.host(s) for s in [first] + states]
    lay = case.layout()
    case.free()
    del case, first, states
    return (reference.check(cfg, mix, draw, lay, judged),
            reference.check(cfg, mix, draw, lay, [rounded(s)
                                                  for s in judged]))


def test_pb_cylinder3d_rounded_program_is_not_correct():
    """The program's own states are correct; rounded to float32 they are
    not."""
    mix = tiny_mix()
    numbers, control = program_numbers(mix, 2147483659, "cpu")
    assert not failed(numbers, mix["limits"]), numbers
    assert failed(control, mix["limits"]), control


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--refine", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="judge the program's run of the cell's mix at "
                         "--refine, and its states rounded to float32")
    args = ap.parse_args(argv)
    if args.program:
        import torch
        device = "cuda" if torch.cuda.is_available() else "cpu"
        with open(os.path.join(BENCH, "mixes", "r2_3d_seg3.json")) as f:
            mix = dict(json.load(f), refine=args.refine)
    for seed in args.seeds:
        if args.program:
            numbers, control = program_numbers(mix, seed, device)
            print(json.dumps(dict(refine=args.refine, seed=seed,
                                  device=device, program=numbers,
                                  rounded=control, limits=mix["limits"],
                                  failed=failed(control, mix["limits"]))),
                  flush=True)
            continue
        numbers, limits = control_numbers(args.refine, seed)
        print(json.dumps(dict(refine=args.refine, seed=seed,
                              control=numbers, limits=limits,
                              failed=failed(numbers, limits))), flush=True)


if __name__ == "__main__":
    main()
