"""The control: the reference put in the program's place and computed in
float32, the precision below the float64 that the configurations state
for the state and the residual.  It has to come out as not correct.

On the CPU at the coarse sizes as a test; at a cell's own size, over
seeds, as a script (on the chip's host):
    python3 port_bench/tests/test_pb_control.py --workload cylinder_r3 \\
        --seeds 11 12 13
prints, per seed, the numbers the comparison gives the control and their
limits, one JSON line each."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def control_numbers(cfg, mix, seed):
    import importlib

    import traffic
    reference = importlib.import_module("reference." + cfg["name"])
    draw = traffic.draw(mix, seed)
    lay, states = reference.run(cfg, mix, draw, dtype=torch.float32)
    return reference.check(cfg, mix, draw, lay, states)


def failed(numbers, limits):
    return sorted(k for k, v in numbers.items()
                  if k in limits and v > limits[k])


@pytest.mark.parametrize("workload", ["leaflet_tiny", "cylinder_tiny"])
def test_pb_control_is_not_correct(workload):
    from conftest import BENCH, tiny_mix
    config_name, mix = tiny_mix(workload)
    with open(os.path.join(BENCH, "configs", config_name + ".json")) as f:
        cfg = json.load(f)
    numbers = control_numbers(cfg, mix, 5)
    assert failed(numbers, mix["limits"]), numbers


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import run
    _, cell, entry, cfg, mix = run.load_cell(args.workload)
    for seed in args.seeds:
        numbers = control_numbers(cfg, mix, seed)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=numbers, limits=mix["limits"],
                              failed=failed(numbers, mix["limits"]))),
              flush=True)


if __name__ == "__main__":
    main()
