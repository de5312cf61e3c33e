"""Snapshot and replay on the CPU at the coarse leaflet (h = 0.1) with
path A's knobs: every replay repeats the first pass's counts and its
final state to the bit."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from conftest import BENCH, tiny_mix


@pytest.mark.parametrize("workload", ["leaflet_tiny", "cylinder_tiny"])
def test_pb_replays_repeat(workload):
    import run
    import traffic
    config_name, mix = tiny_mix(workload)
    with open(os.path.join(BENCH, "configs", config_name + ".json")) as f:
        cfg = json.load(f)
    config = importlib.import_module("configs." + config_name)
    case = config.Case(cfg, mix, traffic.draw(mix, 7), "cpu")
    case.first_step()
    snap = case.snapshot()
    first, states = case.segment()
    final = case.host(states[-1])
    for _ in range(2):
        case.restore(snap)
        again, states = case.segment()
        assert run.counts(again) == run.counts(first)
        replayed = case.host(states[-1])
        for k, v in final.items():
            assert np.array_equal(v, replayed[k]), k
