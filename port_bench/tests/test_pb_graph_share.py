"""krylov_graph_share on synthetic counters: graph iterations over graph
and eager ones, and nothing where the program counts neither (a program
without the iteration blocks, or a run off the card)."""

from __future__ import annotations

import importlib

import pytest

read = importlib.import_module("metrics.krylov_graph_share").read


@pytest.mark.parametrize("counts,share", [
    ({"krylov.graph_iters": 1062, "krylov.eager_iters": 0}, 100.0),
    ({"krylov.graph_iters": 300, "krylov.eager_iters": 100}, 75.0),
    ({"krylov.eager_iters": 50}, 0.0),
    ({"sync.cg_test": 10}, None),
    ({}, None),
])
def test_pb_graph_share_reads_the_counters(counts, share):
    got = read(dict(spans=dict(steps=[[3, {}]], sync_counts=counts)))
    assert got == (share if share is None else pytest.approx(share))


def test_pb_graph_share_without_spans(monkeypatch):
    import spanrun
    monkeypatch.setattr(spanrun, "context", lambda ctx: None)
    assert read({}) is None
