"""The stencil kernel's roofline share (metrics/stencil_roofline.py) on
synthetic launches and traces: the byte count at the 3-D cell's group,
N(k, m), a program without stencil_sizes, and the element-matvec 3-D
metric, which ignores stencil keys."""

from __future__ import annotations

import importlib

import pytest

import peaks
import sized_bound

roofline = importlib.import_module("metrics.stencil_roofline")

# the 3-D cell's group at refinement 2: 832 z-order patches of 4^3 Q2
# cells (13^3 bordered slots, 9^3 nodes), 3 x 3 blocks, f32
KEY = ("stencil_apply", "float32", 832, (13, 13, 13), 2, 3, 3)
SIZES = dict(n_b=832, m=(4, 4, 4), G=(9, 9, 9), k=2, d_out=3, d_in=3,
             w_elem_bytes=4, x_elem_bytes=4)
ELEMENT = ("element_matvec_taylor_hood", "float32", 53248, 89, 89)


def test_pb_nonzero_pairs():
    assert roofline.nonzero_pairs(2, 4) == 33
    # Q1, 3 cells: the two inner nodes couple to three nodes each, the
    # two end nodes to two
    assert roofline.nonzero_pairs(1, 3) == 2 * 3 + 2 * 2


def test_pb_stencil_bytes_at_the_3d_cell():
    t, nbytes = roofline.least_seconds(KEY, SIZES)
    assert 33 ** 3 * 9 * 832 * 4 == 1_076_385_024
    assert 6 * 832 * 9 ** 3 * 4 == 14_556_672
    assert nbytes == 1_076_385_024 + 14_556_672
    assert t == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    assert 1e3 * t == pytest.approx(0.3257, abs=5e-5)


def _ctx(launches, seconds):
    return dict(launches=launches, trace={"by_name": {
        "void (anonymous namespace)::stencil_apply_kernel<float, 5, 3, 3>"
        "(float const*, long long, ...)": seconds,
        "void element_matvec_kernel<float, 32, 3>(...)": 0.5}})


def test_pb_stencil_roofline_reads_the_table(monkeypatch):
    monkeypatch.setattr(roofline, "program_sizes", lambda: {KEY: SIZES})
    t = roofline.least_seconds(KEY, SIZES)[0]
    got = roofline.read(_ctx({KEY: 10, ELEMENT: 40}, 10 * t / 0.25))
    assert got == pytest.approx(25.0)


def test_pb_stencil_roofline_none_without_sizes(monkeypatch):
    monkeypatch.setattr(roofline, "program_sizes", lambda: None)
    assert roofline.read(_ctx({KEY: 10}, 0.01)) is None
    monkeypatch.setattr(roofline, "program_sizes", lambda: {})
    assert roofline.read(_ctx({KEY: 10}, 0.01)) is None
    # sizes, but no stencil launch in the replay
    monkeypatch.setattr(roofline, "program_sizes", lambda: {KEY: SIZES})
    assert roofline.read(_ctx({ELEMENT: 10}, 0.0)) is None


def test_pb_element_3d_roofline_ignores_stencil_keys(monkeypatch):
    read = importlib.import_module("metrics.element_matvec_3d_roofline").read
    sizes = dict(cells=53248, nr=89, nc=89, a_elem_bytes=4,
                 table_numel=53248 * 35, table_elem_bytes=4,
                 x_numel=1408668, x_elem_bytes=4, n_out=1408668)
    monkeypatch.setattr(sized_bound, "program_sizes",
                        lambda: {ELEMENT: sizes})
    alone = read(_ctx({ELEMENT: 40}, 0.01))
    assert alone is not None
    assert read(_ctx({ELEMENT: 40, KEY: 10}, 0.01)) == alone
