"""The meshes the plain references build (reference/frozen_mesh/, a copy of
the port's generators) against the geometry of their sources, so that a
fault the copy shares with the port cannot pass the comparison unseen:

- the DFG channel of Schaefer and Turek (1996), benchmark 2D-1: the
  channel [0, 2.2] x [0, 0.41], the cylinder of radius 0.05 centred at
  (0.2, 0.2); boundary ids 0 inflow (x = 0), 1 outflow (x = 2.2), 2 and 3
  the walls (y = 0, y = 0.41), 4 the cylinder;
- the leaflet's channel and leaflet of fsi_leaflet.json's geometry
  (tests/test_fsi.py:66-86): the channel [0, L] x [0, H] in squares of
  side h, one level finer in the band [L/4 - a, L/4 + 2a] x [0, H/2]
  around the leaflet [L/4, L/4 + a] x [0, b], which is clamped at y = 0."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import BENCH

# face -> local vertices of a z-ordered quad: [-x, +x, -y, +y]
FACES = [(0, 2), (1, 3), (0, 1), (2, 3)]
DFG = dict(length=2.2, height=0.41, centre=(0.2, 0.2), radius=0.05)


def quad_areas(m):
    """Areas of the cells as polygons (z-order 0, 1, 3, 2 round the
    edge), by the shoelace formula."""
    v = m.vertices[m.cells][:, [0, 1, 3, 2]]
    x, y = v[..., 0], v[..., 1]
    return 0.5 * (x * np.roll(y, -1, 1) - np.roll(x, -1, 1) * y).sum(1)


def boundary_faces(m):
    """{boundary id: (n, 2, 2) end points of its faces}."""
    out = {}
    for f, (a, b) in enumerate(FACES):
        for bid in np.unique(m.boundary_id[:, f]):
            if bid < 0:
                continue
            c = m.boundary_id[:, f] == bid
            ends = np.stack([m.vertices[m.cells[c, a]],
                             m.vertices[m.cells[c, b]]], axis=1)
            out.setdefault(int(bid), []).append(ends)
    return {k: np.concatenate(v) for k, v in out.items()}


def face_counts(m):
    """How many cells hold each face (by its two vertices)."""
    keys = np.concatenate([np.sort(m.cells[:, list(f)], axis=1)
                           for f in FACES])
    _, n = np.unique(keys, axis=0, return_counts=True)
    return n


def length(ends):
    return np.linalg.norm(ends[:, 0] - ends[:, 1], axis=1).sum()


@pytest.mark.parametrize("refine", [0, 1, 2, 3])
def test_pb_dfg_mesh_is_the_published_channel(refine):
    from reference.frozen_mesh import generators
    m = generators.flow_around_cylinder(2).refine_global(refine)
    L, H, r = DFG["length"], DFG["height"], DFG["radius"]
    centre = np.array(DFG["centre"])
    v = m.vertices
    assert v[:, 0].min() == 0.0 and v[:, 0].max() == pytest.approx(L)
    assert v[:, 1].min() == 0.0 and v[:, 1].max() == pytest.approx(H)
    # nothing inside the cylinder, every cell the right way round
    assert np.linalg.norm(v - centre, axis=1).min() >= r - 1e-12
    areas = quad_areas(m)
    assert areas.min() > 0
    # conforming: every face in one cell (the boundary) or two
    assert set(np.unique(face_counts(m))) == {1, 2}
    faces = boundary_faces(m)
    assert sorted(faces) == [0, 1, 2, 3, 4]
    assert np.abs(faces[0][..., 0]).max() == 0.0
    assert np.abs(faces[1][..., 0] - L).max() < 1e-12
    assert np.abs(faces[2][..., 1]).max() == 0.0
    assert np.abs(faces[3][..., 1] - H).max() < 1e-12
    on_circle = np.linalg.norm(faces[4] - centre, axis=-1)
    assert np.abs(on_circle - r).max() < 1e-12
    for bid, expect in ((0, H), (1, H), (2, L), (3, L)):
        assert length(faces[bid]) == pytest.approx(expect, rel=1e-12)
    # the cylinder's polygon: 8 faces on the coarse mesh, doubling with
    # each refinement, inscribed in the circle
    n = len(faces[4])
    assert n == 8 * 2 ** refine
    inscribed = 2 * n * r * np.sin(np.pi / n)
    assert length(faces[4]) == pytest.approx(inscribed, rel=1e-12)
    hole = 0.5 * n * r * r * np.sin(2 * np.pi / n)
    assert areas.sum() == pytest.approx(L * H - hole, rel=1e-12)


def test_pb_leaflet_meshes_are_the_configured_geometry():
    from reference import fsi_leaflet
    with open(os.path.join(BENCH, "configs", "fsi_leaflet.json")) as f:
        cfg = json.load(f)
    geom = cfg["geometry"]
    L, H, a, b, h = (geom[k] for k in ("L", "H", "a", "b", "h"))
    fluid, solid = fsi_leaflet.meshes(geom, cfg["refinements"])
    band = (L / 4 - a, L / 4 + 2 * a, 0.0, H / 2)
    n_band = round((band[1] - band[0]) / h) * round(band[3] / h)
    assert fluid.n_cells == round(L / h) * round(H / h) + 3 * n_band
    areas = quad_areas(fluid)
    assert areas.sum() == pytest.approx(L * H, rel=1e-12)
    fine = np.isclose(areas, (h / 2) ** 2, rtol=1e-9)
    assert np.isclose(areas[~fine], h * h, rtol=1e-9).all()
    c = fluid.vertices[fluid.cells].mean(axis=1)[fine]
    assert fine.sum() == 4 * n_band
    assert (c[:, 0] > band[0]).all() and (c[:, 0] < band[1]).all()
    assert (c[:, 1] > band[2]).all() and (c[:, 1] < band[3]).all()
    faces = boundary_faces(fluid)
    assert sorted(faces) == [0, 1, 2, 3]
    for bid, axis, at, expect in ((0, 0, 0.0, H), (1, 0, L, H),
                                  (2, 1, 0.0, L), (3, 1, H, L)):
        assert np.abs(faces[bid][..., axis] - at).max() < 1e-12
        assert length(faces[bid]) == pytest.approx(expect, rel=1e-12)
    # the leaflet: [L/4, L/4 + a] x [0, b], clamped (id 2) at y = 0
    sv = solid.vertices
    assert sv[:, 0].min() == pytest.approx(L / 4)
    assert sv[:, 0].max() == pytest.approx(L / 4 + a)
    assert sv[:, 1].min() == 0.0 and sv[:, 1].max() == pytest.approx(b)
    assert quad_areas(solid).sum() == pytest.approx(a * b, rel=1e-12)
    clamp = boundary_faces(solid)[cfg["solid_clamp_ids"][0]]
    assert np.abs(clamp[..., 1]).max() == 0.0
    assert length(clamp) == pytest.approx(a, rel=1e-12)
