# Frozen copy of openifem_tpu_torch/mesh/mesh.py at commit 2573dc3, cut to
# what the plain references call (2-D quads, global and flagged
# refinement), so that they build their meshes without importing the port;
# the lines kept are unchanged but for the 3-D branches and the coarsening
# bookkeeping taken out.  tests/test_pb_meshes.py holds the meshes it makes
# to the published geometry.  Do not edit: it is part of the benchmark's
# yardstick.
"""Unstructured quad/hex mesh with refinement (host-side, numpy).

TPU-native replacement for deal.II Triangulation / p4est: the mesh is plain
index arrays; all heavy per-element work downstream happens in batched JAX
kernels over device arrays derived from it.  Adaptivity is performed on the
host between jitted solve segments (the reference refines at fixed intervals,
e.g. source/fsi.cpp:383-456, so recompilation is rare and amortized).

Conventions follow deal.II (so reference test geometry translates 1:1):
 - cell vertex order is z-order over the unit hypercube bits (x fastest)
 - face order: 2D [-x,+x,-y,+y]; 3D [-x,+x,-y,+y,-z,+z]
 - boundary_id < 0 means interior face
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from .manifolds import FlatManifold

# face -> local vertex indices (deal.II GeometryInfo)
FACE_VERTICES = {
    1: [[0], [1]],
    2: [[0, 2], [1, 3], [0, 1], [2, 3]],
}

FLAT = FlatManifold()
FLAT_ID = -1


@dataclass
class Mesh:
    dim: int
    vertices: np.ndarray                 # (n_v, dim) float64
    cells: np.ndarray                    # (n_c, 2**dim) int64
    material_id: np.ndarray = None       # (n_c,) int32
    boundary_id: np.ndarray = None       # (n_c, 2*dim) int32, -1 interior
    face_manifold: np.ndarray = None     # (n_c, 2*dim) int32, -1 flat
    cell_manifold: np.ndarray = None     # (n_c,) int32, -1 flat
    level: np.ndarray = None             # (n_c,) int32 refinement level
    manifolds: Dict[int, object] = field(default_factory=dict)
    # transfinite-interpolation charts (deal.II TransfiniteInterpolation-
    # Manifold analog): per-cell coarse chart id (-1 = none) and the cell's
    # [xi0, eta0, xi1, eta1] sub-rectangle in that chart
    tfi: object = None                   # TransfiniteManifold or None
    tfi_coarse: np.ndarray = None        # (n_c,) int32
    tfi_rect: np.ndarray = None          # (n_c, 4) float64

    def __post_init__(self):
        n_c = len(self.cells)
        nf = 2 * self.dim
        if self.material_id is None:
            self.material_id = np.ones(n_c, dtype=np.int32)
        if self.boundary_id is None:
            self.boundary_id = np.full((n_c, nf), -1, dtype=np.int32)
        if self.face_manifold is None:
            self.face_manifold = np.full((n_c, nf), FLAT_ID, dtype=np.int32)
        if self.cell_manifold is None:
            self.cell_manifold = np.full(n_c, FLAT_ID, dtype=np.int32)
        if self.level is None:
            self.level = np.zeros(n_c, dtype=np.int32)
        if self.tfi_coarse is None:
            self.tfi_coarse = np.full(n_c, -1, dtype=np.int32)
        if self.tfi_rect is None:
            self.tfi_rect = np.tile(
                np.array([0.0, 0.0, 1.0, 1.0]), (n_c, 1))
        self.vertices = np.asarray(self.vertices, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=np.int64)

    # ------------------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return len(self.cells)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    def cell_centers(self) -> np.ndarray:
        return self.vertices[self.cells].mean(axis=1)

    def _manifold(self, mid: int):
        if mid == FLAT_ID or mid not in self.manifolds:
            return FLAT
        return self.manifolds[mid]

    # ------------------------------------------------------------------
    # refinement
    def refine_global(self, n: int = 1) -> "Mesh":
        m = self
        for _ in range(n):
            m = m._refine(np.ones(m.n_cells, dtype=bool))
        return m

    def refine(self, flags: np.ndarray) -> "Mesh":
        """Refine flagged cells, enforcing 2:1 balance (1-irregular mesh)."""
        flags = np.asarray(flags, dtype=bool).copy()
        # 2:1 balance: a cell must be refined if a face neighbor is flagged
        # and already one level finer.
        changed = True
        while changed:
            changed = False
            face_map = self._face_map()
            for key, lst in face_map.items():
                if len(lst) != 2:
                    continue
                (c0, _), (c1, _) = lst
                for a, b in ((c0, c1), (c1, c0)):
                    la = self.level[a] + (1 if flags[a] else 0)
                    lb = self.level[b] + (1 if flags[b] else 0)
                    if la - lb > 1 and not flags[b]:
                        flags[b] = True
                        changed = True
        return self._refine(flags)

    def _face_map(self):
        """Map frozenset(face vertices) -> list of (cell, face)."""
        fm: Dict[frozenset, list] = {}
        fv = FACE_VERTICES[self.dim]
        for c in range(self.n_cells):
            for f in range(2 * self.dim):
                key = frozenset(int(self.cells[c, v]) for v in fv[f])
                fm.setdefault(key, []).append((c, f))
        return fm

    def _refine(self, flags: np.ndarray) -> "Mesh":
        if self.dim == 2:
            return self._refine_2d(flags)
        raise NotImplementedError

    def _edge_manifold_id(self, c: int, edge_vs: Tuple[int, int],
                          edge_face_map) -> int:
        """Manifold id governing a new point on this edge.

        Priority (mirroring deal.II): a boundary/face manifold on any face
        containing the edge, else the cell manifold.
        """
        key = frozenset(edge_vs)
        best = FLAT_ID
        for (cc, ff) in edge_face_map.get(key, []):
            mid = self.face_manifold[cc, ff]
            if mid != FLAT_ID:
                return mid
        if self.cell_manifold[c] != FLAT_ID:
            best = self.cell_manifold[c]
        return best

    def _refine_2d(self, flags: np.ndarray) -> "Mesh":
        verts = list(self.vertices)
        new_vertex: Dict[frozenset, int] = {}
        # position lookup so refining next to an already-finer neighbor (or
        # refining a 1-irregular mesh globally) reuses the hanging vertex
        # instead of duplicating it
        pos_lookup = {tuple(np.round(p, 12)): i
                      for i, p in enumerate(self.vertices)}

        # map edge -> (cell, face) occurrences for manifold lookup: in 2D
        # edges ARE faces.
        edge_face_map = self._face_map()

        def register(key, p):
            pk = tuple(np.round(p, 12))
            if pk in pos_lookup:
                new_vertex[key] = pos_lookup[pk]
                return pos_lookup[pk]
            i = len(verts)
            verts.append(p)
            pos_lookup[pk] = i
            new_vertex[key] = i
            return i

        def midpoint(c, va, vb):
            key = frozenset((int(va), int(vb)))
            if key in new_vertex:
                return new_vertex[key]
            mid = self._edge_manifold_id(c, (int(va), int(vb)), edge_face_map)
            p = self._manifold(mid).new_point(
                np.array([verts[va], verts[vb]]))
            return register(key, p)

        def point_at(key, p):
            if key in new_vertex:
                return new_vertex[key]
            return register(key, p)

        new_cells, new_mat, new_bnd, new_fman, new_cman, new_lvl = \
            [], [], [], [], [], []
        new_tfic, new_tfir = [], []
        for c in range(self.n_cells):
            v = self.cells[c]
            if not flags[c]:
                new_cells.append(list(v))
                new_mat.append(self.material_id[c])
                new_bnd.append(list(self.boundary_id[c]))
                new_fman.append(list(self.face_manifold[c]))
                new_cman.append(self.cell_manifold[c])
                new_lvl.append(self.level[c])
                new_tfic.append(self.tfi_coarse[c])
                new_tfir.append(list(self.tfi_rect[c]))
                continue
            cman = self.cell_manifold[c]
            cid = int(self.tfi_coarse[c])
            if cid >= 0 and self.tfi is not None:
                # transfinite chart of the coarse ancestor cell
                xi0, eta0, xi1, eta1 = self.tfi_rect[c]
                xm, em = 0.5 * (xi0 + xi1), 0.5 * (eta0 + eta1)
                ev = lambda xi, eta: self.tfi.eval(cid, xi, eta)
                mb = point_at(frozenset((int(v[0]), int(v[1]))),
                              ev(xm, eta0))
                mt = point_at(frozenset((int(v[2]), int(v[3]))),
                              ev(xm, eta1))
                ml = point_at(frozenset((int(v[0]), int(v[2]))),
                              ev(xi0, em))
                mr = point_at(frozenset((int(v[1]), int(v[3]))),
                              ev(xi1, em))
                ci = len(verts)
                verts.append(ev(xm, em))
                kid_rects = [[xi0, eta0, xm, em], [xm, eta0, xi1, em],
                             [xi0, em, xm, eta1], [xm, em, xi1, eta1]]
                kid_cids = [cid] * 4
            else:
                mb = midpoint(c, v[0], v[1])
                mt = midpoint(c, v[2], v[3])
                ml = midpoint(c, v[0], v[2])
                mr = midpoint(c, v[1], v[3])
                ctr_pts = np.array([verts[v[0]], verts[v[1]],
                                    verts[v[2]], verts[v[3]]])
                cc = self._manifold(cman).new_point(ctr_pts)
                ci = len(verts)
                verts.append(cc)
                kid_rects = [[0.0, 0.0, 1.0, 1.0]] * 4
                kid_cids = [-1] * 4
            b = self.boundary_id[c]
            fm = self.face_manifold[c]
            # children in z-order; faces [-x,+x,-y,+y]
            kids = [
                ([v[0], mb, ml, ci], [b[0], -1, b[2], -1],
                 [fm[0], cman, fm[2], cman]),
                ([mb, v[1], ci, mr], [-1, b[1], b[2], -1],
                 [cman, fm[1], fm[2], cman]),
                ([ml, ci, v[2], mt], [b[0], -1, -1, b[3]],
                 [fm[0], cman, cman, fm[3]]),
                ([ci, mr, mt, v[3]], [-1, b[1], -1, b[3]],
                 [cman, fm[1], cman, fm[3]]),
            ]
            for kk, (kc, kb, kf) in enumerate(kids):
                new_cells.append(kc)
                new_mat.append(self.material_id[c])
                new_bnd.append(kb)
                new_fman.append(kf)
                new_cman.append(cman)
                new_lvl.append(self.level[c] + 1)
                new_tfic.append(kid_cids[kk])
                new_tfir.append(kid_rects[kk])

        return Mesh(dim=2,
                    vertices=np.array(verts),
                    cells=np.array(new_cells, dtype=np.int64),
                    material_id=np.array(new_mat, dtype=np.int32),
                    boundary_id=np.array(new_bnd, dtype=np.int32),
                    face_manifold=np.array(new_fman, dtype=np.int32),
                    cell_manifold=np.array(new_cman, dtype=np.int32),
                    level=np.array(new_lvl, dtype=np.int32),
                    manifolds=self.manifolds,
                    tfi=self.tfi,
                    tfi_coarse=np.array(new_tfic, dtype=np.int32),
                    tfi_rect=np.array(new_tfir, dtype=np.float64))
