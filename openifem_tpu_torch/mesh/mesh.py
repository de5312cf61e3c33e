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
from typing import Dict, List, Tuple

import numpy as np

from ..utils.timer import span
from .manifolds import FlatManifold

# face -> local vertex indices (deal.II GeometryInfo)
FACE_VERTICES = {
    1: [[0], [1]],
    2: [[0, 2], [1, 3], [0, 1], [2, 3]],
    3: [[0, 2, 4, 6], [1, 3, 5, 7], [0, 1, 4, 5], [2, 3, 6, 7],
        [0, 1, 2, 3], [4, 5, 6, 7]],
}

# 2D quad edges as (vertex, vertex): bottom, top, left, right
_EDGES_2D = [(0, 1), (2, 3), (0, 2), (1, 3)]
# 3D hex edges (12)
_EDGES_3D = [(0, 1), (2, 3), (4, 5), (6, 7),   # x-dir
             (0, 2), (1, 3), (4, 6), (5, 7),   # y-dir
             (0, 4), (1, 5), (2, 6), (3, 7)]   # z-dir

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
    # sibling tracking for coarsening: cells created by one refine() call on
    # the same parent share a unique family id; child_index is the z-order
    # child number within the family (-1 = no recorded parent)
    family: np.ndarray = None            # (n_c,) int64
    child_index: np.ndarray = None       # (n_c,) int8

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
        if self.family is None:
            self.family = np.full(n_c, -1, dtype=np.int64)
        if self.child_index is None:
            self.child_index = np.full(n_c, -1, dtype=np.int8)
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

    def cell_diameters(self) -> np.ndarray:
        """deal.II cell diameter: largest vertex-to-vertex distance."""
        v = self.vertices[self.cells]  # (n_c, 2**dim, dim)
        if self.dim == 2:
            d1 = np.linalg.norm(v[:, 0] - v[:, 3], axis=1)
            d2 = np.linalg.norm(v[:, 1] - v[:, 2], axis=1)
            return np.maximum(d1, d2)
        d1 = np.linalg.norm(v[:, 0] - v[:, 7], axis=1)
        d2 = np.linalg.norm(v[:, 1] - v[:, 6], axis=1)
        d3 = np.linalg.norm(v[:, 2] - v[:, 5], axis=1)
        d4 = np.linalg.norm(v[:, 3] - v[:, 4], axis=1)
        return np.maximum(np.maximum(d1, d2), np.maximum(d3, d4))

    def _manifold(self, mid: int):
        if mid == FLAT_ID or mid not in self.manifolds:
            return FLAT
        return self.manifolds[mid]

    def boundary_faces(self, ids=None) -> List[Tuple[int, int]]:
        """(cell, local face) pairs on the boundary, optionally filtered."""
        out = []
        for c in range(self.n_cells):
            for f in range(2 * self.dim):
                b = self.boundary_id[c, f]
                if b >= 0 and (ids is None or b in ids):
                    out.append((c, f))
        return out

    # ------------------------------------------------------------------
    # refinement
    def refine_global(self, n: int = 1) -> "Mesh":
        m = self
        with span("mesh"):
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

    def coarsen(self, flags: np.ndarray, min_level: int = 0):
        """deal.II-style sibling coarsening: a family of 2^dim children is
        merged back into its parent iff ALL children are flagged, none is at
        or below min_level, and no face neighbor is finer than the children
        (2:1 balance; deal.II clears such coarsen flags in
        prepare_coarsening_and_refinement).

        Only families recorded by refine() can coarsen (the original coarse
        cells have no parent, mirroring deal.II level-0 cells; a cell
        produced by coarsen() loses its own family record, so repeated
        multi-level coarsening stops one level up — reference tests never
        coarsen below the initial grid, source/fluid_solver.cpp:246-250).

        Returns (mesh, old_to_new): per-old-cell index into the new mesh
        (children map to their parent's index)."""
        flags = np.asarray(flags, dtype=bool)
        nv = 2 ** self.dim
        ident = np.arange(self.n_cells)
        cand: Dict[int, list] = {}
        for c in np.where(flags & (self.family >= 0) &
                          (self.level > min_level))[0]:
            cand.setdefault(int(self.family[c]), []).append(int(c))
        groups = {f: sorted(cs, key=lambda x: int(self.child_index[x]))
                  for f, cs in cand.items() if len(cs) == nv}
        if not groups:
            return self, ident

        face_map = self._face_map()
        fv = FACE_VERTICES[self.dim]
        in_group = np.zeros(self.n_cells, dtype=bool)
        for cs in groups.values():
            in_group[cs] = True

        faces_at_vertex: Dict[int, list] = {}
        if self.dim == 2:
            for key in face_map:
                for v in key:
                    faces_at_vertex.setdefault(int(v), []).append(key)

        def has_finer_neighbor(cs):
            gset = set(cs)
            for c in cs:
                for f in range(2 * self.dim):
                    verts = [int(self.cells[c, v]) for v in fv[f]]
                    key = frozenset(verts)
                    others = [x for x in face_map.get(key, [])
                              if x[0] != c and x[0] not in gset]
                    if others or self.boundary_id[c, f] >= 0:
                        continue  # conforming neighbor or boundary
                    if self.dim == 3:
                        return True  # conservative: unknown nonconforming
                    # 2D: distinguish coarser (ok) from finer (veto):
                    # finer iff two outside half-faces (a,x) + (x,b) exist
                    a, b2 = verts
                    for key2 in faces_at_vertex.get(a, []):
                        if b2 in key2:
                            continue
                        (x,) = key2 - {a}
                        k3 = frozenset((int(x), b2))
                        if k3 in face_map and \
                                any(cc not in gset for cc, _ in
                                    face_map[key2]) and \
                                any(cc not in gset for cc, _ in
                                    face_map[k3]):
                            return True
            return False

        groups = {f: cs for f, cs in groups.items()
                  if not has_finer_neighbor(cs)}
        if not groups:
            return self, ident

        coarsened = np.zeros(self.n_cells, dtype=bool)
        for cs in groups.values():
            coarsened[cs] = True

        new_cells, new_mat, new_bnd, new_fman, new_cman, new_lvl = \
            [], [], [], [], [], []
        new_tfic, new_tfir, new_fam, new_chi = [], [], [], []
        old_to_new = np.full(self.n_cells, -1, dtype=np.int64)

        def emit(cell, mat, bnd, fman, cman, lvl, tfic, tfir, fam, chi):
            i = len(new_cells)
            new_cells.append(cell)
            new_mat.append(mat)
            new_bnd.append(bnd)
            new_fman.append(fman)
            new_cman.append(cman)
            new_lvl.append(lvl)
            new_tfic.append(tfic)
            new_tfir.append(tfir)
            new_fam.append(fam)
            new_chi.append(chi)
            return i

        done = set()
        for c in range(self.n_cells):
            if not coarsened[c]:
                old_to_new[c] = emit(
                    list(self.cells[c]), self.material_id[c],
                    list(self.boundary_id[c]), list(self.face_manifold[c]),
                    self.cell_manifold[c], self.level[c],
                    self.tfi_coarse[c], list(self.tfi_rect[c]),
                    self.family[c], self.child_index[c])
                continue
            fam = int(self.family[c])
            if fam in done:
                continue
            done.add(fam)
            cs = groups[fam]
            # parent corner i = child i's local corner i (z-order children)
            pcell = [int(self.cells[cs[i], i]) for i in range(nv)]
            pbnd, pfman = [], []
            for f in range(2 * self.dim):
                d_ax, side = f // 2, f % 2
                rep = cs[side << d_ax]
                pbnd.append(int(self.boundary_id[rep, f]))
                pfman.append(int(self.face_manifold[rep, f]))
            c0, cl = cs[0], cs[-1]
            rect = [self.tfi_rect[c0][0], self.tfi_rect[c0][1],
                    self.tfi_rect[cl][2], self.tfi_rect[cl][3]]
            i_new = emit(pcell, self.material_id[c0], pbnd, pfman,
                         self.cell_manifold[c0], self.level[c0] - 1,
                         self.tfi_coarse[c0], rect, -1, -1)
            for cc in cs:
                old_to_new[cc] = i_new

        cells_arr = np.array(new_cells, dtype=np.int64)
        # compact vertices (drop the now-unused midpoints/centers)
        used = np.unique(cells_arr)
        remap = np.full(self.n_vertices, -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        mesh = Mesh(dim=self.dim,
                    vertices=self.vertices[used],
                    cells=remap[cells_arr],
                    material_id=np.array(new_mat, dtype=np.int32),
                    boundary_id=np.array(new_bnd, dtype=np.int32),
                    face_manifold=np.array(new_fman, dtype=np.int32),
                    cell_manifold=np.array(new_cman, dtype=np.int32),
                    level=np.array(new_lvl, dtype=np.int32),
                    manifolds=self.manifolds,
                    tfi=self.tfi,
                    tfi_coarse=np.array(new_tfic, dtype=np.int32),
                    tfi_rect=np.array(new_tfir, dtype=np.float64),
                    family=np.array(new_fam, dtype=np.int64),
                    child_index=np.array(new_chi, dtype=np.int8))
        return mesh, old_to_new

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
        elif self.dim == 3:
            return self._refine_3d(flags)
        raise NotImplementedError

    # -- helpers shared by 2D/3D refinement
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
        new_fam, new_chi = [], []
        fam_base = int(max(0, self.family.max() + 1))
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
                new_fam.append(self.family[c])
                new_chi.append(self.child_index[c])
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
                new_fam.append(fam_base + c)
                new_chi.append(kk)

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
                    tfi_rect=np.array(new_tfir, dtype=np.float64),
                    family=np.array(new_fam, dtype=np.int64),
                    child_index=np.array(new_chi, dtype=np.int8))

    def _refine_3d(self, flags: np.ndarray) -> "Mesh":
        verts = list(self.vertices)
        new_vertex: Dict[frozenset, int] = {}
        face_map = self._face_map()

        # build edge -> faces-containing map for manifold decisions
        edge_face_map: Dict[frozenset, list] = {}
        fv = FACE_VERTICES[3]
        face_edges = {  # edges (as index pairs into face vertex list)
            f: [(0, 1), (2, 3), (0, 2), (1, 3)] for f in range(6)
        }
        for c in range(self.n_cells):
            for f in range(6):
                vs = [int(self.cells[c, v]) for v in fv[f]]
                for (a, b) in face_edges[f]:
                    edge_face_map.setdefault(
                        frozenset((vs[a], vs[b])), []).append((c, f))

        pos_lookup = {tuple(np.round(p, 12)): i
                      for i, p in enumerate(self.vertices)}

        def new_pt(key, points, mid):
            if key in new_vertex:
                return new_vertex[key]
            return place(key, self._manifold(mid).new_point(
                np.asarray(points)))

        def place(key, p):
            if key in new_vertex:
                return new_vertex[key]
            pk = tuple(np.round(p, 12))
            if pk in pos_lookup:
                new_vertex[key] = pos_lookup[pk]
                return pos_lookup[pk]
            i = len(verts)
            verts.append(p)
            pos_lookup[pk] = i
            new_vertex[key] = i
            return i

        def edge_mid(c, va, vb):
            key = frozenset((int(va), int(vb)))
            mid = self._edge_manifold_id(c, (int(va), int(vb)), edge_face_map)
            return new_pt(key, [verts[va], verts[vb]], mid)

        def face_mid(c, f):
            vs = [int(self.cells[c, v]) for v in fv[f]]
            key = frozenset(vs)
            mid = self.face_manifold[c, f]
            if mid == FLAT_ID:
                mid = self.cell_manifold[c]
            return new_pt(key, [verts[x] for x in vs], mid)

        def chart_lattice(c, v, L):
            """The new points of an extruded cell with a transfinite chart
            (generators.extrude): the coarse quad's chart at the halves of
            the cell's (xi, eta) rectangle, linear in z between the cell's
            bottom and top.  Each point is keyed by the corners of the
            edge, face or cell it lies in."""
            cid = int(self.tfi_coarse[c])
            xi0, eta0, xi1, eta1 = self.tfi_rect[c]
            xis = (xi0, 0.5 * (xi0 + xi1), xi1)
            etas = (eta0, 0.5 * (eta0 + eta1), eta1)
            z0, z1 = verts[v[0]][2], verts[v[4]][2]
            zs = (z0, 0.5 * (z0 + z1), z1)
            for i, j, k in np.ndindex(3, 3, 3):
                if i != 1 and j != 1 and k != 1:
                    continue
                key = frozenset(
                    v[(a // 2) + 2 * (b // 2) + 4 * (cc // 2)]
                    for a in ((0, 2) if i == 1 else (i,))
                    for b in ((0, 2) if j == 1 else (j,))
                    for cc in ((0, 2) if k == 1 else (k,)))
                xy = self.tfi.eval(cid, xis[i], etas[j])
                L[i, j, k] = place(key, np.array([xy[0], xy[1], zs[k]]))
            return xis, etas

        new_cells, new_mat, new_bnd, new_fman, new_cman, new_lvl = \
            [], [], [], [], [], []
        new_fam, new_chi = [], []
        new_tfic, new_tfir = [], []
        fam_base = int(max(0, self.family.max() + 1))
        for c in range(self.n_cells):
            v = [int(x) for x in self.cells[c]]
            if not flags[c]:
                new_cells.append(v)
                new_mat.append(self.material_id[c])
                new_bnd.append(list(self.boundary_id[c]))
                new_fman.append(list(self.face_manifold[c]))
                new_cman.append(self.cell_manifold[c])
                new_lvl.append(self.level[c])
                new_fam.append(self.family[c])
                new_chi.append(self.child_index[c])
                new_tfic.append(self.tfi_coarse[c])
                new_tfir.append(list(self.tfi_rect[c]))
                continue
            cman = self.cell_manifold[c]
            # Build the 3x3x3 lattice of points indices for this cell:
            # lattice[i][j][k] with i,j,k in {0,1,2} (x,y,z halves)
            L = np.empty((3, 3, 3), dtype=np.int64)
            bits = lambda i, j, k: v[(i // 2) + 2 * (j // 2) + 4 * (k // 2)]
            # corners
            for i in (0, 2):
                for j in (0, 2):
                    for k in (0, 2):
                        L[i, j, k] = bits(i, j, k)
            if self.tfi_coarse[c] >= 0 and self.tfi is not None:
                xis, etas = chart_lattice(c, v, L)
                kid_cid = self.tfi_coarse[c]
                kid_rects = [[xis[kx], etas[ky], xis[kx + 1], etas[ky + 1]]
                             for kz in range(2) for ky in range(2)
                             for kx in range(2)]
            else:
                # 12 edge midpoints
                em = {e: edge_mid(c, v[e[0]], v[e[1]]) for e in _EDGES_3D}
                # 6 face centers
                fc = [face_mid(c, f) for f in range(6)]
                # cell center
                ck = frozenset(v)
                ci = new_pt(ck, [verts[x] for x in v], cman)
                # edge midpoints
                L[1, 0, 0] = em[(0, 1)]; L[1, 2, 0] = em[(2, 3)]
                L[1, 0, 2] = em[(4, 5)]; L[1, 2, 2] = em[(6, 7)]
                L[0, 1, 0] = em[(0, 2)]; L[2, 1, 0] = em[(1, 3)]
                L[0, 1, 2] = em[(4, 6)]; L[2, 1, 2] = em[(5, 7)]
                L[0, 0, 1] = em[(0, 4)]; L[2, 0, 1] = em[(1, 5)]
                L[0, 2, 1] = em[(2, 6)]; L[2, 2, 1] = em[(3, 7)]
                # face centers: faces [-x,+x,-y,+y,-z,+z]
                L[0, 1, 1] = fc[0]; L[2, 1, 1] = fc[1]
                L[1, 0, 1] = fc[2]; L[1, 2, 1] = fc[3]
                L[1, 1, 0] = fc[4]; L[1, 1, 2] = fc[5]
                L[1, 1, 1] = ci
                kid_cid, kid_rects = -1, [[0.0, 0.0, 1.0, 1.0]] * 8
            new_tfic += [kid_cid] * 8
            new_tfir += kid_rects

            b = self.boundary_id[c]
            fm = self.face_manifold[c]
            for kz in range(2):
                for ky in range(2):
                    for kx in range(2):
                        kc = [int(L[kx + dx, ky + dy, kz + dz])
                              for dz in (0, 1) for dy in (0, 1)
                              for dx in (0, 1)]
                        kb = [b[0] if kx == 0 else -1,
                              b[1] if kx == 1 else -1,
                              b[2] if ky == 0 else -1,
                              b[3] if ky == 1 else -1,
                              b[4] if kz == 0 else -1,
                              b[5] if kz == 1 else -1]
                        kf = [fm[0] if kx == 0 else cman,
                              fm[1] if kx == 1 else cman,
                              fm[2] if ky == 0 else cman,
                              fm[3] if ky == 1 else cman,
                              fm[4] if kz == 0 else cman,
                              fm[5] if kz == 1 else cman]
                        new_cells.append(kc)
                        new_mat.append(self.material_id[c])
                        new_bnd.append(kb)
                        new_fman.append(kf)
                        new_cman.append(cman)
                        new_lvl.append(self.level[c] + 1)
                        new_fam.append(fam_base + c)
                        new_chi.append(kx + 2 * ky + 4 * kz)

        return Mesh(dim=3,
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
                    tfi_rect=np.array(new_tfir, dtype=np.float64),
                    family=np.array(new_fam, dtype=np.int64),
                    child_index=np.array(new_chi, dtype=np.int8))
