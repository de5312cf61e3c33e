# Frozen copy of the 3-D branch of openifem_tpu_torch/mesh/generators.py
# (flow_around_cylinder(3), flow_around_cylinder_2d(False), extrude) and of
# Mesh._refine_3d in openifem_tpu_torch/mesh/mesh.py, with the shell
# centred on the hole whatever the channel's left end, every exterior face
# given its id and the manifolds holding in 3-D, cut to what the plain
# reference of dfg_cylinder_3d calls (global refinement only), so that it
# builds its mesh without importing the port.  It imports the 2-D frozen
# modules for what they already hold.  The port's mesh equals it at refine
# 0 and 1 (tests/test_pb_cylinder3d.py).  Do not edit: it is part of the
# benchmark's yardstick.
"""The Schaefer-Turek 3D-1Z channel: flow_around_cylinder(3) and its
global refinement.

Boundary ids: 0 inflow (x = -0.3), 1 outflow (x = 2.2), 2/3 y = 0/0.41,
4/5 z = 0/0.41, 6 the cylinder (axis along z through (0.2, 0.2), radius
0.05).  The shell cells around the cylinder refine through the 2-D
transfinite charts of their base quads in (x, y) and linearly in z; every
other new point is the mean of the points it refines."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .generators import (_hyper_shell_squashed, merge_meshes, remove_cells,
                         subdivided_hyper_rectangle)
from .manifolds import FlatManifold, PolarManifold, TransfiniteManifold
from .mesh import FACE_VERTICES, Mesh

FACE_VERTICES_3D = [[0, 2, 4, 6], [1, 3, 5, 7], [0, 1, 4, 5], [2, 3, 6, 7],
                    [0, 1, 2, 3], [4, 5, 6, 7]]
# 3D hex edges (12)
_EDGES_3D = [(0, 1), (2, 3), (4, 5), (6, 7),   # x-dir
             (0, 2), (1, 3), (4, 6), (5, 7),   # y-dir
             (0, 4), (1, 5), (2, 6), (3, 7)]   # z-dir
FLAT = FlatManifold()
FLAT_ID = -1


class CylindricalManifold:
    """3D cylindrical manifold along coordinate ``axis`` through origin."""

    def __init__(self, axis: int = 2, center=None):
        self.axis = axis
        self.center = (np.zeros(3) if center is None
                       else np.asarray(center, dtype=np.float64))

    def new_point(self, points: np.ndarray, weights=None) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float64) - self.center
        if weights is None:
            weights = np.full(len(pts), 1.0 / len(pts))
        w = np.asarray(weights, dtype=np.float64)
        ax = self.axis
        other = [d for d in range(3) if d != ax]
        planar = pts[:, other]
        r = np.linalg.norm(planar, axis=1)
        theta = np.arctan2(planar[:, 1], planar[:, 0])
        dtheta = np.angle(np.exp(1j * (theta - theta[0])))
        t = theta[0] + (w * dtheta).sum()
        rr = (w * r).sum()
        z = (w * pts[:, ax]).sum()
        out = np.zeros(3)
        out[other[0]] = rr * np.cos(t)
        out[other[1]] = rr * np.sin(t)
        out[ax] = z
        return out + self.center


def flow_around_cylinder_2d_base() -> Mesh:
    """The 2-D base of the 3-D channel: flow_around_cylinder_2d(False)."""
    left = -0.3
    nx = 25
    bulk = subdivided_hyper_rectangle([nx, 4], [left, 0.0], [2.2, 0.41],
                                      colorize=False)
    centers = bulk.cell_centers()
    remove = np.linalg.norm(centers - np.array([0.2, 0.2]), axis=1) < 0.15
    # the removed block is the 2 x 2 cells around the grid point nearest
    # (0.2, 0.2); the shell is centred on that point
    xs = np.linspace(left, 2.2, nx + 1)
    ys = np.linspace(0.0, 0.41, 5)
    hole = np.array([xs[np.argmin(np.abs(xs - 0.2))],
                     ys[np.argmin(np.abs(ys - 0.2))]])
    result1 = remove_cells(bulk, remove)

    shell = _hyper_shell_squashed(0.05, 0.41 / 4.0)
    shell.vertices = shell.vertices + hole
    shell.material_id[:] = 2

    def min_line_length(m):
        v = m.vertices[m.cells]
        ls = [np.linalg.norm(v[:, 0] - v[:, 1], axis=1),
              np.linalg.norm(v[:, 0] - v[:, 2], axis=1),
              np.linalg.norm(v[:, 1] - v[:, 3], axis=1),
              np.linalg.norm(v[:, 2] - v[:, 3], axis=1)]
        return min(x.min() for x in ls)

    tol = min(min_line_length(result1), min_line_length(shell)) / 2.0
    m = merge_meshes(result1, shell, tol)

    polar_id, tfi_id = 0, 1
    hole_center = np.array([0.2, 0.2])
    polar = PolarManifold(hole_center)
    m.manifolds[polar_id] = polar
    inner_vertex_ids = set()
    for c in range(m.n_cells):
        if m.material_id[c] == 2:
            m.cell_manifold[c] = tfi_id
            for f in range(4):
                if m.boundary_id[c, f] >= 0:
                    m.face_manifold[c, f] = polar_id
                    for v in FACE_VERTICES[2][f]:
                        inner_vertex_ids.add(int(m.cells[c, v]))
                else:
                    m.face_manifold[c, f] = tfi_id
    # recenter the hole boundary vertices at (0.2, 0.2)
    ids = sorted(inner_vertex_ids)
    ctr = m.vertices[ids].mean(axis=0)
    m.vertices[ids] += hole_center - ctr

    # transfinite charts for the shell cells (after recentering)
    tfi = TransfiniteManifold()
    for c in range(m.n_cells):
        if m.material_id[c] != 2:
            continue
        edge_manifolds = [polar if m.face_manifold[c, f] == polar_id else None
                          for f in range(4)]
        cid = tfi.add_cell(m.vertices[m.cells[c]], edge_manifolds)
        m.tfi_coarse[c] = cid
    m.tfi = tfi
    return m


def extrude(m2: Mesh, n_slices: int, height: float) -> Mesh:
    """Extrude a 2D mesh along z into n_slices-1 layers of hexes."""
    zs = np.linspace(0.0, height, n_slices)
    nv = m2.n_vertices
    verts = np.concatenate([
        np.concatenate([m2.vertices, np.full((nv, 1), z)], axis=1)
        for z in zs], axis=0)
    cells, bids, fman, mat = [], [], [], []
    for l in range(n_slices - 1):
        o0, o1 = l * nv, (l + 1) * nv
        for c in range(m2.n_cells):
            q = m2.cells[c]
            cells.append([o0 + q[0], o0 + q[1], o0 + q[2], o0 + q[3],
                          o1 + q[0], o1 + q[1], o1 + q[2], o1 + q[3]])
            b2 = m2.boundary_id[c]
            f2 = m2.face_manifold[c]
            bids.append([b2[0], b2[1], b2[2], b2[3],
                         0 if l == 0 else -1,
                         0 if l == n_slices - 2 else -1])
            fman.append([f2[0], f2[1], f2[2], f2[3], -1, -1])
            mat.append(m2.material_id[c])
    return Mesh(dim=3, vertices=verts,
                cells=np.array(cells, dtype=np.int64),
                material_id=np.array(mat, dtype=np.int32),
                boundary_id=np.array(bids, dtype=np.int32),
                face_manifold=np.array(fman, dtype=np.int32),
                manifolds=dict(m2.manifolds), tfi=m2.tfi,
                tfi_coarse=np.tile(m2.tfi_coarse, n_slices - 1),
                tfi_rect=np.tile(m2.tfi_rect, (n_slices - 1, 1)))


def flow_around_cylinder_3d() -> Mesh:
    m2 = flow_around_cylinder_2d_base()
    m = extrude(m2, 9, 0.41)
    m.manifolds = {0: CylindricalManifold(axis=2, center=[0.2, 0.2, 0.0])}
    for c in range(m.n_cells):
        for f in range(6):
            if m.boundary_id[c, f] < 0:
                continue
            fc = m.vertices[[m.cells[c, v]
                             for v in FACE_VERTICES_3D[f]]].mean(axis=0)
            if abs(fc[0] - 2.2) < 1e-12:
                m.boundary_id[c, f] = 1
            elif abs(fc[0] + 0.3) < 1e-12:
                m.boundary_id[c, f] = 0
            elif abs(fc[1] - 0.41) < 1e-12:
                m.boundary_id[c, f] = 3
            elif abs(fc[1]) < 1e-12:
                m.boundary_id[c, f] = 2
            elif abs(fc[2] - 0.41) < 1e-12:
                m.boundary_id[c, f] = 5
            elif abs(fc[2]) < 1e-12:
                m.boundary_id[c, f] = 4
            else:
                m.boundary_id[c, f] = 6
    return m


def _edge_manifold_id(m: Mesh, c: int, edge_vs, edge_face_map) -> int:
    key = frozenset(edge_vs)
    best = FLAT_ID
    for (cc, ff) in edge_face_map.get(key, []):
        mid = m.face_manifold[cc, ff]
        if mid != FLAT_ID:
            return mid
    if m.cell_manifold[c] != FLAT_ID:
        best = m.cell_manifold[c]
    return best


def _manifold(m: Mesh, mid: int):
    if mid == FLAT_ID or mid not in m.manifolds:
        return FLAT
    return m.manifolds[mid]


def refine_global_3d(m: Mesh, n: int = 1) -> Mesh:
    for _ in range(n):
        m = _refine_3d(m)
    return m


def _refine_3d(self: Mesh) -> Mesh:
    """Every cell into eight (Mesh._refine_3d with every cell flagged)."""
    verts = list(self.vertices)
    new_vertex: Dict[frozenset, int] = {}
    edge_face_map: Dict[frozenset, list] = {}
    fv = FACE_VERTICES_3D
    for c in range(self.n_cells):
        for f in range(6):
            vs = [int(self.cells[c, v]) for v in fv[f]]
            for (a, b) in ((0, 1), (2, 3), (0, 2), (1, 3)):
                edge_face_map.setdefault(
                    frozenset((vs[a], vs[b])), []).append((c, f))

    pos_lookup = {tuple(np.round(p, 12)): i
                  for i, p in enumerate(self.vertices)}

    def new_pt(key, points, mid):
        if key in new_vertex:
            return new_vertex[key]
        return place(key, _manifold(self, mid).new_point(np.asarray(points)))

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
        mid = _edge_manifold_id(self, c, (int(va), int(vb)), edge_face_map)
        return new_pt(key, [verts[va], verts[vb]], mid)

    def face_mid(c, f):
        vs = [int(self.cells[c, v]) for v in fv[f]]
        key = frozenset(vs)
        mid = self.face_manifold[c, f]
        if mid == FLAT_ID:
            mid = self.cell_manifold[c]
        return new_pt(key, [verts[x] for x in vs], mid)

    def chart_lattice(c, v, L):
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
    new_tfic, new_tfir = [], []

    def emit(c, L, b, fm, cman):
        for kz in range(2):
            for ky in range(2):
                for kx in range(2):
                    new_cells.append([int(L[kx + dx, ky + dy, kz + dz])
                                      for dz in (0, 1) for dy in (0, 1)
                                      for dx in (0, 1)])
                    new_bnd.append([b[0] if kx == 0 else -1,
                                    b[1] if kx == 1 else -1,
                                    b[2] if ky == 0 else -1,
                                    b[3] if ky == 1 else -1,
                                    b[4] if kz == 0 else -1,
                                    b[5] if kz == 1 else -1])
                    new_fman.append([fm[0] if kx == 0 else cman,
                                     fm[1] if kx == 1 else cman,
                                     fm[2] if ky == 0 else cman,
                                     fm[3] if ky == 1 else cman,
                                     fm[4] if kz == 0 else cman,
                                     fm[5] if kz == 1 else cman])
                    new_mat.append(self.material_id[c])
                    new_cman.append(cman)
                    new_lvl.append(self.level[c] + 1)

    for c in range(self.n_cells):
        v = [int(x) for x in self.cells[c]]
        cman = self.cell_manifold[c]
        L = np.empty((3, 3, 3), dtype=np.int64)
        for i in (0, 2):
            for j in (0, 2):
                for k in (0, 2):
                    L[i, j, k] = v[(i // 2) + 2 * (j // 2) + 4 * (k // 2)]
        b = self.boundary_id[c]
        fm = self.face_manifold[c]
        if self.tfi_coarse[c] >= 0 and self.tfi is not None:
            xis, etas = chart_lattice(c, v, L)
            emit(c, L, b, fm, cman)
            for kz in range(2):
                for ky in range(2):
                    for kx in range(2):
                        new_tfic.append(self.tfi_coarse[c])
                        new_tfir.append([xis[kx], etas[ky],
                                         xis[kx + 1], etas[ky + 1]])
            continue
        em = {e: edge_mid(c, v[e[0]], v[e[1]]) for e in _EDGES_3D}
        fc = [face_mid(c, f) for f in range(6)]
        ci = new_pt(frozenset(v), [verts[x] for x in v], cman)
        L[1, 0, 0] = em[(0, 1)]; L[1, 2, 0] = em[(2, 3)]  # noqa: E702
        L[1, 0, 2] = em[(4, 5)]; L[1, 2, 2] = em[(6, 7)]  # noqa: E702
        L[0, 1, 0] = em[(0, 2)]; L[2, 1, 0] = em[(1, 3)]  # noqa: E702
        L[0, 1, 2] = em[(4, 6)]; L[2, 1, 2] = em[(5, 7)]  # noqa: E702
        L[0, 0, 1] = em[(0, 4)]; L[2, 0, 1] = em[(1, 5)]  # noqa: E702
        L[0, 2, 1] = em[(2, 6)]; L[2, 2, 1] = em[(3, 7)]  # noqa: E702
        L[0, 1, 1] = fc[0]; L[2, 1, 1] = fc[1]  # noqa: E702
        L[1, 0, 1] = fc[2]; L[1, 2, 1] = fc[3]  # noqa: E702
        L[1, 1, 0] = fc[4]; L[1, 1, 2] = fc[5]  # noqa: E702
        L[1, 1, 1] = ci
        emit(c, L, b, fm, cman)
        new_tfic += [-1] * 8
        new_tfir += [[0.0, 0.0, 1.0, 1.0]] * 8

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
                tfi_rect=np.array(new_tfir, dtype=np.float64))
