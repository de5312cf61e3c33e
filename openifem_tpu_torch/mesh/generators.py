"""Grid generators mirroring deal.II GridGenerator + Utils::GridCreator.

Reference: source/utilities.cpp:344-633 (GridCreator), deal.II GridGenerator
semantics for hyper_cube / subdivided_hyper_rectangle / hyper_ball /
hyper_cube_with_cylindrical_hole.  Boundary-id colorize conventions match
deal.II: face ids 0..2*dim-1 ordered [-x,+x,-y,+y,-z,+z].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.timer import span
from .manifolds import (CylindricalManifold, PolarManifold,
                        SphericalManifold, TransfiniteManifold)
from .mesh import FACE_VERTICES, Mesh


def subdivided_hyper_rectangle(repetitions: Sequence[int], p1, p2,
                               colorize: bool = True) -> Mesh:
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    dim = len(p1)
    reps = list(repetitions)
    axes = [np.linspace(p1[d], p2[d], reps[d] + 1) for d in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([g.ravel(order="F") for g in grids], axis=-1)

    def vid(idx):
        # x fastest
        s = 0
        mult = 1
        for d in range(dim):
            s += idx[d] * mult
            mult *= reps[d] + 1
        return s

    cells = []
    bids = []
    nf = 2 * dim
    if dim == 2:
        for j in range(reps[1]):
            for i in range(reps[0]):
                cells.append([vid((i, j)), vid((i + 1, j)),
                              vid((i, j + 1)), vid((i + 1, j + 1))])
                b = [-1] * nf
                if colorize:
                    if i == 0:
                        b[0] = 0
                    if i == reps[0] - 1:
                        b[1] = 1
                    if j == 0:
                        b[2] = 2
                    if j == reps[1] - 1:
                        b[3] = 3
                else:
                    if i == 0:
                        b[0] = 0
                    if i == reps[0] - 1:
                        b[1] = 0
                    if j == 0:
                        b[2] = 0
                    if j == reps[1] - 1:
                        b[3] = 0
                bids.append(b)
    elif dim == 3:
        for k in range(reps[2]):
            for j in range(reps[1]):
                for i in range(reps[0]):
                    cells.append([
                        vid((i, j, k)), vid((i + 1, j, k)),
                        vid((i, j + 1, k)), vid((i + 1, j + 1, k)),
                        vid((i, j, k + 1)), vid((i + 1, j, k + 1)),
                        vid((i, j + 1, k + 1)), vid((i + 1, j + 1, k + 1))])
                    b = [-1] * nf
                    lo = (i == 0, j == 0, k == 0)
                    hi = (i == reps[0] - 1, j == reps[1] - 1, k == reps[2] - 1)
                    for d in range(3):
                        if lo[d]:
                            b[2 * d] = 2 * d if colorize else 0
                        if hi[d]:
                            b[2 * d + 1] = 2 * d + 1 if colorize else 0
                    bids.append(b)
    else:
        raise NotImplementedError
    return Mesh(dim=dim, vertices=verts,
                cells=np.array(cells, dtype=np.int64),
                boundary_id=np.array(bids, dtype=np.int32))


def hyper_cube(left: float = 0.0, right: float = 1.0, dim: int = 2,
               colorize: bool = True) -> Mesh:
    return subdivided_hyper_rectangle([1] * dim, [left] * dim, [right] * dim,
                                      colorize=colorize)


def merge_meshes(a: Mesh, b: Mesh, tolerance: float) -> Mesh:
    """Merge two meshes, collapsing vertices within ``tolerance``.

    Vertices of ``a`` win on collision (deal.II merge_triangulations keeps
    the first triangulation's vertex positions).
    """
    assert a.dim == b.dim
    verts = list(a.vertices)
    mapping = np.zeros(len(b.vertices), dtype=np.int64)
    averts = np.asarray(a.vertices)
    for i, v in enumerate(b.vertices):
        d = np.linalg.norm(averts - v[None, :], axis=1)
        j = int(np.argmin(d))
        if d[j] <= tolerance:
            mapping[i] = j
        else:
            mapping[i] = len(verts)
            verts.append(v)
    cells = np.concatenate([a.cells, mapping[b.cells]], axis=0)
    boundary = np.concatenate([a.boundary_id, b.boundary_id], axis=0)
    fman = np.concatenate([a.face_manifold, b.face_manifold], axis=0)
    cman = np.concatenate([a.cell_manifold, b.cell_manifold], axis=0)
    mat = np.concatenate([a.material_id, b.material_id], axis=0)
    m = Mesh(dim=a.dim, vertices=np.array(verts), cells=cells,
             material_id=mat, boundary_id=boundary, face_manifold=fman,
             cell_manifold=cman, manifolds={**a.manifolds, **b.manifolds})
    _fix_interior_boundary_flags(m)
    return m


def _fix_interior_boundary_flags(m: Mesh):
    """Clear boundary ids on faces that became interior after a merge."""
    fm = m._face_map()
    for key, lst in fm.items():
        if len(lst) >= 2:
            for (c, f) in lst:
                m.boundary_id[c, f] = -1


def remove_cells(m: Mesh, mask: np.ndarray) -> Mesh:
    """Remove cells where mask is True; exposed faces become boundary id 0."""
    keep = ~np.asarray(mask, dtype=bool)
    cells = m.cells[keep]
    used = np.unique(cells)
    remap = -np.ones(m.n_vertices, dtype=np.int64)
    remap[used] = np.arange(len(used))
    out = Mesh(dim=m.dim, vertices=m.vertices[used], cells=remap[cells],
               material_id=m.material_id[keep],
               boundary_id=m.boundary_id[keep],
               face_manifold=m.face_manifold[keep],
               cell_manifold=m.cell_manifold[keep],
               level=m.level[keep], manifolds=m.manifolds,
               tfi=m.tfi, tfi_coarse=m.tfi_coarse[keep],
               tfi_rect=m.tfi_rect[keep])
    # faces that lost their neighbor become boundary (id 0, deal.II default)
    fmap = out._face_map()
    fv = FACE_VERTICES[out.dim]
    for c in range(out.n_cells):
        for f in range(2 * out.dim):
            key = frozenset(int(out.cells[c, v]) for v in fv[f])
            if len(fmap[key]) == 1 and out.boundary_id[c, f] < 0:
                out.boundary_id[c, f] = 0
    return out


def hyper_ball(center, radius: float, dim: int = 2) -> Mesh:
    """deal.II GridGenerator::hyper_ball: 5 cells (2D) / 7 cells (3D)."""
    center = np.asarray(center, dtype=np.float64)
    if dim == 2:
        a = 1.0 / (1.0 + np.sqrt(2.0))  # inner square scale (deal.II)
        d = radius / np.sqrt(2.0)
        V = np.array([
            [-d, -d], [d, -d],
            [-a * d, -a * d], [a * d, -a * d],
            [-a * d, a * d], [a * d, a * d],
            [-d, d], [d, d],
        ]) + center
        # z-order cells, positively oriented
        cells = np.array([
            [0, 1, 2, 3],    # bottom trapezoid
            [0, 2, 6, 4],    # left
            [2, 3, 4, 5],    # center square
            [1, 7, 3, 5],    # right
            [6, 4, 7, 5],    # top  (careful with orientation)
        ], dtype=np.int64)
        # fix orientation: ensure positive jacobian by construction below
        cells = np.array([_orient_quad(V, c) for c in cells])
        m = Mesh(dim=2, vertices=V, cells=cells)
    else:
        # 7-cell ball: inner cube + 6 shell cells
        d = radius / np.sqrt(3.0)
        a = 1.0 / (1.0 + np.sqrt(3.0)) * (1.0 + np.sqrt(3.0)) / 2.0  # 0.5
        a = 0.5
        corners = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1)
                            for x in (-1, 1)], dtype=np.float64)
        Vout = corners * d + center
        Vin = corners * (a * d) + center
        V = np.concatenate([Vout, Vin], axis=0)
        IN = 8
        cells = [
            [IN + 0, IN + 1, IN + 2, IN + 3,
             IN + 4, IN + 5, IN + 6, IN + 7],  # inner cube
        ]
        # shell cells: one per face of the inner cube, z-order assembled
        face_pairs = FACE_VERTICES[3]
        for f in range(6):
            inner = [IN + v for v in face_pairs[f]]
            outer = [v for v in face_pairs[f]]
            # orient: from face to outside; build hex as (face plane, outer)
            if f % 2 == 0:  # -side: outward is -axis; flip to keep det > 0
                cells.append([outer[0], outer[1], outer[2], outer[3],
                              inner[0], inner[1], inner[2], inner[3]])
            else:
                cells.append([inner[0], inner[1], inner[2], inner[3],
                              outer[0], outer[1], outer[2], outer[3]])
        cells = np.array([_orient_hex(V, c) for c in cells], dtype=np.int64)
        m = Mesh(dim=3, vertices=V, cells=cells)
    # boundary faces + manifolds (sphere boundary, TFI-ish interior)
    _mark_exposed_boundary(m)
    return m


def _orient_quad(V, c):
    c = list(c)
    v = V[c]
    # bilinear jacobian at center
    dx = 0.5 * ((v[1] - v[0]) + (v[3] - v[2]))
    dy = 0.5 * ((v[2] - v[0]) + (v[3] - v[1]))
    if dx[0] * dy[1] - dx[1] * dy[0] < 0:
        c = [c[0], c[2], c[1], c[3]]
    return c


def _orient_hex(V, c):
    c = list(c)
    v = V[c]
    dx = v[1] - v[0]
    dy = v[2] - v[0]
    dz = v[4] - v[0]
    if np.linalg.det(np.stack([dx, dy, dz])) < 0:
        c = [c[0], c[2], c[1], c[3], c[4], c[6], c[5], c[7]]
    return c


def _mark_exposed_boundary(m: Mesh, bid: int = 0):
    from ..native import face_occurrences
    occ = face_occurrences(m.cells, m.dim)
    if occ is not None:
        m.boundary_id[occ == 1] = bid
        return
    fmap = m._face_map()
    fv = FACE_VERTICES[m.dim]
    for c in range(m.n_cells):
        for f in range(2 * m.dim):
            key = frozenset(int(m.cells[c, v]) for v in fv[f])
            if len(fmap[key]) == 1:
                m.boundary_id[c, f] = bid


def sphere(center, radius: float, dim: int = 2) -> Mesh:
    """Utils::GridCreator::sphere (reference: source/utilities.cpp:577-589):
    hyper_ball with spherical boundary manifold."""
    m = hyper_ball(center, radius, dim)
    sph = SphericalManifold(center)
    m.manifolds[0] = sph
    for c in range(m.n_cells):
        for f in range(2 * m.dim):
            if m.boundary_id[c, f] >= 0:
                m.face_manifold[c, f] = 0
    return m


def extrude(m2: Mesh, n_slices: int, height: float) -> Mesh:
    """Extrude a 2D mesh along z into n_slices-1 layers of hexes."""
    assert m2.dim == 2
    zs = np.linspace(0.0, height, n_slices)
    nv = m2.n_vertices
    verts = np.concatenate([
        np.concatenate([m2.vertices, np.full((nv, 1), z)], axis=1)
        for z in zs], axis=0)
    cells = []
    bids = []
    fman = []
    mat = []
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
    # the 2-D transfinite charts carry over: a layer's cell keeps its
    # quad's chart in (x, y) and is linear in z
    return Mesh(dim=3, vertices=verts,
                cells=np.array(cells, dtype=np.int64),
                material_id=np.array(mat, dtype=np.int32),
                boundary_id=np.array(bids, dtype=np.int32),
                face_manifold=np.array(fman, dtype=np.int32),
                manifolds=dict(m2.manifolds), tfi=m2.tfi,
                tfi_coarse=np.tile(m2.tfi_coarse, n_slices - 1),
                tfi_rect=np.tile(m2.tfi_rect, (n_slices - 1, 1)))


def cylinder(radius: float, length: float) -> Mesh:
    """Utils::GridCreator::cylinder (reference: source/utilities.cpp:591-633)."""
    m2 = sphere([0.0, 0.0], radius, dim=2)
    n = int(length / (4 * radius))
    m3 = extrude(m2, max(n, 2), length)
    cyl = CylindricalManifold(axis=2)
    m3.manifolds[0] = cyl
    for c in range(m3.n_cells):
        for f in range(6):
            if m3.boundary_id[c, f] >= 0:
                fc = m3.vertices[[m3.cells[c, v]
                                  for v in FACE_VERTICES[3][f]]].mean(axis=0)
                if abs(fc[2]) < 1e-10:
                    m3.boundary_id[c, f] = 1
                    m3.face_manifold[c, f] = -1
                elif abs(fc[2] - length) < 1e-10:
                    m3.boundary_id[c, f] = 2
                    m3.face_manifold[c, f] = -1
                else:
                    m3.face_manifold[c, f] = 0
    return m3


def _hyper_shell_squashed(inner_radius: float, outer_half: float) -> Mesh:
    """deal.II hyper_cube_with_cylindrical_hole(inner_radius, outer_half):
    8-cell shell with the outer ring squashed onto the square
    [-outer_half, outer_half]^2."""
    angles = np.arange(8) * (2 * np.pi / 8)
    inner = inner_radius * np.stack([np.cos(angles), np.sin(angles)], axis=1)
    outer_circ = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    # map circle to square: scale so the max-|coord| equals outer_half
    outer = outer_circ * (outer_half /
                          np.abs(outer_circ).max(axis=1, keepdims=True))
    V = np.concatenate([inner, outer], axis=0)
    cells = []
    for k in range(8):
        kn = (k + 1) % 8
        cells.append(_orient_quad(V, [k, kn, 8 + k, 8 + kn]))
    m = Mesh(dim=2, vertices=V, cells=np.array(cells, dtype=np.int64))
    _mark_exposed_boundary(m)
    return m


def flow_around_cylinder_2d(compute_in_2d: bool = True) -> Mesh:
    """Turek/Schaefer benchmark mesh
    (reference: source/utilities.cpp:344-489)."""
    left = 0.0 if compute_in_2d else -0.3
    nx = 22 if compute_in_2d else 25
    bulk = subdivided_hyper_rectangle([nx, 4], [left, 0.0], [2.2, 0.41],
                                      colorize=False)
    centers = bulk.cell_centers()
    remove = np.linalg.norm(centers - np.array([0.2, 0.2]), axis=1) < 0.15
    # the removed block is the 2 x 2 cells around the grid point nearest
    # (0.2, 0.2); the shell is centred on that point whatever `left` is
    # (the JAX package's offset, 2 (left + dx, dy) - (left, 0) + (left, 0),
    # holds only for left = 0 and puts the 3-D base's shell at x = -0.4)
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

    # manifolds: polar on the hole boundary, transfinite interpolation in
    # the shell cells (reference: source/utilities.cpp:420-470)
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


def flow_around_cylinder(dim: int = 2) -> Mesh:
    """Boundary ids: 2D: 0 inflow(x=0), 1 outflow(x=2.2), 2 bottom, 3 top,
    4 cylinder (reference: source/utilities.cpp:490-530).
    3D: 0 inflow (x = -0.3), 1 outflow (x = 2.2), 2/3 y = 0/0.41, 4/5
    z = 0/0.41, 6 cylinder (axis along z through (0.2, 0.2), radius 0.05,
    on a cylindrical manifold; the shell cells refine through the 2-D
    transfinite charts in (x, y) and linearly in z)."""
    with span("mesh"):
        if dim == 2:
            m = flow_around_cylinder_2d(True)
            _assign_cylinder_boundary_ids(m, x_lo=0.0, cyl_id=4)
            return m
        m2 = flow_around_cylinder_2d(False)
        m = extrude(m2, 9, 0.41)
        m.manifolds = {0: CylindricalManifold(axis=2,
                                              center=[0.2, 0.2, 0.0])}
        for c in range(m.n_cells):
            for f in range(6):
                if m.boundary_id[c, f] < 0:
                    continue
                fc = m.vertices[[m.cells[c, v]
                                 for v in FACE_VERTICES[3][f]]].mean(axis=0)
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


def _assign_cylinder_boundary_ids(m: Mesh, x_lo: float, cyl_id: int):
    for c in range(m.n_cells):
        for f in range(4):
            if m.boundary_id[c, f] < 0:
                continue
            fc = m.vertices[[m.cells[c, v]
                             for v in FACE_VERTICES[2][f]]].mean(axis=0)
            if abs(fc[0] - 2.2) < 1e-12:
                m.boundary_id[c, f] = 1
            elif abs(fc[0] - x_lo) < 1e-12:
                m.boundary_id[c, f] = 0
            elif abs(fc[1] - 0.41) < 1e-12:
                m.boundary_id[c, f] = 3
            elif abs(fc[1]) < 1e-12:
                m.boundary_id[c, f] = 2
            else:
                m.boundary_id[c, f] = cyl_id
