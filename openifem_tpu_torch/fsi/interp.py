"""Cross-mesh interpolation for the immersed FSI coupling.

Counterpart of openifem_tpu/fsi/interp.py (reference:
source/utilities.cpp:83-341, source/fsi.cpp:92-109): point location by a
uniform-grid cell hash (sort + searchsorted on int64 keys) and a batched
component-wise Newton inversion of the bilinear map, instead of per-point
cell walks.  `locate_points` is the all-pairs search whose semantics the
hash reproduces (the lowest containing cell wins), and `sph_interpolate`
the SPH kernel average from cell centres.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch


def shape_values(degree: int, dim: int, pts):
    """Q_k shape values at unit points. pts: (..., dim) ->
    (..., (degree+1)**dim), local ordering = lexicographic (x fastest),
    matching fe.shapes.QkShapes."""
    n1 = degree + 1
    nodes = torch.linspace(0.0, 1.0, n1, dtype=pts.dtype, device=pts.device)

    def lag1d(x):  # (...,) -> (..., n1)
        vals = []
        for i in range(n1):
            v = torch.ones_like(x)
            for j in range(n1):
                if j == i:
                    continue
                v = v * (x - nodes[j]) / (nodes[i] - nodes[j])
            vals.append(v)
        return torch.stack(vals, dim=-1)

    per_axis = [lag1d(pts[..., d]) for d in range(dim)]
    # local index l = i0 + n1*i1 + ... (x fastest)
    shape = []
    for l in range(n1 ** dim):
        rem = l
        v = None
        for d in range(dim):
            i = rem % n1
            rem //= n1
            t = per_axis[d][..., i]
            v = t if v is None else v * t
        shape.append(v)
    return torch.stack(shape, dim=-1)


def _solve_small_cw(A, r):
    """Solve the dim x dim system A dxi = r per flat-batch element
    (Cramer / cofactor form on lists of (N,) tensors)."""
    dim = len(r)
    if dim == 2:
        det = A[0][0] * A[1][1] - A[0][1] * A[1][0]
        inv_det = 1.0 / det
        return [(A[1][1] * r[0] - A[0][1] * r[1]) * inv_det,
                (A[0][0] * r[1] - A[1][0] * r[0]) * inv_det]
    c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1]
    c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2]
    c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0]
    c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2]
    c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0]
    c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1]
    c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1]
    c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2]
    c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0]
    inv_det = 1.0 / (A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02)
    return [(c00 * r[0] + c10 * r[1] + c20 * r[2]) * inv_det,
            (c01 * r[0] + c11 * r[1] + c21 * r[2]) * inv_det,
            (c02 * r[0] + c12 * r[1] + c22 * r[2]) * inv_det]


def invert_bilinear_cw(px, vx, n_iter: int = 6):
    """Component-wise Newton inversion of the (bi/tri)linear geometric map
    on a flat batch.

    px: list[dim] of (N,) point coordinates; vx: nested list vx[v][d] of
    (N,) corner coordinates (z-order corners, i fastest).  Returns xi as a
    list[dim] of (N,) unit coordinates."""
    dim = len(px)
    xi = [torch.full_like(px[0], 0.5) for _ in range(dim)]
    corners = [tuple((v >> a) & 1 for a in range(dim))
               for v in range(2 ** dim)]
    for _ in range(n_iter):
        f = [[1.0 - xi[a], xi[a]] for a in range(dim)]
        X = [None] * dim
        A = [[None] * dim for _ in range(dim)]
        for v, bits in enumerate(corners):
            N_v = None
            for a in range(dim):
                t = f[a][bits[a]]
                N_v = t if N_v is None else N_v * t
            for d in range(dim):
                t = N_v * vx[v][d]
                X[d] = t if X[d] is None else X[d] + t
            for ax in range(dim):
                # dN_v/dxi_ax = (+-1) * prod_{a != ax} f[a][bits[a]]
                g = None
                for a in range(dim):
                    if a == ax:
                        continue
                    t = f[a][bits[a]]
                    g = t if g is None else g * t
                sign = 1.0 if bits[ax] else -1.0
                for d in range(dim):
                    t = (sign * g) * vx[v][d]
                    A[d][ax] = t if A[d][ax] is None else A[d][ax] + t
        r = [px[d] - X[d] for d in range(dim)]
        dxi = _solve_small_cw(A, r)
        xi = [xi[a] + dxi[a] for a in range(dim)]
    return xi


def invert_bilinear(points, cell_verts, n_iter: int = 6):
    """Invert the (bi/tri)linear map for batches of (point, cell) pairs.

    points: (..., dim); cell_verts: (..., 2**dim, dim) in z-order; the
    batch shapes broadcast.  Returns unit coords (..., dim), by
    invert_bilinear_cw's Newton iteration on the flattened batch."""
    dim = points.shape[-1]
    batch = torch.broadcast_shapes(points.shape[:-1], cell_verts.shape[:-2])
    pts = points.expand(batch + (dim,)).reshape(-1, dim)
    cv = cell_verts.expand(batch + cell_verts.shape[-2:]).reshape(
        -1, 2 ** dim, dim)
    xi = invert_bilinear_cw([pts[:, a] for a in range(dim)],
                            [[cv[:, v, a] for a in range(dim)]
                             for v in range(2 ** dim)], n_iter)
    return torch.stack(xi, dim=-1).reshape(batch + (dim,))


def locate_points(points, cell_verts, cell_bbox_lo, cell_bbox_hi,
                  tol: float = 1e-10):
    """Find for each point the containing cell among all cells (a dense
    (n_p, n_c) search; make_cell_hash gives the same answer on K
    candidates per point).

    points: (n_p, dim); cell_verts: (n_c, 2**dim, dim);
    cell_bbox_lo/hi: (n_c, dim) bounding boxes (pre-inflated by caller).
    Returns (cell_idx (n_p,) [-1 if none], unit (n_p, dim), found); the
    lowest containing cell index wins."""
    inb = torch.all((points[:, None, :] >= cell_bbox_lo[None] - tol) &
                    (points[:, None, :] <= cell_bbox_hi[None] + tol),
                    dim=-1)                                # (n_p, n_c)
    xi = invert_bilinear(points[:, None, :], cell_verts[None])
    inside = torch.all((xi >= -1e-8) & (xi <= 1 + 1e-8), dim=-1) & inb
    # argmax returns the first maximum: the lowest containing cell
    idx = torch.argmax(inside.to(torch.int32), dim=1)
    found = torch.any(inside, dim=1)
    rows = torch.arange(points.shape[0], device=points.device)
    unit = torch.clamp(xi[rows, idx], 0.0, 1.0)
    return torch.where(found, idx, -1), unit, found


def sph_interpolate(targets, centers, diameters, values):
    """SPH cubic-spline-kernel interpolation from cell centres
    (Utils::SPHInterpolator, reference: source/utilities.cpp:83-190).

    targets: (n_t, d); centers: (n_c, d); diameters: (n_c,) smoothing
    lengths h (the reference uses the cell diameter); values: (n_c, ...)
    cell-centred data.  Returns kernel-weighted averages at the targets
    (0 where no centre is within 2 h)."""
    d = targets.shape[1]
    rel = targets[:, None, :] - centers[None, :, :]
    q = torch.linalg.vector_norm(rel, dim=-1) / diameters[None, :]
    coef = (10.0 / (7.0 * np.pi * diameters ** 2) if d == 2
            else 1.0 / (np.pi * diameters ** 3))[None, :]
    w = torch.where(q < 1.0, 1.0 - 1.5 * q ** 2 + 0.75 * q ** 3,
                    torch.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0)) * coef
    wsum = w.sum(dim=1)
    wsum = torch.where(wsum > 0, wsum, 1.0)
    out = torch.einsum("tc,c...->t...", w, values)
    return out / wsum.reshape((-1,) + (1,) * (values.dim() - 1))


def plan_cell_hash(cell_verts_np, safety: float = 1.0,
                   tol: float = 1e-10, max_dims_per_axis: int = 4096):
    """Host-side planning of a uniform-grid cell hash: pick static grid
    dims, per-cell bin span and query candidate count K from the geometry.

    cell_verts_np: (n_c, 2**dim, dim) numpy vertices of a REPRESENTATIVE
    configuration (for a moving mesh, the reference config; pass safety>1
    to leave headroom for deformation).  Returns (dims, span, K).  The
    binning arithmetic must match make_cell_hash's build exactly."""
    cv = np.asarray(cell_verts_np)
    dim = cv.shape[-1]
    lo_c, hi_c = cv.min(axis=1) - tol, cv.max(axis=1) + tol
    dom_lo, dom_hi = lo_c.min(axis=0), hi_c.max(axis=0)
    ext = np.maximum(dom_hi - dom_lo, 1e-300)
    cell_ext = np.maximum((hi_c - lo_c).max(axis=0), 1e-300)
    dims = tuple(int(np.clip(np.floor(ext[a] / cell_ext[a]), 1,
                             max_dims_per_axis)) for a in range(dim))
    inv_bin = np.asarray(dims) / ext
    b0 = np.clip(np.floor((lo_c - dom_lo) * inv_bin).astype(np.int64), 0,
                 np.asarray(dims) - 1)
    b1 = np.clip(np.floor((hi_c - dom_lo) * inv_bin).astype(np.int64), 0,
                 np.asarray(dims) - 1)
    span = int((b1 - b0 + 1).max())
    # exact bin occupancy with these dims
    strides = np.cumprod((1,) + dims[:-1])
    ids = []
    for off in product(*(range(span) for _ in range(dim))):
        b = b0 + np.asarray(off)
        ok = (b <= b1).all(axis=1)
        ids.append((b[ok] * strides).sum(axis=1))
    _, counts = np.unique(np.concatenate(ids), return_counts=True)
    K = int(np.ceil(counts.max() * safety)) + (4 if safety > 1 else 0)
    span = span + (1 if safety > 1 else 0)
    return dims, span, K


def check_cell_hash_capacity(cell_verts_np, dims, span: int, K: int,
                             tol: float = 1e-10, context: str = ""):
    """Host-side check that a (deformed) configuration still fits the
    statically planned (dims, span, K) of make_cell_hash.  Raises
    RuntimeError on overflow."""
    cv = np.asarray(cell_verts_np)
    dim = cv.shape[-1]
    lo_c, hi_c = cv.min(axis=1) - tol, cv.max(axis=1) + tol
    dom_lo, dom_hi = lo_c.min(axis=0), hi_c.max(axis=0)
    inv_bin = np.asarray(dims) / np.maximum(dom_hi - dom_lo, 1e-300)
    b0 = np.clip(np.floor((lo_c - dom_lo) * inv_bin).astype(np.int64), 0,
                 np.asarray(dims) - 1)
    b1 = np.clip(np.floor((hi_c - dom_lo) * inv_bin).astype(np.int64), 0,
                 np.asarray(dims) - 1)
    need_span = int((b1 - b0 + 1).max())
    if need_span > span:
        raise RuntimeError(
            f"cell hash overflow{context}: a deformed cell spans "
            f"{need_span} bins but the static plan enumerates {span}; "
            "point location would silently miss cells.  Re-plan the hash "
            "(plan_cell_hash with a larger safety factor).")
    strides = np.cumprod((1,) + tuple(dims)[:-1])
    ids = []
    for off in product(*(range(span) for _ in range(dim))):
        b = b0 + np.asarray(off)
        ok = (b <= b1).all(axis=1)
        ids.append((b[ok] * strides).sum(axis=1))
    _, counts = np.unique(np.concatenate(ids), return_counts=True)
    need_K = int(counts.max())
    if need_K > K:
        raise RuntimeError(
            f"cell hash overflow{context}: a bin holds {need_K} cells but "
            f"the static plan reads K={K} candidates; point location "
            "would silently truncate.  Re-plan the hash with a larger "
            "safety factor.")


def make_cell_hash(n_cells: int, dims, span: int, K: int,
                   tol: float = 1e-10, device=None):
    """Uniform-grid spatial hash with static shapes: build sorts the
    n_c*span**dim keys, locate gathers K candidate cells per point and
    runs the batched Newton inversion on (n_p, K) only.

    Returns (build, locate): build(cell_verts) -> state (called every step
    for a moving mesh); locate(state, points) -> (cell_idx, unit, found)
    (lowest containing cell id wins; idx -1 where not found)."""
    dims = tuple(int(x) for x in dims)
    dim = len(dims)
    n_bins = 1
    strides = []
    for a in range(dim):
        strides.append(n_bins)
        n_bins *= dims[a]
    i64 = dict(dtype=torch.int64, device=device)
    strides = torch.tensor(strides, **i64)
    dims_arr = torch.tensor(dims, **i64)
    BIG = n_bins * n_cells + n_cells  # > any valid key
    offsets = torch.tensor(list(product(*(range(span) for _ in range(dim)))),
                           **i64)  # (span**dim, dim)
    cell_ids = torch.arange(n_cells, **i64)[:, None]
    k_range = torch.arange(K, **i64)

    def _bins(x, dom_lo, inv_bin):
        return torch.minimum(
            torch.clamp(torch.floor((x - dom_lo) * inv_bin), min=0),
            (dims_arr - 1).to(x.dtype)).to(torch.int64)

    def build(cell_verts):
        lo_c = cell_verts.amin(dim=1) - tol
        hi_c = cell_verts.amax(dim=1) + tol
        dom_lo = lo_c.amin(dim=0)
        dom_hi = hi_c.amax(dim=0)
        inv_bin = dims_arr / torch.clamp(dom_hi - dom_lo, min=1e-300)
        b0 = _bins(lo_c, dom_lo, inv_bin)
        b1 = _bins(hi_c, dom_lo, inv_bin)
        b = b0[:, None, :] + offsets[None, :, :]      # (n_c, span**d, d)
        valid = torch.all(b <= b1[:, None, :], dim=-1)
        bin_id = (b * strides).sum(dim=-1)
        keys = torch.where(valid, bin_id * n_cells + cell_ids, BIG)
        sorted_keys, _ = torch.sort(keys.reshape(-1))
        return (sorted_keys, cell_verts, lo_c, hi_c, dom_lo, inv_bin)

    def locate(state, points):
        sorted_keys, cell_verts, lo_c, hi_c, dom_lo, inv_bin = state
        n_p = points.shape[0]
        pid = (_bins(points, dom_lo, inv_bin) * strides).sum(dim=-1)
        start = torch.searchsorted(sorted_keys, pid * n_cells, side="left")
        take = torch.clamp(start[:, None] + k_range, 0,
                           sorted_keys.shape[0] - 1)
        k_keys = sorted_keys[take]                           # (n_p, K)
        cand_ok = k_keys < (pid[:, None] + 1) * n_cells
        cand = torch.where(cand_ok, k_keys - pid[:, None] * n_cells, 0)
        cand = torch.clamp(cand, 0, n_cells - 1)
        # component-wise flat-batch Newton on (n_p*K,) arrays
        cf = cand.reshape(-1)
        px = [points[:, a, None].expand(n_p, K).reshape(-1)
              for a in range(dim)]
        vx = [[cell_verts[:, v, a][cf] for a in range(dim)]
              for v in range(2 ** dim)]
        inbb = cand_ok.reshape(-1)
        for a in range(dim):
            inbb = inbb & (px[a] >= lo_c[:, a][cf]) & \
                (px[a] <= hi_c[:, a][cf])
        xi = invert_bilinear_cw(px, vx)
        inside = inbb
        for a in range(dim):
            inside = inside & (xi[a] >= -1e-8) & (xi[a] <= 1 + 1e-8)
        inside = inside.reshape(n_p, K)
        # first containing candidate (argmax returns the first maximum)
        first = torch.argmax(inside.to(torch.int32), dim=1)
        found = torch.any(inside, dim=1)
        rows = torch.arange(n_p, device=points.device)
        idx = torch.where(found, cand[rows, first], -1)
        unit = torch.stack(
            [torch.clamp(x.reshape(n_p, K)[rows, first], 0.0, 1.0)
             for x in xi], dim=-1)
        return idx, unit, found

    return build, locate


def interpolate_nodal(field, cell_dofs, cell_idx, unit, degree: int,
                      found=None):
    """Evaluate a nodal field at located points.

    field: (n_nodes, ...) nodal values; cell_dofs: (n_c, nl);
    cell_idx (n_p,), unit (n_p, dim). Points not found give 0."""
    dim = unit.shape[-1]
    N = shape_values(degree, dim, unit)              # (n_p, nl)
    dofs = cell_dofs[torch.clamp(cell_idx, min=0)]   # (n_p, nl)
    vals = field[dofs]                               # (n_p, nl, ...)
    extra_dims = vals.dim() - 2
    out = torch.einsum("pl...,pl->p...", vals, N)
    if found is not None:
        out = out * found.reshape((len(cell_idx),) + (1,) * extra_dims)
    return out
