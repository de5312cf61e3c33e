"""Solution transfer between meshes (deal.II SolutionTransfer analog).

Counterpart of openifem_tpu/fe/transfer.py, used on mesh adaptation
(reference: source/fsi.cpp:443-456, source/fluid_solver.cpp:215-265):
nodal fields of the old FE space are evaluated at the new space's support
points by the grid-hash point location and interpolation of
fsi/interp.py.  Refinement keeps the FE space, so the transfer is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..fsi.interp import (interpolate_nodal, invert_bilinear, make_cell_hash,
                          plan_cell_hash)

# how far from an old cell, in that cell's diameters, a new support point
# may lie and still take that cell's clamped value
NEAR_CELL = 0.5
# (missing point, old cell) pairs handled at once
_PAIRS = 1 << 20


def _unit_to_point(cell_verts, unit):
    """The points at unit coordinates (..., dim) of the (bi/tri)linear
    cells with z-order corners (..., 2**dim, dim)."""
    dim = unit.shape[-1]
    out = 0.0
    for v in range(2 ** dim):
        w = 1.0
        for a in range(dim):
            w = w * (unit[..., a] if (v >> a) & 1 else 1.0 - unit[..., a])
        out = out + w[..., None] * cell_verts[..., v, :]
    return out


def _nearest_cells(pts, cell_verts):
    """(cell, unit coordinates clamped to the unit square, distance) of
    the old cell nearest each point, the distance measured to the
    cell's image of the clamped coordinates.  The clamped coordinates
    alone would not do: a bilinear map extrapolated far outside its cell
    has spurious inverses, some just outside the unit square."""
    step = max(1, _PAIRS // len(cell_verts))
    out = []
    for lo in range(0, len(pts), step):
        p = pts[lo:lo + step]
        xi = torch.clamp(invert_bilinear(p[:, None, :], cell_verts[None]),
                         0.0, 1.0)
        dist = torch.linalg.vector_norm(
            _unit_to_point(cell_verts[None], xi) - p[:, None, :], dim=-1)
        dist = torch.where(torch.isfinite(dist), dist, np.inf)
        best = torch.argmin(dist, dim=1)
        rows = torch.arange(len(p), device=p.device)
        out.append((best, xi[rows, best], dist[rows, best]))
    return tuple(torch.cat(t) for t in zip(*out))


def transfer_nodal_field(old_mesh, old_space, old_field, new_points,
                         pad: float = 1e-9):
    """Evaluate a nodal field of old_space at new_points.

    old_field: (n_old_nodes,) or (n_old_nodes, k) tensor (its device is
    the transfer's) or numpy array (the CPU).  Returns (n_new, ...) on
    that device.

    A point in no old cell is a boundary point that refinement put on a
    curved manifold, outside the old cells' straight edges: it takes the
    value of the old cell nearest it, at its unit coordinates in that
    cell clamped to the unit square.  For a point on the outward normal
    of an old edge that is the parent's value at the edge point, as
    deal.II's hierarchical SolutionTransfer gives.  (The JAX package
    interpolates such points to 0.)  A point farther than NEAR_CELL
    diameters from every old cell raises."""
    field = torch.as_tensor(old_field)
    dev = field.device
    verts = old_mesh.vertices[old_mesh.cells]
    dims, span, K = plan_cell_hash(verts, tol=pad)
    build, locate = make_cell_hash(old_mesh.n_cells, dims, span, K,
                                   tol=pad, device=dev)
    cell_verts = torch.as_tensor(verts, dtype=real_dtype(), device=dev)
    pts = torch.as_tensor(np.asarray(new_points), dtype=real_dtype(),
                          device=dev)
    idx, unit, found = locate(build(cell_verts), pts)
    missing = torch.nonzero(~found)[:, 0]
    if len(missing):
        best, xi, dist = _nearest_cells(pts[missing], cell_verts)
        diam = torch.as_tensor(old_mesh.cell_diameters(),
                               dtype=real_dtype(), device=dev)
        far = int((dist > NEAR_CELL * diam[best]).sum())
        if far:
            raise RuntimeError(
                f"transfer_nodal_field: {far} of {len(pts)} new support "
                "points lie in no cell of the old mesh, nor near one")
        idx = idx.index_put((missing,), best)
        unit = unit.index_put((missing,), xi)
    cell_dofs = torch.as_tensor(old_space.cell_dofs, dtype=torch.int64,
                                device=dev)
    return interpolate_nodal(field, cell_dofs, idx, unit, old_space.degree)
