r"""Kelly error estimator (deal.II KellyErrorEstimator analog).

Counterpart of openifem_tpu/fe/kelly.py (reference use: standalone mesh
adaptivity, source/fluid_solver.cpp:215-265,
source/solid_solver.cpp:209-268):
  eta_K^2 = sum_{faces F of K} (h_F / 24) \int_F [d u_h / d n]^2 ds
with the jump evaluated across interior conforming faces and across each
fine subface of a hanging face against its coarse neighbour.  Face
quadrature points of one side are pulled back into the neighbour with
the batched bilinear inversion, so the jump is sampled at identical
physical points.

Everything runs on the host in float64 (numpy, and the inversion on CPU
tensors), whatever the solver's device: the refinement flags sort these
indicators, so a run on the card and one on the CPU flag the same cells
from the same solution.

One difference from the JAX package: face_values returns its faces
grouped by local face number, and the JAX function pairs them with its
face list in the list's own order, so most pairs take the gradient of one
face and the neighbour of another.  Here face_values' arrays are put back
in the list's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fsi.interp import invert_bilinear
from ..mesh.mesh import FACE_VERTICES
from .fevalues import face_values
from .shapes import QkShapes


def _invert(points, cell_verts):
    return invert_bilinear(
        torch.as_tensor(points, dtype=torch.float64),
        torch.as_tensor(cell_verts, dtype=torch.float64)).numpy()


def _interface_pairs(mesh):
    """([(cell, face) of side A], [cell of side B]): the interior
    conforming faces, then each fine subface of a hanging face with the
    coarse cell across it (found geometrically: a probe just outside the
    subface's centre, in a strictly coarser cell)."""
    fmap = mesh._face_map()
    pairs = [lst for lst in fmap.values() if len(lst) == 2]
    side_a = [p[0] for p in pairs]
    cells_b = [p[1][0] for p in pairs]
    # a fine subface appears in the face map with no partner (its key
    # holds mid-edge vertices) but is not on the boundary
    orphans = [lst[0] for lst in fmap.values()
               if len(lst) == 1 and mesh.boundary_id[lst[0][0],
                                                     lst[0][1]] < 0]
    if not orphans:
        return side_a, cells_b
    fv_tab = FACE_VERTICES[mesh.dim]
    centers = mesh.cell_centers()
    lev = mesh.level
    orphan_cells = np.array(sorted({c for c, _ in orphans}))
    orph_c = np.array([c for c, _ in orphans])
    fverts = mesh.vertices[
        mesh.cells[orph_c[:, None],
                   np.array([list(fv_tab[f]) for _, f in orphans])]]
    x = fverts.mean(axis=1)
    probes = x + 0.1 * (x - centers[orph_c])
    # candidate filter (bbox, strictly coarser, not self), then one
    # batched inversion over the surviving (probe, cell) pairs
    v2 = mesh.vertices[mesh.cells[orphan_cells]]
    lo, hi = v2.min(axis=1), v2.max(axis=1)
    inbox = ((probes[:, None, :] >= lo[None] - 1e-12).all(-1) &
             (probes[:, None, :] <= hi[None] + 1e-12).all(-1))
    mask = (inbox & (lev[orphan_cells][None, :] < lev[orph_c][:, None])
            & (orphan_cells[None, :] != orph_c[:, None]))
    oi, cj = np.nonzero(mask)
    if len(oi):
        unit = _invert(probes[oi], v2[cj])
        ok = (unit > -1e-8).all(-1) & (unit < 1 + 1e-8).all(-1)
        taken = set()
        for t in np.nonzero(ok)[0]:
            o = int(oi[t])
            if o in taken:
                continue
            taken.add(o)
            side_a.append(orphans[o])
            cells_b.append(int(orphan_cells[cj[t]]))
    return side_a, cells_b


def kelly_estimate(space, solution, n_components: int = 1,
                   component_offset: int = 0):
    """Per-cell error indicators for (a component block of) a nodal field.

    solution: flat dof vector (tensor or array) laid out node-major with
    `n_components` per node starting at `component_offset` (e.g. the
    velocity block of a fluid solution).  Returns (n_cells,) float64
    numpy indicators."""
    mesh = space.mesh
    dim = mesh.dim
    side_a, cells_b = _interface_pairs(mesh)
    if not side_a:
        return np.zeros(mesh.n_cells)
    cells_a = np.array([c for c, _ in side_a])
    cells_b = np.asarray(cells_b)

    nq = space.degree + 1
    fva = face_values(space, nq, side_a)
    # face_values groups its faces by local face number (stable within
    # one face number): put its arrays back in the order of side_a
    back = np.argsort(np.argsort([f for _, f in side_a], kind="stable"))
    assert np.array_equal(fva.cells[back], cells_a)
    grad_a_shapes, normals, JxW = fva.grad[back], fva.normals[back], \
        fva.JxW[back]
    xq = fva.xq[back]

    # physical q points from side A, pulled back into the side-B cells
    n_f, n_q = JxW.shape
    vb_rep = np.repeat(mesh.vertices[mesh.cells[cells_b]], n_q, axis=0)
    unit_b = _invert(xq.reshape(-1, dim), vb_rep)

    # shape gradients of side B at those unit points
    _, dN = space.shapes.evaluate(unit_b)
    _, dNg = QkShapes(1, dim).evaluate(unit_b)
    Jb = np.einsum("pvd,pvx->pxd", dNg, vb_rep)
    grad_b_shapes = np.einsum("pld,pdx->plx", dN, np.linalg.inv(Jb))

    if isinstance(solution, torch.Tensor):
        solution = solution.detach().cpu().numpy()
    sol = np.asarray(solution, dtype=np.float64)
    eta2 = np.zeros(mesh.n_cells)
    h_f = JxW.sum(axis=1)  # face measure ~ h_F
    n_nodes = space.n_nodes
    for comp in range(n_components):
        field = sol[component_offset + np.arange(n_nodes) * n_components
                    + comp]
        grad_a = np.einsum("fqlx,fl->fqx", grad_a_shapes,
                           field[space.cell_dofs[cells_a]])
        lb = field[space.cell_dofs[cells_b]]
        grad_b = np.einsum("plx,pl->px", grad_b_shapes,
                           np.repeat(lb, n_q, axis=0)).reshape(n_f, n_q,
                                                               dim)
        jump = np.einsum("fqx,fqx->fq", grad_a - grad_b, normals)
        contrib = (h_f / 24.0) * (jump ** 2 * JxW).sum(axis=1)
        # unbuffered adds in the JAX package's loop order: a0, b0, a1, ...
        np.add.at(eta2, np.stack([cells_a, cells_b], axis=1).ravel(),
                  np.repeat(contrib, 2))
    return np.sqrt(eta2)


def refine_fraction_flags(indicators: np.ndarray, top_fraction: float = 0.6):
    """deal.II refine_and_coarsen_fixed_fraction's refinement half: flag the
    largest-error cells accounting for `top_fraction` of the total error."""
    order = np.argsort(indicators)[::-1]
    err = indicators[order] ** 2
    csum = np.cumsum(err)
    total = csum[-1] if len(csum) else 0.0
    flags = np.zeros(len(indicators), dtype=bool)
    if total <= 0:
        return flags
    k = int(np.searchsorted(csum, top_fraction * total)) + 1
    flags[order[:k]] = True
    return flags


def coarsen_fraction_flags(indicators: np.ndarray,
                           bottom_fraction: float = 0.4):
    """deal.II refine_and_coarsen_fixed_fraction's coarsening half: flag the
    smallest-error cells accounting for `bottom_fraction` of the total."""
    order = np.argsort(indicators)
    err = indicators[order] ** 2
    csum = np.cumsum(err)
    total = csum[-1] if len(csum) else 0.0
    flags = np.zeros(len(indicators), dtype=bool)
    if total <= 0:
        return flags
    k = int(np.searchsorted(csum, bottom_fraction * total, side="right"))
    flags[order[:k]] = True
    return flags
