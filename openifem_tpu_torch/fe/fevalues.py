"""Batched mapped shape-function data (FEValues/FEFaceValues replacement).

Everything is precomputed per mesh as dense arrays shaped for TPU batched
einsum: physical shape gradients (n_cells, n_q, n_local, dim), JxW
(n_cells, n_q), boundary-face tables, etc.  deal.II equivalent: FEValues with
update_values|update_gradients|update_JxW_values (e.g. reference:
source/insim.cpp:155-168).  Geometry mapping is (bi/tri)linear (MappingQ1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..mesh.mesh import Mesh
from .shapes import QkShapes, gauss_quadrature
from .space import FESpace

# outward unit normals of the unit cell faces, deal.II face order
_REF_NORMALS = {
    2: np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.float64),
    3: np.array([[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0],
                 [0, 0, -1], [0, 0, 1]], dtype=np.float64),
}


def _geometry_jacobians(mesh: Mesh, unit_points: np.ndarray):
    """Jacobian dX/dxi of the bilinear map at unit points for all cells.

    Returns (J (n_c, n_q, dim, dim), Jinv, detJ (n_c, n_q), xq (n_c,n_q,dim))
    """
    geo = QkShapes(1, mesh.dim)
    Ng, dNg = geo.evaluate(unit_points)  # (n_q, nv), (n_q, nv, dim)
    cv = mesh.vertices[mesh.cells]       # (n_c, nv, dim)
    J = np.einsum("qvd,cvx->cqxd", dNg, cv)  # dX_x/dxi_d
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    xq = np.einsum("qv,cvx->cqx", Ng, cv)
    return J, Jinv, detJ, xq


@dataclass
class CellValues:
    """Volume quadrature data for one FESpace."""
    N: np.ndarray        # (n_q, nl)
    grad: np.ndarray     # (n_c, n_q, nl, dim) physical gradients
    JxW: np.ndarray      # (n_c, n_q)
    xq: np.ndarray       # (n_c, n_q, dim) physical quadrature points


def cell_values(space: FESpace, n_q1d: int) -> CellValues:
    mesh = space.mesh
    qp, qw = gauss_quadrature(n_q1d, mesh.dim)
    N, dN = space.shapes.evaluate(qp)
    J, Jinv, detJ, xq = _geometry_jacobians(mesh, qp)
    # physical gradient: dN_phys = Jinv^T . dN_ref
    grad = np.einsum("qld,cqdx->cqlx", dN, Jinv)
    JxW = detJ * qw[None, :]
    return CellValues(N=N, grad=grad, JxW=JxW, xq=xq)


@dataclass
class FaceValues:
    """Boundary-face quadrature data for one FESpace.

    Faces are a flat list of (cell, local face); all arrays are batched over
    that list."""
    cells: np.ndarray        # (n_f,) cell index
    faces: np.ndarray        # (n_f,) local face index
    boundary_id: np.ndarray  # (n_f,)
    N: np.ndarray            # (n_f, n_q, nl) volume-element values at face q
    grad: np.ndarray         # (n_f, n_q, nl, dim)
    JxW: np.ndarray          # (n_f, n_q)
    normals: np.ndarray      # (n_f, n_q, dim) outward unit normals
    xq: np.ndarray           # (n_f, n_q, dim)


def _face_unit_points(dim: int, face: int, qp_face: np.ndarray) -> np.ndarray:
    """Embed unit-face quadrature points into the unit cell."""
    n_q = len(qp_face)
    out = np.zeros((n_q, dim))
    d_fix = face // 2
    val = 0.0 if face % 2 == 0 else 1.0
    free = [d for d in range(dim) if d != d_fix]
    for i, d in enumerate(free):
        out[:, d] = qp_face[:, i]
    out[:, d_fix] = val
    return out


def face_values(space: FESpace, n_q1d: int,
                face_list: Optional[Sequence[Tuple[int, int]]] = None
                ) -> Optional[FaceValues]:
    """Quadrature data on boundary faces (all of them by default)."""
    mesh = space.mesh
    if face_list is None:
        face_list = mesh.boundary_faces()
    if len(face_list) == 0:
        return None
    qp_f, qw_f = gauss_quadrature(n_q1d, mesh.dim - 1)
    n_q = len(qw_f)

    by_face: dict = {}
    for (c, f) in face_list:
        by_face.setdefault(f, []).append(c)

    cells_out, faces_out, bid_out = [], [], []
    N_out, grad_out, JxW_out, nrm_out, xq_out = [], [], [], [], []
    for f, cs in sorted(by_face.items()):
        cs = np.array(cs, dtype=np.int64)
        up = _face_unit_points(mesh.dim, f, qp_f)
        N, dN = space.shapes.evaluate(up)   # (n_q, nl), (n_q, nl, dim)
        geo = QkShapes(1, mesh.dim)
        Ng, dNg = geo.evaluate(up)
        cv = mesh.vertices[mesh.cells[cs]]  # (m, nv, dim)
        J = np.einsum("qvd,cvx->cqxd", dNg, cv)
        detJ = np.linalg.det(J)
        Jinv = np.linalg.inv(J)
        xq = np.einsum("qv,cvx->cqx", Ng, cv)
        grad = np.einsum("qld,cqdx->cqlx", dN, Jinv)
        # Nanson: n da = detJ J^{-T} n_ref dA ; face weight = |detJ J^{-T} n|
        nref = _REF_NORMALS[mesh.dim][f]
        jinvT_n = np.einsum("cqdx,d->cqx", Jinv, nref)
        mag = np.linalg.norm(jinvT_n, axis=-1)
        normals = jinvT_n / mag[..., None]
        JxW = detJ * mag * qw_f[None, :]
        m = len(cs)
        cells_out.append(cs)
        faces_out.append(np.full(m, f, dtype=np.int64))
        bid_out.append(mesh.boundary_id[cs, f])
        N_out.append(np.broadcast_to(N, (m,) + N.shape).copy())
        grad_out.append(grad)
        JxW_out.append(JxW)
        nrm_out.append(normals)
        xq_out.append(xq)

    return FaceValues(
        cells=np.concatenate(cells_out),
        faces=np.concatenate(faces_out),
        boundary_id=np.concatenate(bid_out),
        N=np.concatenate(N_out, axis=0),
        grad=np.concatenate(grad_out, axis=0),
        JxW=np.concatenate(JxW_out, axis=0),
        normals=np.concatenate(nrm_out, axis=0),
        xq=np.concatenate(xq_out, axis=0),
    )
