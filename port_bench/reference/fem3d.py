"""Plain Taylor-Hood (Q2 velocity, Q1 pressure) implicit Navier-Stokes step
on hexahedra.

The fluid of the 3-D cells' reference, the same weak form, time step and
grad-div as fem.py's TaylorHood, worked out again on hexahedra in a form
of its own; it imports nothing of the program.  Nodes are keyed by
position, every Dirichlet face's Q2 nodes are constrained, the Newton
matrix is the automatic derivative of the element residual and the linear
systems are solved directly (SuperLU).  The meshes are conforming (global
refinement only): a face that lies in one cell and carries no boundary id
raises.

Weak form (backward Euler, grad-div, as OpenIFEM's InsIM,
source/mpi_insim.cpp:263-304), with r the negative residual:
  r_u = -nu (grad u, grad v) - rho ((u.grad) u, v) + (p, div v)
        - gamma rho (div u, div v) - rho/dt (u - u_old, v)
  r_p = (div u, q)
The geometry map is trilinear; quadrature is Gauss with 3 points per axis.

The residual is assembled in blocks of `block` cells, each block's
geometry computed once and kept (about 1 GB of gradients at 1.4
million dofs), so that a million dofs fit the host.  `dtype` is the
precision of the whole computation: float64 for the reference, float32
for the control.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from .fem import gauss_1d, keys_of, lagrange_1d, rel_gap

# hexahedron faces [-x, +x, -y, +y, -z, +z] as local vertices (z-order)
FACES = ((0, 2, 4, 6), (1, 3, 5, 7), (0, 1, 4, 5), (2, 3, 6, 7),
         (0, 1, 2, 3), (4, 5, 6, 7))


def unit_nodes(k):
    """Unit coordinates of the Q_k local nodes, x fastest."""
    t = np.linspace(0.0, 1.0, k + 1)
    return np.array([(t[i], t[j], t[m]) for m in range(k + 1)
                     for j in range(k + 1) for i in range(k + 1)])


def tensor_shapes(k, pts):
    """Q_k values (n, nl) and unit gradients (n, nl, 3) at unit points
    (n, 3); local node l = ix + (k+1) iy + (k+1)^2 iz."""
    pts = np.asarray(pts, dtype=np.float64)
    V = [lagrange_1d(k, pts[:, a]) for a in range(3)]
    n = len(pts)

    def prod(fx, fy, fz):
        return np.einsum("qi,qj,qm->qmji", fx, fy, fz).reshape(n, -1)
    (Vx, Dx), (Vy, Dy), (Vz, Dz) = V
    N = prod(Vx, Vy, Vz)
    grad = np.stack([prod(Dx, Vy, Vz), prod(Vx, Dy, Vz), prod(Vx, Vy, Dz)],
                    axis=-1)
    return N, grad


def face_nodes(k):
    """Local Q_k nodes on each of the six faces."""
    un = unit_nodes(k)
    return [np.nonzero(np.abs(un[:, f // 2] - (f % 2)) < 1e-12)[0]
            for f in range(6)]


def map_points(cell_verts, unit):
    """Physical positions (c, n, 3) of unit points under each cell's
    trilinear map."""
    G, _ = tensor_shapes(1, unit)
    return np.einsum("nv,cvx->cnx", G, cell_verts)


class TaylorHood3D:
    """Q2/Q1 spaces, Dirichlet constraints and the Newton step on one
    hexahedral mesh.

    vertices (n_v, 3), cells (n_c, 8) in z-order, boundary_id (n_c, 6)
    with -1 on interior faces; dirichlet: {boundary id: fn(points,
    component)}, the smaller id first where faces meet; params: viscosity,
    rho, grad_div, dt."""

    def __init__(self, vertices, cells, boundary_id, dirichlet, params,
                 dtype=torch.float64, block=4096):
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.params = params
        self.block = block
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.cells = np.asarray(cells, dtype=np.int64)
        n_c = len(self.cells)
        self.n_cells = n_c
        self._conforming(boundary_id)

        # Q2 nodes by position
        u_pts = map_points(self.vertices[self.cells], unit_nodes(2))
        ukeys, uinv = np.unique(keys_of(u_pts.reshape(-1, 3)), axis=0,
                                return_inverse=True)
        self.u_nodes = uinv.reshape(n_c, 27)
        self.n_unodes = len(ukeys)
        self.u_points = np.zeros((self.n_unodes, 3))
        self.u_points[self.u_nodes.ravel()] = u_pts.reshape(-1, 3)
        del u_pts
        # Q1 nodes: the cell vertices, by position
        cv = self.vertices[self.cells]
        pkeys, pinv = np.unique(keys_of(cv.reshape(-1, 3)), axis=0,
                                return_inverse=True)
        self.p_nodes = pinv.reshape(n_c, 8)
        self.n_pnodes = len(pkeys)
        self.p_points = np.zeros((self.n_pnodes, 3))
        self.p_points[self.p_nodes.ravel()] = cv.reshape(-1, 3)

        self.n_u = 3 * self.n_unodes
        self.n = self.n_u + self.n_pnodes
        self.cell_dofs = np.concatenate(
            [(self.u_nodes[:, :, None] * 3 + np.arange(3)).reshape(n_c, 81),
             self.n_u + self.p_nodes], axis=1)

        qp1, qw1 = gauss_1d(3)
        self.qp = np.array([(qp1[i], qp1[j], qp1[m]) for m in range(3)
                            for j in range(3) for i in range(3)])
        self.qw = np.array([qw1[i] * qw1[j] * qw1[m] for m in range(3)
                            for j in range(3) for i in range(3)])
        self.N2, self.dN2 = tensor_shapes(2, self.qp)
        self.N1, _ = tensor_shapes(1, self.qp)
        _, self.dG = tensor_shapes(1, self.qp)
        self._t = {name: torch.as_tensor(a, dtype=dtype) for name, a in (
            ("N2", self.N2), ("N1", self.N1))}
        self._boundary(boundary_id, dirichlet)
        self._lu, self._geo = None, {}

    def _conforming(self, boundary_id):
        """Raise unless every face lies in two cells or on the boundary."""
        faces = np.sort(np.stack([self.cells[:, list(f)] for f in FACES],
                                 axis=1), axis=2).reshape(-1, 4)
        _, inv, cnt = np.unique(faces, axis=0, return_inverse=True,
                                return_counts=True)
        once = cnt[inv.ravel()] == 1
        if (once != (np.asarray(boundary_id).reshape(-1) >= 0)).any():
            raise ValueError("the mesh is not conforming: a face lies in "
                             "one cell and carries no boundary id")

    def _boundary(self, boundary_id, dirichlet):
        fn = face_nodes(2)
        mask = np.zeros(self.n, dtype=bool)
        vals = np.zeros(self.n)
        for bid in sorted(dirichlet):
            cs, fs = np.nonzero(np.asarray(boundary_id) == bid)
            if len(cs) == 0:
                continue
            nodes = np.unique(np.concatenate(
                [self.u_nodes[c, fn[f]] for c, f in zip(cs, fs)]))
            pts = self.u_points[nodes]
            for comp in range(3):
                dofs = 3 * nodes + comp
                fresh = ~mask[dofs]
                v = np.asarray(dirichlet[bid](pts, comp), dtype=np.float64)
                vals[dofs[fresh]] = v[fresh]
                mask[dofs] = True
        self.bc_mask, self.bc_vals = mask, vals

    # -- element residual -----------------------------------------------
    def _geometry(self, lo):
        """Physical Q2 gradients (c, q, 27, 3) and JxW (c, q) of the block
        of cells from `lo`, computed in float64 once and held in the
        reference's dtype."""
        if lo not in self._geo:
            cv = torch.as_tensor(
                self.vertices[self.cells[lo:lo + self.block]])
            J = torch.einsum("qvd,cvx->cqxd", torch.as_tensor(self.dG), cv)
            grad = torch.einsum("qld,cqdx->cqlx", torch.as_tensor(self.dN2),
                                torch.linalg.inv(J))
            JxW = torch.linalg.det(J) * torch.as_tensor(self.qw)[None, :]
            self._geo[lo] = (grad.to(self.dtype), JxW.to(self.dtype))
        return self._geo[lo]

    def _residual(self, xl, unl, grad, JxW):
        """Element negative residuals (c, 89) of cells (c, ...)."""
        p = self.params
        N2, N1 = self._t["N2"], self._t["N1"]
        ul = xl[:, :81].reshape(-1, 27, 3)
        uc = torch.einsum("ql,cla->cqa", N2, ul)
        G = torch.einsum("cqlx,cla->cqax", grad, ul)
        pc = xl[:, 81:] @ N1.T
        un = torch.einsum("ql,cla->cqa", N2, unl)
        divu = G[:, :, 0, 0] + G[:, :, 1, 1] + G[:, :, 2, 2]
        conv = torch.einsum("cqax,cqx->cqa", G, uc)
        w = JxW[:, :, None]
        rho = p["rho"]
        r_u = (-p["viscosity"] * torch.einsum("cqax,cqlx->cla",
                                             G * w[..., None], grad)
               - torch.einsum("ql,cqa->cla", N2,
                              (rho * conv + (rho / p["dt"]) * (uc - un)) * w)
               + torch.einsum("cqla,cq->cla", grad,
                              (pc - p["grad_div"] * rho * divu) * JxW))
        r_p = torch.einsum("cq,qn->cn", divu * JxW, N1)
        return torch.cat([r_u.reshape(-1, 81), r_p], dim=1)

    def _jacobian(self, xl, unl, grad, JxW):
        """Element derivatives dF/dx (c, 89, 89) by forward-mode automatic
        differentiation, one local dof at a time in every cell at once."""
        cols = []
        for j in range(xl.shape[1]):
            t = torch.zeros_like(xl)
            t[:, j] = 1.0
            _, d = torch.func.jvp(
                lambda x: self._residual(x, unl, grad, JxW), (xl,), (t,))
            cols.append(d)
        return torch.stack(cols, dim=2)

    def assemble(self, x, x_old, jacobian=True):
        """(negative residual F (n,), Newton matrix K = -dF/dx or None),
        block by block."""
        F = np.zeros(self.n, dtype=np.float64)
        rows, cols, vals = [], [], []
        for lo in range(0, self.n_cells, self.block):
            cells = np.arange(lo, min(lo + self.block, self.n_cells))
            cd = self.cell_dofs[cells]
            xl = torch.as_tensor(x[cd], dtype=self.dtype)
            unl = torch.as_tensor(
                x_old[:self.n_u].reshape(-1, 3)[self.u_nodes[cells]],
                dtype=self.dtype)
            g, w = self._geometry(lo)
            F += np.bincount(cd.ravel(),
                             weights=self._residual(xl, unl, g, w).numpy()
                             .ravel(), minlength=self.n)
            if jacobian:
                K_loc = self._jacobian(xl, unl, g, w)
                rows.append(np.repeat(cd, 89, axis=1).ravel())
                cols.append(np.tile(cd, (1, 89)).ravel())
                vals.append(-K_loc.numpy().ravel())
        F = F.astype(self.np_dtype)
        if not jacobian:
            return F, None
        K = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(self.n, self.n))
        return F, K

    def free(self):
        return np.nonzero(~self.bc_mask)[0]

    def initial_eval(self, present):
        """The Newton start of a step: Dirichlet dofs at their boundary
        values."""
        x = present.astype(np.float64).copy()
        x[self.bc_mask] = self.bc_vals[self.bc_mask]
        return x

    def newton_step(self, x_old, eval_pt, rtol=1e-12, max_it=40):
        """The step's solution from `eval_pt` (Dirichlet values in place),
        with increments zero on the Dirichlet dofs: a chord Newton that
        factors the free block at the start (or keeps the last step's
        factors) and again whenever an iteration shrinks the residual by
        less than ten times; it stops at rtol times the first residual, or
        where a fresh factorisation no longer lowers it.  Returns (x,
        iterations)."""
        free = self.free()
        x = eval_pt.astype(self.np_dtype)
        x_old = x_old.astype(self.np_dtype)
        lu = self._lu
        res0, prev, fresh, it = None, np.inf, False, 0
        while it < max_it:
            F, K = self.assemble(x, x_old, jacobian=lu is None)
            Fr = F[free]
            res = float(np.linalg.norm(Fr))
            res0 = max(res, 1e-300) if res0 is None else res0
            if res <= rtol * res0 or res == 0.0:
                break
            if lu is not None and res > 0.1 * prev:
                if fresh:
                    break
                F, K = self.assemble(x, x_old)
                lu = None
            if lu is None:
                Kr = K[free][:, free].tocsc().astype(self.np_dtype)
                lu = spla.splu(Kr)
                fresh = True
            else:
                fresh = False
            self._lu = lu
            y = lu.solve(Fr.astype(self.np_dtype))
            x = x.copy()
            x[free] += y.astype(self.np_dtype)
            prev = res
            it += 1
        return x, it


def fluid_checks(th, x_old, x_new, out):
    """fluid_res (the step's residual over its start's, on the free dofs)
    and bc_gap (the largest miss of a constrained velocity over the
    largest velocity) of one step, the worst kept in `out`."""
    target = th.initial_eval(x_new)
    fixed = th.bc_mask
    out["bc_gap"] = max(out["bc_gap"], rel_gap(
        np.abs(x_new - target)[fixed].max(),
        np.abs(x_new[:th.n_u]).max()))
    free = th.free()
    F0, _ = th.assemble(th.initial_eval(x_old), x_old, jacobian=False)
    F1, _ = th.assemble(x_new, x_old, jacobian=False)
    r0, r1 = np.linalg.norm(F0[free]), np.linalg.norm(F1[free])
    out["fluid_res"] = max(out["fluid_res"], r1 / r0 if r0 > 1e-11
                           else (0.0 if r1 <= 1e-11 else r1 / 1e-11))
