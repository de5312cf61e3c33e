"""Plain Taylor-Hood (Q2 velocity, Q1 pressure) implicit Navier-Stokes step.

The fluid half of every cell's reference.  It imports nothing of the
program: the dof numbering, the hanging-node and Dirichlet constraints, the
element residual and the Newton loop are worked out here again, in a form
of its own.  Nodes are keyed by position (a hanging vertex and the coarse
edge's midpoint are one Q2 node), the Newton matrix is the automatic
derivative of the element residual, and every linear system is solved
directly (SuperLU), so the answer is the discrete step's own solution and
not a Krylov iterate.

Weak form (backward Euler, grad-div, as OpenIFEM's InsIM,
source/mpi_insim.cpp:263-304), with r the negative residual:
  r_u = -nu (grad u, grad v) - rho ((u.grad) u, v) + (p, div v)
        - gamma rho (div u, div v) - rho/dt (u - u_old, v)
  r_p = (div u, q)
The geometry map is bilinear; quadrature is Gauss with degree + 1 points
per axis.

`dtype` is the precision of the whole computation: float64 for the
reference, float32 for the control (the nearest precision below the one the
configurations state).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

# unit-cell faces [-x, +x, -y, +y] as (vertex, vertex) in z-order
FACES = ((0, 2), (1, 3), (0, 1), (2, 3))
# Q2 local nodes (lexicographic, x fastest) on each face
Q2_FACE_NODES = ((0, 3, 6), (2, 5, 8), (0, 1, 2), (6, 7, 8))
KEY_SCALE = 1e9


def keys_of(points):
    """Integer position keys (1e-9 resolution) of (n, 2) points."""
    return np.rint(np.asarray(points) * KEY_SCALE).astype(np.int64)


def key_index(keys):
    """dict from key tuple to row of `keys`."""
    return {(int(a), int(b)): i for i, (a, b) in enumerate(keys)}


def gauss_1d(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange_1d(k, x):
    """Values and derivatives of the k+1 Lagrange polynomials on uniform
    nodes of [0, 1] at the points x."""
    nodes = np.linspace(0.0, 1.0, k + 1)
    x = np.asarray(x, dtype=np.float64)
    V = np.ones((len(x), k + 1))
    D = np.zeros((len(x), k + 1))
    for i in range(k + 1):
        others = [j for j in range(k + 1) if j != i]
        for j in others:
            V[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        for m in others:
            t = np.full(len(x), 1.0 / (nodes[i] - nodes[m]))
            for j in others:
                if j != m:
                    t = t * (x - nodes[j]) / (nodes[i] - nodes[j])
            D[:, i] += t
    return V, D


def tensor_shapes(k, pts):
    """Q_k values (n, nl) and unit gradients (n, nl, 2) at unit points
    (n, 2); local node l = ix + (k+1) iy."""
    pts = np.asarray(pts, dtype=np.float64)
    Vx, Dx = lagrange_1d(k, pts[:, 0])
    Vy, Dy = lagrange_1d(k, pts[:, 1])
    n = len(pts)
    N = np.einsum("qi,qj->qji", Vx, Vy).reshape(n, -1)
    gx = np.einsum("qi,qj->qji", Dx, Vy).reshape(n, -1)
    gy = np.einsum("qi,qj->qji", Vx, Dy).reshape(n, -1)
    return N, np.stack([gx, gy], axis=-1)


def unit_nodes(k):
    """Unit coordinates of the Q_k local nodes."""
    t = np.linspace(0.0, 1.0, k + 1)
    return np.array([(t[i], t[j]) for j in range(k + 1)
                     for i in range(k + 1)])


def cell_geometry(cell_verts, k, n_q1d):
    """Physical shape gradients (c, q, nl, 2), JxW (c, q) and values
    (q, nl) of Q_k under the bilinear map of each cell."""
    qp1, qw1 = gauss_1d(n_q1d)
    qp = np.array([(qp1[i], qp1[j]) for j in range(n_q1d)
                   for i in range(n_q1d)])
    qw = np.array([qw1[i] * qw1[j] for j in range(n_q1d)
                   for i in range(n_q1d)])
    _, dG = tensor_shapes(1, qp)
    N, dN = tensor_shapes(k, qp)
    J = np.einsum("qvd,cvx->cqxd", dG, cell_verts)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    grad = np.einsum("qld,cqdx->cqlx", dN, Jinv)
    return grad, detJ * qw[None, :], N, qp, qw


def map_points(cell_verts, unit):
    """Physical positions (c, n, 2) of unit points under each cell's
    bilinear map."""
    G, _ = tensor_shapes(1, unit)
    return np.einsum("nv,cvx->cnx", G, cell_verts)


class TaylorHood:
    """Q2/Q1 spaces, constraints and the Newton step on one mesh.

    vertices (n_v, 2), cells (n_c, 4) in z-order, boundary_id (n_c, 4) with
    -1 on interior faces; dirichlet: {boundary id: fn(points, component)};
    params: viscosity, rho, grad_div, dt."""

    def __init__(self, vertices, cells, boundary_id, dirichlet, params,
                 dtype=torch.float64):
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.params = params
        cv = vertices[cells]
        self.cell_verts = cv
        n_c = len(cells)
        self.n_cells = n_c

        # Q2 nodes by position
        u_pts = map_points(cv, unit_nodes(2))           # (c, 9, 2)
        ukeys, uinv = np.unique(keys_of(u_pts.reshape(-1, 2)), axis=0,
                                return_inverse=True)
        self.u_nodes = uinv.reshape(n_c, 9)
        self.n_unodes = len(ukeys)
        self.u_points = np.zeros((self.n_unodes, 2))
        self.u_points[self.u_nodes.ravel()] = u_pts.reshape(-1, 2)
        self.u_key = key_index(ukeys)
        # Q1 nodes: the cell vertices, by position
        pkeys, pinv = np.unique(keys_of(cv.reshape(-1, 2)), axis=0,
                                return_inverse=True)
        self.p_nodes = pinv.reshape(n_c, 4)
        self.n_pnodes = len(pkeys)
        self.p_points = np.zeros((self.n_pnodes, 2))
        self.p_points[self.p_nodes.ravel()] = cv.reshape(-1, 2)
        self.p_key = key_index(pkeys)

        self.n_u = 2 * self.n_unodes
        self.n = self.n_u + self.n_pnodes
        self.cell_dofs = np.concatenate(
            [(self.u_nodes[:, :, None] * 2 + np.arange(2)).reshape(n_c, 18),
             self.n_u + self.p_nodes], axis=1)

        self.grad, self.JxW, self.N2, qp, qw = cell_geometry(cv, 2, 3)
        self.N1, _ = tensor_shapes(1, qp)
        # unit-cell L2 projection quadrature -> Q2 nodes (stress output)
        Mref = np.einsum("qi,qj,q->ij", self.N2, self.N2, qw)
        self.qpt_to_node = np.linalg.solve(Mref, (self.N2 * qw[:, None]).T)
        self.node_cells = np.bincount(self.u_nodes.ravel(),
                                      minlength=self.n_unodes)

        self._hanging()
        self.hang_mask = np.zeros(self.n, dtype=bool)
        self.hang_mask[list(self.hang)] = True
        self._boundary(boundary_id, dirichlet)
        self._lu, self._lu_fixed = None, None
        self._t = {name: torch.as_tensor(a, dtype=dtype) for name, a in (
            ("grad", self.grad), ("JxW", self.JxW), ("N2", self.N2),
            ("N1", self.N1))}

    # -- constraints ----------------------------------------------------
    def _hanging(self):
        """Hanging nodes of a 1-irregular mesh: a coarse edge whose
        midpoint is a vertex of the finer neighbours.  Q1: that vertex is
        the mean of the edge's ends; Q2: the fine edges' midpoints (the
        quarter points) follow the coarse edge's quadratic."""
        self.hang = {}            # dof -> [(master dof, weight)]
        lag_q = {0.25: (0.375, 0.75, -0.125), 0.75: (-0.125, 0.75, 0.375)}
        for c in range(self.n_cells):
            for a, b in FACES:
                pa, pb = self.cell_verts[c, a], self.cell_verts[c, b]
                mk = tuple(keys_of(0.5 * (pa + pb)))
                if mk not in self.p_key:
                    continue
                ia, ib = self.p_key[tuple(keys_of(pa))], \
                    self.p_key[tuple(keys_of(pb))]
                self.hang[self.n_u + self.p_key[mk]] = [
                    (self.n_u + ia, 0.5), (self.n_u + ib, 0.5)]
                ua, ub = self.u_key[tuple(keys_of(pa))], \
                    self.u_key[tuple(keys_of(pb))]
                um = self.u_key[mk]
                for t, (wa, wm, wb) in lag_q.items():
                    q = self.u_key[tuple(keys_of(pa + t * (pb - pa)))]
                    for comp in range(2):
                        self.hang[2 * q + comp] = [
                            (2 * ua + comp, wa), (2 * um + comp, wm),
                            (2 * ub + comp, wb)]

    def _boundary(self, boundary_id, dirichlet):
        mask = np.zeros(self.n, dtype=bool)
        vals = np.zeros(self.n)
        for bid in sorted(dirichlet):
            nodes = set()
            for c, f in zip(*np.nonzero(boundary_id == bid)):
                nodes.update(int(self.u_nodes[c, l])
                             for l in Q2_FACE_NODES[f])
            nodes = np.array(sorted(nodes), dtype=np.int64)
            if len(nodes) == 0:
                continue
            pts = self.u_points[nodes]
            for comp in range(2):
                dofs = 2 * nodes + comp
                fresh = ~mask[dofs]
                v = np.asarray(dirichlet[bid](pts, comp), dtype=np.float64)
                vals[dofs[fresh]] = v[fresh]
                mask[dofs] = True
        self.bc_mask, self.bc_vals = mask, vals

    def eligible_u_nodes(self):
        """Q2 nodes that lie on a face of zero unit coordinate of some cell
        (the nodes OpenIFEM may constrain to the solid's velocity,
        source/fsi.cpp:262-276)."""
        un = unit_nodes(2)
        local = np.nonzero((np.abs(un) < 1e-12).any(axis=1))[0]
        out = np.zeros(self.n_unodes, dtype=bool)
        out[self.u_nodes[:, local].ravel()] = True
        return out

    def constraint_map(self, extra_mask=None):
        """(P, fixed): P maps the free dofs to all dofs (a Newton
        increment, zero on Dirichlet dofs, hanging dofs from masters)."""
        fixed = self.bc_mask.copy()
        if extra_mask is not None:
            fixed |= extra_mask
        fixed &= ~self.hang_mask
        free = np.nonzero(~(fixed | self.hang_mask))[0]
        col = -np.ones(self.n, dtype=np.int64)
        col[free] = np.arange(len(free))
        rows, cols, w = list(free), list(range(len(free))), [1.0] * len(free)
        for dof, masters in self.hang.items():
            for m, wt in masters:
                if col[m] >= 0:
                    rows.append(dof)
                    cols.append(col[m])
                    w.append(wt)
        P = sp.csr_matrix((w, (rows, cols)), shape=(self.n, len(free)))
        return P, fixed

    def distribute_hanging(self, x):
        x = x.copy()
        for dof, masters in self.hang.items():
            x[dof] = sum(wt * x[m] for m, wt in masters)
        return x

    # -- element residual -----------------------------------------------
    def _residual(self, xl, unl, grad, JxW):
        """Element negative residuals (c, 22) of cells (c, ...)."""
        p = self.params
        N2, N1 = self._t["N2"], self._t["N1"]
        ul = xl[:, :18].reshape(-1, 9, 2)
        uc = torch.einsum("ql,cla->cqa", N2, ul)
        G = torch.einsum("cqlx,cla->cqax", grad, ul)
        pc = xl[:, 18:] @ N1.T
        un = torch.einsum("ql,cla->cqa", N2, unl)
        divu = G[:, :, 0, 0] + G[:, :, 1, 1]
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
        return torch.cat([r_u.reshape(-1, 18), r_p], dim=1)

    def _jacobian(self, xl, unl, grad, JxW):
        """Element derivatives dF/dx (c, 22, 22) by forward-mode automatic
        differentiation: one directional derivative per local dof, taken in
        every cell at once (the cells are independent)."""
        cols = []
        for j in range(xl.shape[1]):
            t = torch.zeros_like(xl)
            t[:, j] = 1.0
            _, d = torch.func.jvp(
                lambda x: self._residual(x, unl, grad, JxW), (xl,), (t,))
            cols.append(d)
        return torch.stack(cols, dim=2)

    def assemble(self, x, x_old, jacobian=True):
        """(negative residual F (n,), Newton matrix K = -dF/dx or None)."""
        cd = self.cell_dofs
        xl = torch.as_tensor(x[cd], dtype=self.dtype)
        unl = torch.as_tensor(x_old[:self.n_u].reshape(-1, 2)[self.u_nodes],
                              dtype=self.dtype)
        g, w = self._t["grad"], self._t["JxW"]
        F_loc = self._residual(xl, unl, g, w)
        F = np.bincount(cd.ravel(), weights=F_loc.numpy().ravel(),
                        minlength=self.n).astype(self.np_dtype)
        if not jacobian:
            return F, None
        K_loc = self._jacobian(xl, unl, g, w)
        rows = np.repeat(cd, 22, axis=1).ravel()
        cols = np.tile(cd, (1, 22)).ravel()
        K = sp.csr_matrix((-K_loc.numpy().ravel(), (rows, cols)),
                          shape=(self.n, self.n))
        return F, K

    def newton_step(self, x_old, eval_pt, extra_mask=None, rtol=1e-12,
                    max_it=40):
        """The step's solution from `eval_pt` (constrained values already
        in place), with increments zero on every fixed dof.  A chord
        Newton: the matrix is factored at the start (or the last step's
        factors are kept, where the constraints are the same) and again
        whenever an
        iteration shrinks the exact residual by less than ten times; it stops
        at rtol times the first residual, or where a fresh factorisation
        no longer lowers it (the floor of the precision).  Returns (x,
        iterations)."""
        P, fixed = self.constraint_map(extra_mask)
        Pt = P.T.tocsr()
        x = eval_pt.astype(self.np_dtype)
        x_old = x_old.astype(self.np_dtype)
        # the last step's factors serve while the constraints are the same
        lu = self._lu if np.array_equal(fixed, self._lu_fixed) else None
        res0, prev, fresh, it = None, np.inf, False, 0
        while it < max_it:
            F, K = self.assemble(x, x_old, jacobian=lu is None)
            Fr = Pt @ F
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
                Kr = (Pt @ K @ P).tocsc().astype(self.np_dtype)
                lu = spla.splu(Kr, permc_spec="MMD_ATA")
                fresh = True
            else:
                fresh = False
            self._lu, self._lu_fixed = lu, fixed
            y = lu.solve(Fr.astype(self.np_dtype))
            x = x + (P @ y).astype(self.np_dtype)
            prev = res
            it += 1
        return x, it

    def unconstrained(self, mask):
        """The dofs of `mask` that no boundary or hanging constraint holds
        yet (constraints already there win, source/fsi.cpp:297-305)."""
        return mask & ~self.bc_mask & ~self.hang_mask

    def initial_eval(self, present, covered=None, covered_vals=None):
        """The Newton start of a step: Dirichlet dofs at their boundary
        values, the `covered` dofs (see unconstrained) at the given values,
        hanging dofs from their masters."""
        x = present.astype(np.float64).copy()
        x[self.bc_mask] = self.bc_vals[self.bc_mask]
        if covered is not None and covered.any():
            x[covered] = covered_vals[covered]
        return self.distribute_hanging(x)

    def nodal_stress(self, x):
        """Nodal viscous stress mu (grad u + grad u^T), projected from the
        quadrature points cell by cell and averaged over the cells of each
        node (source/fluid_solver.cpp:324-414)."""
        dt = self.np_dtype
        mu = dt(self.params["viscosity"])
        ul = x.astype(dt)[:self.n_u].reshape(-1, 2)[self.u_nodes]
        G = np.einsum("cqlx,cla->cqax", self.grad.astype(dt), ul)
        tau = mu * (G + np.swapaxes(G, 2, 3))
        cellwise = np.einsum("iq,cqab->ciab", self.qpt_to_node.astype(dt),
                             tau)
        out = np.zeros((self.n_unodes, 2, 2), dtype=dt)
        np.add.at(out, self.u_nodes.ravel(), cellwise.reshape(-1, 2, 2))
        return out / self.node_cells[:, None, None].astype(dt)


def rel_gap(gap, scale):
    """gap / scale, and 0 where the gap is 0."""
    return float(gap) / max(float(scale), 1e-300) if gap > 0 else 0.0


def fluid_checks(th, x_old, x_new, covered, vals, out):
    """fluid_res and bc_gap of one fluid step (see check)."""
    target = th.initial_eval(x_new, covered, vals)
    fixed = th.bc_mask | covered | th.hang_mask
    out["bc_gap"] = max(out["bc_gap"], rel_gap(
        np.abs(x_new - target)[fixed].max(),
        np.abs(x_new[:th.n_u]).max()))
    P, _ = th.constraint_map(covered)
    Pt = P.T.tocsr()
    F0, _ = th.assemble(th.initial_eval(x_old, covered, vals), x_old,
                        jacobian=False)
    F1, _ = th.assemble(x_new, x_old, jacobian=False)
    r0, r1 = np.linalg.norm(Pt @ F0), np.linalg.norm(Pt @ F1)
    out["fluid_res"] = max(out["fluid_res"], r1 / r0 if r0 > 1e-11
                           else (0.0 if r1 <= 1e-11 else r1 / 1e-11))


def match(points, ref_points):
    """Rows of ref_points at each of points (by position); raises where a
    point has no counterpart."""
    index = {tuple(k): i for i, k in enumerate(keys_of(ref_points))}
    try:
        return np.array([index[tuple(k)] for k in keys_of(points)],
                        dtype=np.int64)
    except KeyError as e:
        raise ValueError(f"no reference node at {e}") from None
