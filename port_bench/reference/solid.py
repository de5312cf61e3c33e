"""Plain Neo-Hookean solid with Newmark time stepping: the solid of the
leaflet's reference.  Q1 displacement on a conforming quad mesh (the nodes
are the vertices), 2 x 2 Gauss points, the internal force from the first
Piola-Kirchhoff stress P = tau F^-T of the compressible Neo-Hookean
material of OpenIFEM (include/neo_hookean.h:26-34):
  J = det F,  b_bar = J^(-2/d) F F^T,  tau_bar = 2 c1 b_bar,
  tau = tau_bar - tr(tau_bar)/d I + kappa J (J - 1) I,
Newmark with gamma = 1/2 + damping, beta = gamma / 2 and the predictor
d_pred = d + dt v + (1/2 - beta) dt^2 a (source/hyper_elasticity.cpp:
84-202).  Newton to the discrete step's own solution, each linear system
solved densely; its matrix is the automatic derivative of the residual."""

from __future__ import annotations

import numpy as np
import torch

from .fem import FACES, cell_geometry


class Solid:
    def __init__(self, vertices, cells, boundary_id, fields, clamp_ids,
                 dtype=torch.float64):
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.vertices, self.cells = vertices, cells
        n_c = len(cells)
        self.n = 2 * len(vertices)
        self.cell_dofs = (cells[:, :, None] * 2 + np.arange(2)).reshape(n_c,
                                                                         8)
        grad, JxW, N, _, _ = cell_geometry(vertices[cells], 1, 2)
        self.grad = torch.as_tensor(grad, dtype=dtype)
        self.JxW = torch.as_tensor(JxW, dtype=dtype)
        rho = fields["solid_rho"]
        Ms = np.einsum("qi,qj,cq->cij", N, N, JxW)
        M_loc = np.einsum("cij,ab->ciajb", Ms, np.eye(2)).reshape(n_c, 8, 8)
        self.M = self._sparse(rho * M_loc).astype(self.np_dtype)
        self.c1, self.kappa = fields["C"][0]
        self.gamma = 0.5 + fields.get("damping", 0.0)
        self.beta = self.gamma / 2
        self.dt = fields["time_step"]
        clamp = np.zeros(self.n, dtype=bool)
        faces = []
        for c, f in zip(*np.nonzero(boundary_id >= 0)):
            va, vb = cells[c, FACES[f][0]], cells[c, FACES[f][1]]
            faces.append((c, va, vb))
            if boundary_id[c, f] in clamp_ids:
                clamp[[2 * va, 2 * va + 1, 2 * vb, 2 * vb + 1]] = True
        self.faces = np.array(faces, dtype=np.int64)      # (cell, va, vb)
        self.free = np.nonzero(~clamp)[0]

    def _sparse(self, loc):
        cd = self.cell_dofs
        K = np.zeros((self.n, self.n))
        np.add.at(K, (np.repeat(cd, 8, axis=1).ravel(),
                      np.tile(cd, (1, 8)).ravel()), loc.ravel())
        return K

    def _internal_loc(self, ul):
        """Element internal forces -int P : Grad N (c, 8) at displacements
        ul (c, 8)."""
        u = ul.reshape(-1, 4, 2)
        F = torch.einsum("cqlX,cla->cqaX", self.grad, u) + torch.eye(
            2, dtype=self.dtype)
        J = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
        Fbar = F * (J ** -0.5)[..., None, None]
        tau_bar = 2.0 * self.c1 * Fbar @ Fbar.transpose(-1, -2)
        tr = tau_bar[..., 0, 0] + tau_bar[..., 1, 1]
        eye = torch.eye(2, dtype=self.dtype)
        tau = tau_bar + (self.kappa * J * (J - 1.0) - tr / 2)[..., None,
                                                              None] * eye
        Finv_T = torch.stack([torch.stack([F[..., 1, 1], -F[..., 1, 0]], -1),
                              torch.stack([-F[..., 0, 1], F[..., 0, 0]], -1)],
                             -2) / J[..., None, None]
        P = tau @ Finv_T
        return -torch.einsum("cqaX,cqlX,cq->cla", P, self.grad,
                             self.JxW).reshape(-1, 8)

    def internal(self, d, jacobian=False):
        ul = torch.as_tensor(d[self.cell_dofs], dtype=self.dtype)
        F = np.bincount(self.cell_dofs.ravel(),
                        weights=self._internal_loc(ul).numpy().ravel(),
                        minlength=self.n).astype(self.np_dtype)
        if not jacobian:
            return F, None
        cols = []
        for j in range(8):
            t = torch.zeros_like(ul)
            t[:, j] = 1.0
            cols.append(torch.func.jvp(self._internal_loc, (ul,), (t,))[1])
        return F, self._sparse(torch.stack(cols, dim=2).numpy()).astype(
            self.np_dtype)

    def initial_acceleration(self, d, trhs):
        """M a0 = internal force + traction (the first step's start)."""
        F, _ = self.internal(d)
        a = np.zeros(self.n)
        fr = self.free
        a[fr] = np.linalg.solve(self.M[np.ix_(fr, fr)], (F + trhs)[fr])
        return a

    def step(self, d0, v0, a0, trhs, rtol=1e-13, max_it=20):
        """One Newmark step; returns (d, v, a, Newton iterations)."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        c = 1.0 / (beta * dt * dt)
        d0, v0, a0, trhs = (np.asarray(z, dtype=self.np_dtype)
                            for z in (d0, v0, a0, trhs))
        d_pred = d0 + dt * v0 + (0.5 - beta) * dt * dt * a0
        d, fr = d0.astype(self.np_dtype).copy(), self.free
        res0, it = None, 0
        while it < max_it:
            F, K = self.internal(d, jacobian=True)
            R = (F + trhs - self.M @ ((d - d_pred) * c))[fr]
            res = float(np.linalg.norm(R))
            res0 = max(res, 1e-300) if res0 is None else res0
            if res <= rtol * res0 or res == 0.0:
                break
            A = (-K + c * self.M)[np.ix_(fr, fr)].astype(self.np_dtype)
            d[fr] += np.linalg.solve(A, R.astype(self.np_dtype))
            it += 1
        a = (d - d_pred) * c
        v = v0 + dt * ((1 - gamma) * a0 + gamma * a)
        return d, v, a, it

    def step_residuals(self, d0, v0, a0, trhs, d):
        """A step's residual norms at its start d0 and at d, and the
        Newmark acceleration and velocity of d (float64)."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        c = 1.0 / (beta * dt * dt)
        d_pred = d0 + dt * v0 + (0.5 - beta) * dt * dt * a0
        fr, M = self.free, self.M.astype(np.float64)
        norms = []
        for z in (d0, d):
            F, _ = self.internal(z)
            norms.append(float(np.linalg.norm(
                (F + trhs - M @ ((z - d_pred) * c))[fr])))
        a = (d - d_pred) * c
        return norms[0], norms[1], a, v0 + dt * ((1 - gamma) * a0 + gamma * a)

    def traction_rhs(self, traction):
        """A traction constant on each boundary face, (n_faces, 2), as
        nodal forces: each end of a face takes half its reference
        length."""
        dt = self.np_dtype
        traction = traction.astype(dt)
        rhs = np.zeros(self.n, dtype=dt)
        v = self.vertices.astype(dt)
        half = dt(0.5) * np.linalg.norm(v[self.faces[:, 2]] -
                                        v[self.faces[:, 1]], axis=1)
        for end in (1, 2):
            for comp in range(2):
                np.add.at(rhs, 2 * self.faces[:, end] + comp,
                          traction[:, comp] * half)
        return rhs
