"""FSI-side ("shared") solid solvers.

Counterpart of openifem_tpu/solvers/solid/shared.py (reference:
include/mpi_shared_solid_solver.h, source/mpi_shared_solid_solver.cpp,
source/mpi_shared_linear_elasticity.cpp (HHT-alpha viscoelastic),
source/mpi_shared_hyper_elasticity.cpp (Newmark hyperelastic)).

Differences from the standalone solvers:
 - FSI traction is a NODAL stress field `fsi_stress_rows` (n_nodes, dim,
   dim) interpolated on the displacement-MOVED boundary faces with
   current-configuration JxW and normals
   (reference: source/mpi_shared_linear_elasticity.cpp:196-257).
 - initial velocity from the parameters
   (reference: source/mpi_shared_solid_solver.cpp:156-196).
 - SharedLinearElasticity integrates with HHT-alpha: alpha = -damping,
   gamma = 0.5 - alpha, beta_assemble = (1+alpha)^2/4 in the system matrix
   but beta_run = (1-alpha)^2/4 in the update formulas; the reference uses
   both literally and so does the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...fe.shapes import QkShapes, gauss_quadrature
from ...la.operators import element_matvec
from ...mesh.mesh import FACE_VERTICES
from .base import SolidSolverBase
from .hyper import HyperElasticity
from .linear import (LinearSteps, cell_tensors, mass_and_gravity,
                     stiffness_blocks)
from .materials import viscosity_tensor


class SharedSolidMixin:
    """Nodal fsi_stress_rows + moved-face traction + initial velocity."""

    def _setup_shared_faces(self):
        """Face tables for fsi_stress_rows traction on moved faces; needs
        only self.{dim, space, fv, mesh, params, device} (no FE
        constraints), so the meshfree SharedHypoElasticity reuses it."""
        d = self.dim
        t = self._tensor
        self.fsi_stress_rows = torch.zeros((self.space.n_nodes, d, d),
                                           dtype=real_dtype(),
                                           device=self.device)
        fv = self.fv
        mesh = self.mesh
        # face vertex ids + reference outward orientation signs
        bverts = [[int(mesh.cells[c, v]) for v in FACE_VERTICES[d][f]]
                  for c, f in zip(np.asarray(fv.cells), np.asarray(fv.faces))]
        self._bface_verts = t(np.array(bverts), torch.int64)
        # volume shape values at the face quadrature points, and the nodes
        # of each face's cell
        self._face_N = t(fv.N)
        self._face_cell_nodes = t(self.space.cell_dofs[np.asarray(fv.cells)],
                                  torch.int64)
        # face-local geometry shapes at face quadrature points
        qp_f, qw_f = gauss_quadrature(self.params.solid_degree + 1, d - 1)
        self._face_qw = t(qw_f)
        if d == 3:
            _, dNg = QkShapes(1, 2).evaluate(qp_f)
            self._face_dNg = t(dNg)                       # (nq, 4, 2)
        # orientation: match the reference-configuration outward normals
        self._ref_vertex_coords = t(mesh.vertices)
        _, ref_n = self._face_geometry(self._ref_vertex_coords)
        dots = np.einsum("fqa,fqa->f", ref_n.cpu().numpy(),
                         np.asarray(fv.normals))
        self._face_orient = t(np.sign(dots))
        self._n_sv = mesh.n_vertices

    def _setup_shared(self):
        d = self.dim
        self._setup_shared_faces()
        # initial velocity (reference: mpi_shared_solid_solver.cpp:156-196)
        iv = np.zeros(d)
        iv[:len(self.params.initial_velocity)] = \
            self.params.initial_velocity[:d]
        if np.any(iv != 0):
            v0 = self.constraints.distribute(
                self._tensor(np.tile(iv, self.space.n_nodes)))
            self.previous_velocity = v0
            self.current_velocity = v0

    def _face_geometry(self, vert_coords):
        """(JxW (n_f, n_q), unit normals (n_f, n_q, d)) of the boundary
        faces at given vertex coordinates (unoriented; multiply normals by
        self._face_orient after setup)."""
        d = self.dim
        coords = vert_coords[self._bface_verts]          # (n_f, nfv, d)
        n_q = len(self._face_qw)
        if d == 2:
            # segment: closed form
            tv = coords[:, 1] - coords[:, 0]              # (n_f, 2)
            length = torch.linalg.vector_norm(tv, dim=-1)
            n = torch.stack([tv[:, 1], -tv[:, 0]], dim=-1) / length[:, None]
            JxW = length[:, None] * self._face_qw[None, :]
            return JxW, n[:, None, :].expand(len(tv), n_q, 2)
        Pxi = torch.einsum("qvx,fvd->fqxd", self._face_dNg, coords)
        nvec = torch.linalg.cross(Pxi[:, :, 0, :], Pxi[:, :, 1, :])
        mag = torch.linalg.vector_norm(nvec, dim=-1)
        return mag * self._face_qw[None, :], nvec / mag[..., None]

    def moved_vertex_coords(self):
        d = self.dim
        disp = self.current_displacement[:self._n_sv * d].reshape(-1, d)
        return self._ref_vertex_coords + disp

    def _traction_q(self, vert_coords, fsi_stress_rows):
        """(traction (n_f, n_q, d), JxW) at the face quadrature points from
        the nodal stress rows on the faces at vert_coords."""
        JxW, normals = self._face_geometry(vert_coords)
        normals = normals * self._face_orient[:, None, None]
        # interpolate nodal stress rows at face q points (volume shapes)
        rows = fsi_stress_rows[self._face_cell_nodes]     # (f, nl, d, d)
        sig_q = torch.einsum("fql,flab->fqab", self._face_N, rows)
        return torch.einsum("fqab,fqb->fqa", sig_q, normals), JxW

    def _fsi_traction_rhs(self):
        """Traction from nodal fsi_stress_rows on MOVED faces."""
        t_q, JxW = self._traction_q(self.moved_vertex_coords(),
                                    self.fsi_stress_rows)
        # rhs[(l,a)] += N_l t_a JxW(moved)
        rl = torch.einsum("fqi,fqa,fq->fia", self._face_N, t_q, JxW)
        return torch.zeros(self.n_dofs, dtype=rl.dtype,
                           device=rl.device).index_add_(
            0, self._face_cell_dofs.reshape(-1), rl.reshape(-1))


class SharedLinearElasticity(SharedSolidMixin, LinearSteps, SolidSolverBase):
    """HHT-alpha linear viscoelasticity
    (reference: source/mpi_shared_linear_elasticity.cpp)."""

    def _assemble_constant(self):
        params = self.params
        d = self.dim
        t = self._tensor

        alpha = -params.damping
        gamma = 0.5 - alpha
        beta_a = (1 + alpha) ** 2 / 4
        beta_r = (1 - alpha) ** 2 / 4
        self._alpha, self._gamma = alpha, gamma
        self._beta_a, self._beta_r = beta_a, beta_r
        dt = self.time.get_delta_t()

        V_cells = cell_tensors(params, self.mesh, d, lambda i:
                               viscosity_tensor(params.eta[i], d))
        K = stiffness_blocks(self.cv, self._elasticity_cells(), d)
        Cd = stiffness_blocks(self.cv, V_cells, d)
        Mv, rhs_g = mass_and_gravity(self.cv, params, self.sys, self.n_dofs,
                                     d)

        self.K_loc = t(K)
        self.C_loc = t(Cd)
        self.M_loc = t(Mv)
        self.A_loc = (self.M_loc + ((1 + alpha) * gamma * dt) * self.C_loc +
                      ((1 + alpha) * beta_a * dt * dt) * self.K_loc)
        self.cell_dofs = t(self.sys.cell_dofs, index_dtype)
        self.gravity_rhs = t(rhs_g)
        self._standalone_traction = self._standalone_face_traction(
            skip_dirichlet_faces=False)

        self._apply_K = lambda x: element_matvec(self.K_loc, self.cell_dofs,
                                                 self.n_dofs, x)
        self._apply_C = lambda x: element_matvec(self.C_loc, self.cell_dofs,
                                                 self.n_dofs, x)
        self._solve_A = self._cg_of(self.A_loc)
        self._solve_M = self._cg_of(self.M_loc)
        self._setup_shared()

    def assemble_rhs(self):
        if self.params.simulation_type == "FSI":
            return self.gravity_rhs + self._fsi_traction_rhs()
        return self.gravity_rhs + self.traction_rhs(self._standalone_traction)

    def run_one_step(self, first_step: bool):
        dt = self.time.get_delta_t()
        alpha, gamma = self._alpha, self._gamma
        beta_r = self._beta_r
        cons = self.constraints
        if first_step:
            self._initial_acceleration()
        self.time.increment()

        rhs = self.assemble_rhs()
        d_pred = (self.previous_displacement +
                  (1 + alpha) * dt * self.previous_velocity +
                  (0.5 - beta_r) * dt * dt * (1 + alpha) *
                  self.previous_acceleration)
        v_pred = (self.previous_velocity +
                  (1 + alpha) * (1 - gamma) * dt * self.previous_acceleration)
        rhs = rhs - self._apply_K(d_pred) - self._apply_C(v_pred)
        b = cons.condense_rhs(rhs)
        res = self._solve_A(b, 1e-6 * torch.linalg.vector_norm(b))
        a_new = cons.distribute(res.x)

        v_new = (self.previous_velocity + dt * (1 - gamma) *
                 self.previous_acceleration + dt * gamma * a_new)
        d_new = (self.previous_displacement + dt * self.previous_velocity +
                 dt * dt * (0.5 - beta_r) * self.previous_acceleration +
                 dt * dt * beta_r * a_new)
        self._set_state(a_new, v_new, d_new, res.iters)
        # reference: source/mpi_shared_linear_elasticity.cpp:378-398
        # (refine/save guarded by simulation type there)
        self._end_of_step_io(first_step, refine_levels=(1, 4))


class SharedHyperElasticity(SharedSolidMixin, HyperElasticity):
    """Newmark hyperelastic FSI-side solid
    (reference: source/mpi_shared_hyper_elasticity.cpp)."""

    def _assemble_constant(self):
        super()._assemble_constant()
        self._setup_shared()

    def _external_traction_rhs(self):
        if self.params.simulation_type == "FSI":
            return self._fsi_traction_rhs()
        return self.traction_rhs(self._standalone_traction)
