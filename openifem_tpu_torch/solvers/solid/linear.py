"""Linear (visco)elastic solid with Newmark-beta time stepping.

Counterpart of openifem_tpu/solvers/solid/linear.py (reference:
include/linear_elasticity.h, source/linear_elasticity.cpp).  Scheme
(solving for acceleration):
  (rho M + beta dt^2 K) a_{n+1} = F - K (d_n + dt v_n + (0.5-beta) dt^2 a_n)
  v_{n+1} = v_n + dt ((1-gamma) a_n + gamma a_{n+1})
  d_{n+1} = d_n + dt v_n + dt^2 ((0.5-beta) a_n + beta a_{n+1})
with gamma = 0.5 + damping, beta = gamma/2
(reference: source/linear_elasticity.cpp:28-30,245-320).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import index_dtype
from ...la.operators import element_diag, element_matvec
from .base import SolidSolverBase
from .materials import linear_elasticity_tensor


def cell_tensors(params, mesh, dim, tensor_of_part):
    """Per-cell rank-4 material tensor by material part:
    tensor_of_part(i) for part i, indexed by the cells' material ids (one
    part: every cell takes part 0)."""
    parts = np.stack([tensor_of_part(i)
                      for i in range(params.n_solid_parts)])
    mat = np.asarray(mesh.material_id)
    if params.n_solid_parts == 1:
        mat = np.ones_like(mat)
    return parts[mat - 1]


def stiffness_blocks(cv, C_cells, dim):
    """K[(l,a),(m,b)] = sum_q JxW g_lx C_axby g_my, (n_c, nl d, nl d)."""
    n_c, _, nl, _ = cv.grad.shape
    K = np.einsum("cqlx,caxby,cqmy,cq->clamb", cv.grad, C_cells, cv.grad,
                  cv.JxW, optimize=True)
    return K.reshape(n_c, nl * dim, nl * dim)


def mass_and_gravity(cv, params, sys, n_dofs, dim):
    """(vector mass blocks with rho, gravity rhs) (reference:
    source/linear_elasticity.cpp:106-112)."""
    n_c, _, nl, _ = cv.grad.shape
    rho = params.solid_rho
    Ms = np.einsum("qi,qj,cq->cij", cv.N, cv.N, cv.JxW)
    Mv = np.einsum("cij,ab->ciajb", Ms, np.eye(dim)).reshape(
        n_c, nl * dim, nl * dim) * rho
    g = np.zeros(dim)
    g[:len(params.gravity)] = params.gravity[:dim]
    rl = np.einsum("qi,cq,a->cia", cv.N, cv.JxW, g).reshape(n_c, -1) * rho
    rhs_g = np.zeros(n_dofs)
    np.add.at(rhs_g, sys.cell_dofs.ravel(), rl.ravel())
    return Mv, rhs_g


class LinearSteps:
    """The pieces of a linear Newmark-family step that LinearElasticity
    and SharedLinearElasticity share: a Jacobi-CG solve per operator, the
    initial acceleration, the state update and the elasticity tensors."""

    def _elasticity_cells(self):
        p = self.params
        return cell_tensors(p, self.mesh, self.dim, lambda i:
                            linear_elasticity_tensor(p.E[i], p.nu[i],
                                                     self.dim))

    def _cg_of(self, A_loc):
        """Jacobi-CG solve fn(b, atol) of the constrained operator of the
        element blocks A_loc."""
        cons = self.constraints
        op = cons.wrap_operator(lambda x: element_matvec(
            A_loc, self.cell_dofs, self.n_dofs, x))
        diag = torch.where(cons.fixed, 1.0,
                           element_diag(A_loc, self.cell_dofs, self.n_dofs))
        return self.make_cg_solver(op, diag)

    def _initial_acceleration(self):
        """M a0 = F on the first step."""
        cons = self.constraints
        b = cons.condense_rhs(self.assemble_rhs())
        res = self._solve_M(b, 1e-6 * torch.linalg.vector_norm(b))
        self.previous_acceleration = cons.distribute(res.x)

    def _set_state(self, a_new, v_new, d_new, cg_iters):
        self.current_acceleration = self.previous_acceleration = a_new
        self.current_velocity = self.previous_velocity = v_new
        self.current_displacement = self.previous_displacement = d_new
        self.lin_iters = int(cg_iters)

    def _stress_from_strain(self, eps, gradu):
        return np.einsum("cijkl,cqkl->cqij", self._elasticity_cells(), eps)


class LinearElasticity(LinearSteps, SolidSolverBase):
    fsi_skip_dirichlet_faces = True

    def _assemble_constant(self):
        params = self.params
        d = self.dim
        t = self._tensor
        K = stiffness_blocks(self.cv, self._elasticity_cells(), d)
        Mv, rhs_g = mass_and_gravity(self.cv, params, self.sys, self.n_dofs,
                                     d)

        dt = self.time.get_delta_t()
        gamma = 0.5 + params.damping
        beta = gamma / 2
        self._gamma, self._beta = gamma, beta

        self.K_loc = t(K)
        self.M_loc = t(Mv)
        self.A_loc = self.M_loc + (beta * dt * dt) * self.K_loc
        self.cell_dofs = t(self.sys.cell_dofs, index_dtype)
        self.gravity_rhs = t(rhs_g)
        self._standalone_traction = self._standalone_face_traction(
            skip_dirichlet_faces=True)

        self._apply_K = lambda x: element_matvec(self.K_loc, self.cell_dofs,
                                                 self.n_dofs, x)
        self._solve_A = self._cg_of(self.A_loc)
        self._solve_M = self._cg_of(self.M_loc)

    # ------------------------------------------------------------------
    def assemble_rhs(self):
        """External force F: gravity + traction (prescribed or FSI)."""
        if self.params.simulation_type == "FSI":
            return self.gravity_rhs + self._fsi_traction_rhs_impl(
                self.fsi_traction)
        return self.gravity_rhs + self.traction_rhs(
            self._standalone_traction)

    def run_one_step(self, first_step: bool):
        dt = self.time.get_delta_t()
        gamma, beta = self._gamma, self._beta
        cons = self.constraints
        if first_step:
            self._initial_acceleration()
        self.time.increment()

        rhs = self.assemble_rhs()
        # rhs -= K (d + dt v + (0.5-beta) dt^2 a)
        d_pred = (self.previous_displacement + dt * self.previous_velocity +
                  (0.5 - beta) * dt * dt * self.previous_acceleration)
        rhs = rhs - self._apply_K(d_pred)
        b = cons.condense_rhs(rhs)
        res = self._solve_A(b, 1e-6 * torch.linalg.vector_norm(b))
        a_new = cons.distribute(res.x)

        v_new = (self.previous_velocity + dt * (1 - gamma) *
                 self.previous_acceleration + dt * gamma * a_new)
        d_new = (self.previous_displacement + dt * self.previous_velocity +
                 dt * dt * (0.5 - beta) * self.previous_acceleration +
                 dt * dt * beta * a_new)
        self._set_state(a_new, v_new, d_new, res.iters)
        # reference: source/linear_elasticity.cpp:255-320 (refine is NOT
        # guarded by simulation type there)
        self._end_of_step_io(first_step, refine_levels=(1, 4),
                             guard_refine=False)
