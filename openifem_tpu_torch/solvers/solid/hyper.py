"""Finite-strain hyperelastic solid (Neo-Hookean / St.Venant-Kirchhoff)
with Newmark time integration and Newton iterations.

Counterpart of openifem_tpu/solvers/solid/hyper.py (reference:
include/hyper_elasticity.h, source/hyper_elasticity.cpp, a dynamic variant
of deal.II step-44).  The per-quadrature-point history of the reference is
recomputed from the current displacement in each batched assembly.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...la.krylov import cg
from ...la.operators import element_diag, element_matvec
from ...la.smalltensor import inv as _inv
from .base import SolidSolverBase
from .materials import kirchhoff_state, neo_hookean_state


class HyperElasticity(SolidSolverBase):
    def _assemble_constant(self):
        params = self.params
        d = self.dim
        cv = self.cv
        n_c, n_q, nl, _ = cv.grad.shape
        rho = params.solid_rho
        t = self._tensor

        Ms = np.einsum("qi,qj,cq->cij", cv.N, cv.N, cv.JxW)
        Mv = np.einsum("cij,ab->ciajb", Ms, np.eye(d)).reshape(
            n_c, nl * d, nl * d) * rho
        self.M_loc = t(Mv)
        self.cell_dofs = t(self.sys.cell_dofs, index_dtype)
        self.dN = t(cv.grad)                             # (c,q,l,X)
        self.JxW = t(cv.JxW)
        self.Nq = t(cv.N)

        gamma = 0.5 + params.damping
        beta = gamma / 2
        self._gamma, self._beta = gamma, beta

        g = np.zeros(d)
        g[:len(params.gravity)] = params.gravity[:d]
        rl = np.einsum("qi,cq,a->cia", cv.N, cv.JxW, g).reshape(n_c, -1) * rho
        rhs_g = np.zeros(self.n_dofs)
        np.add.at(rhs_g, self.sys.cell_dofs.ravel(), rl.ravel())
        self.gravity_rhs = t(rhs_g)

        # hyper assembly does NOT skip Dirichlet faces
        # (reference: source/hyper_elasticity.cpp:445-462)
        self._standalone_traction = self._standalone_face_traction(
            skip_dirichlet_faces=False)

        if params.solid_type == "NeoHookean":
            c1, kappa = params.C[0][0], params.C[0][1]
            self._material = partial(neo_hookean_state, c1=c1, kappa=kappa)
        elif params.solid_type == "Kirchhoff":
            self._material = partial(kirchhoff_state, E_mod=params.E[0],
                                     nu=params.nu[0])
        else:
            raise ValueError(f"unknown solid type {params.solid_type}")

        cons = self.constraints
        op_M = cons.wrap_operator(
            lambda x: element_matvec(self.M_loc, self.cell_dofs, self.n_dofs,
                                     x))
        diag_M = torch.where(
            cons.fixed, 1.0,
            element_diag(self.M_loc, self.cell_dofs, self.n_dofs))
        self._solve_M = self.make_cg_solver(op_M, diag_M)

    # ------------------------------------------------------------------
    def _assemble(self, disp):
        """Batched tangent + internal-force assembly at displacement state.

        Returns (A_loc (c, nd, nd), rhs (n_dofs,)) where nd = nl*dim.
        reference: source/hyper_elasticity.cpp:378-431."""
        d = self.dim
        dN, JxW = self.dN, self.JxW
        n_c, n_q, nl, _ = dN.shape
        ul = disp[self.cell_dofs].reshape(n_c, nl, d)
        Grad_u = torch.einsum("cqlX,cla->cqaX", dN, ul)
        I = torch.eye(d, dtype=disp.dtype, device=disp.device)
        F = Grad_u + I
        Finv = _inv(F)
        # spatial gradients of scalar shapes
        g = torch.einsum("cqlX,cqXx->cqlx", dN, Finv)
        tau, Jc = self._material(F)

        Kmat = torch.einsum("cqlx,cqaxby,cqmy,cq->clamb", g, Jc, g, JxW)
        Kgeo = torch.einsum("cqlx,cqxy,cqmy,cq->clm", g, tau, g, JxW)
        Kgeo = torch.einsum("clm,ab->clamb", Kgeo, I)
        A_loc = (Kmat + Kgeo).reshape(n_c, nl * d, nl * d)

        rl = -torch.einsum("cqlx,cqax,cq->cla", g, tau, JxW).reshape(n_c, -1)
        rhs = torch.zeros(self.n_dofs, dtype=disp.dtype,
                          device=disp.device).index_add_(
            0, self.cell_dofs.reshape(-1), rl.reshape(-1))
        return A_loc, rhs + self.gravity_rhs

    def _external_traction_rhs(self):
        if self.params.simulation_type == "FSI":
            return self._fsi_traction_rhs_impl(self.fsi_traction)
        return self.traction_rhs(self._standalone_traction)

    def _newton_step_impl(self, disp, d_pred, v_prev, a_prev, traction_rhs):
        """One Newton iteration: returns (newton_update, res_F, cg_iters)."""
        dt = self.time.get_delta_t()
        beta = self._beta
        cons = self.constraints

        a_cur = (disp - d_pred) / (beta * dt * dt)
        A_loc, rhs = self._assemble(disp)
        rhs = rhs + traction_rhs
        rhs = rhs - element_matvec(self.M_loc, self.cell_dofs, self.n_dofs,
                                   a_cur)
        b = cons.condense_rhs(rhs)
        res_F = torch.linalg.vector_norm(b).item()

        dt2inv = 1.0 / (beta * dt * dt)
        A_full = A_loc + self.M_loc * dt2inv
        if self.n_dofs <= self.dense_solve_max and not cons.any_hanging:
            # small system: dense f32 LU + f64 refinement
            x = self._dense_solve(A_full, self.cell_dofs, cons, b)
            return cons.distribute(x), res_F, 0
        diag = element_diag(A_full, self.cell_dofs, self.n_dofs)
        diag = torch.where(cons.fixed, 1.0, diag)
        dinv = torch.where(diag != 0, 1.0 / diag, 1.0)
        op = cons.wrap_operator(
            lambda x: element_matvec(A_full, self.cell_dofs, self.n_dofs, x))
        res = cg(op, b, M=lambda r: r * dinv,
                 atol=1e-6 * res_F, maxiter=self.n_dofs)
        return cons.distribute(res.x), res_F, res.iters

    # ------------------------------------------------------------------
    def _device_step_impl(self, disp0, v_prev, a_prev, traction_rhs):
        """One Newmark time step with the Newton loop of the JAX package's
        fused step (identical tolerances and stopping rules, reference:
        source/hyper_elasticity.cpp:84-202), run eagerly.  Returns
        (disp, vel, acc, newton_iters); callers must check
        newton_iters < solid_max_iterations."""
        params = self.params
        dt = self.time.get_delta_t()
        gamma, beta = self._gamma, self._beta
        cons = self.constraints
        tol_d, tol_f = params.tol_d, params.tol_f
        max_it = params.solid_max_iterations

        d_pred = (disp0 + dt * v_prev + (0.5 - beta) * dt * dt * a_prev)

        disp, it = disp0, 0
        norm_res = norm_upd = init_res = init_upd = 1.0
        err_res = err_upd = 1.0
        while ((norm_upd > tol_d or norm_res > tol_f) and err_res > 1e-12
               and err_upd > 1e-12 and it < max_it):
            du, err_res, _ = self._newton_step_impl(
                disp, d_pred, v_prev, a_prev, traction_rhs)
            err_upd = torch.linalg.vector_norm(cons.set_zero(du)).item()
            if it == 0:
                init_res = max(err_res, 1e-300)
                init_upd = max(err_upd, 1e-300)
            disp = cons.distribute(disp + du)
            it += 1
            norm_res, norm_upd = err_res / init_res, err_upd / init_upd

        a_new = (disp - d_pred) / (beta * dt * dt)
        v_new = v_prev + dt * ((1 - gamma) * a_prev + gamma * a_new)
        return disp, v_new, a_new, it

    def run_one_step(self, first_step: bool):
        params = self.params
        dt = self.time.get_delta_t()
        gamma, beta = self._gamma, self._beta
        cons = self.constraints

        traction_rhs = self._external_traction_rhs()

        if first_step:
            # initial acceleration M a0 = F (internal force is zero at rest
            # for NeoHookean/Kirchhoff with F=I)
            _, rhs = self._assemble(self.current_displacement)
            rhs = rhs + traction_rhs
            b = cons.condense_rhs(rhs)
            res = self._solve_M(b, 1e-6 * torch.linalg.vector_norm(b))
            self.previous_acceleration = cons.distribute(res.x)

        self.time.increment()

        d_pred = (self.previous_displacement + dt * self.previous_velocity +
                  (0.5 - beta) * dt * dt * self.previous_acceleration)
        disp = self.current_displacement

        err_res = err_upd = 1.0
        init_res = init_upd = 1.0
        norm_res = norm_upd = 1.0
        it = 0
        while ((norm_upd > params.tol_d or norm_res > params.tol_f)
               and err_res > 1e-12 and err_upd > 1e-12):
            if it >= params.solid_max_iterations:
                raise RuntimeError("Too many Newton iterations!")
            du, err_res, cg_iters = self._newton_step_impl(
                disp, d_pred, self.previous_velocity,
                self.previous_acceleration, traction_rhs)
            err_upd = torch.linalg.vector_norm(cons.set_zero(du)).item()
            if it == 0:
                init_res = max(err_res, 1e-300)
                init_upd = max(err_upd, 1e-300)
            norm_res = err_res / init_res
            norm_upd = err_upd / init_upd
            disp = cons.distribute(disp + du)
            it += 1
        self.newton_iters = it

        a_new = (disp - d_pred) / (beta * dt * dt)
        v_new = (self.previous_velocity + dt * (1 - gamma) *
                 self.previous_acceleration + dt * gamma * a_new)
        self.current_displacement = disp
        self.current_acceleration = a_new
        self.current_velocity = v_new
        self.previous_displacement = disp
        self.previous_acceleration = a_new
        self.previous_velocity = v_new
        # reference: source/hyper_elasticity.cpp:84-202
        self._end_of_step_io(first_step)

    def _stress_from_strain(self, eps, gradu):
        """Kirchhoff stress at quadrature points for output."""
        d = self.dim
        F = torch.as_tensor(gradu + np.eye(d)[None, None])
        tau, _ = self._material(F)
        return tau.numpy()
