"""Incompressible NS with implicit-explicit (IMEX) splitting.

Counterpart of openifem_tpu/solvers/fluid/insimex.py (reference:
include/insimex.h, source/insimex.cpp).  Convection is treated
explicitly, so the system matrix is symmetric, constant in time (built
once at setup), and each time step costs ONE linear solve for the
increment d(u,p):
  LHS = nu K + grad-div + M_u rho/dt - B^T - B
  RHS = -(residual of present solution with explicit convection)
(reference weak form: source/insimex.cpp:228-256).

The block-Schur preconditioner is the same as InsIM's but every inner
solve is a plain CG, the A-block included (the reference does exactly
this: CG + identity, source/insimex.cpp:96-108).  B and B^T are applied
in the flat rectangular layout (`element_matvec_rect`) and the outer
operator in the scalar layout over the system dof table, so on a CUDA
device every operator apply runs the hand-written kernel of
csrc/element_matvec.cu.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...la.krylov import cg, fgmres
from ...la.operators import (element_diag, element_matvec,
                             element_matvec_rect, scatter_add)
from .base import FluidSolverBase


class InsIMEX(FluidSolverBase):
    mp_cg_maxiter = 200
    schur_cg_maxiter = 400
    a_cg_maxiter = 1000
    mixed_precision_precond = False  # f32 preconditioner (see InsIM)
    outer_restart = 30
    outer_max_restarts = 40

    def setup(self):
        assert (self.params.fluid_velocity_degree -
                self.params.fluid_pressure_degree) == 1
        super().setup()
        self._precompute()

    # ------------------------------------------------------------------
    def _precompute(self):
        params = self.params
        d = self.dim
        cvu, cvp = self.cv_u, self.cv_p
        n_c, n_q, nlu, _ = cvu.grad.shape
        nlp = cvp.N.shape[1]
        self.nlu, self.nlp = nlu, nlp
        self.nu_loc = nlu * d
        t = self._tensor

        self.Nu = t(cvu.N)
        self.Np = t(cvp.N)
        self.gu = t(cvu.grad)
        self.JxW = t(cvu.JxW)

        cd = self.sys.cell_dofs
        self.cell_dofs = t(cd, index_dtype)
        self.cell_dofs_u = t(cd[:, :self.nu_loc], index_dtype)
        self.cell_dofs_p = t(cd[:, self.nu_loc:] - self.n_u, index_dtype)
        self._p_cell_nodes = t(self.p_space.cell_dofs, torch.int64)

        Mu_s = np.einsum("qi,qj,cq->cij", cvu.N, cvu.N, cvu.JxW)
        diag_mu = np.zeros(self.n_u)
        dloc = np.einsum("cii->ci", Mu_s)
        for a in range(d):
            np.add.at(diag_mu, self.u_space.cell_dofs.ravel() * d + a,
                      dloc.ravel())
        self.Mu_diag = t(diag_mu)
        Mp_loc = np.einsum("qi,qj,cq->cij", cvp.N, cvp.N, cvp.JxW)
        self.Mp_loc = t(Mp_loc)
        diag_mp = np.zeros(self.n_p)
        np.add.at(diag_mp, self.p_space.cell_dofs.ravel(),
                  np.einsum("cii->ci", Mp_loc).ravel())
        self.Mp_diag = t(diag_mp)

        g = np.zeros(d)
        g[:len(params.gravity)] = params.gravity[:d]
        if self.body_force is not None:
            xq = cvu.xq.reshape(-1, d)
            bf = np.asarray(self.body_force(xq)).reshape(n_c, n_q, d)
            self.gravity_q = t(bf + g)
        else:
            self.gravity_q = t(np.broadcast_to(g, (n_c, n_q, d)).copy())

        self._neumann_rhs_const = self._assemble_neumann()
        self._build_matrix()
        # outer / (mp, sm, a) inner iterations, preconditioner applies
        self.krylov_iters = {"outer": 0, "mp": 0, "sm": 0, "a": 0,
                             "applies": 0}

    def _assemble_neumann(self):
        params = self.params
        fv = self.fv_u
        rhs = np.zeros(self.n_dofs)
        if fv is None or params.n_fluid_neumann_bcs == 0:
            return self._tensor(rhs)
        for i in range(len(fv.cells)):
            bid = int(fv.boundary_id[i])
            if bid not in params.fluid_neumann_bcs:
                continue
            pbc = params.fluid_neumann_bcs[bid]
            rl = -np.einsum("qi,qa,q->ia", fv.N[i], fv.normals[i],
                            fv.JxW[i]) * pbc
            c = int(fv.cells[i])
            np.add.at(rhs, self.sys.cell_dofs[c][:self.nu_loc],
                      rl.reshape(-1))
        return self._tensor(rhs)

    def _build_matrix(self):
        """Constant IMEX system matrix (reference:
        source/insimex.cpp:228-243)."""
        params = self.params
        d = self.dim
        nu_visc, gamma, rho = (params.viscosity, params.grad_div,
                               params.fluid_rho)
        dt = self.time.get_delta_t()
        Nu, Np, gu, JxW = self.Nu, self.Np, self.gu, self.JxW
        n_c = gu.shape[0]
        nu = self.nu_loc
        I = torch.eye(d, dtype=real_dtype(), device=self.device)

        NN = torch.einsum("ql,qm,cq->clm", Nu, Nu, JxW)
        gg = torch.einsum("cqlx,cqmx,cq->clm", gu, gu, JxW)
        Auu = torch.einsum("clm,ab->clamb", nu_visc * gg + (rho / dt) * NN,
                           I)
        Auu = Auu + (gamma * rho) * torch.einsum("cqla,cqmb,cq->clamb",
                                                 gu, gu, JxW)
        # one (n_c, nl, nl) table; Auu, Aup and Apu are views of it (the
        # App block stays zero)
        nl = nu + self.nlp
        self.A_loc = torch.zeros((n_c, nl, nl), dtype=real_dtype(),
                                 device=self.device)
        self.A_loc[:, :nu, :nu] = Auu.reshape(n_c, nu, nu)
        self.A_loc[:, :nu, nu:] = -torch.einsum(
            "cqla,qn,cq->clan", gu, Np, JxW).reshape(n_c, nu, self.nlp)
        self.A_loc[:, nu:, :nu] = -torch.einsum(
            "qn,cqmb,cq->cnmb", Np, gu, JxW).reshape(n_c, self.nlp, nu)
        self.Auu = self.A_loc[:, :nu, :nu]
        self.Aup = self.A_loc[:, :nu, nu:]
        self.Apu = self.A_loc[:, nu:, :nu]

    # ------------------------------------------------------------------
    def _assemble_rhs(self, present, indicator, fsi_acc, fsi_stress):
        """Incremental residual RHS (reference: source/insimex.cpp:244-262)."""
        params = self.params
        d = self.dim
        nu_visc, gamma, rho = (params.viscosity, params.grad_div,
                               params.fluid_rho)
        Nu, Np, gu, JxW = self.Nu, self.Np, self.gu, self.JxW
        n_c = gu.shape[0]

        ul = present[:self.n_u].reshape(-1, d)[self._u_cell_nodes]
        pl = present[self.n_u:][self._p_cell_nodes]
        uc = torch.einsum("ql,cla->cqa", Nu, ul)
        guc = torch.einsum("cqlx,cla->cqax", gu, ul)
        pc = torch.einsum("qn,cn->cq", Np, pl)
        divu = torch.diagonal(guc, dim1=2, dim2=3).sum(-1)
        conv = torch.einsum("cqax,cqx->cqa", guc, uc)

        r_u = -(nu_visc * torch.einsum("cqax,cqlx,cq->cla", guc, gu, JxW)
                - torch.einsum("cq,cqla,cq->cla", pc, gu, JxW)
                + (gamma * rho) * torch.einsum("cq,cqla,cq->cla", divu, gu,
                                               JxW)
                + rho * torch.einsum("ql,cqa,cq->cla", Nu, conv, JxW)
                - rho * torch.einsum("ql,cqa,cq->cla", Nu, self.gravity_q,
                                     JxW))
        # FSI force (note the extra rho on fsi_acceleration vs InsIM;
        # reference: source/insimex.cpp:252-259)
        r_u = r_u + indicator[:, None, None] * (
            torch.einsum("cqla,cab,cq->clb", gu, fsi_stress, JxW) +
            rho * torch.einsum("ql,ca,cq->cla", Nu, fsi_acc, JxW))
        r_p = torch.einsum("cq,qn,cq->cn", divu, Np, JxW)
        r_loc = torch.cat([r_u.reshape(n_c, -1), r_p], dim=1)
        rhs = scatter_add(self.n_dofs, self.cell_dofs, r_loc)
        return rhs + self._neumann_rhs_const

    def _make_preconditioner(self):
        params = self.params
        gamma, rho = params.grad_div, params.fluid_rho
        nu_visc = params.viscosity
        dt = self.time.get_delta_t()
        ucons, pcons = self.u_constraints, self.p_constraints
        cd_u, cd_p = self.cell_dofs_u, self.cell_dofs_p
        pdt = torch.float32 if self.mixed_precision_precond else \
            self.A_loc.dtype
        # the blocks stay views of one table: the CUDA kernel reads them
        # in place through the table's strides
        A_loc = self.A_loc.to(pdt)
        nu = self.nu_loc
        Auu = A_loc[:, :nu, :nu]
        Aup = A_loc[:, :nu, nu:]
        Apu = A_loc[:, nu:, :nu]

        op_A = ucons.wrap_operator(
            lambda x: element_matvec(Auu, cd_u, self.n_u, x))
        diag_A = torch.where(ucons.fixed, 1.0,
                             element_diag(Auu, cd_u, self.n_u))
        dinv_A = torch.where(diag_A != 0, 1.0 / diag_A, 1.0)

        def apply_B(xu):
            xu = ucons.expand(xu)
            y = element_matvec_rect(Apu, cd_p, cd_u, self.n_p, xu)
            return pcons.restrict(y) if pcons.any_hanging else y

        def apply_BT(xp):
            xp = pcons.expand(xp) if pcons.any_hanging else xp
            y = element_matvec_rect(Aup, cd_u, cd_p, self.n_u, xp)
            return ucons.restrict(y)

        mu_inv = torch.where(self.Mu_diag != 0, 1.0 / self.Mu_diag,
                             1.0).to(pdt)

        def op_Sm(xp):
            y = apply_B(mu_inv * apply_BT(xp))
            return torch.where(pcons.fixed, xp, y)

        Mp_loc = self.Mp_loc.to(pdt)
        op_Mp = pcons.wrap_operator(
            lambda x: element_matvec(Mp_loc, cd_p, self.n_p, x))
        mp_dinv = torch.where(self.Mp_diag != 0, 1.0 / self.Mp_diag,
                              1.0).to(pdt)
        counts = self.krylov_iters

        def precond(v):
            out_dtype = v.dtype
            v = v.to(pdt)
            vu, vp = v[:self.n_u], v[self.n_u:]
            atol_p = 1e-6 * torch.linalg.vector_norm(vp)
            mp = cg(op_Mp, vp, M=lambda r: r * mp_dinv, atol=atol_p,
                    maxiter=self.mp_cg_maxiter)
            tmp = mp.x * (-(nu_visc + gamma * rho))
            sm = cg(op_Sm, vp, atol=atol_p, maxiter=self.schur_cg_maxiter)
            dst_p = sm.x * (-rho / dt) + tmp
            utmp = vu - apply_BT(dst_p)
            # reference: CG tol relative to the incoming velocity block
            atol_u = 1e-6 * torch.linalg.vector_norm(vu)
            au = cg(op_A, utmp, M=lambda r: r * dinv_A, atol=atol_u,
                    maxiter=self.a_cg_maxiter)
            counts["mp"] += mp.iters
            counts["sm"] += sm.iters
            counts["a"] += au.iters
            counts["applies"] += 1
            return torch.cat([au.x, dst_p]).to(out_dtype)

        return precond

    # ------------------------------------------------------------------
    def _step_impl(self, present, indicator, fsi_acc, fsi_stress):
        cons = self.zero_constraints
        rhs = self._assemble_rhs(present, indicator, fsi_acc, fsi_stress)
        b = cons.condense_rhs(rhs)
        res_norm = torch.linalg.vector_norm(b).item()
        op = cons.wrap_operator(lambda x: element_matvec(
            self.A_loc, self.cell_dofs, self.n_dofs, x))
        precond = self._make_preconditioner()
        atol = min(1e-9, 1e-8 * res_norm)
        res = fgmres(op, b, M=precond, atol=atol,
                     restart=self.outer_restart,
                     max_restarts=self.outer_max_restarts)
        self.krylov_iters["outer"] += res.iters
        du = cons.distribute(res.x)
        return du, res_norm, res.iters, res.residual

    def run_one_step(self, apply_nonzero_constraints: bool,
                     assemble_system: bool = True, verbose: bool = True):
        """reference: source/insimex.cpp:355-393.  The matrix is constant
        and built at setup, so `assemble_system` changes nothing (the
        argument keeps the reference's signature)."""
        self.time.increment()
        if verbose:
            print(f"*** Time step = {self.time.get_timestep()}, "
                  f"at t = {self.time.current():.6e}")

        present = self.present_solution
        if apply_nonzero_constraints:
            # fold the inhomogeneous BC values into the increment
            present = self.nonzero_constraints.apply_increment(present)
        bc_shift = present - self.present_solution

        du, res_norm, iters, gres = self._step_impl(
            present, self.indicator, self.fsi_acceleration,
            self.fsi_stress_cell)
        self.solution_increment = du + bc_shift
        self.present_solution = self.present_solution + \
            self.solution_increment
        if verbose:
            print(f" GMRES_ITR = {iters} GMRES_RES = {gres:.6e}")
        self.update_stress()
        # reference: source/insimex.cpp:378-388, source/mpi_insimex.cpp:433-444
        self._end_of_step_io(refine_levels=(1, 3))

    def run(self, verbose: bool = True):
        if not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[0])
            self.setup()
        while self.time.end() - self.time.current() > 1e-12:
            self.run_one_step(self.time.get_timestep() == 0,
                              self.time.get_timestep() < 2, verbose=verbose)
