"""Implicit incompressible Navier-Stokes with Grad-Div stabilization (InsIM).

Counterpart of openifem_tpu/solvers/fluid/insim.py (reference:
include/insim.h, source/insim.cpp; weak form at
source/mpi_insim.cpp:263-304).

Scheme: backward Euler + Newton on (du, dp); each Newton system is solved by
FGMRES with the Grad-Div block-Schur right preconditioner
  P^-1 = [[A~^-1, -A~^-1 B^T S~^-1], [0, S~^-1]],
  S~^-1 = -(nu + gamma rho) Mp^-1 - (rho/dt) (B diag(Mu)^-1 B^T)^-1
(reference: source/insim.cpp:13-120), with A~^-1 an inner Jacobi-
preconditioned FGMRES run to a loose tolerance.  Every operator apply is a
matrix-free element-block matvec (la/operators.py), which on a CUDA device
runs the hand-written kernel of csrc/element_matvec.cu.

This port carries the element-matvec preconditioner branch.  The dense
condensed branch, block-Jacobi and polynomial inner preconditioners,
multigrid and the stencil layout raise NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...la.krylov import cg, fgmres
from ...la.operators import (element_diag, element_matvec,
                             element_matvec_nodeblock,
                             element_matvec_p_to_u_nodeblock,
                             element_matvec_taylor_hood,
                             element_matvec_u_to_p_nodeblock, scatter_add)
from .base import FluidSolverBase

_NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1, item {item})")


class InsIM(FluidSolverBase):
    # inner-solver knobs (same defaults as the JAX package)
    schur_cg_maxiter = 400
    mp_cg_maxiter = 200
    a_inner_restart = 50
    a_inner_restarts = 4
    a_inner_rtol = 1e-3
    # Mp/Sm CG relative tolerance inside the preconditioner (the outer
    # solve is flexible, so this only trades inner vs outer iterations)
    mp_sm_rtol = 1e-6
    # f32 Jacobian apply in the outer FGMRES (inexact Newton); the f64
    # assembled residual still gates Newton convergence
    f32_matrix = False
    outer_restart = 30
    outer_max_restarts = 40
    # run the whole block-Schur preconditioner in float32 (flexible outer:
    # changes only iteration counts, never the converged f64 solution)
    mixed_precision_precond = False
    # not ported: each raises NotImplementedError at setup when enabled
    a_block_jacobi = False
    a_poly = 1
    dense_precond = False
    dense_a_bf16 = False
    # the stencil layout of the JAX package is off by default in the port
    a_stencil = False

    def setup(self):
        assert (self.params.fluid_velocity_degree -
                self.params.fluid_pressure_degree) == 1, \
            "Velocity degree must be one higher than pressure (Taylor-Hood)"
        self._check_knobs()
        super().setup()
        self._precompute()

    def _check_knobs(self):
        if self.dense_precond or self.dense_a_bf16:
            raise NotImplementedError(
                "dense_precond / dense_a_bf16 " + _NOT_PORTED.format(item=1))
        if self.a_block_jacobi:
            raise NotImplementedError(
                "a_block_jacobi " + _NOT_PORTED.format(item=1))
        if self.a_poly > 1:
            raise NotImplementedError(
                "a_poly > 1 " + _NOT_PORTED.format(item=1))
        if self.a_stencil:
            raise NotImplementedError(
                "the stencil layout (a_stencil) " +
                _NOT_PORTED.format(item=2))

    def enable_pressure_mg(self, *args, **kwargs):
        raise NotImplementedError("pressure multigrid " +
                                  _NOT_PORTED.format(item=2))

    def enable_velocity_mg(self, *args, **kwargs):
        raise NotImplementedError("velocity multigrid " +
                                  _NOT_PORTED.format(item=2))

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

        self.Nu = t(cvu.N)                               # (q, nlu)
        self.Np = t(cvp.N)                               # (q, nlp)
        self.gu = t(cvu.grad)                            # (c,q,nlu,d)
        self.JxW = t(cvu.JxW)                            # (c,q)

        cd = self.sys.cell_dofs
        # the node-block layouts and the one-launch Taylor-Hood apply rely
        # on the velocity dofs being node-major, component-minor
        ucd = self.u_space.cell_dofs
        if not np.array_equal(
                cd[:, :self.nu_loc],
                (ucd[:, :, None] * d + np.arange(d)).reshape(n_c, -1)):
            raise ValueError("system dof table is not interleaved "
                             "[node*d + component]")
        self.cell_dofs = t(cd, index_dtype)
        self.cell_dofs_u = t(cd[:, :self.nu_loc], index_dtype)
        self.cell_dofs_p = t(cd[:, self.nu_loc:] - self.n_u, index_dtype)
        # velocity NODE table for the node-block matvec layout
        self.cell_nodes_u = t(ucd, index_dtype)
        self._p_cell_nodes = t(self.p_space.cell_dofs, torch.int64)

        # mass matrices for the preconditioner (no rho; reference
        # source/insim.cpp:255-257)
        Mu_s = np.einsum("qi,qj,cq->cij", cvu.N, cvu.N, cvu.JxW)
        diag_mu = np.zeros(self.n_u)
        dloc = np.einsum("cii->ci", Mu_s)
        for a in range(d):
            np.add.at(diag_mu, ucd.ravel() * d + a, dloc.ravel())
        self.Mu_diag = t(diag_mu)
        Mp_loc = np.einsum("qi,qj,cq->cij", cvp.N, cvp.N, cvp.JxW)
        self.Mp_loc = t(Mp_loc)
        diag_mp = np.zeros(self.n_p)
        np.add.at(diag_mp, self.p_space.cell_dofs.ravel(),
                  np.einsum("cii->ci", Mp_loc).ravel())
        self.Mp_diag = t(diag_mp)

        # gravity / body force at q points
        g = np.zeros(d)
        g[:len(params.gravity)] = params.gravity[:d]
        if self.body_force is not None:
            xq = cvu.xq.reshape(-1, d)
            bf = np.asarray(self.body_force(xq)).reshape(n_c, n_q, d)
            self.gravity_q = t(bf + g)
        else:
            self.gravity_q = t(np.broadcast_to(g, (n_c, n_q, d)).copy())

        # Neumann (pressure) boundary faces (reference:
        # source/insim.cpp:288-319)
        self._neumann_rhs_const = self._neumann_rhs()

        # constant (linearization-independent) part of the Newton matrix:
        # viscous + grad-div + mass/dt + B/B^T blocks.  Only the two
        # convection terms change per iteration.
        nu_visc, gamma, rho = params.viscosity, params.grad_div, \
            params.fluid_rho
        dt = self.time.get_delta_t()
        I_np = np.eye(d)
        NN = np.einsum("ql,qm,cq->clm", cvu.N, cvu.N, cvu.JxW)
        gg = np.einsum("cqlx,cqmx,cq->clm", cvu.grad, cvu.grad, cvu.JxW)
        Auu_c = np.einsum("clm,ab->clamb", nu_visc * gg + (rho / dt) * NN,
                          I_np)
        Auu_c = Auu_c + (gamma * rho) * np.einsum(
            "cqla,cqmb,cq->clamb", cvu.grad, cvu.grad, cvu.JxW)
        Auu_c = Auu_c.reshape(n_c, self.nu_loc, self.nu_loc)
        Aup = -np.einsum("cqla,qn,cq->clan", cvu.grad, cvp.N,
                         cvu.JxW).reshape(n_c, self.nu_loc, nlp)
        Apu = -np.einsum("qn,cqmb,cq->cnmb", cvp.N, cvu.grad,
                         cvu.JxW).reshape(n_c, nlp, self.nu_loc)
        nl = self.nu_loc + nlp
        A_const = np.zeros((n_c, nl, nl))
        A_const[:, :self.nu_loc, :self.nu_loc] = Auu_c
        A_const[:, :self.nu_loc, self.nu_loc:] = Aup
        A_const[:, self.nu_loc:, :self.nu_loc] = Apu
        self._mdt = torch.float32 if self.f32_matrix else real_dtype()
        self._A_const = t(A_const, self._mdt)
        self._Nu_m = t(cvu.N, self._mdt)
        self._gu_m = t(cvu.grad, self._mdt)
        self._JxW_m = t(cvu.JxW, self._mdt)
        self.krylov_iters = {"outer": 0, "mp": 0, "sm": 0, "a": 0}

    def _neumann_rhs(self):
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
            # rhs[(l,a)] -= N_l n_a p_bc JxW
            rl = -np.einsum("qi,qa,q->ia", fv.N[i], fv.normals[i],
                            fv.JxW[i]) * pbc
            c = int(fv.cells[i])
            np.add.at(rhs, self.sys.cell_dofs[c][:self.nu_loc],
                      rl.reshape(-1))
        return self._tensor(rhs)

    # ------------------------------------------------------------------
    def _assemble(self, eval_pt, present, indicator, fsi_acc, fsi_stress,
                  fsi_acc_nodal):
        """Element Newton matrix + rhs at evaluation point.

        Weak form: reference source/mpi_insim.cpp:263-304."""
        params = self.params
        d = self.dim
        nu_visc = params.viscosity
        gamma = params.grad_div
        rho = params.fluid_rho
        dt = self.time.get_delta_t()
        Nu, Np, gu, JxW = self.Nu, self.Np, self.gu, self.JxW
        n_c = gu.shape[0]
        nodes = self._u_cell_nodes

        ul = eval_pt[:self.n_u].reshape(-1, d)[nodes]           # (c,nlu,d)
        p_eval = eval_pt[self.n_u:][self._p_cell_nodes]          # (c,nlp)
        unl = present[:self.n_u].reshape(-1, d)[nodes]

        uc = torch.einsum("ql,cla->cqa", Nu, ul)
        guc = torch.einsum("cqlx,cla->cqax", gu, ul)
        pc = torch.einsum("qn,cn->cq", Np, p_eval)
        un = torch.einsum("ql,cla->cqa", Nu, unl)
        divu = torch.diagonal(guc, dim1=2, dim2=3).sum(-1)

        # matrix: constant part precomputed at setup; only the two
        # convection terms are linearization-dependent (built in f32 in
        # f32_matrix mode; the f64 rhs below gates Newton convergence)
        mdt = self._mdt
        I_m = torch.eye(d, dtype=mdt, device=self.device)
        Nu_m, gu_m, JxW_m = self._Nu_m, self._gu_m, self._JxW_m
        uc_m = uc.to(mdt)
        guc_m = guc.to(mdt)
        g_uc = torch.einsum("cqmx,cqx->cqm", gu_m, uc_m)
        conv2 = torch.einsum("ql,cqm,cq->clm", Nu_m, g_uc, JxW_m)
        conv = torch.einsum("clm,ab->clamb", rho * conv2, I_m)
        conv = conv + rho * torch.einsum("ql,qm,cqab,cq->clamb", Nu_m, Nu_m,
                                         guc_m, JxW_m)
        conv = conv.reshape(n_c, self.nu_loc, self.nu_loc)
        A_loc = self._A_const.clone()
        A_loc[:, :self.nu_loc, :self.nu_loc] += conv

        # RHS (negative residual)
        conv_c = torch.einsum("cqax,cqx->cqa", guc, uc)
        r_u = (-nu_visc * torch.einsum("cqax,cqlx,cq->cla", guc, gu, JxW)
               - rho * torch.einsum("ql,cqa,cq->cla", Nu, conv_c, JxW)
               + torch.einsum("cq,cqla,cq->cla", pc, gu, JxW)
               - (gamma * rho) * torch.einsum("cq,cqla,cq->cla", divu, gu,
                                              JxW)
               - (rho / dt) * torch.einsum("ql,cqa,cq->cla", Nu, uc - un,
                                           JxW)
               + rho * torch.einsum("ql,cqa,cq->cla", Nu, self.gravity_q,
                                    JxW))
        # FSI body force on artificial-fluid cells (reference:
        # source/insim.cpp:277-284): grad(phi):sigma_fsi + a_fsi . phi
        r_u = r_u + indicator[:, None, None] * (
            torch.einsum("cqla,cab,cq->clb", gu, fsi_stress, JxW) +
            torch.einsum("ql,ca,cq->cla", Nu, fsi_acc, JxW))
        # MPI-style nodal FSI acceleration field (reference:
        # source/mpi_insim.cpp:298-304, note the extra rho)
        acc_q = torch.einsum("ql,cla->cqa", Nu, fsi_acc_nodal[nodes])
        r_u = r_u + (rho * indicator[:, None, None]) * torch.einsum(
            "ql,cqa,cq->cla", Nu, acc_q, JxW)
        r_p = torch.einsum("cq,qn,cq->cn", divu, Np, JxW)

        r_loc = torch.cat([r_u.reshape(n_c, -1), r_p], dim=1)
        rhs = scatter_add(self.n_dofs, self.cell_dofs, r_loc)
        return A_loc, rhs + self._neumann_rhs_const

    # ------------------------------------------------------------------
    def _make_preconditioner(self, A_loc, ucons, pcons):
        """Grad-Div block-Schur right preconditioner (reference:
        source/insim.cpp:55-120), element-matvec branch."""
        params = self.params
        d = self.dim
        gamma, rho = params.grad_div, params.fluid_rho
        nu_visc = params.viscosity
        dt = self.time.get_delta_t()

        pdt = torch.float32 if self.mixed_precision_precond else A_loc.dtype
        A_loc = A_loc.to(pdt)
        Mp_loc = self.Mp_loc.to(pdt)
        Mu_diag = self.Mu_diag.to(pdt)
        Mp_diag = self.Mp_diag.to(pdt)

        nu = self.nu_loc
        Auu = A_loc[:, :nu, :nu]
        Aup = A_loc[:, :nu, nu:]
        Apu = A_loc[:, nu:, :nu]
        n_c = Auu.shape[0]
        nlu = nu // d
        nlp = Apu.shape[1]
        n_un = self.n_u // d
        cn_u, cd_u, cd_p = self.cell_nodes_u, self.cell_dofs_u, \
            self.cell_dofs_p

        # strided views of A_loc: the CUDA kernel reads them in place
        Auu_b = Auu.reshape(n_c, nlu, d, nlu, d)
        Apu_b = Apu.reshape(n_c, nlp, nlu, d)
        Aup_b = Aup.reshape(n_c, nlu, d, nlp)

        op_A = ucons.wrap_operator(
            lambda x: element_matvec_nodeblock(Auu_b, cn_u, n_un, x))
        diag_A = torch.where(ucons.fixed, 1.0,
                             element_diag(Auu, cd_u, self.n_u))
        dinv_A = torch.where(diag_A != 0, 1.0 / diag_A, 1.0)

        def apply_dinv_A(r):
            return r * dinv_A

        def apply_B(xu):   # u -> p   (condensed)
            xu = ucons.expand(xu)
            y = element_matvec_u_to_p_nodeblock(Apu_b, cn_u, cd_p, self.n_p,
                                                xu)
            return pcons.restrict(y) if pcons.any_hanging else y

        def apply_BT(xp):  # p -> u   (condensed)
            xp = pcons.expand(xp) if pcons.any_hanging else xp
            y = element_matvec_p_to_u_nodeblock(Aup_b, cn_u, cd_p, n_un, xp)
            return ucons.restrict(y)

        mu_inv = torch.where(Mu_diag != 0, 1.0 / Mu_diag, 1.0)

        def op_Sm(xp):
            y = apply_B(mu_inv * apply_BT(xp))
            return torch.where(pcons.fixed, xp, y)

        # Jacobi preconditioner for the mass-Schur CG from the cell-local
        # diagonal of B diag(Mu)^-1 B^T
        sm_diag_loc = torch.einsum("cnk,ck,cnk->cn", Apu, mu_inv[cd_u], Apu)
        sm_diag = scatter_add(self.n_p, cd_p, sm_diag_loc)
        sm_dinv = torch.where(
            sm_diag > 0, 1.0 / torch.where(sm_diag > 0, sm_diag, 1.0), 1.0)

        op_Mp = pcons.wrap_operator(
            lambda x: element_matvec(Mp_loc, cd_p, self.n_p, x))
        mp_dinv = torch.where(Mp_diag != 0, 1.0 / Mp_diag, 1.0)
        counts = self.krylov_iters

        def precond(v):
            out_dtype = v.dtype
            v = v.to(pdt)
            vu, vp = v[:self.n_u], v[self.n_u:]
            atol_p = torch.clamp(
                self.mp_sm_rtol * torch.linalg.vector_norm(vp), min=1e-10)
            mp = cg(op_Mp, vp, M=lambda r: r * mp_dinv, atol=atol_p,
                    maxiter=self.mp_cg_maxiter)
            tmp = mp.x * (-(nu_visc + gamma * rho))
            sm = cg(op_Sm, vp, M=lambda r: r * sm_dinv, atol=atol_p,
                    maxiter=self.schur_cg_maxiter)
            dst_p = sm.x * (-rho / dt) + tmp
            utmp = vu - apply_BT(dst_p)
            atol_u = self.a_inner_rtol * torch.linalg.vector_norm(utmp)
            au = fgmres(op_A, utmp, M=apply_dinv_A, atol=atol_u,
                        restart=self.a_inner_restart,
                        max_restarts=self.a_inner_restarts)
            counts["mp"] += mp.iters
            counts["sm"] += sm.iters
            counts["a"] += au.iters
            return torch.cat([au.x, dst_p]).to(out_dtype)

        return precond

    # ------------------------------------------------------------------
    def _newton_iter_impl(self, eval_pt, present, indicator, fsi_acc,
                          fsi_stress, fsi_acc_nodal, cons, ucons, pcons,
                          res0=None):
        """One Newton iteration: assemble, condense, FGMRES.  Returns
        (du, res_norm, outer_iters, outer_residual)."""
        A_loc, rhs = self._assemble(eval_pt, present, indicator, fsi_acc,
                                    fsi_stress, fsi_acc_nodal)
        b = cons.condense_rhs(rhs)
        res_norm = torch.linalg.vector_norm(b).item()
        atol = self._outer_atol(res_norm, res0, max(1e-8 * res_norm, 1e-10))

        nlu = self.nu_loc // self.dim
        mdt = torch.float32 if self.f32_matrix else A_loc.dtype
        A_op = A_loc.to(mdt)

        def apply_A(x):
            y = element_matvec_taylor_hood(
                A_op, self.cell_nodes_u, self.cell_dofs_p, nlu, self.dim,
                self.n_u, self.n_p, x.to(mdt), cell_dofs=self.cell_dofs)
            return y.to(x.dtype)

        op = cons.wrap_operator(apply_A)
        precond = self._make_preconditioner(A_loc, ucons, pcons)
        x, iters, residual = self._outer_solve(op, b, precond, atol)
        self.krylov_iters["outer"] += iters
        du = cons.distribute(x)
        return du, res_norm, iters, residual

    # ------------------------------------------------------------------
    def make_fsi_step(self):
        """One coupled-run time step: the Newton loop with the stopping
        rules of the JAX package's fused step (insim.py make_fsi_step),
        run eagerly.  Returns fn(present, indicator, fsi_acc, fsi_stress,
        fsi_acc_nodal, zero_cons, nonzero_cons, ucons, pcons) ->
        (present, stress_nodal, rel_res, newton_iters)."""
        tol = self.params.fluid_tolerance
        max_it = self.params.fluid_max_iterations

        def step(present, indicator, fsi_acc, fsi_stress, fsi_acc_nodal,
                 zero_cons, nonzero_cons, ucons, pcons):
            def newton_once(eval_pt, res0=None):
                du, rn, its, _ = self._newton_iter_impl(
                    eval_pt, present, indicator, fsi_acc, fsi_stress,
                    fsi_acc_nodal, zero_cons, ucons, pcons, res0=res0)
                return eval_pt + du, rn, its

            def stagnated(res, prev, last_its):
                # a 0-iteration Krylov solve with a non-decreasing residual
                # is machine-level stagnation -> treat as converged
                return last_its == 0 and res >= prev * (1 - 1e-12)

            eval_pt = nonzero_cons.apply_increment(present)
            eval_pt, res0, last_its = newton_once(eval_pt)
            it, res, prev = 1, res0, math.inf
            while (res / max(res0, 1e-300) > tol and res > 1e-11 and
                   it < max_it and not stagnated(res, prev, last_its)):
                eval_pt, rn, last_its = newton_once(eval_pt, res0)
                it, prev, res = it + 1, res, rn
            rel = res / max(res0, 1e-300) if res0 > 1e-11 else 0.0
            if stagnated(res, prev, last_its):
                rel = 0.0
            return eval_pt, self._update_stress_impl(eval_pt), rel, it

        return step

    def run_one_step(self, apply_nonzero_constraints: bool,
                     assemble_system: bool = True, verbose: bool = True,
                     zero_cons=None, nonzero_cons=None):
        """reference: source/insim.cpp:370-459."""
        params = self.params
        zero_cons = zero_cons or self.zero_constraints
        nonzero_cons = nonzero_cons or self.nonzero_constraints
        self.time.increment()
        if verbose:
            print(f"*** Time step = {self.time.get_timestep()}, "
                  f"at t = {self.time.current():.6e}")

        eval_pt = self.present_solution
        if apply_nonzero_constraints:
            eval_pt = nonzero_cons.apply_increment(eval_pt)

        current_res = 1.0
        initial_res = 1.0
        rel_res = 1.0
        prev_res = None
        it = 0
        while rel_res > params.fluid_tolerance and current_res > 1e-11:
            if it >= params.fluid_max_iterations:
                raise RuntimeError("Too many Newton iterations!")
            with self.timer.scope("Assemble + solve (Newton iter)"):
                du, current_res, gmres_iters, gmres_res = \
                    self._newton_iter_impl(
                        eval_pt, self.present_solution, self.indicator,
                        self.fsi_acceleration, self.fsi_stress_cell,
                        self.fsi_acc_nodal, zero_cons,
                        self._u_cons_of(zero_cons), self.p_constraints,
                        res0=initial_res if it > 0 else math.inf)
            if (prev_res is not None and gmres_iters == 0
                    and current_res >= prev_res * (1 - 1e-12)):
                # fully stagnated at machine-level residual
                break
            prev_res = current_res
            eval_pt = eval_pt + du
            if it == 0:
                initial_res = max(current_res, 1e-300)
            rel_res = current_res / initial_res
            if verbose:
                print(f" ITR = {it} ABS_RES = {current_res:.6e} "
                      f"REL_RES = {rel_res:.6e} "
                      f"GMRES_ITR = {gmres_iters} "
                      f"GMRES_RES = {gmres_res:.6e}")
            it += 1
        self.newton_iters = it
        self.solution_increment = eval_pt - self.present_solution
        self.present_solution = eval_pt
        with self.timer.scope("Update stress"):
            self.update_stress()
        self._end_of_step_io(refine_levels=(1, 3))

    def run(self, verbose: bool = True):
        """reference: source/insim.cpp:445-459."""
        if not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[0])
            self.setup()
        self.run_one_step(True, verbose=verbose)
        while self.time.end() - self.time.current() > 1e-12:
            self.run_one_step(False, verbose=verbose)
