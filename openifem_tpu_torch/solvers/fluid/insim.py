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

Every branch of the JAX package's preconditioner is here: the element
matvec, the dense condensed operators (la/dense.py), block-Jacobi and
polynomial inner preconditioners, the structured-patch stencil layout
(la/stencil.py) and the pressure / velocity V-cycles (la/multigrid.py).
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...la.krylov import cg, fgmres
from ...la.operators import (element_diag, element_matvec,
                             element_matvec_nodeblock,
                             element_matvec_p_to_u_nodeblock,
                             element_matvec_taylor_hood,
                             element_matvec_u_to_p_nodeblock, scatter_add)
from .base import FluidSolverBase, _whole


class InsIM(FluidSolverBase):
    # inner-solver knobs (same defaults and meaning as the JAX package)
    schur_cg_maxiter = 400
    mp_cg_maxiter = 200
    a_inner_restart = 50
    a_inner_restarts = 4
    a_inner_rtol = 1e-3
    # Mp/Sm CG relative tolerance inside the preconditioner (the outer
    # solve is flexible, so this only trades inner vs outer iterations)
    mp_sm_rtol = 1e-6
    # nodal d x d block-Jacobi for the inner A-solve instead of pointwise
    # Jacobi (preconditioner choice only)
    a_block_jacobi = False
    # f32 Jacobian apply in the outer FGMRES (inexact Newton); the f64
    # assembled residual still gates Newton convergence
    f32_matrix = False
    outer_restart = 30
    outer_max_restarts = 40
    # with multigrid enabled, apply the V-cycles DIRECTLY as the inner
    # approximate solves instead of preconditioning the inner Krylov loops
    mg_direct = False
    a_mg_cycles = 1
    # with mg_direct + velocity MG: keep the A block as an MG-preconditioned
    # inner FGMRES instead of raw cycles
    a_mg_precond = False
    # run the inner A-block FGMRES in the structured-patch stencil layout
    # when the mesh supports it (la/stencil.py): same condensed operator,
    # same iteration counts (ownership-weighted inner products)
    a_stencil = True
    # polynomial (damped-Jacobi Richardson) inner preconditioner: a_poly
    # Jacobi sweeps per FGMRES preconditioner apply
    a_poly = 1
    a_poly_omega = 0.8
    # dense condensed inner operators for the whole preconditioner
    # (la/dense.py); dense_a_bf16 stores and multiplies the A block in
    # bfloat16 (preconditioner only)
    dense_precond = False
    dense_a_bf16 = False
    # run the whole block-Schur preconditioner in float32 (flexible outer:
    # changes only iteration counts, never the converged f64 solution)
    mixed_precision_precond = False

    def setup(self):
        assert (self.params.fluid_velocity_degree -
                self.params.fluid_pressure_degree) == 1, \
            "Velocity degree must be one higher than pressure (Taylor-Hood)"
        # attached V-cycles are built against the OLD mesh's tables; drop
        # them (re-enable with a fresh hierarchy after setup)
        self._pressure_mg = None
        self._velocity_mg = None
        super().setup()
        self._precompute()

    # ------------------------------------------------------------------
    def enable_pressure_mg(self, meshes, n_smooth: int = 2,
                           fixed_prefix: bool = True, galerkin: bool = False):
        """Attach a V-cycle (la/multigrid.py) as the inner preconditioner
        of the mass-Schur CG, or with mg_direct as Sm^-1 itself.  `meshes`
        is the nested hierarchy, coarsest first, finest == self.mesh.
        galerkin=False (default): the frozen pressure-Laplacian cycle;
        galerkin=True coarsens the cell-local Sm blocks of each Newton
        matrix.  Preconditioner-only: the converged solution is
        unchanged."""
        from ...fe.space import FESpace
        from ...la.multigrid import GalerkinMG, make_pressure_mg
        assert meshes[-1].n_cells == self.mesh.n_cells, \
            "finest hierarchy level must be the solver mesh"
        assert self.params.fluid_pressure_degree == 1, (
            "pressure V-cycle assumes a Q1 pressure space (node-id-prefix "
            "mask restriction); got degree "
            f"{self.params.fluid_pressure_degree}")
        pdt = torch.float32 if self.mixed_precision_precond else \
            real_dtype()
        fixed = self.p_constraints.fixed.cpu().numpy()
        if galerkin:
            spaces = [FESpace(m, 1) for m in meshes[:-1]] + [self.p_space]
            self._pressure_mg = GalerkinMG(
                spaces, self.p_space.cell_dofs, None, fixed,
                n_smooth=n_smooth, dtype=pdt, device=self.device)
        else:
            self._pressure_mg = make_pressure_mg(
                meshes, fixed, n_smooth, pdt, fixed_prefix=fixed_prefix,
                device=self.device)

    def enable_velocity_mg(self, meshes, n_smooth: int = 2,
                           galerkin: bool = True):
        """Attach a vector V-cycle as the preconditioner of the inner
        A-block FGMRES (or, with mg_direct, as the A-solve itself).
        galerkin=True (default) coarsens the true per-Newton velocity
        block (convection included); galerkin=False keeps the frozen
        symmetric cycle (rho/dt M + mu K + gamma rho G), full refinements
        only."""
        from ...fe.space import FESpace
        from ...la.multigrid import GalerkinMG, make_velocity_mg
        assert meshes[-1].n_cells == self.mesh.n_cells
        params = self.params
        pdt = torch.float32 if self.mixed_precision_precond else \
            real_dtype()
        fixed = self.u_constraints.fixed.cpu().numpy()
        if galerkin:
            deg = params.fluid_velocity_degree
            spaces = [FESpace(m, deg) for m in meshes[:-1]] + \
                [self.u_space]
            self._velocity_mg = GalerkinMG(
                spaces, self.u_space.cell_dofs, None, fixed,
                n_smooth=n_smooth, dtype=pdt, ncomp=self.dim,
                device=self.device)
        else:
            self._velocity_mg = make_velocity_mg(
                meshes, params.fluid_velocity_degree, self.dim,
                params.fluid_rho, params.viscosity, params.grad_div,
                float(self.time.get_delta_t()), fixed, n_smooth, pdt,
                device=self.device)

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

        # structured-patch stencil for the inner A-block solve
        # (la/stencil.py), when the mesh is brick-structured; the
        # preconditioner falls back to the element matvec otherwise
        self._u_stencil = None
        if self.a_stencil:
            from ...la.stencil import PatchGrid, StencilOperator
            pgrid = PatchGrid.build(self.mesh)
            if pgrid is not None:
                self._u_stencil = StencilOperator(pgrid, self.u_space, d=d,
                                                  device=self.device)

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
        self.krylov_iters = {"outer": 0, "mp": 0, "sm": 0, "a": 0,
                             "applies": 0}
        # preconditioner builds per (A-solve, Sm-solve) branch
        self.precond_branches = Counter()

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
    def a_solve_branch(self, ucons):
        """Which inner A-solve the preconditioner takes for constraints
        `ucons` (the same decision as the JAX package's
        _make_preconditioner): "dense", "velocity_mg", "stencil" (the
        patch layout), "stencil_flat" (the stencil inside the constraint
        wrap, hanging-node meshes) or "element"."""
        if self.dense_precond:
            return "dense"
        if self._velocity_mg is not None:
            return "velocity_mg"
        if self._u_stencil is not None:
            return "stencil_flat" if ucons.any_hanging else "stencil"
        return "element"

    def sm_solve_branch(self):
        """The mass-Schur solve: "cg" (Jacobi CG), "cg+vcycle" (CG
        preconditioned by the pressure V-cycle) or "vcycle" (mg_direct:
        one V-cycle as Sm^-1)."""
        if self._pressure_mg is None:
            return "cg"
        return "vcycle" if self.mg_direct else "cg+vcycle"

    def _make_preconditioner(self, A_loc, ucons, pcons):
        """Grad-Div block-Schur right preconditioner (reference:
        source/insim.cpp:55-120).

        On a rank's view of the solver (parallel/shard.py) the cell
        tables are the rank's and `cell_reduce` is the sum over the ranks:
        every element-block apply and diagonal then covers the rank's
        cells and is reduced.  A solver has no cell_reduce."""
        from ...la.multigrid import GalerkinMG
        red = getattr(self, "cell_reduce", None) or _whole
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
            lambda x: red(element_matvec_nodeblock(Auu_b, cn_u, n_un, x)))
        if self.a_block_jacobi:
            # nodal d x d block-Jacobi: the grad-div term couples velocity
            # components, which pointwise Jacobi ignores
            from ...la.smalltensor import inv as small_inv
            diag_blocks = torch.diagonal(Auu_b, dim1=1, dim2=3).permute(
                0, 3, 1, 2)                              # (n_c, nlu, d, d)
            D = torch.zeros((n_un, d, d), dtype=pdt, device=self.device)
            D.index_add_(0, cn_u.reshape(-1).long(),
                         diag_blocks.reshape(-1, d, d))
            D = red(D)
            fixed = ucons.fixed.reshape(n_un, d)
            fi = fixed[:, :, None] | fixed[:, None, :]
            D = torch.where(fi, torch.eye(d, dtype=pdt, device=self.device),
                            D)
            Dinv = small_inv(D)

            def apply_dinv_A(r):
                return torch.einsum("nab,nb->na", Dinv,
                                    r.reshape(n_un, d)).reshape(-1)
        else:
            diag_A = torch.where(ucons.fixed, 1.0,
                                 red(element_diag(Auu, cd_u, self.n_u)))
            dinv_A = torch.where(diag_A != 0, 1.0 / diag_A, 1.0)

            def apply_dinv_A(r):
                return r * dinv_A

        def apply_B(xu):   # u -> p   (condensed)
            xu = ucons.expand(xu)
            y = red(element_matvec_u_to_p_nodeblock(Apu_b, cn_u, cd_p,
                                                    self.n_p, xu))
            return pcons.restrict(y) if pcons.any_hanging else y

        def apply_BT(xp):  # p -> u   (condensed)
            xp = pcons.expand(xp) if pcons.any_hanging else xp
            y = red(element_matvec_p_to_u_nodeblock(Aup_b, cn_u, cd_p, n_un,
                                                    xp))
            return ucons.restrict(y)

        mu_inv = torch.where(Mu_diag != 0, 1.0 / Mu_diag, 1.0)

        def op_Sm(xp):
            y = apply_B(mu_inv * apply_BT(xp))
            return torch.where(pcons.fixed, xp, y)

        # Jacobi preconditioner for the mass-Schur CG from the cell-local
        # diagonal of B diag(Mu)^-1 B^T
        sm_diag_loc = torch.einsum("cnk,ck,cnk->cn", Apu, mu_inv[cd_u], Apu)
        sm_diag = red(scatter_add(self.n_p, cd_p, sm_diag_loc))
        sm_dinv = torch.where(
            sm_diag > 0, 1.0 / torch.where(sm_diag > 0, sm_diag, 1.0), 1.0)

        op_Mp = pcons.wrap_operator(
            lambda x: red(element_matvec(Mp_loc, cd_p, self.n_p, x)))
        mp_dinv = torch.where(Mp_diag != 0, 1.0 / Mp_diag, 1.0)

        if self.dense_precond:
            # dense condensed inner operators (la/dense.py): exactly the
            # condensed matvecs (R A E + fixed identity), so iteration
            # counts are unchanged; the explicit Sm = B diag(Mu)^-1 B^T
            # mirrors the reference's mass_schur assembly
            # (source/mpi_insim.cpp:36-50)
            from ...la.dense import (add_unit_diag, condensed_dense, gemv,
                                     hanging_tables)
            uht = hanging_tables(self.u_constraints)
            pht = hanging_tables(self.p_constraints)
            Ad = condensed_dense(Auu, cd_u, cd_u, self.n_u, self.n_u,
                                 ucons, ucons, uht, uht,
                                 unit_fixed_diag=True)
            Bd = condensed_dense(Apu, cd_p, cd_u, self.n_p, self.n_u,
                                 pcons, ucons, pht, uht)
            Btd = condensed_dense(Aup, cd_u, cd_p, self.n_u, self.n_p,
                                  ucons, pcons, uht, pht)
            Sd = add_unit_diag(Bd @ (mu_inv[:, None] * Btd), pcons.fixed)
            del Bd
            Mpd = condensed_dense(Mp_loc, cd_p, cd_p, self.n_p, self.n_p,
                                  pcons, pcons, pht, pht,
                                  unit_fixed_diag=True)
            dA = torch.diagonal(Ad)
            dinv_A = torch.where(dA != 0, 1.0 / dA, 1.0)
            # the bf16 A block replaces the f32/f64 one (not kept beside it)
            A_mv = Ad.to(torch.bfloat16) if self.dense_a_bf16 else Ad
            del Ad, dA
            op_A = lambda x: gemv(A_mv, x)           # noqa: E731
            apply_BT = lambda xp: gemv(Btd, xp)      # noqa: E731
            op_Sm = lambda xp: gemv(Sd, xp)          # noqa: E731
            op_Mp = lambda x: gemv(Mpd, x)           # noqa: E731
            apply_dinv_A = lambda r: r * dinv_A      # noqa: E731
            dS = torch.diagonal(Sd)
            sm_dinv = torch.where(
                dS > 0, 1.0 / torch.where(dS > 0, dS, 1.0), 1.0)

        mg = self._pressure_mg
        if isinstance(mg, GalerkinMG):
            # cell-local mass-Schur blocks of THIS Newton matrix
            sm_loc = torch.einsum("cik,ck,cjk->cij", Apu, mu_inv[cd_u], Apu)
            fixp = pcons.fixed[cd_p]
            sm_loc = torch.where(fixp[:, None, :] | fixp[:, :, None], 0.0,
                                 sm_loc)
            sm_M = mg.build(sm_loc)
        elif mg is not None:
            sm_M = mg.vcycle
        else:
            sm_M = lambda r: r * sm_dinv             # noqa: E731
        vmg = self._velocity_mg
        if isinstance(vmg, GalerkinMG):
            # TRUE velocity block (convection included), fixed rows/cols
            # projected out
            fixu = ucons.fixed[cd_u]
            a_M = vmg.build(torch.where(fixu[:, None, :] | fixu[:, :, None],
                                        0.0, Auu))
        elif vmg is not None:
            a_M = vmg.vcycle
        else:
            a_M = apply_dinv_A

        def _poly_wrap(base_M, op):
            """a_poly damped-Jacobi Richardson sweeps as one preconditioner
            apply: z0 = w M r; z_{i+1} = z_i + w M (r - A z_i)."""
            k_p, omega = self.a_poly, self.a_poly_omega
            if k_p <= 1:
                return base_M

            def M(r):
                z = omega * base_M(r)
                for _ in range(k_p - 1):
                    z = z + omega * base_M(r - op(z))
                return z
            return M

        # structured-patch stencil inner A-solve (la/stencil.py): the
        # whole inner FGMRES runs in the duplicated patch layout with
        # ownership-weighted inner products, or (hanging-node meshes) the
        # stencil replaces the element matvec inside the constraint wrap
        a_branch = self.a_solve_branch(ucons)
        st = self._u_stencil
        if a_branch == "stencil":
            W_st = st.build_weights(Auu_b)
            fix_st = st.spread_mask(ucons.fixed)
            w_st = st.weight(pdt)
            if self.a_block_jacobi:
                a_M_st = st.spread_blockdiag(Dinv)
            else:
                dinv_st = st.spread(dinv_A)
                a_M_st = lambda r: r * dinv_st       # noqa: E731

            def op_st(x):
                return st.condensed_matvec(W_st, fix_st, x)
            a_M_st = _poly_wrap(a_M_st, op_st)
        elif a_branch == "stencil_flat":
            W_st = st.build_weights(Auu_b)
            op_A = ucons.wrap_operator(lambda x: st.flat_matvec(W_st, x))
            a_M = _poly_wrap(a_M, op_A)
        elif vmg is None:
            a_M = _poly_wrap(a_M, op_A)
        sm_branch = self.sm_solve_branch()
        self.precond_branches[(a_branch, sm_branch)] += 1

        counts = self.krylov_iters
        a_direct = vmg is not None and self.mg_direct and \
            not self.a_mg_precond

        def precond(v):
            out_dtype = v.dtype
            v = v.to(pdt)
            vu, vp = v[:self.n_u], v[self.n_u:]
            atol_p = torch.clamp(
                self.mp_sm_rtol * torch.linalg.vector_norm(vp), min=1e-10)
            mp = cg(op_Mp, vp, M=lambda r: r * mp_dinv, atol=atol_p,
                    maxiter=self.mp_cg_maxiter)
            tmp = mp.x * (-(nu_visc + gamma * rho))
            if sm_branch == "vcycle":
                # one V-cycle IS the approximate Sm^-1 (the outer solver
                # is flexible)
                sm_x, sm_it = sm_M(vp), 0
            else:
                sm = cg(op_Sm, vp, M=sm_M, atol=atol_p,
                        maxiter=self.schur_cg_maxiter)
                sm_x, sm_it = sm.x, sm.iters
            dst_p = sm_x * (-rho / dt) + tmp
            utmp = vu - apply_BT(dst_p)
            if a_direct:
                # a_mg_cycles V-cycles of the velocity operator replace the
                # inner FGMRES A-solve
                au_x = a_M(utmp)
                for _ in range(self.a_mg_cycles - 1):
                    au_x = au_x + a_M(utmp - op_A(au_x))
                au_it = 0
            elif a_branch == "stencil":
                # spread -> weighted solve -> read back the owning copies
                atol_u = self.a_inner_rtol * torch.linalg.vector_norm(utmp)
                au = fgmres(op_st, st.spread(utmp), M=a_M_st, atol=atol_u,
                            restart=self.a_inner_restart,
                            max_restarts=self.a_inner_restarts,
                            weight=w_st)
                au_x, au_it = st.unspread(au.x), au.iters
            else:
                atol_u = self.a_inner_rtol * torch.linalg.vector_norm(utmp)
                au = fgmres(op_A, utmp, M=a_M, atol=atol_u,
                            restart=self.a_inner_restart,
                            max_restarts=self.a_inner_restarts)
                au_x, au_it = au.x, au.iters
            counts["mp"] += mp.iters
            counts["sm"] += sm_it
            counts["a"] += au_it
            counts["applies"] += 1
            return torch.cat([au_x, dst_p]).to(out_dtype)

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
        # a rank's cells only when parallel/shard.py shards the solver
        red = getattr(self, "cell_reduce", None) or _whole

        def apply_A(x):
            y = element_matvec_taylor_hood(
                A_op, self.cell_nodes_u, self.cell_dofs_p, nlu, self.dim,
                self.n_u, self.n_p, x.to(mdt), cell_dofs=self.cell_dofs)
            return red(y).to(x.dtype)

        op = cons.wrap_operator(apply_A)
        precond = self._make_preconditioner(A_loc, ucons, pcons)
        x, iters, residual = self._outer_solve(op, b, precond, atol)
        self.krylov_iters["outer"] += iters
        du = cons.distribute(x)
        return du, res_norm, iters, residual

    # ------------------------------------------------------------------
    def _newton_loop(self, eval_pt, present, indicator, fsi_acc, fsi_stress,
                     fsi_acc_nodal, cons, ucons, pcons):
        """The Newton loop of one time step from `eval_pt`, with the
        stopping rules of the JAX package's fused steps (insim.py
        make_fsi_step, make_on_device_stepper), run eagerly: iterate
        while res / res0 > fluid_tolerance and res > 1e-11, at most
        fluid_max_iterations times, and not stagnated.  Returns (eval_pt,
        rel_res, newton_iters); rel_res is 0 where res0 <= 1e-11 or on
        stagnation."""
        def newton_once(eval_pt, res0):
            du, rn, its, _ = self._newton_iter_impl(
                eval_pt, present, indicator, fsi_acc, fsi_stress,
                fsi_acc_nodal, cons, ucons, pcons, res0=res0)
            return eval_pt + du, rn, its

        return self._run_newton(eval_pt, newton_once, 1e-11)

    def make_on_device_stepper(self):
        """Time stepping without the host path's bookkeeping: the
        production / benchmark path (run_one_step remains the instrumented
        one).  Returns fn(present, n_steps) -> (present, max_rel_res,
        max_newton_iters): the worst final Newton relative residual and
        the largest iteration count over the window, so callers can
        detect a silently non-converged step (the host path raises 'Too
        many Newton iterations!' instead).  Each step starts its Newton
        loop at the present solution with zero-increment constraints; no
        constraint increment, stress update, output or time increment
        happens inside.

        The JAX package compiles the window into one dispatch; here it is
        an eager loop on device tensors, and every Krylov iteration still
        ends in a host synchronisation (la/krylov.py)."""
        cons = self.zero_constraints
        ucons = self.u_constraints
        pcons = self.p_constraints

        def run_n(present, n_steps):
            worst_rel, worst_it = 0.0, 0
            for _ in range(int(n_steps)):
                present, rel, it = self._newton_loop(
                    present, present, self.indicator, self.fsi_acceleration,
                    self.fsi_stress_cell, self.fsi_acc_nodal, cons, ucons,
                    pcons)
                worst_rel, worst_it = max(worst_rel, rel), max(worst_it, it)
            return present, worst_rel, worst_it

        return run_n

    def make_fsi_step(self):
        """One coupled-run time step: the Newton loop with the stopping
        rules of the JAX package's fused step (insim.py make_fsi_step),
        run eagerly.  Returns fn(present, indicator, fsi_acc, fsi_stress,
        fsi_acc_nodal, zero_cons, nonzero_cons, ucons, pcons) ->
        (present, stress_nodal, rel_res, newton_iters)."""
        def step(present, indicator, fsi_acc, fsi_stress, fsi_acc_nodal,
                 zero_cons, nonzero_cons, ucons, pcons):
            eval_pt, rel, it = self._newton_loop(
                nonzero_cons.apply_increment(present), present, indicator,
                fsi_acc, fsi_stress, fsi_acc_nodal, zero_cons, ucons, pcons)
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

    def run_on_device(self, verbose: bool = True):
        """run() with all steps after the first through
        make_on_device_stepper; static-BC configurations only (the
        stepper applies zero-increment constraints)."""
        assert not self.hard_coded_bcs, \
            "run_on_device(InsIM) supports static BCs only"
        if not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[0])
            self.setup()
        self.run_one_step(True, verbose=verbose)
        dt = self.time.get_delta_t()
        n = int(round((self.time.end() - self.time.current()) / dt))
        if n <= 0:
            return
        stepper = self.make_on_device_stepper()
        sol, rel, its = stepper(self.present_solution, n)
        if rel > self.params.fluid_tolerance:
            raise RuntimeError("Too many Newton iterations!")
        self.solution_increment = sol - self.present_solution
        self.present_solution = sol
        self.newton_iters = its
        for _ in range(n):
            self.time.increment()
        self.update_stress()
        if verbose:
            print(f"run_on_device: {n} steps, worst rel_res "
                  f"{rel:.3e}, max newton iters {its}")
