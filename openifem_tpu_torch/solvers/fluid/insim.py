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
from ...la.krylov import BlockGraphs, cg, fgmres
from ...la.operators import (element_diag, element_matvec,
                             element_matvec_nodeblock,
                             element_matvec_p_to_u_nodeblock,
                             element_matvec_taylor_hood,
                             element_matvec_u_to_p_nodeblock, index_sum,
                             scatter_add)
from ...utils.timer import host_read, span
from .base import WHOLE, FluidSolverBase, condensed


def _buffer(bufs, name, like):
    """The tensor `name` of the dict `bufs`, made empty like `like` (dense)
    on first use."""
    buf = bufs.get(name)
    if buf is None:
        buf = bufs[name] = torch.empty_like(like)
    return buf


def _on_card(device) -> bool:
    """Whether the preconditioner's inner solves take iteration blocks
    (InsIM._inner_graphs): on a CUDA device.  Monkeypatched to True, the
    blocks run uncaptured on the CPU."""
    return device.type == "cuda"


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
    # the inner solves' buffers and graphs (_inner_graphs)
    _inner = None

    def setup(self):
        assert (self.params.fluid_velocity_degree -
                self.params.fluid_pressure_degree) == 1, \
            "Velocity degree must be one higher than pressure (Taylor-Hood)"
        with span("setup"):
            # attached V-cycles are built against the OLD mesh's tables;
            # drop them (re-enable with a fresh hierarchy after setup)
            self._pressure_mg = None
            self._velocity_mg = None
            self._inner = None
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
        with span("pressure_mg"):
            fixed = self.p_constraints.fixed.cpu().numpy()
            if galerkin:
                spaces = [FESpace(m, 1) for m in meshes[:-1]] + \
                    [self.p_space]
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

        def ein(spec, *ops):
            """np.einsum of host arrays.  Hexahedra (27 velocity nodes and
            27 points a cell) take torch's batched contraction on the
            solver's device, where numpy's plain loop takes minutes at a
            million dofs; the sums differ in the last bits, so quads keep
            the loop their tables were always built with."""
            if d == 2:
                return np.einsum(spec, *ops)
            return torch.einsum(spec, *[t(o) for o in ops]).cpu().numpy()

        # mass matrices for the preconditioner (no rho; reference
        # source/insim.cpp:255-257)
        Mu_s = ein("qi,qj,cq->cij", cvu.N, cvu.N, cvu.JxW)
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
        NN = Mu_s                                   # the velocity mass
        gg = ein("cqlx,cqmx,cq->clm", cvu.grad, cvu.grad, cvu.JxW)
        Auu_c = ein("clm,ab->clamb", nu_visc * gg + (rho / dt) * NN, I_np)
        Auu_c = Auu_c + (gamma * rho) * ein(
            "cqla,cqmb,cq->clamb", cvu.grad, cvu.grad, cvu.JxW)
        Auu_c = Auu_c.reshape(n_c, self.nu_loc, self.nu_loc)
        Aup = -ein("cqla,qn,cq->clan", cvu.grad, cvp.N,
                   cvu.JxW).reshape(n_c, self.nu_loc, nlp)
        Apu = -ein("qn,cqmb,cq->cnmb", cvp.N, cvu.grad,
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
                  fsi_acc_nodal, out=None):
        """Element Newton matrix + rhs at evaluation point; the matrix is
        written into `out` where one is given.

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

        # the cells' values are gathered only for the products that read
        # them, so that no cell-sized gather outlives its use
        ul = eval_pt[:self.n_u].reshape(-1, d)[nodes]           # (c,nlu,d)
        uc = torch.einsum("ql,cla->cqa", Nu, ul)
        guc = torch.einsum("cqlx,cla->cqax", gu, ul)
        del ul
        pc = torch.einsum("qn,cn->cq", Np,
                          eval_pt[self.n_u:][self._p_cell_nodes])
        un = torch.einsum("ql,cla->cqa", Nu,
                          present[:self.n_u].reshape(-1, d)[nodes])
        divu = torch.diagonal(guc, dim1=2, dim2=3).sum(-1)

        # matrix: constant part precomputed at setup; only the two
        # convection terms are linearization-dependent (built in f32 in
        # f32_matrix mode; the f64 rhs below gates Newton convergence)
        mdt = self._mdt
        Nu_m, gu_m, JxW_m = self._Nu_m, self._gu_m, self._JxW_m
        uc_m = uc.to(mdt)
        guc_m = guc.to(mdt)
        conv2 = rho * torch.einsum("ql,cqm,cq->clm", Nu_m, torch.einsum(
            "cqmx,cqx->cqm", gu_m, uc_m), JxW_m)
        # in place, one cell-sized temporary: the second term, plus the
        # first on its (a, a) diagonals (off them the first term is 0),
        # added into A's velocity block seen as (c, l, a, m, b)
        conv = torch.einsum("ql,qm,cqab,cq->clamb", Nu_m, Nu_m, guc_m,
                            JxW_m).mul_(rho)
        for a in range(d):
            conv[:, :, a, :, a] += conv2
        A_loc = self._A_const.clone() if out is None else \
            out.copy_(self._A_const)
        nlu = self.nu_loc // d
        A_loc[:, :self.nu_loc, :self.nu_loc].unflatten(2, (nlu, d)) \
            .unflatten(1, (nlu, d)).add_(conv)
        # the matrix's temporaries go before the residual's
        del uc_m, guc_m, conv2, conv

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

    def _inner_graphs(self, lay, ucons, pcons):
        """The buffers and BlockGraphs sites ("mp", "sm", "a") of the
        preconditioner's inner solves, as (key, buffers, sites), or None
        where they run the eager loops: off the card, on a rank's view
        (parallel/shard.py), in the dense branch, and under constraint
        sets other than the solver's own (a coupled FSI step makes new
        ones every step).  One set serves every Newton iteration while
        what the inner operators read outside the buffers stays: the
        V-cycles, the stencil, the cell tables (setup() drops the set)
        and the knobs baked into the closures."""
        if lay is not WHOLE or not _on_card(self.device) or \
                self.dense_precond or ucons is not self.u_constraints or \
                pcons is not self.p_constraints:
            return None
        key = (ucons, pcons, self._pressure_mg, self._u_stencil,
               self.a_poly, self.a_poly_omega, self.mixed_precision_precond)
        inner = self._inner
        if inner is None or any(a is not b for a, b in zip(inner[0], key)):
            pool = torch.cuda.graph_pool_handle() \
                if self.device.type == "cuda" else None
            inner = self._inner = (key, {}, {n: BlockGraphs(pool)
                                             for n in ("mp", "sm", "a")})
        return inner

    def _make_preconditioner(self, A_loc, ucons, pcons):
        """Grad-Div block-Schur right preconditioner (reference:
        source/insim.cpp:55-120).

        On a rank's view of the solver (parallel/shard.py) the cell
        tables are the rank's and `rank_layout` says how the vectors are
        held (solvers/fluid/base.py::WholeLayout): every element-block
        apply and diagonal covers the rank's cells and is summed over the
        ranks into the rank's piece; the branches that need every cell's
        block (dense, the V-cycle builds, the stencil) gather the blocks
        (gather_cells) and build their operator whole on every rank.

        On the card with whole vectors (_inner_graphs) the tensors the
        inner solves read are the solver's buffers, written in place each
        Newton iteration, and the inner Mp CG, the Schur CG (Jacobi or
        geometric V-cycle) and the stencil A-solve run their iterations as
        replayed CUDA graphs (la/krylov.py BlockGraphs)."""
        from ...la.multigrid import GalerkinMG
        lay = self.rank_layout
        inner = self._inner_graphs(lay, ucons, pcons)
        bufs, sites = (None, {}) if inner is None else inner[1:]

        def kept(name, t, once=False):
            """t in the buffer `name`: written in place, or only when
            first made with once=True; t itself without buffers."""
            if bufs is None:
                return t
            if once and name in bufs:
                return bufs[name]
            return _buffer(bufs, name, t).copy_(t)
        # every cell's tables (the solver itself, or a rank view's solver)
        whole = lay.whole or self
        params = self.params
        d = self.dim
        gamma, rho = params.grad_div, params.fluid_rho
        nu_visc = params.viscosity
        dt = self.time.get_delta_t()

        pdt = torch.float32 if self.mixed_precision_precond else A_loc.dtype
        A_loc = A_loc.to(pdt)
        Mp_loc = kept("Mp_loc", self.Mp_loc.to(pdt), once=True)
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
        n_ur = lay.part(self.n_u)
        cn_u, cd_u, cd_p = self.cell_nodes_u, self.cell_dofs_u, \
            self.cell_dofs_p
        fixed_u = lay.piece(ucons.fixed)
        fixed_p = lay.piece(pcons.fixed)

        # strided views of A_loc: the CUDA kernel reads them in place
        Auu_b = Auu.reshape(n_c, nlu, d, nlu, d)
        Apu_b = Apu.reshape(n_c, nlp, nlu, d)
        Aup_b = Aup.reshape(n_c, nlu, d, nlp)
        sm_branch = self.sm_solve_branch()
        mg = self._pressure_mg
        # the inner solves whose operators read only the buffers and
        # tensors that outlive this build: the Schur CG reads B and B^T,
        # views of the assembly's buffer (_newton_iter_impl) or, where
        # A_loc is a copy in another dtype, buffers of their own
        mp_graphs = sites.get("mp")
        sm_graphs = sites.get("sm") if sm_branch != "vcycle" and \
            not isinstance(mg, GalerkinMG) else None
        if sm_graphs is not None and A_loc is not bufs.get("A_loc"):
            Apu_b, Aup_b = kept("Apu_b", Apu_b), kept("Aup_b", Aup_b)

        op_A = condensed(lay, ucons, lambda x: element_matvec_nodeblock(
            Auu_b, cn_u, n_un, x))
        if self.a_block_jacobi:
            # nodal d x d block-Jacobi: the grad-div term couples velocity
            # components, which pointwise Jacobi ignores
            from ...la.smalltensor import inv as small_inv
            diag_blocks = torch.diagonal(Auu_b, dim1=1, dim2=3).permute(
                0, 3, 1, 2)                              # (n_c, nlu, d, d)
            D = lay.scatter(index_sum(n_un, cn_u, diag_blocks))
            fixed = fixed_u.reshape(-1, d)
            fi = fixed[:, :, None] | fixed[:, None, :]
            D = torch.where(fi, torch.eye(d, dtype=pdt, device=self.device),
                            D)
            Dinv = small_inv(D)

            def apply_dinv_A(r):
                return torch.einsum("nab,nb->na", Dinv,
                                    r.reshape(-1, d)).reshape(-1)
        else:
            diag_A = torch.where(fixed_u, 1.0, lay.scatter(
                element_diag(Auu, cd_u, self.n_u)))
            dinv_A = torch.where(diag_A != 0, 1.0 / diag_A, 1.0)

            def apply_dinv_A(r):
                return r * dinv_A

        def apply_B(xu):   # u -> p   (condensed)
            y = element_matvec_u_to_p_nodeblock(
                Apu_b, cn_u, cd_p, self.n_p, ucons.expand(lay.gather(xu)))
            return lay.scatter(pcons.restrict(y) if pcons.any_hanging
                               else y)

        def apply_BT(xp):  # p -> u   (condensed)
            xp = lay.gather(xp)
            xp = pcons.expand(xp) if pcons.any_hanging else xp
            y = element_matvec_p_to_u_nodeblock(Aup_b, cn_u, cd_p, n_un, xp)
            return lay.scatter(ucons.restrict(y))

        # mu_inv of every dof (the cell-local products read it through
        # cd_u) and of the rank's piece
        mu_inv = torch.where(Mu_diag != 0, 1.0 / Mu_diag, 1.0)
        mu_inv_r = kept("mu_inv_r", lay.piece(mu_inv), once=True)

        def op_Sm(xp):
            y = apply_B(mu_inv_r * apply_BT(xp))
            return torch.where(fixed_p, xp, y)

        # Jacobi preconditioner for the mass-Schur CG from the cell-local
        # diagonal of B diag(Mu)^-1 B^T
        sm_diag_loc = torch.einsum("cnk,ck,cnk->cn", Apu, mu_inv[cd_u], Apu)
        sm_diag = lay.scatter(scatter_add(self.n_p, cd_p, sm_diag_loc))
        sm_dinv = kept("sm_dinv", torch.where(
            sm_diag > 0, 1.0 / torch.where(sm_diag > 0, sm_diag, 1.0), 1.0))

        op_Mp = condensed(lay, pcons, lambda x: element_matvec(
            Mp_loc, cd_p, self.n_p, x))
        mp_dinv = kept("mp_dinv", lay.piece(
            torch.where(Mp_diag != 0, 1.0 / Mp_diag, 1.0)), once=True)

        if self.dense_precond:
            # dense condensed inner operators (la/dense.py): exactly the
            # condensed matvecs (R A E + fixed identity), so iteration
            # counts are unchanged; the explicit Sm = B diag(Mu)^-1 B^T
            # mirrors the reference's mass_schur assembly
            # (source/mpi_insim.cpp:36-50).  Built from every cell's
            # blocks, whole on every rank.
            from ...la.dense import (add_unit_diag, condensed_dense, gemv,
                                     hanging_tables)
            A_all = lay.gather_cells(A_loc)
            Mp_all = lay.gather_cells(Mp_loc)
            wcd_u, wcd_p = whole.cell_dofs_u, whole.cell_dofs_p
            uht = hanging_tables(self.u_constraints)
            pht = hanging_tables(self.p_constraints)
            Ad = condensed_dense(A_all[:, :nu, :nu], wcd_u, wcd_u, self.n_u,
                                 self.n_u, ucons, ucons, uht, uht,
                                 unit_fixed_diag=True)
            Bd = condensed_dense(A_all[:, nu:, :nu], wcd_p, wcd_u, self.n_p,
                                 self.n_u, pcons, ucons, pht, uht)
            Btd = condensed_dense(A_all[:, :nu, nu:], wcd_u, wcd_p, self.n_u,
                                  self.n_p, ucons, pcons, uht, pht)
            Sd = add_unit_diag(Bd @ (mu_inv[:, None] * Btd), pcons.fixed)
            del Bd
            Mpd = condensed_dense(Mp_all, wcd_p, wcd_p, self.n_p, self.n_p,
                                  pcons, pcons, pht, pht,
                                  unit_fixed_diag=True)
            dA = torch.diagonal(Ad)
            dinv_A = torch.where(dA != 0, 1.0 / dA, 1.0)
            # the bf16 A block replaces the f32/f64 one (not kept beside it)
            A_mv = Ad.to(torch.bfloat16) if self.dense_a_bf16 else Ad
            del Ad, dA, A_all
            op_A = lambda x: gemv(A_mv, x)           # noqa: E731
            apply_BT = lambda xp: gemv(Btd, xp)      # noqa: E731
            op_Sm = lambda xp: gemv(Sd, xp)          # noqa: E731
            op_Mp = lambda x: gemv(Mpd, x)           # noqa: E731
            apply_dinv_A = lambda r: r * dinv_A      # noqa: E731
            dS = torch.diagonal(Sd)
            sm_dinv = torch.where(
                dS > 0, 1.0 / torch.where(dS > 0, dS, 1.0), 1.0)

        if isinstance(mg, GalerkinMG):
            # cell-local mass-Schur blocks of THIS Newton matrix
            sm_loc = torch.einsum("cik,ck,cjk->cij", Apu, mu_inv[cd_u], Apu)
            fixp = pcons.fixed[cd_p]
            sm_loc = torch.where(fixp[:, None, :] | fixp[:, :, None], 0.0,
                                 sm_loc)
            sm_M = mg.build(lay.gather_cells(sm_loc))
        elif mg is not None:
            sm_M = mg.vcycle
        else:
            sm_M = lambda r: r * sm_dinv             # noqa: E731
        vmg = self._velocity_mg
        if isinstance(vmg, GalerkinMG):
            # TRUE velocity block (convection included), fixed rows/cols
            # projected out
            fixu = ucons.fixed[cd_u]
            a_M = vmg.build(lay.gather_cells(torch.where(
                fixu[:, None, :] | fixu[:, :, None], 0.0, Auu)))
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
        # stencil replaces the element matvec inside the constraint wrap;
        # its weights come from every cell's block
        a_branch = self.a_solve_branch(ucons)
        st = self._u_stencil
        if a_branch in ("stencil", "stencil_flat"):
            W_st = st.build_weights(
                lay.gather_cells(Auu_b),
                out=None if bufs is None else bufs.get("W_st"))
            if bufs is not None:
                bufs["W_st"] = W_st
        if a_branch == "stencil":
            fix_st = kept("fix_st", st.spread_mask(ucons.fixed), once=True)
            w_st = kept("w_st", st.weight(pdt), once=True)
            if self.a_block_jacobi:
                a_M_st = st.spread_blockdiag(Dinv)
            else:
                dinv_st = kept("dinv_st", st.spread(dinv_A))
                a_M_st = lambda r: r * dinv_st       # noqa: E731

            def op_st(x):
                return st.condensed_matvec(W_st, fix_st, x)
            a_M_st = _poly_wrap(a_M_st, op_st)
        elif a_branch == "stencil_flat":
            op_A = ucons.wrap_operator(lambda x: st.flat_matvec(W_st, x))
            a_M = _poly_wrap(a_M, op_A)
        elif vmg is None:
            a_M = _poly_wrap(a_M, op_A)
        self.precond_branches[(a_branch, sm_branch)] += 1

        counts = self.krylov_iters
        a_direct = vmg is not None and self.mg_direct and \
            not self.a_mg_precond
        reduce = lay.reduce

        def precond(v):
            out_dtype = v.dtype
            v = v.to(pdt)
            vu, vp = v[:n_ur], v[n_ur:]
            atol_p = torch.clamp(self.mp_sm_rtol * lay.norm(vp), min=1e-10)
            with span("inner_mp"):
                mp = cg(op_Mp, vp, M=lambda r: r * mp_dinv, atol=atol_p,
                        maxiter=self.mp_cg_maxiter, reduce=reduce,
                        graphs=mp_graphs)
            tmp = mp.x * (-(nu_visc + gamma * rho))
            with span("inner_sm"):
                if sm_branch == "vcycle":
                    # one V-cycle IS the approximate Sm^-1 (the outer
                    # solver is flexible)
                    sm_x, sm_it = sm_M(vp), 0
                else:
                    sm = cg(op_Sm, vp, M=sm_M, atol=atol_p,
                            maxiter=self.schur_cg_maxiter, reduce=reduce,
                            graphs=sm_graphs)
                    sm_x, sm_it = sm.x, sm.iters
            dst_p = sm_x * (-rho / dt) + tmp
            utmp = vu - apply_BT(dst_p)
            with span("inner_a"):
                if a_direct:
                    # a_mg_cycles V-cycles of the velocity operator
                    # replace the inner FGMRES A-solve
                    au_x = a_M(utmp)
                    for _ in range(self.a_mg_cycles - 1):
                        au_x = au_x + a_M(utmp - op_A(au_x))
                    au_it = 0
                elif a_branch == "stencil":
                    # spread -> weighted solve -> read back the owning
                    # copies
                    atol_u = self.a_inner_rtol * \
                        torch.linalg.vector_norm(utmp)
                    au = fgmres(op_st, st.spread(utmp), M=a_M_st,
                                atol=atol_u, restart=self.a_inner_restart,
                                max_restarts=self.a_inner_restarts,
                                weight=w_st,
                                graphs=None if self.a_block_jacobi
                                else sites.get("a"))
                    au_x, au_it = st.unspread(au.x), au.iters
                else:
                    atol_u = self.a_inner_rtol * lay.norm(utmp)
                    au = fgmres(op_A, utmp, M=a_M, atol=atol_u,
                                restart=self.a_inner_restart,
                                max_restarts=self.a_inner_restarts,
                                reduce=reduce)
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
        # a rank's cells only when parallel/shard.py shards the solver
        lay = self.rank_layout
        inner = self._inner_graphs(lay, ucons, pcons)
        with span("newton"):
            with span("assemble"):
                # with the inner graphs the blocks go to a buffer, whose
                # B and B^T views the Schur CG's graphs read (a rank
                # view's _assemble takes no `out`)
                out = {} if inner is None else \
                    dict(out=_buffer(inner[1], "A_loc", self._A_const))
                A_loc, rhs = self._assemble(eval_pt, present, indicator,
                                            fsi_acc, fsi_stress,
                                            fsi_acc_nodal, **out)
                b = cons.condense_rhs(rhs)
                res_norm = torch.linalg.vector_norm(b)
                with host_read("newton_res"):
                    res_norm = res_norm.item()
            atol = self._outer_atol(res_norm, res0,
                                    max(1e-8 * res_norm, 1e-10))

            nlu = self.nu_loc // self.dim
            mdt = torch.float32 if self.f32_matrix else A_loc.dtype
            A_op = A_loc.to(mdt)

            def apply_A(x):
                y = element_matvec_taylor_hood(
                    A_op, self.cell_nodes_u, self.cell_dofs_p, nlu,
                    self.dim, self.n_u, self.n_p, x.to(mdt),
                    cell_dofs=self.cell_dofs)
                return lay.scatter(y).to(x.dtype)

            op = cons.wrap_operator(apply_A)
            with span("precond_build"):
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
        an eager loop on device tensors.  On the card the preconditioner's
        inner solves replay CUDA graphs of iteration blocks, one host read
        per block (_inner_graphs); the outer FGMRES still ends every
        iteration in one (la/krylov.py)."""
        cons = self.zero_constraints
        ucons = self.u_constraints
        pcons = self.p_constraints

        def run_n(present, n_steps):
            worst_rel, worst_it = 0.0, 0
            for _ in range(int(n_steps)):
                with span("step"):
                    present, rel, it = self._newton_loop(
                        present, present, self.indicator,
                        self.fsi_acceleration, self.fsi_stress_cell,
                        self.fsi_acc_nodal, cons, ucons, pcons)
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
        """reference: source/insim.cpp:370-459.  Traced as the span
        "first_step": the host path, which a stepper run takes for its
        first step only."""
        with span("first_step"):
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
