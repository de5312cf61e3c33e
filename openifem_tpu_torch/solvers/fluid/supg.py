"""SUPG/PSPG/LSIC-stabilized fluid solvers: SUPGInsIM, SCnsIM, SerialSCnsIM.

Counterpart of openifem_tpu/solvers/fluid/supg.py (reference:
include/mpi_supg_solver.h, source/mpi_supg_solver.cpp: the Newton loop and
the Washio incomplete-Schur preconditioner, citing Washio et al. CMAME 194
(2005) 4027; source/mpi_insim_supg.cpp, source/mpi_scnsim.cpp,
source/scnsim.cpp for the three assemblies).

Equal-order-friendly stabilization with Tezduyar UGN parameters:
  h = 2|u| / sum_a |u . grad N_a|   (over the reference's first
      dofs_per_cell / dofs_per_vertex system shape functions)
  tau_SUPG = ((2/dt)^2 + (2|u|/h)^2 + (4 nu/h^2)^2)^(-1/2)
  tau_PSPG = tau_SUPG / rho,  tau_LSIC = (h/2)|u| z(Re_local)

Preconditioner (BlockIncompSchurPreconditioner): Pvv = Jacobi of Avv;
Tpp = App - Apv Pvv^-1 Avp applied matrix-free; Tpp^-1 by inner GMRES(200)
to 1e-3 preconditioned with (the diagonal of, or a V-cycle on) B2pp =
App - Apv rowsum(|Avv|)^-1 Avp.

The JAX package compiles one Newton iteration, and its steppers whole
windows; here they are eager loops on device tensors.  The element-block
applies go through la/operators.py, which on a CUDA tensor runs the
hand-written kernel of csrc/element_matvec.cu; the assembly einsums, the
stencil applies, the dense Tpp and GMRES's projections are plain PyTorch,
as they are XLA ops in the JAX package.

The many-operand einsums of the JAX assemblies are written here as chains
of small products: torch.einsum contracts left to right, so each product
first folds the per-quadrature-point weights and vectors and only then
meets a shape-function table.  Terms of the form
(w, Nu, gu, vec, I) -> "clamb" with a common structure are summed as one
quadrature-point vector before the shape functions are applied.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...la.krylov import fgmres
from ...la.operators import (element_diag, element_matvec,
                             element_matvec_p_to_u_nodeblock,
                             element_matvec_rect,
                             element_matvec_taylor_hood,
                             element_matvec_u_to_p_nodeblock, scatter_add)
from .base import FluidSolverBase, _whole

CP_TO_CV = 1.4          # reference: source/mpi_scnsim.cpp:124
ATM = 1013250.0         # reference: source/mpi_scnsim.cpp:125
KAPPA_S = 1e4           # reference: source/mpi_scnsim.cpp:126

es = torch.einsum


def _trace(G):
    return torch.diagonal(G, dim1=2, dim2=3).sum(-1)


class SUPGFluidSolver(FluidSolverBase):
    """Shared Newton loop + incomplete-Schur solve for the SUPG family."""

    tpp_restart = 200
    tpp_max_restarts = 2
    outer_restart = 30
    outer_max_restarts = 40
    # outer FGMRES relative tolerance (MPI family: 1e-6,
    # source/mpi_supg_solver.cpp:311-327; serial SCnsIM overrides 1e-8)
    outer_rtol = 1e-6
    # f32 preconditioner inside the f64 flexible outer solve (see InsIM)
    mixed_precision_precond = False
    # f32 Jacobian apply in the outer FGMRES (inexact Newton); the f64
    # assembled residual still gates Newton convergence (see InsIM)
    f32_matrix = False
    # dense condensed p-coupled blocks + explicit dense Tpp in the
    # preconditioner (la/dense.py; see _make_preconditioner).  The same
    # operators as the element matvec path; needs n_p * n_u entries of
    # device memory (rectangular blocks only: no dense Avv).
    dense_precond = False
    # coupled-node stencil (la/stencil.py): the Q1/Q1 equal-order family
    # admits ONE (dim+1)-component (2k+1)^dim-point stencil for the coupled
    # system matrix on brick-structured meshes (uniform or locally
    # refined).  The outer Jacobian apply and the Tpp pieces (Avp/Apv/App
    # as component slices of the same tensor) become shifted contiguous
    # multiply-adds instead of element gather/scatters.  The same operator
    # (reassociated sums only).  Off on non-brick meshes or unequal
    # degrees.
    coupled_stencil = True
    # hybrid: keep the stencil for the OUTER Jacobian apply but let
    # dense_precond own the Tpp pieces
    stencil_outer_only = False

    def setup(self):
        # a previously attached V-cycle is built against the OLD mesh's
        # shape tables; drop it (re-enable with a fresh hierarchy after)
        self._pressure_mg = None
        super().setup()
        self._precompute()

    def _refine_setup_with_mg(self):
        """Apply the parameters' global refinement, keeping the
        intermediate meshes as the V-cycle hierarchy for the Tpp
        preconditioner (see enable_pressure_mg).  Shared by run() and
        run_on_device()."""
        gr = self.params.global_refinements[0]
        meshes = [self.mesh]
        for _ in range(gr):
            meshes.append(meshes[-1].refine_global(1))
        self.mesh = meshes[-1]
        if self.hard_coded_bcs:
            self.bc_time += self.time.get_delta_t()
        self.setup()
        if gr >= 1 and self.params.fluid_pressure_degree == 1:
            self.enable_pressure_mg(meshes)

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
        self.gp = t(cvp.grad)
        self.JxW = t(cvu.JxW)

        cd = self.sys.cell_dofs
        # the node-block layouts and the one-launch coupled apply rely on
        # the velocity dofs being node-major, component-minor
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

        g = np.zeros(d)
        g[:len(params.gravity)] = params.gravity[:d]
        if self.body_force is not None:
            xq = cvu.xq.reshape(-1, d)
            bf = np.asarray(self.body_force(xq)).reshape(n_c, n_q, d)
            self.gravity_q = t(bf + g)
        else:
            self.gravity_q = t(np.broadcast_to(g, (n_c, n_q, d)).copy())

        # PML attenuation field at q points (set_sigma_pml_field,
        # reference: source/mpi_fluid_solver.cpp:93-103)
        if getattr(self, "sigma_pml_field", None) is not None:
            xq = cvu.xq.reshape(-1, d)
            s = np.asarray(self.sigma_pml_field(xq)).reshape(n_c, n_q)
            self.sigma_pml_q = t(s)
        else:
            self.sigma_pml_q = torch.zeros((n_c, n_q), dtype=real_dtype(),
                                           device=self.device)

        self._neumann_rhs_const = self._neumann_rhs()

        # vertex shape-gradient selection for the reference's h heuristic:
        # the sum runs over the first dofs_per_cell/dofs_per_vertex SYSTEM
        # shape functions in deal.II local order (vertex-major, per vertex
        # [u_x .. u_z, p]) (reference: source/mpi_insim_supg.cpp:130-141)
        def vertex_local_index(degree, v):
            k, n1 = degree, degree + 1
            bits = [(v >> b) & 1 for b in range(d)]
            return sum(bits[b] * k * n1 ** b for b in range(d))

        dofs_per_cell = nlu * d + nlp
        dofs_per_vertex = d + 1
        K = dofs_per_cell // dofs_per_vertex
        seq = []
        for v in range(2 ** d):
            lu = vertex_local_index(params.fluid_velocity_degree, v)
            lp = vertex_local_index(params.fluid_pressure_degree, v)
            seq.extend([(lu, "u")] * d)
            seq.append((lp, "p"))
        # Counter keeps insertion order: the sum of _stab_parameters runs
        # in the JAX package's order
        cnt = Counter(seq[:K])
        self._h_terms = [(l, float(w), kind) for (l, kind), w in cnt.items()]

        # coupled-node stencil for the Q1/Q1 system (class comment at
        # coupled_stencil): one StencilOperator on the shared node grid
        # serves the outer matvec AND the Tpp sub-blocks via component
        # slices
        self._sys_stencil = None
        if (self.coupled_stencil
                and params.fluid_velocity_degree ==
                params.fluid_pressure_degree
                and self.u_space.n_nodes == self.p_space.n_nodes):
            from ...la.stencil import PatchGrid, StencilOperator
            pgrid = PatchGrid.build(self.mesh)
            if pgrid is not None:
                self._sys_stencil = StencilOperator(
                    pgrid, self.p_space, d=d + 1, device=self.device)

        # the compiled iteration of the JAX package is the plain method here
        self._newton_iter = self._newton_iter_impl
        # Krylov iterations: outer FGMRES, Tpp GMRES, preconditioner applies
        self.krylov_iters = {"outer": 0, "tpp": 0, "applies": 0}
        # preconditioner builds per (outer apply, Tpp pieces, Tpp
        # preconditioner) branch
        self.precond_branches = Counter()

    # -- coupled-stencil layout maps -------------------------------------
    def _sys_to_nodal(self, x):
        """System flat [u (n_nodes*d), p (n_nodes)] -> node-major
        (n_nodes*(d+1)) with per-node components [u_0..u_{d-1}, p]."""
        d = self.dim
        u = x[:self.n_u].reshape(-1, d)
        p = x[self.n_u:]
        return torch.cat([u, p[:, None]], dim=1).reshape(-1)

    def _nodal_to_sys(self, y):
        d = self.dim
        Y = y.reshape(-1, d + 1)
        return torch.cat([Y[:, :d].reshape(-1), Y[:, d]])

    def _sys_node_blocks(self, A_loc):
        """Cell system blocks (n_c, nl*d+nl, nl*d+nl) -> coupled node
        blocks (n_c, nl, d+1, nl, d+1) for the equal-order stencil."""
        d = self.dim
        n_c = A_loc.shape[0]
        nl = self.nlu
        nu = self.nu_loc
        Auu = A_loc[:, :nu, :nu].reshape(n_c, nl, d, nl, d)
        Aup = A_loc[:, :nu, nu:].reshape(n_c, nl, d, nl)
        Apu = A_loc[:, nu:, :nu].reshape(n_c, nl, nl, d)
        App = A_loc[:, nu:, nu:]
        top = torch.cat([Auu, Aup[..., None]], dim=4)
        bot = torch.cat([Apu[:, :, None], App[:, :, None, :, None]], dim=4)
        return torch.cat([top, bot], dim=2)

    def set_sigma_pml_field(self, fn):
        """reference: source/mpi_fluid_solver.cpp:93-103 (must be called
        before setup)."""
        self.sigma_pml_field = fn

    def enable_pressure_mg(self, meshes, n_smooth: int = 2,
                           fixed_prefix: bool = True, galerkin: bool = True):
        """Attach a geometric V-cycle as the preconditioner of the Tpp
        inner GMRES, replacing the cell-local B2pp diagonal surrogate.

        Tpp = App - Apv Pvv^-1 Avp is spectrally a pressure Laplacian
        (PSPG tau_p grad q . grad p plus the mass-scaled Schur product),
        which a diagonal cannot precondition mesh-independently.  The
        reference gets the same effect from ILU(0) of the assembled B2pp
        (source/mpi_supg_solver.cpp:56-133).  Preconditioner-only: the
        outer solve is flexible, so the converged solution is unchanged.

        `meshes`: nested hierarchy, coarsest first, finest == self.mesh.

        galerkin=True (default) coarsens the TRUE per-Newton B2pp element
        blocks (GalerkinMG); galerkin=False attaches the frozen Laplacian
        cycle."""
        from ...fe.space import FESpace
        from ...la.multigrid import GalerkinMG, make_pressure_mg
        assert meshes[-1].n_cells == self.mesh.n_cells, \
            "finest hierarchy level must be the solver mesh"
        assert self.params.fluid_pressure_degree == 1, \
            "pressure V-cycle assumes a Q1 pressure space"
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
            rl = -np.einsum("qi,qa,q->ia", fv.N[i], fv.normals[i],
                            fv.JxW[i]) * pbc
            c = int(fv.cells[i])
            np.add.at(rhs, self.sys.cell_dofs[c][:self.nu_loc],
                      rl.reshape(-1))
        return self._tensor(rhs)

    # ------------------------------------------------------------------
    def _stab_parameters(self, un, viscosity_q, rho_q):
        """tau_SUPG/PSPG/LSIC at q points from the present velocity.  Both
        the guard inside each division and the outer select are kept, so a
        zero velocity gives dt / 2 and no NaN."""
        dt = self.time.get_delta_t()
        h_sum = 0.0
        for (l, w, kind) in self._h_terms:
            gq = self.gu[:, :, l, :] if kind == "u" else self.gp[:, :, l, :]
            h_sum = h_sum + w * torch.abs(es("cqx,cqx->cq", un, gq))
        v_norm = torch.linalg.vector_norm(un, dim=-1)
        h = torch.where(h_sum > 0,
                        2 * v_norm / torch.where(h_sum > 0, h_sum, 1.0), 0.0)
        nu = viscosity_q / rho_q
        safe_h = torch.where(h > 0, h, 1.0)
        tau = 1.0 / torch.sqrt((2 / dt) ** 2 + (2 * v_norm / safe_h) ** 2 +
                               (4 * nu / safe_h ** 2) ** 2)
        tau_supg = torch.where(h > 0, tau, dt / 2)
        tau_pspg = tau_supg / rho_q
        local_re = v_norm * h / (2 * nu)
        z = torch.where(local_re <= 3, local_re / 3, 1.0)
        tau_lsic = h / 2 * v_norm * z
        return tau_supg, tau_pspg, tau_lsic

    # ------------------------------------------------------------------
    def outer_branch(self):
        """The outer Jacobian apply: "stencil" (the coupled stencil) or
        "element" (element_matvec_taylor_hood)."""
        return "stencil" if self._sys_stencil is not None else "element"

    def tpp_branch(self):
        """Which operators carry the Tpp pieces (the same decision as the
        JAX package's _make_preconditioner): "stencil" (component slices
        of the coupled stencil), "dense" (condensed dense blocks and an
        explicit dense Tpp), "nodeblock" (the node-block element layouts)
        or "rect" (the flat rectangular layout, for a solver without a
        velocity node table)."""
        st = self._sys_stencil
        if st is not None and self.dense_precond and self.stencil_outer_only:
            st = None
        if st is not None:
            return "stencil"
        if self.dense_precond:
            return "dense"
        if getattr(self, "cell_nodes_u", None) is not None:
            return "nodeblock"
        return "rect"

    def tpp_M_branch(self):
        """The preconditioner of the Tpp GMRES: "galerkin" (GalerkinMG of
        the B2pp blocks), "vcycle" (a frozen cycle) or "diag"."""
        from ...la.multigrid import GalerkinMG
        mg = getattr(self, "_pressure_mg", None)
        if isinstance(mg, GalerkinMG):
            return "galerkin"
        return "diag" if mg is None else "vcycle"

    def _make_preconditioner(self, A_loc, ucons, pcons, sys_W=None):
        """Washio incomplete-Schur ("Tpp") preconditioner
        (reference: source/mpi_supg_solver.cpp:7-198).

        sys_W: optional prebuilt coupled stencil tensors (coupled_stencil
        path): Avp/Apv/App become component slices of it; built here from
        A_loc when the solver has a stencil but no tensor was passed.

        The returned precond(v) has the attributes `stats` (v -> (result,
        Tpp GMRES iterations)) and `pieces`, a dict of the closures and
        tensors it is made of (apply_Avp, apply_Apv, op_App, Tpp, tpp_M,
        pvv_inv, b2pp_diag, x0), for tests and probes.

        On a rank's view of the solver (parallel/shard.py) the cell
        tables are the rank's and `cell_reduce` is the sum over the ranks:
        every element-block apply and diagonal then covers the rank's
        cells and is reduced.  A solver has no cell_reduce."""
        red = getattr(self, "cell_reduce", None) or _whole
        pdt = torch.float32 if self.mixed_precision_precond else A_loc.dtype
        A_loc = A_loc.to(pdt)
        nu = self.nu_loc
        Avv = A_loc[:, :nu, :nu]
        Avp = A_loc[:, :nu, nu:]
        Apv = A_loc[:, nu:, :nu]
        App = A_loc[:, nu:, nu:]
        cd_u, cd_p = self.cell_dofs_u, self.cell_dofs_p

        diag_Avv = torch.where(ucons.fixed, 1.0,
                               red(element_diag(Avv, cd_u, self.n_u)))
        pvv_inv = torch.where(diag_Avv != 0, 1.0 / diag_Avv, 1.0)

        def Pvv_inverse(x):
            return x * pvv_inv

        branch = self.tpp_branch()
        st = self._sys_stencil if branch == "stencil" else None
        if branch == "stencil":
            if sys_W is None:
                sys_W = st.build_weights(self._sys_node_blocks(A_loc))
            sys_W = tuple(w.to(pdt) for w in sys_W)
            d = self.dim
            # contiguous copies: the apply reshapes its weights, which
            # would copy a strided slice on every call

            def comp(rows, cols):
                return tuple(w.contiguous() for w in
                             st.slice_weights(sys_W, rows, cols))
            W_avp = comp(slice(0, d), slice(d, d + 1))
            W_apv = comp(slice(d, d + 1), slice(0, d))
            W_app = comp(slice(d, d + 1), slice(d, d + 1))

            def apply_Avp(xp):
                xp = pcons.expand(xp) if pcons.any_hanging else xp
                y = st.unspread(st.matvec(W_avp, st.spread(xp)))
                return ucons.restrict(y)

            def apply_Apv(xu):
                xu = ucons.expand(xu)
                y = st.unspread(st.matvec(W_apv, st.spread(xu)))
                return pcons.restrict(y) if pcons.any_hanging else y

            def raw_App(xp):
                return st.unspread(st.matvec(W_app, st.spread(xp)))

            op_App = pcons.wrap_operator(raw_App)
        elif branch == "rect":
            def apply_Avp(xp):
                xp = pcons.expand(xp) if pcons.any_hanging else xp
                y = red(element_matvec_rect(Avp, cd_u, cd_p, self.n_u, xp))
                return ucons.restrict(y)

            def apply_Apv(xu):
                xu = ucons.expand(xu)
                y = red(element_matvec_rect(Apv, cd_p, cd_u, self.n_p, xu))
                return pcons.restrict(y) if pcons.any_hanging else y
        else:
            # node-block layout (also behind the dense branch, whose
            # closures replace these below)
            d = self.dim
            n_c = Avv.shape[0]
            nlu = nu // d
            nlp = Apv.shape[1]
            cn_u = getattr(self, "cell_nodes_u", None)
            # strided views of A_loc: the CUDA kernel reads them in place
            Avp_b = Avp.reshape(n_c, nlu, d, nlp)
            Apv_b = Apv.reshape(n_c, nlp, nlu, d)

            def apply_Avp(xp):
                xp = pcons.expand(xp) if pcons.any_hanging else xp
                y = red(element_matvec_p_to_u_nodeblock(
                    Avp_b, cn_u, cd_p, self.n_u // d, xp))
                return ucons.restrict(y)

            def apply_Apv(xu):
                xu = ucons.expand(xu)
                y = red(element_matvec_u_to_p_nodeblock(
                    Apv_b, cn_u, cd_p, self.n_p, xu))
                return pcons.restrict(y) if pcons.any_hanging else y

        if st is None:
            op_App = pcons.wrap_operator(
                lambda x: red(element_matvec(App, cd_p, self.n_p, x)))

        def Tpp(xp):
            y = op_App(xp) - apply_Apv(Pvv_inverse(apply_Avp(xp)))
            return torch.where(pcons.fixed, xp, y)

        # Jacobi approximation of B2pp = App - Apv rowsum(|Avv|)^-1 Avp:
        # cell-local contribution to the product's diagonal (the reference
        # builds the full matrix and takes ILU(0))
        rowsum_loc = torch.abs(Avv).sum(dim=2)
        rowsum = red(scatter_add(self.n_u, cd_u, rowsum_loc))
        rinv = torch.where(rowsum != 0, 1.0 / rowsum, 1.0)
        rinv_loc = rinv[cd_u]
        prod_diag_loc = es("cnk,ck,ckn->cn", Apv, rinv_loc, Avp)
        diag_App = element_diag(App, cd_p, self.n_p)
        b2pp_diag = red(diag_App - scatter_add(self.n_p, cd_p,
                                               prod_diag_loc))
        b2pp_diag = torch.where(pcons.fixed, 1.0, b2pp_diag)
        b2pp_inv = torch.where(torch.abs(b2pp_diag) > 1e-300,
                               1.0 / b2pp_diag, 1.0)
        if branch == "dense":
            # Dense condensed rectangular blocks + EXPLICIT dense Tpp
            # (la/dense.py): the SUPG preconditioner never iterates on the
            # (large) Avv block, so dense mode only needs the p-coupled
            # blocks, n_p x n_u.  The explicit Tpp = App - Apv Pvv^-1 Avp
            # mirrors the reference's explicit B2pp assembly
            # (source/mpi_supg_solver.cpp:56-133); each Tpp matvec becomes
            # one small GEMV instead of three element gather/scatters.
            from ...la.dense import condensed_dense, gemv, hanging_tables
            uht = hanging_tables(self.u_constraints)
            pht = hanging_tables(self.p_constraints)
            Avp_d = condensed_dense(Avp, cd_u, cd_p, self.n_u, self.n_p,
                                    ucons, pcons, uht, pht)
            Apv_d = condensed_dense(Apv, cd_p, cd_u, self.n_p, self.n_u,
                                    pcons, ucons, pht, uht)
            App_d = condensed_dense(App, cd_p, cd_p, self.n_p, self.n_p,
                                    pcons, pcons, pht, pht,
                                    unit_fixed_diag=True)
            apply_Avp = lambda xp: gemv(Avp_d, xp)      # noqa: E731
            apply_Apv = lambda xu: gemv(Apv_d, xu)      # noqa: E731
            op_App = lambda x: gemv(App_d, x)           # noqa: E731
            Tpp_d = App_d - Apv_d @ (pvv_inv[:, None] * Avp_d)
            Tpp = lambda xp: gemv(Tpp_d, xp)            # noqa: E731

        # B2pp preconditioner when a hierarchy is attached
        # (enable_pressure_mg); diagonal surrogate otherwise.  GalerkinMG
        # coarsens the TRUE cell-local B2pp blocks of THIS Newton matrix
        # (the reference rebuilds and ILU(0)-factors B2pp the same way
        # every step, source/mpi_supg_solver.cpp:56-133)
        m_branch = self.tpp_M_branch()
        mg = getattr(self, "_pressure_mg", None)
        if m_branch == "galerkin":
            b2pp_loc = App - es("cik,ck,ckj->cij", Apv, rinv_loc, Avp)
            fixp = pcons.fixed[cd_p]
            b2pp_loc = torch.where(fixp[:, None, :] | fixp[:, :, None],
                                   0.0, b2pp_loc)
            tpp_M = mg.build(b2pp_loc)
        elif m_branch == "vcycle":
            tpp_M = mg.vcycle
        else:
            tpp_M = lambda r: r * b2pp_inv              # noqa: E731
        self.precond_branches[(self.outer_branch(), branch, m_branch)] += 1

        def initial_guess(ptmp):
            # reference: source/mpi_supg_solver.cpp:163-171
            c = ptmp
            Sc = Tpp(c)
            denom = torch.dot(Sc, c)
            alpha = torch.where(denom != 0, torch.dot(ptmp, c) / denom, 0.0)
            return alpha * c

        counts = self.krylov_iters

        def _apply(v, with_stats):
            out_dtype = v.dtype
            v = v.to(pdt)
            vu, vp = v[:self.n_u], v[self.n_u:]
            ptmp = vp - apply_Apv(Pvv_inverse(vu))
            x0 = initial_guess(ptmp)
            atol = 1e-3 * torch.linalg.vector_norm(ptmp).item()
            tpp = fgmres(Tpp, ptmp, x0=x0, M=tpp_M, atol=atol,
                         restart=self.tpp_restart,
                         max_restarts=self.tpp_max_restarts)
            dst_p = tpp.x
            dst_u = Pvv_inverse(vu) - Pvv_inverse(apply_Avp(dst_p))
            out = torch.cat([dst_u, dst_p]).to(out_dtype)
            counts["tpp"] += tpp.iters
            counts["applies"] += 1
            if with_stats:
                return out, tpp.iters
            return out

        def precond(v):
            return _apply(v, False)

        # telemetry twin: (result, tpp_gmres_iters) per apply; the
        # reference prints the same count per outer iteration
        # (source/mpi_supg_solver.cpp:184-190)
        precond.stats = lambda v: _apply(v, True)
        precond.pieces = dict(
            apply_Avp=apply_Avp, apply_Apv=apply_Apv, op_App=op_App,
            Tpp=Tpp, tpp_M=tpp_M, pvv_inv=pvv_inv, b2pp_diag=b2pp_diag,
            x0=initial_guess)
        return precond

    # ------------------------------------------------------------------
    def _newton_iter_impl(self, eval_pt, present, indicator, fsi_acc_nodal,
                          fsi_stress_nodal, stress_nodal, eddy_nu, cons,
                          ucons, pcons, res0=None):
        """One Newton iteration: assemble, condense, FGMRES.  Returns
        (du, res_norm, outer_iters, outer_residual)."""
        A_loc, rhs = self._assemble(eval_pt, present, indicator,
                                    fsi_acc_nodal, fsi_stress_nodal,
                                    stress_nodal, eddy_nu)
        b = cons.condense_rhs(rhs)
        res_norm = torch.linalg.vector_norm(b).item()
        nlu = self.nu_loc // self.dim
        st = self._sys_stencil
        sys_W = None
        mdt = torch.float32 if self.f32_matrix else A_loc.dtype
        A_op = A_loc.to(mdt)
        if st is not None:
            # coupled-node stencil outer apply: one (dim+1)-component
            # stencil tensor built per Newton iteration, shared with the
            # Tpp preconditioner
            sys_W = st.build_weights(self._sys_node_blocks(A_op))

            def apply_A(x):
                y = self._nodal_to_sys(
                    st.flat_matvec(sys_W, self._sys_to_nodal(x.to(mdt))))
                return y.to(x.dtype)
        else:
            # a rank's cells only when parallel/shard.py shards the solver
            red = getattr(self, "cell_reduce", None) or _whole

            def apply_A(x):
                y = element_matvec_taylor_hood(
                    A_op, self.cell_nodes_u, self.cell_dofs_p, nlu,
                    self.dim, self.n_u, self.n_p, x.to(mdt),
                    cell_dofs=self.cell_dofs)
                return red(y).to(x.dtype)
        op = cons.wrap_operator(apply_A)
        precond = self._make_preconditioner(A_loc, ucons, pcons,
                                            sys_W=sys_W)
        atol = self._outer_atol(res_norm, res0, self.outer_rtol * res_norm)
        x, iters, residual = self._outer_solve(op, b, precond, atol)
        self.krylov_iters["outer"] += iters
        du = cons.distribute(x)
        return du, res_norm, iters, residual

    # ------------------------------------------------------------------
    def bc_value_table(self, n_steps: int):
        """Per-step hard-coded Dirichlet inhomogeneities for the next
        n_steps, replicating the run loop's bc_time advance + constraint
        rebuild (reference: source/mpi_supg_solver.cpp:427-486).  Build
        this BEFORE make_on_device_stepper (it restores the solver's
        constraints afterwards)."""
        dt = self.time.get_delta_t()
        t0 = self.bc_time
        vals = []
        for i in range(n_steps):
            # table[0] = what run_one_step would apply right now; each
            # further step advances the BC clock by dt (run loop order:
            # bc_time += dt, make_constraints, run_one_step)
            self.bc_time = t0 + i * dt
            self._make_constraints()
            vals.append(self.nonzero_constraints.dirichlet_values)
        self.bc_time = t0
        self._make_constraints()
        return torch.stack(vals)

    def _eddy_nodal(self):
        """The attached turbulence model's nodal eddy viscosity, or
        zeros."""
        eddy = getattr(self, "eddy_viscosity_nodal", None)
        if eddy is None:
            eddy = torch.zeros(self.u_space.n_nodes, dtype=real_dtype(),
                               device=self.device)
        return eddy

    def _newton_loop(self, eval_pt, present, indicator, fsi_acc_nodal,
                     fsi_stress_nodal, stress_nodal, eddy_nu, cons, ucons,
                     pcons):
        """The Newton loop of one time step from `eval_pt` (see
        FluidSolverBase._run_newton; the residual floor of this family is
        1e-14)."""
        def newton_once(eval_pt, res0):
            du, rn, its, _ = self._newton_iter_impl(
                eval_pt, present, indicator, fsi_acc_nodal,
                fsi_stress_nodal, stress_nodal, eddy_nu, cons, ucons, pcons,
                res0=res0)
            return eval_pt + du, rn, its

        return self._run_newton(eval_pt, newton_once, 1e-14)

    def make_on_device_stepper(self, bc_values=None, turbulence=None):
        """SUPG time stepping without the host path's bookkeeping, with
        the nodal-stress update after every step.

        bc_values: optional (n_steps, n_dofs) table from bc_value_table
        for time-dependent hard-coded BCs (the reference run loop
        reapplies nonzero constraints every step); None = zero-increment
        stepping (BCs already in the state).  Returns fn(present, stress,
        n_steps, start=0) -> (present, stress, max_rel_res,
        max_newton_iters); `start` is an offset into the BC table, so a
        long window can be split into several calls without replaying BC
        rows.

        turbulence: optional SpalartAllmaras model (standalone runs): its
        step (make_device_step) runs BEFORE each fluid step on the
        previous fluid solution, the reference alternation
        (source/mpi_supg_solver.cpp:458-468), and its eddy viscosity
        enters that fluid step.  The returned fn is then fn(present,
        stress, nu, n_steps, start=0) -> (present, stress, nu,
        max_rel_res, max_newton_iters, max_sa_rel_res); the nonzero SA
        constraints apply at the step with index 0 only.

        The JAX package compiles the window into one dispatch; here it is
        an eager loop on device tensors, and every Krylov iteration still
        ends in a host synchronisation (la/krylov.py)."""
        cons = self.zero_constraints
        ucons = self.u_constraints
        pcons = self.p_constraints
        eddy0 = self._eddy_nodal()
        nz = self.nonzero_constraints
        sa_step = turbulence.make_device_step() if turbulence is not None \
            else None

        def one_step(present, stress_nodal, i, eddy):
            eval_pt = present if bc_values is None else \
                nz.apply_increment_with(present, bc_values[i])
            present, rel, it = self._newton_loop(
                eval_pt, present, self.indicator, self.fsi_acc_nodal,
                self.fsi_stress_nodal, stress_nodal, eddy, cons, ucons,
                pcons)
            return present, self._update_stress_impl(present), rel, it

        if sa_step is not None:
            def run_n_sa(present, stress_nodal, nu, n_steps, start=0):
                worst_rel = worst_it = worst_sa = 0
                for i in range(start, start + int(n_steps)):
                    # nonzero SA constraints are ADDITIVE increments: once,
                    # at the very first step (the host loop's
                    # run_one_step(True) then (False))
                    nu, eddy, sa_rel, _ = sa_step(nu, present, i == 0)
                    present, stress_nodal, rel, it = one_step(
                        present, stress_nodal, i, eddy)
                    worst_rel, worst_it = max(worst_rel, rel), max(worst_it,
                                                                   it)
                    worst_sa = max(worst_sa, sa_rel)
                return (present, stress_nodal, nu, worst_rel, worst_it,
                        worst_sa)

            return run_n_sa

        def run_n(present, stress_nodal, n_steps, start=0):
            worst_rel, worst_it = 0.0, 0
            for i in range(start, start + int(n_steps)):
                present, stress_nodal, rel, it = one_step(
                    present, stress_nodal, i, eddy0)
                worst_rel, worst_it = max(worst_rel, rel), max(worst_it, it)
            return present, stress_nodal, worst_rel, worst_it

        return run_n

    def make_fsi_step(self):
        """One coupled-run time step: the Newton loop with the stopping
        rules of the JAX package's fused step, run eagerly, with the
        per-step FSI fields and (extended) constraint sets as arguments.
        Returns fn(present, indicator, fsi_acc_nodal, fsi_stress_nodal,
        stress_nodal, eddy_nu, zero_cons, nonzero_cons, ucons, pcons) ->
        (present, stress_nodal, rel_res, newton_iters)."""
        def step(present, indicator, fsi_acc_nodal, fsi_stress_nodal,
                 stress_nodal, eddy_nu, zero_cons, nonzero_cons, ucons,
                 pcons):
            eval_pt, rel, it = self._newton_loop(
                nonzero_cons.apply_increment(present), present, indicator,
                fsi_acc_nodal, fsi_stress_nodal, stress_nodal, eddy_nu,
                zero_cons, ucons, pcons)
            return eval_pt, self._update_stress_impl(eval_pt), rel, it

        return step

    def run_on_device(self, verbose: bool = True):
        """run() with the whole time loop through make_on_device_stepper;
        results match the host run().  The production / benchmark path
        for standalone SUPG runs.  An attached Spalart-Allmaras model
        steps inside the stepper, before each fluid step; only its FSI
        wall-function mode (per-step moving-wall distances and Dirichlet
        rows, driven by MPIFSI) falls back to run(), as in the JAX
        package.  Per-step VTU/PVD/checkpoint writes are skipped (only
        the final state is kept)."""
        if not self._setup_done:
            self._refine_setup_with_mg()
            self._setup_done = True
        tm = getattr(self, "turbulence_model", None)
        if tm is not None and not hasattr(tm, "space"):
            tm.setup()
        if tm is not None and (tm._step_zero is not None or
                               tm._step_nonzero is not None):
            # FSI wall-function mode: the host loop
            return self.run(verbose=verbose)
        dt = self.time.get_delta_t()
        n = int(round((self.time.end() - self.time.current()) / dt))
        if n <= 0:
            return
        if self.hard_coded_bcs:
            table = self.bc_value_table(n)
        else:
            # reference run loop: nonzero constraints at the first step
            # only, zero increments afterwards
            table = torch.zeros((n, self.n_dofs), dtype=real_dtype(),
                                device=self.device)
            table[0] = self.nonzero_constraints.dirichlet_values
        stepper = self.make_on_device_stepper(table, turbulence=tm)
        if tm is not None:
            sol, stress, nu, rel, its, sa_rel = stepper(
                self.present_solution, self.stress_device,
                tm.present_solution, n)
            if sa_rel > self.params.fluid_tolerance:
                raise RuntimeError("Too many Newton iterations!")
            tm.present_solution = nu
            tm.update_eddy_viscosity()
        else:
            sol, stress, rel, its = stepper(self.present_solution,
                                            self.stress_device, n)
        if rel > self.params.fluid_tolerance:
            raise RuntimeError("Too many Newton iterations!")
        self.present_solution = sol
        self.stress_device = stress
        self.newton_iters = its
        for _ in range(n):
            self.time.increment()
        if verbose:
            print(f"run_on_device: {n} steps, worst rel_res "
                  f"{rel:.3e}, max newton iters {its}")

    def run_one_step(self, apply_nonzero_constraints: bool,
                     assemble_system: bool = True, verbose: bool = True,
                     zero_cons=None, nonzero_cons=None):
        """reference: source/mpi_supg_solver.cpp:330-425."""
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
        eddy = self._eddy_nodal()

        current_res = 1.0
        initial_res = 1.0
        rel_res = 1.0
        prev_res = None
        it = 0
        while rel_res > params.fluid_tolerance and current_res > 1e-14:
            if it >= params.fluid_max_iterations:
                raise RuntimeError("Too many Newton iterations!")
            with self.timer.scope("Assemble + solve (Newton iter)"):
                du, current_res, iters, gres = self._newton_iter(
                    eval_pt, self.present_solution, self.indicator,
                    self.fsi_acc_nodal, self.fsi_stress_nodal,
                    self.stress_device, eddy, zero_cons,
                    self._u_cons_of(zero_cons), self.p_constraints,
                    res0=initial_res if it > 0 else math.inf)
            if (prev_res is not None and iters == 0
                    and current_res >= prev_res * (1 - 1e-12)):
                break
            prev_res = current_res
            eval_pt = eval_pt + du
            if it == 0:
                initial_res = max(current_res, 1e-300)
            rel_res = current_res / initial_res
            if verbose:
                print(f" ITR = {it} ABS_RES = {current_res:.6e} "
                      f"REL_RES = {rel_res:.6e} GMRES_ITR = {iters} "
                      f"GMRES_RES = {gres:.6e}")
            it += 1
        self.newton_iters = it
        self.solution_increment = eval_pt - self.present_solution
        self.present_solution = eval_pt
        with self.timer.scope("Update stress"):
            self.update_stress()
        # reference: source/mpi_supg_solver.cpp:400-424
        self._end_of_step_io()

    def run(self, verbose: bool = True):
        """reference: source/mpi_supg_solver.cpp:427-486 (time-dependent
        hard-coded BCs advance their own clock and reapply nonzero
        constraints every step; an attached turbulence model steps before
        the fluid, :458-468)."""
        if not self._setup_done:
            self._refine_setup_with_mg()
        tm = getattr(self, "turbulence_model", None)
        if tm is not None and not hasattr(tm, "space"):
            tm.setup()
        if tm is not None:
            tm.run_one_step(True)
        self.run_one_step(True, verbose=verbose)
        while self.time.end() - self.time.current() > 1e-12:
            if tm is not None:
                tm.run_one_step(False)
            if self.hard_coded_bcs:
                self.bc_time += self.time.get_delta_t()
                self._make_constraints()
                self.run_one_step(True, verbose=verbose)
            else:
                self.run_one_step(False, verbose=verbose)

    # ------------------------------------------------------------------
    def _fields_at_q(self, eval_pt, present):
        d = self.dim
        Nu, Np, gu, gp = self.Nu, self.Np, self.gu, self.gp
        un_nodes, pn_nodes = self._u_cell_nodes, self._p_cell_nodes
        ul = eval_pt[:self.n_u].reshape(-1, d)[un_nodes]
        pl = eval_pt[self.n_u:][pn_nodes]
        unl = present[:self.n_u].reshape(-1, d)[un_nodes]
        pnl = present[self.n_u:][pn_nodes]
        uc = es("ql,cla->cqa", Nu, ul)
        G = es("cqlx,cla->cqax", gu, ul)
        pc = es("qn,cn->cq", Np, pl)
        gpc = es("cqnx,cn->cqx", gp, pl)
        un = es("ql,cla->cqa", Nu, unl)
        pn = es("qn,cn->cq", Np, pnl)
        return uc, G, pc, gpc, un, pn

    # -- shared pieces of the three assemblies -----------------------------
    def _supg_uu(self, w, uc, G, gu, Nu, vec, I):
        """The SUPG velocity-velocity terms that all three assemblies
        share, for the test vector u[a] grad N_l with weight w (c, q):
          w u_a N_m (grad N_l . grad u_b) + w u_a u_b (grad N_l . grad N_m)
          + I_ab N_m (grad N_l . vec)
        where vec (c, q, x) is the sum of every strong-residual vector
        that multiplies N_m I_ab, each with its own weight folded in."""
        gG = es("cqlx,cqbx->cqlb", gu, G)
        wu = w[..., None] * uc
        out = es("cqa,cqlb,qm->clamb", wu, gG, Nu)
        glgm = es("cqlx,cqmx->cqlm", gu, gu)
        out = out + es("cqa,cqb,cqlm->clamb", wu, uc, glgm)
        gv = es("cqlx,cqx->cql", gu, vec)
        return out + es("clm,ab->clamb", es("cql,qm->clm", gv, Nu), I)

    def _finish(self, Auu, Aup, Apu, App, r_u, r_p):
        n_c = Auu.shape[0]
        A_loc = torch.cat([torch.cat([Auu, Aup], dim=2),
                           torch.cat([Apu, App], dim=2)], dim=1)
        r_loc = torch.cat([r_u.reshape(n_c, -1), r_p], dim=1)
        rhs = scatter_add(self.n_dofs, self.cell_dofs, r_loc)
        return A_loc, rhs + self._neumann_rhs_const


class SUPGInsIM(SUPGFluidSolver):
    """Incompressible SUPG/PSPG/LSIC solver
    (reference: source/mpi_insim_supg.cpp:14-330)."""

    def _assemble(self, eval_pt, present, indicator, fsi_acc_nodal,
                  fsi_stress_nodal, stress_nodal, eddy_nu):
        params = self.params
        d = self.dim
        rho = params.fluid_rho
        mu = params.viscosity
        dt = self.time.get_delta_t()
        Nu, Np, gu, gp, JxW = self.Nu, self.Np, self.gu, self.gp, self.JxW
        n_c, n_q = JxW.shape
        nlp = self.nlp
        I = torch.eye(d, dtype=eval_pt.dtype, device=self.device)

        uc, G, pc, gpc, un, pn = self._fields_at_q(eval_pt, present)
        divu = _trace(G)
        bf = self.gravity_q  # gravity + body force

        ones = torch.ones((n_c, n_q), dtype=eval_pt.dtype,
                          device=self.device)
        tau_s, tau_p, tau_l = self._stab_parameters(un, mu * ones,
                                                    rho * ones)

        # NOTE deal.II tensor conventions (replicated from the reference):
        #   u * grad_phi_u[i]  contracts the COMPONENT index ->  u[a] grad N_l
        #   u * G (in the SUPG residual) = (grad u)^T u,
        # while the Galerkin convection uses G * u = (u . grad) u.
        ug = es("cqx,cqlx->cql", uc, gu)             # grad N_l . u
        uTG = es("cqa,cqax->cqx", uc, G)             # (grad u)^T u
        Gu = es("cqax,cqx->cqa", G, uc)              # (u . grad) u
        accel = (uc - un) / dt
        w_s = tau_s * JxW
        w_p = tau_p * JxW

        # ---------------- Auu -------------------------------------------
        gg = es("cqlx,cqmx,cq->clm", gu, gu, JxW)
        NN = es("ql,qm,cq->clm", Nu, Nu, JxW)
        conv2 = es("ql,cqm,cq->clm", Nu, ug, JxW)
        Auu = es("clm,ab->clamb", mu * gg + rho * conv2 + (rho / dt) * NN,
                 I)
        Auu = Auu + rho * es("cq,ql,qm,cqab->clamb", JxW, Nu, Nu, G)
        # SUPG: test vector u[a] grad N_l; the I_ab terms carry
        # rho (grad u)^T u + rho (u - un)/dt + grad p - rho bf
        vec = w_s[..., None] * (rho * (uTG + accel - bf) + gpc)
        Auu = Auu + self._supg_uu(rho * w_s, uc, G, gu, Nu, vec, I)
        Auu = Auu + (rho / dt) * es("cqa,cqlb,qm->clamb",
                                    w_s[..., None] * uc, gu, Nu)
        # LSIC
        Auu = Auu + rho * es("cq,cqla,cqmb->clamb", tau_l * JxW, gu, gu)
        Auu = Auu.reshape(n_c, self.nu_loc, self.nu_loc)

        # ---------------- Aup -------------------------------------------
        Aup = -es("cqla,qn,cq->clan", gu, Np, JxW)
        Aup = Aup + es("cqa,cqlx,cqnx->clan", w_s[..., None] * uc, gu, gp)
        Aup = Aup.reshape(n_c, self.nu_loc, nlp)

        # ---------------- Apu -------------------------------------------
        Apu = es("qn,cqmb,cq->cnmb", Np, gu, JxW)  # +continuity
        Apu = Apu + rho * es("cq,cqnb,qm->cnmb", w_p,
                             es("cqnx,cqbx->cqnb", gp, G), Nu)
        Apu = Apu + rho * es("cqb,cqnm->cnmb", w_p[..., None] * uc,
                             es("cqnx,cqmx->cqnm", gp, gu))
        Apu = Apu + (rho / dt) * es("cq,cqnb,qm->cnmb", w_p, gp, Nu)
        Apu = Apu.reshape(n_c, nlp, self.nu_loc)

        # ---------------- App -------------------------------------------
        App = es("cq,cqnx,cqox->cno", w_p, gp, gp)

        # ---------------- RHS -------------------------------------------
        mom_res = rho * (accel + uTG) + gpc - rho * bf  # SUPG strong residual
        r_u = (-mu * es("cqax,cqlx,cq->cla", G, gu, JxW)
               - rho * es("ql,cqa,cq->cla", Nu, Gu, JxW)
               + es("cq,cqla,cq->cla", pc, gu, JxW)
               - rho * es("ql,cqa,cq->cla", Nu, accel, JxW)
               + rho * es("ql,cqa,cq->cla", Nu, bf, JxW))
        r_u = r_u - es("cqa,cql->cla", w_s[..., None] * uc,
                       es("cqlx,cqx->cql", gu, mom_res))
        r_u = r_u - rho * es("cq,cqla,cq->cla", tau_l * JxW, gu, divu)
        r_p = -es("cq,qn,cq->cn", divu, Np, JxW)
        r_p = r_p - es("cq,cqnx,cqx->cn", w_p, gp, mom_res)
        return self._finish(Auu, Aup, Apu, App, r_u, r_p)


class SCnsIM(SUPGFluidSolver):
    """Slightly-compressible SUPG solver with isentropic continuity, PML
    attenuation, artificial-solid handling and nodal-stress-divergence
    stabilization (reference: source/mpi_scnsim.cpp:15-568)."""

    def _assemble(self, eval_pt, present, indicator, fsi_acc_nodal,
                  fsi_stress_nodal, stress_nodal, eddy_nu):
        params = self.params
        d = self.dim
        dt = self.time.get_delta_t()
        Nu, Np, gu, gp, JxW = self.Nu, self.Np, self.gu, self.gp, self.JxW
        n_c, n_q = JxW.shape
        nlp = self.nlp

        uc, G, pc, gpc, un, pn = self._fields_at_q(eval_pt, present)
        divu = _trace(G)
        bf = self.gravity_q
        sig = self.sigma_pml_q                     # (c, q)
        ind = indicator[:, None]                   # (c, 1) -> broadcast q
        nf = 1.0 - ind                             # "not solid" factor

        # local density/viscosity (reference: source/mpi_scnsim.cpp:210-216)
        rho_q = params.fluid_rho * (1 + pn / ATM) * nf + \
            ind * params.solid_rho
        cd_u = self._u_cell_nodes
        eddy_q = es("ql,cl->cq", Nu, eddy_nu[cd_u])
        visc_q = (ind * 1.0 + nf * params.viscosity) + \
            torch.clamp(eddy_q, min=0.0)

        tau_s, tau_p, tau_l = self._stab_parameters(un, visc_q, rho_q)
        w_s = tau_s * JxW
        w_p = tau_p * JxW
        w_l = tau_l * JxW

        # divergence of the projected nodal viscous stress, rescaled by the
        # local viscosity (reference: source/mpi_scnsim.cpp:278-289)
        sl = stress_nodal[cd_u]                    # (c, nlu, d, d)
        div_sigma = es("cqlx,clax->cqa", gu, sl)
        div_sigma = div_sigma * (visc_q / params.viscosity)[..., None]

        fsi_acc_q = es("ql,cla->cqa", Nu, fsi_acc_nodal[cd_u])
        fsi_sig_q = es("ql,clab->cqab", Nu, fsi_stress_nodal[cd_u])

        # see SUPGInsIM for the deal.II tensor-contraction conventions
        uTG = es("cqa,cqax->cqx", uc, G)             # (grad u)^T u
        Gu = es("cqax,cqx->cqa", G, uc)              # (u . grad) u
        accel = (uc - un) / dt
        rJ = rho_q * JxW

        # Matrix block in f32 when f32_matrix: the Jacobian is applied and
        # preconditioned in f32 (inexact Newton).  The casts sit where the
        # JAX package has them; the residual below stays f64.
        mdt = torch.float32 if self.f32_matrix else eval_pt.dtype
        c_ = (lambda a: a.to(mdt))
        Nu_, Np_, gu_, gp_ = c_(Nu), c_(Np), c_(gu), c_(gp)
        JxW_, rJ_, sig_ = c_(JxW), c_(rJ), c_(sig)
        uc_, G_, un_, gpc_ = c_(uc), c_(G), c_(un), c_(gpc)
        rho_, ws_, wp_, wl_ = c_(rho_q), c_(w_s), c_(w_p), c_(w_l)
        pc_, nf_, ind_, divu_ = c_(pc), c_(nf), c_(ind), c_(divu)
        visc_, dsig_, bf_ = c_(visc_q), c_(div_sigma), c_(bf)
        facc_ = c_(fsi_acc_q)
        I_ = torch.eye(d, dtype=mdt, device=self.device)
        ug_ = es("cqx,cqlx->cql", uc_, gu_)           # grad N_l . u
        uTG_ = c_(uTG)
        rws_ = rho_ * ws_

        # ---------------- Auu -------------------------------------------
        gg_v = es("cq,cqlx,cqmx->clm", visc_ * JxW_, gu_, gu_)
        NN_r = es("cq,ql,qm->clm", rJ_, Nu_, Nu_)
        conv2 = es("cq,ql,cqm->clm", rJ_, Nu_, ug_)
        Auu = es("clm,ab->clamb",
                 gg_v + conv2 + NN_r / dt
                 + es("cq,ql,qm->clm", rJ_ * sig_, Nu_, Nu_), I_)
        Auu = Auu + es("cq,ql,qm,cqab->clamb", rJ_, Nu_, Nu_, G_)
        # SUPG (test vector u[a] grad N_l); the I_ab terms carry the
        # strong momentum residual's vectors: convection, acceleration,
        # pressure gradient, stress divergence, body force, PML and the
        # FSI acceleration on artificial-fluid cells
        vec = (rws_[..., None] * (uTG_ + (uc_ - un_) / dt - bf_)
               + ws_[..., None] * (gpc_ - dsig_)
               + (rws_ * sig_)[..., None] * uc_
               - (ws_ * ind_ * rho_)[..., None] * facc_)
        Auu = Auu + self._supg_uu(rws_, uc_, G_, gu_, Nu_, vec, I_)
        # SUPG acceleration + PML (u-trial part)
        Auu = Auu + es("cqa,cqlb,qm->clamb",
                       (rws_ / dt + rws_ * sig_)[..., None] * uc_, gu_, Nu_)
        # LSIC velocity divergence (+ compressible corrections)
        Auu = Auu + es("cq,cqla,cqmb->clamb",
                       rho_ * wl_ * CP_TO_CV * (1 + pc_ * nf_ / ATM), gu_,
                       gu_)
        # LSIC pressure-gradient coupling (u-trial part)
        Auu = Auu + es("cq,cqla,qm,cqb->clamb", rho_ * wl_ * nf_ / ATM,
                       gu_, Nu_, gpc_)
        Auu = Auu.reshape(n_c, self.nu_loc, self.nu_loc)

        # ---------------- Aup -------------------------------------------
        Aup = -es("cqla,qn,cq->clan", gu_, Np_, JxW_)
        Aup = Aup + es("cqa,cqlx,cqnx->clan", ws_[..., None] * uc_, gu_,
                       gp_)
        # LSIC acceleration terms (fluid + artificial-solid bulk) and the
        # velocity-divergence cross term
        Aup = Aup + es("cq,cqla,qn->clan",
                       rho_ * wl_ / dt * (nf_ / ATM + ind_ / KAPPA_S)
                       + rho_ * wl_ * CP_TO_CV * nf_ * divu_ / ATM,
                       gu_, Np_)
        # LSIC pressure gradient (p-trial part)
        Aup = Aup + es("cq,cqla,cqn->clan", rho_ * wl_ * nf_ / ATM, gu_,
                       es("cqnx,cqx->cqn", gp_, uc_))
        Aup = Aup.reshape(n_c, self.nu_loc, nlp)

        # ---------------- Apu -------------------------------------------
        # isentropic continuity (reference: source/mpi_scnsim.cpp:395-414)
        Apu = es("cq,qn,cqmb->cnmb",
                 CP_TO_CV * (ATM + pc_ * nf_) / ATM * JxW_, Np_, gu_)
        Apu = Apu + es("cq,qn,qm,cqb->cnmb", nf_ / ATM * JxW_, Np_, Nu_,
                       gpc_)
        # PSPG
        rwp_ = rho_ * wp_
        Apu = Apu + es("cq,cqnb,qm->cnmb", rwp_,
                       es("cqnx,cqbx->cqnb", gp_, G_), Nu_)
        Apu = Apu + es("cqb,cqnm->cnmb", rwp_[..., None] * uc_,
                       es("cqnx,cqmx->cqnm", gp_, gu_))
        Apu = Apu + es("cq,cqnb,qm->cnmb", rwp_ / dt + rwp_ * sig_, gp_,
                       Nu_)
        Apu = Apu.reshape(n_c, nlp, self.nu_loc)

        # ---------------- App -------------------------------------------
        App = es("cq,qn,qo->cno",
                 (sig_ / ATM + divu_ * nf_ / ATM
                  + (nf_ / ATM + ind_ / KAPPA_S) / dt) * JxW_, Np_, Np_)
        App = App + es("cq,qn,cqo->cno", nf_ / ATM * JxW_, Np_,
                       es("cqox,cqx->cqo", gp_, uc_))
        App = App + es("cq,cqnx,cqox->cno", wp_, gp_, gp_)

        # ---------------- RHS -------------------------------------------
        mom_res = (rho_q[..., None] * (accel + uTG) + gpc - div_sigma -
                   rho_q[..., None] * bf +
                   (rho_q * sig)[..., None] * uc)
        r_u = (-es("cq,cqax,cqlx->cla", visc_q * JxW, G, gu)
               - es("cq,ql,cqa->cla", rJ, Nu, Gu)
               + es("cq,cqla->cla", pc * JxW, gu)
               - es("cq,ql,cqa->cla", rJ / dt, Nu, uc - un)
               + es("cq,ql,cqa->cla", rJ, Nu, bf)
               - es("cq,ql,cqa->cla", rJ * sig, Nu, uc))
        r_u = r_u - es("cqa,cql->cla", w_s[..., None] * uc,
                       es("cqlx,cqx->cql", gu, mom_res))
        # LSIC rhs
        lsic_res = ((pc - pn) / dt * nf / ATM +
                    CP_TO_CV * divu * (1 + pc * nf / ATM) +
                    es("cqx,cqx->cq", uc, gpc) * nf / ATM +
                    (pc - pn) / dt * ind / KAPPA_S)
        r_u = r_u - es("cq,cqla->cla", rho_q * w_l * lsic_res, gu)
        # FSI (artificial fluid)
        r_u = r_u + ind[..., None] * (
            es("cqla,cqab,cq->clb", gu, fsi_sig_q, JxW) +
            es("cq,ql,cqa->cla", rJ, Nu, fsi_acc_q) +
            es("cqa,cql->cla", (w_s * rho_q)[..., None] * uc,
               es("cqlx,cqx->cql", gu, fsi_acc_q)))

        cont_res = (CP_TO_CV * (ATM + pc * nf) * divu +
                    es("cqx,cqx->cq", uc, gpc) * nf +
                    (pc - pn) / dt * nf) / ATM + \
            (pc - pn) / dt * ind / KAPPA_S
        r_p = (-es("cq,qn->cn", cont_res * JxW, Np)
               - es("cq,qn->cn", sig * pc / ATM * JxW, Np))
        r_p = r_p - es("cq,cqnx,cqx->cn", w_p, gp, mom_res)
        r_p = r_p + es("cq,cqnx,cqx->cn", w_p * rho_q * ind, gp, fsi_acc_q)
        return self._finish(Auu, Aup, Apu, App, r_u, r_p)


class SerialSCnsIM(SUPGFluidSolver):
    """Serial-variant slightly-compressible SUPG solver
    (reference: source/scnsim.cpp:198-658, include/scnsim.h:36-236).

    Differs from the MPI variant (SCnsIM above):
     - constant per-cell density rho_f + ind*(rho_s - rho_f) and constant
       laminar viscosity (scnsim.cpp:262-264; no compressible density or
       artificial-fluid viscosity override)
     - continuity equation and PML pressure terms scaled by
       1/(cp/cv * atm) instead of 1/atm (scnsim.cpp:352, 404-413, 432-442)
     - no LSIC stabilization, no nodal-stress divergence and no gravity in
       the SUPG/PSPG residual (scnsim.cpp:355-397, 449-461)
     - Galerkin-only FSI force (scnsim.cpp:462-469)
     - outer FGMRES rtol 1e-8 (scnsim.cpp:533-535)
    The nodal FSI fields stand in for the reference's per-cell
    CellProperty (constant over a covered cell in the reference)."""

    outer_rtol = 1e-8

    def _assemble(self, eval_pt, present, indicator, fsi_acc_nodal,
                  fsi_stress_nodal, stress_nodal, eddy_nu):
        params = self.params
        d = self.dim
        dt = self.time.get_delta_t()
        Nu, Np, gu, gp, JxW = self.Nu, self.Np, self.gu, self.gp, self.JxW
        n_c, n_q = JxW.shape
        nlp = self.nlp

        uc, G, pc, gpc, un, pn = self._fields_at_q(eval_pt, present)
        divu = _trace(G)
        bf = self.gravity_q
        sig = self.sigma_pml_q
        ind = indicator[:, None]
        nf = 1.0 - ind
        CA = CP_TO_CV * ATM

        mu = params.viscosity
        ones = torch.ones((n_c, n_q), dtype=eval_pt.dtype,
                          device=self.device)
        rho_q = (params.fluid_rho +
                 ind * (params.solid_rho - params.fluid_rho)) * ones

        tau_s, tau_p, _ = self._stab_parameters(un, mu * ones, rho_q)
        w_s = tau_s * JxW
        w_p = tau_p * JxW

        cd_u = self._u_cell_nodes
        fsi_acc_q = es("ql,cla->cqa", Nu, fsi_acc_nodal[cd_u])
        fsi_sig_q = es("ql,clab->cqab", Nu, fsi_stress_nodal[cd_u])

        # deal.II tensor conventions: see SUPGInsIM
        uTG = es("cqa,cqax->cqx", uc, G)
        Gu = es("cqax,cqx->cqa", G, uc)
        accel = (uc - un) / dt
        rJ = rho_q * JxW

        # Matrix block in f32 when f32_matrix (see SCnsIM); the residual
        # below stays f64.
        mdt = torch.float32 if self.f32_matrix else eval_pt.dtype
        c_ = (lambda a: a.to(mdt))
        m_Nu, m_Np, m_gu, m_gp = c_(Nu), c_(Np), c_(gu), c_(gp)
        m_JxW, m_rJ, m_sig = c_(JxW), c_(rJ), c_(sig)
        m_uc, m_G, m_un, m_gpc = c_(uc), c_(G), c_(un), c_(gpc)
        m_rho, m_ws, m_wp = c_(rho_q), c_(w_s), c_(w_p)
        m_pc, m_nf, m_ind, m_divu = c_(pc), c_(nf), c_(ind), c_(divu)
        m_I = torch.eye(d, dtype=mdt, device=self.device)
        m_ug = es("cqx,cqlx->cql", m_uc, m_gu)
        m_uTG = c_(uTG)
        m_rws = m_rho * m_ws

        # ---------------- Auu (scnsim.cpp:338-397) -----------------------
        gg = es("cqlx,cqmx,cq->clm", m_gu, m_gu, m_JxW)
        NN_r = es("cq,ql,qm->clm", m_rJ, m_Nu, m_Nu)
        conv2 = es("cq,ql,cqm->clm", m_rJ, m_Nu, m_ug)
        Auu = es("clm,ab->clamb",
                 mu * gg + conv2 + NN_r / dt
                 + es("cq,ql,qm->clm", m_rJ * m_sig, m_Nu, m_Nu), m_I)
        Auu = Auu + es("cq,ql,qm,cqab->clamb", m_rJ, m_Nu, m_Nu, m_G)
        # SUPG (test vector u[a] grad N_l): convection, acceleration,
        # pressure gradient and PML in the I_ab terms
        vec = (m_rws[..., None] * (m_uTG + (m_uc - m_un) / dt)
               + m_ws[..., None] * m_gpc
               + (m_rws * m_sig)[..., None] * m_uc)
        Auu = Auu + self._supg_uu(m_rws, m_uc, m_G, m_gu, m_Nu, vec, m_I)
        # SUPG acceleration + PML (u-trial part)
        Auu = Auu + es("cqa,cqlb,qm->clamb",
                       (m_rws / dt + m_rws * m_sig)[..., None] * m_uc,
                       m_gu, m_Nu)
        Auu = Auu.reshape(n_c, self.nu_loc, self.nu_loc)

        # ---------------- Aup --------------------------------------------
        Aup = -es("cqla,qn,cq->clan", m_gu, m_Np, m_JxW)
        Aup = Aup + es("cqa,cqlx,cqnx->clan", m_ws[..., None] * m_uc, m_gu,
                       m_gp)
        Aup = Aup.reshape(n_c, self.nu_loc, nlp)

        # ---------------- Apu (continuity, scnsim.cpp:400-413) -----------
        Apu = es("cq,qn,cqmb->cnmb", (ATM + m_pc) / ATM * m_JxW, m_Np,
                 m_gu)
        Apu = Apu + es("cq,qn,qm,cqb->cnmb", m_JxW / CA, m_Np, m_Nu, m_gpc)
        # PSPG
        m_rwp = m_rho * m_wp
        Apu = Apu + es("cq,cqnb,qm->cnmb", m_rwp,
                       es("cqnx,cqbx->cqnb", m_gp, m_G), m_Nu)
        Apu = Apu + es("cqb,cqnm->cnmb", m_rwp[..., None] * m_uc,
                       es("cqnx,cqmx->cqnm", m_gp, m_gu))
        Apu = Apu + es("cq,cqnb,qm->cnmb", m_rwp / dt + m_rwp * m_sig,
                       m_gp, m_Nu)
        Apu = Apu.reshape(n_c, nlp, self.nu_loc)

        # ---------------- App --------------------------------------------
        App = es("cq,qn,qo->cno",
                 (m_sig / CA + CP_TO_CV * m_nf / CA * m_divu
                  + (m_nf / CA + m_ind / KAPPA_S) / dt) * m_JxW, m_Np, m_Np)
        App = App + es("cq,qn,cqo->cno", m_nf / CA * m_JxW, m_Np,
                       es("cqox,cqx->cqo", m_gp, m_uc))
        App = App + es("cq,cqnx,cqox->cno", m_wp, m_gp, m_gp)

        # ---------------- RHS (scnsim.cpp:428-469) -----------------------
        mom_res = (rho_q[..., None] * (accel + uTG) + gpc +
                   (rho_q * sig)[..., None] * uc)
        r_u = (-mu * es("cqax,cqlx,cq->cla", G, gu, JxW)
               - es("cq,ql,cqa->cla", rJ, Nu, Gu)
               + es("cq,cqla->cla", pc * JxW, gu)
               - es("cq,ql,cqa->cla", rJ / dt, Nu, uc - un)
               + es("cq,ql,cqa->cla", rJ, Nu, bf)
               - es("cq,ql,cqa->cla", rJ * sig, Nu, uc))
        r_u = r_u - es("cqa,cql->cla", w_s[..., None] * uc,
                       es("cqlx,cqx->cql", gu, mom_res))
        r_u = r_u + ind[..., None] * (
            es("cqla,cqab,cq->clb", gu, fsi_sig_q, JxW) +
            es("cq,ql,cqa->cla", rJ, Nu, fsi_acc_q))

        cont_res = (CP_TO_CV * (ATM + pc) * divu +
                    es("cqx,cqx->cq", uc, gpc) * nf +
                    (pc - pn) / dt * (nf + CA / KAPPA_S * ind)) / CA
        r_p = (-es("cq,qn->cn", cont_res * JxW, Np)
               - es("cq,qn->cn", sig * pc / CA * JxW, Np))
        r_p = r_p - es("cq,cqnx,cqx->cn", w_p, gp, mom_res)
        return self._finish(Auu, Aup, Apu, App, r_u, r_p)
