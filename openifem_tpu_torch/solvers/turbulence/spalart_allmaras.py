"""Spalart-Allmaras (negative-SA variant) RANS turbulence model.

Counterpart of openifem_tpu/solvers/turbulence/spalart_allmaras.py
(reference: include/mpi_spalart_allmaras.h,
source/mpi_spalart_allmaras.cpp, include/mpi_turbulence_model.h; factory
at source/mpi_turbulence_model.cpp:12-26).

The scalar working viscosity nu~ lives on the fluid's scalar (velocity-
degree) space; each fluid step is preceded by a Newton solve of the SA
transport equation; the eddy viscosity mu_t = rho f_v1 nu~ feeds back into
the fluid assembly (SCnsIM reads `eddy_viscosity_nodal`).  The Newton
matrix is applied by the element-block matvec in its scalar layout over
the model's persistent `cell_dofs` table (on a CUDA tensor the kernel of
csrc/element_matvec.cu, whose gather plan is then built once).

Parity notes, as in the JAX package:
 - the reference's `r` parameter drops the result of std::min (an
   uninitialized-variable bug, source/mpi_spalart_allmaras.cpp:757-769);
   r = min(nu~/(S~ k^2 d^2), 10) is the evidently intended value;
 - the fixed wall distance is the minimum over the wall boundary VERTEX
   cloud (source/mpi_spalart_allmaras.cpp:408-539), one distance matrix
   on the device;
 - FSI wall functions: the moving-wall distance is point-to-segment
   against the deformed solid boundary (2-D; the vertex cloud in 3-D)
   with y+ from linearly interpolated shear velocities (:16-127); the
   shear velocity solves the analytic u+(y+) profile by Newton (:217-280);
   `update_boundary_condition` adds per-step Dirichlet rows nu~ = kappa y+
   nu near the moving wall and nu~ = 0 inside the solid (:129-215), and
   rows accumulate across steps, as the reference never rebuilds them.

Where the JAX package works on the host, the port stays on the device:
the shear-velocity Newton runs a fixed 30 masked iterations (converged
entries are frozen, so the values are the same as breaking out early,
without a host read per iteration); the wall distances are device
tensors; the per-step constraint sets are built from device masks
(Constraints.with_dirichlet).  The Newton loops read one residual norm
per iteration on the host, as the fluids' do.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...fe.space import SystemSpace
from ...la.constraints import Constraints
from ...la.krylov import fgmres
from ...la.operators import element_diag, element_matvec, scatter_add
from ...parameters import AllParameters

CV1, CV2, CV3 = 7.1, 0.7, 0.9
CB1, CB2, CT3, CT4, KAPPA = 0.1355, 0.622, 1.2, 0.5, 0.41
CW2, CW3, CN1 = 0.3, 2.0, 16.0
SIGMA = 2.0 / 3.0
CW1 = CB1 / (KAPPA * KAPPA) + (1.0 + CB2) / SIGMA

# analytic wall-velocity-profile constants
# (reference: source/mpi_spalart_allmaras.cpp:237-246)
WF_B, WF_A1, WF_A2 = 5.03339088, 8.14822158, -6.92870938
WF_B1, WF_B2 = 7.46008761, 7.46814579
WF_C1, WF_C2, WF_C3, WF_C4 = 2.54967735, 1.33016516, 3.59945911, 3.63975319
# iterations of the shear-velocity Newton solve
SHEAR_NEWTON_ITERS = 30

es = torch.einsum


def _u_plus(yp):
    b1 = torch.full_like(yp, WF_B1)
    b2 = torch.full_like(yp, WF_B2)
    return (WF_B + WF_C1 * torch.log((yp + WF_A1) ** 2 + WF_B1 ** 2)
            - WF_C2 * torch.log((yp + WF_A2) ** 2 + WF_B2 ** 2)
            - WF_C3 * torch.atan2(b1, yp + WF_A1)
            - WF_C4 * torch.atan2(b2, yp + WF_A2))


def _dup_dyp(yp):
    k3 = KAPPA ** 3
    return k3 * yp ** 3 / (CV1 ** 3 + k3 * yp ** 3)


def make_turbulence_model(name: str, fluid):
    """TurbulenceModelFactory analog
    (reference: source/mpi_turbulence_model.cpp:12-26); attaches the
    model to the fluid (reference: attach_turbulence_model,
    source/mpi_fluid_solver.cpp:53-63)."""
    if name == "Spalart-Allmaras":
        model = SpalartAllmaras(fluid)
        fluid.turbulence_model = model
        return model
    raise ValueError(f"Unknown turbulence model: {name}")


class SpalartAllmaras:
    outer_restart = 30
    outer_max_restarts = 20

    def __init__(self, fluid):
        self.fluid = fluid
        self.params: AllParameters = fluid.params
        self.device = fluid.device
        # Newton iterations of the last step; FGMRES iterations summed
        self.newton_iters = 0
        self.krylov_iters = {"fgmres": 0}

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype if dtype is not None
                               else real_dtype())

    # ------------------------------------------------------------------
    def setup(self):
        """Build the scalar system on the fluid's velocity-degree space."""
        fluid = self.fluid
        params = self.params
        space = fluid.u_space
        self.space = space
        self.n = space.n_nodes
        t = self._tensor
        rdt, dev = real_dtype(), self.device

        # BCs: type 0 wall -> 0; type 1 inflow -> 5 nu_laminar
        # (reference: source/mpi_spalart_allmaras.cpp:347-406)
        dmask = np.zeros(self.n, dtype=bool)
        dvals = np.zeros(self.n)
        bmap = space.boundary_node_map()
        lam_nu = params.viscosity / params.fluid_rho
        wall_ids = []
        for bid, typ in params.spalart_allmaras_model_bcs.items():
            if bid not in bmap:
                continue
            nodes = bmap[bid]
            dmask[nodes] = True
            dvals[nodes] = 0.0 if typ == 0 else 5.0 * lam_nu
            if typ == 0:
                wall_ids.append(bid)
        hidx, hw, hmask = SystemSpace([(space, 1)]).hanging_tables()
        self._base_dirichlet = t(dmask, torch.bool)
        self._base_values = t(dvals)
        self._accum_mask = torch.zeros(self.n, dtype=torch.bool, device=dev)
        self._step_zero = None
        self._step_nonzero = None
        self.zero_constraints = Constraints(self.n, hidx, hw, hmask,
                                            dirichlet_mask=dmask, device=dev)
        self.nonzero_constraints = Constraints(
            self.n, hidx, hw, hmask, dirichlet_mask=dmask,
            dirichlet_values=dvals, device=dev)

        # fixed wall distance: min distance from each support point to the
        # wall boundary vertex cloud, on the device
        self._node_points = t(space.node_points)
        if wall_ids:
            wnodes = space.boundary_nodes(wall_ids)
            # the reference uses only mesh VERTICES of wall faces
            wall_pts = t(fluid.mesh.vertices[
                np.asarray([n for n in wnodes if n < fluid.mesh.n_vertices])])
            self.fixed_wall_distance = torch.linalg.vector_norm(
                self._node_points[:, None, :] - wall_pts[None, :, :],
                dim=-1).amin(dim=1)
        else:
            self.fixed_wall_distance = torch.full((self.n,), 1e10,
                                                  dtype=rdt, device=dev)
        self.moving_wall_distance = torch.full((self.n,), np.inf,
                                               dtype=rdt, device=dev)
        self.y_plus = torch.zeros(self.n, dtype=rdt, device=dev)

        # initial condition: coeff * laminar nu with zero-constraint rows
        # zeroed; the inflow value enters as the first step's constraint
        # increment (reference: source/mpi_spalart_allmaras.cpp:559-565)
        ic = params.spalart_allmaras_initial_condition_coefficient * lam_nu
        self.present_solution = self.zero_constraints.distribute(
            torch.full((self.n,), ic, dtype=rdt, device=dev))
        self.update_eddy_viscosity()

        # the kernel's persistent table (int32; its gather plan is built
        # once) and the same table for gathers and scatters
        self.cell_dofs = t(space.cell_dofs, index_dtype)
        self._cell_nodes = t(space.cell_dofs, torch.int64)
        self.Nq = t(fluid.cv_u.N)
        self.gq = t(fluid.cv_u.grad)
        self.JxW = t(fluid.cv_u.JxW)
        # the compiled iteration of the JAX package is the plain method
        self._newton_iter = self._newton_iter_impl

    # ------------------------------------------------------------------
    def _assemble(self, eval_pt, present, fluid_solution, wall_d,
                  indicator):
        """SA Newton matrix + rhs, f64
        (reference: source/mpi_spalart_allmaras.cpp:619-860)."""
        fluid = self.fluid
        params = self.params
        d = fluid.dim
        dt = fluid.time.get_delta_t()
        N, g, JxW = self.Nq, self.gq, self.JxW
        cd = self._cell_nodes

        lam_nu_f = params.viscosity / params.fluid_rho
        lam_nu_s = 1.0 / params.fluid_rho  # artificial fluid (mu = 1)
        ind = indicator[:, None]
        lam_nu = ind * lam_nu_s + (1 - ind) * lam_nu_f

        u = fluid_solution[:fluid.n_u].reshape(-1, d)
        ul = u[fluid._u_cell_nodes]
        uq = es("ql,cla->cqa", N, ul)
        Gq = es("cqlx,cla->cqax", g, ul)
        # vorticity magnitude |curl u|
        if d == 2:
            S = torch.abs(Gq[..., 1, 0] - Gq[..., 0, 1])
        else:
            wx = Gq[..., 2, 1] - Gq[..., 1, 2]
            wy = Gq[..., 0, 2] - Gq[..., 2, 0]
            wz = Gq[..., 1, 0] - Gq[..., 0, 1]
            S = torch.sqrt(wx ** 2 + wy ** 2 + wz ** 2)

        nu_p = es("ql,cl->cq", N, present[cd])       # nu~ at t_n
        nu_c = es("ql,cl->cq", N, eval_pt[cd])
        gnu_c = es("cqlx,cl->cqx", g, eval_pt[cd])
        dq = torch.clamp(es("ql,cl->cq", N, wall_d[cd]), min=1e-12)

        chi = nu_p / lam_nu
        ft2 = CT3 * torch.exp(-CT4 * chi * chi)
        fv1 = chi ** 3 / (chi ** 3 + CV1 ** 3)
        fv2 = 1.0 - chi / (1.0 + chi * fv1)
        S_bar = nu_p / (KAPPA ** 2 * dq ** 2) * fv2
        S_tilde = torch.where(
            S_bar >= -CV2 * S, S + S_bar,
            S + S * (CV2 ** 2 * S - CV3 * S_bar) /
            ((CV3 - 2 * CV2) * S - S_bar))
        big = torch.abs(S_tilde) > 1e-8
        r = torch.where(big, torch.clamp(nu_p / (
            torch.where(big, S_tilde, 1.0) * KAPPA ** 2 * dq ** 2),
            max=10.0), 10.0)
        gg = r + CW2 * (r ** 6 - r)
        fw = gg * ((1 + CW3 ** 6) / (gg ** 6 + CW3 ** 6)) ** (1.0 / 6.0)

        pos = nu_p >= 0
        P = torch.where(pos, CB1 * (1 - ft2) * S_tilde, CB1 * (1 - CT3) * S)
        D = torch.where(pos, (CW1 * fw - CB1 / KAPPA ** 2 * ft2) / dq ** 2,
                        -CW1 / dq ** 2)
        fn = torch.where(pos, 1.0, (CN1 + chi ** 3) / (CN1 - chi ** 3))

        diff = lam_nu + fn * nu_p
        ugj = es("cqa,cqja->cqj", uq, g)             # u . grad N_j

        # the mass-like terms share N_i N_j: one weight per q point
        w_nn = JxW / dt - JxW * P + 2 * JxW * D * nu_c
        A = (es("cq,qi,qj->cij", w_nn, N, N)
             + es("cq,qi,cqj->cij", JxW, N, ugj)
             + es("cq,cqix,cqjx->cij", JxW * diff / SIGMA, g, g)
             - (2 * CB2 / SIGMA) * es(
                 "qi,cqj->cij", N, es("cq,cqjx,cqx->cqj", JxW, g, gnu_c)))

        ug_nu = es("cqa,cqa->cq", uq, gnu_c)
        res = (nu_c - nu_p) / dt + ug_nu - P * nu_c + D * nu_c * nu_c
        r_i = -(es("cq,qi->ci", JxW * res, N)
                + es("cq,cqix,cqx->ci", JxW * diff / SIGMA, g, gnu_c)
                - (CB2 / SIGMA) * es(
                    "cq,qi->ci", JxW * es("cqx,cqx->cq", gnu_c, gnu_c), N))
        rhs = scatter_add(self.n, cd, r_i)
        return A, rhs

    def _newton_iter_impl(self, eval_pt, present, fluid_solution, wall_d,
                          indicator, cons):
        """One Newton iteration: assemble, condense, Jacobi-preconditioned
        FGMRES.  Returns (du, res_norm, fgmres_iters)."""
        A_loc, rhs = self._assemble(eval_pt, present, fluid_solution, wall_d,
                                    indicator)
        b = cons.condense_rhs(rhs)
        res_norm = torch.linalg.vector_norm(b).item()
        op = cons.wrap_operator(
            lambda x: element_matvec(A_loc, self.cell_dofs, self.n, x))
        diag = torch.where(cons.fixed, 1.0,
                           element_diag(A_loc, self._cell_nodes, self.n))
        dinv = torch.where(diag != 0, 1.0 / diag, 1.0)
        res = fgmres(op, b, M=lambda r_: r_ * dinv,
                     atol=max(1e-8 * res_norm, 1e-12),
                     restart=self.outer_restart,
                     max_restarts=self.outer_max_restarts)
        self.krylov_iters["fgmres"] += res.iters
        return cons.distribute(res.x), res_norm, res.iters

    def _newton_loop(self, eval_pt, present, fluid_solution, wall_d,
                     indicator, cons, verbose=False):
        """The Newton loop of one SA step from `eval_pt`: while the
        residual relative to the first is above fluid_tolerance and above
        1e-14, at most fluid_max_iterations times.  Returns (eval_pt,
        rel_res, newton_iters, last residual norm)."""
        params = self.params
        current_res = initial_res = rel = 1.0
        it = 0
        while rel > params.fluid_tolerance and current_res > 1e-14:
            if it >= params.fluid_max_iterations:
                break
            du, current_res, iters = self._newton_iter(
                eval_pt, present, fluid_solution, wall_d, indicator, cons)
            eval_pt = eval_pt + du
            if it == 0:
                initial_res = max(current_res, 1e-300)
            rel = current_res / initial_res
            if verbose:
                print(f" SA ITR = {it} ABS_RES = {current_res:.6e} "
                      f"GMRES_ITR = {iters}")
            it += 1
        return eval_pt, rel, it, current_res

    # ------------------------------------------------------------------
    def run_one_step(self, apply_nonzero_constraints: bool,
                     verbose: bool = False):
        """Newton loop (reference: source/mpi_spalart_allmaras.cpp:282-345).
        Couples to the fluid's present solution and indicator field."""
        fluid = self.fluid
        wall_d = torch.minimum(self.fixed_wall_distance,
                               self.moving_wall_distance)
        zero_cons = self._step_zero if self._step_zero is not None \
            else self.zero_constraints
        nonzero_cons = self._step_nonzero if self._step_nonzero is not None \
            else self.nonzero_constraints
        eval_pt = self.present_solution
        if apply_nonzero_constraints:
            eval_pt = nonzero_cons.apply_increment(eval_pt)
        eval_pt, rel, it, res = self._newton_loop(
            eval_pt, self.present_solution, fluid.present_solution, wall_d,
            fluid.indicator, zero_cons, verbose)
        if rel > self.params.fluid_tolerance and res > 1e-14:
            raise RuntimeError("Too many Newton iterations!")
        self.newton_iters = it
        self.present_solution = eval_pt
        self.update_eddy_viscosity()

    def make_device_step(self):
        """One SA time step (Newton loop + eddy-viscosity update) for
        STANDALONE runs (static wall distances, constraints and indicator;
        the FSI wall-function path keeps run_one_step, as the moving-wall
        distances update per step there).  Returns fn(nu_present,
        fluid_solution, apply_nonzero) -> (nu_new, eddy_nodal, rel_res,
        newton_iters).  apply_nonzero adds the nonzero-constraint
        inhomogeneity to the evaluation point (deal.II INCREMENT
        semantics), so it must be True exactly once, at the first step of a
        run, as run_one_step(True) then run_one_step(False)."""
        params = self.params
        cons = self.zero_constraints
        nz = self.nonzero_constraints
        wall_d = torch.minimum(self.fixed_wall_distance,
                               self.moving_wall_distance)
        indicator = self.fluid.indicator

        def step(nu, fluid_sol, apply_nonzero):
            e0 = nz.apply_increment(nu) if apply_nonzero else nu
            eval_pt, rel, it, _ = self._newton_loop(e0, nu, fluid_sol,
                                                    wall_d, indicator, cons)
            self.newton_iters = it
            return eval_pt, self._eddy_of(eval_pt), rel, it

        return step

    def _eddy_of(self, nu):
        """mu_t = rho f_v1 nu~."""
        params = self.params
        chi = nu / (params.viscosity / params.fluid_rho)
        fv1 = chi ** 3 / (chi ** 3 + CV1 ** 3)
        return fv1 * nu * params.fluid_rho

    def update_eddy_viscosity(self):
        """mu_t = rho f_v1 nu~, fed back into the fluid solver
        (reference: source/mpi_spalart_allmaras.cpp:891-914)."""
        self.eddy_viscosity_nodal = self._eddy_of(self.present_solution)
        self.fluid.eddy_viscosity_nodal = self.eddy_viscosity_nodal

    # ------------------------------------------------------------------
    # FSI wall-function machinery
    # ------------------------------------------------------------------
    def get_shear_velocity(self, vel, init_guess):
        """Shear velocity u_tau from the analytic wall-velocity profile by
        Newton iteration, vectorized over points (reference:
        source/mpi_spalart_allmaras.cpp:217-280).  A fixed number of
        masked iterations: a converged entry is frozen, so the values are
        those of the reference's loop that stops once all converged."""
        params = self.params
        vel = torch.atleast_1d(vel)
        init = torch.broadcast_to(torch.as_tensor(init_guess,
                                                  dtype=vel.dtype,
                                                  device=vel.device),
                                  vel.shape)
        nu = params.viscosity / params.fluid_rho
        dist = params.wall_function_image_distance
        small = torch.abs(vel) < 1e-10
        # viscous sublayer shortcut (y+ < 5: u+ = y+)
        visc = ~small & (vel * dist / nu < np.sqrt(5.0))
        visc_ut = vel / torch.sqrt(torch.where(visc, vel * dist / nu, 1.0))
        active = ~(small | visc)
        ut = torch.clamp(init, min=5.0 * nu / dist)
        for _ in range(SHEAR_NEWTON_ITERS):
            yp = ut * dist / nu
            up = _u_plus(yp)
            ut_next = ut - (ut * up - vel) / (up + yp * _dup_dyp(yp))
            conv = torch.abs(ut_next - ut) < 1e-2 * torch.abs(ut)
            ut = torch.where(active, ut_next, ut)
            active = active & ~conv
        return torch.where(small, 0.0, torch.where(visc, visc_ut, ut))

    def update_moving_wall_distance(self, vertex_pts, faces,
                                    shear_velocities):
        """FSI hook: per-support-point distance to the DEFORMED solid
        boundary, plus y+ from the nearest point's shear velocity
        (reference: source/mpi_spalart_allmaras.cpp:16-127).

        vertex_pts: (m, d) deformed solid boundary vertex positions;
        faces: (k, nfv) int tensor of indices into vertex_pts (2-D:
        segment endpoints); shear_velocities: (m,) u_tau per boundary
        vertex.  A dense (n_nodes, k + m) distance table."""
        params = self.params
        P, V, ut = self._node_points, vertex_pts, shear_velocities
        nu = params.viscosity / params.fluid_rho

        # vertex-cloud distances (checked AFTER edges in the reference,
        # with strict <, so edges win exact ties: edges come first, and
        # argmin returns the first minimum)
        dv = torch.linalg.vector_norm(P[:, None, :] - V[None, :, :], dim=-1)
        uv = ut[None, :].expand(dv.shape)
        cand_d, cand_u = [dv], [uv]
        if self.fluid.dim == 2 and len(faces):
            A, B = V[faces[:, 0]], V[faces[:, 1]]
            e = B - A                                    # (k, d)
            L2 = torch.clamp((e * e).sum(-1), min=1e-30)
            w = P[:, None, :] - A[None, :, :]            # (n, k, d)
            t = es("nkd,kd->nk", w, e) / L2
            foot = A[None] + t[..., None] * e[None]
            de = torch.linalg.vector_norm(P[:, None, :] - foot, dim=-1)
            de = torch.where((t > 0) & (t < 1), de, np.inf)
            ue = ut[faces[:, 0]][None] + t * (ut[faces[:, 1]] -
                                              ut[faces[:, 0]])[None]
            cand_d, cand_u = [de, dv], [ue, uv]
        D = torch.cat(cand_d, dim=1)
        U = torch.cat(cand_u, dim=1)
        best = torch.argmin(D, dim=1, keepdim=True)
        min_d = torch.gather(D, 1, best)[:, 0]
        best_u = torch.gather(U, 1, best)[:, 0]
        self.moving_wall_distance = min_d
        self.y_plus = min_d * best_u / nu

    def update_boundary_condition(self, first_step: bool):
        """Per-step extra Dirichlet rows (reference:
        source/mpi_spalart_allmaras.cpp:129-215): nu~ set to 0 on dofs of
        fully-covered (indicator == 1) cells and to kappa y+ nu on support
        points within the wall-function distance of the moving wall with
        y+ < 200.  The first touching cell wins (a min-scatter of cell
        ids); the new rows are merged into the accumulated mask, which is
        never rebuilt, as in the reference.  Both constraint sets are
        built on the device."""
        params = self.params
        n = self.n
        cd = self._cell_nodes
        n_c, nl = cd.shape
        ind = (self.fluid.indicator == 1)[:, None].expand(n_c, nl)
        INF = n_c + 1
        cells = torch.arange(n_c, device=self.device)[:, None].expand(n_c,
                                                                      nl)
        flat = cd.reshape(-1)

        def first_touch(mask):
            ids = torch.where(mask, cells, INF).reshape(-1)
            return torch.full((n,), INF, dtype=torch.int64,
                              device=self.device).scatter_reduce(
                0, flat, ids, "amin", include_self=True)

        first_ind = first_touch(ind)
        wall_ok = (self.moving_wall_distance <
                   params.wall_function_effective_distance) & \
            (self.y_plus < 200.0)
        first_wall = torch.where(wall_ok, first_touch(~ind), INF)
        is_ind = (first_ind < INF) & (first_ind < first_wall)
        is_wall = (first_wall < INF) & (first_wall < first_ind)
        new_mask = is_ind | is_wall
        self._accum_mask = self._accum_mask | new_mask

        nu_lam = params.viscosity / params.fluid_rho
        target = torch.where(is_ind, 0.0, KAPPA * self.y_plus * nu_lam)
        zero_mask = self._base_dirichlet | self._accum_mask
        base_vals = self._base_values if first_step else \
            torch.zeros_like(self._base_values)
        vals = torch.where(new_mask, target - self.present_solution,
                           torch.where(self._accum_mask, 0.0, base_vals))
        self._step_zero = self.zero_constraints.with_dirichlet(
            zero_mask, torch.zeros_like(vals))
        self._step_nonzero = self.zero_constraints.with_dirichlet(
            zero_mask, vals)
