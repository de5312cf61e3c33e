"""Explicit slightly-compressible solver (SCnsEX).

Counterpart of openifem_tpu/solvers/fluid/scnsex.py (reference:
include/mpi_scnsex.h, source/mpi_scnsex.cpp).  Velocity and pressure are
decoupled; each fixed-point sweep does two mass+diffusion CG solves
(Jacobi-preconditioned: the systems are mass-dominated):
  (rho M/dt + nu K + rho sigma M) u = rho M u_n/dt - rho (u.grad)u - grad p
                                      + rho(g + bf)              [velocity]
  ((1/dt + sigma) Mp)/atm p = [-cp/cv (atm+p) div u + p_n/dt - u.grad p]/atm
                                                                [pressure]
iterated until the solution increment converges
(reference: source/mpi_scnsex.cpp:429-520).  The constant element
matrices are assembled once (the reference caches its local matrices for
the same reason, include/mpi_scnsex.h:97-107).

Both CG operators are element-block matvecs (la/operators.py), which on a
CUDA device run the hand-written kernel of csrc/element_matvec.cu: this
solver's time stepping runs on nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import index_dtype, real_dtype
from ...la.krylov import cg
from ...la.operators import element_diag, element_matvec, scatter_add
from .base import FluidSolverBase
from .supg import ATM, CP_TO_CV

es = torch.einsum


class SCnsEX(FluidSolverBase):
    cg_maxiter = 2000

    def setup(self):
        super().setup()
        self._precompute()

    def set_sigma_pml_field(self, fn):
        self.sigma_pml_field = fn

    def set_hard_coded_boundary_condition_time(self, bid: int, t_limit):
        """Expire a hard-coded BC after t_limit
        (reference: source/mpi_scnsex.cpp:84-97)."""
        if not hasattr(self, "bc_time_limits"):
            self.bc_time_limits = {}
        self.bc_time_limits[bid] = t_limit

    # ------------------------------------------------------------------
    def _precompute(self):
        params = self.params
        d = self.dim
        cvu, cvp = self.cv_u, self.cv_p
        n_c, n_q, nlu, _ = cvu.grad.shape
        nlp = cvp.N.shape[1]
        self.nlu, self.nlp = nlu, nlp
        rho, mu = params.fluid_rho, params.viscosity
        dt = self.time.get_delta_t()
        t = self._tensor

        self.Nu = t(cvu.N)
        self.Np = t(cvp.N)
        self.gu = t(cvu.grad)
        self.gp = t(cvp.grad)
        self.JxW = t(cvu.JxW)
        self.cell_dofs_u = t(
            (self.u_space.cell_dofs[:, :, None] * d +
             np.arange(d)[None, None, :]).reshape(n_c, -1), index_dtype)
        self.cell_dofs_p = t(self.p_space.cell_dofs, index_dtype)
        self._p_cell_nodes = t(self.p_space.cell_dofs, torch.int64)

        g = np.zeros(d)
        g[:len(params.gravity)] = params.gravity[:d]
        if self.body_force is not None:
            xq = cvu.xq.reshape(-1, d)
            bf = np.asarray(self.body_force(xq)).reshape(n_c, n_q, d)
            self.gravity_q = t(bf + g)
        else:
            self.gravity_q = t(np.broadcast_to(g, (n_c, n_q, d)).copy())

        if getattr(self, "sigma_pml_field", None) is not None:
            xq = cvu.xq.reshape(-1, d)
            s = np.asarray(self.sigma_pml_field(xq)).reshape(n_c, n_q)
            sig = t(s)
        else:
            sig = torch.zeros((n_c, n_q), dtype=real_dtype(),
                              device=self.device)
        self.sigma_pml_q = sig

        I = torch.eye(d, dtype=real_dtype(), device=self.device)
        gg = es("cqlx,cqmx,cq->clm", self.gu, self.gu, self.JxW)
        NNs = es("cq,ql,qm->clm", (rho / dt + rho * sig) * self.JxW,
                 self.Nu, self.Nu)
        self.Av_loc = es("clm,ab->clamb", mu * gg + NNs, I).reshape(
            n_c, nlu * d, nlu * d)
        self.Ap_loc = es("cq,qn,qo->cno",
                         (1.0 / dt + sig) / ATM * self.JxW, self.Np,
                         self.Np)

        ucons, pcons = self.u_constraints, self.p_constraints
        # raw (uncondensed) application, also for the Dirichlet lift
        self._raw_v = lambda x: element_matvec(
            self.Av_loc, self.cell_dofs_u, self.n_u, x)
        self._op_v = ucons.wrap_operator(self._raw_v)
        dv = torch.where(ucons.fixed, 1.0, element_diag(
            self.Av_loc, self.cell_dofs_u, self.n_u))
        self._dinv_v = torch.where(dv != 0, 1.0 / dv, 1.0)
        self._op_p = pcons.wrap_operator(lambda x: element_matvec(
            self.Ap_loc, self.cell_dofs_p, self.n_p, x))
        dp = torch.where(pcons.fixed, 1.0, element_diag(
            self.Ap_loc, self.cell_dofs_p, self.n_p))
        self._dinv_p = torch.where(dp != 0, 1.0 / dp, 1.0)

        self._neumann_rhs_u = self._neumann_rhs_velocity()
        # the compiled sweep of the JAX package is the plain method here
        self._iterate = self._iterate_impl
        # CG iterations of the velocity and pressure solves, and sweeps
        self.krylov_iters = {"vel": 0, "pre": 0, "sweeps": 0}

    def _neumann_rhs_velocity(self):
        params = self.params
        fv = self.fv_u
        rhs = np.zeros(self.n_u)
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
            dofs = (self.u_space.cell_dofs[c][:, None] * self.dim +
                    np.arange(self.dim)[None, :]).reshape(-1)
            np.add.at(rhs, dofs, rl.reshape(-1))
        return self._tensor(rhs)

    # ------------------------------------------------------------------
    def _iterate_impl(self, eval_pt, present, bc_vals_u):
        """One velocity+pressure fixed-point sweep; returns (new solution,
        velocity CG iterations, pressure CG iterations)."""
        params = self.params
        d = self.dim
        rho = params.fluid_rho
        dt = self.time.get_delta_t()
        Nu, Np, gu, gp, JxW = self.Nu, self.Np, self.gu, self.gp, self.JxW
        ucons, pcons = self.u_constraints, self.p_constraints
        u_nodes, p_nodes = self._u_cell_nodes, self._p_cell_nodes

        ul = eval_pt[:self.n_u].reshape(-1, d)[u_nodes]
        pl = eval_pt[self.n_u:][p_nodes]
        unl = present[:self.n_u].reshape(-1, d)[u_nodes]
        pnl = present[self.n_u:][p_nodes]
        uc = es("ql,cla->cqa", Nu, ul)
        G = es("cqlx,cla->cqax", gu, ul)
        gpc = es("cqnx,cn->cqx", gp, pl)
        un = es("ql,cla->cqa", Nu, unl)
        pn = es("qn,cn->cq", Np, pnl)
        Gu = es("cqax,cqx->cqa", G, uc)

        # velocity rhs
        r_u = (rho * es("cq,ql,cqa->cla", JxW / dt, Nu, un)
               - rho * es("cq,ql,cqa->cla", JxW, Nu, Gu)
               - es("cq,ql,cqa->cla", JxW, Nu, gpc)
               + rho * es("cq,ql,cqa->cla", JxW, Nu, self.gravity_q))
        rhs_u = scatter_add(self.n_u, self.cell_dofs_u,
                            r_u.reshape(r_u.shape[0], -1))
        rhs_u = rhs_u + self._neumann_rhs_u
        # Dirichlet lift: solve for the interior with BC values imposed
        gvec = torch.where(ucons.dirichlet, bc_vals_u, 0.0)
        b = ucons.condense_rhs(rhs_u - self._raw_v(gvec))
        res_v = cg(self._op_v, b, M=lambda r: r * self._dinv_v,
                   atol=1e-6 * torch.linalg.vector_norm(b),
                   maxiter=self.cg_maxiter)
        u_new = ucons.distribute_with_values(res_v.x, bc_vals_u)

        # pressure rhs (using the JUST UPDATED velocity: the reference,
        # :475-481, solves the velocity, then assembles the pressure at
        # the new u)
        ul2 = u_new.reshape(-1, d)[u_nodes]
        uc2 = es("ql,cla->cqa", Nu, ul2)
        G2 = es("cqlx,cla->cqax", gu, ul2)
        divu2 = torch.diagonal(G2, dim1=2, dim2=3).sum(-1)
        pc = es("qn,cn->cq", Np, pl)
        r_p = (-es("cq,qn->cn", CP_TO_CV * (ATM + pc) * divu2 / ATM * JxW,
                   Np)
               + es("cq,qn->cn", pn / dt / ATM * JxW, Np)
               - es("cq,qn->cn", es("cqx,cqx->cq", uc2, gpc) / ATM * JxW,
                    Np))
        rhs_p = scatter_add(self.n_p, self.cell_dofs_p, r_p)
        bp = pcons.condense_rhs(rhs_p)
        res_p = cg(self._op_p, bp, M=lambda r: r * self._dinv_p,
                   atol=1e-6 * torch.linalg.vector_norm(bp),
                   maxiter=self.cg_maxiter)
        p_new = pcons.distribute(res_p.x)

        counts = self.krylov_iters
        counts["vel"] += res_v.iters
        counts["pre"] += res_p.iters
        counts["sweeps"] += 1
        return torch.cat([u_new, p_new]), res_v.iters, res_p.iters

    # ------------------------------------------------------------------
    def run_one_step(self, apply_nonzero_constraints: bool = True,
                     assemble_system: bool = True, verbose: bool = True):
        params = self.params
        self.time.increment()
        if verbose:
            print(f"*** Time step = {self.time.get_timestep()}, "
                  f"at t = {self.time.current():.6e}")

        bc_vals_u = self.nonzero_constraints.dirichlet_values[:self.n_u]
        eval_pt = self.present_solution
        last = None
        current_res = 1.0
        initial_res = 1.0
        rel_res = 1.0
        it = 0
        norm = torch.linalg.vector_norm
        while rel_res > params.fluid_tolerance and current_res > 1e-12:
            if it >= params.fluid_max_iterations:
                raise RuntimeError("Too many iterations!")
            new_sol, it_v, it_p = self._iterate(
                eval_pt, self.present_solution, bc_vals_u)
            if last is not None:
                current_res = norm(new_sol - last).item()
            if it == 0:
                initial_res = max(norm(new_sol).item(), 1e-300)
                current_res = norm(new_sol).item() \
                    if last is None else current_res
            rel_res = current_res / initial_res
            if verbose:
                print(f" ITR = {it} ABS_RES = {current_res:.6e} "
                      f"REL_RES = {rel_res:.6e} VEL_ITR = {it_v} "
                      f"PRE_ITR = {it_p}")
            last = new_sol
            eval_pt = new_sol
            it += 1
        self.sweeps = it
        self.solution_increment = eval_pt - self.present_solution
        self.present_solution = eval_pt
        self.update_stress()
        # reference: source/mpi_scnsex.cpp:505-519
        self._end_of_step_io()

    def bc_value_table(self, n_steps: int):
        """Per-step Dirichlet velocity values for the next n_steps,
        replicating run()'s loop exactly: per-boundary BC expiry checked
        against the running time, then the BC clock advance + constraint
        rebuild (reference: source/mpi_scnsex.cpp:540-596).  Expiry only
        changes VALUES (the Dirichlet mask is static), so one table
        covers the whole window (and, like the reference, an expired BC
        keeps its last rebuilt values until another rebuild happens).
        Mutates the solver's bc state exactly as running n_steps of run()
        would; call right before make_on_device_stepper."""
        dt = self.time.get_delta_t()
        limits = getattr(self, "bc_time_limits", {})
        t = self.time.current()
        vals = []
        for _ in range(n_steps):
            for bid in list(limits):
                if limits[bid] < t:
                    self.hard_coded_bcs.pop(bid, None)
                    limits.pop(bid)
            if self.hard_coded_bcs:
                self.bc_time += dt
                self._make_constraints()
            vals.append(
                self.nonzero_constraints.dirichlet_values[:self.n_u])
            t += dt
        return torch.stack(vals)

    def make_on_device_stepper(self, bc_values_u):
        """Explicit time stepping without the host path's bookkeeping:
        the velocity/pressure fixed-point sweeps of every step, with the
        stopping rules of the JAX package's fused stepper, run eagerly.

        bc_values_u: (n_steps, n_u) table from bc_value_table.  Returns
        fn(present, n_steps) -> (present, max_rel_res, max_sweeps).

        The JAX package compiles the window into one dispatch; here every
        CG iteration still ends in a host synchronisation
        (la/krylov.py)."""
        params = self.params
        tol = params.fluid_tolerance
        max_it = params.fluid_max_iterations
        norm = torch.linalg.vector_norm

        def one_step(present, bc_vals):
            sol, _, _ = self._iterate_impl(present, present, bc_vals)
            init = max(norm(sol).item(), 1e-300)
            it, cur = 1, init
            while cur / init > tol and cur > 1e-12 and it < max_it:
                new, _, _ = self._iterate_impl(sol, present, bc_vals)
                it, cur, sol = it + 1, norm(new - sol).item(), new
            return sol, cur / init, it

        def run_n(present, n_steps):
            worst_rel, worst_it = 0.0, 0
            for i in range(int(n_steps)):
                present, rel, it = one_step(present, bc_values_u[i])
                worst_rel, worst_it = max(worst_rel, rel), max(worst_it, it)
            return present, worst_rel, worst_it

        return run_n

    def _refine_and_setup(self):
        if self.hard_coded_bcs:
            self.bc_time += self.time.get_delta_t()
        self.mesh = self.mesh.refine_global(
            self.params.global_refinements[0])
        self.setup()

    def run_on_device(self, verbose: bool = True):
        """run() with all steps through make_on_device_stepper; the
        per-step VTU/PVD/checkpoint writes of run_one_step are skipped
        (only the final state is kept) and solution_increment holds the
        whole-window delta.  The production / benchmark path for
        standalone SCnsEX runs."""
        if not self._setup_done:
            self._refine_and_setup()
        dt = self.time.get_delta_t()
        n = int(round((self.time.end() - self.time.current()) / dt))
        if n <= 0:
            return
        table = self.bc_value_table(n)
        stepper = self.make_on_device_stepper(table)
        sol, rel, its = stepper(self.present_solution, n)
        if rel > self.params.fluid_tolerance:
            raise RuntimeError("Too many iterations!")
        self.solution_increment = sol - self.present_solution
        self.present_solution = sol
        self.sweeps = its
        for _ in range(n):
            self.time.increment()
        self.update_stress()
        if verbose:
            print(f"run_on_device: {n} steps, worst rel_res "
                  f"{rel:.3e}, max fixed-point iters {its}")

    def run(self, verbose: bool = True):
        """reference: source/mpi_scnsex.cpp:540-596.  Note the BC clock is
        advanced once before setup AND once per loop iteration, so the
        first step sees t_bc = 2*dt (replicating the reference exactly)."""
        if not self._setup_done:
            self._refine_and_setup()
        limits = getattr(self, "bc_time_limits", {})
        while self.time.end() - self.time.current() > 1e-12:
            for bid in list(limits):
                if limits[bid] < self.time.current():
                    self.hard_coded_bcs.pop(bid, None)
                    limits.pop(bid)
            if self.hard_coded_bcs:
                self.bc_time += self.time.get_delta_t()
                self._make_constraints()
            self.run_one_step(True, verbose=verbose)
