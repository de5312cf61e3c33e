"""Fluid solver base: Taylor-Hood spaces, BCs, stress projection.

Counterpart of openifem_tpu/solvers/fluid/base.py (reference:
include/fluid_solver.h:63-171, source/fluid_solver.cpp).  Global dof
vector = [u (node-major, component fastest), p]; deal.II's block
renumbering becomes two index ranges of one flat vector.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ...config import device as _device
from ...config import real_dtype
from ...fe.fevalues import cell_values, face_values
from ...fe.shapes import gauss_quadrature
from ...fe.space import FESpace, SystemSpace
from ...la.constraints import Constraints
from ...parameters import (AllParameters, component_flag_to_mask,
                           component_flag_values)
from ...utils.timectl import Time


def _whole(y):
    """The cell reduce of a solver that holds every cell: the identity
    (parallel/shard.py gives a rank its sum over the ranks)."""
    return y


class FluidSolverBase:
    # Newton-target-aware forcing for the outer FGMRES (see the JAX
    # package, openifem_tpu/solvers/fluid/base.py).  None keeps the
    # reference-parity tolerance atol = max(1e-8 ||rhs||, 1e-10); a pair
    # (eta, theta) solves each Newton system only to
    #   atol = max(eta * ||r_k||, theta * fluid_tolerance * ||r_0||)
    # and skips the solve of an already converged iterate.
    newton_forcing = None
    # run the outer FGMRES in f32 (combine with f32_matrix); the f64
    # assembled residual still gates Newton convergence, and the solve
    # tolerance is clamped to the f32-achievable floor
    f32_outer = False
    f32_outer_floor = 2e-6

    def _outer_solve(self, op, b, precond, atol):
        """Dispatch the outer FGMRES, optionally with an f32 Krylov basis
        (f32_outer).  Returns (x_in_b_dtype, iters, residual)."""
        from ...la.krylov import fgmres
        if self.f32_outer:
            atol = max(float(atol), self.f32_outer_floor *
                       torch.linalg.vector_norm(b).item())
            op32 = lambda x: op(x).to(torch.float32)  # noqa: E731
            res = fgmres(op32, b.to(torch.float32), M=precond, atol=atol,
                         restart=self.outer_restart,
                         max_restarts=self.outer_max_restarts)
            return res.x.to(b.dtype), res.iters, res.residual
        res = fgmres(op, b, M=precond, atol=atol,
                     restart=self.outer_restart,
                     max_restarts=self.outer_max_restarts)
        return res.x, res.iters, res.residual

    def _outer_atol(self, res_norm: float, res0, parity_atol: float):
        """Outer-FGMRES absolute tolerance for one Newton iteration.
        res0: the step's initial nonlinear residual, or None / non-finite
        when unknown (first iteration of a step)."""
        if self.newton_forcing is None:
            return parity_atol
        eta, theta = self.newton_forcing
        tol = self.params.fluid_tolerance
        r0 = res_norm if res0 is None or not math.isfinite(res0) else res0
        atol = max(eta * res_norm, theta * tol * r0, 1e-10)
        if res_norm <= max(tol * r0, 1e-11):
            return math.inf
        return atol

    def _run_newton(self, eval_pt, newton_once, floor: float):
        """The Newton loop of one time step from `eval_pt`, with the
        stopping rules of the JAX package's fused steps (make_fsi_step,
        make_on_device_stepper of insim.py and supg.py), run eagerly.
        newton_once(eval_pt, res0) -> (next eval_pt, residual norm, outer
        Krylov iterations); res0 is None on the first iteration.  Iterates
        while res / res0 > fluid_tolerance and res > floor, at most
        fluid_max_iterations times, and not stagnated.  Returns (eval_pt,
        rel_res, newton_iters); rel_res is 0 where res0 <= floor or on
        stagnation."""
        tol = self.params.fluid_tolerance
        max_it = self.params.fluid_max_iterations

        def stagnated(res, prev, last_its):
            # a 0-iteration Krylov solve with a non-decreasing residual
            # is machine-level stagnation -> treat as converged
            return last_its == 0 and res >= prev * (1 - 1e-12)

        eval_pt, res0, last_its = newton_once(eval_pt, None)
        it, res, prev = 1, res0, math.inf
        while (res / max(res0, 1e-300) > tol and res > floor and
               it < max_it and not stagnated(res, prev, last_its)):
            eval_pt, rn, last_its = newton_once(eval_pt, res0)
            it, prev, res = it + 1, res, rn
        rel = res / max(res0, 1e-300) if res0 > floor else 0.0
        if stagnated(res, prev, last_its):
            rel = 0.0
        return eval_pt, rel, it

    def __init__(self, mesh, params: AllParameters,
                 bc: Optional[Callable] = None, device=None):
        """bc: hard-coded boundary-value function f(points (n,dim), component)
        -> (n,) used when params.use_hard_coded_values (reference:
        source/fluid_solver.cpp:132-143).  device: torch device of the
        solver state (default config.device(): "cuda" unless
        OPENIFEM_DEVICE says otherwise)."""
        self.mesh = mesh
        self.params = params
        self.dim = mesh.dim
        self.boundary_values = bc
        self.device = _device(device)
        self.time = Time(params.end_time, params.time_step,
                         params.output_interval, params.refinement_interval,
                         params.save_interval)
        from ...utils.timer import Timer
        self.timer = Timer(type(self).__name__)
        self._setup_done = False
        self.body_force = None          # set_body_force analog
        self.initial_condition = None   # set_initial_condition analog
        # time-dependent hard-coded BCs: bid -> fn(points, component, time)
        self.hard_coded_bcs = {}
        self.bc_time = 0.0

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype if dtype is not None
                               else real_dtype())

    def add_hard_coded_boundary_condition(self, bid: int, fn):
        self.hard_coded_bcs[bid] = fn

    def set_body_force(self, fn: Callable):
        """fn(points (n,dim)) -> (n,dim) body acceleration."""
        self.body_force = fn

    def set_initial_condition(self, fn: Callable):
        """fn(points (n,dim), component) -> (n,) initial field values
        (reference: source/mpi_fluid_solver.cpp:105-113)."""
        self.initial_condition = fn

    # ------------------------------------------------------------------
    def setup(self):
        params, mesh = self.params, self.mesh
        dim = self.dim
        vdeg = params.fluid_velocity_degree
        pdeg = params.fluid_pressure_degree
        self.u_space = FESpace(mesh, vdeg)
        self.p_space = FESpace(mesh, pdeg)
        self.sys = SystemSpace([(self.u_space, dim), (self.p_space, 1)])
        self.n_dofs = self.sys.n_dofs
        self.n_u = self.u_space.n_nodes * dim
        self.n_p = self.p_space.n_nodes

        nq = vdeg + 1
        self.cv_u = cell_values(self.u_space, nq)
        self.cv_p = cell_values(self.p_space, nq)
        self.fv_u = face_values(self.u_space, nq)

        self._make_constraints()
        self._setup_stress_projection()

        rdt, dev = real_dtype(), self.device
        self.present_solution = torch.zeros(self.n_dofs, dtype=rdt,
                                            device=dev)
        self.solution_increment = torch.zeros_like(self.present_solution)
        if self.initial_condition is not None:
            self._apply_initial_condition()

        n_c = mesh.n_cells
        self.indicator = torch.zeros(n_c, dtype=rdt, device=dev)
        self.fsi_acceleration = torch.zeros((n_c, dim), dtype=rdt,
                                            device=dev)
        self.fsi_stress_cell = torch.zeros((n_c, dim, dim), dtype=rdt,
                                           device=dev)
        # MPI-style nodal FSI fields (reference:
        # include/mpi_fluid_solver.h:208-212)
        self.fsi_acc_nodal = torch.zeros((self.u_space.n_nodes, dim),
                                         dtype=rdt, device=dev)
        self.fsi_stress_nodal = torch.zeros(
            (self.u_space.n_nodes, dim, dim), dtype=rdt, device=dev)
        # nodal viscous stress, device-resident (n_scalar_nodes, dim, dim)
        self.stress_device = torch.zeros((self.u_space.n_nodes, dim, dim),
                                         dtype=rdt, device=dev)
        self._setup_done = True

    # ------------------------------------------------------------------
    def _make_constraints(self):
        """Dirichlet constraint masks + values on the velocity block
        (reference: source/fluid_solver.cpp:66-163)."""
        params, dim = self.params, self.dim
        dmask = np.zeros(self.n_dofs, dtype=bool)
        dvals = np.zeros(self.n_dofs)
        bmap = self.u_space.boundary_node_map()
        # deal.II's AffineConstraints keeps the FIRST constraint added for a
        # dof; boundaries are processed in ascending id order, so at corner
        # nodes the lower boundary id wins.
        for bid in sorted(params.fluid_dirichlet_bcs):
            flag, vals = params.fluid_dirichlet_bcs[bid]
            if bid not in bmap:
                continue
            nodes = bmap[bid]
            mask = component_flag_to_mask(flag, dim)
            per_axis = component_flag_values(flag, vals, dim)
            pts = self.u_space.node_points[nodes]
            for d in range(dim):
                if not mask[d]:
                    continue
                gd = nodes * dim + d
                fresh = ~dmask[gd]
                if params.use_hard_coded_values and bid in self.hard_coded_bcs:
                    v = np.asarray(self.hard_coded_bcs[bid](pts, d,
                                                            self.bc_time))
                elif params.use_hard_coded_values and \
                        self.boundary_values is not None:
                    v = np.asarray(self.boundary_values(pts, d))
                else:
                    v = np.full(len(nodes), per_axis[d])
                dvals[gd[fresh]] = v[fresh]
                dmask[gd] = True
        dev = self.device
        hidx, hw, hmask = self.sys.hanging_tables()
        self.zero_constraints = Constraints(self.n_dofs, hidx, hw, hmask,
                                            dirichlet_mask=dmask, device=dev)
        self.nonzero_constraints = Constraints(
            self.n_dofs, hidx, hw, hmask, dirichlet_mask=dmask,
            dirichlet_values=dvals, device=dev)
        # per-block constraints for the Schur preconditioner sub-operators
        usys = SystemSpace([(self.u_space, self.dim)])
        uh_idx, uh_w, uh_mask = usys.hanging_tables()
        self.u_constraints = Constraints(self.n_u, uh_idx, uh_w, uh_mask,
                                         dirichlet_mask=dmask[:self.n_u],
                                         device=dev)
        psys = SystemSpace([(self.p_space, 1)])
        ph_idx, ph_w, ph_mask = psys.hanging_tables()
        self.p_constraints = Constraints(self.n_p, ph_idx, ph_w, ph_mask,
                                         device=dev)

    def _u_cons_of(self, cons):
        """Velocity-block constraints matching a (possibly FSI-extended)
        full-vector constraint set."""
        if cons is self.zero_constraints:
            return self.u_constraints
        return self.u_constraints.with_extra_dirichlet(
            cons.dirichlet[:self.n_u],
            torch.zeros(self.n_u, dtype=real_dtype(), device=self.device))

    def _apply_initial_condition(self):
        """reference: source/mpi_fluid_solver.cpp:367-414."""
        x = np.zeros(self.n_dofs)
        for d in range(self.dim):
            x[d:self.n_u:self.dim] = np.asarray(
                self.initial_condition(self.u_space.node_points, d))
        x[self.n_u:] = np.asarray(
            self.initial_condition(self.p_space.node_points, self.dim))
        self.present_solution = self._tensor(x)

    # ------------------------------------------------------------------
    def _setup_stress_projection(self):
        k = self.params.fluid_velocity_degree
        qp, qw = gauss_quadrature(k + 1, self.dim)
        N, _ = self.u_space.shapes.evaluate(qp)
        Mref = np.einsum("qi,qj,q->ij", N, N, qw)
        Q = (N * qw[:, None]).T
        self.qpt_to_dof = np.linalg.solve(Mref, Q)
        counts = np.zeros(self.u_space.n_nodes)
        np.add.at(counts, self.u_space.cell_dofs.ravel(), 1.0)
        self._scalar_counts = counts
        self._qpt_to_dof_t = self._tensor(self.qpt_to_dof)
        self._scalar_counts_t = self._tensor(counts)
        self._u_cell_nodes = self._tensor(self.u_space.cell_dofs,
                                          torch.int64)
        self._cv_u_grad = self._tensor(self.cv_u.grad)

    def velocity_gradients(self, solution):
        """(n_c, n_q, dim, dim) velocity gradients at volume q points."""
        d = self.dim
        ul = solution[:self.n_u].reshape(-1, d)[self._u_cell_nodes]
        return torch.einsum("cqlx,cla->cqax", self._cv_u_grad, ul)

    def _update_stress_impl(self, solution):
        mu = self.params.viscosity
        gradv = self.velocity_gradients(solution)
        tau = mu * (gradv + gradv.transpose(2, 3))
        # project each component
        cellwise = torch.einsum("iq,cqab->ciab", self._qpt_to_dof_t, tau)
        d = self.dim
        out = torch.zeros((self.u_space.n_nodes, d, d), dtype=tau.dtype,
                          device=tau.device)
        out.index_add_(0, self._u_cell_nodes.reshape(-1),
                       cellwise.reshape(-1, d, d))
        return out / self._scalar_counts_t[:, None, None]

    def update_stress(self):
        """Nodal viscous stress tau = 2 mu grad^s(v), projected
        quadrature->nodes and averaged (reference:
        source/fluid_solver.cpp:324-414)."""
        self.stress_device = self._update_stress_impl(self.present_solution)

    @property
    def stress(self):
        return self.stress_device.cpu().numpy().transpose(1, 2, 0)

    def get_current_solution(self):
        return self.present_solution

    # ------------------------------------------------------------------
    def refine_mesh(self, min_level: int, max_level: int,
                    verbose: bool = False):
        """Kelly-driven standalone AMR with solution transfer (reference:
        source/fluid_solver.cpp:215-265,
        refine_and_coarsen_fixed_fraction(0.6, 0.4)).  The indicators and
        flags are computed on the host in float64."""
        from ...fe.kelly import (coarsen_fraction_flags, kelly_estimate,
                                 refine_fraction_flags)
        from ...fe.transfer import transfer_nodal_field
        eta = kelly_estimate(self.u_space, self.present_solution,
                             n_components=self.dim, component_offset=0)
        flags = refine_fraction_flags(eta, 0.6)
        flags &= self.mesh.level < max_level
        cflags = coarsen_fraction_flags(eta, 0.4) & ~flags
        if not flags.any() and not cflags.any():
            return
        old_mesh, old_u, old_p = self.mesh, self.u_space, self.p_space
        old_solution = self.present_solution
        n_u_old = self.n_u
        mesh2, old_to_new = self.mesh.coarsen(cflags, min_level)
        rflags = np.zeros(mesh2.n_cells, dtype=bool)
        rflags[old_to_new[flags]] = True
        self.mesh = mesh2.refine(rflags)
        self.setup()
        if verbose:
            print(f"Kelly refine: {old_mesh.n_cells} -> "
                  f"{self.mesh.n_cells} cells")
        u_new = transfer_nodal_field(
            old_mesh, old_u, old_solution[:n_u_old].reshape(-1, self.dim),
            self.u_space.node_points)
        p_new = transfer_nodal_field(old_mesh, old_p, old_solution[n_u_old:],
                                     self.p_space.node_points)
        self.present_solution = self.nonzero_constraints.distribute(
            torch.cat([u_new.reshape(-1), p_new]))
        self.update_stress()

    _MESH_CKPT_FIELDS = ("vertices", "cells", "material_id", "boundary_id",
                         "face_manifold", "cell_manifold", "level",
                         "tfi_coarse", "tfi_rect", "family", "child_index")

    def save_checkpoint(self, step: Optional[int] = None,
                        prefix: str = "fluid"):
        """reference: source/mpi_fluid_solver.cpp:581-636.  The mesh
        arrays are stored with the solution, so a restart after AMR
        rebuilds the adapted mesh; an attached turbulence model's state
        rides along (reference: source/mpi_spalart_allmaras.cpp:569-591).
        The keys are the JAX package's."""
        from ...io.checkpoint import save_checkpoint
        if step is None:
            step = self.time.get_timestep()
        host = lambda a: a.cpu().numpy()  # noqa: E731
        arrays = {"present_solution": host(self.present_solution),
                  "time_current": self.time.current()}
        for f in self._MESH_CKPT_FIELDS:
            arrays["mesh_" + f] = np.asarray(getattr(self.mesh, f))
        tm = getattr(self, "turbulence_model", None)
        if tm is not None:
            arrays["sa_nu_tilde"] = host(tm.present_solution)
            arrays["sa_moving_wall_distance"] = host(
                tm.moving_wall_distance)
            arrays["sa_y_plus"] = host(tm.y_plus)
            arrays["sa_accum_mask"] = host(tm._accum_mask)
        save_checkpoint(prefix, step, arrays)

    def load_checkpoint(self, prefix: str = "fluid") -> bool:
        """reference: source/mpi_fluid_solver.cpp:638-713.  Rebuilds the
        mesh recorded at save time (its manifold and TFI chart objects,
        whose ids refinement keeps, come from the current mesh), or
        applies the global refinement when the file has no mesh."""
        from ...io.checkpoint import load_latest_checkpoint
        from ...mesh.mesh import Mesh
        data = load_latest_checkpoint(prefix)
        if data is None:
            return False
        if "mesh_vertices" in data:
            kw = {f: data["mesh_" + f] for f in self._MESH_CKPT_FIELDS}
            self.mesh = Mesh(dim=self.dim, manifolds=self.mesh.manifolds,
                             tfi=self.mesh.tfi, **kw)
            self.setup()
        elif not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[0])
            self.setup()
        if data["present_solution"].shape != (self.n_dofs,):
            raise ValueError(
                f"checkpoint '{prefix}' has {data['present_solution'].shape}"
                f" dofs but the mesh yields {self.n_dofs}; the checkpoint "
                "was saved on a different mesh")
        self.present_solution = self._tensor(data["present_solution"])
        tm = getattr(self, "turbulence_model", None)
        if tm is not None and "sa_nu_tilde" in data:
            if not hasattr(tm, "space"):
                tm.setup()
            tm.present_solution = tm._tensor(data["sa_nu_tilde"])
            tm.moving_wall_distance = tm._tensor(
                data["sa_moving_wall_distance"])
            tm.y_plus = tm._tensor(data["sa_y_plus"])
            tm._accum_mask = tm._tensor(data["sa_accum_mask"], torch.bool)
            tm.update_eddy_viscosity()
        while self.time.get_timestep() < data["__step__"]:
            self.time.increment()
        self.update_stress()
        return True

    def output_results(self, step: Optional[int] = None,
                       prefix: str = "fluid"):
        """VTU output with velocity/pressure/indicator/stress
        (reference: source/mpi_fluid_solver.cpp:490-579)."""
        from ...io.vtk import write_vtu
        from ...utils.pvd import PVDWriter
        if step is None:
            step = self.time.get_timestep()
        n_vert = self.mesh.n_vertices
        d = self.dim
        u = self.velocity_part().reshape(-1, d)
        p = self.pressure_part()
        tau = self.stress_device.cpu().numpy()
        point_data = {"velocity": u[:n_vert], "pressure": p[:n_vert]}
        for i in range(d):
            for j in range(i, d):
                point_data[f"tau_{i}{j}"] = tau[:n_vert, i, j]
        # FSI body force and eddy viscosity, when active (reference:
        # source/mpi_fluid_solver.cpp:500-556)
        fsi_acc = self.fsi_acc_nodal.cpu().numpy()
        if np.any(fsi_acc):
            point_data["fsi_force"] = fsi_acc[:n_vert]
        eddy = getattr(self, "eddy_viscosity_nodal", None)
        if eddy is not None:
            point_data["eddy_viscosity"] = eddy.cpu().numpy()[:n_vert]
        write_vtu(f"{prefix}-{step:06d}.vtu", self.mesh,
                  point_data=point_data,
                  cell_data={"indicator": self.indicator.cpu().numpy()})
        if not hasattr(self, "_pvd"):
            self._pvd = PVDWriter(self.time, f"{prefix}.pvd")
        self._pvd.write_current_timestep(f"{prefix}-", 6)

    def _end_of_step_io(self, refine_levels=None):
        """run_one_step epilogue shared by every fluid solver (reference:
        source/mpi_insim.cpp:475-489, source/mpi_supg_solver.cpp:400-424):
        VTU/PVD output at `time_to_output` (also inside FSI runs), and -
        standalone runs only - checkpoint at `time_to_save` and Kelly AMR
        at `time_to_refine` with the given (min, max) levels."""
        standalone = self.params.simulation_type == "Fluid"
        if standalone and self.time.time_to_save():
            self.save_checkpoint()
        if self.time.time_to_output():
            self.output_results()
        if standalone and self.time.time_to_refine():
            if refine_levels is None:
                gr = self.params.global_refinements[0]
                refine_levels = (gr, gr + 3)
            self.refine_mesh(*refine_levels)

    def velocity_part(self, solution=None):
        s = self.present_solution if solution is None else solution
        return s[:self.n_u].cpu().numpy()

    def pressure_part(self, solution=None):
        s = self.present_solution if solution is None else solution
        return s[self.n_u:].cpu().numpy()
