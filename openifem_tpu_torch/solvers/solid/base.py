"""Solid solver base: spaces, constraints, Newmark state, traction RHS.

Counterpart of openifem_tpu/solvers/solid/base.py (reference:
include/solid_solver.h:59-180, source/solid_solver.cpp).  Element data
lives as batched tensors on the solver's device; the time loop runs on the
host, as the reference's Newton loops do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...config import device as _device
from ...config import index_dtype, real_dtype
from ...fe.fevalues import CellValues, FaceValues, cell_values, face_values
from ...fe.shapes import gauss_quadrature
from ...fe.space import FESpace, SystemSpace
from ...la.constraints import Constraints
from ...la.krylov import cg
from ...la.operators import element_matvec
from ...parameters import AllParameters, component_flag_to_mask
from ...utils.timectl import Time


class SolidSolverBase:
    def __init__(self, mesh, params: AllParameters, device=None):
        self.mesh = mesh
        self.params = params
        self.dim = mesh.dim
        self.device = _device(device)
        self.time = Time(params.end_time, params.time_step,
                         params.output_interval, params.refinement_interval,
                         params.save_interval)
        self._setup_done = False

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype if dtype is not None
                               else real_dtype())

    # ------------------------------------------------------------------
    def setup(self):
        """setup_dofs + initialize_system (reference:
        source/solid_solver.cpp:36-122)."""
        params, mesh = self.params, self.mesh
        dim = self.dim
        self.space = FESpace(mesh, params.solid_degree)
        self.sys = SystemSpace([(self.space, dim)])
        self.n_dofs = self.sys.n_dofs
        nq = params.solid_degree + 1
        self.cv: CellValues = cell_values(self.space, nq)
        self.fv: Optional[FaceValues] = face_values(self.space, nq)

        # Dirichlet constraints (homogeneous only; reference:
        # source/solid_solver.cpp:55-84) + hanging nodes
        dmask = np.zeros(self.n_dofs, dtype=bool)
        bmap = self.space.boundary_node_map()
        for bid, flag in params.solid_dirichlet_bcs.items():
            if bid not in bmap:
                continue
            mask = component_flag_to_mask(flag, dim)
            for d in range(dim):
                if mask[d]:
                    dmask[bmap[bid] * dim + d] = True
        hidx, hw, hmask = self.sys.hanging_tables()
        self.constraints = Constraints(self.n_dofs, hidx, hw, hmask,
                                       dirichlet_mask=dmask,
                                       device=self.device)

        z = torch.zeros(self.n_dofs, dtype=real_dtype(), device=self.device)
        self.current_displacement = z
        self.current_velocity = z
        self.current_acceleration = z
        self.previous_displacement = z
        self.previous_velocity = z
        self.previous_acceleration = z

        # FSI traction per boundary-face entry (constant per face)
        if self.fv is not None:
            self.fsi_traction = torch.zeros((len(self.fv.cells), dim),
                                            dtype=real_dtype(),
                                            device=self.device)
            # the hyperelastic solver does not skip Dirichlet faces when
            # applying FSI traction (reference:
            # source/hyper_elasticity.cpp:449)
            skip = getattr(self, "fsi_skip_dirichlet_faces", False)
            mask = np.ones(len(self.fv.cells))
            if skip:
                for i, b in enumerate(np.asarray(self.fv.boundary_id)):
                    if int(b) in params.solid_dirichlet_bcs:
                        mask[i] = 0.0
            self._fsi_face_mask = self._tensor(mask)
            self._fv_N = self._tensor(self.fv.N)
            self._fv_JxW = self._tensor(self.fv.JxW)
            self._face_cell_dofs = self._tensor(
                self.sys.cell_dofs[np.asarray(self.fv.cells)], torch.int64)
        else:
            self.fsi_traction = None

        self._setup_strain_projection()
        self._assemble_constant()
        self._setup_done = True

    # ------------------------------------------------------------------
    def _setup_strain_projection(self):
        """Unit-cell projection matrix quadrature -> nodal dofs (deal.II
        FETools::compute_projection_from_quadrature_points_matrix)."""
        k = self.params.solid_degree
        qp, qw = gauss_quadrature(k + 1, self.dim)
        N, _ = self.space.shapes.evaluate(qp)  # (n_q, nl)
        Mref = np.einsum("qi,qj,q->ij", N, N, qw)
        Q = (N * qw[:, None]).T  # (nl, n_q)
        self.qpt_to_dof = np.linalg.solve(Mref, Q)  # (nl, n_q)
        counts = np.zeros(self.space.n_nodes)
        np.add.at(counts, self.space.cell_dofs.ravel(), 1.0)
        self.scalar_node_counts = counts

    def project_to_nodes(self, quad_field: np.ndarray) -> np.ndarray:
        """(n_c, n_q) quadrature field -> averaged nodal field."""
        cellwise = np.einsum("iq,cq->ci", self.qpt_to_dof, quad_field)
        out = np.zeros(self.space.n_nodes)
        np.add.at(out, self.space.cell_dofs.ravel(), cellwise.ravel())
        return out / self.scalar_node_counts

    # ------------------------------------------------------------------
    def _assemble_constant(self):
        """Subclass hook: precompute constant element matrices."""
        raise NotImplementedError

    def run_one_step(self, first_step: bool):
        raise NotImplementedError

    def run(self):
        """reference: source/solid_solver.cpp:270-283."""
        if not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[1])
            self.setup()
        self.run_one_step(True)
        while self.time.end() - self.time.current() > 1e-12:
            self.run_one_step(False)

    def get_current_solution(self):
        return self.current_displacement

    # ------------------------------------------------------------------
    def output_results(self, step: Optional[int] = None,
                       prefix: str = "solid"):
        """VTU output with displacement/velocity/strain/stress
        (reference: source/solid_solver.cpp:143-206)."""
        from ...io.vtk import write_vtu
        from ...utils.pvd import PVDWriter
        if step is None:
            step = self.time.get_timestep()
        n_vert = self.mesh.n_vertices
        d = self.dim
        u = self.current_displacement.cpu().numpy().reshape(-1, d)
        v = self.current_velocity.cpu().numpy().reshape(-1, d)
        point_data = {"displacements": u[:n_vert], "velocities": v[:n_vert]}
        if hasattr(self, "strain"):
            for i in range(d):
                for j in range(i, d):
                    point_data[f"E{i}{j}"] = self.strain[i][j][:n_vert]
                    point_data[f"S{i}{j}"] = self.stress[i][j][:n_vert]
        write_vtu(f"{prefix}-{step:06d}.vtu", self.mesh,
                  point_data=point_data,
                  cell_data={"material_id":
                             np.asarray(self.mesh.material_id)})
        if not hasattr(self, "_pvd"):
            self._pvd = PVDWriter(self.time, f"{prefix}.pvd")
        self._pvd.write_current_timestep(f"{prefix}-", 6)

    def refine_mesh(self, min_level: int, max_level: int):
        """Kelly AMR on the displacement field with transfer of the
        previous d/v/a (reference: source/solid_solver.cpp:209-268,
        refine_and_coarsen_fixed_fraction(0.6, 0.4)).  The indicators and
        flags are computed on the host in float64."""
        from ...fe.kelly import (coarsen_fraction_flags, kelly_estimate,
                                 refine_fraction_flags)
        from ...fe.transfer import transfer_nodal_field
        d = self.dim
        eta = kelly_estimate(self.space, self.current_displacement,
                             n_components=d, component_offset=0)
        flags = refine_fraction_flags(eta, 0.6)
        flags &= np.asarray(self.mesh.level) < max_level
        cflags = coarsen_fraction_flags(eta, 0.4) & ~flags
        if not flags.any() and not cflags.any():
            return
        old_mesh, old_space = self.mesh, self.space
        old_fields = [v.reshape(-1, d) for v in (
            self.previous_displacement, self.previous_velocity,
            self.previous_acceleration)]
        mesh2, old_to_new = self.mesh.coarsen(cflags, min_level)
        rflags = np.zeros(mesh2.n_cells, dtype=bool)
        rflags[old_to_new[flags]] = True
        self.mesh = mesh2.refine(rflags)
        self.setup()
        new = [self.constraints.distribute(
            transfer_nodal_field(old_mesh, old_space, f,
                                 self.space.node_points).reshape(-1))
            for f in old_fields]
        (self.previous_displacement, self.previous_velocity,
         self.previous_acceleration) = new
        (self.current_displacement, self.current_velocity,
         self.current_acceleration) = new

    def save_checkpoint(self, step: Optional[int] = None,
                        prefix: str = "solid"):
        """reference: source/mpi_shared_solid_solver.cpp:452-505."""
        from ...io.checkpoint import save_checkpoint
        if step is None:
            step = self.time.get_timestep()
        save_checkpoint(prefix, step, {
            "displacement": self.current_displacement.cpu().numpy(),
            "velocity": self.current_velocity.cpu().numpy(),
            "acceleration": self.current_acceleration.cpu().numpy(),
            "time_current": self.time.current(),
        })

    def load_checkpoint(self, prefix: str = "solid") -> bool:
        """reference: source/mpi_shared_solid_solver.cpp:508-571.  Applies
        the solid's global refinement itself when not yet set up."""
        from ...io.checkpoint import load_latest_checkpoint
        data = load_latest_checkpoint(prefix)
        if data is None:
            return False
        if not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[1])
            self.setup()
        if data["displacement"].shape != (self.n_dofs,):
            raise ValueError(
                f"solid checkpoint has {data['displacement'].shape[0]} dofs"
                f" but the mesh has {self.n_dofs}: refinement state "
                "mismatch (was the mesh refined before load_checkpoint?)")
        (self.current_displacement, self.current_velocity,
         self.current_acceleration) = (
            self._tensor(data[k]) for k in ("displacement", "velocity",
                                            "acceleration"))
        self.previous_displacement = self.current_displacement
        self.previous_velocity = self.current_velocity
        self.previous_acceleration = self.current_acceleration
        while self.time.get_timestep() < data["__step__"]:
            self.time.increment()
        return True

    def _end_of_step_io(self, first_step: bool = False,
                        refine_levels=None, guard_refine: bool = True):
        """run_one_step epilogue (reference: source/linear_elasticity.cpp:
        310-320, source/mpi_shared_linear_elasticity.cpp:378-398): output
        at time_to_output (and at the first step), checkpoint at
        time_to_save in standalone runs, Kelly AMR at time_to_refine
        (inside FSI runs too when not guard_refine, as the serial
        LinearElasticity does, reference :317)."""
        standalone = self.params.simulation_type == "Solid"
        if first_step or self.time.time_to_output():
            if hasattr(self, "update_strain_and_stress"):
                self.update_strain_and_stress()
            self.output_results()
        if standalone and self.time.time_to_save():
            self.save_checkpoint()
        if refine_levels is not None and self.time.time_to_refine() and \
                (standalone or not guard_refine):
            self.refine_mesh(*refine_levels)

    # ------------------------------------------------------------------
    def make_cg_solver(self, op, diag, maxiter=None):
        """CG solve fn(b, atol) -> SolveResult with Jacobi preconditioning
        on the condensed system (reference uses CG+SSOR,
        source/solid_solver.cpp:125-142)."""
        if maxiter is None:
            maxiter = self.n_dofs
        dinv = torch.where(diag != 0, 1.0 / diag, 1.0)

        def solve(b, atol):
            return cg(op, b, M=lambda r: r * dinv, atol=atol,
                      maxiter=maxiter)

        return solve

    # -- standalone Neumann traction ----------------------------------
    def _standalone_face_traction(self, skip_dirichlet_faces: bool):
        """(n_f, n_q, dim) prescribed traction on boundary faces.

        reference: source/linear_elasticity.cpp:140-207 /
        source/hyper_elasticity.cpp:445-505."""
        fv = self.fv
        params = self.params
        if fv is None:
            return None
        n_f, n_q = fv.JxW.shape
        t = np.zeros((n_f, n_q, self.dim))
        for i in range(n_f):
            bid = int(fv.boundary_id[i])
            if skip_dirichlet_faces and bid in params.solid_dirichlet_bcs:
                continue
            if params.simulation_type != "FSI":
                if bid not in params.solid_neumann_bcs:
                    continue
                val = params.solid_neumann_bcs[bid]
                if params.solid_neumann_bc_type == "Traction":
                    t[i, :, :] = np.asarray(val)[None, :]
                else:  # Pressure w.r.t. reference configuration
                    t[i, :, :] = np.asarray(fv.normals[i]) * val[0]
        return self._tensor(t)

    def _fsi_traction_rhs_impl(self, traction):
        """FSI per-face traction -> global rhs."""
        t = traction * self._fsi_face_mask[:, None]
        tq = t[:, None, :].expand(len(self.fv.cells), self.fv.JxW.shape[1],
                                  self.dim)
        return self.traction_rhs(tq)

    def traction_rhs(self, traction_q):
        """Assemble face traction into the global rhs.

        traction_q: (n_f, n_q, dim)."""
        if self.fv is None or traction_q is None:
            return torch.zeros(self.n_dofs, dtype=real_dtype(),
                               device=self.device)
        # rhs[(l,a)] += N_l(q) * t_a(q) * JxW(q)
        rl = torch.einsum("fqi,fqa,fq->fia", self._fv_N, traction_q,
                          self._fv_JxW)
        return torch.zeros(self.n_dofs, dtype=rl.dtype,
                           device=rl.device).index_add_(
            0, self._face_cell_dofs.reshape(-1), rl.reshape(-1))

    # -- nodal strain/stress ------------------------------------------
    def update_strain_and_stress(self):
        """Projected nodal strain/stress with surrounding-cell averaging
        (reference: source/linear_elasticity.cpp:316-441)."""
        d = self.dim
        u = self.current_displacement.cpu().numpy().reshape(-1, d)
        ul = u[self.space.cell_dofs]  # (n_c, nl, d)
        gradu = np.einsum("cqlx,cla->cqax", self.cv.grad, ul)
        eps = 0.5 * (gradu + np.swapaxes(gradu, 2, 3))
        sig = self._stress_from_strain(eps, gradu)
        self.strain = np.stack(
            [[self.project_to_nodes(eps[:, :, i, j]) for j in range(d)]
             for i in range(d)])
        self.stress = np.stack(
            [[self.project_to_nodes(sig[:, :, i, j]) for j in range(d)]
             for i in range(d)])

    def _stress_from_strain(self, eps, gradu):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Dense direct solve for SMALL systems (the FSI solids are hundreds to
    # a few thousand dofs): a dense f32 LU + f64 iterative refinement
    # through the element matvec, as the JAX package does.
    dense_solve_max = 4096

    def _dense_solve(self, A_loc, cell_dofs, cons, b, n_refine: int = 2):
        """x = A^-1 b with identity fixed rows, via dense f32 LU (a library
        call, as jax.scipy.linalg.lu_factor is in the JAX package) + f64
        refinement."""
        n = self.n_dofs
        cd = cell_dofs.to(torch.int64)
        flat = (cd[:, :, None] * n + cd[:, None, :]).reshape(-1)
        A = torch.zeros(n * n, dtype=torch.float32, device=b.device)
        A.index_add_(0, flat, A_loc.to(torch.float32).reshape(-1))
        A = A.reshape(n, n)
        fixed = cons.fixed
        A = torch.where(fixed[:, None] | fixed[None, :], 0.0, A)
        A = A + torch.diag(fixed.to(torch.float32))
        lu, piv = torch.linalg.lu_factor(A)

        def solve32(r):
            return torch.linalg.lu_solve(
                lu, piv, r.to(torch.float32)[:, None])[:, 0].to(b.dtype)

        def mv(x):
            y = element_matvec(A_loc, cell_dofs, n, x)
            return torch.where(fixed, x, y)

        x = solve32(b)
        for _ in range(n_refine):
            x = x + solve32(b - mv(x))
        return x
