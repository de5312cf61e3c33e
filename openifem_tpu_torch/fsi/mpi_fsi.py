"""MPI-semantics immersed FSI coupler (nodal coupling fields).

Counterpart of openifem_tpu/fsi/mpi_fsi.py (reference: include/mpi_fsi.h,
source/mpi_fsi.cpp).  Differences from the serial coupler (fsi.py):
 - indicator: a fluid cell is artificial only if ALL its vertices are inside
   the solid (reference: source/mpi_fsi.cpp:292-319)
 - find_fluid_bc (body-force mode): NODAL fields, at velocity support
   points of artificial cells inside the solid,
     fsi_acc = (v_s - v_f)/dt + (grad v_f) v_f - a_s
   and at scalar support points fsi_stress = fluid nodal viscous stress -
   interpolated solid nodal stress (reference: source/mpi_fsi.cpp:323-663)
 - find_solid_bc: fluid (p, tau) interpolated at MOVED solid boundary
   vertices into the nodal field fsi_stress_rows
   (reference: source/mpi_fsi.cpp:666-867)
 - penalty contact model: redo the solid step with incremented contact
   traction until penetration < 1e-5 (reference: source/mpi_fsi.cpp:870-969)

Scatters keep the JAX package's semantics on CUDA: the "node lies in an
indicator cell" flags are a max-scatter (scatter_reduce "amax"); the
owner-cell velocity gradient is a gather through a precomputed (cell,
slot) index per node, one term per node, so no atomics; the boundary rows
are a set on unique indices; the contact traction adds at shared vertices
once per (face, vertex) occurrence, by design (index_add_).

A fluid with a turbulence model (the Spalart-Allmaras wall functions,
source/mpi_fsi.cpp:78-120, 655-660, 784-844, 1199-1203) takes the
per-phase loop, as in the JAX package: per step the shear velocities at
the solid boundary vertices (find_solid_bc), the model's Dirichlet rows,
the moving-wall distance (find_fluid_bc) and the model's Newton solve
before the fluid's, all on the device.

run() first restarts from the latest coordinated checkpoints in the
working directory (a lone solid or fluid checkpoint raises), and refines
the fluid around the solid at `Refinement interval` with levels
(gr, gr + 3) (source/mpi_fsi.cpp:1119-1227).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..config import real_dtype
from ..fe.fevalues import _geometry_jacobians
from ..mesh.mesh import FACE_VERTICES
from ..solvers.fluid.supg import SUPGFluidSolver
from .fsi import FSI, _same_meshes
from .interp import interpolate_nodal

class MPIFSI(FSI):
    def __init__(self, fluid, solid, params, use_dirichlet_bc: bool = False):
        super().__init__(fluid, solid, params, use_dirichlet_bc)
        self.penetration_criterion = None
        self.penetration_direction = None
        # name -> context manager, entered around each part of a step: the
        # coupled step's "solid RK4", "coupling" and "fluid Newton"; the
        # per-phase step's "solid", "coupling", "SA" (a turbulence model's
        # rows and solve) and "fluid Newton"; ControlVolumeFSI's "CV
        # analysis".  A profiler's hook
        self.step_span = None

    def _can_fuse_step(self):
        # the coupled step: body-force mode with an RKPM solid
        # (SharedHypoElasticity, the fsi-wall-3D stack) and a fluid with an
        # FSI step; contact, turbulence and Dirichlet mode use the
        # per-phase loop
        return (self.fused_coupled_stepping
                and not self.use_dirichlet_bc
                and self.penetration_criterion is None
                and getattr(self, "_tm", None) is None
                and hasattr(self.fluid, "make_fsi_step")
                and hasattr(self.solid, "_rk4_step_impl")
                and hasattr(self.solid, "_nodal_stress_impl"))

    def make_coupled_step(self):
        """The fsi-wall-3D per-step sequence as one function (reference
        loop: source/mpi_fsi.cpp:1180-1213): solid_bc_rows -> RKPM RK4
        step -> all-vertices indicator -> nodal fsi_stress / fsi_acc
        fields -> SUPG-family fluid Newton."""
        fluid, solid = self.fluid, self.solid
        if not isinstance(fluid, SUPGFluidSolver):
            raise TypeError("the MPI coupled step takes a SUPG-family fluid")
        k = self._mpi_kernels
        fluid_step = fluid.make_fsi_step()
        rdt = real_dtype()
        ref_verts = self._tensor(solid.mesh.vertices)

        def step(s_x, s_v, s_sigma, f_sol, f_stress):
            span = self.step_span or (lambda name: nullcontext())
            with span("coupling"):
                s_disp = (s_x - ref_verts).reshape(-1)
                rows, p_nodal, u_nodal = k.solid_bc_rows(s_disp, f_sol,
                                                         f_stress)
            with span("solid RK4"):
                x2, v2, sig2, a2 = solid._device_step_impl(s_x, s_v,
                                                           s_sigma, rows)
            with span("coupling"):
                indicator = k.indicator_all_vertices(x2).to(rdt)
                solid_stress_nodal = solid._nodal_stress_impl(sig2)
                fsi_stress_nodal = k.fsi_stress_nodal(
                    x2, f_stress, solid_stress_nodal, indicator)
                fsi_acc_nodal = k.fsi_acc_nodal(
                    x2, f_sol, v2.reshape(-1), a2.reshape(-1), indicator)
            with span("fluid Newton"):
                eddy = torch.zeros(fluid.u_space.n_nodes, dtype=rdt,
                                   device=self.device)
                zc = fluid.zero_constraints
                sol2, f_stress2, rel, f_it = fluid_step(
                    f_sol, indicator, fsi_acc_nodal, fsi_stress_nodal,
                    f_stress, eddy, zc, zc, fluid.u_constraints,
                    fluid.p_constraints)
            return (x2, v2, sig2, a2, sol2, f_stress2, indicator,
                    fsi_stress_nodal, fsi_acc_nodal, rel, f_it,
                    rows, p_nodal, u_nodal)

        return step

    def run_one_coupled_step(self, verbose: bool = False):
        fluid, solid = self.fluid, self.solid
        self._sync_coupling()
        if not _same_meshes(getattr(self, "_coupled_step_meshes", None),
                            self._coupling_meshes):
            self._coupled_step = self.make_coupled_step()
            self._coupled_step_meshes = self._coupling_meshes
        self._check_solid_hash_capacity(solid.moved_vertex_coords())
        (x2, v2, sig2, a2, sol2, f_stress2, indicator, fsi_stress_nodal,
         fsi_acc_nodal, rel, f_it, rows, p_nodal,
         u_nodal) = self._coupled_step(
            solid.x, solid.v, solid.sigma, fluid.present_solution,
            fluid.stress_device)
        if rel > self.params.fluid_tolerance:
            raise RuntimeError("Too many Newton iterations!")
        # find_solid_bc's outputs stay on the solid, as in the reference
        # (source/mpi_fsi.cpp:770-781)
        solid.fsi_stress_rows = rows
        solid.fluid_pressure_nodal = p_nodal
        solid.fluid_velocity_nodal = u_nodal
        solid.x, solid.v, solid.sigma, solid._acc = x2, v2, sig2, a2
        solid._sync()
        solid.time.increment()
        fluid.indicator = indicator
        fluid.fsi_stress_nodal = fsi_stress_nodal
        fluid.fsi_acc_nodal = fsi_acc_nodal
        fluid.solution_increment = sol2 - fluid.present_solution
        fluid.present_solution = sol2
        fluid.stress_device = f_stress2
        fluid.newton_iters = f_it
        fluid.time.increment()
        if verbose:
            print(f"*** Time step = {fluid.time.get_timestep()}, at t = "
                  f"{fluid.time.current():.6e} (coupled step): "
                  f"fluid {f_it} Newton iters")
        solid._end_of_step_io(False)
        fluid._end_of_step_io()

    def set_penetration_criterion(self, criterion, direction):
        """criterion(points (n,dim) numpy) -> (n,) penetration depth;
        direction: contact force direction (reference:
        source/mpi_fsi.cpp:1229-1237)."""
        self.penetration_criterion = criterion
        self.penetration_direction = np.asarray(direction, dtype=np.float64)

    # ------------------------------------------------------------------
    def _setup_coupling(self):
        fluid, solid = self.fluid, self.solid
        tm = getattr(fluid, "turbulence_model", None)
        if tm is not None and not hasattr(tm, "space"):
            tm.setup()
        super()._setup_coupling()
        d = fluid.dim
        t = self._tensor
        cell_dofs = fluid.u_space.cell_dofs

        # eligibility for Dirichlet constraints: non-cell-interior support
        # points (the reference skips points whose unit coordinates are
        # all strictly inside (0,1), source/mpi_fsi.cpp:589-602)
        unit = fluid.u_space.shapes.local_nodes()
        strict_inside = ((unit > 1e-5) & (unit < 1 - 1e-5)).all(axis=1)
        eligible = np.zeros(fluid.u_space.n_nodes, dtype=bool)
        for l in range(unit.shape[0]):
            if not strict_inside[l]:
                eligible[cell_dofs[:, l]] = True
        self._u_node_eligible = t(eligible, torch.bool)

        # per node, the (owner cell, slot) of the smallest cell index that
        # holds it, as a flat index into (n_cells * n_local)
        n_c, nl = cell_dofs.shape
        owner_flat = np.full(fluid.u_space.n_nodes, -1, dtype=np.int64)
        flat = np.arange(n_c * nl).reshape(n_c, nl)
        for c in range(n_c - 1, -1, -1):
            owner_flat[cell_dofs[c]] = flat[c]
        self._u_node_owner_slot = t(owner_flat, torch.int64)

        # physical shape gradients of the u space at its unit support points
        _, dN = fluid.u_space.shapes.evaluate(unit)
        _, Jinv, _, _ = _geometry_jacobians(fluid.mesh, unit)
        self._gsup = t(np.einsum("sld,csdx->cslx", dN, Jinv))

        # solid boundary nodes (on non-fully-fixed faces) for find_solid_bc
        smesh = solid.mesh
        fixed_flag = (1 << d) - 1
        bnodes = set()
        for c in range(smesh.n_cells):
            for f in range(2 * d):
                bid = int(smesh.boundary_id[c, f])
                if bid < 0:
                    continue
                if self.params.solid_dirichlet_bcs.get(bid) == fixed_flag:
                    continue
                for l in solid.space.face_local_nodes[f]:
                    bnodes.add(int(solid.space.cell_dofs[c, l]))
        self._solid_bnodes = t(sorted(bnodes), torch.int64)

        # turbulence-model wall functions: the solid boundary vertices,
        # each face's endpoints as indices into them, and the mean over a
        # vertex's adjacent faces as an (n_v, n_f) matrix (reference:
        # collect_solid_boundaries / _boundary_vertices,
        # source/mpi_fsi.cpp:78-120)
        self._tm = tm
        if tm is not None:
            bfv = solid._bface_verts.cpu().numpy()      # (n_f, nfv) ids
            vids = np.unique(bfv)
            face_vidx = np.searchsorted(vids, bfv)
            avg = np.zeros((len(vids), len(bfv)))
            for fi, row in enumerate(face_vidx):
                avg[np.unique(row), fi] = 1.0
            avg /= avg.sum(axis=1, keepdims=True)
            self._sb_vids = t(vids, torch.int64)
            self._sb_face_vidx = t(face_vidx, torch.int64)
            self._sb_vertex_mean = t(avg)
            self.shear_velocities = torch.zeros(len(vids),
                                                dtype=real_dtype(),
                                                device=self.device)
        self._mpi_kernels = _MPIKernels(self)

    # ------------------------------------------------------------------
    def update_solid_box_and_indicator(self):
        moved = self._solid_moved_verts()
        self._check_solid_hash_capacity(moved)
        self.fluid.indicator = self._mpi_kernels.indicator_all_vertices(
            moved).to(real_dtype())

    def find_fluid_bc(self, first_step: bool = True):
        fluid, solid = self.fluid, self.solid
        k = self._mpi_kernels
        moved = self._solid_moved_verts()
        solid.update_strain_and_stress()
        solid_stress_nodal = self._tensor(solid.stress.transpose(2, 0, 1))
        # the nodal fsi_stress difference (both modes set it; the
        # reference computes it before the acceleration loop)
        fluid.fsi_stress_nodal = k.fsi_stress_nodal(
            moved, fluid.stress_device, solid_stress_nodal, fluid.indicator)
        if self._tm is not None:
            # the SA moving-wall distance from the deformed solid boundary
            # (reference: source/mpi_fsi.cpp:655-660)
            mv = solid.moved_vertex_coords()
            self._tm.update_moving_wall_distance(
                mv[self._sb_vids], self._sb_face_vidx, self.shear_velocities)
        base = fluid.nonzero_constraints if first_step else \
            fluid.zero_constraints
        if not self.use_dirichlet_bc:
            fluid.fsi_acc_nodal = k.fsi_acc_nodal(
                moved, fluid.present_solution, solid.current_velocity,
                solid.current_acceleration, fluid.indicator)
            fluid.fsi_acceleration = torch.zeros_like(fluid.fsi_acceleration)
            # nonzero inhomogeneities apply exactly once (the reference
            # copies zero_constraints over nonzero_constraints after the
            # first step, mpi_fsi.cpp:1193-1197)
            return None, base
        fluid.fsi_acc_nodal = torch.zeros_like(fluid.fsi_acc_nodal)
        return self._fluid_constraints(moved, solid.current_velocity,
                                       fluid.present_solution, base,
                                       k.dirichlet_bc_mpi)

    def find_solid_bc(self):
        solid = self.solid
        (solid.fsi_stress_rows, solid.fluid_pressure_nodal,
         solid.fluid_velocity_nodal) = self._mpi_kernels.solid_bc_rows(
            solid.current_displacement, self.fluid.present_solution,
            self.fluid.stress_device)
        if self._tm is not None:
            self._update_shear_velocities()

    def _update_shear_velocities(self):
        """Shear velocity u_tau at each solid boundary vertex for the
        turbulence wall function (reference: source/mpi_fsi.cpp:784-844).
        The vertex normal is the UN-normalized mean of the adjacent
        deformed face unit normals (:795-800); the reference computes an
        image point but samples the fluid velocity AT the wall vertex
        itself (:805-814), and so does the port."""
        fluid, solid = self.fluid, self.solid
        d = fluid.dim
        moved = solid.moved_vertex_coords()
        _, fn = solid._face_geometry(moved)
        fn = (fn * solid._face_orient[:, None, None])[:, 0, :]
        vn = self._sb_vertex_mean @ fn
        idx, unit, found = self._fluid_locate(self._fluid_hash_state,
                                              moved[self._sb_vids])
        u = fluid.present_solution[:fluid.n_u].reshape(-1, d)
        uv = interpolate_nodal(u, fluid._u_cell_nodes, idx, unit,
                               fluid.params.fluid_velocity_degree, found)
        normal_part = (uv * vn).sum(dim=-1)[:, None] * vn
        tangential = torch.linalg.vector_norm(uv - normal_part, dim=-1)
        ut = self._tm.get_shear_velocity(tangential, self.shear_velocities)
        self.shear_velocities = torch.where(found, ut, 0.0)

    # ------------------------------------------------------------------
    def _contact_tables(self):
        """(vertex ids (P,), reference normals (P, d)) of every boundary
        (face, vertex) occurrence, cached per solid mesh."""
        solid = self.solid
        if getattr(self, "_contact_cache_mesh", None) is not solid.mesh:
            fv = solid.fv
            fvidx = np.asarray(FACE_VERTICES[solid.dim])[np.asarray(fv.faces)]
            verts = np.asarray(solid.mesh.cells)[
                np.asarray(fv.cells)[:, None], fvidx].reshape(-1)
            normals0 = np.asarray(fv.normals)[:, 0, :]
            self._contact_cache_mesh = solid.mesh
            self._contact_verts = verts
            self._contact_tensors = (
                self._tensor(verts, torch.int64),
                self._tensor(np.repeat(normals0, fvidx.shape[1], axis=0)))
        return self._contact_verts, self._contact_tensors

    def _add_contact_traction(self, rows, pen, force_inc, dirn):
        """rows + the contact traction of the active (face, vertex)
        occurrences, and whether any is active: extra[p, :, d-1] =
        force * pen[p] * dirn / nrm[p] where the normal component is
        usable (mpi_fsi.cpp:929-948)."""
        d = self.solid.dim
        _, (verts_t, nrm) = self._contact_tables()
        active = pen > 1e-5
        traction = force_inc * pen[:, None] * dirn[None, :]
        usable = nrm > 1e-5
        col = torch.where(usable, traction / torch.where(usable, nrm, 1.0),
                          0.0)
        col = torch.where(active[:, None], col, 0.0)
        extra = torch.zeros(col.shape + (d,), dtype=rows.dtype,
                            device=rows.device)
        extra[..., d - 1] = col
        return rows.index_add(0, verts_t, extra), bool(active.any())

    def apply_contact_model(self, first_step: bool) -> int:
        """reference: source/mpi_fsi.cpp:870-969.  All boundary faces
        take part (the reference loop does not skip Dirichlet faces here);
        each (face, vertex) occurrence adds its own contribution, so a
        vertex shared by two boundary faces accumulates twice, as in the
        reference (source/mpi_fsi.cpp:903-954).  Returns the number of
        retries."""
        solid = self.solid
        cache = (solid.current_acceleration, solid.current_velocity,
                 solid.current_displacement, solid.previous_acceleration,
                 solid.previous_velocity, solid.previous_displacement)
        direction = self.penetration_direction
        dirn = self._tensor(direction / np.linalg.norm(direction))
        force_inc = self.params.contact_force_multiplier
        verts, _ = self._contact_tables()
        retries = 0
        while True:
            solid.run_one_step(first_step)
            moved = solid.moved_vertex_coords().cpu().numpy()
            pen = self._tensor(self.penetration_criterion(moved[verts]))
            rows, any_active = self._add_contact_traction(
                solid.fsi_stress_rows, pen, force_inc, dirn)
            if not any_active:
                return retries
            solid.fsi_stress_rows = rows
            (solid.current_acceleration, solid.current_velocity,
             solid.current_displacement, solid.previous_acceleration,
             solid.previous_velocity, solid.previous_displacement) = cache
            solid.time.decrement()
            retries += 1

    def _run_solid_step(self, first_step: bool) -> int:
        if self.penetration_criterion is not None:
            return self.apply_contact_model(first_step)
        return super()._run_solid_step(first_step)

    def _run_phases(self, first_step: bool, verbose: bool) -> int:
        """One step of the per-phase loop (reference:
        source/mpi_fsi.cpp:1180-1213), each part inside its step_span: with
        a turbulence model, its per-step Dirichlet rows from the last
        step's wall distances after the indicator update (:1199-1203), and
        its Newton solve before the fluid's."""
        span = self.step_span or (lambda name: nullcontext())
        tm = self._tm
        with self.timer.scope("Find solid BC"), span("coupling"):
            self.find_solid_bc()
        with self.timer.scope("Run solid solver"), span("solid"):
            retries = self._run_solid_step(first_step)
        with self.timer.scope("Update indicator"), span("coupling"):
            self.update_solid_box_and_indicator()
        if tm is not None:
            with span("SA"):
                tm.update_boundary_condition(first_step)
        with self.timer.scope("Find fluid BC"), span("coupling"):
            zero_ext, nonzero_ext = self.find_fluid_bc(first_step)
        if tm is not None:
            with self.timer.scope("Run turbulence model"), span("SA"):
                tm.run_one_step(True)
        with self.timer.scope("Run fluid solver"), span("fluid Newton"):
            self._run_fluid_step(zero_ext, nonzero_ext, verbose)
        return retries

    # ------------------------------------------------------------------
    def _interface_levels(self):
        """(gr, gr + 3) (reference: source/mpi_fsi.cpp:1164-1171)."""
        gr = self.params.global_refinements[0]
        return gr, gr + 3

    def run(self, verbose: bool = True):
        """reference: source/mpi_fsi.cpp:1119-1227: restart from the latest
        coordinated checkpoints when there are any (load_checkpoint applies
        the solid's global refinement itself; a lone solid or fluid
        checkpoint raises, as the reference's unconditional AssertThrow
        does, :1130-1134), else the global refinement and set-up; the
        initial interface refinement x2; then FSI.run's loop, with the
        contact model in the solid phase and no first step after a
        restart."""
        loaded = self.load_checkpoint()
        self._setup_run(loaded)
        self._initial_refinement(verbose)
        self._time_loop(verbose, first_step=not loaded)


class _MPIKernels:
    """The MPI coupler's kernels bound to static mesh tables."""

    def __init__(self, fsi: MPIFSI):
        fluid, solid = fsi.fluid, fsi.solid
        d = fluid.dim
        t = fsi._tensor
        sdeg = solid.params.solid_degree
        s_space_dofs = t(solid.space.cell_dofs, torch.int64)
        u_cell_dofs = t(fluid.u_space.cell_dofs, torch.int64)
        p_cell_dofs = t(fluid.p_space.cell_dofs, torch.int64)
        flat_u = u_cell_dofs.reshape(-1)
        n_nodes = fluid.u_space.n_nodes
        dt = fsi.params.time_step
        points_in_solid = fsi._kernels.points_in_solid
        pts = fsi._fluid_u_points

        def node_in_indicator_cell(indicator):
            """A node counts if it belongs to ANY indicator cell (a max-
            scatter, order-free)."""
            flag = (indicator[:, None] > 0).expand(u_cell_dofs.shape)
            return torch.zeros(n_nodes, dtype=torch.int32,
                               device=indicator.device).scatter_reduce(
                0, flat_u, flag.reshape(-1).to(torch.int32), "amax") > 0

        def indicator_all_vertices(moved):
            """all cell vertices inside -> artificial
            (reference: source/mpi_fsi.cpp:292-319)."""
            verts = fsi._fluid_cell_verts             # (n_c, nv, d)
            n_c, nv, _ = verts.shape
            _, _, found = points_in_solid(verts.reshape(-1, d), moved)
            return found.reshape(n_c, nv).all(dim=1)

        def fsi_stress_nodal(moved, fluid_stress, solid_stress, indicator):
            """fluid nodal stress - interpolated solid nodal stress on
            covered scalar dofs (reference: source/mpi_fsi.cpp:411-476)."""
            idx, unit, found = points_in_solid(pts, moved)
            s_scalar = interpolate_nodal(solid_stress, s_space_dofs, idx,
                                         unit, sdeg, found)
            active = node_in_indicator_cell(indicator) & found
            return torch.where(active[:, None, None],
                               fluid_stress - s_scalar, 0.0)

        def fsi_acc_nodal(moved, fluid_solution, solid_vel, solid_acc,
                          indicator):
            """(v_s - v_f)/dt + (grad v_f) v_f - a_s at velocity support
            points (reference: source/mpi_fsi.cpp:478-566)."""
            u = fluid_solution[:fluid.n_u].reshape(-1, d)
            # the gradient at each cell's support points, then per node
            # the owner cell's
            gv = torch.einsum("cslx,cla->csax", fsi._gsup, u[u_cell_dofs])
            grad_at_node = gv.reshape(-1, d, d)[fsi._u_node_owner_slot]
            idx, unit, found = points_in_solid(pts, moved)
            vs = interpolate_nodal(solid_vel.reshape(-1, d), s_space_dofs,
                                   idx, unit, sdeg, found)
            a_s = interpolate_nodal(solid_acc.reshape(-1, d), s_space_dofs,
                                    idx, unit, sdeg, found)
            fluid_acc = (vs - u) / dt + torch.einsum("nab,nb->na",
                                                     grad_at_node, u)
            # unlike the Dirichlet branch (mpi_fsi.cpp:590-602), the body-
            # force branch sets the acceleration at ALL velocity support
            # points, cell-interior ones included (mpi_fsi.cpp:478-566)
            active = node_in_indicator_cell(indicator) & found
            return torch.where(active[:, None], fluid_acc - a_s, 0.0)

        def dirichlet_bc_mpi(moved, solid_vel):
            idx, unit, found = points_in_solid(pts, moved)
            inside = found & fsi._u_node_eligible
            v_s = interpolate_nodal(solid_vel.reshape(-1, d), s_space_dofs,
                                    idx, unit, sdeg, found)
            mask = inside[:, None].expand(v_s.shape)
            return mask, torch.where(mask, v_s, 0.0)

        bnodes = fsi._solid_bnodes
        fdeg = fluid.params.fluid_velocity_degree
        pdeg = fluid.params.fluid_pressure_degree
        s_node_ref = t(solid.space.node_points)
        n_s = solid.space.n_nodes

        def solid_bc_rows(solid_disp, fluid_solution, fluid_stress):
            """sigma = -p I + tau at moved solid boundary nodes, and the
            fluid pressure / velocity there (reference:
            source/mpi_fsi.cpp:666-867)."""
            d_full = solid_disp.reshape(-1, d)
            bpts = s_node_ref[bnodes] + d_full[bnodes]
            idx, unit, found = fsi._fluid_locate(fsi._fluid_hash_state,
                                                 bpts)
            p_val = interpolate_nodal(fluid_solution[fluid.n_u:],
                                      p_cell_dofs, idx, unit, pdeg, found)
            tau = interpolate_nodal(fluid_stress, u_cell_dofs, idx, unit,
                                    fdeg, found)
            u = fluid_solution[:fluid.n_u].reshape(-1, d)
            u_val = interpolate_nodal(u, u_cell_dofs, idx, unit, fdeg, found)
            I = torch.eye(d, dtype=fluid_solution.dtype,
                          device=fluid_solution.device)
            like = dict(dtype=fluid_solution.dtype,
                        device=fluid_solution.device)
            rows = torch.zeros((n_s, d, d), **like)
            rows[bnodes] = -p_val[:, None, None] * I + tau
            p_nodal = torch.zeros(n_s, **like)
            p_nodal[bnodes] = p_val
            u_nodal = torch.zeros((n_s, d), **like)
            u_nodal[bnodes] = u_val
            return rows, p_nodal, u_nodal

        self.indicator_all_vertices = indicator_all_vertices
        self.fsi_stress_nodal = fsi_stress_nodal
        self.fsi_acc_nodal = fsi_acc_nodal
        self.dirichlet_bc_mpi = dirichlet_bc_mpi
        self.solid_bc_rows = solid_bc_rows
