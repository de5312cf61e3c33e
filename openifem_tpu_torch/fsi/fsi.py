"""Immersed FSI coupler (serial semantics).

Counterpart of openifem_tpu/fsi/fsi.py (reference: include/fsi.h,
source/fsi.cpp).  The mIFEM loop per step:
  1. find_solid_bc: interpolate fluid stress -> solid boundary traction
  2. advance the solid
  3. update solid box + indicator field (fluid cells covered by solid)
  4. find_fluid_bc: FSI body force (and/or Dirichlet velocity constraints
     interpolated from the solid) on the artificial fluid
  5. advance the fluid
The first step runs these phases one by one; every later step is one
call of make_coupled_step's function.  All geometric queries are batched
tensor kernels (fsi/interp.py) on the solvers' device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import real_dtype
from ..mesh.mesh import FACE_VERTICES
from ..parameters import AllParameters
from ..solvers.fluid.supg import SUPGFluidSolver
from ..utils.timectl import Time
from .interp import (check_cell_hash_capacity, interpolate_nodal,
                     make_cell_hash, plan_cell_hash)


def _same_meshes(a, b):
    """Whether two (fluid mesh, solid mesh) pairs are the same objects."""
    return a is not None and all(x is y for x, y in zip(a, b))


class FSI:
    def __init__(self, fluid, solid, params: AllParameters,
                 use_dirichlet_bc: bool = False):
        self.fluid = fluid
        self.solid = solid
        self.params = params
        self.use_dirichlet_bc = use_dirichlet_bc
        self.device = fluid.device
        self.time = Time(params.end_time, params.time_step,
                         params.output_interval, params.refinement_interval,
                         params.save_interval)
        # optional nested coarse-mesh list (coarsest first, all
        # geometrically nested under the fluid mesh) for the fluid pressure
        # V-cycle; when set, the hierarchy [bases..., fluid mesh] is
        # attached after the fluid's setup
        self.fluid_mg_base = None
        from ..utils.timer import Timer
        self.timer = Timer(type(self).__name__)

    def _enable_fluid_mg(self):
        fl = self.fluid
        if (self.fluid_mg_base and hasattr(fl, "enable_pressure_mg")
                and fl.params.fluid_pressure_degree == 1):
            bases = [m for m in self.fluid_mg_base
                     if m.n_cells < fl.mesh.n_cells]
            if bases:
                fl.enable_pressure_mg(bases + [fl.mesh], fixed_prefix=False)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, device=self.device,
                               dtype=dtype if dtype is not None
                               else real_dtype())

    # ------------------------------------------------------------------
    def _setup_coupling(self):
        """Precompute static coupling tables (device tensors)."""
        fluid, solid = self.fluid, self.solid
        d = fluid.dim
        smesh = solid.mesh
        t = self._tensor
        self._solid_cells = t(smesh.cells, torch.int64)
        self._solid_ref_verts = t(smesh.vertices)
        self._n_sv = smesh.n_vertices

        # fluid cell centers (vertex average, = deal.II cell->center())
        self._fluid_centers = t(fluid.mesh.cell_centers())
        self._fluid_u_points = t(fluid.u_space.node_points)

        # velocity support points eligible for FSI Dirichlet constraints:
        # those on a zero-unit-coordinate face of some cell (reference:
        # source/fsi.cpp:262-276)
        eligible = np.zeros(fluid.u_space.n_nodes, dtype=bool)
        unit = fluid.u_space.shapes.local_nodes()
        has_zero = (np.abs(unit) < 1e-5).any(axis=1)
        for l in range(unit.shape[0]):
            if has_zero[l]:
                eligible[fluid.u_space.cell_dofs[:, l]] = True
        self._u_node_eligible = t(eligible, torch.bool)

        # solid boundary faces: endpoints (vertex ids) for moved-face
        # geometry, aligned with solid.fv entries
        fv = solid.fv
        face_verts = [[int(smesh.cells[c, v]) for v in FACE_VERTICES[d][f]]
                      for c, f in zip(np.asarray(fv.cells),
                                      np.asarray(fv.faces))]
        self._solid_bface_verts = t(np.array(face_verts), torch.int64)
        self._solid_bface_cells = t(np.asarray(fv.cells), torch.int64)

        # grid-hash locators.  The fluid mesh is static: built once.  The
        # solid moves: its hash is rebuilt on the deformed configuration
        # every step, planned on the reference config with 2x headroom.
        fverts = fluid.mesh.vertices
        fcells = fluid.mesh.cells
        self._fluid_cell_verts = t(fverts[fcells])
        fdims, fspan, fK = plan_cell_hash(fverts[fcells])
        fbuild, self._fluid_locate = make_cell_hash(
            fluid.mesh.n_cells, fdims, fspan, fK, device=self.device)
        self._fluid_hash_state = fbuild(self._fluid_cell_verts)
        sdims, sspan, sK = plan_cell_hash(smesh.vertices[smesh.cells],
                                          safety=2.0)
        self._solid_hash = make_cell_hash(smesh.n_cells, sdims, sspan, sK,
                                          device=self.device)
        self._solid_hash_plan = (sdims, sspan, sK)

        self._kernels = _FSIKernels(self)
        self._coupling_meshes = (fluid.mesh, solid.mesh)

    # ------------------------------------------------------------------
    def _solid_moved_verts(self):
        d = self.solid.dim
        disp = self.solid.current_displacement[:self._n_sv * d].reshape(
            self._n_sv, d)
        return self._solid_ref_verts + disp

    def update_solid_box_and_indicator(self):
        """reference: source/fsi.cpp:64-165."""
        moved = self._solid_moved_verts()
        self._check_solid_hash_capacity(moved)
        self.fluid.indicator = self._kernels.indicator(moved).to(
            real_dtype())

    # ------------------------------------------------------------------
    # fluid advance through the solver's make_fsi_step (set
    # device_fluid_stepping = False for run_one_step's instrumented host
    # loop; same converged solution either way)
    device_fluid_stepping = True
    # whole-step coupling (make_coupled_step) for non-first steps; False
    # runs the per-phase loop every step
    fused_coupled_stepping = True

    def _can_fuse_step(self):
        return (self.fused_coupled_stepping
                and hasattr(self.fluid, "make_fsi_step")
                and hasattr(self.solid, "_device_step_impl")
                and getattr(self.fluid, "turbulence_model", None) is None)

    def _run_fluid_step(self, zero_ext, nonzero_ext, verbose):
        fluid = self.fluid
        zero_ext = zero_ext if zero_ext is not None else \
            fluid.zero_constraints
        nonzero_ext = nonzero_ext if nonzero_ext is not None else \
            fluid.nonzero_constraints
        if not (self.device_fluid_stepping and
                hasattr(fluid, "make_fsi_step")):
            fluid.run_one_step(True, verbose=verbose, zero_cons=zero_ext,
                               nonzero_cons=nonzero_ext)
            return
        if getattr(self, "_fluid_step_mesh", None) is not fluid.mesh:
            self._fluid_step_fn = fluid.make_fsi_step()
            self._fluid_step_mesh = fluid.mesh
        fluid.time.increment()
        if verbose:
            print(f"*** Time step = {fluid.time.get_timestep()}, "
                  f"at t = {fluid.time.current():.6e} (device step)")
        ucons = fluid._u_cons_of(zero_ext)
        if isinstance(fluid, SUPGFluidSolver):
            sol, stress, rel, its = self._fluid_step_fn(
                fluid.present_solution, fluid.indicator,
                fluid.fsi_acc_nodal, fluid.fsi_stress_nodal,
                fluid.stress_device, fluid._eddy_nodal(), zero_ext,
                nonzero_ext, ucons, fluid.p_constraints)
        else:
            sol, stress, rel, its = self._fluid_step_fn(
                fluid.present_solution, fluid.indicator,
                fluid.fsi_acceleration, fluid.fsi_stress_cell,
                fluid.fsi_acc_nodal, zero_ext, nonzero_ext, ucons,
                fluid.p_constraints)
        if rel > self.params.fluid_tolerance:
            raise RuntimeError("Too many Newton iterations!")
        fluid.solution_increment = sol - fluid.present_solution
        fluid.present_solution = sol
        fluid.stress_device = stress
        fluid.newton_iters = its
        fluid._end_of_step_io()

    # ------------------------------------------------------------------
    def _fluid_constraints(self, moved, solid_vel, f_sol, base,
                           dirichlet_bc=None):
        """Dirichlet coupling: FSI velocity constraints at covered fluid
        support points (from `dirichlet_bc`, default the serial kernel's).
        The inhomogeneity is the velocity DELTA (v_solid - present).
        Returns (zero_ext, nonzero_ext)."""
        fluid = self.fluid
        dirichlet_bc = dirichlet_bc or self._kernels.dirichlet_bc
        mask_u, vals_u = dirichlet_bc(moved, solid_vel)
        n = fluid.n_dofs
        mask = torch.zeros(n, dtype=torch.bool, device=self.device)
        mask[:fluid.n_u] = mask_u.reshape(-1)
        vals = torch.zeros(n, dtype=real_dtype(), device=self.device)
        vals[:fluid.n_u] = vals_u.reshape(-1)
        vals = vals - torch.where(mask, f_sol, 0.0)
        zero_ext = fluid.zero_constraints.with_extra_dirichlet(
            mask, torch.zeros_like(vals))
        nonzero_ext = base.with_extra_dirichlet(mask, vals)
        return zero_ext, nonzero_ext

    # whole coupled step: solid traction -> solid Newton -> indicator ->
    # FSI fluid constraints -> fluid Newton (the reference loop makes the
    # same sequence of calls per step, source/fsi.cpp:484-506).  Non-first
    # steps only: the first step applies the inflow inhomogeneities and
    # the solid initial-acceleration mass solve on the per-phase path.
    def make_coupled_step(self):
        fluid, solid = self.fluid, self.solid
        k = self._kernels
        fluid_step = fluid.make_fsi_step()
        n_sv, d = self._n_sv, fluid.dim
        is_supg = isinstance(fluid, SUPGFluidSolver)

        def step(s_disp, s_vel, s_acc, f_sol, f_stress, fsi_stress_nodal):
            moved = self._solid_ref_verts + s_disp[:n_sv * d].reshape(n_sv,
                                                                      d)
            traction = k.solid_traction(moved, f_sol, f_stress)
            trhs = solid._fsi_traction_rhs_impl(traction)
            disp2, v2, a2, s_it = solid._device_step_impl(
                s_disp, s_vel, s_acc, trhs)
            moved2 = self._solid_ref_verts + disp2[:n_sv * d].reshape(n_sv,
                                                                      d)
            indicator = k.indicator(moved2).to(real_dtype())
            acc_nodal = torch.zeros_like(fluid.fsi_acc_nodal)
            if self.use_dirichlet_bc:
                fsi_acc = torch.zeros_like(fluid.fsi_acceleration)
                zero_ext, nonzero_ext = self._fluid_constraints(
                    moved2, v2, f_sol, fluid.zero_constraints)
            else:
                fsi_acc = k.fsi_acceleration(moved2, a2, indicator)
                zero_ext = nonzero_ext = fluid.zero_constraints
            ucons = fluid._u_cons_of(zero_ext)
            if is_supg:
                # the SUPG family takes the nodal FSI fields and the
                # fluid's own nodal stress; no eddy viscosity inside a
                # coupled step
                eddy = torch.zeros(fluid.u_space.n_nodes,
                                   dtype=real_dtype(), device=self.device)
                sol2, stress2, rel, f_it = fluid_step(
                    f_sol, indicator, acc_nodal, fsi_stress_nodal,
                    f_stress, eddy, zero_ext, nonzero_ext, ucons,
                    fluid.p_constraints)
            else:
                sol2, stress2, rel, f_it = fluid_step(
                    f_sol, indicator, fsi_acc,
                    torch.zeros_like(fluid.fsi_stress_cell), acc_nodal,
                    zero_ext, nonzero_ext, ucons, fluid.p_constraints)
            return (disp2, v2, a2, sol2, stress2, indicator, rel, f_it,
                    s_it, traction)

        return step

    def run_one_coupled_step(self, verbose: bool = False):
        """Advance one (non-first) FSI step through make_coupled_step and
        update both solvers' state + IO epilogues."""
        fluid, solid = self.fluid, self.solid
        self._sync_coupling()
        if not _same_meshes(getattr(self, "_coupled_step_meshes", None),
                            self._coupling_meshes):
            self._coupled_step = self.make_coupled_step()
            self._coupled_step_meshes = self._coupling_meshes
        self._check_solid_hash_capacity(self._solid_moved_verts())
        (disp2, v2, a2, sol2, stress2, indicator, rel, f_it, s_it,
         traction) = self._coupled_step(
            solid.current_displacement, solid.current_velocity,
            solid.current_acceleration, fluid.present_solution,
            fluid.stress_device, fluid.fsi_stress_nodal)
        if s_it >= self.params.solid_max_iterations or \
                rel > self.params.fluid_tolerance:
            raise RuntimeError("Too many Newton iterations!")
        solid.fsi_traction = traction
        solid.current_displacement = solid.previous_displacement = disp2
        solid.current_velocity = solid.previous_velocity = v2
        solid.current_acceleration = solid.previous_acceleration = a2
        solid.newton_iters = s_it
        solid.time.increment()
        fluid.indicator = indicator
        fluid.solution_increment = sol2 - fluid.present_solution
        fluid.present_solution = sol2
        fluid.stress_device = stress2
        fluid.newton_iters = f_it
        fluid.time.increment()
        if verbose:
            print(f"*** Time step = {fluid.time.get_timestep()}, at t = "
                  f"{fluid.time.current():.6e} (coupled step): "
                  f"solid {s_it} / fluid {f_it} Newton iters")
        solid._end_of_step_io(False)
        fluid._end_of_step_io()

    def _check_solid_hash_capacity(self, moved):
        """The solid hash was planned on the reference config with 2x
        headroom; verify the DEFORMED config still fits the static
        (span, K) so the locator cannot silently drop cells."""
        sdims, sspan, sK = self._solid_hash_plan
        cv = moved.cpu().numpy()[self.solid.mesh.cells]
        check_cell_hash_capacity(cv, sdims, sspan, sK,
                                 context=" (deformed solid)")

    def find_fluid_bc(self, first_step: bool = True):
        """reference: source/fsi.cpp:168-310.  After the first step the
        boundary-BC inhomogeneities are zeroed
        (nonzero_constraints.copy_from(zero_constraints), reference:
        source/fsi.cpp:478-484)."""
        fluid, solid = self.fluid, self.solid
        moved = self._solid_moved_verts()
        fluid.fsi_stress_cell = torch.zeros_like(fluid.fsi_stress_cell)
        if not self.use_dirichlet_bc:
            fluid.fsi_acceleration = self._kernels.fsi_acceleration(
                moved, solid.current_acceleration, fluid.indicator)
            return None, (fluid.nonzero_constraints if first_step
                          else fluid.zero_constraints)
        fluid.fsi_acceleration = torch.zeros_like(fluid.fsi_acceleration)
        base = fluid.nonzero_constraints if first_step else \
            fluid.zero_constraints
        return self._fluid_constraints(moved, solid.current_velocity,
                                       fluid.present_solution, base)

    def find_solid_bc(self):
        """Fluid stress -> solid boundary traction
        (reference: source/fsi.cpp:313-382)."""
        self.solid.fsi_traction = self._kernels.solid_traction(
            self._solid_moved_verts(), self.fluid.present_solution,
            self.fluid.stress_device)

    # ------------------------------------------------------------------
    def save_checkpoint(self):
        """Coordinated solid + fluid checkpoint (reference:
        source/mpi_fsi.cpp:1221-1225)."""
        self.solid.save_checkpoint(self.time.get_timestep())
        self.fluid.save_checkpoint(self.time.get_timestep())

    def load_checkpoint(self) -> bool:
        """Restore both solvers from the latest coordinated checkpoints in
        the working directory and advance the clock to their step
        (reference: source/mpi_fsi.cpp:1127-1134).  False when there are
        none; a lone solid or fluid checkpoint, or unequal times, raises,
        as the reference's unconditional AssertThrow does (a fresh start
        would leave the loaded solver's state advanced)."""
        solid_loaded = self.solid.load_checkpoint()
        fluid_loaded = self.fluid.load_checkpoint()
        if solid_loaded != fluid_loaded:
            raise RuntimeError(
                "Inconsistent restart files: solid checkpoint "
                f"{'found' if solid_loaded else 'missing'} but fluid "
                f"checkpoint {'found' if fluid_loaded else 'missing'}. "
                "Check and remove inconsistent restart files!")
        if not solid_loaded:
            return False
        if abs(self.solid.time.current() - self.fluid.time.current()) \
                >= 1e-12:
            raise RuntimeError(
                "Solid and fluid restart files have different time steps. "
                "Check and remove inconsistent restart files!")
        while self.time.get_timestep() < self.solid.time.get_timestep():
            self.time.increment()
        return True

    def _interface_levels(self):
        """(min, max) levels of the interface refinement: the serial
        coupler refines one level (reference: source/fsi.cpp:499-506)."""
        gr = self.params.global_refinements[0]
        return gr, gr + 1

    def refine_mesh(self, min_level: int, max_level: int,
                    verbose: bool = False):
        """Refine the fluid cells within one diameter of the moved solid
        boundary up to max_level and coarsen the rest (sibling families
        only, down to min_level), with solution transfer (reference:
        source/fsi.cpp:385-456).  An attached turbulence model's nu~ is
        transferred and its tables rebuilt (reference:
        source/mpi_fsi.cpp:1092-1117); then the coupling tables."""
        from ..fe.transfer import transfer_nodal_field
        fluid = self.fluid
        self._sync_coupling()      # the solid's boundary on its own mesh
        moved = self._solid_moved_verts().cpu().numpy()
        bpts = moved[self._solid_bface_verts.cpu().numpy()].mean(axis=1)
        fmesh = fluid.mesh
        fc = fmesh.cell_centers()
        dist = np.linalg.norm(fc[:, None, :] - bpts[None, :, :],
                              axis=-1).min(axis=1)
        near = dist < fmesh.cell_diameters()
        flags = near & (fmesh.level < max_level)
        mesh2, old_to_new = fmesh.coarsen(~near, min_level)
        if not flags.any() and mesh2.n_cells == fmesh.n_cells:
            return
        old_u, old_p = fluid.u_space, fluid.p_space
        old_solution, n_u_old = fluid.present_solution, fluid.n_u
        rflags = np.zeros(mesh2.n_cells, dtype=bool)
        rflags[old_to_new[flags]] = True
        fluid.mesh = mesh2.refine(rflags)
        fluid.setup()
        self._enable_fluid_mg()
        if verbose:
            print(f"FSI refine: {fmesh.n_cells} -> "
                  f"{fluid.mesh.n_cells} fluid cells")
        pts_u = fluid.u_space.node_points
        u_new = transfer_nodal_field(
            fmesh, old_u, old_solution[:n_u_old].reshape(-1, fluid.dim),
            pts_u)
        p_new = transfer_nodal_field(fmesh, old_p, old_solution[n_u_old:],
                                     fluid.p_space.node_points)
        fluid.present_solution = fluid.nonzero_constraints.distribute(
            torch.cat([u_new.reshape(-1), p_new]))
        fluid.update_stress()
        tm = getattr(fluid, "turbulence_model", None)
        if tm is not None and hasattr(tm, "space"):
            nu_old = tm.present_solution
            tm.setup()
            tm.present_solution = transfer_nodal_field(fmesh, old_u, nu_old,
                                                       pts_u)
            tm.update_eddy_viscosity()
        self._setup_coupling()

    def _sync_coupling(self):
        """Rebuild the coupling tables when either mesh changed since they
        were built (a LinearElasticity solid refines itself inside FSI
        runs, reference: source/linear_elasticity.cpp:317)."""
        if not _same_meshes(self._coupling_meshes,
                            (self.fluid.mesh, self.solid.mesh)):
            self._setup_coupling()

    # ------------------------------------------------------------------
    def _run_solid_step(self, first_step: bool) -> int:
        """Advance the solid one step on the per-phase path; returns the
        number of retries (the serial coupler makes none)."""
        self.solid.run_one_step(first_step)
        return 0

    def _run_phases(self, first_step: bool, verbose: bool) -> int:
        """One step of the per-phase loop (reference: source/fsi.cpp:
        484-506); returns the solid's retries."""
        with self.timer.scope("Find solid BC"):
            self.find_solid_bc()
        with self.timer.scope("Run solid solver"):
            retries = self._run_solid_step(first_step)
        # the solid's step may have refined its mesh
        self._sync_coupling()
        with self.timer.scope("Update indicator"):
            self.update_solid_box_and_indicator()
        with self.timer.scope("Find fluid BC"):
            zero_ext, nonzero_ext = self.find_fluid_bc(first_step)
        with self.timer.scope("Run fluid solver"):
            self._run_fluid_step(zero_ext, nonzero_ext, verbose)
        return retries

    def _setup_run(self, loaded: bool = False):
        """run()'s set-up: the global refinement and both solvers (unless
        `loaded` from checkpoints, which set them up), then the pressure
        V-cycle and the coupling tables."""
        if not loaded:
            params = self.params
            self.solid.mesh = self.solid.mesh.refine_global(
                params.global_refinements[1])
            self.solid.setup()
            self.fluid.mesh = self.fluid.mesh.refine_global(
                params.global_refinements[0])
            self.fluid.setup()
        self._enable_fluid_mg()
        self._setup_coupling()

    def run(self, verbose: bool = True):
        """reference: source/fsi.cpp:459-516."""
        self._setup_run()
        self._initial_refinement(verbose)
        self._time_loop(verbose)

    def resume(self, verbose: bool = True):
        """Continue a run from the latest coordinated checkpoints in the
        working directory (run() starts fresh, as the reference's serial
        coupler does; MPIFSI.run restarts by itself): both solvers
        restored at the saved step and mesh, then run()'s loop with no
        first step."""
        if not self.load_checkpoint():
            raise RuntimeError("no coordinated checkpoints to resume from "
                               "in the working directory")
        self._setup_run(loaded=True)
        self._time_loop(verbose, first_step=False)

    def _initial_refinement(self, verbose: bool):
        """The interface refinement x2 before the first step, when the
        refinement interval is shorter than the run (reference:
        source/fsi.cpp:499-506)."""
        if self.params.refinement_interval < self.params.end_time:
            self.refine_mesh(*self._interface_levels(), verbose=verbose)
            self.refine_mesh(*self._interface_levels(), verbose=verbose)

    def _time_loop(self, verbose: bool, fuse: bool = True, after_step=None,
                   first_step: bool = True):
        """The time loop of run(): the per-phase first step (none after a
        restart: first_step False), then coupled steps where `fuse` and
        _can_fuse_step allow; after each step the clock, `after_step()`,
        interface refinement and checkpoints at their intervals.  The
        coupling tables follow a mesh that changed (_sync_coupling).  Logs
        each step in self.step_log (its seconds include after_step)."""
        if verbose:
            print(f"{type(self).__name__}: fluid cells/dofs "
                  f"[{self.fluid.mesh.n_cells}, "
                  f"{self.fluid.n_dofs}], solid cells/dofs "
                  f"[{self.solid.mesh.n_cells}, {self.solid.n_dofs}]")

        # one entry per step: path taken, Newton, retry and Krylov counts
        # (a turbulence model's Newton and FGMRES counts), time
        self.step_log = []
        tm = getattr(self.fluid, "turbulence_model", None)
        while self.time.end() - self.time.current() > 1e-12:
            t0 = time.perf_counter()
            self._sync_coupling()
            # a refinement's setup() replaces the fluid's counters
            krylov = getattr(self.fluid, "krylov_iters", {})
            k0 = dict(krylov)
            sa0 = tm.krylov_iters["fgmres"] if tm is not None else 0
            coupled = fuse and not first_step and self._can_fuse_step()
            retries = 0
            if coupled:
                with self.timer.scope("Coupled device step"):
                    self.run_one_coupled_step(verbose)
            else:
                retries = self._run_phases(first_step, verbose)
                first_step = False
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            entry = dict(
                step=self.time.get_timestep() + 1, coupled=coupled,
                solid_newton=getattr(self.solid, "newton_iters", None),
                fluid_newton=self.fluid.newton_iters, solid_retries=retries,
                krylov={k: v - k0[k] for k, v in krylov.items()})
            if tm is not None:
                entry.update(sa_newton=tm.newton_iters,
                             sa_fgmres=tm.krylov_iters["fgmres"] - sa0)
            self.time.increment()
            if after_step is not None:
                after_step()
            entry["seconds"] = time.perf_counter() - t0
            self.step_log.append(entry)
            if self.time.time_to_refine():
                self.refine_mesh(*self._interface_levels(), verbose=verbose)
            if self.time.time_to_save():
                self.save_checkpoint()


class _FSIKernels:
    """Coupling kernels bound to static mesh tables."""

    def __init__(self, fsi: FSI):
        fluid, solid = fsi.fluid, fsi.solid
        d = fluid.dim
        scell = fsi._solid_cells
        sdeg = solid.params.solid_degree
        s_space_dofs = fsi._tensor(solid.space.cell_dofs, torch.int64)
        u_space_dofs = fsi._tensor(fluid.u_space.cell_dofs, torch.int64)
        p_cell_dofs = fsi._tensor(fluid.p_space.cell_dofs, torch.int64)
        s_build, s_locate = fsi._solid_hash
        g = torch.zeros(d, dtype=real_dtype(), device=fsi.device)
        g[:len(fsi.params.gravity)] = fsi._tensor(fsi.params.gravity[:d])

        def points_in_solid(points, moved):
            state = s_build(moved[scell])  # rebuilt on the deformed config
            idx, unit, found = s_locate(state, points)
            box_lo = moved.amin(dim=0)
            box_hi = moved.amax(dim=0)
            inbox = torch.all((points >= box_lo) & (points <= box_hi),
                              dim=-1)
            return idx, unit, found & inbox

        def indicator(moved):
            _, _, found = points_in_solid(fsi._fluid_centers, moved)
            return found

        def fsi_acceleration(moved, solid_acc, indicator_field):
            """(rho_s - rho_f)(g - a_s) at covered fluid cell centers
            (reference: source/fsi.cpp:241-251)."""
            idx, unit, found = points_in_solid(fsi._fluid_centers, moved)
            a_s = interpolate_nodal(solid_acc.reshape(-1, d), s_space_dofs,
                                    idx, unit, sdeg, found)
            acc = (fsi.params.solid_rho - fsi.params.fluid_rho) * (g - a_s)
            return acc * indicator_field[:, None]

        def dirichlet_bc(moved, solid_vel):
            """FSI velocity constraints at covered fluid support points
            (reference: source/fsi.cpp:252-297)."""
            idx, unit, found = points_in_solid(fsi._fluid_u_points, moved)
            inside = found & fsi._u_node_eligible
            v_s = interpolate_nodal(solid_vel.reshape(-1, d), s_space_dofs,
                                    idx, unit, sdeg, found)
            mask = inside[:, None].expand(v_s.shape)
            return mask, torch.where(mask, v_s, 0.0)

        fdeg = fluid.params.fluid_velocity_degree
        pdeg = fluid.params.fluid_pressure_degree
        bface = fsi._solid_bface_verts  # (n_bf, 2**(d-1)) vertex ids

        def solid_traction(moved, fluid_solution, fluid_stress_nodes):
            """traction = (-p I + tau) n at moved solid boundary face
            centers (reference: source/fsi.cpp:313-382).
            fluid_stress_nodes: (n_scalar_nodes, d, d)."""
            fverts = moved[bface]              # (n_bf, nfv, d)
            centers = fverts.mean(dim=1)
            idx, unit, found = fsi._fluid_locate(fsi._fluid_hash_state,
                                                 centers)
            p_val = interpolate_nodal(fluid_solution[fluid.n_u:],
                                      p_cell_dofs, idx, unit, pdeg, found)
            tau = interpolate_nodal(fluid_stress_nodes, u_space_dofs, idx,
                                    unit, fdeg, found)
            I = torch.eye(d, dtype=moved.dtype, device=moved.device)
            sigma = -p_val[:, None, None] * I + tau
            # outward normal of the moved face
            if d == 2:
                tv = fverts[:, 1] - fverts[:, 0]
                n = torch.stack([tv[:, 1], -tv[:, 0]], dim=-1)
            else:
                n = torch.linalg.cross(fverts[:, 1] - fverts[:, 0],
                                       fverts[:, 2] - fverts[:, 0])
            n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
            # orient outward: away from the moved cell center
            ccenters = moved[scell[fsi._solid_bface_cells]].mean(dim=1)
            sign = torch.sign(torch.einsum("fd,fd->f", n,
                                           centers - ccenters))
            n = n * torch.where(sign == 0, 1.0, sign)[:, None]
            return torch.einsum("fab,fb->fa", sigma, n)

        self.points_in_solid = points_in_solid
        self.indicator = indicator
        self.fsi_acceleration = fsi_acceleration
        self.dirichlet_bc = dirichlet_bc
        self.solid_traction = solid_traction
