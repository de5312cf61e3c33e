"""Meshfree hypo-elastic solid (RKPM + explicit RK4).

Counterpart of openifem_tpu/solvers/solid/hypo.py (reference:
include/hypo_elasticity.h, source/hypo_elasticity.cpp, a wrapper over the
optional `rkpm-rk4` C++ library; and include/mpi_shared_hypo_elasticity.h,
source/mpi_shared_hypo_elasticity.cpp, the fsi-wall-3D solid):

 - particles at mesh vertices carry mass/velocity/position
   (reference: source/hypo_elasticity.cpp:144-185)
 - integration points at the cells' Gauss points carry stress and
   quadrature weights (reference: source/hypo_elasticity.cpp:186-210)
 - RKPM shape functions with linear reproducing conditions (cubic-spline
   window corrected with the moment matrix), evaluated particle -> quad
   point as fixed-K neighbour tables built once on the host in numpy
 - hypo-elastic rate form with Jaumann objectivity:
     sigma_dot = lambda tr(d) I + 2 mu d + w sigma - sigma w
 - classic RK4 in time, FSI traction at boundary quadrature points.

Each RK4 stage is a gather over the neighbour tables, a few small einsums
and two scatter-adds into the particles (la/operators.py: index_add_ on
the CPU, a planned sum in a fixed order on CUDA, so a CUDA run repeats to
the bit, and the CUDA and CPU sums round differently).  The FE-facing
interface matches the other solid solvers (current_displacement/velocity/
acceleration at vertex dofs), so the couplers and VTU output work
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import real_dtype
from ...fe.fevalues import cell_values, face_values
from ...fe.shapes import gauss_quadrature
from ...fe.space import FESpace, SystemSpace
from ...la.operators import add_at, index_sum
from ...parameters import AllParameters, component_flag_to_mask
from .base import SolidSolverBase
from .materials import lame_parameters
from .shared import SharedSolidMixin


def cubic_spline(q):
    """Cubic spline window W(q), support q < 2 (reference:
    source/utilities.cpp:103-123 uses the same kernel family)."""
    return np.where(
        q < 1.0, 1.0 - 1.5 * q ** 2 + 0.75 * q ** 3,
        np.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0))


def rkpm_shapes(points, particles, h):
    """Linear-consistency RKPM shape values and gradients (dense).

    points: (n_q, d) evaluation points; particles: (n_p, d); h: smoothing
    length. Returns (psi (n_q, n_p), dpsi (n_q, n_p, d)) with
    sum_j psi = 1, sum_j psi x_j = x, and exact gradients of linears."""
    d = points.shape[1]
    rel = (particles[None, :, :] - points[:, None, :]) / h  # (q, p, d)
    q = np.linalg.norm(rel, axis=-1)
    w = cubic_spline(q)                                     # (q, p)
    # basis P = [1, xi_1..xi_d]
    P = np.concatenate([np.ones(rel.shape[:2] + (1,)), rel], axis=-1)
    M = np.einsum("qpa,qpb,qp->qab", P, P, w)               # (q, d+1, d+1)
    Minv = np.linalg.inv(M + 1e-12 * np.eye(d + 1))
    e0 = np.zeros(d + 1)
    e0[0] = 1.0
    c = np.einsum("qab,b->qa", Minv, e0)                    # reproduce 1
    psi = np.einsum("qa,qpa,qp->qp", c, P, w)
    dpsi = np.zeros(points.shape[:1] + particles.shape[:1] + (d,))
    for k in range(d):
        ek = np.zeros(d + 1)
        ek[k + 1] = 1.0
        ck = np.einsum("qab,b->qa", Minv, ek)
        # implicit-gradient RKPM: derivative reproducing condition
        dpsi[:, :, k] = np.einsum("qa,qpa,qp->qp", ck, P, w) / h
    return psi, dpsi


def rkpm_shapes_sparse(points, particles, h, chunk: int = 2048):
    """Sparse fixed-K RKPM tables: (idx (n_q, K), psi (n_q, K),
    dpsi (n_q, K, d)).

    The cubic-spline window has support radius 2h, so each evaluation
    point sees only the particles within that ball.  K is the largest
    neighbour count over the points, so every RKPM contraction is a gather
    and a small einsum with static shapes.  Unused slots carry idx=0,
    psi=0 (exact zeros, so scatter-adds are unaffected).  The same values
    as rkpm_shapes on the shared support (same moment-matrix correction,
    built per chunk)."""
    n_q, d = points.shape
    cut = 2.0 * h
    # K = max number of particles within the window over all points
    counts = np.zeros(n_q, dtype=np.int64)
    for s in range(0, n_q, chunk):
        e = min(s + chunk, n_q)
        dist = np.linalg.norm(particles[None, :, :] -
                              points[s:e, None, :], axis=-1)
        counts[s:e] = (dist < cut).sum(axis=1)
    K = int(counts.max())
    idx = np.zeros((n_q, K), dtype=np.int64)
    psi = np.zeros((n_q, K))
    dpsi = np.zeros((n_q, K, d))
    e0 = np.zeros(d + 1)
    e0[0] = 1.0
    eye = np.eye(d + 1)
    for s in range(0, n_q, chunk):
        e = min(s + chunk, n_q)
        rel = (particles[None, :, :] - points[s:e, None, :]) / h
        q = np.linalg.norm(rel, axis=-1)
        inside = q < 2.0
        # stable top-K selection: in-window particles first
        order = np.argsort(~inside, axis=1, kind="stable")[:, :K]
        ii = np.arange(e - s)[:, None]
        rel_k = rel[ii, order]                      # (c, K, d)
        w = cubic_spline(np.linalg.norm(rel_k, axis=-1))
        w = np.where(inside[ii, order], w, 0.0)
        P = np.concatenate([np.ones(rel_k.shape[:2] + (1,)), rel_k],
                           axis=-1)
        M = np.einsum("qka,qkb,qk->qab", P, P, w)
        Minv = np.linalg.inv(M + 1e-12 * eye)
        c0 = np.einsum("qab,b->qa", Minv, e0)
        psi[s:e] = np.einsum("qa,qka,qk->qk", c0, P, w)
        for k in range(d):
            ck = np.einsum("qab,b->qa", Minv, eye[k + 1])
            dpsi[s:e, :, k] = np.einsum("qa,qka,qk->qk", ck, P, w) / h
        idx[s:e] = order
    return idx, psi, dpsi


class HypoElasticity(SolidSolverBase):
    """FE-interfaced meshfree hypo-elastic solver."""

    h_factor = 1.3  # smoothing length / particle spacing
    # the RK4 rates in f32 (state and RK4 sums stay f64): a per-stage
    # roundoff choice (~1e-7 rel) of the JAX bench, not a tolerance
    f32_rates = False

    # ------------------------------------------------------------------
    def setup(self):
        params, mesh = self.params, self.mesh
        d = self.dim
        t = self._tensor
        # FE facade (vertex dofs) so FSI/IO see a standard solid solver
        self.space = FESpace(mesh, 1)
        self.sys = SystemSpace([(self.space, d)])
        self.n_dofs = self.sys.n_dofs
        nq = params.solid_degree + 1
        self.cv = cell_values(self.space, nq)
        self.fv = face_values(self.space, nq)

        X = mesh.vertices                       # particles (n_p, d)
        n_p = len(X)
        qpts = self.cv.xq.reshape(-1, d)        # integration points
        qw = self.cv.JxW.reshape(-1)
        dx = float(np.mean(mesh.cell_diameters())) / np.sqrt(d)
        h = self.h_factor * dx

        idx_q, psi_q, dpsi_q = rkpm_shapes_sparse(qpts, X, h)
        # lumped particle masses from quadrature of the density
        m = np.zeros(n_p)
        np.add.at(m, idx_q.ravel(),
                  ((qw * params.solid_rho)[:, None] * psi_q).ravel())
        self.mass = t(m)
        self.idx_q = t(idx_q, torch.int64)
        self.psi_q = t(psi_q)
        self.dpsi_q = t(dpsi_q)
        # the slots whose force terms can be nonzero: the padding of the
        # fixed-K tables (dpsi = 0) stays out of the card's sum plans
        self._live_q = t((dpsi_q != 0).any(axis=-1), torch.bool)
        self.qw = t(qw)

        # boundary quadrature (for traction)
        if self.fv is not None:
            bq = self.fv.xq.reshape(-1, d)
            idx_b, psi_b, _ = rkpm_shapes_sparse(bq, X, h)
            self.idx_b = t(idx_b, torch.int64)
            self.psi_b = t(psi_b)
            self._live_b = t(psi_b != 0, torch.bool)
            self.bqw = t(self.fv.JxW.reshape(-1))
            self.fsi_traction = torch.zeros((len(self.fv.cells), d),
                                            dtype=real_dtype(),
                                            device=self.device)

        # homogeneous Dirichlet mask at particles
        fixed = np.zeros((n_p, d), dtype=bool)
        bmap = self.space.boundary_node_map()
        for bid, flag in params.solid_dirichlet_bcs.items():
            if bid not in bmap:
                continue
            mask = component_flag_to_mask(flag, d)
            for dd in range(d):
                if mask[dd]:
                    fixed[bmap[bid], dd] = True
        self.fixed = t(fixed, torch.bool)
        g = np.zeros(d)
        g[:len(params.gravity)] = params.gravity[:d]
        self._gravity = t(g)

        self._lam, self._mu = lame_parameters(params.E[0], params.nu[0])

        self._ref_vertex_coords = t(X)
        self.x = t(X)
        self.v = torch.zeros((n_p, d), dtype=real_dtype(), device=self.device)
        self.sigma = torch.zeros((len(qpts), d, d), dtype=real_dtype(),
                                 device=self.device)
        self.n_p = n_p
        self._acc = torch.zeros_like(self.v)
        self._setup_done = True
        self._sync()

    # ------------------------------------------------------------------
    def _rates(self, v, sigma, traction_q):
        """(v_dot at particles, sigma_dot at quad points) given state."""
        d = self.dim
        lam, mu = self._lam, self._mu
        out_dtype = v.dtype
        rt = torch.float32 if self.f32_rates else v.dtype
        v = v.to(rt)
        sigma = sigma.to(rt)
        dpsi_q = self.dpsi_q.to(rt)
        qw = self.qw.to(rt)
        mass = self.mass.to(rt)
        # velocity gradient at quad points: L = sum_j v_j (x) dpsi_j
        # (gather over the fixed-K neighbour lists)
        v_g = v[self.idx_q]                                  # (q, K, a)
        L = torch.einsum("qkd,qka->qad", dpsi_q, v_g)
        Lt = L.transpose(1, 2)
        eps_dot = 0.5 * (L + Lt)
        w_spin = 0.5 * (L - Lt)
        I = torch.eye(d, dtype=rt, device=v.device)
        tr = torch.diagonal(eps_dot, dim1=1, dim2=2).sum(-1)
        sig_dot = (lam * tr[:, None, None] * I + 2 * mu * eps_dot
                   + torch.bmm(w_spin, sigma) - torch.bmm(sigma, w_spin))
        # internal nodal force: f_p = -sum_q V_q sigma_q . dpsi_p(X_q)
        contrib = -torch.einsum("qab,qkb->qka", qw[:, None, None] * sigma,
                                dpsi_q)
        f = index_sum(self.n_p, self.idx_q, contrib, self._live_q)
        f = f + mass[:, None] * self._gravity.to(rt)
        if traction_q is not None:
            tc = torch.einsum("bk,ba->bka",
                              self.bqw.to(rt)[:, None] * self.psi_b.to(rt),
                              traction_q.to(rt))
            f = add_at(f, self.idx_b, tc, live=self._live_b)
        a = f / mass[:, None]
        a = torch.where(self.fixed, 0.0, a)
        return a.to(out_dtype), sig_dot.to(out_dtype)

    def _rk4_step_impl(self, x, v, sigma, traction_q):
        dt = self.time.get_delta_t()

        def f(v_, s_):
            a, sd = self._rates(v_, s_, traction_q)
            return v_, a, sd

        k1 = f(v, sigma)
        k2 = f(v + dt / 2 * k1[1], sigma + dt / 2 * k1[2])
        k3 = f(v + dt / 2 * k2[1], sigma + dt / 2 * k2[2])
        k4 = f(v + dt * k3[1], sigma + dt * k3[2])
        x_n = x + dt / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        v_n = v + dt / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        v_n = torch.where(self.fixed, 0.0, v_n)
        s_n = sigma + dt / 6 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        return x_n, v_n, s_n, k4[1]

    # ------------------------------------------------------------------
    def _traction_now(self):
        """Traction at the boundary quadrature points for this step."""
        if self.fv is None:
            return None
        if self.params.simulation_type == "FSI":
            return self.fsi_traction.repeat_interleave(
                self.fv.JxW.shape[1], dim=0)
        return self._standalone_traction_q()

    def run_one_step(self, first_step: bool = False):
        """One RK4 step (reference: source/hypo_elasticity.cpp:34-94:
        m_body->step() + synchronize())."""
        tq = self._traction_now()
        self.time.increment()
        self.x, self.v, self.sigma, self._acc = self._rk4_step_impl(
            self.x, self.v, self.sigma, tq)
        self._sync()
        self._end_of_step_io(first_step)

    def _standalone_traction_q(self):
        params = self.params
        fv = self.fv
        n_f, n_q = fv.JxW.shape
        t = np.zeros((n_f * n_q, self.dim))
        for i in range(n_f):
            bid = int(fv.boundary_id[i])
            if bid in params.solid_neumann_bcs and \
                    params.simulation_type != "FSI":
                val = params.solid_neumann_bcs[bid]
                if params.solid_neumann_bc_type == "Traction":
                    t[i * n_q:(i + 1) * n_q] = np.asarray(val)[None, :]
                else:
                    t[i * n_q:(i + 1) * n_q] = \
                        np.asarray(fv.normals[i]) * val[0]
        return self._tensor(t)

    def _sync(self):
        """Copy particle state into the FE-facing vectors
        (reference: source/hypo_elasticity.cpp:96-141)."""
        disp = self.x - self._ref_vertex_coords
        self.current_displacement = disp.reshape(-1)
        self.current_velocity = self.v.reshape(-1)
        self.current_acceleration = self._acc.reshape(-1)
        self.previous_displacement = self.current_displacement
        self.previous_velocity = self.current_velocity
        self.previous_acceleration = self.current_acceleration

    # ------------------------------------------------------------------
    def output_results(self, step=None, prefix: str = "solid"):
        """VTU/PVD output of the FE-facing particle state (reference:
        SolidSolver::output_results + vtk_write_particle,
        source/mpi_shared_hypo_elasticity.cpp:59-96)."""
        from ...io.vtk import write_vtu
        from ...utils.pvd import PVDWriter
        if step is None:
            step = self.time.get_timestep()
        d = self.dim
        n_vert = self.mesh.n_vertices
        u = self.current_displacement.cpu().numpy().reshape(-1, d)
        v = self.current_velocity.cpu().numpy().reshape(-1, d)
        write_vtu(f"{prefix}-{step:06d}.vtu", self.mesh,
                  point_data={"displacements": u[:n_vert],
                              "velocities": v[:n_vert]},
                  cell_data={"material_id":
                             np.asarray(self.mesh.material_id)})
        if not hasattr(self, "_pvd"):
            self._pvd = PVDWriter(self.time, f"{prefix}.pvd")
        self._pvd.write_current_timestep(f"{prefix}-", 6)

    def _end_of_step_io(self, first_step: bool = False):
        """reference: source/mpi_shared_hypo_elasticity.cpp:62-101."""
        if first_step or self.time.time_to_output():
            self.output_results()
        if self.params.simulation_type == "Solid" and \
                self.time.time_to_save():
            self.save_checkpoint()

    # ------------------------------------------------------------------
    def save_checkpoint(self, step=None, prefix: str = "solid"):
        """Particle-state checkpoint (x, v, sigma), the JAX package's
        keys."""
        from ...io.checkpoint import save_checkpoint
        if step is None:
            step = self.time.get_timestep()
        save_checkpoint(prefix, step, {
            "x": self.x.cpu().numpy(), "v": self.v.cpu().numpy(),
            "sigma": self.sigma.cpu().numpy(),
            "time_current": self.time.current()})

    def load_checkpoint(self, prefix: str = "solid") -> bool:
        """Restore the particle state; applies the solid's global
        refinement itself when not yet set up."""
        from ...io.checkpoint import load_latest_checkpoint
        data = load_latest_checkpoint(prefix)
        if data is None:
            return False
        if not self._setup_done:
            self.mesh = self.mesh.refine_global(
                self.params.global_refinements[1])
            self.setup()
        if data["x"].shape != (self.n_p, self.dim):
            raise ValueError(
                f"RKPM checkpoint has {data['x'].shape} particles but the "
                f"mesh has {(self.n_p, self.dim)}: refinement state "
                "mismatch")
        self.x, self.v, self.sigma = (self._tensor(data[k])
                                      for k in ("x", "v", "sigma"))
        while self.time.get_timestep() < data["__step__"]:
            self.time.increment()
        self._sync()
        return True


class SharedHypoElasticity(SharedSolidMixin, HypoElasticity):
    """FSI-side RKPM solid (reference: include/mpi_shared_hypo_elasticity.h,
    source/mpi_shared_hypo_elasticity.cpp; the fsi-wall-3D solid).

    Coupling contract of the Shared* family:
     - `fsi_stress_rows` (n_nodes, d, d) nodal fluid stress set by
       MPIFSI.find_solid_bc; per step it is interpolated at the boundary
       face quadrature points ON THE MOVED FACES and dotted with the moved
       outward normal to give the particle traction
       (reference: source/mpi_shared_hypo_elasticity.cpp:127-233)
     - `update_strain_and_stress` / `stress` provide the nodal solid stress
       the coupler subtracts from the fluid stress (projection of the RKPM
       quadrature-point sigma with surrounding-cell averaging)

    (dx, hdx) are the reference ctor's particle spacing and smoothing
    ratio; dx defaults to the mesh vertex spacing."""

    def __init__(self, mesh, params: AllParameters, dx: float = None,
                 hdx: float = 1.3, device=None):
        super().__init__(mesh, params, device=device)
        self._dx = dx
        self._hdx = hdx
        self.h_factor = hdx

    def setup(self):
        if self._dx is not None:
            # smoothing length h = hdx * dx, as the reference ctor does
            d = self.dim
            mean_diam = float(np.mean(self.mesh.cell_diameters()))
            self.h_factor = self._hdx * self._dx * np.sqrt(d) / mean_diam
        super().setup()
        self._setup_shared_faces()

        # stress projection quadrature -> nodes (for find_fluid_bc)
        k = self.params.solid_degree
        qp, qw = gauss_quadrature(k + 1, self.dim)
        N, _ = self.space.shapes.evaluate(qp)
        Mref = np.einsum("qi,qj,q->ij", N, N, qw)
        self._qpt_to_dof = self._tensor(
            np.linalg.solve(Mref, (N * qw[:, None]).T))
        counts = np.zeros(self.space.n_nodes)
        np.add.at(counts, self.space.cell_dofs.ravel(), 1.0)
        self._node_counts = self._tensor(counts)
        self._cell_nodes = self._tensor(self.space.cell_dofs,
                                        torch.int64).reshape(-1)

        # initial velocity at particles
        iv = np.zeros(self.dim)
        iv[:len(self.params.initial_velocity)] = \
            self.params.initial_velocity[:self.dim]
        if np.any(iv != 0):
            v0 = self._tensor(iv).expand(self.v.shape)
            self.v = torch.where(self.fixed, 0.0, v0)
            self._sync()

    def moved_vertex_coords(self):
        return self.x

    def _fsi_traction_q_impl(self, x, fsi_stress_rows):
        """Traction at boundary-face quadrature points from the nodal
        fluid stress rows on the MOVED faces (reference:
        source/mpi_shared_hypo_elasticity.cpp:127-233)."""
        t_q, _ = self._traction_q(x, fsi_stress_rows)
        return t_q.reshape(-1, self.dim)

    def _device_step_impl(self, x, v, sigma, fsi_stress_rows):
        """One FSI RK4 step: traction from the nodal stress rows, then
        _rk4_step_impl.  Returns (x, v, sigma, acc)."""
        tq = self._fsi_traction_q_impl(x, fsi_stress_rows)
        return self._rk4_step_impl(x, v, sigma, tq)

    def _traction_now(self):
        if self.fv is not None and self.params.simulation_type == "FSI":
            return self._fsi_traction_q_impl(self.x, self.fsi_stress_rows)
        return super()._traction_now()

    def _nodal_stress_impl(self, sigma):
        """Projection of the RKPM quadrature stress to averaged nodal
        fields -> (n_nodes, d, d) (the layout the MPI coupler's
        fsi_stress_nodal consumes)."""
        d = self.dim
        n_c = self.cv.JxW.shape[0]
        sig = sigma.reshape(n_c, -1, d, d)
        cellwise = torch.einsum("iq,cqab->ciab",
                                self._qpt_to_dof.to(sigma.dtype), sig)
        out = index_sum(self.space.n_nodes, self._cell_nodes,
                        cellwise.reshape(-1, d, d))
        return out / self._node_counts.to(sigma.dtype)[:, None, None]

    def update_strain_and_stress(self):
        """Project the RKPM quadrature stress to averaged nodal fields.
        RKPM tracks no total strain; strain output is zero (the coupler
        consumes only the stress)."""
        nodal = self._nodal_stress_impl(self.sigma).cpu().numpy()
        self.stress = nodal.transpose(1, 2, 0)
        self.strain = np.zeros_like(self.stress)
