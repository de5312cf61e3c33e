"""Control-volume FSI analytics (the vocal-fold application).

Counterpart of openifem_tpu/fsi/cv_fsi.py (reference: include/cv_fsi.h,
source/cv_fsi.cpp).  Runs the MPI-semantics FSI loop and, after each step,
evaluates momentum / energy control-volume budgets and appends them to a
CSV file (the reference writes a long-header text file,
source/cv_fsi.cpp:1637-1825).  Two-dimensional, as the JAX package's.

Surface fluxes use exact sub-cell cutting: each fluid cell straddling an
inlet / outlet plane x = const is cut (the SurfaceCutter analog,
source/cv_fsi.cpp:6-58, 368-546); flux integrands are evaluated at the two
cut-segment endpoints with trapezoidal weights and the cut cell's volume
integrals are weighted by the kept volume fraction (shoelace polygon
area; the reference uses the Gauss theorem, source/cv_fsi.cpp:61-160).

Budget terms (CVValues, include/cv_fsi.h:119-213): inlet / outlet volume
flow, pressure force / work, momentum and KE fluxes, friction work and
turbulence efflux at the cuts, rate of momentum / kinetic energy (direct
and finite-difference), convective KE, pressure convection, dissipation,
compression work, SUPG / LSIC stabilisation rate, turbulence dissipation
rate, gap volume flow at the solid tip, deformed VF volume, max velocity,
pressure probe, VF drag / friction / work on the moved interface; the
Bernoulli contraction / jet head decomposition along the glottis
centreline path (source/cv_fsi.cpp:1243-1591) and the per-step solid-
boundary trace for POD post-processing (source/cv_fsi.cpp:1594-1634).

The set-up tables (control-volume cells, cut planes, the Bernoulli path)
are built once on the host, as the mesh layer is; the cut planes loop
only over the cells that straddle a plane.  Every budget term is computed
on the device: the cells that the JAX package selects per step (fluid
cells with indicator 0, the solid tip's cells) are weights and masks over
static cell lists here, and the whole budget comes back to the host as
one packed vector per step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fe.shapes import QkShapes, gauss_quadrature
from ..mesh.mesh import FACE_VERTICES
from ..solvers.fluid.supg import ATM, CP_TO_CV
from ..utils.timer import span as trace_span
from .interp import interpolate_nodal, invert_bilinear
from .mpi_fsi import MPIFSI

es = torch.einsum

# boundary edges of a z-order quad cell (vertex-index pairs)
_QUAD_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0)]
# the z-order quad's corners in cyclic order
_QUAD_CYCLE = [0, 1, 3, 2]
# gap tolerance of the Bernoulli decomposition (the reference's
# hard-coded value, source/cv_fsi.cpp:1245-1590)
GAP_TOL = 0.0045
# the Bernoulli head terms
HEAD_KEYS = ("rate_convection", "rate_pressure_grad", "acceleration",
             "rate_density", "rate_friction")
# the volume terms, accumulated over CV cells and cut cells
VOLUME_KEYS = ("rate_momentum", "previous_KE", "present_KE",
               "rate_kinetic_energy_direct", "convective_KE",
               "pressure_convection", "rate_dissipation",
               "rate_compression_work", "rate_stabilization",
               "rate_turbulence", "gap_volume_flow", "rate_friction_work",
               "rate_turbulence_efflux")
# the cut-plane terms and the budget keys they fill, inlet and outlet
SURFACE_KEYS = {"volume_flow": ("inlet_volume_flow", "outlet_volume_flow"),
                "pressure_force": ("inlet_pressure_force",
                                   "outlet_pressure_force"),
                "momentum_flux": ("momentum_inlet_flux",
                                  "momentum_outlet_flux"),
                "KE_flux": ("energy_inlet_flux", "energy_outlet_flux"),
                "rate_pressure_work": ("inlet_pressure_work",
                                       "outlet_pressure_work")}


def _polygon_area(pts):
    """Shoelace area of points ordered around their centroid."""
    if len(pts) < 3:
        return 0.0
    c = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    p = pts[np.argsort(ang)]
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


class ControlVolumeFSI(MPIFSI):
    def __init__(self, fluid, solid, params, use_dirichlet_bc: bool = False):
        super().__init__(fluid, solid, params, use_dirichlet_bc)
        self._cv_bounds = None
        self._centerline_y = None
        self._probe_point = None
        self.output_solid_boundary = False
        self.cv_history = []

    # -- reference API (include/cv_fsi.h:19-21) ------------------------
    def set_control_volume_boundary(self, x_in, x_out=None,
                                    y_low=None, y_top=None):
        """Accepts (x_in, x_out[, y_low, y_top]) or a single 4-list (the
        reference passes [x_in, x_out, y_low, y_top]; boundaries[3] is the
        glottis centreline used for the solid tip, cv_fsi.cpp:1252)."""
        if x_out is None:
            x_in, x_out, y_low, y_top = x_in
        self._cv_bounds = (float(x_in), float(x_out))
        self._centerline_y = float(y_top) if y_top is not None else None

    def set_pressure_probe(self, point):
        self._probe_point = np.asarray(point, dtype=np.float64)

    def set_output_solid_boundary(self, flag: bool = True):
        self.output_solid_boundary = flag

    # ------------------------------------------------------------------
    def _setup_coupling(self):
        super()._setup_coupling()
        if self._cv_bounds is not None:
            self._setup_cv()

    def _cut_plane(self, x_plane, keep):
        """Cut the fluid cells straddling x = x_plane.

        Returns a dict with the cells (k,), trapezoid weights (k, 2), kept
        volume fractions (k,) and the velocity / pressure shape values and
        physical velocity shape gradients at the two cut-segment endpoints
        (numpy; keep='right' for the inlet cut, 'left' for the outlet;
        reference: compute_cut_points / compute_volume_fraction,
        source/cv_fsi.cpp:6-160), or None when no cell straddles."""
        fluid = self.fluid
        mesh = fluid.mesh
        V = mesh.vertices
        left_all = V[mesh.cells, 0] <= x_plane               # (n_c, nv)
        straddle = left_all.any(axis=1) & ~left_all.all(axis=1)
        cells, segs, fracs = [], [], []
        for c in np.flatnonzero(straddle):
            cv = V[mesh.cells[c]]
            left = left_all[c]
            pts = []
            for a, b in _QUAD_EDGES:
                if left[a] != left[b]:
                    t = (x_plane - cv[a, 0]) / (cv[b, 0] - cv[a, 0])
                    pts.append(cv[a] + t * (cv[b] - cv[a]))
            if len(pts) != 2:
                continue
            pts = np.array(sorted(pts, key=lambda p: p[1]))
            keep_mask = (cv[:, 0] > x_plane) if keep == "right" else \
                (cv[:, 0] <= x_plane)
            poly = np.concatenate([cv[keep_mask], pts], axis=0)
            area = _polygon_area(cv)
            cells.append(c)
            segs.append(pts)
            fracs.append(_polygon_area(poly) / area if area > 0 else 0.0)
        if not cells:
            return None
        cells = np.asarray(cells, dtype=np.int64)
        segs = np.asarray(segs)                          # (k, 2, d)
        L = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=-1)
        w = np.stack([L / 2, L / 2], axis=1)             # trapezoid

        # unit coordinates of the endpoints in their parent cells
        cv_all = V[mesh.cells[cells]].repeat(2, axis=0)
        unit = invert_bilinear(torch.from_numpy(segs.reshape(-1, 2)),
                               torch.from_numpy(cv_all)).numpy()
        Nu, dNu = fluid.u_space.shapes.evaluate(unit)    # (2k, nlu[, d])
        Np_, _ = fluid.p_space.shapes.evaluate(unit)
        # physical gradients via the geometry Jacobian at each endpoint
        _, dNg = QkShapes(1, mesh.dim).evaluate(unit)
        J = np.einsum("nvd,nvx->ndx", dNg, cv_all)
        gu = np.einsum("nld,ndx->nlx", dNu, np.linalg.inv(J))
        k = len(cells)
        return dict(cells=cells, w=w, frac=np.asarray(fracs),
                    Nu=Nu.reshape(k, 2, -1), Np=Np_.reshape(k, 2, -1),
                    gu=gu.reshape(k, 2, gu.shape[1], -1))

    def _cell_tables(self, cells):
        """Device tables of the fluid cells `cells` for the volume
        integrals: dof tables, shape gradients, JxW, vertex x range."""
        fluid = self.fluid
        mesh = fluid.mesh
        t = self._tensor
        vx = mesh.vertices[mesh.cells[cells], 0]
        T = dict(cells=t(cells, torch.int64),
                 cu=t(fluid.u_space.cell_dofs[cells], torch.int64),
                 cp=t(fluid.p_space.cell_dofs[cells], torch.int64),
                 g=t(fluid.cv_u.grad[cells]), gp=t(fluid.cv_p.grad[cells]),
                 JxW=t(fluid.cv_u.JxW[cells]), vx=t(vx),
                 vx_min=t(vx.min(axis=1)), vx_max=t(vx.max(axis=1)))
        if hasattr(fluid, "_h_terms"):
            # the SUPG solver's shape gradients for the h heuristic
            T["gu_h"] = fluid.gu[T["cells"]]
            T["gp_h"] = fluid.gp[T["cells"]]
        return T

    def _setup_cv(self):
        fluid = self.fluid
        mesh = fluid.mesh
        t = self._tensor
        if fluid.dim != 2:
            raise ValueError("ControlVolumeFSI cuts planes of 2-D meshes")
        x_in, x_out = self._cv_bounds
        self._x_in, self._x_out = x_in, x_out
        self._Nu_q = t(fluid.cv_u.N)
        self._Np_q = t(fluid.cv_p.N)
        self._u_dofs = t(fluid.u_space.cell_dofs, torch.int64)
        self._p_dofs = t(fluid.p_space.cell_dofs, torch.int64)

        # CV cells: ALL vertices strictly inside (x_in, x_out]
        # (reference: source/cv_fsi.cpp:315-341)
        vx = mesh.vertices[mesh.cells, 0]            # (n_c, nv)
        self._cv_cells = np.where(
            ((vx > x_in) & (vx <= x_out)).all(axis=1))[0]
        self._cut_in = self._cut_plane(x_in, keep="right")
        self._cut_out = self._cut_plane(x_out, keep="left")

        # the volume integrals run over the CV cells (fraction 1) and the
        # cut cells (their kept fractions); the groups are disjoint
        groups = [(self._cv_cells, np.ones(len(self._cv_cells)))]
        self._cut_t = []
        for cut in (self._cut_in, self._cut_out):
            if cut is None:
                self._cut_t.append(None)
                continue
            groups.append((cut["cells"], cut["frac"]))
            self._cut_t.append(dict(
                cu=t(fluid.u_space.cell_dofs[cut["cells"]], torch.int64),
                cp=t(fluid.p_space.cell_dofs[cut["cells"]], torch.int64),
                w=t(cut["w"]), Nu=t(cut["Nu"]), Np=t(cut["Np"]),
                gu=t(cut["gu"])))
        cells = np.concatenate([g for g, _ in groups])
        self._vol = self._cell_tables(cells)
        self._vol_frac = t(np.concatenate([f for _, f in groups]))

        # Bernoulli streamline path: CV boundary cells hugging the glottis
        # centreline y_top (reference: source/cv_fsi.cpp:341-365, 436-500)
        self._path = self._ends = None
        if self._centerline_y is not None:
            cy = self._centerline_y
            centers = mesh.cell_centers()
            diam = mesh.cell_diameters()
            at_bdry = (mesh.boundary_id >= 0).any(axis=1)
            near = np.abs(centers[:, 1] - cy) < diam

            def bface_len(c):
                for f in range(2 * mesh.dim):
                    if mesh.boundary_id[c, f] >= 0:
                        vs = [int(mesh.cells[c, v])
                              for v in FACE_VERTICES[mesh.dim][f]]
                        return float(np.linalg.norm(
                            mesh.vertices[vs[1]] - mesh.vertices[vs[0]]))
                return 0.0

            def area_fraction(c):
                return bface_len(c) / _polygon_area(
                    mesh.vertices[mesh.cells[c]])

            sel = self._cv_cells[(at_bdry & near)[self._cv_cells]]
            if len(sel):
                self._path = self._cell_tables(sel)
                self._path_af = t([area_fraction(c) for c in sel])
            # partially-cut start / end cells at the CV planes
            ends = []
            for cut, plane, kind in ((self._cut_in, x_in, "contraction"),
                                     (self._cut_out, x_out, "jet")):
                if cut is None:
                    continue
                for c in cut["cells"]:
                    if not (at_bdry[c] and near[c]):
                        continue
                    v = mesh.vertices[mesh.cells[c], 0]
                    left, right = v.min(), v.max()
                    frac = (right - plane) / (right - left) \
                        if kind == "contraction" else \
                        (plane - left) / (right - left)
                    ends.append((int(c), frac * area_fraction(c),
                                 kind == "contraction"))
            if ends:
                self._ends = self._cell_tables(
                    np.array([c for c, _, _ in ends]))
                self._ends_w = t([w for _, w, _ in ends])
                self._ends_contraction = t([k for _, _, k in ends],
                                           torch.bool)

        if self._probe_point is not None:
            self._probe_t = t(self._probe_point[None, :])

    # ------------------------------------------------------------------
    def _eddy_q(self, N, cu):
        """The turbulence model's eddy viscosity at the points of shape
        table N ('ql' or 'kel') in the cells of dof table cu."""
        tm = self._tm
        if tm is None:
            return None
        ev = tm.eddy_viscosity_nodal[cu]
        return es("kel,kl->ke", N, ev) if N.dim() == 3 else \
            es("ql,cl->cq", N, ev)

    def _surface_integrals(self, cut, sol):
        """Flux integrals over one cut plane (reference integrands:
        source/cv_fsi.cpp:627-653), as device scalars."""
        if cut is None:
            return None
        fluid = self.fluid
        rho = self.params.fluid_rho
        mu = self.params.viscosity
        d = fluid.dim
        ul = sol[:fluid.n_u].reshape(-1, d)[cut["cu"]]   # (k, nlu, d)
        vel = es("kel,kla->kea", cut["Nu"], ul)
        pre = es("kel,kl->ke", cut["Np"], sol[fluid.n_u:][cut["cp"]])
        grad = es("kelx,kla->keax", cut["gu"], ul)
        eddy = self._eddy_q(cut["Nu"], cut["cu"])
        w = cut["w"]
        u1 = vel[..., 0]
        gv = es("kea,kea->ke", grad[..., 0], vel)

        def integ(q):
            return (q * w).sum()

        return dict(
            volume_flow=integ(u1), pressure_force=integ(pre),
            momentum_flux=integ(rho * u1 * u1),
            KE_flux=integ(0.5 * rho * u1 * (vel ** 2).sum(-1)),
            rate_pressure_work=integ(pre * u1),
            rate_friction_work=integ(mu * gv),
            rate_turbulence_efflux=(integ(eddy * gv) if eddy is not None
                                    else torch.zeros_like(w[0, 0])))

    # ------------------------------------------------------------------
    def _volume_fields(self, T, sol, prev):
        fluid = self.fluid
        d = fluid.dim
        u = sol[:fluid.n_u].reshape(-1, d)
        up = prev[:fluid.n_u].reshape(-1, d)
        p, pp = sol[fluid.n_u:], prev[fluid.n_u:]
        cu, cp, g, gp = T["cu"], T["cp"], T["g"], T["gp"]
        N, Np = self._Nu_q, self._Np_q
        F = dict(
            uq=es("ql,cla->cqa", N, u[cu]),
            uq_prev=es("ql,cla->cqa", N, up[cu]),
            G=es("cqlx,cla->cqax", g, u[cu]),
            pq=es("qn,cn->cq", Np, p[cp]),
            pq_prev=es("qn,cn->cq", Np, pp[cp]),
            gpq=es("cqnx,cn->cqx", gp, p[cp]), JxW=T["JxW"])
        # nodal-stress divergence (for the stabilisation residual,
        # reference: source/cv_fsi.cpp:941-959)
        F["stress_div"] = es("cqlx,clax->cqa", g, fluid.stress_device[cu])
        eddy = self._eddy_q(N, cu)
        F["eddy"] = eddy if eddy is not None else torch.zeros_like(T["JxW"])
        return F

    def _volume_integrals(self, T, weight, sol, prev, out, tip):
        """reference integrands: source/cv_fsi.cpp:797-1015, over the
        cells of T with per-cell weights (kept fraction, 0 for an
        artificial cell)."""
        fluid = self.fluid
        params = self.params
        rho, mu = params.fluid_rho, params.viscosity
        dt = self.time.get_delta_t()
        F = self._volume_fields(T, sol, prev)
        uq, up, G, pq, pqp, gpq, JxW = (F["uq"], F["uq_prev"], F["G"],
                                        F["pq"], F["pq_prev"], F["gpq"],
                                        F["JxW"])
        eddy = F["eddy"]
        divu = torch.diagonal(G, dim1=2, dim2=3).sum(-1)
        fr = weight[:, None]

        def add(key, q):
            out[key] = out[key] + (q * JxW * fr).sum()

        add("rate_momentum", rho * (uq[..., 0] - up[..., 0]) / dt)
        add("previous_KE", 0.5 * rho * (up ** 2).sum(-1))
        add("present_KE", 0.5 * rho * (uq ** 2).sum(-1))
        add("rate_kinetic_energy_direct",
            rho * es("cqa,cqa->cq", (uq - up) / dt, uq))
        # deal.II convention: vel_grad * u * u = ((grad u)^T u) . u
        uTG = es("cqa,cqax->cqx", uq, G)
        add("convective_KE", rho * es("cqx,cqx->cq", uTG, uq))
        add("pressure_convection", es("cqx,cqx->cq", gpq, uq))
        add("rate_dissipation", mu * (G ** 2).sum((2, 3)))
        add("rate_compression_work", pq * divu)
        add("rate_turbulence", eddy * (G ** 2).sum((2, 3)))

        # SUPG / LSIC stabilisation rate (reference: cv_fsi.cpp:846-938),
        # with the solver's h heuristic on the CURRENT velocity
        if "gu_h" in T:
            h_sum = 0.0
            for (l, w_, kind) in fluid._h_terms:
                gq = T["gu_h" if kind == "u" else "gp_h"][:, :, l, :]
                h_sum = h_sum + w_ * torch.abs(es("cqx,cqx->cq", uq, gq))
            v_norm = torch.linalg.vector_norm(uq, dim=-1)
            nu_eff = (mu + eddy) / rho
            pos_h = h_sum > 0
            h = torch.where(pos_h, 2 * v_norm / torch.where(pos_h, h_sum,
                                                            1.0), 0.0)
            hs = torch.where(h > 0, h, 1.0)
            tau_s = torch.where(
                h > 0, 1.0 / torch.sqrt((2 / dt) ** 2 + (2 * v_norm / hs) ** 2
                                        + (4 * nu_eff / hs ** 2) ** 2),
                dt / 2)
            re_loc = v_norm * h / (2 * nu_eff)
            z = torch.where(re_loc <= 3, re_loc / 3, 1.0)
            tau_l = h / 2 * v_norm * z
            sdiv = F["stress_div"] * ((mu + eddy) / mu)[..., None]
            mom_res = rho * ((uq - up) / dt + uTG) + gpq - sdiv
            cont_res = ((pq - pqp) / dt + CP_TO_CV * (ATM + pq) * divu +
                        es("cqx,cqx->cq", uq, gpq)) / ATM
            # tau_SUPG * (u . grad-row of the test) . mom_res with the
            # deal.II contraction u * G = (grad u)^T u
            supg = tau_s * es("cqx,cqx->cq", uTG, mom_res)
            add("rate_stabilization", supg + tau_l * rho * divu * cont_res)

        keep = weight > 0
        vmax = torch.where(keep[:, None],
                           torch.linalg.vector_norm(uq, dim=-1), 0.0).amax()
        out["max_velocity"] = torch.maximum(out["max_velocity"], vmax)

        # gap volume flow at the solid tip (reference: cv_fsi.cpp:983-1007)
        if tip is not None:
            strad = (T["vx_min"] <= tip) & (T["vx_max"] > tip) & keep
            flow = (uq[..., 0] * JxW).sum(dim=1)
            xdist = T["vx_max"] - T["vx_min"]
            out["gap_volume_flow"] = out["gap_volume_flow"] + torch.where(
                strad, flow / xdist, 0.0).sum()

    # ------------------------------------------------------------------
    def control_volume_analysis(self):
        """The budgets of the step just taken (reference:
        source/cv_fsi.cpp:549-1015; see the module doc), appended to
        cv_history and the CSV file.  One host read of the packed budget
        vector."""
        fluid, solid = self.fluid, self.solid
        params = self.params
        d = fluid.dim
        dt = self.time.get_delta_t()
        sol = fluid.present_solution
        prev = sol - fluid.solution_increment
        zero = torch.zeros((), dtype=sol.dtype, device=sol.device)
        out = {k: zero for k in VOLUME_KEYS}
        out["max_velocity"] = zero

        ins = self._surface_integrals(self._cut_t[0], sol)
        outs = self._surface_integrals(self._cut_t[1], sol)
        for term, (k_in, k_out) in SURFACE_KEYS.items():
            out[k_in] = ins[term] if ins is not None else zero
            out[k_out] = outs[term] if outs is not None else zero
        # friction work / turbulence efflux: -inlet +outlet
        # (reference: source/cv_fsi.cpp:728-748)
        for term in ("rate_friction_work", "rate_turbulence_efflux"):
            for sign, s in ((-1.0, ins), (1.0, outs)):
                if s is not None:
                    out[term] = out[term] + sign * s[term]

        # solid tip (for the gap flow; reference: cv_fsi.cpp:1252-1274)
        moved = solid.moved_vertex_coords()
        tip = None
        if self._centerline_y is not None:
            tip_i = torch.argmin(torch.abs(moved[:, 1] - self._centerline_y))
            tip = moved[tip_i, 0]

        # volume integrals: full CV cells + fraction-weighted cut cells,
        # skipping artificial (indicator != 0) cells
        # (reference: source/cv_fsi.cpp:1034-1066)
        keep = fluid.indicator[self._vol["cells"]] == 0
        self._volume_integrals(self._vol, torch.where(keep, self._vol_frac,
                                                      0.0),
                               sol, prev, out, tip)
        out["rate_kinetic_energy"] = (out["present_KE"] -
                                      out["previous_KE"]) / dt

        # deformed solid (VF) volume (reference: cv_fsi.cpp:1068-1078),
        # shoelace over each quad's corners in cyclic order
        sv = moved[self._solid_cells][:, _QUAD_CYCLE]      # (n_c, 4, 2)
        x, y = sv[..., 0], sv[..., 1]
        out["VF_volume"] = (0.5 * torch.abs(
            (x * y.roll(-1, dims=1)).sum(1) -
            (y * x.roll(-1, dims=1)).sum(1))).sum()

        # interface (VF) integrals on the moved solid boundary
        if hasattr(solid, "_face_geometry"):
            JxWf, normals = solid._face_geometry(moved)
            normals = normals * solid._face_orient[:, None, None]
            fq = es("fqv,fvd->fqd", self._solid_face_geo_N(),
                    moved[self._solid_bface_verts])
            idx, unit, found = self._fluid_locate(self._fluid_hash_state,
                                                  fq.reshape(-1, d))
            p_at = interpolate_nodal(
                sol[fluid.n_u:], self._p_dofs, idx, unit,
                params.fluid_pressure_degree, found).reshape(JxWf.shape)
            tau_at = interpolate_nodal(
                fluid.stress_device, self._u_dofs, idx, unit,
                params.fluid_velocity_degree, found).reshape(
                JxWf.shape + (d, d))
            u_at = interpolate_nodal(
                sol[:fluid.n_u].reshape(-1, d), self._u_dofs, idx, unit,
                params.fluid_velocity_degree, found).reshape(
                JxWf.shape + (d,))
            out["VF_drag"] = (p_at * normals[..., 0] * JxWf).sum()
            fric = es("fqij,fqj->fqi", tau_at, normals)
            out["VF_friction"] = (fric[..., 0] * JxWf).sum()
            out["rate_friction_work"] = out["rate_friction_work"] + (
                es("fqi,fqi->fq", fric, u_at) * JxWf).sum()
            out["rate_vf_work"] = (
                p_at * es("fqi,fqi->fq", u_at, normals) * JxWf).sum()

        if self._probe_point is not None:
            idx, unit, found = self._fluid_locate(self._fluid_hash_state,
                                                  self._probe_t)
            out["probed_pressure"] = interpolate_nodal(
                sol[fluid.n_u:], self._p_dofs, idx, unit,
                params.fluid_pressure_degree, found)[0]

        if self._centerline_y is not None:
            self._bernoulli_terms(out, sol, prev, moved)

        keys = list(out)
        packed = torch.stack([out[k] for k in keys]).cpu().tolist()
        out = dict(zip(keys, packed))
        out["time"] = self.time.current()
        self.cv_history.append(out)
        self._write_cv_output(out)
        return out

    def _cell_heads(self, T, sol, prev):
        """Per-cell integrals of the five Bernoulli head terms, (5, c)."""
        fluid, params = self.fluid, self.params
        rho, mu = params.fluid_rho, params.viscosity
        dt = self.time.get_delta_t()
        d = fluid.dim
        F = self._volume_fields(T, sol, prev)
        uq, up, pq, gpq, JxW = (F["uq"], F["uq_prev"], F["pq"], F["gpq"],
                                F["JxW"])
        g, cu = T["g"], T["cu"]
        # gradient of the PREVIOUS velocity (cv_fsi.cpp:1460-1461)
        upn = prev[:fluid.n_u].reshape(-1, d)
        Gp = es("cqlx,cla->cqax", g, upn[cu])
        # nodal-stress gradients
        gS = es("cqlx,clab->cqabx", g, fluid.stress_device[cu])
        conv = es("cqa,cqa->cq", uq, Gp[:, :, 0, :])
        acc = (uq[..., 0] - up[..., 0]) / dt
        phead = gpq[..., 0] / rho
        dens = pq / rho / (ATM + 2 * pq) * gpq[..., 0]
        scale = (mu + F["eddy"]) / (rho * mu)
        fric = (sum(gS[:, :, 0, dd, dd] for dd in range(d))
                - gS[:, :, 1, 1, 0]) * scale
        if d == 3:
            fric = fric - gS[:, :, 2, 2, 0] * scale
        return torch.stack([(q * JxW).sum(1)
                            for q in (conv, phead, acc, dens, fric)])

    def _bernoulli_terms(self, out, sol, prev, moved):
        """Bernoulli head decomposition along the glottis streamline path
        (reference: source/cv_fsi.cpp:1245-1590; 'half space' assumption).
        Contraction / jet regions split at the solid tip; per-cell volume
        integrals are converted to line averages by the boundary-face /
        cell-area fraction; GAP_TOL is the reference's hard-coded gap
        tolerance."""
        cy = self._centerline_y
        i_high = torch.argmin(torch.abs(moved[:, 1] - cy))
        highest_y = moved[i_high, 1]
        high = torch.abs(moved[:, 1] - highest_y) < GAP_TOL
        at_gap = torch.abs(highest_y - cy) < GAP_TOL
        ce_x = torch.where(at_gap, torch.where(high, moved[:, 0],
                                               np.inf).amin(),
                           moved[i_high, 0])
        js_x = torch.where(at_gap, torch.where(high, moved[:, 0],
                                               -np.inf).amax(),
                           moved[i_high, 0])
        out["contraction_end_x"] = ce_x
        out["jet_start_x"] = js_x
        zero = torch.zeros_like(ce_x)
        region = {"contraction": [zero] * 5, "jet": [zero] * 5}
        if self._path is not None:
            T = self._path
            in_c = (T["vx"] <= ce_x).all(dim=1)
            in_j = (T["vx"] > js_x).all(dim=1)
            heads = self._cell_heads(T, sol, prev) * self._path_af[None, :]
            for name, mask in (("contraction", in_c), ("jet", in_j)):
                region[name] = [r + torch.where(mask, h, 0.0).sum()
                                for r, h in zip(region[name], heads)]
        if self._ends is not None:
            heads = self._cell_heads(self._ends, sol, prev) * \
                self._ends_w[None, :]
            is_c = self._ends_contraction
            for name, mask in (("contraction", is_c), ("jet", ~is_c)):
                region[name] = [r + torch.where(mask, h, 0.0).sum()
                                for r, h in zip(region[name], heads)]
        for name, vals in region.items():
            for key, v in zip(HEAD_KEYS, vals):
                out[f"{key}_{name}"] = v

    def output_solid_boundary_vertices(self):
        """Per-step boundary trace for POD post-processing: one file per
        step with 'vertex-id  deformed-position  fluid-pressure' lines
        (reference: source/cv_fsi.cpp:1594-1634)."""
        solid = self.solid
        os.makedirs("solid_trace", exist_ok=True)
        moved = solid.moved_vertex_coords().cpu().numpy()
        vids = np.unique(solid._bface_verts.cpu().numpy())
        pn = getattr(solid, "fluid_pressure_nodal", None)
        pn = np.zeros(len(moved)) if pn is None else pn.cpu().numpy()
        fname = f"solid_trace/BoundaryTrace-{self.time.get_timestep():06d}"
        with open(fname, "w") as f:
            for v in vids:
                pos = " ".join(f"{x:.10g}" for x in moved[v])
                f.write(f"{v} {pos} {pn[v]:.10g}\n")

    def _solid_face_geo_N(self):
        """Bilinear geometry shape values at the solid face quadrature
        points, (n_f, n_q, face vertices)."""
        if getattr(self, "_sfN_mesh", None) is not self.solid.mesh:
            d = self.solid.dim
            qp, _ = gauss_quadrature(self.params.solid_degree + 1, d - 1)
            if d == 2:
                N = np.stack([1 - qp[:, 0], qp[:, 0]], axis=1)
            else:
                N, _ = QkShapes(1, 2).evaluate(qp)
            nf = len(self.solid.fv.cells)
            self._sfN = self._tensor(N).expand((nf,) + N.shape)
            self._sfN_mesh = self.solid.mesh
        return self._sfN

    def _write_cv_output(self, out):
        fname = "control_volume_analysis.csv"
        new = not os.path.exists(fname) or self.time.get_timestep() <= 1
        keys = sorted(k for k in out if k != "time")
        with open(fname, "w" if new else "a") as f:
            if new:
                f.write("time," + ",".join(keys) + "\n")
            f.write(f"{out['time']:.10g}," +
                    ",".join(f"{out.get(k, 0.0):.10g}" for k in keys) + "\n")

    # ------------------------------------------------------------------
    def _after_step(self):
        span = self.step_span or trace_span
        if self._cv_bounds is not None:
            with span("CV analysis"):
                self.control_volume_analysis()
        if self.output_solid_boundary:
            self.output_solid_boundary_vertices()

    def run(self, verbose: bool = True):
        """reference: source/cv_fsi.cpp:160-281: the per-phase MPI loop
        (no coupled step, no restart), then the budgets and the solid
        trace after every step; interface refinement with levels
        (gr, gr + 3) and coordinated checkpoints at their intervals
        (:269-279; the refinement's _setup_coupling rebuilds the
        control-volume tables on the new mesh)."""
        params = self.params
        self.solid.mesh = self.solid.mesh.refine_global(
            params.global_refinements[1])
        self.solid.setup()
        self.fluid.mesh = self.fluid.mesh.refine_global(
            params.global_refinements[0])
        self.fluid.setup()
        self._setup_coupling()
        self._time_loop(verbose, fuse=False, after_step=self._after_step)
