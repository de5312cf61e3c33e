"""Plain reference of the fsi_leaflet configuration: the Taylor-Hood fluid
(fem.py), the Neo-Hookean leaflet (solid.py) and the serial mIFEM coupling
with Dirichlet velocity constraints, stepped from rest with the seeded
inflow.  Imports nothing of the program; the meshes come from the frozen
copy of the generator (frozen_mesh/).

One coupled step, as OpenIFEM's FSI::run makes it (source/fsi.cpp:484-506):
  1. traction on each solid boundary face: (-p I + tau) n of the fluid
     state at the start of the step, at the moved face's centre, n the
     moved face's outward normal (source/fsi.cpp:313-382);
  2. a Newmark step of the solid under that traction;
  3. the indicator: the fluid cells whose centre lies in the moved solid
     (source/fsi.cpp:64-165);
  4. the fluid's velocity at every eligible Q2 node inside the moved solid
     is constrained to the solid's velocity there (source/fsi.cpp:
     252-297); constraints already there win;
  5. the fluid step.
The first step starts both solids from rest: the solid's initial
acceleration solves M a0 = f, and the fluid's start carries the inflow.
A point lies in a cell where its bilinear preimage is within 1e-8 of the
unit square and the point within 1e-10 of the cell's bounding box (the
lowest such cell wins); a point in the solid must also lie in the bounding
box of the moved solid.  Everything runs in the fluid's precision: float64,
or float32 in the control."""

from __future__ import annotations

import numpy as np
import torch

from .fem import TaylorHood, fluid_checks, match, rel_gap, tensor_shapes
from .frozen_mesh import generators
from .solid import Solid


def meshes(geom, refinements):
    """(fluid, solid) meshes: the channel with one level of refinement in
    a band around the leaflet, and the leaflet, each refined globally as
    the configuration says (tests/test_fsi.py:66-86)."""
    L, H, a, b, h = (geom[k] for k in ("L", "H", "a", "b", "h"))
    fluid = generators.subdivided_hyper_rectangle(
        [int(L / h), int(H / h)], [0.0, 0.0], [L, H])
    c = fluid.cell_centers()
    band = (c[:, 0] >= L / 4 - a) & (c[:, 0] <= L / 4 + 2 * a) & \
        (c[:, 1] < H / 2)
    fluid = fluid.refine(band)
    fluid = fluid.refine_global(refinements[0])
    solid = generators.subdivided_hyper_rectangle(
        [max(1, int(a / h)), int(b / h)], [L / 4, 0.0], [a + L / 4, b])
    return fluid, solid.refine_global(refinements[1])


def inflow_fn(geom, scale):
    L, H, U = geom["L"], geom["H"], geom["U"] * scale

    def fn(points, comp):
        out = np.zeros(len(points))
        if comp == 0:
            m = np.abs(points[:, 0]) < 1e-10
            out[m] = U - 4 * U / (H * H) * (points[m, 1] - H / 2) ** 2
        return out
    return fn


def invert_bilinear(points, cv, n_iter=8):
    """Unit coordinates (n, 2) of points (n, 2) under the bilinear maps of
    cells (n, 4, 2)."""
    xi = np.full_like(points, 0.5)
    for _ in range(n_iter):
        G, dG = (z.astype(points.dtype) for z in tensor_shapes(1, xi))
        X = np.einsum("nv,nvx->nx", G, cv)
        J = np.einsum("nvd,nvx->nxd", dG, cv)
        xi = xi + np.linalg.solve(J, (points - X)[..., None])[..., 0]
    return xi


def locate(points, cell_verts):
    """(cell index or -1, unit coordinates) of each point.  In float32 (the
    control) the tolerances widen to what its own rounding needs."""
    eps = 64 * np.finfo(points.dtype).eps
    tol_box, tol_unit = max(1e-10, eps), max(1e-8, eps)
    lo = cell_verts.min(axis=1) - tol_box
    hi = cell_verts.max(axis=1) + tol_box
    cand = np.all((points[:, None] >= lo[None]) & (points[:, None] <= hi[None]),
                  axis=-1)
    pi, ci = np.nonzero(cand)
    xi = invert_bilinear(points[pi], cell_verts[ci])
    ok = np.all((xi >= -tol_unit) & (xi <= 1 + tol_unit), axis=1)
    pi, ci, xi = pi[ok], ci[ok], xi[ok]
    order = np.lexsort((ci, pi))          # lowest cell first per point
    pi, ci, xi = pi[order], ci[order], xi[order]
    first = np.ones(len(pi), dtype=bool)
    first[1:] = pi[1:] != pi[:-1]
    idx = -np.ones(len(points), dtype=np.int64)
    unit = np.zeros_like(points)
    idx[pi[first]] = ci[first]
    unit[pi[first]] = xi[first]
    return idx, unit


class Coupling:
    def __init__(self, th, solid, fluid_mesh, solid_mesh):
        """Works in the fluid's precision (float32 in the control)."""
        self.th, self.solid = th, solid
        self.dt = dt = th.np_dtype
        self.fluid_cv = fluid_mesh.vertices[fluid_mesh.cells].astype(dt)
        self.centers = fluid_mesh.cell_centers().astype(dt)
        self.u_points = th.u_points.astype(dt)
        self.eligible = th.eligible_u_nodes()
        self.ref = solid_mesh.vertices.astype(dt)
        self.points = dict(solid_points=solid_mesh.vertices,
                           cell_centers=fluid_mesh.cell_centers())
        self.scells = solid_mesh.cells

    def in_solid(self, points, moved):
        moved = moved.astype(self.dt)
        idx, unit = locate(points, moved[self.scells])
        box = np.all((points >= moved.min(axis=0)) &
                     (points <= moved.max(axis=0)), axis=1)
        return np.where(box, idx, -1), unit

    def indicator(self, moved):
        return self.in_solid(self.centers, moved)[0] >= 0

    def dirichlet(self, moved, v):
        """(covered dofs (n,) bool, their values (n,)) of the fluid."""
        th, dt = self.th, self.dt
        idx, unit = self.in_solid(self.u_points, moved.astype(dt))
        inside = (idx >= 0) & self.eligible
        G = tensor_shapes(1, unit[inside])[0].astype(dt)
        vs = np.einsum("nv,nva->na", G,
                       v.astype(dt).reshape(-1, 2)[self.scells[idx[inside]]])
        mask = np.zeros(th.n, dtype=bool)
        vals = np.zeros(th.n, dtype=dt)
        nodes = np.nonzero(inside)[0]
        for comp in range(2):
            mask[2 * nodes + comp] = True
            vals[2 * nodes + comp] = vs[:, comp]
        return th.unconstrained(mask), vals

    def traction(self, moved, x, tau):
        th, faces, dt = self.th, self.solid.faces, self.dt
        moved, x, tau = (z.astype(dt) for z in (moved, x, tau))
        a, b = moved[faces[:, 1]], moved[faces[:, 2]]
        centers = dt(0.5) * (a + b)
        idx, unit = locate(centers, self.fluid_cv)
        if (idx < 0).any():
            raise RuntimeError("a solid face centre lies outside the fluid")
        G1 = tensor_shapes(1, unit)[0].astype(dt)
        G2 = tensor_shapes(2, unit)[0].astype(dt)
        p = np.einsum("nv,nv->n", G1, x[th.n_u:][th.p_nodes[idx]])
        t = np.einsum("nv,nvab->nab", G2, tau[th.u_nodes[idx]])
        sigma = t - p[:, None, None] * np.eye(2, dtype=dt)
        tv = b - a
        n = np.stack([tv[:, 1], -tv[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        cc = moved[self.scells[faces[:, 0]]].mean(axis=1)
        s = np.sign(np.einsum("nd,nd->n", n, centers - cc))
        n *= np.where(s == 0, 1.0, s)[:, None]
        return np.einsum("nab,nb->na", sigma, n)


def build(cfg, mix, draw, dtype=torch.float64):
    """(fluid TaylorHood, Solid, Coupling) of a run."""
    f, geom = cfg["fields"], dict(cfg["geometry"], h=mix["h"])
    fmesh, smesh = meshes(geom, cfg["refinements"])
    zero = lambda pts, comp: np.zeros(len(pts))  # noqa: E731
    bcs = {bid: zero for bid in cfg["dirichlet_ids"]}
    bcs[cfg["inflow_boundary_id"]] = inflow_fn(geom, draw["inflow_scale"])
    th = TaylorHood(fmesh.vertices, fmesh.cells, fmesh.boundary_id, bcs,
                    dict(viscosity=f["viscosity"], rho=f["fluid_rho"],
                         grad_div=f["grad_div"], dt=f["time_step"]),
                    dtype=dtype)
    solid = Solid(smesh.vertices, smesh.cells, smesh.boundary_id, f,
                  cfg["solid_clamp_ids"], dtype=dtype)
    return th, solid, Coupling(th, solid, fmesh, smesh)


def layout(th, solid, cp):
    """Where each entry of a state lies (float64 positions)."""
    ref = cp.points["solid_points"]
    return dict(u_points=th.u_points, p_points=th.p_points,
                face_centers=0.5 * (ref[solid.faces[:, 1]] +
                                    ref[solid.faces[:, 2]]), **cp.points)


def run(cfg, mix, draw, dtype=torch.float64):
    """The reference's own run from rest: (layout, one state per step: the
    host first step, then the mix's segment of coupled steps).  In float32
    it is the control."""
    th, solid, cp = build(cfg, mix, draw, dtype)
    x, tau = np.zeros(th.n), np.zeros((th.n_unodes, 2, 2))
    d = v = np.zeros(solid.n)
    a = None
    states = []
    for _ in range(1 + mix["segment_steps"]):
        moved = cp.ref + d.reshape(-1, 2)
        trac = cp.traction(moved, x, tau)
        trhs = solid.traction_rhs(trac)
        if a is None:
            a = solid.initial_acceleration(d, trhs)
        d, v, a, _ = solid.step(d, v, a, trhs)
        moved = cp.ref + d.reshape(-1, 2)
        covered, vals = cp.dirichlet(moved, v)
        x, _ = th.newton_step(x, th.initial_eval(x, covered, vals),
                              extra_mask=covered)
        tau = th.nodal_stress(x)
        states.append(dict(u=x[:th.n_u].reshape(-1, 2), p=x[th.n_u:],
                           d=d.reshape(-1, 2), v=v.reshape(-1, 2),
                           a=a.reshape(-1, 2), traction=trac,
                           indicator=cp.indicator(moved)))
    return layout(th, solid, cp), states


def check(cfg, mix, draw, lay, states):
    """Judge a run step by step, each step from the state the run itself
    held at its start (the first step from rest), in float64:
      fluid_res     the fluid step's residual over its start's, the
                    configuration's own Newton measure (limit: its
                    fluid_tolerance);
      bc_gap        the largest miss of a constrained velocity (inflow,
                    walls, the solid's velocity at covered nodes, hanging
                    nodes), over the largest velocity;
      traction_gap  the traction the solid took against (-p I + tau) n of
                    the fluid state at the step's start;
      solid_res     the solid step's residual over its start's, under the
                    traction it took (limit: the configuration's tol_f);
      newmark_gap   the velocity and acceleration against the Newmark
                    update of the displacement;
      indicator_off fluid cells whose indicator differs.
    Returns the worst of each over the steps."""
    th, solid, cp = build(cfg, mix, draw)
    ref_lay = layout(th, solid, cp)
    idx = {k: match(lay[k], ref_lay[k]) for k in ref_lay}
    fu, fp, fs = idx["u_points"], idx["p_points"], idx["solid_points"]
    fc, ff = idx["cell_centers"], idx["face_centers"]

    def fluid_vec(st):
        x = np.zeros(th.n)
        x[:th.n_u].reshape(-1, 2)[fu] = st["u"]
        x[th.n_u:][fp] = st["p"]
        return x

    def solid_vec(st, key):
        out = np.zeros((len(cp.ref), 2))
        out[fs] = st[key]
        return out.ravel()

    out = dict(fluid_res=0.0, bc_gap=0.0, traction_gap=0.0, solid_res=0.0,
               newmark_gap=0.0, indicator_off=0)
    x_old = np.zeros(th.n)
    d_old = v_old = np.zeros(solid.n)
    a_old = None
    for st in states:
        x_new = fluid_vec(st)
        d_new, v_new, a_new = (solid_vec(st, k) for k in "dva")
        trac = np.zeros((len(solid.faces), 2))
        trac[ff] = st["traction"]
        # the coupler: traction from the step's start
        moved = cp.ref + d_old.reshape(-1, 2)
        ref_trac = cp.traction(moved, x_old, th.nodal_stress(x_old))
        out["traction_gap"] = max(out["traction_gap"], rel_gap(
            np.abs(trac - ref_trac).max(), np.abs(ref_trac).max()))
        # the solid step under the traction it took
        trhs = solid.traction_rhs(trac)
        if a_old is None:
            a_old = solid.initial_acceleration(d_old, trhs)
        r0, r1, a_ref, v_ref = solid.step_residuals(d_old, v_old, a_old,
                                                    trhs, d_new)
        out["solid_res"] = max(out["solid_res"], r1 / r0 if r0 > 1e-12
                               else (0.0 if r1 <= 1e-12 else r1 / 1e-12))
        out["newmark_gap"] = max(
            out["newmark_gap"],
            rel_gap(np.abs(a_new - a_ref).max(), np.abs(a_ref).max()),
            rel_gap(np.abs(v_new - v_ref).max(), np.abs(v_ref).max()))
        # the indicator and the fluid's constraints from the new solid
        moved = cp.ref + d_new.reshape(-1, 2)
        ind = np.zeros(th.n_cells, dtype=bool)
        ind[fc] = st["indicator"]
        out["indicator_off"] = max(out["indicator_off"],
                                   int((ind != cp.indicator(moved)).sum()))
        covered, vals = cp.dirichlet(moved, v_new)
        fluid_checks(th, x_old, x_new, covered, vals, out)
        x_old, d_old, v_old, a_old = x_new, d_new, v_new, a_new
    return out
