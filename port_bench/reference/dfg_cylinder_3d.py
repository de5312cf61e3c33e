"""Plain reference of the dfg_cylinder_3d configuration: the Schaefer-Turek
3D-1Z channel (Re = 20) as a standalone Q2/Q1 Taylor-Hood fluid on
hexahedra with the seeded inflow.  Imports nothing of the program; the
mesh comes from the frozen copy of the 3-D generator
(frozen_mesh/cylinder3d.py)."""

from __future__ import annotations

import numpy as np
import torch

from .fem import match
from .fem3d import TaylorHood3D, fluid_checks
from .frozen_mesh import cylinder3d


def inflow_fn(cfg, scale):
    """U = 16 Um y z (H - y)(H - z) / H^4 on the inflow plane, V = W = 0."""
    inflow = cfg["inflow"]
    umax, height, x0 = inflow["umax"] * scale, inflow["height"], inflow["x"]

    def fn(points, comp):
        out = np.zeros(len(points))
        if comp == 0:
            m = np.abs(points[:, 0] - x0) < 1e-10
            y, z = points[m, 1], points[m, 2]
            out[m] = 16 * umax * y * z * (height - y) * (height - z) \
                / height ** 4
        return out
    return fn


def build(cfg, mix, draw, dtype=torch.float64):
    f = cfg["fields"]
    m = cylinder3d.refine_global_3d(cylinder3d.flow_around_cylinder_3d(),
                                    mix["refine"])
    zero = lambda pts, comp: np.zeros(len(pts))  # noqa: E731
    bcs = {bid: zero for bid in cfg["dirichlet_ids"]}
    bcs[cfg["inflow"]["boundary_id"]] = inflow_fn(cfg, draw["inflow_scale"])
    return TaylorHood3D(m.vertices, m.cells, m.boundary_id, bcs, dict(
        viscosity=f["viscosity"], rho=f["fluid_rho"],
        grad_div=f["grad_div"], dt=f["time_step"]), dtype=dtype)


def run(cfg, mix, draw, dtype=torch.float64, steps=None):
    """The reference's own run from rest: (layout, one state per step: the
    host first step, then the mix's segment, or `steps` steps in all).
    In float32 it is the control.  Direct solves: coarse meshes only."""
    th = build(cfg, mix, draw, dtype)
    x, states = np.zeros(th.n), []
    for _ in range(1 + mix["segment_steps"] if steps is None else steps):
        x, _ = th.newton_step(x, th.initial_eval(x))
        states.append(dict(u=x[:th.n_u].reshape(-1, 3), p=x[th.n_u:]))
    return dict(u_points=th.u_points, p_points=th.p_points), states


def check(cfg, mix, draw, lay, states):
    """Judge a run step by step, each step from the state the run itself
    held at its start (the first step from rest), in float64: fluid_res
    (the step's residual over its start's, the configuration's own Newton
    measure) and bc_gap (the largest miss of a constrained velocity over
    the largest velocity), the worst over the steps."""
    th = build(cfg, mix, draw)
    fu = match(lay["u_points"], th.u_points)
    fp = match(lay["p_points"], th.p_points)
    out = dict(fluid_res=0.0, bc_gap=0.0)
    x_old = np.zeros(th.n)
    for st in states:
        x_new = np.zeros(th.n)
        x_new[:th.n_u].reshape(-1, 3)[fu] = st["u"]
        x_new[th.n_u:][fp] = st["p"]
        fluid_checks(th, x_old, x_new, out)
        x_old = x_new
    return out
