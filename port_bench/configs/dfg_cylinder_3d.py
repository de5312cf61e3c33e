"""Builds the dfg_cylinder_3d configuration (dfg_cylinder_3d.json) on the
port: the Schaefer-Turek 3D-1Z channel as a standalone Q2/Q1 InsIM on
hexahedra, set up on the 3-D cylinder mesh refined `mix["refine"]` times,
with the pressure V-cycle over the refinement hierarchy, and the seeded
inflow.  The window drives the stepper that InsIM.make_on_device_stepper
returns, one step per call, as for dfg_cylinder."""

from __future__ import annotations

import numpy as np

from case_util import parameters
from configs import dfg_cylinder


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


class Case(dfg_cylinder.Case):
    def __init__(self, cfg, mix, draw, device):
        from openifem_tpu_torch.mesh import generators
        from openifem_tpu_torch.solvers.fluid import InsIM
        self.steps = mix["segment_steps"]
        p = parameters(cfg, mix, [mix["refine"], 0])
        meshes = [generators.flow_around_cylinder(3)]
        for _ in range(mix["refine"]):
            meshes.append(meshes[-1].refine_global(1))
        fluid = InsIM(meshes[-1], p, bc=inflow_fn(cfg, draw["inflow_scale"]),
                      device=device)
        # before setup: the knobs decide the types of the tables that
        # setup and enable_pressure_mg build
        for name, value in mix["knobs"].items():
            setattr(fluid, name, value)
        fluid.setup()
        if len(meshes) > 1:
            fluid.enable_pressure_mg(meshes)
        self.fluid = fluid
        self.tol = p.fluid_tolerance

    def host(self, state):
        """A state in the reference's terms, on the host."""
        x = state["x"].cpu().numpy()
        n_u = self.fluid.n_u
        return dict(u=x[:n_u].reshape(-1, 3), p=x[n_u:])
