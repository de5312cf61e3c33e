"""Builds the dfg_cylinder configuration (dfg_cylinder.json) on the port:
the Schaefer-Turek 2D-1 channel as a standalone InsIM, set up on the
cylinder mesh refined `mix["refine"]` times, with the pressure V-cycle over
the refinement hierarchy, as cases/fluid_cylinder.py's cylinder_case does,
and the seeded inflow.  The window drives the stepper that
InsIM.make_on_device_stepper returns, one step per call."""

from __future__ import annotations

import numpy as np

from case_util import parameters


def inflow_fn(cfg, scale):
    umax, height = cfg["inflow"]["umax"] * scale, cfg["inflow"]["height"]

    def fn(points, comp):
        out = np.zeros(len(points))
        if comp == 0:
            m = np.abs(points[:, 0]) < 1e-10
            out[m] = 4 * umax * points[m, 1] * (height - points[m, 1]) \
                / height ** 2
        return out
    return fn


class Case:
    def __init__(self, cfg, mix, draw, device):
        from openifem_tpu_torch.mesh import generators
        from openifem_tpu_torch.solvers.fluid import InsIM
        self.steps = mix["segment_steps"]
        p = parameters(cfg, mix, [mix["refine"], 0])
        meshes = [generators.flow_around_cylinder(2)]
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

    def first_step(self):
        self.fluid.run_one_step(True, verbose=False)
        self.stepper = self.fluid.make_on_device_stepper()

    def state(self):
        """The state a step leaves, for the comparison (on the device)."""
        return {"x": self.fluid.present_solution}

    def snapshot(self):
        """What the fluid's checkpoint holds: its solution."""
        return {"present": self.fluid.present_solution.clone()}

    def restore(self, snap):
        self.fluid.present_solution = snap["present"].clone()

    def segment(self):
        """One segment through the stepper, a step per call: (per step the
        Newton and Krylov counts, per step the state)."""
        fluid, records, states = self.fluid, [], []
        x = fluid.present_solution
        for _ in range(self.steps):
            k0 = dict(fluid.krylov_iters)
            x, rel, its = self.stepper(x, 1)
            records.append(dict(
                newton=int(its), converged=bool(rel <= self.tol),
                krylov={k: v - k0[k] for k, v in fluid.krylov_iters.items()}))
            states.append({"x": x})
        fluid.present_solution = x
        return records, states

    def layout(self):
        f = self.fluid
        return dict(u_points=f.u_space.node_points,
                    p_points=f.p_space.node_points)

    def host(self, state):
        """A state in the reference's terms, on the host."""
        x = state["x"].cpu().numpy()
        n_u = self.fluid.n_u
        return dict(u=x[:n_u].reshape(-1, 2), p=x[n_u:])

    def free(self):
        self.fluid = self.stepper = None
