"""Builds the fsi_leaflet configuration (fsi_leaflet.json) on the port: the
serial mIFEM coupler FSI with an InsIM fluid and a Neo-Hookean
HyperElasticity leaflet, Dirichlet velocity coupling, the mix's solver
knobs and the seeded inflow, as cases/fsi_leaflet.py's leaflet_case builds
it.  The window drives FSI.run_one_coupled_step through FSI's time
loop."""

from __future__ import annotations

import numpy as np

from case_util import parameters


def inflow_fn(geom, scale):
    L, H, U = geom["L"], geom["H"], geom["U"] * scale

    def fn(points, comp):
        out = np.zeros(len(points))
        if comp == 0:
            m = np.abs(points[:, 0]) < 1e-10
            out[m] = U - 4 * U / (H * H) * (points[m, 1] - H / 2) ** 2
        return out
    return fn


class Case:
    def __init__(self, cfg, mix, draw, device):
        from openifem_tpu_torch.fsi import FSI
        from openifem_tpu_torch.mesh import generators
        from openifem_tpu_torch.solvers.fluid import InsIM
        from openifem_tpu_torch.solvers.solid import HyperElasticity
        geom = dict(cfg["geometry"], h=mix["h"])
        L, H, a, b, h = (geom[k] for k in ("L", "H", "a", "b", "h"))
        p = parameters(cfg, mix, cfg["refinements"])
        fluid_mesh = generators.subdivided_hyper_rectangle(
            [int(L / h), int(H / h)], [0.0, 0.0], [L, H])
        c = fluid_mesh.cell_centers()
        fluid_mesh = fluid_mesh.refine(
            (c[:, 0] >= L / 4 - a) & (c[:, 0] <= L / 4 + 2 * a) &
            (c[:, 1] < H / 2))
        solid_mesh = generators.subdivided_hyper_rectangle(
            [max(1, int(a / h)), int(b / h)], [L / 4, 0.0], [a + L / 4, b])
        fluid = InsIM(fluid_mesh, p, bc=inflow_fn(geom, draw["inflow_scale"]),
                      device=device)
        for name, value in mix["knobs"].items():
            setattr(fluid, name, tuple(value) if isinstance(value, list)
                    else value)
        self.fsi = FSI(fluid, HyperElasticity(solid_mesh, p, device=device),
                       p, use_dirichlet_bc=True)
        # the global refinements, both solvers' setup and the coupling
        # tables, as FSI.run does before its time loop
        self.fsi._setup_run()
        self.dt = p.time_step
        self.steps = mix["segment_steps"]

    def _loop(self, n_steps, first_step):
        """n_steps of FSI's time loop; per step the state it leaves."""
        fsi, states = self.fsi, []
        fsi.time.time_end = fsi.time.current() + (n_steps - 0.5) * self.dt
        fsi._time_loop(verbose=False, first_step=first_step,
                       after_step=lambda: states.append(self.state()))
        return fsi.step_log, states

    def first_step(self):
        self._loop(1, True)

    def state(self):
        """The state a step leaves, for the comparison (on the device; each
        step replaces these tensors and writes none of them in place)."""
        f, s = self.fsi.fluid, self.fsi.solid
        return dict(x=f.present_solution, d=s.current_displacement,
                    v=s.current_velocity, a=s.current_acceleration,
                    traction=s.fsi_traction, indicator=f.indicator)

    def snapshot(self):
        """What the solvers' checkpoints hold: the fluid solution, the
        solid's displacement, velocity and acceleration, and the clocks."""
        f, s = self.fsi.fluid, self.fsi.solid
        return dict(
            present=f.present_solution.clone(),
            d=s.current_displacement.clone(),
            v=s.current_velocity.clone(),
            a=s.current_acceleration.clone(),
            clocks=[(t.timestep, t.time_current)
                    for t in (self.fsi.time, f.time, s.time)])

    def restore(self, snap):
        """The snapshot back in place; the fluid's nodal stress worked out
        from its solution, as a checkpoint's load does."""
        f, s = self.fsi.fluid, self.fsi.solid
        f.present_solution = snap["present"].clone()
        f.stress_device = f._update_stress_impl(f.present_solution)
        for name in ("displacement", "velocity", "acceleration"):
            t = snap[name[0]].clone()
            setattr(s, "current_" + name, t)
            setattr(s, "previous_" + name, t)
        for t, (step, now) in zip((self.fsi.time, f.time, s.time),
                                  snap["clocks"]):
            t.timestep, t.time_current = step, now

    def segment(self):
        """One segment of coupled steps through the time loop: (per step
        the Newton and Krylov counts, per step the state)."""
        log, states = self._loop(self.steps, False)
        records = [dict(newton=int(e["fluid_newton"]),
                        solid_newton=int(e["solid_newton"]),
                        converged=True, krylov=dict(e["krylov"]))
                   for e in log]
        return records, states

    def layout(self):
        fsi = self.fsi
        f, s = fsi.fluid, fsi.solid
        fv = fsi._solid_bface_verts.cpu().numpy()
        return dict(u_points=f.u_space.node_points,
                    p_points=f.p_space.node_points,
                    solid_points=s.space.node_points,
                    cell_centers=f.mesh.cell_centers(),
                    face_centers=s.mesh.vertices[fv].mean(axis=1))

    def host(self, state):
        """A state in the reference's terms, on the host."""
        n_u = self.fsi.fluid.n_u
        h = {k: v.cpu().numpy() for k, v in state.items()}
        x = h.pop("x")
        h.update(u=x[:n_u].reshape(-1, 2), p=x[n_u:],
                 indicator=h["indicator"] > 0.5,
                 **{k: h[k].reshape(-1, 2) for k in "dva"})
        return h

    def free(self):
        self.fsi = None
