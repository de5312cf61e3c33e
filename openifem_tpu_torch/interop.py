"""Carry solver state across from the JAX package (or another run of the
port) as numpy arrays.

`fluid_state(solver)` / `solid_state(solver)` read the fields that define
a solver's state in the middle of a run from either package (for a solid,
the Newmark vectors of an FE solid or the particles of an RKPM one, and a
shared solid's nodal stress rows); the
`load_*` functions write such a dict into a port solver that was set up
on the same mesh (its precomputed tables are rebuilt from the mesh, not
carried).  The time counters are carried too, so the next step uses the
same step number and time.  A fluid's state also carries the clock of
its time-dependent hard-coded BCs, which of them are still alive (SCnsEX
lets them expire), their expiry limits and the Dirichlet values last
built from them, so a SUPG or SCnsEX run continues from the same point in
either package.  `turbulence_state(model, fsi)` / `load_turbulence_state`
carry a Spalart-Allmaras model's state (nu~, the eddy viscosity, the wall
distances, y+ and the accumulated Dirichlet rows) and, with an MPI
coupler, its shear velocities and a ControlVolumeFSI's budget history.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import real_dtype

FLUID_FIELDS = ("present_solution", "indicator", "stress_device")
# nodal FSI fields of the SUPG family
FLUID_OPTIONAL = ("fsi_acc_nodal", "fsi_stress_nodal")
# the state of the time-dependent hard-coded BCs
BC_KEYS = ("bc_time", "bc_ids", "bc_time_limits", "dirichlet_values")
SOLID_FIELDS = ("current_displacement", "current_velocity",
                "current_acceleration", "previous_displacement",
                "previous_velocity", "previous_acceleration",
                "fsi_traction")
# the nodal fluid stress rows of a shared (FSI-side) solid
SOLID_OPTIONAL = ("fsi_stress_rows",)
# the particle state of an RKPM solid (HypoElasticity); its FE-facing
# vectors follow from it
RKPM_FIELDS = ("x", "v", "sigma", "_acc")
# a Spalart-Allmaras model's state
TURBULENCE_FIELDS = ("present_solution", "eddy_viscosity_nodal",
                     "fixed_wall_distance", "moving_wall_distance",
                     "y_plus", "_accum_mask")


def to_numpy(a):
    """numpy copy of a JAX array, a torch tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _state(solver, fields):
    out = {f: to_numpy(getattr(solver, f)) for f in fields}
    out["time"] = (solver.time.timestep, solver.time.time_current)
    return out


def fluid_state(solver):
    out = _state(solver, FLUID_FIELDS)
    for f in FLUID_OPTIONAL:
        if hasattr(solver, f):
            out[f] = to_numpy(getattr(solver, f))
    out["bc_time"] = solver.bc_time
    out["bc_ids"] = sorted(solver.hard_coded_bcs)
    out["bc_time_limits"] = dict(getattr(solver, "bc_time_limits", {}))
    out["dirichlet_values"] = to_numpy(
        solver.nonzero_constraints.dirichlet_values)
    return out


def solid_state(solver):
    """The state of a solid of either package: the Newmark vectors of an
    FE solid, or the particle state of an RKPM one (whose `_acc` the JAX
    package sets on its first step), and a shared solid's stress rows."""
    if hasattr(solver, "sigma"):
        out = {f: to_numpy(getattr(solver, f)) for f in RKPM_FIELDS[:3]}
        acc = getattr(solver, "_acc", None)
        out["_acc"] = (np.zeros_like(out["v"]) if acc is None
                       else to_numpy(acc))
        out["time"] = (solver.time.timestep, solver.time.time_current)
    else:
        out = _state(solver, SOLID_FIELDS)
    for f in SOLID_OPTIONAL:
        if hasattr(solver, f):
            out[f] = to_numpy(getattr(solver, f))
    return out


def _load(solver, state, fields):
    for f in fields:
        cur = getattr(solver, f)
        arr = np.asarray(state[f])
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(f"{f}: state has shape {arr.shape}, the "
                             f"solver {tuple(cur.shape)}")
        setattr(solver, f, torch.tensor(arr, dtype=real_dtype(),
                                        device=solver.device))
    if "time" in state:
        solver.time.timestep, solver.time.time_current = state["time"]


def load_fluid_state(solver, state):
    """Write a fluid state into a port solver that was set up on the same
    mesh with the same hard-coded BCs added."""
    _load(solver, state, FLUID_FIELDS +
          tuple(f for f in FLUID_OPTIONAL if f in state))
    if "bc_time" not in state:
        return
    solver.bc_time = state["bc_time"]
    for bid in list(solver.hard_coded_bcs):
        if bid not in state["bc_ids"]:
            del solver.hard_coded_bcs[bid]          # expired
    if state["bc_time_limits"] or hasattr(solver, "bc_time_limits"):
        solver.bc_time_limits = dict(state["bc_time_limits"])
    # an expired BC keeps the values of its last rebuild
    solver.nonzero_constraints.dirichlet_values = torch.tensor(
        state["dirichlet_values"], dtype=real_dtype(), device=solver.device)


def load_solid_state(solver, state):
    """Write a solid state (solid_state's dict) into a port solver set up
    on the same mesh."""
    optional = tuple(f for f in SOLID_OPTIONAL if f in state)
    if "sigma" in state:
        _load(solver, state, RKPM_FIELDS + optional)
        solver._sync()
    else:
        _load(solver, state, SOLID_FIELDS + optional)


def turbulence_state(model, fsi=None):
    """The state of a Spalart-Allmaras model of either package, and with
    `fsi` (an MPIFSI) its shear velocities and, for a ControlVolumeFSI,
    the budget history."""
    out = {f: to_numpy(getattr(model, f)) for f in TURBULENCE_FIELDS}
    if fsi is not None:
        out["shear_velocities"] = to_numpy(fsi.shear_velocities)
        if hasattr(fsi, "cv_history"):
            out["cv_history"] = [dict(h) for h in fsi.cv_history]
    return out


def load_turbulence_state(model, state, fsi=None):
    """Write a turbulence_state dict into a port model set up on the same
    mesh (and into `fsi`, the port coupler, when given); the fluid's eddy
    viscosity follows."""
    for f in TURBULENCE_FIELDS:
        cur = getattr(model, f)
        arr = np.asarray(state[f])
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(f"{f}: state has shape {arr.shape}, the "
                             f"model {tuple(cur.shape)}")
        setattr(model, f, torch.tensor(arr, dtype=cur.dtype,
                                       device=model.device))
    model.fluid.eddy_viscosity_nodal = model.eddy_viscosity_nodal
    if fsi is not None:
        fsi.shear_velocities = torch.tensor(
            state["shear_velocities"], dtype=real_dtype(),
            device=fsi.device)
        if "cv_history" in state:
            fsi.cv_history = [dict(h) for h in state["cv_history"]]
