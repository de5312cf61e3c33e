"""Carry solver state across from the JAX package (or another run of the
port) as numpy arrays.

`fluid_state(solver)` / `solid_state(solver)` read the fields that define
a solver's state in the middle of a run from either package; the
`load_*` functions write such a dict into a port solver that was set up
on the same mesh (its precomputed tables are rebuilt from the mesh, not
carried).  The time counters are carried too, so the next step uses the
same step number and time.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import real_dtype

FLUID_FIELDS = ("present_solution", "indicator", "stress_device")
SOLID_FIELDS = ("current_displacement", "current_velocity",
                "current_acceleration", "previous_displacement",
                "previous_velocity", "previous_acceleration",
                "fsi_traction")


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
    return _state(solver, FLUID_FIELDS)


def solid_state(solver):
    return _state(solver, SOLID_FIELDS)


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
    _load(solver, state, FLUID_FIELDS)


def load_solid_state(solver, state):
    _load(solver, state, SOLID_FIELDS)
