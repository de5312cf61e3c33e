"""Checkpoint save/restore.

Counterpart of openifem_tpu/io/checkpoint.py (reference: fluid side via
SolutionTransfer + triangulation.save, source/mpi_fluid_solver.cpp:
581-713; solid side via rank-0 block_write of d/v/a,
source/mpi_shared_solid_solver.cpp:452-571): one npz per solver with the
state vectors and the time bookkeeping; only the latest checkpoint is
kept, as in the reference.  The file names and array keys are the JAX
package's, so a checkpoint written by either package restores in the
other.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np


def _step_of(path: str) -> int:
    try:
        return int(path.split("-")[-1].split(".")[0])
    except ValueError:
        return -1


def save_checkpoint(prefix: str, step: int, arrays: Dict[str, np.ndarray],
                    keep_only_latest: bool = True) -> str:
    """Write <prefix>-<step:06d>.checkpoint.npz, then remove older ones.

    The new checkpoint is written to a temporary name and renamed (an
    atomic replace) BEFORE any older checkpoint is deleted, so a crash or
    a full disk mid-save never leaves the run without a restartable
    checkpoint."""
    path = f"{prefix}-{step:06d}.checkpoint.npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)
    if keep_only_latest:
        for old in glob.glob(f"{prefix}-*.checkpoint.npz"):
            if old != path:
                os.remove(old)
    return path


def load_latest_checkpoint(prefix: str) -> Optional[Dict[str, np.ndarray]]:
    """The arrays of the latest <prefix>-*.checkpoint.npz by parsed step
    number, with the step under "__step__"; None when there is none."""
    files = glob.glob(f"{prefix}-*.checkpoint.npz")
    if not files:
        return None
    latest = max(files, key=_step_of)
    with np.load(latest) as data:
        out = {k: data[k] for k in data.files}
    out["__step__"] = _step_of(latest)
    return out
