"""The one generator of the benchmark's inputs: a mix file's parameters and
the run's seed give what both the program and the reference receive.

A mix (mixes/<name>.json) fixes the work: the mesh size or refinement,
the solver path (the knobs set on the fluid), the segment of steps that
the window replays and the limits of the comparison.  The seed draws only
the inflow's amplitude, within `inflow_rel` of the configuration's own:
every seed runs the same mesh, path and number of steps, so the seed
changes the numbers and not the shape of the work."""

from __future__ import annotations

import numpy as np


def draw(mix, seed):
    """The seeded inputs of a run: {"inflow_scale": 1 + r inflow_rel},
    r uniform in [-1, 1)."""
    rng = np.random.default_rng(int(seed))
    r = 2.0 * rng.random() - 1.0
    return {"inflow_scale": 1.0 + mix["inflow_rel"] * r}
