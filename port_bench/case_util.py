"""Helpers the configuration builders share: AllParameters from a
configuration file's fields and a mix's segment."""

from __future__ import annotations


def fields(cfg, mix, refinements):
    """The AllParameters fields of a run: the configuration's own, the
    global refinements, and an end time one host first step plus one
    segment after the start."""
    f = dict(cfg["fields"])
    for key in ("fluid_dirichlet_bcs", "solid_dirichlet_bcs"):
        if key in f:
            f[key] = {int(k): (tuple(v) if isinstance(v, list) else v)
                      for k, v in f[key].items()}
    f["global_refinements"] = list(refinements)
    f["end_time"] = (1 + mix["segment_steps"]) * f["time_step"]
    return f


def parameters(cfg, mix, refinements):
    from openifem_tpu_torch.parameters import AllParameters
    return AllParameters(**fields(cfg, mix, refinements))
