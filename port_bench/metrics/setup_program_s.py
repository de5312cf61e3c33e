"""The program's part of set-up, in s: the top-level set-up spans of a
build of the case and its host first step under the program's tracer
(spanrun.py, in a process of its own): "mesh" (the cylinder mesh and its
global refinements), "setup" (InsIM.setup), "pressure_mg" (the pressure
hierarchy) and "first_step" (the host first step, with the kernel's load
and the plan builds inside it).  Imports and the warm-up pass, which
setup_s also holds, are left out."""

import spanrun


def read(ctx):
    out = spanrun.context(ctx)
    if out is None or out["setup_program_s"] <= 0:
        return None
    return out["setup_program_s"]
