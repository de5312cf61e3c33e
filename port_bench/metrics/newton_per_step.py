"""Fluid Newton iterations per time step of the traced segment
(step_log's fluid_newton, or the stepper's count)."""


def read(ctx):
    steps = ctx["steps"]
    return sum(s["newton"] for s in steps) / len(steps) if steps else None
