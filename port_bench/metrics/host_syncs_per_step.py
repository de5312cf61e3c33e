"""Host reads of device values per time step over the traced segment
(utils/timer.py count_host_syncs)."""


def read(ctx):
    n = len(ctx["steps"])
    return ctx["syncs"] / n if n else None
