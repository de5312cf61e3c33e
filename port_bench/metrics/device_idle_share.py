"""The device's idle share of a replay of the segment, in %: one less the
device's busy time (the union of its operation intervals in the
profiler's trace) over the time of the plain replay of the same work, so
that the profiler's own host overhead, which stretches the traced window,
is not read as the program's."""


def read(ctx):
    w, busy = ctx["plain_s"], ctx["trace"]["busy_s"]
    if w <= 0 or busy <= 0:
        return None
    return 100.0 * (w - busy) / w
