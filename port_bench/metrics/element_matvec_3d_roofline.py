"""The element-matvec kernel's share of its roofline over the traced
segment of the 3-D cell, in %: for each key launched in the profiled
replay (graph replays included), its launches times the least time of one
launch, reckoned from the sizes the program notes at the key's first
launch (sized_bound.py, peaks.py's formula), summed, over the summed
device time of the kernels named element_matvec in the trace.  Every
launched key has its sizes, graph-replayed ones too.  A program without
the table of sizes gives None."""

import sized_bound

KERNEL = "element_matvec"


def read(ctx):
    sizes = sized_bound.program_sizes()
    if not sizes:
        return None
    bound = sum(n * sized_bound.least_seconds(key, sizes[key])[0]
                for key, n in ctx["launches"].items() if key in sizes)
    device = sum(s for name, s in ctx["trace"]["by_name"].items()
                 if KERNEL in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
