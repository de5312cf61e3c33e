"""The element-matvec kernel's share of its roofline over the traced
segment: for each launched shape, launches times the least time of one
launch (peaks.launch_bound: bytes of A, the tables, x and y once, at
3.35 TB/s, or its flops, whichever is longer), summed, over the summed
device time of the kernel's launches in the trace, in %."""

KERNEL = "element_matvec"


def read(ctx):
    bound = sum(n * ctx["launch_bounds"][key][0]
                for key, n in ctx["launches"].items()
                if key in ctx["launch_bounds"])
    device = sum(s for name, s in ctx["trace"]["by_name"].items()
                 if KERNEL in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
