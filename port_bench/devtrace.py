"""Reduction of a torch.profiler trace of the device to what the per-layer
metrics read: the device operations as (name, start s, seconds), their
union (the busy time), the kernels by name and the idle gaps."""

from __future__ import annotations

from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")


def device_events(prof):
    """[(name, start s, seconds)] of every operation the profiler saw on
    the device, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "cuda" in str(e.device_type()).lower():
            out.append((e.name(), e.start_ns() * 1e-9,
                        e.duration_ns() * 1e-9))
    out.sort(key=lambda t: t[1])
    return out


def is_kernel(name):
    return not name.startswith(COPY_PREFIXES)


def reduce(events, top=10):
    """busy_s (the union of the device's intervals), the number of
    kernels, seconds by name, and the `top` longest idle gaps, each named
    after the operation that ended last before it."""
    busy, end, last = 0.0, None, None
    by_name = defaultdict(float)
    gaps = []
    n_kernels = 0
    for name, start, dur in events:
        by_name[name] += dur
        n_kernels += is_kernel(name)
        stop = start + dur
        if end is None or start >= end:
            if end is not None and start > end:
                gaps.append((f"after {last[:100]}", start - end))
            busy += dur
            end, last = stop, name
        elif stop > end:
            busy += stop - end
            end, last = stop, name
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_s=busy, n_kernels=n_kernels, by_name=dict(by_name),
                top_ops=[[n[:120], s] for n, s in ops[:top]],
                top_gaps=[[n, s] for n, s in gaps[:top]])
