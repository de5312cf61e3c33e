#!/usr/bin/env python3
"""The program's own spans in a cell: what the span metrics
(metrics/assemble_ms_per_step.py, precond_build_ms_per_step.py,
inner_a_ms_per_step.py, sync_wait_ms_per_step.py, setup_program_s.py)
read, and where the device's idle time goes.

    python3 port_bench/spanrun.py --workload NAME --seed N [--device cpu]

does in a process of its own what run.py's set-up and traced window do,
with the program's tracer (openifem_tpu_torch/utils/timer.py) on where it
measures: it builds the case and takes the host first step under the
tracer (the set-up spans), runs the warm-up pass untraced, then replays
the segment three times, each under one instrument set: plain (the time
the tracer's cost is taken against), under the tracer alone (the spans
the metrics read) and, on the card, under the tracer and torch.profiler
together, whose device events and spans lie on one clock (the profiler's,
ns since the epoch).  That replay's idle time (its window less the union
of the device's intervals) is split over the innermost span open on the
host at each instant ("idle_by_span"), and its longest idle gaps are
named after the spans open at their start ("idle_gaps").  It prints a
summary on stderr and one JSON object as its last line.

A metric calls context(ctx): the harness's ctx["spans"] where a harness
puts it there, else this script run once per process for the workload and
seed of the harness's own command line.  A program without the tracer,
or a command line without a workload, gives None: the metrics are then
left out of the result line."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUTSIDE = "outside spans"
# the top-level spans of set-up that setup_program_s sums: the mesh, the
# solver's setup(), the pressure hierarchy and the host first step
SETUP_SPANS = ("mesh", "setup", "pressure_mg", "first_step")
TIMEOUT_S = 900

_CACHE = {}


# -- the arithmetic, on plain lists ----------------------------------------

def innermost(spans, t0, t1):
    """[(start, end, span index)] covering [t0, t1] in time order: at each
    instant the innermost span open on the host, or -1 where none is.
    spans: (name, start, end, parent index) in opening order, nested as a
    single thread's are."""
    children = defaultdict(list)
    for i, s in enumerate(spans):
        children[s[3]].append(i)
    out = []

    def fill(lo, hi, owner):
        t = lo
        for k in children[owner]:
            a, b = max(spans[k][1], lo), min(spans[k][2], hi)
            if a >= b:
                continue
            if t < a:
                out.append((t, a, owner))
            fill(a, b, k)
            t = b
        if t < hi:
            out.append((t, hi, owner))
    fill(t0, t1, -1)
    return out


def busy_union(events, t0, t1):
    """The union of the device's intervals (name, start, duration) within
    [t0, t1], as sorted disjoint (start, end, name of the operation that
    ends it)."""
    out = []
    for name, start, dur in sorted(events, key=lambda e: e[1]):
        a, b = max(start, t0), min(start + dur, t1)
        if a >= b:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def idle_intervals(events, t0, t1):
    """[(start, end, name of the last operation before it, or None)]: the
    parts of [t0, t1] where the device runs nothing."""
    out, t, last = [], t0, None
    for a, b, name in busy_union(events, t0, t1):
        if t < a:
            out.append((t, a, last))
        t, last = b, name
    if t < t1:
        out.append((t, t1, last))
    return out


def chain(spans, i, depth=2):
    """The names of the `depth` innermost spans open at span i, outermost
    first, joined by ">"; OUTSIDE for -1."""
    names = []
    while i >= 0 and len(names) < depth:
        names.append(spans[i][0])
        i = spans[i][3]
    return ">".join(reversed(names)) if names else OUTSIDE


def attribute_idle(events, spans, t0, t1, top=10):
    """(idle time by span name: each idle interval of [t0, t1] split over
    the innermost spans it overlaps, by the overlap, time under no span
    under OUTSIDE; the `top` longest idle gaps between device operations
    as [name, length], named "<spans open at its start> after <the
    operation before it>")."""
    segs = innermost(spans, t0, t1)
    starts = [s[0] for s in segs]
    by_span = defaultdict(float)
    gaps = []
    k = 0
    for a, b, last in idle_intervals(events, t0, t1):
        if last is not None and b < t1:
            j = bisect.bisect_right(starts, a) - 1
            gaps.append((f"{chain(spans, segs[j][2])} after {last[:100]}",
                         b - a))
        while segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            name = spans[segs[j][2]][0] if segs[j][2] >= 0 else OUTSIDE
            by_span[name] += hi - lo
            j += 1
    gaps.sort(key=lambda g: -g[1])
    return dict(by_span), [list(g) for g in gaps[:top]]


def inclusive_ns(spans, name):
    """The summed time of the spans `name` that no span of the same name
    encloses."""
    total = 0
    for s in spans:
        if s[0] != name:
            continue
        p = s[3]
        while p >= 0 and spans[p][0] != name:
            p = spans[p][3]
        if p < 0:
            total += s[2] - s[1]
    return total


# -- what the metrics read --------------------------------------------------

def context(ctx):
    """The spans' summary for this run (the dict this script prints), or
    None."""
    if ctx.get("spans") is not None:
        return ctx["spans"]
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed")
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None:
        return None
    key = (args.workload, args.seed)
    if key not in _CACHE:
        _CACHE[key] = _spawn(args.workload, args.seed, ctx)
    return _CACHE[key]


def _has_tracer():
    try:
        from openifem_tpu_torch.utils import timer
    except ImportError:
        return False
    return hasattr(timer, "recording")


def _spawn(workload, seed, ctx):
    if not _has_tracer():
        return None
    import torch
    cmd = [sys.executable, os.path.join(HERE, "spanrun.py"), "--workload",
           workload, "--seed", str(seed), "--device",
           "cuda" if torch.cuda.is_available() else "cpu"]
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print("spanrun: timed out", file=sys.stderr)
        return None
    sys.stderr.write(p.stderr)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines:
        print(f"spanrun: exit code {p.returncode}, no result",
              file=sys.stderr)
        return None
    out = json.loads(lines[-1])
    steps = [[r["newton"], r["krylov"]] for r in ctx.get("steps", [])]
    if steps and out["steps"] != steps:
        print(f"spanrun: counts {out['steps']} differ from the harness's "
              f"{steps}", file=sys.stderr)
        return None
    return out


def per_step_ms(ctx, name):
    """The inclusive time of the spans `name` per step of the tracer's
    replay, in ms, or None."""
    out = context(ctx)
    if out is None or not out["steps"]:
        return None
    ns = out["inclusive_ns"].get(name, 0)
    return ns * 1e-6 / len(out["steps"]) if ns > 0 else None


# -- the run ----------------------------------------------------------------

def _device_events(prof):
    """(name, start ns, duration ns) of every operation the profiler saw
    on the device."""
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "cuda" in str(e.device_type()).lower()]


def _tuples(rec):
    return [(s.name, s.start_ns, s.end_ns, s.parent) for s in rec.spans]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    import importlib

    import torch

    import run
    import traffic
    from openifem_tpu_torch.utils import timer

    torch.set_num_threads(1)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("spanrun: no CUDA device", file=sys.stderr)
        return 3

    def sync():
        if on_card:
            torch.cuda.synchronize()

    _, _, _, cfg, mix = run.load_cell(args.workload)
    config = importlib.import_module("configs." + cfg["name"])
    draw = traffic.draw(mix, args.seed)

    t_build = time.perf_counter()
    with timer.recording() as setup:
        case = config.Case(cfg, mix, draw, args.device)
        case.first_step()
    sync()
    snap = case.snapshot()
    t_warm = time.perf_counter()
    warm, _ = case.segment()
    sync()
    t_end = time.perf_counter()
    setup_spans = [s for s in setup.spans if s.parent < 0]
    setup_s = {n: 1e-9 * sum(s.end_ns - s.start_ns for s in setup_spans
                             if s.name == n) for n in SETUP_SPANS}
    # set-up as run.py's setup_s holds it: the imports (this process's
    # start to the case's build), the build and host first step, whose
    # top-level spans setup_s sums, and the warm-up pass
    setup_split = dict(imports=t_build - T0, build=t_warm - t_build,
                       warm_up=t_end - t_warm)

    _, _, plain_s = run.replay(case, snap, sync)
    with timer.recording() as rec:
        records, _, traced_s = run.replay(case, snap, sync)
    if run.counts(records) != run.counts(warm):
        print(f"spanrun: the tracer's replay counts {run.counts(records)} "
              f"differ from the warm-up pass's {run.counts(warm)}",
              file=sys.stderr)
        return 5
    n = len(records)
    spans = _tuples(rec)
    names = {s[0] for s in spans}
    out = dict(
        steps=[[r["newton"], r["krylov"]] for r in records],
        setup_s=setup_s, setup_program_s=sum(setup_s.values()),
        setup_split=setup_split,
        inclusive_ns={name: inclusive_ns(spans, name) for name in names},
        sync_counts=dict(rec.counts), plain_s=plain_s, traced_s=traced_s,
        tracer_cost=traced_s / plain_s)
    print(f"spanrun {args.workload} seed {args.seed}: set-up (s) "
          f"{json.dumps(setup_split)}, its top-level spans (s) "
          f"{json.dumps(setup_s)}; replays: plain {plain_s:.3f} s, under "
          f"the tracer {traced_s:.3f} s ({traced_s / plain_s:.4f}x)",
          file=sys.stderr)
    print("set-up, whole:\n" + setup.summary(), file=sys.stderr)
    print(f"the tracer's replay, per step ({n} steps):\n"
          + rec.summary(per=n), file=sys.stderr)

    if on_card:
        activity = torch.profiler.ProfilerActivity
        sync()
        with timer.recording() as prec, torch.profiler.profile(
                activities=[activity.CUDA]) as prof:
            t0 = prec.offset_ns + time.perf_counter_ns()
            case.restore(snap)
            precords, _ = case.segment()
            sync()
            t1 = prec.offset_ns + time.perf_counter_ns()
        events = _device_events(prof)
        by_span, gaps = attribute_idle(events, _tuples(prec), t0, t1)
        busy = sum(b - a for a, b, _ in busy_union(events, t0, t1))
        out.update(profiled_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
                   idle_s=(t1 - t0 - busy) * 1e-9,
                   idle_by_span={k: v * 1e-9 for k, v in sorted(
                       by_span.items(), key=lambda kv: -kv[1])},
                   idle_gaps=[[g[0][:120], g[1] * 1e-9] for g in gaps],
                   profiled_counts_equal=run.counts(precords) ==
                   run.counts(warm))
        print(f"the profiled replay: {out['profiled_s']:.3f} s, busy "
              f"{out['busy_s']:.3f} s, idle {out['idle_s']:.3f} s; idle by "
              f"span (s): {json.dumps(out['idle_by_span'])}\nlongest idle "
              f"gaps: {json.dumps(out['idle_gaps'])}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
