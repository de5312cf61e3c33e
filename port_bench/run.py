#!/usr/bin/env python3
"""The benchmark of openifem_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (BENCHMARK.json's workloads) names a configuration, whose builder
configs/<config>.py makes the case on the card and whose plain reference
reference/<config>.py judges it, and a mix (mixes/<traffic>.json) that
fixes the size, the solver path and the segment of steps.  Set-up builds
the case from the seed, runs the host first step, takes a snapshot of what
the solvers' checkpoints hold and runs the segment once (the warm-up pass,
whose counts every replay has to repeat).  The window restores the
snapshot and replays the segment, again and again, starting a replay only
where it would end within --seconds at the last replay's pace, and always
one.  With --trace 1 the window is three replays instead: a plain one, one
under the profiler alone and one under the host-sync counter alone, and
the cell's per-layer metrics (metrics/<name>.py) are read from them.  Then the last replay's states are judged by the reference, step by
step, and the last line is the result as one JSON object."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "openifem_tpu")


def load_cell(workload, root=ROOT):
    """(benchmark, cell, configuration entry, configuration file, mix) of a
    workload, found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "mixes", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return bench, cell, entry, cfg, mix


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer_metrics(bench, cell):
    """The per-layer metrics this cell reports: each names the cell, or
    lists no cells and moves an end-to-end metric the cell reports."""
    mine = {m["name"] for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and (m.get("workloads") or m["moves"] in mine)]


def counts(records):
    """What a replay has to repeat: per step the Newton and Krylov counts
    and whether it converged."""
    return [(r["newton"], r.get("solid_newton"), r["converged"],
             sorted(r["krylov"].items())) for r in records]


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def replay(case, snap, sync):
    """One replay, synchronised at both ends: (records, states,
    seconds)."""
    sync()
    t0 = time.perf_counter()
    case.restore(snap)
    records, states = case.segment()
    sync()
    return records, states, time.perf_counter() - t0


def traced_replays(case, snap, sync, on_card):
    """The per-layer metrics' context, from three replays of the segment,
    each under one kind of instrumentation so that none stretches
    another's reading: a plain one (the time the device's idle share is
    taken against), one under torch.profiler alone (the device's
    activity; the host's off the card, which gives no device events): the
    window, the trace and the kernel's launches by shape, and one under
    the host-sync counter, which also notes each launched shape's bytes.
    Every replay does the same work (the run requires equal counts), so
    each metric reads the segment.  Returns (the replays' records, the
    last replay's states, the traced window, the context)."""
    import torch
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.utils.timer import count_host_syncs

    import devtrace
    import peaks

    plain, _, plain_s = replay(case, snap, sync)

    before = dict(cuda_ops.launches)
    activity = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[
            activity.CUDA if on_card else activity.CPU]) as prof:
        records, _, window = replay(case, snap, sync)
    launches = {k: v - before.get(k, 0) for k, v in cuda_ops.launches.items()
                if v - before.get(k, 0)}

    bounds, real = {}, cuda_ops.launch

    def launch(layout, A, cell_stride, row_stride, rows, cols, n_out, x,
               nr, nc, dr=1, dc=1):
        key = (layout, peaks.dt_name(x.dtype), A.shape[0], nr, nc)
        if key not in bounds:
            bounds[key] = peaks.launch_bound(A, rows, cols, x, n_out, nr, nc)
        return real(layout, A, cell_stride, row_stride, rows, cols, n_out,
                    x, nr, nc, dr, dc)

    cuda_ops.launch = launch
    try:
        with count_host_syncs() as syncs:
            counted, states, counted_s = replay(case, snap, sync)
    finally:
        cuda_ops.launch = real
    print(f"replays: plain {plain_s:.3f} s, under the profiler {window:.3f}"
          f" s ({window / plain_s:.3f}x), under the sync counter "
          f"{counted_s:.3f} s ({counted_s / plain_s:.3f}x)", file=sys.stderr)
    reduced = devtrace.reduce(devtrace.device_events(prof))
    ctx = dict(steps=records, syncs=syncs["syncs"], plain_s=plain_s,
               window_s=window, trace=reduced, launches=launches,
               launch_bounds=bounds)
    return [plain, records, counted], states, window, ctx


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    # one process with few threads: the host's cores are shared, and the
    # program's host work is one thread of dispatch
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    bench, cell, _, cfg, mix = load_cell(args.workload)

    import torch
    torch.set_num_threads(1)
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    from openifem_tpu_torch.la import cuda_ops, operators

    import traffic
    config = importlib.import_module("configs." + cfg["name"])
    reference = importlib.import_module("reference." + cfg["name"])
    draw = traffic.draw(mix, args.seed)

    # -- set-up --------------------------------------------------------
    case = config.Case(cfg, mix, draw, device)
    case.first_step()
    first = case.state()
    snap = case.snapshot()
    t = time.perf_counter()
    warm, _ = case.segment()
    sync()
    pace = time.perf_counter() - t
    plans = (cuda_ops.plan_builds, operators.sum_plan_builds)
    setup_s = time.perf_counter() - T0
    print(f"set-up {setup_s:.3f} s; warm-up pass {pace:.3f} s, counts "
          f"{counts(warm)}", file=sys.stderr)

    # -- the window ----------------------------------------------------
    replays, paces = [], []
    ctx = None
    if args.trace:
        replays, states, window, ctx = traced_replays(case, snap, sync,
                                                      on_card)
    else:
        t_start = time.perf_counter()
        while True:
            t = time.perf_counter()
            case.restore(snap)
            records, states = case.segment()
            sync()
            now = time.perf_counter()
            pace = now - t
            replays.append(records)
            paces.append(pace)
            if now - t_start + pace > args.seconds:
                break
        window = time.perf_counter() - t_start
    steps_run = sum(len(r) for r in replays)
    new_plans = (cuda_ops.plan_builds - plans[0]
                 + operators.sum_plan_builds - plans[1])
    attempted, failed = len(replays), 0
    for k, r in enumerate(replays):
        same = counts(r) == counts(warm)
        failed += not same
        print(f"replay {k}: counts {'equal to' if same else 'DIFFER from'}"
              f" the warm-up pass's {counts(r) if not same else ''}"
              f"; plan builds since set-up {new_plans}", file=sys.stderr)
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        kind, count = torch.cuda.get_device_name(0), cell["chips"]
    else:
        peak, kind, count = 0, "cpu", 0

    # -- the comparison, with the program's state freed -----------------
    layout = case.layout()
    judged = [case.host(s) for s in [first] + states]
    case.free()
    del case, snap, first, states
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 4
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    t = time.perf_counter()
    numbers = {k: float(v) if isinstance(v, float) else v for k, v in
               reference.check(cfg, mix, draw, layout, judged).items()}
    print(f"comparison with the reference {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    numbers["replays_off"] = failed
    numbers["plan_builds"] = new_plans
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in mix["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    device_info = dict(platform="gpu" if on_card else "cpu", kind=kind,
                       count=count, memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=attempted, failed=failed)
    if args.trace:
        card = power_limit() if on_card else "cpu"
        metrics = {}
        for m in per_layer_metrics(bench, cell):
            value = importlib.import_module("metrics." + m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=ctx["trace"]["busy_s"], window_s=window)
        result.update(metrics=metrics, device=device_info, breakdown=dict(
            device_ops=ctx["trace"]["top_ops"],
            idle_gaps=ctx["trace"]["top_gaps"]))
        print(f"traced on {card}: {json.dumps(metrics)}", file=sys.stderr)
    else:
        values = dict(step_ms=1e3 * window / steps_run,
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])}
        result.update(metrics=metrics, device=device_info)
        print(f"window {window:.3f} s, {len(replays)} replays, {steps_run} "
              f"steps; replays of {[round(p, 4) for p in paces]} s",
              file=sys.stderr)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
