#!/usr/bin/env python3
"""Time the port's scatter-add sites three ways on one CUDA GPU, at the
shapes the full-size cases give them: index_add_ (atomics), index_add_
under torch.use_deterministic_algorithms, and the planned sum the port
runs (la/operators.py: index_sum, add_at, dense_sum).

    python3 tools/time_scatter.py [--cases path_a,path_b,wall3d,vocal_fold]

Each case (path A: fsi_leaflet, 17,249 dofs; path B: fsi_leaflet_r2,
232,997 dofs; wall3d: fsi-wall-3D at 45,207 dofs; vocal_fold: 52,470
dofs, all with the bench knobs) is set up on the card and run for two
steps (the host first step and one more) while every call of the three
functions is recorded by its call site: the first call's inputs per
(site, shapes) and the calls per step.  Then each recorded call is timed
with chip_smoke.py's timing: device us per call (CUDA events around
back-to-back calls queued behind a sleep kernel) and host us per call
(the host clock over repeated enqueues).  The planned sum's plan is
built before timing, as on a path after its first step.  Prints the
card's name and power limit, then one JSON line per (case, site,
shapes), with the largest difference between the planned and the
atomic result relative to the atomic result's max norm, and per case a
summary line: the sum over its sites of calls per step times us per
call, for each route (device and host).
"""

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("path_a", "path_b", "wall3d", "vocal_fold")
NAMES = ("index_sum", "add_at", "dense_sum")


def _case(name):
    """An unrun FSI / MPIFSI of the case, on the card, for 2 steps."""
    if name in ("path_a", "path_b"):
        from openifem_tpu_torch.cases.fsi_leaflet import (leaflet_case,
                                                          port_package)
        config = "fsi_leaflet" if name == "path_a" else "fsi_leaflet_r2"
        return leaflet_case(port_package(), config, n_steps=2,
                            device="cuda")
    if name == "wall3d":
        from openifem_tpu_torch.cases import fsi_wall_3d as fw
        return fw.wall3d_case(fw.port_package(), full_res=True, n_steps=2,
                              device="cuda")
    from openifem_tpu_torch.cases import vocal_fold as vf
    return vf.vocal_fold_case(vf.port_package(), 2, global_refinements=(2, 1),
                              knobs=vf.BENCH_KNOBS, device="cuda")


def _site():
    """file:line (function) of the nearest caller outside la/operators.py,
    and of its caller when that is in la/dense.py."""
    frames = [f for f in traceback.extract_stack()[:-2]
              if not f.filename.endswith(os.path.join("la", "operators.py"))]
    out = []
    for f in reversed(frames):
        out.append(f"{os.path.relpath(f.filename, HERE)}:{f.lineno} "
                   f"({f.name})")
        if not f.filename.endswith(os.path.join("la", "dense.py")):
            break
    return " <- ".join(out)


@contextlib.contextmanager
def _recording(torch, calls):
    """Replace the three functions in every loaded module of the port by
    wrappers that record calls[(site, kind, shapes)] = [count, inputs]."""
    from openifem_tpu_torch.la import operators as ops
    real = {n: getattr(ops, n) for n in NAMES}

    def wrap(name):
        def rec(*args, **kw):
            def shape(a):
                return tuple(a.shape) if isinstance(a, torch.Tensor) else a
            shapes = tuple(shape(a) for a in args) + tuple(
                sorted((k, shape(v)) for k, v in kw.items()))
            key = (_site(), name, shapes)
            if key not in calls:
                # the inputs as they are now (add_at writes its first one)
                calls[key] = [0, [a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args], dict(kw)]
            calls[key][0] += 1
            return real[name](*args, **kw)
        return rec

    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("openifem_tpu_torch"):
            continue
        for n in NAMES:
            if getattr(mod, n, None) is real[n]:
                patched.append((mod, n))
                setattr(mod, n, wrap(n))
    try:
        yield
    finally:
        for mod, n in patched:
            setattr(mod, n, real[n])


def _routes(torch, name, args, kw):
    """(atomic, planned, (targets, plan), results): callables on the
    recorded inputs, the plan, and a callable that returns both routes'
    results from fresh copies.  The atomic one is the code the sites ran
    before: zeros and one index_add_, or for add_at one index_add_ into
    the output (timed in place on a copy made once, as the planned
    add_at is)."""
    from openifem_tpu_torch.la import operators as ops
    if name == "dense_sum":
        blocks, rows, cols, n_rows, n_cols = args
        vals = blocks.reshape(-1)

        def atomic():
            flat = (rows.long()[:, :, None] * n_cols +
                    cols.long()[:, None, :])
            M = torch.zeros((n_rows, n_cols), dtype=vals.dtype,
                            device=vals.device)
            M.view(-1).index_add_(0, flat.reshape(-1), vals)
            return M
        plan = ops.dense_sum_plan(rows, cols, n_rows, n_cols)

        def planned():
            return ops.dense_sum(*args)
        return atomic, planned, plan, lambda: (atomic(), planned())
    if name == "index_sum":
        n_out, idx, vals = args[:3]
        live = args[3] if len(args) > 3 else kw.get("live")
        rest = tuple(vals.shape[idx.dim():])

        def atomic():
            return torch.zeros((n_out,) + rest, dtype=vals.dtype,
                               device=vals.device).index_add_(
                0, idx.reshape(-1), vals.reshape((-1,) + rest))
        def planned():
            return ops.index_sum(*args, **kw)
        return (atomic, planned, ops.sum_plan(idx, n_out, live),
                lambda: (atomic(), planned()))
    out, idx, vals = args[:3]
    dim = args[3] if len(args) > 3 else kw.get("dim", 0)
    live = args[4] if len(args) > 4 else kw.get("live")
    v = vals.reshape(out.shape[:dim] + (idx.numel(),) + out.shape[dim + 1:])
    work_a, work_p = out.clone(), out.clone()
    return (lambda: work_a.index_add_(dim, idx.reshape(-1), v),
            lambda: ops.add_at(work_p, idx, vals, dim=dim, live=live),
            ops.sum_plan(idx, out.shape[dim], live),
            lambda: (out.clone().index_add_(dim, idx.reshape(-1), v),
                     ops.add_at(out.clone(), idx, vals, dim=dim, live=live)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sites are timed on a GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import openifem_tpu_torch  # noqa: F401  (the precision policy)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()} (torch: "
          f"{torch.cuda.get_device_name(0)})", flush=True)
    here = os.getcwd()
    for case in args.cases.split(","):
        if case not in CASES:
            raise SystemExit(f"unknown case {case}: one of {CASES}")
        calls = {}
        with tempfile.TemporaryDirectory(prefix="time_scatter_") as work:
            os.chdir(work)
            try:
                fsi = _case(case)
                with _recording(torch, calls):
                    fsi.run(verbose=False)
                torch.cuda.synchronize()
            finally:
                os.chdir(here)
        n_steps = len(fsi.step_log)
        del fsi
        per_step = {}
        for (site, name, shapes), (n, inputs, kw) in sorted(
                calls.items(), key=lambda kv: kv[0][0]):
            atomic, planned, (targets, plan), results = _routes(
                torch, name, inputs, kw)
            ref, got = results()
            scale = ref.abs().max().item() or 1.0
            row = dict(case=case, site=site, function=name,
                       shapes=str(shapes), calls_per_step=n / n_steps,
                       dtype=str(ref.dtype)[6:], out_shape=list(ref.shape),
                       plan_rows=plan.shape[0], plan_K=plan.shape[1],
                       outputs_reached="all" if targets is None
                       else int(targets.numel()),
                       max_rel_diff=(got - ref).abs().max().item() / scale)
            big = ref.numel() * ref.element_size() > 2 ** 26
            reps = 20 if big else cs.HOST_REPS
            for route, fn in (("atomic", atomic), ("planned", planned),
                              ("deterministic", atomic)):
                torch.use_deterministic_algorithms(route == "deterministic")
                try:
                    fn()
                    torch.cuda.synchronize()
                    host = cs._host_us(torch, fn, reps)
                    row[f"{route}_host_us"] = host
                    row[f"{route}_device_us"] = cs._device_us(
                        torch, fn, host, reps=min(reps, cs.DEVICE_REPS))
                finally:
                    torch.use_deterministic_algorithms(False)
            del ref, got
            print(json.dumps(row), flush=True)
            for k, v in row.items():
                if k.endswith("_us"):
                    per_step[k] = per_step.get(k, 0.0) + v * row[
                        "calls_per_step"]
        print(json.dumps(dict(case=case, sites=len(calls),
                              calls_per_step=sum(c[0] for c in
                                                 calls.values()) / n_steps,
                              us_per_step=per_step)), flush=True)
        del calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
