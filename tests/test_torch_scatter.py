"""The port's deterministic scatter-adds (la/operators.py: sum plans,
planned sums, index_sum / add_at / dense_sum and AtomicScatterGuard), on
the CPU:

- each of the four shapes the sites need (1-D values; rows of width k;
  the flat dense build; condense_right's column sum), its planned sum
  against index_add_ and against the JAX package's .at[].add on the same
  seeded inputs with heavy duplicates: 1e-15 relative in f64, 1e-6 in
  f32 (relative to the reference's max norm; the orders differ);
- the plan cache: one build per table, a rebuild after an in-place
  change (of either table of a dense plan); a table made per call gets
  its plan per call, the same plan every time (stable sorts);
- the guard raises on every atomic scatter-add it names, and lets the
  order-free ones through;
- a source scan: no port module calls an atomic scatter-add outside
  la/operators.py's CPU branches and its *_plain twins;
- the card's route run here (the planned sums, and the kernel's index
  arithmetic through cuda_ops.emulate, under the guard) through coarse
  runs that reach every routed site: equal to the CPU route within
  1e-10, and no plan built after the first step.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import operators as ops
from torch_parity import rel_err

TOL = {torch.float64: 1e-15, torch.float32: 1e-6}
PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "openifem_tpu_torch")


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on the CPU: planned sums, the kernel emulated."""
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_ops, "launch", cuda_ops.emulate)


def _cases(dtype):
    """(name, planned call, index_add_ call, JAX call) per shape, on
    tables with heavy duplicates (about 16 entries per reached output,
    and outputs no entry reaches)."""
    rng = np.random.default_rng(12)
    npd = np.float64 if dtype == torch.float64 else np.float32
    n, m, k = 40, 600, 3
    idx = rng.integers(0, n - 2, size=(m // 6, 6))
    v1 = rng.normal(size=idx.shape).astype(npd)
    vk = rng.normal(size=idx.shape + (k,)).astype(npd)
    vkk = rng.normal(size=idx.shape + (2, 2)).astype(npd)
    rows = rng.integers(0, 12, size=(30, 5))          # dense: 12 x 9
    cols = rng.integers(0, 9, size=(30, 4))
    blk = rng.normal(size=(30, 5, 4)).astype(npd)
    M = rng.normal(size=(7, n)).astype(npd)
    vc = rng.normal(size=(7,) + idx.shape).astype(npd)
    t = torch.from_numpy
    ti = t(idx)
    flat = (rows[:, :, None] * 9 + cols[:, None, :]).reshape(-1)
    return [
        ("1-D", lambda: ops.index_sum(n, ti, t(v1)),
         lambda: torch.zeros(n, dtype=dtype).index_add_(
             0, ti.reshape(-1), t(v1).reshape(-1)),
         lambda: jnp.zeros(n, npd).at[idx.reshape(-1)].add(v1.reshape(-1))),
        ("rows (n, k)", lambda: ops.index_sum(n, ti, t(vk)),
         lambda: torch.zeros(n, k, dtype=dtype).index_add_(
             0, ti.reshape(-1), t(vk).reshape(-1, k)),
         lambda: jnp.zeros((n, k), npd).at[idx.reshape(-1)].add(
             vk.reshape(-1, k))),
        ("rows (n, d, d)", lambda: ops.add_at(
            torch.ones(n, 2, 2, dtype=dtype), ti, t(vkk)),
         lambda: torch.ones(n, 2, 2, dtype=dtype).index_add_(
             0, ti.reshape(-1), t(vkk).reshape(-1, 2, 2)),
         lambda: jnp.ones((n, 2, 2), npd).at[idx.reshape(-1)].add(
             vkk.reshape(-1, 2, 2))),
        ("dense build", lambda: ops.dense_sum(t(blk), t(rows), t(cols),
                                              12, 9),
         lambda: torch.zeros(12 * 9, dtype=dtype).index_add_(
             0, t(flat), t(blk).reshape(-1)).reshape(12, 9),
         lambda: jnp.zeros(12 * 9, npd).at[flat].add(
             blk.reshape(-1)).reshape(12, 9)),
        ("columns", lambda: ops.add_at(t(M.copy()), ti, t(vc), dim=1),
         lambda: t(M.copy()).index_add_(1, ti.reshape(-1),
                                        t(vc).reshape(7, -1)),
         lambda: jnp.asarray(M).at[:, idx.reshape(-1)].add(
             vc.reshape(7, -1)))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_planned_sums_match_index_add_and_jax(card_route, dtype):
    for name, planned, atomic, jax_ref in _cases(dtype):
        with ops.AtomicScatterGuard("cpu"):
            got = planned()
        want = atomic()
        assert got.dtype == dtype and got.shape == want.shape, name
        assert rel_err(got, want) <= TOL[dtype], name
        assert rel_err(got, np.asarray(jax_ref())) <= TOL[dtype], name
        # the same bits every time
        assert torch.equal(planned(), got), name


def test_cpu_route_is_index_add(monkeypatch):
    """On a CPU tensor the wrappers call index_add_ itself, so the CPU
    parity tests keep their bits."""
    for name, planned, atomic, _ in _cases(torch.float64):
        assert torch.equal(planned(), atomic()), name
        with pytest.raises(RuntimeError, match="atomic scatter-add"):
            with ops.AtomicScatterGuard("cpu"):
                planned()


def test_sum_plan_layout():
    idx = torch.tensor([[3, 1], [1, 5]])
    targets, plan = ops.make_sum_plan(idx, 7)
    assert targets.tolist() == [1, 3, 5]
    # rows in increasing order, padded with the sentinel idx.numel()
    assert plan.dtype == torch.int32
    assert plan.tolist() == [[1, 2], [0, 4], [3, 4]]
    targets, plan = ops.make_sum_plan(torch.tensor([2, 0, 1, 0]), 3)
    assert targets is None and plan.tolist() == [[1, 3], [2, 4], [0, 4]]
    with pytest.raises(ValueError, match="outside"):
        ops.make_sum_plan(idx, 5)
    # slots left out by a live mask: never read, and the sentinel stays
    # idx.numel()
    live = torch.tensor([[True, False], [True, True]])
    targets, plan = ops.make_sum_plan(idx, 7, live)
    assert targets.tolist() == [1, 3, 5]
    assert plan.tolist() == [[2], [0], [3]]


def test_live_mask_drops_the_padding(card_route):
    """A fixed-width neighbour table whose unused slots point at output 0
    with zero values (the RKPM tables' padding): with the live mask the
    plan's K is the real largest count, and the sum is the same."""
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 30, size=(200, 8)))
    live = torch.from_numpy(rng.random((200, 8)) < 0.5)
    idx = torch.where(live, idx, 0)
    vals = torch.where(live[..., None],
                       torch.from_numpy(rng.normal(size=(200, 8, 3))), 0.0)
    _, wide = ops.make_sum_plan(idx, 30)
    _, plan = ops.make_sum_plan(idx, 30, live)
    assert plan.shape[1] < wide.shape[1] // 4
    want = torch.zeros(30, 3, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), vals.reshape(-1, 3))
    with ops.AtomicScatterGuard("cpu"):
        got = ops.index_sum(30, idx, vals, live)
        more = ops.add_at(torch.ones(30, 3, dtype=torch.float64), idx, vals,
                          live=live)
    assert rel_err(got, want) <= 1e-15
    assert rel_err(more, want + 1.0) <= 1e-15


def test_plan_is_built_once_per_table():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 20, size=(30, 4)))
    n0 = ops.sum_plan_builds
    first = ops.sum_plan(idx, 20)
    assert ops.sum_plan(idx, 20) is first and ops.sum_plan_builds == n0 + 1
    idx[0, 0] = 19
    changed = ops.sum_plan(idx, 20)
    assert changed is not first and ops.sum_plan_builds == n0 + 2
    # a dense plan depends on both tables
    rows, cols = idx[:, :2].clone(), idx[:, 2:].clone()
    dense = ops.dense_sum_plan(rows, cols, 20, 20)
    assert ops.dense_sum_plan(rows, cols, 20, 20) is dense
    cols[0, 0] = (cols[0, 0] + 1) % 20
    assert ops.dense_sum_plan(rows, cols, 20, 20) is not dense
    other = cols.clone()
    assert ops.dense_sum_plan(rows, other, 20, 20) is not dense
    assert ops.sum_plan_builds == n0 + 5


def test_per_call_tables(card_route):
    """A table made anew at each call (an index set that changes) gets a
    plan at each call, built by stable sorts: the same plan for the same
    entries, and the right sum for each set."""
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.normal(size=50))
    n0 = ops.sum_plan_builds
    for _ in range(3):
        idx = torch.from_numpy(rng.integers(0, 9, size=50))
        got = ops.index_sum(9, idx, vals)
        assert torch.allclose(got, torch.zeros(9, dtype=torch.float64)
                              .index_add_(0, idx, vals), rtol=0,
                              atol=1e-14)
        again = ops.make_sum_plan(idx.clone(), 9)
        assert torch.equal(again[1], ops.make_sum_plan(idx, 9)[1])
    assert ops.sum_plan_builds == n0 + 3


def test_guard_names_every_atomic_scatter():
    x = torch.zeros(5, dtype=torch.float64)
    i = torch.tensor([0, 1, 1])
    v = torch.ones(3, dtype=torch.float64)
    atomic = [lambda: x.index_add_(0, i, v),
              lambda: torch.index_add(x, 0, i, v),
              lambda: x.index_put_((i,), v, accumulate=True),
              lambda: x.index_put((i,), v, True),
              lambda: x.put_(i, v, accumulate=True),
              lambda: x.scatter_add(0, i, v),
              lambda: x.scatter_add_(0, i, v),
              lambda: x.scatter_reduce(0, i, v, "sum"),
              lambda: x.scatter_reduce_(0, i, v, reduce="mean")]
    for call in atomic:
        with pytest.raises(RuntimeError, match="atomic scatter-add"):
            with ops.AtomicScatterGuard("cpu"):
                call()
    with ops.AtomicScatterGuard("cpu"):
        x.scatter_reduce(0, i, v, "amax")
        x.index_put_((i,), v)
        torch.zeros(5, dtype=torch.int64).index_add_(0, i, i)
    # the default guards the card only
    with ops.AtomicScatterGuard():
        x.index_add_(0, i, v)


# -- the source scan -----------------------------------------------------

_ATOMIC = {"index_add", "index_add_", "scatter_add_", "index_reduce",
           "index_reduce_"}


def _atomic_calls(tree):
    """(function name or None, line) of each atomic scatter-add call:
    index_add(_), scatter_add_, torch.scatter_add, any call with
    accumulate=True, scatter_reduce(_) with a "sum" or "mean" literal."""
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child.name
            if isinstance(child, ast.Call):
                f = child.func
                name = f.attr if isinstance(f, ast.Attribute) else None
                lits = [a.value for a in child.args + [
                    k.value for k in child.keywords]
                    if isinstance(a, ast.Constant)]
                if (name in _ATOMIC
                        or (name == "scatter_add"
                            and isinstance(f.value, ast.Name)
                            and f.value.id == "torch")
                        or any(k.arg == "accumulate"
                               and not (isinstance(k.value, ast.Constant)
                                        and k.value.value is False)
                               for k in child.keywords)
                        or (name in ("scatter_reduce", "scatter_reduce_")
                            and ({"sum", "mean"} & set(
                                v for v in lits if isinstance(v, str))))):
                    found.append((fn, child.lineno))
            visit(child, inner)
    visit(tree, None)
    return found


def test_no_atomic_scatter_outside_the_cpu_branches():
    allowed = {"add_at", "dense_sum"}      # their CPU branch
    bad = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            rel = os.path.relpath(path, PORT)
            for fn, line in _atomic_calls(tree):
                if rel == os.path.join("la", "operators.py") and fn and (
                        fn in allowed or fn.endswith("_plain")):
                    continue
                bad.append(f"{rel}:{line} ({fn})")
    assert not bad, f"atomic scatter-adds outside the CPU branches: {bad}"


def test_the_scan_finds_what_it_looks_for():
    src = ("def f(y, i, v):\n"
           "    y.index_add_(0, i, v)\n"
           "    torch.scatter_add(y, 0, i, v)\n"
           "    y.index_put_((i,), v, accumulate=True)\n"
           "    y.scatter_reduce(0, i, v, reduce='sum')\n"
           "    y.scatter_reduce(0, i, v, 'amax')\n"
           "    y.index_put_((i,), v, accumulate=False)\n")
    assert [line for _, line in _atomic_calls(ast.parse(src))] == \
        [2, 3, 4, 5]


# -- the card's route through coarse runs --------------------------------

def _step_builds(fsi):
    """sum_plan_builds before and after each step (coupled or per
    phase)."""
    marks = []

    def counted(real):
        def step(*args, **kw):
            marks.append(ops.sum_plan_builds)
            out = real(*args, **kw)
            marks.append(ops.sum_plan_builds)
            return out
        return step
    fsi.run_one_coupled_step = counted(fsi.run_one_coupled_step)
    fsi._run_phases = counted(fsi._run_phases)
    return marks


@pytest.mark.parametrize("config", ["fsi_leaflet", "block_contact"])
def test_card_route_runs(config, tmp_path, monkeypatch):
    """Path A's coarse configuration in f64 (dense condensed blocks with
    hanging rows, the solid's dense solve and rhs, the fluid's stress
    projection, the residual and diagonal sums) and the MPI block with
    contact (the contact traction at shared vertices, the shared solid):
    the card's route under the guard against the CPU route, 1e-10, equal
    Newton counts, and no plan built after the first step."""
    from openifem_tpu_torch.cases import mpi_block as mb
    from openifem_tpu_torch.cases.fsi_leaflet import (leaflet_case,
                                                      port_package)
    monkeypatch.chdir(tmp_path)

    def make():
        if config == "block_contact":
            return mb.block_case(mb.port_package(), "contact", n_steps=2,
                                 device="cpu")
        return leaflet_case(port_package(), config, h=0.1,
                            refinements=(0, 1), n_steps=3, device="cpu",
                            bench_precision=False)

    ref = make()
    ref.run(verbose=False)
    with monkeypatch.context() as m:
        m.setattr(ops, "_on_card", lambda t: True)
        m.setattr(cuda_ops, "launch", cuda_ops.emulate)
        got = make()
        marks = _step_builds(got)
        with ops.AtomicScatterGuard("cpu"):
            got.run(verbose=False)
    assert [(s["solid_newton"], s["fluid_newton"], s["solid_retries"])
            for s in got.step_log] == \
        [(s["solid_newton"], s["fluid_newton"], s["solid_retries"])
         for s in ref.step_log]
    assert rel_err(got.fluid.present_solution,
                   ref.fluid.present_solution) <= 1e-10
    assert rel_err(got.solid.current_displacement,
                   ref.solid.current_displacement) <= 1e-10
    assert len(marks) == 2 * len(ref.step_log) and marks[-1] == marks[1]


def test_card_route_rkpm(card_route, monkeypatch):
    """The RKPM solid's particle sums (internal force, boundary traction,
    nodal stress) on the card's route under the guard: within 1e-12 of
    the CPU route, from one seeded state."""
    from test_torch_hypo import _seeded_shared
    _, psol = _seeded_shared(2)
    args = (psol.x, psol.v, psol.sigma, psol.fsi_stress_rows)
    with ops.AtomicScatterGuard("cpu"):
        got = psol._device_step_impl(*args)
        nodal = psol._nodal_stress_impl(psol.sigma)
    monkeypatch.setattr(ops, "_on_card", lambda t: False)
    want = psol._device_step_impl(*args)
    assert rel_err(nodal, psol._nodal_stress_impl(psol.sigma)) <= 1e-12
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-12
