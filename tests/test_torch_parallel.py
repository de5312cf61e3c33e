"""The port's parallel/shard.py and entry.py against the JAX package's
sharded functions (the nine sharding cases of tests/test_parallel.py,
built in code).

The port side runs once for the module: four gloo ranks on the CPU
(spawn_ranks) run every port case of CASES in one spawn and hand back
numpy.  The JAX side runs in this process on a four-device mesh (four of
the eight virtual CPU devices of tests/conftest.py) while the ranks
work.  Tolerances:

- the element-sharded fluid (two steps) and the dry run's Newton
  iteration: 1e-10 absolute against the unsharded runs of both packages;
- the sharded element CG (the beam, 2 steps; the long beam, 3 steps):
  1e-10 of the scale against the port unsharded and the JAX sharded;
- the padded InsIM and SCnsIM Newton iterations (every Krylov vector
  range-sharded: a quarter of its padded block on each rank): res_norm
  1e-10, du 1e-5 of the scale against the JAX sharded ones, FGMRES counts
  within 1; with preconditioner knobs set on the solver (KNOBS), the same
  against the port's unsharded iteration with equal counts;
- the sharded stepper (the cavity and the channel, 3 steps): 1e-5 of the
  scale, equal largest Newton count;
- the plane-sharded stencil: the apply 1e-12, the A-solve 1e-8 of the
  scale, iterations within 2;
- the dry run (entry.dryrun_multichip's checks, WINDOW_STEPS windows):
  its own tolerances (entry.compare) against the port's unsharded runs.

Also: la/krylov.py with reduce=None and with an identity reduce gives
today's bits; the collectives' halos are zero at the edge ranks; a rank
that raises makes spawn_ranks raise; the padded Newton refuses the dense
and multigrid preconditioners (shard_fluid_solver runs them:
tests/test_torch_parallel_branches.py).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import openifem_tpu.parallel.shard as jshard
from openifem_tpu_torch import entry
from openifem_tpu_torch.la import krylov
from openifem_tpu_torch.parallel import spawn_ranks
from torch_parity import JAX, np_

N_RANKS = 4
PIPE_STEPS = STEPPER_STEPS = 3
# preconditioner knobs that the sharded Newton must honour
KNOBS = dict(a_block_jacobi=True, a_poly=2)
CASES = (
    ("fluid_steps", "fluid_steps", {}),
    ("beam", "check_solid_cg", {}),
    ("long_beam", "check_solid_cg", dict(n_steps=3, reps=(16, 2),
                                         size=(8.0, 1.0))),
    ("insim_newton", "check_insim_newton", {}),
    ("insim_newton_knobs", "check_insim_newton", KNOBS),
    ("stepper", "stepper_window", dict(n_steps=STEPPER_STEPS)),
    ("pipe", "stepper_window", dict(n_steps=PIPE_STEPS, case="channel")),
    ("supg_newton", "supg_newton", {}),
    ("stencil", "stencil_asolve", dict(refine=4)),
    ("collectives", "probe_collectives", {}),
) + tuple((f"dryrun:{name}", fn, kw) for name, fn, kw in entry.check_cases())


def scale_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _jax_side():
    """The JAX package's sharded runs of the same configurations on four
    devices."""
    jnp = jax.numpy
    dmesh = jshard.make_cell_mesh(N_RANKS)
    out = {}

    def cavity(**kw):
        s = entry.cavity(pkg=JAX, **kw)
        s._u_stencil = None
        s._setup_done = True
        return s

    # two steps, unsharded (the element branch, as the port's sharded run)
    s = cavity(n_steps=2)
    s.run_one_step(True, verbose=False)
    s.run_one_step(False, verbose=False)
    out["fluid_steps"] = np.asarray(s.present_solution)

    for name, kw in (("beam", {}), ("long_beam", dict(
            n_steps=3, reps=(16, 2), size=(8.0, 1.0)))):
        solid = entry.beam(pkg=JAX, **kw)
        jshard.shard_solid_solver(solid, dmesh)
        entry.beam_steps(solid, kw.get("n_steps", 2))
        out[name] = np.asarray(solid.get_current_solution())

    s = cavity()
    args = (s.nonzero_constraints.apply_increment(s.present_solution),
            s.present_solution, s.indicator, s.fsi_acceleration,
            s.fsi_stress_cell, s.fsi_acc_nodal)
    du, rn, its, _ = jshard.sharded_insim_newton(s, dmesh)(*args)
    out["insim_newton"] = dict(du=np.asarray(du), res_norm=float(rn),
                               iters=int(its))

    for name, build, n in (
            ("stepper", lambda: cavity(n_steps=STEPPER_STEPS + 1),
             STEPPER_STEPS),
            ("pipe", lambda: entry.channel(pkg=JAX, n_steps=PIPE_STEPS + 1),
             PIPE_STEPS)):
        s = build()
        s._u_stencil = None
        s._setup_done = True
        s.run_one_step(True, verbose=False)
        u, rel, it = jshard.make_sharded_stepper(s, dmesh)(
            s.present_solution, n)
        out[name] = dict(u=np.asarray(u), rel=float(rel), newton=int(it),
                         tol=s.params.fluid_tolerance)

    s = entry.scnsim(pkg=JAX)
    eddy = jnp.zeros(s.u_space.n_nodes)
    sargs = (s.nonzero_constraints.apply_increment(s.present_solution),
             s.present_solution, s.indicator, s.fsi_acc_nodal,
             s.fsi_stress_nodal, s.stress_device, eddy)
    du, rn, its, _ = jshard.sharded_supg_newton(s, dmesh)(*sargs)
    out["supg_newton"] = dict(du=np.asarray(du), res_norm=float(rn),
                              iters=int(its))

    # the stencil: the port's problem at refine 4, moved over as numpy
    ps, Auu, b, atol = entry.stencil_problem(4, device="cpu")
    s = entry.cavity(refine=4, pkg=JAX)
    st = s._u_stencil
    sst = jshard.ShardedStencil(st, dmesh)
    Auu_j = jnp.asarray(np_(Auu))
    Ws = st.build_weights(Auu_j.reshape(s.mesh.n_cells, s.nlu, s.dim, s.nlu,
                                        s.dim))
    y = sst.unspread(jax.jit(sst.matvec)(sst.shard_weights(Ws),
                                         sst.spread(jnp.asarray(
                                             np_(ps.stencil_x)))))
    res = jshard.sharded_stencil_asolve(s, dmesh)(Auu_j, jnp.asarray(np_(b)),
                                                  atol)
    out["stencil"] = dict(y=np.asarray(y), x=np.asarray(res.x),
                          iters=int(res.iters))
    return out


@pytest.fixture(scope="module")
def runs():
    """(port rank results per rank, JAX results): the ranks run in a
    thread while this process computes the JAX side."""
    box = {}

    def ranks():
        try:
            box["port"] = [out for out, _, _ in spawn_ranks(
                entry.rank_run, N_RANKS, "cpu", CASES, timeout=600,
                all_ranks=True)]
        except BaseException as e:   # re-raised in the test process
            box["error"] = e
    t = threading.Thread(target=ranks)
    t.start()
    try:
        jax_out = _jax_side()
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    return box["port"], jax_out


@pytest.fixture(scope="module")
def port(runs):
    return runs[0][0]


def test_element_sharded_fluid_steps(runs, port):
    """Two steps with shard_fluid_solver against the unsharded steps of
    both packages."""
    ref = entry.numpy_tree(entry.fluid_steps(None, torch.device("cpu")))
    got = port["fluid_steps"]
    assert got["newton"] == ref["newton"]
    assert np.abs(got["u"] - ref["u"]).max() < 1e-10
    assert np.abs(got["u"] - runs[1]["fluid_steps"]).max() < 1e-10


@pytest.mark.parametrize("name", ["beam", "long_beam"])
def test_sharded_element_cg(runs, port, name):
    kw = {c[0]: c[2] for c in CASES}[name]
    ref = entry.numpy_tree(entry.check_solid_cg(None, torch.device("cpu"),
                                                **kw))
    got = port[name]
    assert scale_err(got["u"], ref["u"]) < 1e-10
    assert scale_err(got["u"], runs[1][name]) < 1e-10
    assert all(abs(a - b) <= 1 for a, b in zip(got["iters"], ref["iters"]))
    if name == "long_beam":
        assert got["u"].min() < -1e-4          # bends downward


@pytest.mark.parametrize("name", ["insim_newton", "supg_newton"])
def test_padded_newton_matches_jax(runs, port, name):
    got, ref = port[name], runs[1][name]
    assert abs(got["res_norm"] - ref["res_norm"]) < \
        1e-10 * max(1.0, ref["res_norm"])
    assert scale_err(got["du"], ref["du"]) < 1e-5
    assert abs(got["iters"] - ref["iters"]) <= 1


def test_padded_newton_keeps_the_solver_knobs(port):
    """The padded rank view runs the solver's own preconditioner: with the
    nodal block-Jacobi A-solve and two Richardson sweeps set on the
    solver, the sharded iteration matches the unsharded one with them."""
    ref = entry.numpy_tree(entry.check_insim_newton(
        None, torch.device("cpu"), **KNOBS))
    plain = entry.numpy_tree(entry.check_insim_newton(
        None, torch.device("cpu")))
    got = port["insim_newton_knobs"]
    assert abs(got["res_norm"] - ref["res_norm"]) < \
        1e-10 * max(1.0, ref["res_norm"])
    assert scale_err(got["du"], ref["du"]) < 1e-5
    assert got["iters"] == ref["iters"]
    # the knobs change the solve: the counts or the bits differ
    assert got["iters"] != plain["iters"] or \
        not np.array_equal(ref["du"], plain["du"])


@pytest.mark.parametrize("knob,value", [
    ("dense_precond", True), ("_pressure_mg", object()),
    ("_velocity_mg", object())])
@pytest.mark.parametrize("fn", ["sharded_insim_newton"])
def test_sharding_refuses_whole_cell_preconditioners(fn, knob, value):
    """The dense and multigrid preconditioners build their operator from
    every cell's block: the range-sharded padded Newton refuses them
    before touching the mesh and names shard_fluid_solver, which shards
    them (tests/test_torch_parallel_branches.py)."""
    from openifem_tpu_torch import parallel
    s = entry.cavity(device="cpu")
    setattr(s, knob, value)
    with pytest.raises(NotImplementedError,
                       match=f"{knob}.*shard_fluid_solver"):
        getattr(parallel, fn)(s, None)


@pytest.mark.parametrize("name", ["stepper", "pipe"])
def test_sharded_stepper_matches_jax(runs, port, name):
    got, ref = port[name], runs[1][name]
    assert got["rel"] < got["tol"] and ref["rel"] < ref["tol"]
    assert got["newton"] == ref["newton"]
    assert scale_err(got["u"], ref["u"]) < 1e-5
    # both hold the same sharded layout: 4 ranks, per-rank tables
    (tables,) = got["tables"]
    assert tables["n_cells"] * N_RANKS >= 64


@pytest.mark.parametrize("name", ["insim_newton", "supg_newton", "stepper",
                                  "pipe"])
def test_padded_newton_range_shards_its_vectors(runs, name):
    """Every Krylov vector of the padded Newton holds a quarter of its
    padded block on each of the four ranks: the outer [u_r | p_r] vector
    n_pad / 4 entries, the preconditioner's u and p vectors n_u_pad / 4
    and n_p_pad / 4; every vector that an operator was given is one of
    these pieces, and none is whole."""
    for rank_out in runs[0]:
        got = rank_out[name]
        pc = got["pieces"]
        assert pc["outer"] * N_RANKS == pc["n_pad"]
        assert pc["u"] * N_RANKS == pc["n_u_pad"]
        assert pc["p"] * N_RANKS == pc["n_p_pad"]
        assert set(got["lengths"]) == {pc["outer"], pc["u"], pc["p"]}
        assert min(got["lengths"].values()) > 0


def test_sharded_stencil_matches_jax(runs, port):
    got, ref = port["stencil"], runs[1]["stencil"]
    assert np.abs(got["y"] - ref["y"]).max() < \
        1e-12 * np.abs(ref["y"]).max()
    assert scale_err(got["x"], ref["x"]) < 1e-8
    assert abs(int(got["iters"]) - int(ref["iters"])) <= 2
    P0, cx, R, k = got["planes"]
    assert cx * N_RANKS >= P0 and cx >= k


@pytest.mark.parametrize("name", entry.CHECKS)
def test_dryrun_checks(port, name):
    """Each check of dryrun_multichip at four ranks against the port's
    unsharded run, with the dry run's own tolerances."""
    ref = entry.run_check(name, None, torch.device("cpu"))
    errors = entry.compare(name, port[f"dryrun:{name}"], ref)
    assert errors


def test_entry():
    fn, args = entry.entry("cpu")
    du, res = fn(*args)
    assert du.shape == (659,) and np.isfinite(float(res))
    assert torch.isfinite(du).all()


def test_collectives_halos_zero_at_edges(runs):
    per_rank = [r["collectives"] for r in runs[0]]
    v = np.arange(1, 4, dtype=np.float64)
    for rank, c in enumerate(per_rank):
        # the previous rank's hi = +v*(rank); the next rank's lo = -v*(rank+2)
        want_prev = v * rank if rank > 0 else np.zeros(3)
        want_next = -v * (rank + 2) if rank < N_RANKS - 1 else np.zeros(3)
        np.testing.assert_array_equal(c["from_prev"], want_prev)
        np.testing.assert_array_equal(c["from_next"], want_next)
        np.testing.assert_array_equal(c["all_reduce"], v * 10)
        np.testing.assert_array_equal(
            c["all_gather"], np.concatenate([v * r for r in range(1, 5)]))
        full = np.arange(4 * N_RANKS, dtype=np.float64) * 10
        np.testing.assert_array_equal(c["reduce_scatter"],
                                      full[4 * rank:4 * rank + 4])
    assert np.all(per_rank[0]["from_prev"] == 0)
    assert np.all(per_rank[N_RANKS - 1]["from_next"] == 0)


def test_spawn_ranks_raises_for_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank .* raised"):
        spawn_ranks(entry.rank_run, 2, "cpu",
                    (("x", "no_such_function", {}),), timeout=120)


def _system(n=40, seed=3):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = torch.as_tensor(Q @ Q.T + n * np.eye(n))
    N = torch.as_tensor(rng.standard_normal((n, n))) + n * torch.eye(
        n, dtype=torch.float64)
    b = torch.as_tensor(rng.standard_normal(n))
    w = torch.as_tensor((rng.random(n) > 0.2).astype(float))
    return A, N, b, w


@pytest.mark.parametrize("weighted", [False, True])
def test_krylov_reduce_keeps_the_bits(weighted):
    """reduce=None and an identity reduce give the same bits."""
    A, N, b, w = _system()
    kw = dict(weight=w) if weighted else {}
    outs = []
    for reduce in (None, lambda t: t):
        c = krylov.cg(lambda x: A @ x, b, M=lambda r: r / 40.0, atol=1e-12,
                      maxiter=200, reduce=reduce, **kw)
        g = krylov.fgmres(lambda x: N @ x, b, M=lambda r: r / 40.0,
                          atol=1e-12, restart=7, max_restarts=20,
                          reduce=reduce, **kw)
        outs.append((c, g))
    (c0, g0), (c1, g1) = outs
    assert torch.equal(c0.x, c1.x) and c0.iters == c1.iters
    assert c0.residual == c1.residual
    assert torch.equal(g0.x, g1.x) and g0.iters == g1.iters
    assert g0.residual == g1.residual
    assert c0.iters > 5 and g0.iters > 7
