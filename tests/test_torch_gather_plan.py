"""The gather plan that the CUDA element-matvec kernel reads, on the CPU:
the port's make_gather_plan against openifem_tpu.la.operators' integer
for integer, the plan-driven applies against the JAX package (f64 to
1e-12 relative), and the kernel's index arithmetic (la/cuda_ops.emulate,
reached through the layouts' CUDA branch) against the scatter plain
version in all six layouts (f64 to 1e-12).  Also the plan cache and the
default device (the card unless the caller asks for the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.la import operators as jops
from openifem_tpu_torch.cases.fsi_leaflet import leaflet_case, port_package
from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import operators as ops
from torch_parity import leaflet_fsi, rel_err

TOL = 1e-12
# a random Taylor-Hood-like problem: Q2 velocity (9 nodes, d = 2) and Q1
# pressure (4 nodes) per cell, with more nodes than the tables reach
N_C, NLU, D, NLP, N_UN, N_P = 37, 9, 2, 4, 70, 30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def leaflet_tables():
    """The coarse leaflet fluid's tables (numpy), as the port builds them
    (tests/test_torch_fe_mesh.py holds them equal to the JAX package's)."""
    fsi = leaflet_fsi(True, n_steps=1)
    fl = fsi.fluid
    fl.mesh = fl.mesh.refine_global(fsi.params.global_refinements[0])
    fl.setup()
    return dict(cell_dofs=fl.cell_dofs.numpy(), n_dofs=fl.n_dofs,
                cell_nodes_u=fl.cell_nodes_u.numpy(), n_un=fl.n_u // fl.dim,
                cell_dofs_p=fl.cell_dofs_p.numpy(), n_p=fl.n_p)


def _random_tables():
    rng = np.random.default_rng(5)
    # the last velocity nodes and pressure dof have no incidence
    un = rng.integers(0, N_UN - 2, size=(N_C, NLU)).astype(np.int32)
    pd = rng.integers(0, N_P - 1, size=(N_C, NLP)).astype(np.int32)
    return un, pd


def _table_cases(lt):
    un, pd = _random_tables()
    return {"cell_dofs": (lt["cell_dofs"], lt["n_dofs"]),
            "cell_nodes_u": (lt["cell_nodes_u"], lt["n_un"]),
            "cell_dofs_p": (lt["cell_dofs_p"], lt["n_p"]),
            "random_u_nodes": (un, N_UN), "random_p_dofs": (pd, N_P)}


@pytest.mark.parametrize("table", ["cell_dofs", "cell_nodes_u",
                                   "cell_dofs_p", "random_u_nodes",
                                   "random_p_dofs"])
def test_plan_equals_jax(leaflet_tables, table):
    cd, n = _table_cases(leaflet_tables)[table]
    got = ops.make_gather_plan(_t(cd), n)
    want = np.asarray(jops.make_gather_plan(jnp.asarray(cd), n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if table.startswith("random"):
        sentinel = want == cd.size
        assert sentinel.all(axis=1).any()     # a dof with no incidence
        assert sentinel.any(axis=1).any()     # K padded for some dofs
        assert not sentinel[:, -1].all()      # and reached by others


@pytest.mark.parametrize("which", ["gather", "rect_gather"])
def test_plan_applies_match_jax(which):
    rng = np.random.default_rng(6)
    un, pd = _random_tables()
    cd_u = (un[:, :, None] * D + np.arange(D)).reshape(N_C, -1).astype(
        np.int32)
    if which == "gather":
        A = rng.normal(size=(N_C, NLP, NLP))
        x = rng.normal(size=N_P)
        plan = jops.make_gather_plan(jnp.asarray(pd), N_P)
        want = jops.element_matvec_gather(jnp.asarray(A), jnp.asarray(pd),
                                          plan, jnp.asarray(x))
        got = ops.element_matvec_gather(_t(A), _t(pd),
                                        ops.make_gather_plan(_t(pd), N_P),
                                        _t(x))
        plain = ops.element_matvec_plain(_t(A), _t(pd), N_P, _t(x))
    else:
        A = rng.normal(size=(N_C, NLP, NLU * D))
        x = rng.normal(size=N_UN * D)
        plan = jops.make_gather_plan(jnp.asarray(pd), N_P)
        want = jops.element_matvec_rect_gather(
            jnp.asarray(A), jnp.asarray(cd_u), plan, jnp.asarray(x))
        got = ops.element_matvec_rect_gather(
            _t(A), _t(cd_u), ops.make_gather_plan(_t(pd), N_P), _t(x))
        plain = ops.element_matvec_rect_plain(_t(A), _t(pd), _t(cd_u), N_P,
                                              _t(x))
    assert rel_err(got, want) <= TOL
    assert rel_err(plain, want) <= TOL


class _OnCard(torch.Tensor):
    """A CPU tensor that the layouts' dispatch takes for a CUDA one, so
    that their kernel branch (with cuda_ops.launch replaced by
    cuda_ops.emulate) runs here."""

    @property
    def is_cuda(self):
        return True


def _coupled_problem(source, leaflet_tables):
    rng = np.random.default_rng(7)
    if source == "random":
        un, pd = _random_tables()
        n_c, n_un, n_p = N_C, N_UN, N_P
    else:
        lt = leaflet_tables
        un, pd = lt["cell_nodes_u"], lt["cell_dofs_p"]
        n_c, n_un, n_p = un.shape[0], lt["n_un"], lt["n_p"]
    n_u = n_un * D
    cd = np.concatenate([(un[:, :, None] * D + np.arange(D)).reshape(n_c, -1),
                         pd + n_u], axis=1).astype(np.int32)
    nl = NLU * D + NLP
    return dict(A=_t(rng.normal(size=(n_c, nl, nl))), un=_t(un), pd=_t(pd),
                cd=_t(cd), x=_t(rng.normal(size=n_u + n_p)), n_c=n_c,
                n_un=n_un, n_p=n_p)


def _layout_calls(pr):
    """{layout: (entry point, plain version, args)}, with the strided
    views of one coupled block that the solver passes."""
    A, un, pd, cd, x = pr["A"], pr["un"], pr["pd"], pr["cd"], pr["x"]
    n_c, n_un, n_p = pr["n_c"], pr["n_un"], pr["n_p"]
    nu, n_u = NLU * D, n_un * D
    xu, xp = x[:n_u], x[n_u:]
    return {
        "element_matvec": (ops.element_matvec, ops.element_matvec_plain,
                           (A[:, nu:, nu:], pd, n_p, xp)),
        "element_matvec_rect": (
            ops.element_matvec_rect, ops.element_matvec_rect_plain,
            (A[:, nu:, :nu], pd, cd[:, :nu].contiguous(), n_p, xu)),
        "element_matvec_nodeblock": (
            ops.element_matvec_nodeblock, ops.element_matvec_nodeblock_plain,
            (A[:, :nu, :nu].reshape(n_c, NLU, D, NLU, D), un, n_un, xu)),
        "element_matvec_u_to_p_nodeblock": (
            ops.element_matvec_u_to_p_nodeblock,
            ops.element_matvec_u_to_p_nodeblock_plain,
            (A[:, nu:, :nu].reshape(n_c, NLP, NLU, D), un, pd, n_p, xu)),
        "element_matvec_p_to_u_nodeblock": (
            ops.element_matvec_p_to_u_nodeblock,
            ops.element_matvec_p_to_u_nodeblock_plain,
            (A[:, :nu, nu:].reshape(n_c, NLU, D, NLP), un, pd, n_un, xp)),
        "element_matvec_taylor_hood": (
            lambda *a: ops.element_matvec_taylor_hood(*a, cell_dofs=cd),
            ops.element_matvec_taylor_hood_plain,
            (A, un, pd, NLU, D, n_u, n_p, x)),
    }


@pytest.mark.parametrize("source", ["random", "leaflet"])
@pytest.mark.parametrize("layout", cuda_ops.LAYOUTS)
def test_kernel_indexing_matches_scatter(leaflet_tables, monkeypatch,
                                         layout, source):
    pr = _coupled_problem(source, leaflet_tables)
    entry, plain, args = _layout_calls(pr)[layout]
    want = plain(*args)
    monkeypatch.setattr(cuda_ops, "launch", cuda_ops.emulate)
    on_card = tuple(a.as_subclass(_OnCard) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() and a.dim() == 1 else a
                    for a in args)
    got = entry(*on_card).as_subclass(torch.Tensor)
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL


def test_plan_is_built_once_per_table():
    """The launch path checks and builds a table's plan once; a table
    changed in place gets a new plan."""
    un, pd = _random_tables()
    rows, cpu = _t(pd), torch.device("cpu")
    n0 = cuda_ops.plan_builds
    first = cuda_ops._row_plan(rows, N_P, NLP, 1, cpu)
    again = cuda_ops._row_plan(rows, N_P, NLP, 1, cpu)
    assert again[0] is first[0] and cuda_ops.plan_builds == n0 + 1
    plan, K, n_flat = first
    assert n_flat == pd.size and K == plan.shape[1]
    rows[0, 0] = N_P - 1
    changed = cuda_ops._row_plan(rows, N_P, NLP, 1, cpu)
    assert cuda_ops.plan_builds == n0 + 2
    assert changed[0][N_P - 1, 0] == 0
    # node-block rows: the plan has n_out / d rows
    nb = cuda_ops._row_plan(_t(un), N_UN * D, NLU * D, D, cpu)
    assert nb[0].shape[0] == N_UN
    with pytest.raises(TypeError, match="int32"):
        cuda_ops._row_plan(_t(pd).long(), N_P, NLP, 1, cpu)
    with pytest.raises(ValueError, match="outside"):
        cuda_ops._row_plan(_t(pd), N_P - 1, NLP, 1, cpu)
    with pytest.raises(ValueError, match="shape"):
        cuda_ops._row_plan(_t(pd), N_P, NLP + 1, 1, cpu)


def _coarse_case(**kw):
    return leaflet_case(port_package(), "element", h=0.1,
                        refinements=(0, 1), n_steps=1, **kw)


def test_default_device_is_the_card(monkeypatch):
    """With no device argument and no OPENIFEM_DEVICE the solvers take
    "cuda" and raise without a card; device="cpu" or OPENIFEM_DEVICE=cpu
    ask for the CPU."""
    monkeypatch.delenv("OPENIFEM_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _coarse_case()
    fsi = _coarse_case(device="cpu")
    assert fsi.fluid.device.type == "cpu" and fsi.solid.device.type == "cpu"
    monkeypatch.setenv("OPENIFEM_DEVICE", "cpu")
    fsi = _coarse_case()
    assert fsi.fluid.device.type == "cpu" and fsi.solid.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("OPENIFEM_DEVICE")
    from openifem_tpu_torch import config
    assert config.device() == torch.device("cuda")
