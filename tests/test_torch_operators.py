"""The port's element-matvec layouts (plain PyTorch versions, which the
dispatch runs for CPU tensors) against openifem_tpu.la.operators and the
Pallas kernel in interpret mode.  Tolerances are relative to the
reference's max norm: 1e-13 in f64, 1e-5 in f32 (sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.la import operators as jops
from openifem_tpu.la.pallas_ops import pallas_element_matvec
from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import operators as ops
from torch_parity import rel_err

TOL = {np.float64: 1e-13, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]

# a small Taylor-Hood-like problem: Q2 velocity (9 nodes, d = 2) and Q1
# pressure (4 nodes) per cell
N_C, NLU, D, NLP, N_UN, N_P = 37, 9, 2, 4, 60, 25


def _problem(dtype, seed=0):
    rng = np.random.default_rng(seed)
    nl = NLU * D + NLP
    return dict(
        A=rng.normal(size=(N_C, nl, nl)).astype(dtype),
        u_nodes=rng.integers(0, N_UN, size=(N_C, NLU)).astype(np.int32),
        p_dofs=rng.integers(0, N_P, size=(N_C, NLP)).astype(np.int32),
        x=rng.normal(size=N_UN * D + N_P).astype(dtype))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layouts(pr):
    """(name, port call on torch tensors, JAX call) for every layout."""
    A, un, pd, x = pr["A"], pr["u_nodes"], pr["p_dofs"], pr["x"]
    nu, n_u = NLU * D, N_UN * D
    Auu_b = A[:, :nu, :nu].reshape(N_C, NLU, D, NLU, D)
    Aup_b = A[:, :nu, nu:].reshape(N_C, NLU, D, NLP)
    Apu_b = A[:, nu:, :nu].reshape(N_C, NLP, NLU, D)
    Mp = A[:, nu:, nu:]
    xu, xp = x[:n_u], x[n_u:]
    cd_u = (un[:, :, None] * D + np.arange(D)).reshape(N_C, -1).astype(
        np.int32)
    return [
        ("element_matvec",
         lambda: ops.element_matvec(_t(Mp), _t(pd), N_P, _t(xp)),
         lambda: jops.element_matvec(jnp.asarray(Mp), jnp.asarray(pd), N_P,
                                     jnp.asarray(xp))),
        ("element_matvec_rect",
         lambda: ops.element_matvec_rect(_t(A[:, nu:, :nu]), _t(pd),
                                         _t(cd_u), N_P, _t(xu)),
         lambda: jops.element_matvec_rect(
             jnp.asarray(A[:, nu:, :nu]), jnp.asarray(pd), jnp.asarray(cd_u),
             N_P, jnp.asarray(xu))),
        ("element_matvec_nodeblock",
         lambda: ops.element_matvec_nodeblock(_t(Auu_b), _t(un), N_UN,
                                              _t(xu)),
         lambda: jops.element_matvec_nodeblock(
             jnp.asarray(Auu_b), jnp.asarray(un), N_UN, jnp.asarray(xu))),
        ("element_matvec_u_to_p_nodeblock",
         lambda: ops.element_matvec_u_to_p_nodeblock(_t(Apu_b), _t(un),
                                                     _t(pd), N_P, _t(xu)),
         lambda: jops.element_matvec_u_to_p_nodeblock(
             jnp.asarray(Apu_b), jnp.asarray(un), jnp.asarray(pd), N_P,
             jnp.asarray(xu))),
        ("element_matvec_p_to_u_nodeblock",
         lambda: ops.element_matvec_p_to_u_nodeblock(_t(Aup_b), _t(un),
                                                     _t(pd), N_UN, _t(xp)),
         lambda: jops.element_matvec_p_to_u_nodeblock(
             jnp.asarray(Aup_b), jnp.asarray(un), jnp.asarray(pd), N_UN,
             jnp.asarray(xp))),
        ("element_matvec_taylor_hood",
         lambda: ops.element_matvec_taylor_hood(
             _t(A), _t(un), _t(pd), NLU, D, n_u, N_P, _t(x)),
         lambda: jops.element_matvec_taylor_hood(
             jnp.asarray(A), jnp.asarray(un), jnp.asarray(pd), NLU, D, n_u,
             N_P, jnp.asarray(x))),
    ]


LAYOUT_NAMES = [name for name, _, _ in _layouts(_problem(np.float64))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("layout", LAYOUT_NAMES)
def test_layout_matches_jax(layout, dtype):
    before = dict(cuda_ops.launches)
    (_, port, ref), = [c for c in _layouts(_problem(dtype))
                       if c[0] == layout]
    got, want = port(), ref()
    assert got.dtype == _t(np.zeros(1, dtype)).dtype
    assert rel_err(got, want) <= TOL[dtype]
    # CPU tensors take the plain version: the kernel never launched
    assert cuda_ops.launches == before


def test_taylor_hood_equals_one_scalar_apply_over_system_table():
    """The CUDA path runs the Taylor-Hood apply as one scalar-layout launch
    over the system dof table; on the plain side that is the same sum."""
    pr = _problem(np.float64, seed=3)
    A, un, pd, x = pr["A"], pr["u_nodes"], pr["p_dofs"], pr["x"]
    n_u = N_UN * D
    cd = np.concatenate([(un[:, :, None] * D + np.arange(D)).reshape(N_C, -1),
                         pd + n_u], axis=1).astype(np.int32)
    th = ops.element_matvec_taylor_hood_plain(_t(A), _t(un), _t(pd), NLU, D,
                                              n_u, N_P, _t(x))
    flat = ops.element_matvec_plain(_t(A), _t(cd), n_u + N_P, _t(x))
    assert rel_err(flat, th) <= 1e-13


def test_scalar_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    n_c, nl, n = 37, 12, 100
    A = rng.normal(size=(n_c, nl, nl))
    dofs = rng.integers(0, n, size=(n_c, nl)).astype(np.int32)
    x = rng.normal(size=n)
    ref = pallas_element_matvec(jnp.asarray(A), jnp.asarray(dofs), n,
                                jnp.asarray(x), block=16, interpret=True)
    got = ops.element_matvec(_t(A), _t(dofs), n, _t(x))
    assert rel_err(got, ref) <= 1e-13


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_element_diag_and_scatter_add(dtype):
    pr = _problem(dtype, seed=1)
    A, pd = pr["A"][:, -NLP:, -NLP:], pr["p_dofs"]
    got = ops.element_diag(_t(A), _t(pd), N_P)
    want = jops.element_diag(jnp.asarray(A), jnp.asarray(pd), N_P)
    assert rel_err(got, want) <= TOL[dtype]
    vals = pr["A"][:, 0, :NLP]
    got = ops.scatter_add(N_P, _t(pd), _t(vals))
    want = jops.scatter_add(N_P, jnp.asarray(pd), jnp.asarray(vals))
    assert rel_err(got, want) <= TOL[dtype]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch path takes CUDA tensors only; it never computes on the
    CPU, and a refused call counts no launch."""
    pr = _problem(np.float64)
    A, pd = _t(pr["A"][:, -NLP:, -NLP:]), _t(pr["p_dofs"])
    before = dict(cuda_ops.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ops.launch("element_matvec", A, A.stride(0), A.stride(1), pd,
                        pd, N_P, _t(pr["x"][:N_P]), NLP, NLP)
    assert cuda_ops.launches == before
