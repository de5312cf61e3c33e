"""The port's dense condensed operators (la/dense.py) against the JAX
package on the coarse leaflet (h = 0.1: 3,820 velocity and 504 pressure
dofs, hanging nodes on both blocks), from the same seeded element blocks.

Tolerances, relative to the reference's max norm: the f64 condensed
matrices 1e-12 (the same sums in another order); the port's dense matrix
against its own constraint-wrapped element matvec 1e-12; the bf16 GEMV
2**-7 (bf16 keeps 8 significant bits, and the two packages round the
product at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.la import dense as jdense
from openifem_tpu_torch.la import dense
from openifem_tpu_torch.la.operators import (element_matvec,
                                             element_matvec_nodeblock)
from torch_parity import leaflet_fsi, rel_err, setup_fsi


@pytest.fixture(scope="module")
def fluids():
    """(JAX fluid, port fluid), set up on the coarse leaflet."""
    jfl = setup_fsi(leaflet_fsi(False)).fluid
    pfl = setup_fsi(leaflet_fsi(True)).fluid
    return jfl, pfl


def _blocks(fl, rng):
    n_c, nu, nlp = fl.mesh.n_cells, fl.nu_loc, fl.nlp
    return dict(A=rng.standard_normal((n_c, nu, nu)),
                B=rng.standard_normal((n_c, nlp, nu)),
                BT=rng.standard_normal((n_c, nu, nlp)),
                Mp=rng.standard_normal((n_c, nlp, nlp)))


def _extra(fl, n, rng, jax):
    """The velocity constraints with extra Dirichlet rows (as FSI adds)."""
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(n, n // 20, replace=False)] = True
    cons = fl.u_constraints
    if jax:
        return cons.with_extra_dirichlet(jnp.asarray(mask), jnp.zeros(n))
    return cons.with_extra_dirichlet(torch.as_tensor(mask),
                                     torch.zeros(n, dtype=torch.float64))


def test_hanging_tables_equal(fluids):
    jfl, pfl = fluids
    for jc, pc in ((jfl.u_constraints, pfl.u_constraints),
                   (jfl.p_constraints, pfl.p_constraints)):
        jt, pt = jdense.hanging_tables(jc), dense.hanging_tables(pc)
        assert jt is not None and pt is not None and len(pt.rows) > 0
        for a, b in zip(pt, jt):
            np.testing.assert_array_equal(a, np.asarray(b))


def _condensed(mod, fl, blk, ucons, to):
    ht = mod.hanging_tables
    uht, pht = ht(fl.u_constraints), ht(fl.p_constraints)
    pc = fl.p_constraints
    cdu, cdp = fl.cell_dofs_u, fl.cell_dofs_p
    nu, np_ = fl.n_u, fl.n_p
    cd = mod.condensed_dense
    return dict(
        A=cd(to(blk["A"]), cdu, cdu, nu, nu, ucons, ucons, uht, uht,
             unit_fixed_diag=True),
        B=cd(to(blk["B"]), cdp, cdu, np_, nu, pc, ucons, pht, uht),
        BT=cd(to(blk["BT"]), cdu, cdp, nu, np_, ucons, pc, uht, pht),
        Mp=cd(to(blk["Mp"]), cdp, cdp, np_, np_, pc, pc, pht, pht,
              unit_fixed_diag=True))


def test_condensed_dense_matches_jax(fluids):
    jfl, pfl = fluids
    rng = np.random.default_rng(7)
    blk = _blocks(pfl, rng)
    jext = _extra(jfl, jfl.n_u, np.random.default_rng(8), True)
    pext = _extra(pfl, pfl.n_u, np.random.default_rng(8), False)
    ref = _condensed(jdense, jfl, blk, jext, jnp.asarray)
    got = _condensed(dense, pfl, blk, pext, torch.as_tensor)
    for k in ref:
        assert rel_err(got[k], ref[k]) <= 1e-12, k
    # M @ x is the constraint-wrapped element matvec of the port
    d, nlu = pfl.dim, pfl.nlu
    x = torch.as_tensor(rng.standard_normal(pfl.n_u))
    Ab = torch.as_tensor(blk["A"]).reshape(-1, nlu, d, nlu, d)
    op = pext.wrap_operator(lambda v: element_matvec_nodeblock(
        Ab, pfl.cell_nodes_u, pfl.n_u // d, v))
    assert rel_err(got["A"] @ x, op(x)) <= 1e-12
    xp = torch.as_tensor(rng.standard_normal(pfl.n_p))
    pc = pfl.p_constraints
    op_p = pc.wrap_operator(lambda v: element_matvec(
        torch.as_tensor(blk["Mp"]), pfl.cell_dofs_p, pfl.n_p, v))
    assert rel_err(got["Mp"] @ xp, op_p(xp)) <= 1e-12


def test_gemv_keeps_types_and_matches_jax():
    rng = np.random.default_rng(9)
    M = rng.standard_normal((300, 200))
    x = rng.standard_normal(200)
    y = dense.gemv(torch.as_tensor(M), torch.as_tensor(x))
    assert y.dtype == torch.float64
    assert rel_err(y, jdense.gemv(jnp.asarray(M), jnp.asarray(x))) <= 1e-14
    Mb = torch.as_tensor(M).to(torch.bfloat16)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    yb = dense.gemv(Mb, x32)
    assert yb.dtype == torch.float32 and Mb.dtype == torch.bfloat16
    ref = jdense.gemv(jnp.asarray(M).astype(jnp.bfloat16),
                      jnp.asarray(x, dtype=jnp.float32))
    assert ref.dtype == jnp.float32
    assert rel_err(yb, np.asarray(ref)) <= 2.0 ** -7


def test_precision_policy_is_set_by_the_package():
    """Importing the port turns TF32 and bf16 reduced-precision reduction
    off, so the GEMVs above compute the same operator on CUDA."""
    from openifem_tpu_torch import config
    mm = torch.backends.cuda.matmul

    def off():
        return not (mm.allow_tf32 or torch.backends.cudnn.allow_tf32
                    or mm.allow_bf16_reduced_precision_reduction)
    assert off()
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = True
    config.full_precision_products()
    assert off()
