"""la/operators.py::ElementOperator of the port against the JAX package's
(openifem_tpu.la.ElementOperator): matvec and diag on seeded blocks of
the cavity's pressure table (float64, 1e-14 of the reference's max
norm), on a table whose dofs are shared by up to four cells."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openifem_tpu.la as jla
import openifem_tpu_torch.la as tla
from torch_parity import cavity, np_, rel_err


@pytest.fixture(scope="module")
def blocks():
    fl = cavity(True)
    cd = np_(fl.cell_dofs_p)
    rng = np.random.default_rng(7)
    A = rng.normal(size=(cd.shape[0], cd.shape[1], cd.shape[1]))
    x = rng.normal(size=fl.n_p)
    return cd, fl.n_p, A, x


def test_element_operator_matvec_and_diag(blocks):
    cd, n, A, x = blocks
    jop = jla.ElementOperator(cd, n)
    top = tla.ElementOperator(cd, n, device="cpu")
    assert top.cell_dofs.dtype == torch.int32 and top.n_dofs == n
    got = top.matvec(torch.as_tensor(A), torch.as_tensor(x))
    assert rel_err(got, jop.matvec(jnp.asarray(A), jnp.asarray(x))) <= 1e-14
    got = top.diag(torch.as_tensor(A))
    assert rel_err(got, jop.diag(jnp.asarray(A))) <= 1e-14
    # shared dofs: the diagonal sums over the cells of each dof
    assert np.bincount(cd.reshape(-1)).max() == 4
