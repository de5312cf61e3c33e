"""The port's FSI coupling kernels (fsi/interp.py, FSI._FSIKernels) against
the JAX package on the coarse leaflet: located cell indices are equal,
unit coordinates agree to 1e-12, and the indicator, the Dirichlet masks
and values and the traction match for a deformed solid.  Also the batched
invert_bilinear (2-D and 3-D), the all-pairs locate_points (equal cells,
and the same answer as the cell hash) and sph_interpolate, within 1e-12
of the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.fsi import interp as jinterp
from openifem_tpu_torch.fsi import interp
from torch_parity import leaflet_fsi, rel_err, setup_fsi


@pytest.fixture(scope="module")
def pair():
    return setup_fsi(leaflet_fsi(False)), setup_fsi(leaflet_fsi(True))


@pytest.mark.parametrize("degree", [1, 2])
def test_shape_values(degree):
    pts = np.random.default_rng(0).random((50, 2))
    want = jinterp.shape_values_jax(degree, 2, jnp.asarray(pts))
    got = interp.shape_values(degree, 2, torch.from_numpy(pts))
    assert rel_err(got, want) <= 1e-15


def test_invert_bilinear_cw():
    rng = np.random.default_rng(1)
    n = 64
    verts = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], float)[None] + \
        0.2 * rng.normal(size=(n, 4, 2))
    xi = rng.random((n, 2))
    N = np.stack([(1 - xi[:, 0]) * (1 - xi[:, 1]), xi[:, 0] * (1 - xi[:, 1]),
                  (1 - xi[:, 0]) * xi[:, 1], xi[:, 0] * xi[:, 1]], -1)
    pts = np.einsum("nv,nvd->nd", N, verts)
    px = [pts[:, a] for a in range(2)]
    vx = [[verts[:, v, a] for a in range(2)] for v in range(4)]
    want = jinterp.invert_bilinear_cw([jnp.asarray(p) for p in px],
                                      [[jnp.asarray(c) for c in v]
                                       for v in vx])
    got = interp.invert_bilinear_cw([torch.from_numpy(p) for p in px],
                                    [[torch.from_numpy(c) for c in v]
                                     for v in vx])
    for g, w, x in zip(got, want, xi.T):
        assert rel_err(g, w) <= 1e-12
        assert np.abs(g.numpy() - x).max() <= 1e-10


def test_fluid_locate(pair):
    jfsi, pfsi = pair
    rng = np.random.default_rng(2)
    # inside, on cell faces (grid-aligned) and outside the channel
    pts = np.concatenate([rng.random((300, 2)) * [4.0, 1.0],
                          np.round(rng.random((40, 2)) * [40, 10]) / 10,
                          [[-0.5, 0.5], [4.5, 0.5]]])
    ji, ju, jf = jfsi._fluid_locate(jfsi._fluid_hash_state, jnp.asarray(pts))
    pi, pu, pf = pfsi._fluid_locate(pfsi._fluid_hash_state,
                                    torch.from_numpy(pts))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert pf.numpy()[:-2].all() and not pf.numpy()[-2:].any()
    assert rel_err(pu, ju) <= 1e-12


def _moved(fsi, amp, port):
    """The leaflet's vertices bent downstream by amp * (y / b)^2."""
    ref = np.asarray(fsi.solid.mesh.vertices)
    disp = np.zeros_like(ref)
    disp[:, 0] = amp * (ref[:, 1] / 0.4) ** 2
    moved = ref + disp
    return torch.from_numpy(moved) if port else jnp.asarray(moved)


@pytest.mark.parametrize("amp", [0.0, 0.03])
def test_indicator_dirichlet_and_traction(pair, amp):
    jfsi, pfsi = pair
    jk, pk = jfsi._kernels, pfsi._kernels
    jm, pm = _moved(jfsi, amp, False), _moved(pfsi, amp, True)
    jind, pind = jk.indicator(jm), pk.indicator(pm)
    np.testing.assert_array_equal(pind.numpy(), np.asarray(jind))
    assert pind.sum() > 0

    rng = np.random.default_rng(3)
    vel = rng.normal(size=jfsi.solid.n_dofs)
    jmask, jvals = jk.dirichlet_bc(jm, jnp.asarray(vel))
    pmask, pvals = pk.dirichlet_bc(pm, torch.from_numpy(vel))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    assert pmask.any()
    assert rel_err(pvals, jvals) <= 1e-12

    acc = rng.normal(size=jfsi.solid.n_dofs)
    ja = jk.fsi_acceleration(jm, jnp.asarray(acc), jind.astype(float))
    pa = pk.fsi_acceleration(pm, torch.from_numpy(acc), pind.double())
    assert rel_err(pa, ja) <= 1e-12

    sol = rng.normal(size=jfsi.fluid.n_dofs)
    stress = rng.normal(size=(jfsi.fluid.u_space.n_nodes, 2, 2))
    jt = jk.solid_traction(jm, jnp.asarray(sol), jnp.asarray(stress))
    pt = pk.solid_traction(pm, torch.from_numpy(sol),
                           torch.from_numpy(stress))
    assert rel_err(pt, jt) <= 1e-12


def test_hash_capacity_check_raises_on_overstretch(pair):
    _, pfsi = pair
    ref = torch.from_numpy(np.asarray(pfsi.solid.mesh.vertices))
    pfsi._check_solid_hash_capacity(ref)
    # one vertex pulled far away: the bins grow, and one bin then holds
    # more cells than the plan's K
    stretched = ref.clone()
    stretched[-1] += 100.0
    with pytest.raises(RuntimeError, match="cell hash overflow"):
        pfsi._check_solid_hash_capacity(stretched)


def _distorted_cells(rng, n, dim):
    """n unit cells in z-order with their corners moved by 0.15 sigma,
    and points at known unit coordinates inside them."""
    corners = np.array([[(v >> a) & 1 for a in range(dim)]
                        for v in range(2 ** dim)], float)
    verts = corners[None] + 0.15 * rng.normal(size=(n, 2 ** dim, dim))
    xi = rng.random((n, dim))
    f = [[1 - xi[:, a], xi[:, a]] for a in range(dim)]
    N = np.stack([np.prod([f[a][int(c[a])] for a in range(dim)], axis=0)
                  for c in corners], -1)
    return verts, xi, np.einsum("nv,nvd->nd", N, verts)


@pytest.mark.parametrize("dim", [2, 3])
def test_invert_bilinear(dim):
    rng = np.random.default_rng(10 + dim)
    verts, xi, pts = _distorted_cells(rng, 40, dim)
    want = jinterp.invert_bilinear(jnp.asarray(pts), jnp.asarray(verts))
    got = interp.invert_bilinear(torch.from_numpy(pts),
                                 torch.from_numpy(verts))
    assert rel_err(got, want) <= 1e-12
    assert np.abs(got.numpy() - xi).max() <= 1e-10
    # broadcast batches: every point against every cell.  Six Newton
    # steps leave far (point, cell) pairs unconverged, where Cramer's rule
    # and the explicit inverse round apart: 1e-12 near the cell, 1e-10
    # over all pairs
    want = np.asarray(jinterp.invert_bilinear(
        jnp.asarray(pts)[:, None].repeat(40, axis=1),
        jnp.asarray(verts)[None].repeat(40, axis=0)))
    got = interp.invert_bilinear(torch.from_numpy(pts)[:, None],
                                 torch.from_numpy(verts)[None]).numpy()
    assert got.shape == (40, 40, dim) and rel_err(got, want) <= 1e-10
    near = ((want > -0.5) & (want < 1.5)).all(axis=-1)
    assert near.sum() > 40 and rel_err(got[near], want[near]) <= 1e-12


def test_locate_points(pair):
    """All-pairs location on the coarse leaflet's fluid mesh: the JAX
    package's cells and unit coordinates, and the cell hash's."""
    jfsi, pfsi = pair
    mesh = pfsi.fluid.mesh
    cv = mesh.vertices[mesh.cells]
    lo, hi = cv.min(axis=1), cv.max(axis=1)
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.random((200, 2)) * [4.0, 1.0],
                          np.round(rng.random((30, 2)) * [40, 10]) / 10,
                          [[-0.5, 0.5], [4.5, 0.5]]])
    ji, ju, jf = jinterp.locate_points(*map(jnp.asarray, (pts, cv, lo, hi)))
    pi, pu, pf = interp.locate_points(*map(torch.from_numpy,
                                           (pts, cv, lo, hi)))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert pf.numpy()[:-2].all() and not pf.numpy()[-2:].any()
    assert rel_err(pu, ju) <= 1e-12
    hi_, hu, hf = pfsi._fluid_locate(pfsi._fluid_hash_state,
                                     torch.from_numpy(pts))
    np.testing.assert_array_equal(hi_.numpy(), pi.numpy())
    assert np.abs(hu.numpy() - pu.numpy()).max() <= 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_sph_interpolate(dim):
    rng = np.random.default_rng(20 + dim)
    centers = rng.random((60, dim))
    diam = 0.1 + 0.2 * rng.random(60)
    values = rng.normal(size=(60, dim))
    # the last target lies beyond every kernel's support
    targets = np.concatenate([rng.random((30, dim)), [[9.0] * dim]])
    want = jinterp.sph_interpolate(*map(jnp.asarray,
                                        (targets, centers, diam, values)))
    got = interp.sph_interpolate(*map(torch.from_numpy,
                                      (targets, centers, diam, values)))
    assert rel_err(got, want) <= 1e-12
    assert np.abs(got.numpy()[-1]).max() == 0 and \
        np.abs(got.numpy()[:-1]).max() > 0
