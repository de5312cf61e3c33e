"""Mesh adaptation in the port against the JAX package (the port on the
CPU, the same seeded inputs and configurations built in code):

- kelly_estimate on a uniform mesh and on the hanging-face mesh of
  tests/test_coarsen.py:159-184, within 1e-12 relative; the JAX function
  runs with its face_values put in the order of its face list
  (torch_parity.fix_jax_kelly_order), since unpatched it pairs faces with
  the wrong neighbours (test_jax_kelly_face_order_defect shows it);
- refine_fraction_flags and coarsen_fraction_flags equal;
- transfer_nodal_field within 1e-12, with every point found, and its
  refusal of a point outside the old mesh; on the disc, whose refined
  boundary cells put points on the circle outside the old cells, every
  point the JAX package locates within 1e-12 of its transfer and each
  of the others at its parent cell's clamped value (the JAX package
  gives them 0);
- a fluid refine_mesh on the cavity: equal meshes, the transferred
  solution within 1e-12, then 2 steps within 1e-6 with equal Newton
  counts; a solid refine_mesh;
  (test_torch_amr_fsi.py has the interface refinement.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu.fe import kelly as jax_kelly
from openifem_tpu.fe import transfer as jax_transfer
from openifem_tpu.fe.space import FESpace as JaxFESpace
from openifem_tpu_torch.fe import kelly, transfer
from openifem_tpu_torch.fe.space import FESpace
from torch_parity import JAX, PORT, cavity, fix_jax_kelly_order, rel_err


def same_mesh(a, b):
    return (np.array_equal(np.asarray(a.cells), np.asarray(b.cells))
            and np.array_equal(np.asarray(a.level), np.asarray(b.level))
            and np.allclose(np.asarray(a.vertices), np.asarray(b.vertices),
                            rtol=0, atol=1e-14))


def meshes(kind):
    """The same mesh in both packages: 'uniform' (4 x 3 cells) or
    'hanging' (tests/test_coarsen.py:159-184, then one more cell
    refined)."""
    out = []
    for pkg in (JAX, PORT):
        if kind == "uniform":
            m = pkg.generators.subdivided_hyper_rectangle([4, 3], [0.0, 0.0],
                                                          [1.0, 0.75])
        else:
            m = pkg.generators.subdivided_hyper_rectangle([1, 2], [0.0, 0.0],
                                                          [1.0, 2.0])
            m = m.refine(np.array([False, True]))
            m = m.refine(np.arange(m.n_cells) == 3)
        out.append(m)
    return out


@pytest.mark.parametrize("kind", ["uniform", "hanging"])
@pytest.mark.parametrize("degree,n_comp", [(1, 1), (2, 2)])
def test_kelly_estimate(kind, degree, n_comp, monkeypatch):
    fix_jax_kelly_order(monkeypatch)
    jm, pm = meshes(kind)
    js, ps = JaxFESpace(jm, degree), FESpace(pm, degree)
    pts = ps.node_points
    rng = np.random.default_rng(8)
    # a smooth field plus seeded noise, node-major with n_comp components
    field = np.stack([np.sin(3 * pts[:, 0] + c) * pts[:, 1] ** 2
                      for c in range(n_comp)], axis=1)
    field = (field + 0.01 * rng.normal(size=field.shape)).reshape(-1)
    want = jax_kelly.kelly_estimate(js, field, n_components=n_comp)
    got = kelly.kelly_estimate(ps, torch.as_tensor(field),
                               n_components=n_comp)
    assert want.max() > 0
    assert rel_err(got, want) <= 1e-12
    if kind == "hanging":
        # the coarse bottom cell's only interior faces are hanging
        assert got[0] > 1e-8


def test_jax_kelly_face_order_defect():
    """x^2 on a symmetric 3 x 3 mesh: the indicators must not depend on
    y.  The port's are symmetric; the unpatched JAX function's are not."""
    out = []
    for pkg, space, est in ((JAX, JaxFESpace, jax_kelly.kelly_estimate),
                            (PORT, FESpace, kelly.kelly_estimate)):
        mesh = pkg.generators.subdivided_hyper_rectangle([3, 3], [0.0, 0.0],
                                                         [1.0, 1.0])
        sp = space(mesh, 1)
        out.append(np.asarray(est(sp, sp.node_points[:, 0] ** 2)))
    jax_eta, port_eta = (e.reshape(3, 3) for e in out)
    assert np.allclose(port_eta, port_eta[0][None, :], rtol=1e-12)
    assert not np.allclose(jax_eta, jax_eta[0][None, :], rtol=1e-3)


def test_fraction_flags():
    rng = np.random.default_rng(3)
    eta = rng.random(200) ** 3
    eta[::17] = eta[5]          # ties
    for frac in (0.2, 0.6, 0.9):
        assert np.array_equal(kelly.refine_fraction_flags(eta, frac),
                              jax_kelly.refine_fraction_flags(eta, frac))
        assert np.array_equal(kelly.coarsen_fraction_flags(eta, frac),
                              jax_kelly.coarsen_fraction_flags(eta, frac))
    zero = np.zeros(5)
    assert not kelly.refine_fraction_flags(zero).any()
    assert not kelly.coarsen_fraction_flags(zero).any()


def test_transfer_nodal_field():
    jm, pm = meshes("hanging")
    flags = np.zeros(pm.n_cells, dtype=bool)
    flags[[0, 2]] = True
    new = [m.refine(flags) for m in (jm, pm)]
    js, ps = JaxFESpace(jm, 2), FESpace(pm, 2)
    rng = np.random.default_rng(4)
    c = rng.normal(size=(2, 6))

    def poly(x):
        """A seeded quadratic per component: a Q2 field, so the transfer
        to the refined mesh is exact."""
        basis = np.stack([np.ones(len(x)), x[:, 0], x[:, 1], x[:, 0] ** 2,
                          x[:, 0] * x[:, 1], x[:, 1] ** 2], axis=1)
        return basis @ c.T
    field = poly(ps.node_points)
    pts = FESpace(new[1], 2).node_points
    want = jax_transfer.transfer_nodal_field(jm, js, jnp.asarray(field),
                                             FESpace(new[0], 2).node_points)
    got = transfer.transfer_nodal_field(pm, ps, torch.as_tensor(field), pts)
    assert got.shape == (len(pts), 2)
    assert rel_err(got, want) <= 1e-12
    assert rel_err(got, poly(pts)) <= 1e-12
    with pytest.raises(RuntimeError, match="lie in no cell of the old mesh"
                                           ", nor near one"):
        transfer.transfer_nodal_field(pm, ps, torch.as_tensor(field),
                                      np.array([[2.0, 5.0]]))


def unit_coords(p, v, n_iter=20):
    """Unit coordinates of point p in the bilinear cell with z-order
    corners v (4, 2), by Newton in numpy."""
    xi = np.full(2, 0.5)
    for _ in range(n_iter):
        a, b = xi
        x = (v[0] * (1 - a) * (1 - b) + v[1] * a * (1 - b)
             + v[2] * (1 - a) * b + v[3] * a * b)
        J = np.stack([(v[1] - v[0]) * (1 - b) + (v[3] - v[2]) * b,
                      (v[2] - v[0]) * (1 - a) + (v[3] - v[1]) * a], axis=1)
        xi = xi - np.linalg.solve(J, x - p)
    return xi


def test_transfer_curved_boundary():
    """Refining the boundary cells of the disc (a circular boundary
    manifold) puts new support points on the circle, outside the old
    cells' straight boundary edges.  Every point the JAX package locates
    transfers as there, within 1e-12.  Each of the others (the JAX
    package gives them 0) takes its parent's value: the old cell whose
    boundary arc holds the point, evaluated at the point's unit
    coordinates in that cell (Newton in numpy here) clamped to the unit
    square."""
    from openifem_tpu.fsi import interp as jax_interp
    from openifem_tpu.mesh import generators as jax_gen
    from openifem_tpu_torch.fsi.interp import interpolate_nodal
    from openifem_tpu_torch.mesh import generators as gen
    from openifem_tpu_torch.mesh.mesh import FACE_VERTICES
    jm, pm = (g.sphere([0.0, 0.0], 1.0, 2).refine_global(1)
              for g in (jax_gen, gen))
    faces = pm.boundary_faces()
    flags = np.zeros(pm.n_cells, dtype=bool)
    flags[[c for c, _ in faces]] = True
    new = [m.refine(flags) for m in (jm, pm)]
    assert same_mesh(*new)
    ps = FESpace(pm, 2)
    W = np.random.default_rng(6).normal(size=(2, 2))
    field = np.sin(ps.node_points @ W)
    pts = FESpace(new[1], 2).node_points
    got = transfer.transfer_nodal_field(pm, ps, torch.as_tensor(field),
                                        pts).numpy()
    want = np.asarray(jax_transfer.transfer_nodal_field(
        jm, JaxFESpace(jm, 2), jnp.asarray(field), pts))
    verts = jm.vertices[jm.cells]
    dims, span, K = jax_interp.plan_cell_hash(verts, tol=1e-9)
    build, locate = jax_interp.make_cell_hash(jm.n_cells, dims, span, K,
                                              tol=1e-9)
    found = np.asarray(locate(build(jnp.asarray(verts)),
                              jnp.asarray(pts))[2])
    missing = np.nonzero(~found)[0]
    assert len(missing) > 0
    assert rel_err(got[found], want[found]) <= 1e-12
    assert np.abs(want[missing]).max() == 0.0     # the JAX package's 0
    # each missing point's parent: the old boundary face whose arc (the
    # angles of its two vertices) holds the point's angle
    ends = np.array([pm.vertices[pm.cells[c][FACE_VERTICES[2][f]]]
                     for c, f in faces])                       # (nf, 2, 2)
    a0, a1 = (np.arctan2(ends[:, k, 1], ends[:, k, 0]) for k in (0, 1))
    span_ = np.angle(np.exp(1j * (a1 - a0)))
    idx, unit = [], []
    for p in pts[missing]:
        off = np.angle(np.exp(1j * (np.arctan2(p[1], p[0]) - a0)))
        inside = (off * span_ >= 0) & (np.abs(off) <= np.abs(span_))
        assert inside.sum() == 1
        c = faces[int(np.argmax(inside))][0]
        idx.append(c)
        unit.append(np.clip(unit_coords(p, pm.vertices[pm.cells[c]]),
                            0.0, 1.0))
    expect = interpolate_nodal(
        torch.as_tensor(field), torch.as_tensor(ps.cell_dofs),
        torch.as_tensor(idx), torch.as_tensor(np.array(unit)), 2).numpy()
    assert rel_err(got[missing], expect) <= 1e-12
    # against the field itself: off by at most its slope times the
    # bulge of the arc over the old edge (the Q2 error is far below it)
    bulge = 1.0 - np.cos(np.abs(span_).max() / 2)
    err = np.abs(got[missing] - np.sin(pts[missing] @ W)).max()
    assert err <= np.linalg.norm(W, 2) * bulge


def test_fluid_refine_mesh(monkeypatch):
    """Kelly AMR on the cavity after 2 steps, then 2 more steps."""
    fix_jax_kelly_order(monkeypatch)
    solvers = []
    for port in (False, True):
        fl = cavity(port)
        fl.run_one_step(True, verbose=False)
        fl.run_one_step(False, verbose=False)
        n0 = fl.mesh.n_cells
        fl.refine_mesh(1, 3)
        solvers.append((fl, n0))
    (jf, n0), (pf, _) = solvers
    assert pf.mesh.n_cells != n0 and (pf.mesh.level == 3).any()
    assert same_mesh(pf.mesh, jf.mesh)
    assert rel_err(pf.present_solution, jf.present_solution) <= 1e-12
    assert rel_err(pf.stress_device, jf.stress_device) <= 1e-12
    counts = []
    for fl in (jf, pf):
        its = []
        for _ in range(2):
            fl.run_one_step(False, verbose=False)
            its.append(int(fl.newton_iters))
        counts.append(its)
    assert counts[0] == counts[1]
    assert rel_err(pf.present_solution, jf.present_solution) <= 1e-6


def test_solid_refine_mesh(monkeypatch):
    """Kelly AMR of a standalone LinearElasticity beam under gravity
    after 2 steps: equal meshes, transferred d / v / a within 1e-12."""
    fix_jax_kelly_order(monkeypatch)
    out = []
    for pkg in (JAX, PORT):
        p = pkg.AllParameters(
            simulation_type="Solid", dimension=2, global_refinements=[0, 1],
            end_time=0.04, time_step=0.01, output_interval=1e9,
            refinement_interval=1e9, save_interval=1e9,
            gravity=[0.0, -1.0], solid_degree=1, solid_type="LinearElastic",
            solid_rho=1.0, E=[1e3], nu=[0.3], n_solid_dirichlet_bcs=1,
            solid_dirichlet_bcs={0: 3})
        kw = dict(device="cpu") if pkg is PORT else {}
        s = pkg.LinearElasticity(pkg.generators.subdivided_hyper_rectangle(
            [4, 1], [0.0, 0.0], [1.0, 0.25]), p, **kw)
        s.mesh = s.mesh.refine_global(1)
        s.setup()
        s.run_one_step(True)
        s.run_one_step(False)
        s.refine_mesh(1, 3)
        out.append(s)
    js, ps = out
    assert ps.mesh.n_cells > 16 and same_mesh(ps.mesh, js.mesh)
    for name in ("current_displacement", "current_velocity",
                 "current_acceleration", "previous_displacement"):
        assert rel_err(getattr(ps, name), getattr(js, name)) <= 1e-12
