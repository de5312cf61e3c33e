"""The stencil kernel's arithmetic on the CPU: la/stencil.py's
`emulate_stencil_apply` (the kernel's tiles, windows and interior test in
plain PyTorch) taken through `StencilOperator.matvec`'s card route against
the plain apply, `plain_matvec`, on the shapes the port builds: 2-D
z-order patches of the Turek cylinder and a merged 2-D super-patch (Q2,
d = 2), the 3-D channel's z-order patches at refinement 0 (Q2, d = 3), the
locally refined leaflet channel's lattice bricks of two levels, and the
coupled Q1 system (k = 1, d + 1 components) whole and as a component
slice.  Relative to the plain result's max norm: f64 within 1e-14, f32
within 1e-6 (the same products summed in another order); border slots
exactly 0 and every slot of the output written; the built stencils zero
wherever the kernel reads nothing (`coupling_mask`).  The CPU route itself is
the plain apply, bit for bit.  Then the card route through an InsIM
preconditioner apply on the cylinder's stencil A-solve, against the CPU
route.
"""

import numpy as np
import pytest
import torch

from openifem_tpu_torch.cases.fsi_leaflet import leaflet_meshes
from openifem_tpu_torch.fe.space import FESpace
from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import stencil as stencil_mod
from openifem_tpu_torch.la.stencil import (PatchGrid, StencilOperator,
                                           coupling_mask,
                                           emulate_stencil_apply)
from openifem_tpu_torch.mesh import generators as gen

TOL = {torch.float64: 1e-14, torch.float32: 1e-6}


def _zorder_super_patch():
    """An axis-aligned 4 x 3 grid refined twice, decomposed as z-order
    patches (the lattice path would take it first), which merge into one
    super-patch."""
    mesh = gen.subdivided_hyper_rectangle([4, 3], [0.0, 0.0], [1.0, 0.75])
    mesh = mesh.refine_global(2)
    return mesh, PatchGrid._build_zorder(mesh)


def _built(mesh):
    return mesh, PatchGrid.build(mesh)


# name -> (mesh and grid, degree, d, component slice or None)
CASES = {
    "cylinder_2d_patches": (
        lambda: _built(gen.flow_around_cylinder(2).refine_global(1)), 2, 2,
        None),
    "super_patch_2d": (_zorder_super_patch, 2, 2, None),
    "cylinder_3d_r0": (lambda: _built(gen.flow_around_cylinder(3)), 2, 3,
                       None),
    "lattice_two_levels": (lambda: _built(leaflet_meshes(gen, 0.1)[0]), 2,
                           2, None),
    "coupled_q1": (lambda: _built(gen.flow_around_cylinder(2)
                                  .refine_global(1)), 1, 3, None),
    "coupled_q1_slice": (lambda: _built(gen.flow_around_cylinder(2)
                                        .refine_global(1)), 1, 3,
                         (slice(0, 2), slice(2, 3))),
}
_BUILT = {}


def _operator(name):
    if name not in _BUILT:
        make, degree, d, _ = CASES[name]
        mesh, grid = make()
        assert grid is not None
        _BUILT[name] = StencilOperator(grid, FESpace(mesh, degree), d=d,
                                       device="cpu")
    return _BUILT[name]


def _weights(st, dtype, rows=None, cols=None, seed=5):
    """Stencil tensors built from random element blocks, and an input:
    (Ws, x) with Ws a component slice where rows / cols are given."""
    rng = np.random.default_rng(seed)
    nl = st.space.cell_dofs.shape[1]
    d = st.d
    Ab = torch.as_tensor(rng.standard_normal(
        (st.space.mesh.n_cells, nl, d, nl, d)), dtype=dtype)
    Ws = st.build_weights(Ab)
    if rows is not None:
        Ws = st.slice_weights(Ws, rows, cols)
    d_in = Ws[0].shape[2]
    x = torch.as_tensor(rng.standard_normal(d_in * st.Np_total),
                        dtype=dtype)
    return Ws, x


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _interior(st):
    """(Np_total,) bool: the slots that are k or more from each face of
    their brick's bordered grid."""
    out = torch.zeros(st.Np_total, dtype=torch.bool)
    for g in st._groups:
        inner = torch.ones(g.Gp, dtype=torch.bool)
        for t in range(st.dim):
            sl = [slice(None)] * st.dim
            sl[t] = slice(0, st.k)
            inner[tuple(sl)] = False
            sl[t] = slice(g.Gp[t] - st.k, None)
            inner[tuple(sl)] = False
        out[g.base:g.base + g.n_b * g.M] = inner.reshape(-1).repeat(g.n_b)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", CASES)
def test_emulated_kernel_matches_plain(name, dtype, monkeypatch):
    st = _operator(name)
    rows_cols = CASES[name][3]
    Ws, x = _weights(st, dtype, *(rows_cols or (None, None)))
    if rows_cols is not None:
        assert not Ws[0].is_contiguous()
    d_out, d_in = Ws[0].shape[1], Ws[0].shape[2]
    if name == "lattice_two_levels":
        assert len(Ws) > 1
    # the kernel reads W only where the coupling mask is set: the built
    # stencil is zero elsewhere, and the mask holds N(k, m) = m (k+1)^2 -
    # (m-1) pairs per axis of m cells
    for g, W in zip(st._groups, Ws):
        mask = coupling_mask(g.Gp, st.k)
        assert (W.permute(0, 4, 1, 2, 3)[~mask] == 0).all()
        assert mask.sum() == np.prod([c * (st.k + 1) ** 2 - (c - 1)
                                      for c in g.m])

    plain = st.plain_matvec(Ws, x)
    # the CPU route is the plain apply
    assert torch.equal(st.matvec(Ws, x), plain)

    # every slot written, borders exactly 0, before the combine
    Y = torch.full((d_out, st.Np_total), float("nan"), dtype=dtype)
    X = x.reshape(d_in, st.Np_total)
    for g, W in zip(st._groups, Ws):
        emulate_stencil_apply(W, X, Y, g.base, g.Gp, st.k)
    assert not Y.isnan().any()
    border = ~_interior(st)
    assert border.any()
    assert (Y[:, border] == 0).all()

    monkeypatch.setattr(stencil_mod, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_ops, "stencil_apply", emulate_stencil_apply)
    got = st.matvec(Ws, x)
    assert torch.equal(got, st.combine(Y.reshape(-1)))
    assert got.dtype == dtype and got.shape == plain.shape
    assert _rel(got, plain) <= TOL[dtype], _rel(got, plain)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][3] is None])
def test_build_weights_into_earlier_tensors(name):
    """build_weights accumulates into a view of W: written into the
    tensors of a build from other blocks, it gives a fresh build's bits,
    and W stays zero where the kernel reads nothing."""
    st = _operator(name)
    rng = np.random.default_rng(7)
    nl = st.space.cell_dofs.shape[1]
    shape = (st.space.mesh.n_cells, nl, st.d, nl, st.d)
    A1, A2 = (torch.as_tensor(rng.standard_normal(shape)) for _ in range(2))
    fresh = st.build_weights(A1)
    earlier = st.build_weights(A2)
    again = st.build_weights(A1, out=earlier)
    for g, W, W2, W3 in zip(st._groups, fresh, earlier, again):
        assert W3.data_ptr() == W2.data_ptr()
        assert torch.equal(W3, W)
        mask = coupling_mask(g.Gp, st.k)
        assert not W.permute(0, 4, 1, 2, 3)[~mask].any()


def test_stencil_args_refused():
    """What the kernel does not take raises before any launch."""
    st = _operator("cylinder_2d_patches")
    Ws, x = _weights(st, torch.float64)
    W, g = Ws[0], st._groups[0]
    X = x.reshape(2, st.Np_total)
    Y = torch.empty_like(X)
    cuda_ops.check_stencil_args(W, X, Y, g.base, g.Gp, st.k)
    with pytest.raises(TypeError):
        cuda_ops.check_stencil_args(W, X.float(), Y.float(), g.base, g.Gp,
                                    st.k)
    strided = torch.zeros(W.shape[:4] + (2 * W.shape[4],),
                          dtype=W.dtype)[..., ::2]
    with pytest.raises(ValueError):          # a plane that is not contiguous
        cuda_ops.check_stencil_args(strided, X, Y, g.base, g.Gp, st.k)
    with pytest.raises(ValueError):          # past the end of x
        cuda_ops.check_stencil_args(W, X, Y, st.Np_total, g.Gp, st.k)
    with pytest.raises(ValueError):          # not a bordered Q_k grid
        cuda_ops.check_stencil_args(W, X, Y, g.base, g.Gp, 3)
    with pytest.raises(ValueError):          # CPU tensors
        cuda_ops.stencil_apply(W, X, Y, g.base, g.Gp, st.k)


@pytest.mark.parametrize("config", ["r3", "r4"])
def test_card_route_insim_stencil_preconditioner(config, monkeypatch):
    """One InsIM preconditioner apply on the cylinder at refinement 1 with
    the bench knobs (the stencil A-solve, f32) through the card's route
    of the stencil apply: within 1e-5 of the CPU route, with the same
    Krylov counts, and the stencil launched."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.cases.fsi_leaflet import port_package
    fl = fc.cylinder_case(port_package(), config, refine=1, n_steps=10,
                          device="cpu")
    fl.run_one_step(True, verbose=False)
    s = fl.present_solution
    g = torch.Generator().manual_seed(4)
    v = torch.randn(s.shape, generator=g, dtype=s.dtype)

    def apply():
        A_loc, _ = fl._assemble(s, s, fl.indicator, fl.fsi_acceleration,
                                fl.fsi_stress_cell, fl.fsi_acc_nodal)
        P = fl._make_preconditioner(A_loc, fl.u_constraints,
                                    fl.p_constraints)
        k0 = dict(fl.krylov_iters)
        return P(v), {k: fl.krylov_iters[k] - k0[k] for k in k0}

    want, counts = apply()
    assert counts["a"] > 0
    launched = []

    def emulate(*args):
        launched.append(args[0].dtype)
        return emulate_stencil_apply(*args)

    monkeypatch.setattr(stencil_mod, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_ops, "stencil_apply", emulate)
    got, counts_card = apply()
    assert launched
    assert counts_card == counts
    assert _rel(got, want) <= 1e-5
