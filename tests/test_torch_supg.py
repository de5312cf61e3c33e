"""The SUPG/PSPG/LSIC fluid family of the port (solvers/fluid/supg.py)
against the JAX package: the host part and the three assemblies.

Both packages build the same small channel in code (torch_parity.py:
6 x 4 cells of a 2 x 0.4 channel, refined once left of x = 0.7, so the
constraint sets hold hanging nodes; a body force, a PML field, a Neumann
pressure on the inlet and a moving top wall) and get the same seeded
state, all float64 on the CPU.

Tolerances, relative to the reference's max norm:
- Constraints.apply_increment_with / distribute_with_values: exact;
- _stab_parameters at zero, small and large velocity: 1e-13;
- the layout maps of the coupled stencil: exact;
- the kernel's index arithmetic (cuda_ops.emulate behind the layouts' CUDA
  branch) at the family's block shapes, 12 x 12, 8 x 4, 4 x 8 and 4 x 4,
  read in place from one (cells, 12, 12) table: 1e-12 against the plain
  versions;
- _assemble of SUPGInsIM, SCnsIM and SerialSCnsIM (nonzero indicator,
  nodal FSI fields, PML, body force, eddy viscosity): A_loc and rhs 1e-12;
  with f32_matrix A_loc 1e-5 and the rhs, which stays f64, 1e-12.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openifem_tpu_torch.cases import acoustic_duct as ad
from openifem_tpu_torch.cases import fluid_cylinder as fc
from torch_parity import (JAX, PORT, SUPG_SOLVERS, np_, rel_err, supg_args,
                          supg_seed_state, supg_solver)


@pytest.fixture(scope="module")
def scnsim_pair():
    jfl, pfl = supg_solver(False), supg_solver(True)
    eddy = supg_seed_state(jfl, pfl)
    return jfl, pfl, eddy


def test_constraint_increment_and_distribute_with_values(scnsim_pair):
    jfl, pfl, _ = scnsim_pair
    jc, pc = jfl.nonzero_constraints, pfl.nonzero_constraints
    assert pc.any_hanging and jc.any_hanging
    rng = np.random.default_rng(3)
    x, vals = rng.normal(size=(2, pfl.n_dofs))
    for name in ("apply_increment_with", "distribute_with_values"):
        got = getattr(pc, name)(torch.as_tensor(x), torch.as_tensor(vals))
        ref = getattr(jc, name)(jnp.asarray(x), jnp.asarray(vals))
        np.testing.assert_array_equal(np_(got), np.asarray(ref), name)
    # with the constraint set's own values they are the plain methods
    np.testing.assert_array_equal(
        np_(pc.apply_increment_with(torch.as_tensor(x),
                                    pc.dirichlet_values)),
        np_(pc.apply_increment(torch.as_tensor(x))))
    np.testing.assert_array_equal(
        np_(pc.distribute_with_values(torch.as_tensor(x),
                                      pc.dirichlet_values)),
        np_(pc.distribute(torch.as_tensor(x))))
    # f32 input stays f32 (the mixed-precision paths)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    assert pc.apply_increment_with(x32, x32).dtype == torch.float32


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1.0, 1e4])
def test_stab_parameters(scnsim_pair, scale):
    jfl, pfl, _ = scnsim_pair
    assert pfl._h_terms == jfl._h_terms
    rng = np.random.default_rng(4)
    n_c, n_q = pfl.JxW.shape
    un = scale * rng.normal(size=(n_c, n_q, 2))
    un[0] = 0.0          # a cell at rest beside moving ones
    visc = 0.5 + rng.random((n_c, n_q))
    rho = 1.0 + rng.random((n_c, n_q))
    got = pfl._stab_parameters(*map(torch.as_tensor, (un, visc, rho)))
    ref = jfl._stab_parameters(*map(jnp.asarray, (un, visc, rho)))
    dt = pfl.time.get_delta_t()
    for g, r, name in zip(got, ref, ("supg", "pspg", "lsic")):
        assert torch.isfinite(g).all(), name
        assert rel_err(g, r) <= 1e-13, name
    # zero velocity: tau_supg = dt / 2 and no LSIC, not NaN
    assert torch.all(got[0][0] == dt / 2) and torch.all(got[2][0] == 0)


def test_coupled_stencil_layout_maps(scnsim_pair):
    jfl, pfl, _ = scnsim_pair
    assert pfl._sys_stencil is not None and jfl._sys_stencil is not None
    rng = np.random.default_rng(6)
    x = rng.normal(size=pfl.n_dofs)
    nodal = pfl._sys_to_nodal(torch.as_tensor(x))
    np.testing.assert_array_equal(
        np_(nodal), np.asarray(jfl._sys_to_nodal(jnp.asarray(x))))
    np.testing.assert_array_equal(np_(pfl._nodal_to_sys(nodal)), x)
    nl = pfl.nu_loc + pfl.nlp
    A = rng.normal(size=(pfl.mesh.n_cells, nl, nl))
    np.testing.assert_array_equal(
        np_(pfl._sys_node_blocks(torch.as_tensor(A))),
        np.asarray(jfl._sys_node_blocks(jnp.asarray(A))))


@pytest.mark.parametrize("f32_matrix", [False, True])
@pytest.mark.parametrize("solver", SUPG_SOLVERS)
def test_assemble(solver, f32_matrix):
    jfl = supg_solver(False, solver, f32_matrix=f32_matrix)
    pfl = supg_solver(True, solver, f32_matrix=f32_matrix)
    eddy = supg_seed_state(jfl, pfl)
    assert float(pfl.indicator.sum()) > 0
    assert float(pfl.sigma_pml_q.abs().max()) > 0
    assert float(pfl._neumann_rhs_const.abs().max()) > 0
    rng = np.random.default_rng(8)
    eval_pt = np_(pfl.present_solution) + 0.05 * rng.normal(size=pfl.n_dofs)
    jA, jr = jfl._assemble(*supg_args(jfl, eval_pt, eddy, False))
    pA, pr = pfl._assemble(*supg_args(pfl, eval_pt, eddy, True))
    assert pr.dtype == torch.float64
    assert rel_err(pr, jr) <= 1e-12
    if f32_matrix and solver != "SUPGInsIM":
        # (SUPGInsIM assembles in f64 and casts at the apply)
        assert pA.dtype == torch.float32 and jA.dtype == jnp.float32
        assert rel_err(pA, jA) <= 1e-5
    else:
        assert pA.dtype == torch.float64
        assert rel_err(pA, jA) <= 1e-12


class _OnCard(torch.Tensor):
    """A CPU tensor that the layouts' dispatch takes for a CUDA one, so
    that their kernel branch (with cuda_ops.launch replaced by
    cuda_ops.emulate) runs here."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("which,block", [
    ("taylor_hood", (12, 12)), ("p_to_u", (8, 4)), ("u_to_p", (4, 8)),
    ("App", (4, 4)), ("rect_Avp", (8, 4)), ("rect_Apv", (4, 8))])
def test_kernel_indexing_on_supg_tables(scnsim_pair, monkeypatch, which,
                                        block):
    """The applies of the outer operator and of the Tpp pieces through the
    layouts' CUDA branch, on the solver's own tables and on the strided
    views of the system table that _make_preconditioner passes."""
    from openifem_tpu_torch.la import cuda_ops
    from openifem_tpu_torch.la import operators as ops
    _, pfl, _ = scnsim_pair
    rng = np.random.default_rng(9)
    n_c, nu, d = pfl.mesh.n_cells, pfl.nu_loc, pfl.dim
    A = torch.as_tensor(rng.normal(size=(n_c, nu + pfl.nlp, nu + pfl.nlp)))
    x = torch.as_tensor(rng.normal(size=pfl.n_dofs))
    xu, xp = x[:pfl.n_u].contiguous(), x[pfl.n_u:].contiguous()
    cn_u, cd_u, cd_p = pfl.cell_nodes_u, pfl.cell_dofs_u, pfl.cell_dofs_p
    Avp, Apv = A[:, :nu, nu:], A[:, nu:, :nu]
    calls = {
        "taylor_hood": (
            lambda *a: ops.element_matvec_taylor_hood(
                *a, cell_dofs=pfl.cell_dofs),
            ops.element_matvec_taylor_hood_plain,
            (A, cn_u, cd_p, pfl.nlu, d, pfl.n_u, pfl.n_p, x)),
        "p_to_u": (ops.element_matvec_p_to_u_nodeblock,
                   ops.element_matvec_p_to_u_nodeblock_plain,
                   (Avp.reshape(n_c, pfl.nlu, d, pfl.nlp), cn_u, cd_p,
                    pfl.n_u // d, xp)),
        "u_to_p": (ops.element_matvec_u_to_p_nodeblock,
                   ops.element_matvec_u_to_p_nodeblock_plain,
                   (Apv.reshape(n_c, pfl.nlp, pfl.nlu, d), cn_u, cd_p,
                    pfl.n_p, xu)),
        "App": (ops.element_matvec, ops.element_matvec_plain,
                (A[:, nu:, nu:], cd_p, pfl.n_p, xp)),
        "rect_Avp": (ops.element_matvec_rect, ops.element_matvec_rect_plain,
                     (Avp, cd_u, cd_p, pfl.n_u, xp)),
        "rect_Apv": (ops.element_matvec_rect, ops.element_matvec_rect_plain,
                     (Apv, cd_p, cd_u, pfl.n_p, xu)),
    }
    entry, plain, args = calls[which]
    want = plain(*args)
    seen = []

    def emulate(layout, A_, cs, rs, rows, cols, n_out, x_, nr, nc, *dd):
        seen.append((nr, nc))
        return cuda_ops.emulate(layout, A_, cs, rs, rows, cols, n_out, x_,
                                nr, nc, *dd)
    monkeypatch.setattr(cuda_ops, "launch", emulate)
    on_card = tuple(a.as_subclass(_OnCard) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() and a.dim() == 1 else a
                    for a in args)
    got = entry(*on_card).as_subclass(torch.Tensor)
    assert seen == [block]
    assert got.shape == want.shape and rel_err(got, want) <= 1e-12


def test_neumann_rhs_and_tables_match(scnsim_pair):
    jfl, pfl, _ = scnsim_pair
    assert rel_err(pfl._neumann_rhs_const, jfl._neumann_rhs_const) == 0
    assert rel_err(pfl.sigma_pml_q, jfl.sigma_pml_q) == 0
    assert rel_err(pfl.gravity_q, jfl.gravity_q) == 0
    for name in ("cell_dofs", "cell_dofs_u", "cell_dofs_p", "cell_nodes_u"):
        np.testing.assert_array_equal(np_(getattr(pfl, name)),
                                      np.asarray(getattr(jfl, name)), name)


def test_turbulence_raises_and_names_the_roadmap(scnsim_pair, tmp_path,
                                                 monkeypatch):
    """The stepper takes a Spalart-Allmaras model (its signature gains
    nu~ and the SA residual); with a model attached, the fluid's
    checkpoint carries the model's state under the JAX package's keys (it
    used to raise naming ROADMAP.md queue 1 item 5; the hooks themselves:
    test_torch_turbulence.py, the restart: test_torch_checkpoint.py)."""
    from openifem_tpu_torch.solvers.turbulence import SpalartAllmaras
    monkeypatch.chdir(tmp_path)
    _, pfl, _ = scnsim_pair
    model = SpalartAllmaras(pfl)
    try:
        model.setup()
        stepper = pfl.make_on_device_stepper(turbulence=model)
        assert list(inspect.signature(stepper).parameters) == [
            "present", "stress_nodal", "nu", "n_steps", "start"]
        pfl.turbulence_model = model
        pfl.save_checkpoint(step=7)
        with np.load("fluid-000007.checkpoint.npz") as data:
            np.testing.assert_array_equal(data["sa_nu_tilde"],
                                          np_(model.present_solution))
            assert data["present_solution"].shape == (pfl.n_dofs,)
    finally:
        pfl.__dict__.pop("turbulence_model", None)
        pfl.__dict__.pop("eddy_viscosity_nodal", None)


@pytest.mark.parametrize("galerkin", [True, False])
def test_enable_pressure_mg(galerkin):
    from openifem_tpu_torch.la.multigrid import GalerkinMG
    meshes = fc.cylinder_hierarchy(PORT.generators, 1)
    p = PORT.AllParameters(**fc.scnsim_fields(1, 2))
    fl = PORT.SCnsIM(meshes[-1], p, device="cpu")
    fl.setup()
    assert fl.tpp_M_branch() == "diag"
    fl.enable_pressure_mg(meshes, galerkin=galerkin)
    assert isinstance(fl._pressure_mg, GalerkinMG) == galerkin
    assert fl.tpp_M_branch() == ("galerkin" if galerkin else "vcycle")
    fl.setup()      # a new setup drops the cycle built on the old tables
    assert fl._pressure_mg is None


def test_scnsim_cylinder_case_builds_for_both_packages():
    jfl = fc.scnsim_case(JAX, refine=1, n_steps=2)
    pfl = fc.scnsim_case(PORT, refine=1, n_steps=2, device="cpu")
    assert pfl.n_dofs == jfl.n_dofs == 1284
    assert pfl.mesh.n_cells == 368
    assert pfl.params == PORT.AllParameters(**fc.scnsim_fields(1, 2))
    assert pfl.mixed_precision_precond and not pfl.f32_matrix
    assert jfl.mixed_precision_precond and not jfl.f32_matrix
    # z-order patches carry the coupled stencil; the V-cycle is Galerkin
    assert (pfl.outer_branch(), pfl.tpp_branch(), pfl.tpp_M_branch()) == \
        ("stencil", "stencil", "galerkin")
    assert jfl._sys_stencil is not None
    # the BC clock stands where run() puts it before the first step: the
    # inflow increment is there now and gone one step later
    assert pfl.bc_time == jfl.bc_time == fc.TIME_STEP
    inlet = float(pfl.nonzero_constraints.dirichlet_values.max())
    assert abs(inlet - fc.SCNSIM_UMAX) < 0.02 * fc.SCNSIM_UMAX
    assert rel_err(pfl.nonzero_constraints.dirichlet_values,
                   jfl.nonzero_constraints.dirichlet_values) == 0
    table = pfl.bc_value_table(3)
    assert tuple(table.shape) == (3, pfl.n_dofs)
    assert float(table[0].max()) == inlet and float(table[1:].abs().max()) == 0
    assert rel_err(table, jfl.bc_value_table(3)) == 0
    assert pfl.bc_time == fc.TIME_STEP      # restored
    el = fc.scnsim_case(PORT, refine=0, n_steps=1, device="cpu",
                        coupled_stencil=False, dense_precond=True)
    assert (el.outer_branch(), el.tpp_branch(), el.tpp_M_branch()) == \
        ("element", "dense", "diag")


@pytest.mark.parametrize("solver", ad.SOLVERS)
def test_duct_case_builds_for_both_packages(solver):
    jfl = ad.duct_case(JAX, solver, refine=1, n_steps=3)
    pfl = ad.duct_case(PORT, solver, refine=1, n_steps=3, device="cpu")
    assert pfl.params == PORT.AllParameters(**ad.duct_fields(
        1, 3, implicit=solver != "SCnsEX"))
    assert pfl.params.time_step == ad.TIME_STEP
    assert pfl.mesh.n_cells == jfl.mesh.n_cells == 16
    fn = pfl.hard_coded_bcs[0]
    pts = np.array([[0.0, 0.5], [1.0, 0.5]])
    dt, t = ad.TIME_STEP, ad.CENTER
    if solver == "SCnsEX":
        np.testing.assert_allclose(fn(pts, 0, t), [ad.PEAK, 0.0])
        assert pfl.bc_time_limits == {0: ad.EXPIRY}
    else:
        want = ad.pulse_value(t) - ad.pulse_value(t - dt)
        np.testing.assert_allclose(fn(pts, 0, t), [want, 0.0])
        first = ad.pulse_value(dt) - (0.0 if solver == "SCnsIM"
                                      else ad.pulse_value(0.0))
        np.testing.assert_allclose(fn(pts, 0, dt), [first, 0.0])
    np.testing.assert_array_equal(fn(pts, 1, t), 0.0)
    # extra refinement keeps c dt / h
    fine = ad.duct_case(PORT, solver, refine=1, n_steps=3, extra_refine=2,
                        device="cpu")
    assert fine.params.time_step == dt / 4
    assert fine.params.global_refinements[0] == 3
    with pytest.raises(ValueError):
        ad.duct_case(PORT, "InsIM")
