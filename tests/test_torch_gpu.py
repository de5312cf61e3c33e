"""The CUDA element-matvec kernel on the card: every layout against its
plain PyTorch version (f64 to 1e-12, f32 to 1e-5, relative to the plain
result's max norm; the kernel sums in another order), bitwise-equal
results from repeated launches, one counted launch and one device kernel
per call, one plan build per table, refusal of what the kernel does not
take, and a coarse leaflet step on CUDA equal to the same step on the
CPU.  Needs a CUDA device, and imports no JAX, so it runs where JAX is
absent (--noconftest skips tests/conftest.py, which sets JAX up):

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from openifem_tpu_torch.cases.fsi_leaflet import leaflet_case, port_package
from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import operators as ops
from openifem_tpu_torch.mesh import generators

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NLU, D, NLP = 9, 2, 4
# (cells, velocity nodes, pressure dofs): the leaflet's counts, and a
# small problem; neither output count is a multiple of the outputs per
# block, the random tables leave nodes and dofs with no incidence, and
# their plans pad K
SIZES = {"leaflet": (1780, 7379, 1897), "small": (37, 70, 30)}
N_C, N_UN, N_P = SIZES["leaflet"]


def rel_err(got, ref):
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(dev, dtype, seed=0, size="leaflet"):
    n_c, n_un, n_p = SIZES[size]
    g = torch.Generator(device=dev).manual_seed(seed)
    nl = NLU * D + NLP
    # the last velocity node and pressure dof have no incidence
    un = torch.randint(0, n_un - 1, (n_c, NLU), generator=g, device=dev)
    pd = torch.randint(0, n_p - 1, (n_c, NLP), generator=g, device=dev)
    cd = torch.cat([(un[:, :, None] * D + torch.arange(D, device=dev))
                    .reshape(n_c, -1), pd + n_un * D], dim=1)
    return dict(
        A=torch.randn(n_c, nl, nl, generator=g, device=dev, dtype=dtype),
        un=un.to(torch.int32), pd=pd.to(torch.int32),
        cd=cd.to(torch.int32).contiguous(),
        x=torch.randn(n_un * D + n_p, generator=g, device=dev, dtype=dtype),
        n_c=n_c, n_un=n_un, n_p=n_p)


def _cases(pr):
    A, un, pd, cd, x = pr["A"], pr["un"], pr["pd"], pr["cd"], pr["x"]
    n_c, n_un, n_p = pr["n_c"], pr["n_un"], pr["n_p"]
    nu, n_u = NLU * D, n_un * D
    Auu_b = A[:, :nu, :nu].reshape(n_c, NLU, D, NLU, D)
    Aup_b = A[:, :nu, nu:].reshape(n_c, NLU, D, NLP)
    Apu = A[:, nu:, :nu]
    Apu_b = Apu.reshape(n_c, NLP, NLU, D)
    Mp = A[:, nu:, nu:]
    xu, xp = x[:n_u], x[n_u:]
    cd_u = cd[:, :nu].contiguous()
    return {
        "element_matvec": (ops.element_matvec, ops.element_matvec_plain,
                           (Mp, pd, n_p, xp)),
        "element_matvec_rect": (ops.element_matvec_rect,
                                ops.element_matvec_rect_plain,
                                (Apu, pd, cd_u, n_p, xu)),
        "element_matvec_nodeblock": (ops.element_matvec_nodeblock,
                                     ops.element_matvec_nodeblock_plain,
                                     (Auu_b, un, n_un, xu)),
        "element_matvec_u_to_p_nodeblock": (
            ops.element_matvec_u_to_p_nodeblock,
            ops.element_matvec_u_to_p_nodeblock_plain,
            (Apu_b, un, pd, n_p, xu)),
        "element_matvec_p_to_u_nodeblock": (
            ops.element_matvec_p_to_u_nodeblock,
            ops.element_matvec_p_to_u_nodeblock_plain,
            (Aup_b, un, pd, n_un, xp)),
        "element_matvec_taylor_hood": (
            lambda *a: ops.element_matvec_taylor_hood(*a, cell_dofs=cd),
            ops.element_matvec_taylor_hood_plain,
            (A, un, pd, NLU, D, n_u, n_p, x)),
    }


DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
# (block rows, block columns) of each layout's case in _cases
BLOCK = {"element_matvec": (NLP, NLP),
         "element_matvec_rect": (NLP, NLU * D),
         "element_matvec_nodeblock": (NLU * D, NLU * D),
         "element_matvec_u_to_p_nodeblock": (NLP, NLU * D),
         "element_matvec_p_to_u_nodeblock": (NLU * D, NLP),
         "element_matvec_taylor_hood": (NLU * D + NLP, NLU * D + NLP)}


@DTYPES
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("layout", cuda_ops.LAYOUTS)
def test_kernel_matches_plain(cuda, layout, size, dtype):
    """Right at both sizes, bitwise equal over repeated launches, one
    counted launch per call and one plan build per table."""
    pr = _problem(cuda, dtype, size=size)
    kern, plain, args = _cases(pr)[layout]
    key = (layout, str(dtype).replace("torch.", ""), pr["n_c"],
           *BLOCK[layout])
    before = cuda_ops.launches.copy()
    y = kern(*args)
    torch.cuda.synchronize()
    assert cuda_ops.launches - before == Counter({key: 1})
    assert y.is_cuda and y.dtype == dtype
    assert rel_err(y, plain(*args)) <= TOL[dtype]
    builds = cuda_ops.plan_builds
    for _ in range(5):
        assert torch.equal(kern(*args), y)
    assert cuda_ops.plan_builds == builds
    assert cuda_ops.launches - before == Counter({key: 6})


def _device_events(fn):
    """Names of the device activities torch.profiler records around fn()."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.fixture(scope="module")
def profiler():
    """torch.profiler with its device tracing started once (the first
    profiling run of a process also sets CUPTI up)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _device_events(lambda: torch.ones(1, device="cuda").add_(1))
    return _device_events


@DTYPES
@pytest.mark.parametrize("layout", cuda_ops.LAYOUTS)
def test_one_device_kernel_per_apply(cuda, profiler, layout, dtype):
    """No zero fill: the profiler sees the element-matvec kernel once per
    apply and no other device work."""
    kern, _, args = _cases(_problem(cuda, dtype))[layout]
    kern(*args)                     # the plan is built outside the window
    torch.cuda.synchronize()
    on_device = profiler(lambda: [kern(*args) for _ in range(3)])
    assert len(on_device) == 3, on_device
    assert all("element_matvec_kernel" in n for n in on_device), on_device


def test_kernel_refuses_what_it_does_not_take(cuda):
    pr = _problem(cuda, torch.float64)
    Mp, pd, x = pr["A"][:, -NLP:, -NLP:], pr["pd"], pr["x"][-N_P:]
    before = dict(cuda_ops.launches)
    with pytest.raises(TypeError, match="int32"):
        ops.element_matvec(Mp, pd.long(), N_P, x)
    with pytest.raises(TypeError, match="float32"):
        ops.element_matvec(Mp, pd, N_P, x.float())
    with pytest.raises(ValueError, match="stride"):
        ops.element_matvec(Mp.transpose(1, 2), pd, N_P, x)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        ops.element_matvec(Mp, pd, N_P, pr["x"][::2][:N_P])
    with pytest.raises(ValueError, match="system dof table"):
        ops.element_matvec_taylor_hood(pr["A"], pr["un"], pd, NLU, D,
                                       N_UN * D, N_P, pr["x"])
    assert cuda_ops.launches == before


def test_coarse_leaflet_step_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The element-matvec preconditioner branch (a_stencil off)."""
    monkeypatch.chdir(tmp_path)   # the solid writes its first-step output
    runs = []
    for dev in (cuda, torch.device("cpu")):
        fsi = leaflet_case(port_package(), "element", h=0.1,
                           refinements=(0, 1), n_steps=2, device=dev)
        fsi.run(verbose=False)
        assert set(fsi.fluid.precond_branches) == {("element", "cg")}
        runs.append(fsi)
    g, c = runs
    assert [(s["solid_newton"], s["fluid_newton"]) for s in g.step_log] == \
        [(s["solid_newton"], s["fluid_newton"]) for s in c.step_log]
    assert rel_err(g.fluid.present_solution.cpu(),
                   c.fluid.present_solution) <= 1e-6
    assert rel_err(g.solid.current_displacement.cpu(),
                   c.solid.current_displacement) <= 1e-6
    assert np.isfinite(g.fluid.velocity_part()).all()


# -- the dense, stencil and multigrid modules on the card, against the same
# code on the CPU (the CPU side is held against the JAX package by the
# test_torch_{dense,stencil,multigrid,precond_*} files).  f64 to 1e-12
# for single applies and 1e-10 for V-cycles and preconditioner applies
# (index_add_'s atomics reorder the sums); bf16 GEMV to 2**-7.  Where a
# GalerkinMG cycle runs, 1e-5: its coarse inverse is a float32 Newton-Schulz
# iteration by design, and cuBLAS and the CPU sum its products in another
# order.
GALERKIN_TOL = 1e-5

def _both(fn):
    """fn(device) on CUDA and on the CPU."""
    return fn(torch.device("cuda")), fn(torch.device("cpu"))


def _fluid(dev, config="element", h=0.1, knobs=None, mg=None, **kw):
    """A port fluid set up on `dev` with a seeded mid-run state."""
    fsi = leaflet_case(port_package(), config, h=h, refinements=(0, 1),
                       n_steps=1, device=dev, bench_precision=False, **kw)
    for k, v in (knobs or {}).items():
        setattr(fsi.fluid, k, v)
    fl = fsi.fluid
    fl.setup()
    meshes = (fsi.fluid_mg_base or []) + [fl.mesh]
    if mg == "pressure":
        fl.enable_pressure_mg(meshes)
    elif mg == "pressure_galerkin":
        fl.enable_pressure_mg(meshes, galerkin=True)
    elif mg == "velocity":
        fl.enable_velocity_mg(meshes)
    elif mg == "velocity_geo":
        fl.enable_velocity_mg(meshes, galerkin=False)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(0.2 * rng.normal(size=fl.n_dofs), device=dev)
    fl.present_solution = fl.nonzero_constraints.distribute(x)
    return fl


def test_condensed_dense_and_gemv_cuda_matches_cpu(cuda):
    from openifem_tpu_torch.la import dense
    fl0 = _fluid(torch.device("cpu"))
    rng = np.random.default_rng(7)
    A = rng.standard_normal((fl0.mesh.n_cells, fl0.nu_loc, fl0.nu_loc))
    x = rng.standard_normal(fl0.n_u)

    def run(dev):
        fl = _fluid(dev)
        ht = dense.hanging_tables(fl.u_constraints)
        M = dense.condensed_dense(torch.as_tensor(A, device=dev),
                                  fl.cell_dofs_u, fl.cell_dofs_u, fl.n_u,
                                  fl.n_u, fl.u_constraints, fl.u_constraints,
                                  ht, ht, unit_fixed_diag=True)
        xd = torch.as_tensor(x, device=dev)
        return (M, dense.gemv(M, xd), dense.gemv(M.float(), xd.float()),
                dense.gemv(M.to(torch.bfloat16), xd.float()))

    g, c = _both(run)
    assert rel_err(g[0].cpu(), c[0]) <= 1e-12
    assert rel_err(g[1].cpu(), c[1]) <= 1e-12
    assert rel_err(g[2].cpu(), c[2]) <= 1e-5
    assert g[3].dtype == torch.float32
    assert rel_err(g[3].cpu(), c[3]) <= 2.0 ** -7


def test_stencil_condensed_matvec_cuda_matches_cpu(cuda):
    from openifem_tpu_torch.cases.fsi_leaflet import uniform_hierarchy
    from openifem_tpu_torch.fe.space import FESpace
    from openifem_tpu_torch.la.stencil import PatchGrid, StencilOperator
    mesh = uniform_hierarchy(generators, 0.2, 1)[-1]
    sp = FESpace(mesh, 2)
    rng = np.random.default_rng(3)
    Ab = rng.standard_normal((mesh.n_cells, 9, 2, 9, 2))
    x = rng.standard_normal(sp.n_nodes * 2)
    fixed = rng.random(sp.n_nodes * 2) < 0.1

    def run(dev):
        st = StencilOperator(PatchGrid.build(mesh), sp, d=2, device=dev)
        W = st.build_weights(torch.as_tensor(Ab, device=dev))
        fp = st.spread_mask(torch.as_tensor(fixed, device=dev))
        return st.unspread(st.condensed_matvec(
            W, fp, st.spread(torch.as_tensor(x, device=dev))))

    g, c = _both(run)
    assert rel_err(g.cpu(), c) <= 1e-12


@pytest.mark.parametrize("kind", ["pressure", "velocity_geo",
                                  "pressure_galerkin", "velocity"])
def test_vcycle_cuda_matches_cpu(cuda, kind):
    """One V-cycle of each class on the r2-style hierarchy; the CUDA cycle
    launches the element-matvec kernel on every level."""
    from openifem_tpu_torch.la.multigrid import GalerkinMG

    def run(dev):
        fl = _fluid(dev, "fsi_leaflet_r2", h=0.2, extra_refine=1, mg=kind)
        mg = fl._velocity_mg if kind.startswith("velocity") else \
            fl._pressure_mg
        n = fl.n_u if kind.startswith("velocity") else fl.n_p
        b = torch.as_tensor(np.random.default_rng(4).normal(size=n),
                            device=dev)
        if isinstance(mg, GalerkinMG):
            nl = mg.cell_dofs_k[-1].shape[1]
            blocks = np.random.default_rng(5).normal(
                size=(fl.mesh.n_cells, nl, nl))
            blocks = blocks @ blocks.transpose(0, 2, 1) + nl * np.eye(nl)
            return mg.build(torch.as_tensor(blocks, device=dev))(b)
        return mg.vcycle(b)

    layout = "element_matvec_nodeblock" if kind == "velocity_geo" else \
        "element_matvec"
    before = cuda_ops.launches.copy()
    g = run(torch.device("cuda"))
    torch.cuda.synchronize()
    assert any(k[0] == layout for k in cuda_ops.launches - before)
    c = run(torch.device("cpu"))
    tol = GALERKIN_TOL if kind in ("pressure_galerkin", "velocity") else \
        1e-10
    assert rel_err(g.cpu(), c) <= tol


R2_SMALL = dict(config="fsi_leaflet_r2", h=0.2, extra_refine=1)
TIGHT = dict(mp_sm_rtol=1e-13, a_inner_rtol=1e-12)
BRANCHES = {
    "dense": dict(config="fsi_leaflet"),
    "block_jacobi": dict(knobs=dict(a_block_jacobi=True)),
    "a_poly3": dict(knobs=dict(a_poly=3)),
    "stencil_flat": dict(knobs=dict(a_stencil=True, a_poly=2)),
    "stencil": dict(R2_SMALL, knobs=dict(mg_direct=False)),
    "pressure_mg": dict(R2_SMALL, knobs=dict(mg_direct=False),
                        mg="pressure"),
    "pressure_mg_galerkin": dict(R2_SMALL, knobs=dict(mg_direct=False),
                                 mg="pressure_galerkin"),
    "mg_direct": dict(R2_SMALL, mg="pressure"),
    "velocity_mg": dict(R2_SMALL, knobs=dict(mg_direct=False),
                        mg="velocity"),
    "velocity_mg_direct": dict(R2_SMALL, knobs=dict(a_mg_cycles=2),
                               mg="velocity_geo"),
    "a_mg_precond": dict(R2_SMALL, knobs=dict(a_mg_precond=True),
                         mg="velocity"),
}


@pytest.mark.parametrize("name", BRANCHES)
def test_precond_apply_cuda_matches_cpu(cuda, name):
    """One apply of each preconditioner branch, inner solves converged
    (the f64 parity set-up of test_torch_precond_*.py)."""
    kw = dict(BRANCHES[name])
    kw["knobs"] = dict(TIGHT, **kw.get("knobs", {}))

    def run(dev):
        fl = _fluid(dev, **kw)
        args = (fl.present_solution, fl.present_solution, fl.indicator,
                fl.fsi_acceleration, fl.fsi_stress_cell, fl.fsi_acc_nodal)
        A_loc, _ = fl._assemble(*args)
        P = fl._make_preconditioner(A_loc, fl.u_constraints,
                                    fl.p_constraints)
        v = torch.as_tensor(np.random.default_rng(12).normal(
            size=fl.n_dofs), device=dev)
        return P(v), dict(fl.precond_branches)

    (g, gb), (c, cb) = _both(run)
    assert gb == cb
    galerkin = kw.get("mg") in ("pressure_galerkin", "velocity")
    assert rel_err(g.cpu(), c) <= (GALERKIN_TOL if galerkin else 1e-10)


# -- the standalone fluid path: the Turek cylinder through InsIM's stepper
# and through InsIMEX, on the card against the same code on the CPU (which
# tests/test_torch_{cylinder,insimex}.py hold against the JAX package).
# 1e-6 with equal Newton / outer counts: each linear system is solved to a
# 1e-8 relative residual.

def test_cylinder_stepper_cuda_matches_cpu(cuda):
    """The all-f64 "r1" configuration at refine 1: host first step and a
    2-step stepper window; the z-order stencil patches and the pressure
    V-cycle inside the Schur CG run on the card."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    from openifem_tpu_torch.utils.timer import count_host_syncs

    def run(dev):
        fl = fc.cylinder_case(port_package(), "r1", n_steps=3,
                              bench_precision=False, device=dev)
        fl.run_one_step(True, verbose=False)
        first, k0 = fl.newton_iters, dict(fl.krylov_iters)
        with count_host_syncs() as syncs:
            sol, rel, it = fl.make_on_device_stepper()(fl.present_solution,
                                                       2)
        krylov = sum(fl.krylov_iters[n] - k0[n]
                     for n in ("outer", "mp", "sm", "a"))
        return fl, sol, rel, (first, it), syncs["syncs"], krylov

    before = cuda_ops.launches.copy()
    (gfl, g, grel, gits, gsyncs, krylov), (_, c, _, cits, csyncs, _) = \
        _both(run)
    assert g.is_cuda and gits == cits
    assert grel < gfl.params.fluid_tolerance
    assert rel_err(g.cpu(), c) <= 1e-6
    assert set(gfl.precond_branches) == {("stencil", "cg+vcycle")}
    launched = {k[0] for k in cuda_ops.launches - before}
    assert {"element_matvec_taylor_hood", "element_matvec",
            "element_matvec_u_to_p_nodeblock",
            "element_matvec_p_to_u_nodeblock"} <= launched
    # every Krylov iteration of the window ends in a host read of a device
    # value; on the CPU no tensor is a CUDA tensor
    assert gsyncs >= krylov > 0
    assert csyncs == 0


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "f32_precond"])
def test_insimex_cuda_matches_cpu(cuda, mixed):
    """3 steps at refine 1.  The preconditioner applies B and B^T through
    element_matvec_rect on strided views of the system table, in f64 or
    (mixed_precision_precond) f32."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc

    def run(dev):
        fl = fc.imex_case(port_package(), 1, 3, device=dev)
        fl.mixed_precision_precond = mixed
        fl.run(verbose=False)
        return fl

    before = cuda_ops.launches.copy()
    g, c = _both(run)
    new = cuda_ops.launches - before
    dt = "float32" if mixed else "float64"
    assert new[("element_matvec_rect", dt, 368, 4, 18)] > 0     # B
    assert new[("element_matvec_rect", dt, 368, 18, 4)] > 0     # B^T
    assert new[("element_matvec", dt, 368, 18, 18)] > 0         # A block
    assert new[("element_matvec", "float64", 368, 22, 22)] > 0  # outer
    assert rel_err(g.present_solution.cpu(), c.present_solution) <= 1e-6
    if not mixed:
        assert g.krylov_iters["outer"] == c.krylov_iters["outer"]
    assert np.isfinite(g.velocity_part()).all()


# -- the stabilised fluid family and SCnsEX: the kernel at their block
# shapes, and each new solver coarse on the card against the same code on
# the CPU (which tests/test_torch_supg*.py and test_torch_scnsex.py hold
# against the JAX package).

# Q1/Q1 in 2-D (nlu 4, d 2, nlp 4) and in 3-D (nlu 8, d 3, nlp 8): no
# shape of the Taylor-Hood paths has so few columns per block
SUPG_SHAPES = {"2d": (4, 2, 4, 5888, 6128), "3d": (8, 3, 8, 1728, 2197)}


def _supg_cases(dev, dtype, shape):
    nlu, d, nlp, n_c, n_n = SUPG_SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(5)
    nu, nl = nlu * d, nlu * d + nlp
    un = torch.randint(0, n_n - 1, (n_c, nlu), generator=g, device=dev)
    pd = torch.randint(0, n_n - 1, (n_c, nlp), generator=g, device=dev)
    cd = torch.cat([(un[:, :, None] * d + torch.arange(d, device=dev))
                    .reshape(n_c, -1), pd + n_n * d], dim=1)
    un, pd, cd = (t.to(torch.int32).contiguous() for t in (un, pd, cd))
    A = torch.randn(n_c, nl, nl, generator=g, device=dev, dtype=dtype)
    x = torch.randn(n_n * (d + 1), generator=g, device=dev, dtype=dtype)
    xu, xp = x[:n_n * d].contiguous(), x[n_n * d:].contiguous()
    Av = torch.randn(n_c, nu, nu, generator=g, device=dev, dtype=dtype)
    return {
        "taylor_hood": (
            lambda *a: ops.element_matvec_taylor_hood(*a, cell_dofs=cd),
            ops.element_matvec_taylor_hood_plain,
            (A, un, pd, nlu, d, n_n * d, n_n, x), (nl, nl)),
        "p_to_u": (ops.element_matvec_p_to_u_nodeblock,
                   ops.element_matvec_p_to_u_nodeblock_plain,
                   (A[:, :nu, nu:].reshape(n_c, nlu, d, nlp), un, pd, n_n,
                    xp), (nu, nlp)),
        "u_to_p": (ops.element_matvec_u_to_p_nodeblock,
                   ops.element_matvec_u_to_p_nodeblock_plain,
                   (A[:, nu:, :nu].reshape(n_c, nlp, nlu, d), un, pd, n_n,
                    xu), (nlp, nu)),
        "scalar_pp": (ops.element_matvec, ops.element_matvec_plain,
                      (A[:, nu:, nu:], pd, n_n, xp), (nlp, nlp)),
        "scalar_vv": (ops.element_matvec, ops.element_matvec_plain,
                      (Av, cd[:, :nu].contiguous(), n_n * d, xu), (nu, nu)),
    }


@DTYPES
@pytest.mark.parametrize("shape", SUPG_SHAPES)
@pytest.mark.parametrize("which", ["taylor_hood", "p_to_u", "u_to_p",
                                   "scalar_pp", "scalar_vv"])
def test_kernel_at_supg_shapes(cuda, which, shape, dtype):
    """12 x 12, 8 x 4, 4 x 8, 4 x 4 and 8 x 8 blocks (2-D) and 32 x 32,
    24 x 8, 8 x 24, 8 x 8 and 24 x 24 (3-D): the group-size rule at 4, 8,
    12 and 24 columns and the stride checks on views of one table."""
    kern, plain, args, block = _supg_cases(cuda, dtype, shape)[which]
    before = cuda_ops.launches.copy()
    y = kern(*args)
    torch.cuda.synchronize()
    (key, n), = (cuda_ops.launches - before).items()
    assert n == 1 and key[3:] == block
    assert rel_err(y, plain(*args)) <= TOL[dtype]
    assert all(torch.equal(kern(*args), y) for _ in range(3))


SUPG_BRANCHES = {
    "stencil": (dict(), ("stencil", "stencil", "galerkin")),
    "element": (dict(coupled_stencil=False),
                ("element", "nodeblock", "galerkin")),
    "dense": (dict(coupled_stencil=False, dense_precond=True),
              ("element", "dense", "galerkin")),
    "hybrid": (dict(dense_precond=True, stencil_outer_only=True),
               ("stencil", "dense", "galerkin")),
}


@pytest.mark.parametrize("solver,branch", [
    ("SCnsIM", "stencil"), ("SCnsIM", "element"), ("SCnsIM", "dense"),
    ("SCnsIM", "hybrid"), ("SUPGInsIM", "stencil"),
    ("SerialSCnsIM", "element")])
def test_supg_cuda_matches_cpu(cuda, solver, branch):
    """Two steps on the cylinder at refine 1 (f64): 1e-6 with equal Newton
    counts; the branch taken and the layouts it launches."""
    from openifem_tpu_torch.cases import fluid_cylinder as fc
    knobs, want = SUPG_BRANCHES[branch]

    def run(dev):
        fl = fc.scnsim_case(port_package(), refine=1, n_steps=2,
                            bench_precision=False, solver=solver,
                            device=dev, **knobs)
        newton = []
        for i in range(2):
            if i:
                fl.bc_time += fl.time.get_delta_t()
                fl._make_constraints()
            fl.run_one_step(True, verbose=False)
            newton.append(fl.newton_iters)
        return fl, newton

    before = cuda_ops.launches.copy()
    (g, gn), (c, cn) = _both(run)
    launched = {k[0] for k in cuda_ops.launches - before}
    assert gn == cn and set(g.precond_branches) == {want}
    assert rel_err(g.present_solution.cpu(), c.present_solution) <= 1e-6
    assert rel_err(g.stress_device.cpu(), c.stress_device) <= 1e-6
    layouts = {"element_matvec"}                  # the V-cycle's levels
    if want[0] == "element":
        layouts.add("element_matvec_taylor_hood")
    if want[1] == "nodeblock":
        layouts |= {"element_matvec_p_to_u_nodeblock",
                    "element_matvec_u_to_p_nodeblock"}
    assert launched == layouts


@pytest.mark.parametrize("entry", ["run", "run_on_device"])
def test_scnsex_cuda_matches_cpu(cuda, entry):
    """Six steps of the coarse duct, the inlet BC expiring after the
    third: 1e-6, equal sweep and CG counts, element_matvec at 8 x 8 and
    4 x 4 and nothing else."""
    from openifem_tpu_torch.cases import acoustic_duct as ad

    def run(dev):
        fl = ad.duct_case(port_package(), "SCnsEX", refine=1, n_steps=6,
                          device=dev)
        fl.set_hard_coded_boundary_condition_time(0, 2.5 * ad.TIME_STEP)
        getattr(fl, entry)(verbose=False)
        return fl

    before = cuda_ops.launches.copy()
    g, c = _both(run)
    new = cuda_ops.launches - before
    assert set(new) == {("element_matvec", "float64", 64, 8, 8),
                        ("element_matvec", "float64", 64, 4, 4)}
    assert g.krylov_iters == c.krylov_iters
    assert g.time.get_timestep() == 6 and not g.hard_coded_bcs
    assert rel_err(g.present_solution.cpu(), c.present_solution) <= 1e-6


# -- the MPI coupler and the FSI-side solids --------------------------------

@pytest.mark.parametrize("config", ["body_force", "contact", "dirichlet",
                                    "wall3d"])
def test_mpi_fsi_cuda_matches_cpu(cuda, config, tmp_path, monkeypatch):
    """Three MPIFSI.run steps (f64) of the 2-D block configurations and
    the truncated wall3d: 1e-6 with equal Newton and retry counts; the
    RKPM solid's RK4 state too."""
    from openifem_tpu_torch.cases.fsi_wall_3d import TRUNCATED, wall3d_case
    from openifem_tpu_torch.cases.mpi_block import block_case
    monkeypatch.chdir(tmp_path)      # the RKPM solid writes VTU on step 1

    def run(dev):
        if config == "wall3d":
            fsi = wall3d_case(port_package(), reps=TRUNCATED, n_steps=3,
                              bench_precision=False, device=dev)
        else:
            fsi = block_case(port_package(), config, device=dev)
        fsi.run(verbose=False)
        return fsi

    g, c = _both(run)
    counts = [[(s["fluid_newton"], s["solid_retries"]) for s in f.step_log]
              for f in (g, c)]
    assert counts[0] == counts[1] and len(counts[0]) == 3
    pairs = [(g.fluid.present_solution, c.fluid.present_solution),
             (g.fluid.stress_device, c.fluid.stress_device),
             (g.solid.current_displacement, c.solid.current_displacement)]
    if config == "wall3d":
        pairs.append((g.solid.sigma, c.solid.sigma))
        assert torch.equal(g.fluid.indicator.cpu(), c.fluid.indicator)
    for a, b in pairs:
        assert rel_err(a.cpu(), b) <= 1e-6


def test_mpi_kernels_and_rk4_cuda_match_cpu(cuda):
    """Each _MPIKernels function and one SharedHypoElasticity RK4 step on
    a seeded state of the truncated wall3d: the indicator and the
    Dirichlet mask equal, the rest within 1e-12 (the particle scatters
    are atomics on CUDA)."""
    from openifem_tpu_torch.cases.fsi_wall_3d import TRUNCATED, wall3d_case

    def setup(dev):
        fsi = wall3d_case(port_package(), reps=TRUNCATED,
                          bench_precision=False, device=dev)
        gr = fsi.params.global_refinements
        fsi.solid.mesh = fsi.solid.mesh.refine_global(gr[1])
        fsi.solid.setup()
        fsi.fluid.setup()
        fsi._setup_coupling()
        return fsi

    g, c = _both(setup)
    rng = np.random.default_rng(5)
    so = c.solid
    d = so.dim
    seeds = dict(
        moved=so.x.numpy() + 0.01 * rng.normal(size=so.x.shape),
        sol=0.3 * rng.normal(size=c.fluid.n_dofs),
        f_stress=rng.normal(size=(c.fluid.u_space.n_nodes, d, d)),
        vel=rng.normal(size=so.n_p * d), acc=rng.normal(size=so.n_p * d),
        s_stress=rng.normal(size=(so.n_p, d, d)),
        disp=0.01 * rng.normal(size=so.n_p * d),
        sigma=50.0 * rng.normal(size=so.sigma.shape),
        rows=1e2 * rng.normal(size=(so.n_p, d, d)))

    def outputs(fsi, dev):
        t = {k: torch.as_tensor(v, device=dev) for k, v in seeds.items()}
        k = fsi._mpi_kernels
        ind = k.indicator_all_vertices(t["moved"])
        indf = ind.to(torch.float64)
        mask, vals = k.dirichlet_bc_mpi(t["moved"], t["vel"])
        return [ind, mask, vals,
                k.fsi_stress_nodal(t["moved"], t["f_stress"],
                                   t["s_stress"], indf),
                k.fsi_acc_nodal(t["moved"], t["sol"], t["vel"], t["acc"],
                                indf),
                *k.solid_bc_rows(t["disp"], t["sol"], t["f_stress"]),
                fsi.solid._nodal_stress_impl(t["sigma"]),
                *fsi.solid._device_step_impl(
                    t["moved"], t["vel"].reshape(-1, d), t["sigma"],
                    t["rows"])]

    got, ref = outputs(g, "cuda"), outputs(c, "cpu")
    assert torch.equal(got[0].cpu(), ref[0]) and ref[0].any()
    assert torch.equal(got[1].cpu(), ref[1])
    for a, b in zip(got[2:], ref[2:]):
        assert rel_err(a.cpu(), b) <= 1e-12


# -- the Spalart-Allmaras model and the vocal fold --------------------------

def _vocal_fold(dev, n_steps=3):
    from openifem_tpu_torch.cases.vocal_fold import vocal_fold_case
    return vocal_fold_case(port_package(), n_steps, device=dev)


def _sa_set_up(dev):
    """The coarse vocal fold's fluid and SA model, set up on `dev`."""
    fsi = _vocal_fold(dev)
    fsi.fluid.setup()
    tm = fsi.fluid.turbulence_model
    tm.setup()
    return tm


@DTYPES
def test_kernel_at_sa_shape(cuda, dtype):
    """The scalar layout at the SA's 4 x 4 blocks over its own table (800
    cells), against the plain version; repeats bitwise equal."""
    tm = _sa_set_up(cuda)
    g = torch.Generator(device=cuda).manual_seed(23)
    A = torch.randn(tm.cell_dofs.shape[0], 4, 4, generator=g, device=cuda,
                    dtype=dtype)
    x = torch.randn(tm.n, generator=g, device=cuda, dtype=dtype)
    cuda_ops.reset_launches()
    y = ops.element_matvec(A, tm.cell_dofs, tm.n, x)
    assert cuda_ops.launches[("element_matvec", str(dtype)[6:], 800, 4,
                              4)] == 1
    ref = ops.element_matvec_plain(A, tm.cell_dofs, tm.n, x)
    assert rel_err(y, ref) <= TOL[dtype]
    assert all(torch.equal(ops.element_matvec(A, tm.cell_dofs, tm.n, x), y)
               for _ in range(3))


def test_sa_newton_iter_cuda_matches_cpu(cuda):
    """One SA Newton iteration (assembly, Jacobi-preconditioned FGMRES
    through the kernel) on a seeded state: A_loc and rhs to 1e-12, the
    update to 1e-10, equal FGMRES counts."""
    g, c = _both(_sa_set_up)
    rng = np.random.default_rng(31)
    lam = c.params.viscosity / c.params.fluid_rho
    seeds = dict(
        eval_pt=lam * (2.0 + rng.normal(size=c.n)),
        present=lam * (2.0 + rng.normal(size=c.n)),
        sol=0.5 * rng.normal(size=c.fluid.n_dofs),
        wall=np.minimum(c.fixed_wall_distance.numpy(),
                        0.05 + rng.random(c.n)),
        ind=(rng.random(c.fluid.mesh.n_cells) < 0.1).astype(float))

    def outputs(tm, dev):
        args = [torch.as_tensor(v, device=dev) for v in seeds.values()]
        A, rhs = tm._assemble(*args)
        du, rn, its = tm._newton_iter(*args, tm.zero_constraints)
        return A, rhs, du, rn, its

    gA, gr, gdu, grn, gits = outputs(g, cuda)
    cA, cr, cdu, crn, cits = outputs(c, "cpu")
    assert rel_err(gA.cpu(), cA) <= 1e-12 and rel_err(gr.cpu(), cr) <= 1e-12
    assert abs(grn - crn) <= 1e-12 * crn and gits == cits > 1
    assert rel_err(gdu.cpu(), cdu) <= 1e-10


def test_vocal_fold_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """Three ControlVolumeFSI.run steps of the coarse vocal fold: 1e-6 with
    equal fluid Newton, SA Newton and contact-retry counts."""
    monkeypatch.chdir(tmp_path)

    def run(dev):
        fsi = _vocal_fold(dev)
        fsi.run(verbose=False)
        return fsi

    g, c = _both(run)
    counts = [[(s["fluid_newton"], s["sa_newton"], s["solid_retries"])
               for s in f.step_log] for f in (g, c)]
    assert counts[0] == counts[1] and len(counts[0]) == 3
    for a, b in ((g.fluid.present_solution, c.fluid.present_solution),
                 (g.fluid.turbulence_model.present_solution,
                  c.fluid.turbulence_model.present_solution),
                 (g.solid.current_displacement,
                  c.solid.current_displacement)):
        assert rel_err(a.cpu(), b) <= 1e-6
    for gh, ch in zip(g.cv_history, c.cv_history):
        assert all(abs(gh[k] - ch[k]) <= max(1e-6 * abs(ch[k]), 1e-12)
                   for k in ch)


@DTYPES
def test_kernel_at_shell_shape(cuda, dtype):
    """The scalar layout at the flat shell's 20 x 20 blocks (5 dofs x 4
    nodes) over its own table (256 cells), against the plain version;
    repeats bitwise equal."""
    from openifem_tpu_torch.cases import shell_plate as sp
    shell = sp.shell_case(port_package(), "plate", (16, 16), device=cuda)
    shell.setup()
    g = torch.Generator(device=cuda).manual_seed(29)
    A = torch.randn(256, 20, 20, generator=g, device=cuda, dtype=dtype)
    x = torch.randn(shell.n_dofs, generator=g, device=cuda, dtype=dtype)
    cuda_ops.reset_launches()
    y = ops.element_matvec(A, shell.cell_dofs, shell.n_dofs, x)
    assert cuda_ops.launches[("element_matvec", str(dtype)[6:], 256, 20,
                              20)] == 1
    ref = ops.element_matvec_plain(A, shell.cell_dofs, shell.n_dofs, x)
    assert rel_err(y, ref) <= TOL[dtype]
    assert all(torch.equal(ops.element_matvec(A, shell.cell_dofs,
                                              shell.n_dofs, x), y)
               for _ in range(3))


def test_refine_and_restart_on_the_card(cuda, tmp_path, monkeypatch):
    """The coarse leaflet through FSI.run with interface refinement and a
    checkpoint every 2 steps: 4 steps on the card against the CPU (equal
    meshes and Newton counts, 1e-6), then a restart on the card from the
    step-2 checkpoints to step 4 against the uninterrupted card run
    (1e-10: the card's index_add_ rounds differently from run to run)."""
    import glob
    import shutil
    monkeypatch.chdir(tmp_path)
    pkg = port_package()

    def run(dev, stop=4, workdir="."):
        os.makedirs(workdir, exist_ok=True)
        here = os.getcwd()
        os.chdir(workdir)
        try:
            fsi = leaflet_case(pkg, "element", h=0.1, refinements=(0, 1),
                               n_steps=4, device=dev, refine_every=2,
                               save_every=2)
            # interrupted after step `stop`, its parameters unchanged
            fsi.time.time_end = stop * fsi.params.time_step
            fsi.run(verbose=False)
        finally:
            os.chdir(here)
        return fsi

    g, c = run(cuda, workdir="gpu"), run("cpu", workdir="cpu")
    assert np.array_equal(g.fluid.mesh.cells, c.fluid.mesh.cells)
    assert [(s["solid_newton"], s["fluid_newton"]) for s in g.step_log] == \
        [(s["solid_newton"], s["fluid_newton"]) for s in c.step_log]
    assert rel_err(g.fluid.present_solution.cpu(),
                   c.fluid.present_solution) <= 1e-6
    # the restart: the step-2 checkpoints of a 2-step card run
    run(cuda, stop=2, workdir="part")
    os.makedirs("restart")
    for f in glob.glob("part/*.checkpoint.npz"):
        shutil.copy(f, "restart")
    os.chdir("restart")
    r = leaflet_case(pkg, "element", h=0.1, refinements=(0, 1), n_steps=4,
                     device=cuda, refine_every=2, save_every=2)
    r.resume(verbose=False)
    os.chdir(tmp_path)
    assert r.time.get_timestep() == 4
    assert rel_err(r.fluid.present_solution.cpu(),
                   g.fluid.present_solution.cpu()) <= 1e-10
    assert rel_err(r.solid.current_displacement.cpu(),
                   g.solid.current_displacement.cpu()) <= 1e-10


# -- parallel/shard.py on the card: the dry run's checks at world size 1
# (NCCL) and with 2 ranks sharing the card (gloo unless each rank has a
# card of its own), against the unsharded card run with the dry run's
# tolerances (entry.compare raises on a miss)

@pytest.mark.parametrize("n_ranks,checks", [
    (1, ("element_newton", "insim_newton", "supg_newton", "solid_cg")),
    (2, ("insim_newton", "stencil_asolve", "solid_cg")),
], ids=["nccl_world_size_1", "two_ranks_share_the_card"])
def test_sharded_checks_on_the_card(cuda, n_ranks, checks):
    from openifem_tpu_torch import entry
    from openifem_tpu_torch.parallel.shard import backend_for
    r = entry.dryrun_multichip(n_ranks, "cuda", checks=checks)
    assert set(r["errors"]) == set(checks)
    backend = backend_for("cuda", n_ranks)
    assert backend == ("nccl" if n_ranks <= torch.cuda.device_count()
                       else "gloo")
    assert r["routes"]["all_reduce"] == backend
    if backend == "gloo":
        assert r["routes"]["all_gather"] == "gloo via pinned host"
    # every rank launched the kernel on its own cells in every check but
    # the stencil solve, which runs no element-block apply
    assert all(sum(launches[name].values()) > 0
               for launches in r["launches"] for name in checks
               if name != "stencil_asolve")
