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
