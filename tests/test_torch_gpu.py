"""The CUDA element-matvec kernel on the card: every layout against its
plain PyTorch version (f64 to 1e-12, f32 to 1e-5, relative to the plain
result's max norm; atomics reorder the sums), one counted launch per
call, refusal of what the kernel does not take, and a coarse leaflet step
on CUDA equal to the same step on the CPU.  Needs a CUDA device, and
imports no JAX, so it runs where JAX is absent (--noconftest skips
tests/conftest.py, which sets JAX up):

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import openifem_tpu_torch
from openifem_tpu_torch.cases.fsi_leaflet import (inflow, leaflet_fields,
                                                  leaflet_meshes)
from openifem_tpu_torch.fsi import FSI
from openifem_tpu_torch.la import cuda_ops
from openifem_tpu_torch.la import operators as ops
from openifem_tpu_torch.mesh import generators
from openifem_tpu_torch.solvers.fluid import InsIM
from openifem_tpu_torch.solvers.solid import HyperElasticity

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
N_C, NLU, D, NLP, N_UN, N_P = 1780, 9, 2, 4, 7379, 1897


def rel_err(got, ref):
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(dev, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    nl = NLU * D + NLP
    un = torch.randint(0, N_UN, (N_C, NLU), generator=g, device=dev)
    pd = torch.randint(0, N_P, (N_C, NLP), generator=g, device=dev)
    cd = torch.cat([(un[:, :, None] * D + torch.arange(D, device=dev))
                    .reshape(N_C, -1), pd + N_UN * D], dim=1)
    return dict(
        A=torch.randn(N_C, nl, nl, generator=g, device=dev, dtype=dtype),
        un=un.to(torch.int32), pd=pd.to(torch.int32),
        cd=cd.to(torch.int32).contiguous(),
        x=torch.randn(N_UN * D + N_P, generator=g, device=dev, dtype=dtype))


def _cases(pr):
    A, un, pd, cd, x = pr["A"], pr["un"], pr["pd"], pr["cd"], pr["x"]
    nu, n_u = NLU * D, N_UN * D
    Auu_b = A[:, :nu, :nu].reshape(N_C, NLU, D, NLU, D)
    Aup_b = A[:, :nu, nu:].reshape(N_C, NLU, D, NLP)
    Apu = A[:, nu:, :nu]
    Apu_b = Apu.reshape(N_C, NLP, NLU, D)
    Mp = A[:, nu:, nu:]
    xu, xp = x[:n_u], x[n_u:]
    cd_u = cd[:, :nu].contiguous()
    return {
        "element_matvec": (ops.element_matvec, ops.element_matvec_plain,
                           (Mp, pd, N_P, xp)),
        "element_matvec_rect": (ops.element_matvec_rect,
                                ops.element_matvec_rect_plain,
                                (Apu, pd, cd_u, N_P, xu)),
        "element_matvec_nodeblock": (ops.element_matvec_nodeblock,
                                     ops.element_matvec_nodeblock_plain,
                                     (Auu_b, un, N_UN, xu)),
        "element_matvec_u_to_p_nodeblock": (
            ops.element_matvec_u_to_p_nodeblock,
            ops.element_matvec_u_to_p_nodeblock_plain,
            (Apu_b, un, pd, N_P, xu)),
        "element_matvec_p_to_u_nodeblock": (
            ops.element_matvec_p_to_u_nodeblock,
            ops.element_matvec_p_to_u_nodeblock_plain,
            (Aup_b, un, pd, N_UN, xp)),
        "element_matvec_taylor_hood": (
            lambda *a: ops.element_matvec_taylor_hood(*a, cell_dofs=cd),
            ops.element_matvec_taylor_hood_plain,
            (A, un, pd, NLU, D, n_u, N_P, x)),
    }


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("layout", cuda_ops.LAYOUTS)
def test_kernel_matches_plain(cuda, layout, dtype):
    kern, plain, args = _cases(_problem(cuda, dtype))[layout]
    before = cuda_ops.launches[layout]
    y = kern(*args)
    torch.cuda.synchronize()
    assert cuda_ops.launches[layout] == before + 1
    assert y.is_cuda and y.dtype == dtype
    assert rel_err(y, plain(*args)) <= TOL[dtype]


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
    monkeypatch.chdir(tmp_path)   # the solid writes its first-step output
    runs = []
    for dev in (cuda, torch.device("cpu")):
        p = openifem_tpu_torch.AllParameters(**leaflet_fields(
            h=0.1, refinements=(0, 1), n_steps=2))
        fm, sm = leaflet_meshes(generators, 0.1)
        fsi = FSI(InsIM(fm, p, bc=inflow, device=dev),
                  HyperElasticity(sm, p, device=dev), p,
                  use_dirichlet_bc=True)
        fsi.run(verbose=False)
        runs.append(fsi)
    g, c = runs
    assert [(s["solid_newton"], s["fluid_newton"]) for s in g.step_log] == \
        [(s["solid_newton"], s["fluid_newton"]) for s in c.step_log]
    assert rel_err(g.fluid.present_solution.cpu(),
                   c.fluid.present_solution) <= 1e-6
    assert rel_err(g.solid.current_displacement.cpu(),
                   c.solid.current_displacement) <= 1e-6
    assert np.isfinite(g.fluid.velocity_part()).all()
