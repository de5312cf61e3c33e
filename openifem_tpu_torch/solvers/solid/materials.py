"""Solid material models as pure functions over batched deformation state.

Counterpart of openifem_tpu/solvers/solid/materials.py (reference:
include/linear_elastic_material.h, include/neo_hookean.h,
include/kirchhoff_elastic_material.h, source/hyper_elastic_material.cpp).
The two linear tensors are host numpy, built once at set-up.  Volumetric energy
0.5*kappa*(J-1)^2 and the dim-dependent isochoric split
F_iso = J^(-1/dim) F, as deal.II's Physics::Elasticity does.
"""

from __future__ import annotations

import numpy as np
import torch

from ...la.smalltensor import det as _det


def lame_parameters(E: float, nu: float):
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    return lam, mu


def linear_elasticity_tensor(E: float, nu: float, dim: int) -> np.ndarray:
    """Rank-4 elasticity tensor C_{ijkl} = mu(d_ik d_jl + d_il d_jk)
    + lambda d_ij d_kl
    (reference: source/linear_elastic_material.cpp:17-38)."""
    lam, mu = lame_parameters(E, nu)
    I = np.eye(dim)
    return (mu * (np.einsum("ik,jl->ijkl", I, I) +
                  np.einsum("il,jk->ijkl", I, I)) +
            lam * np.einsum("ij,kl->ijkl", I, I))


def viscosity_tensor(eta: float, dim: int) -> np.ndarray:
    """reference: source/linear_elastic_material.cpp:40-61."""
    I = np.eye(dim)
    return (eta / 2) * (np.einsum("ik,jl->ijkl", I, I) +
                        np.einsum("il,jk->ijkl", I, I))


def _standard_tensors(dim: int, dtype, device):
    I = torch.eye(dim, dtype=dtype, device=device)
    IxI = torch.einsum("ij,kl->ijkl", I, I)
    S = 0.5 * (torch.einsum("ik,jl->ijkl", I, I) +
               torch.einsum("il,jk->ijkl", I, I))
    dev_P = S - IxI / dim
    return I, IxI, S, dev_P


def neo_hookean_state(F, c1: float, kappa: float):
    """Kirchhoff stress tau and spatial tangent Jc for Neo-Hookean.

    F: (..., d, d). Returns (tau (..., d, d), Jc (..., d, d, d, d)).
    Reference: include/neo_hookean.h:26-34,
    source/hyper_elastic_material.cpp:8-40."""
    d = F.shape[-1]
    I, IxI, S, dev_P = _standard_tensors(d, F.dtype, F.device)
    J = _det(F)
    Fbar = F * (J ** (-1.0 / d))[..., None, None]
    b_bar = torch.einsum("...ik,...jk->...ij", Fbar, Fbar)
    tau_bar = 2.0 * c1 * b_bar
    tr_tau_bar = torch.diagonal(tau_bar, dim1=-2, dim2=-1).sum(-1)
    tau_iso = tau_bar - (tr_tau_bar / d)[..., None, None] * I
    p = kappa * (J - 1.0)
    tau_vol = (J * p)[..., None, None] * I
    tau = tau_iso + tau_vol

    e4 = (...,) + (None,) * 4
    p_tilde = p + J * kappa
    Jc_vol = J[e4] * (p_tilde[e4] * IxI - 2.0 * p[e4] * S)
    tiso_x_I = torch.einsum("...ij,kl->...ijkl", tau_iso, I)
    I_x_tiso = torch.einsum("ij,...kl->...ijkl", I, tau_iso)
    Jc_iso = ((2.0 / d) * tr_tau_bar[e4] * dev_P -
              (2.0 / d) * (tiso_x_I + I_x_tiso))
    return tau, Jc_vol + Jc_iso


def kirchhoff_state(F, E_mod: float, nu: float):
    """St. Venant-Kirchhoff: tau = F S F^T with S = lam tr(E) I + 2 mu E;
    Jc = lam IxI + 2 mu S_sym (constant).
    Reference: include/kirchhoff_elastic_material.h:38-73."""
    d = F.shape[-1]
    I, IxI, S4, _ = _standard_tensors(d, F.dtype, F.device)
    lam, mu = lame_parameters(E_mod, nu)
    C = torch.einsum("...ki,...kj->...ij", F, F)
    Egl = 0.5 * (C - I)
    trE = torch.diagonal(Egl, dim1=-2, dim2=-1).sum(-1)
    S_pk2 = lam * trE[..., None, None] * I + 2.0 * mu * Egl
    tau = torch.einsum("...ik,...kl,...jl->...ij", F, S_pk2, F)
    Jc = lam * IxI + 2.0 * mu * S4
    return tau, Jc.expand(F.shape[:-2] + Jc.shape)
