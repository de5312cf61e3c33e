"""Tensor-product Lagrange (Q_k) shape functions and Gauss quadrature.

TPU-first design: all shape data is precomputed as dense numpy tables
(n_points, n_local_nodes[, dim]) that downstream batched einsum/Pallas
assembly kernels consume.  Equivalent roles in the reference: deal.II
FE_Q/FESystem + QGauss (e.g. source/fluid_solver.cpp:15-35).

Local node ordering is lexicographic over the (k+1)^dim tensor grid with x
fastest (NOT deal.II's hierarchical ordering; ordering is internal only).
Unit cell is [0,1]^dim, matching deal.II.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def gauss_points_1d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _lagrange_1d(degree: int, x: np.ndarray):
    """Values and derivatives of the equidistant 1D Lagrange basis at x.

    Returns (vals, derivs) with shape (len(x), degree+1).
    """
    nodes = np.linspace(0.0, 1.0, degree + 1)
    n = degree + 1
    x = np.asarray(x, dtype=np.float64)
    vals = np.ones((len(x), n))
    derivs = np.zeros((len(x), n))
    for i in range(n):
        for j in range(n):
            if j == i:
                continue
            vals[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        # derivative via sum over product rule
        for k in range(n):
            if k == i:
                continue
            term = np.ones(len(x)) / (nodes[i] - nodes[k])
            for j in range(n):
                if j in (i, k):
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            derivs[:, i] += term
    return vals, derivs


class QkShapes:
    """Shape data of scalar Q_k on the unit hypercube at given points."""

    def __init__(self, degree: int, dim: int):
        self.degree = degree
        self.dim = dim
        self.n_local = (degree + 1) ** dim

    def local_nodes(self) -> np.ndarray:
        """Unit support points, lexicographic (x fastest): (n_local, dim)."""
        k = self.degree
        axes = [np.linspace(0.0, 1.0, k + 1)] * self.dim
        grids = np.meshgrid(*axes, indexing="ij")
        # indexing="ij" makes the LAST axis vary fastest when raveling, so
        # stack in reverse to get x fastest.
        pts = np.stack([g.ravel(order="F") for g in grids], axis=-1)
        return pts

    def evaluate(self, points: np.ndarray):
        """Shape values/gradients at unit points.

        Returns (N, dN): N (n_pts, n_local), dN (n_pts, n_local, dim).
        """
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n_pts = points.shape[0]
        vals_d = []
        ders_d = []
        for d in range(self.dim):
            v, g = _lagrange_1d(self.degree, points[:, d])
            vals_d.append(v)
            ders_d.append(g)
        n1 = self.degree + 1
        N = np.ones((n_pts, self.n_local))
        dN = np.ones((n_pts, self.n_local, self.dim))
        # local index l = i0 + n1*i1 + n1^2*i2 (x fastest)
        for l in range(self.n_local):
            idx = []
            rem = l
            for _ in range(self.dim):
                idx.append(rem % n1)
                rem //= n1
            for d in range(self.dim):
                N[:, l] *= vals_d[d][:, idx[d]]
                for dd in range(self.dim):
                    dN[:, l, dd] *= (ders_d[d][:, idx[d]] if d == dd
                                     else vals_d[d][:, idx[d]])
        return N, dN


@lru_cache(maxsize=None)
def gauss_quadrature(n_1d: int, dim: int):
    """Tensor-product Gauss quadrature on the unit hypercube.

    Returns (points (n_q, dim), weights (n_q,)). Matches deal.II QGauss(n_1d).
    """
    x, w = gauss_points_1d(n_1d)
    if dim == 1:
        return x[:, None].copy(), w.copy()
    axes_x = [x] * dim
    grids = np.meshgrid(*axes_x, indexing="ij")
    pts = np.stack([g.ravel(order="F") for g in grids], axis=-1)
    wgrids = np.meshgrid(*([w] * dim), indexing="ij")
    wts = np.ones(len(pts))
    for g in wgrids:
        wts = wts * g.ravel(order="F")
    return pts, wts
