"""Manifold descriptions for curved-geometry vertex placement on refinement.

Equivalent role: deal.II Manifold/PolarManifold/SphericalManifold/
CylindricalManifold used by Utils::GridCreator (reference:
source/utilities.cpp:344-633). Only new-point placement is needed since all
FE mappings are (bi/tri)linear.
"""

from __future__ import annotations

import numpy as np


class FlatManifold:
    def new_point(self, points: np.ndarray, weights=None) -> np.ndarray:
        points = np.asarray(points, dtype=np.float64)
        if weights is None:
            return points.mean(axis=0)
        w = np.asarray(weights, dtype=np.float64)
        return (points * w[:, None]).sum(axis=0)


class PolarManifold:
    """2D polar manifold centered at ``center``: averages (r, theta)."""

    def __init__(self, center):
        self.center = np.asarray(center, dtype=np.float64)

    def new_point(self, points: np.ndarray, weights=None) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float64) - self.center
        r = np.linalg.norm(pts, axis=1)
        theta = np.arctan2(pts[:, 1], pts[:, 0])
        if weights is None:
            weights = np.full(len(pts), 1.0 / len(pts))
        w = np.asarray(weights, dtype=np.float64)
        # Average angles safely around the branch cut: rotate so the first
        # point is at angle 0.
        dtheta = np.angle(np.exp(1j * (theta - theta[0])))
        t = theta[0] + (w * dtheta).sum()
        rr = (w * r).sum()
        return self.center + rr * np.array([np.cos(t), np.sin(t)])


class SphericalManifold:
    """Spherical manifold centered at ``center`` (2D or 3D).

    New point = average radius along the spherical interpolation of the
    directions (adequate for the hyper_ball boundary refinement)."""

    def __init__(self, center):
        self.center = np.asarray(center, dtype=np.float64)

    def new_point(self, points: np.ndarray, weights=None) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float64) - self.center
        r = np.linalg.norm(pts, axis=1)
        if weights is None:
            weights = np.full(len(pts), 1.0 / len(pts))
        w = np.asarray(weights, dtype=np.float64)
        dirs = pts / np.maximum(r[:, None], 1e-300)
        d = (w[:, None] * dirs).sum(axis=0)
        dn = np.linalg.norm(d)
        if dn < 1e-12:
            return self.center + (w[:, None] * pts).sum(axis=0)
        rr = (w * r).sum()
        return self.center + rr * d / dn


class TransfiniteCell:
    """Transfinite-interpolation chart of one coarse quad cell.

    Equivalent to deal.II TransfiniteInterpolationManifold restricted to a
    single coarse cell: blends (possibly curved) edge parameterizations
    into the interior:
      X(xi,eta) = (1-eta) Eb(xi) + eta Et(xi) + (1-xi) El(eta) + xi Er(eta)
                  - bilinear(corners).
    Vertices are in z-order; edges follow the deal.II face order
    [left(v0,v2), right(v1,v3), bottom(v0,v1), top(v2,v3)].
    """

    def __init__(self, verts, edge_manifolds):
        self.verts = np.asarray(verts, dtype=np.float64)  # (4, 2)
        self.edge_manifolds = edge_manifolds  # list of 4: Manifold or None

    def _edge_point(self, face, t):
        pairs = {0: (0, 2), 1: (1, 3), 2: (0, 1), 3: (2, 3)}
        a, b = pairs[face]
        pa, pb = self.verts[a], self.verts[b]
        man = self.edge_manifolds[face]
        if man is None or t == 0.0 or t == 1.0:
            return (1 - t) * pa + t * pb
        return man.new_point(np.array([pa, pb]), np.array([1 - t, t]))

    def eval(self, xi, eta):
        Eb = self._edge_point(2, xi)
        Et = self._edge_point(3, xi)
        El = self._edge_point(0, eta)
        Er = self._edge_point(1, eta)
        v = self.verts
        bil = ((1 - xi) * (1 - eta) * v[0] + xi * (1 - eta) * v[1] +
               (1 - xi) * eta * v[2] + xi * eta * v[3])
        return (1 - eta) * Eb + eta * Et + (1 - xi) * El + xi * Er - bil


class TransfiniteManifold:
    """Collection of coarse-cell TFI charts, indexed by coarse id."""

    def __init__(self):
        self.cells = []

    def add_cell(self, verts, edge_manifolds) -> int:
        self.cells.append(TransfiniteCell(verts, edge_manifolds))
        return len(self.cells) - 1

    def eval(self, coarse_id: int, xi: float, eta: float):
        return self.cells[coarse_id].eval(xi, eta)


class CylindricalManifold:
    """3D cylindrical manifold along coordinate ``axis`` through origin."""

    def __init__(self, axis: int = 2, center=None):
        self.axis = axis
        self.center = (np.zeros(3) if center is None
                       else np.asarray(center, dtype=np.float64))

    def new_point(self, points: np.ndarray, weights=None) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float64) - self.center
        if weights is None:
            weights = np.full(len(pts), 1.0 / len(pts))
        w = np.asarray(weights, dtype=np.float64)
        ax = self.axis
        other = [d for d in range(3) if d != ax]
        planar = pts[:, other]
        r = np.linalg.norm(planar, axis=1)
        theta = np.arctan2(planar[:, 1], planar[:, 0])
        dtheta = np.angle(np.exp(1j * (theta - theta[0])))
        t = theta[0] + (w * dtheta).sum()
        rr = (w * r).sum()
        z = (w * pts[:, ax]).sum()
        out = np.zeros(3)
        out[other[0]] = rr * np.cos(t)
        out[other[1]] = rr * np.sin(t)
        out[ax] = z
        return out + self.center
