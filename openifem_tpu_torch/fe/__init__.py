from .shapes import QkShapes, gauss_quadrature, gauss_points_1d
from .space import FESpace, SystemSpace

__all__ = [
    "QkShapes", "gauss_quadrature", "gauss_points_1d", "FESpace",
    "SystemSpace",
]
