from .mesh import Mesh, FACE_VERTICES
from . import generators
from .manifolds import (FlatManifold, PolarManifold, SphericalManifold,
                        CylindricalManifold)

__all__ = [
    "Mesh", "FACE_VERTICES", "generators", "FlatManifold", "PolarManifold",
    "SphericalManifold", "CylindricalManifold",
]
