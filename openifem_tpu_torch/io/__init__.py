from .vtk import write_vtu

__all__ = ["write_vtu"]
