from .fsi import FSI

__all__ = ["FSI"]
