from .timectl import Time
from .pvd import PVDWriter

__all__ = ["Time", "PVDWriter"]
