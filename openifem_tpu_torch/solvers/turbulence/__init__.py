from .spalart_allmaras import SpalartAllmaras, make_turbulence_model

__all__ = ["SpalartAllmaras", "make_turbulence_model"]
