from .hyper import HyperElasticity

__all__ = ["HyperElasticity"]
