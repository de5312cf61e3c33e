from .insim import InsIM

__all__ = ["InsIM"]
