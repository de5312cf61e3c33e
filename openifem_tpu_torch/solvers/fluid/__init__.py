from .insim import InsIM
from .insimex import InsIMEX

__all__ = ["InsIM", "InsIMEX"]
