from .insim import InsIM
from .insimex import InsIMEX
from .scnsex import SCnsEX
from .supg import SCnsIM, SerialSCnsIM, SUPGFluidSolver, SUPGInsIM

__all__ = ["InsIM", "InsIMEX", "SCnsEX", "SCnsIM", "SerialSCnsIM",
           "SUPGFluidSolver", "SUPGInsIM"]
