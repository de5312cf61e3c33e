"""Inner Krylov iterations of the block preconditioner per time step: the
Mp, Sm and A solves (InsIM.krylov_iters "mp" + "sm" + "a")."""


def read(ctx):
    steps = ctx["steps"]
    if not steps:
        return None
    return sum(sum(s["krylov"].get(k, 0) for k in ("mp", "sm", "a"))
               for s in steps) / len(steps)
