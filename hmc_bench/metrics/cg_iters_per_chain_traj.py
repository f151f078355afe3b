"""CG iterations of the trajectory solves per chain-trajectory of the timed
window (the program's block sums)."""


def read(ctx):
    n = ctx.C * ctx.window.trajectories
    return ctx.window.cg_iters / n if n else None
