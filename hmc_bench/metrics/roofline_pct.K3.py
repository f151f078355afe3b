"""K3 (the refined solve, csrc/solve_ru.cu) against its roofline: the least
time of the traced stretch's refined solves (yardstick.solves_per_traj a
trajectory) and their CG iterations, over K3's device time in the
stretch."""

from hmc_bench import yardstick


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.seconds_of("solve_ru")
    if not t:
        return None
    n = ctx.traced
    work = yardstick.refined_solves(
        ctx.C, ctx.V2, n.trajectories * yardstick.solves_per_traj(ctx.physics),
        n.cg_iters)
    return 100.0 * work.seconds() / t
