"""CG iterations of the Metropolis action solves (the certified solves at
the configuration's tol, two under Hasenbusch) per chain-trajectory of the
timed window: the part of cg_iters_per_chain_traj that is not the MD force
solves (the program's block sums, RunResult.action_iters_total). None where
the program does not count them."""


def read(ctx):
    it = getattr(ctx.result, "action_iters_total", None)
    n = ctx.C * ctx.window.trajectories
    return it / n if it is not None and n else None
