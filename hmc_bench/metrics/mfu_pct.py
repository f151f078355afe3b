"""The timed window's share of the card's peak: the least time of all its
counted solver and force work (the refined solves and force steps a
trajectory of the configuration's physics, yardstick.solves_per_traj and
force_steps_per_traj, and with the condensate its inner solves and f64
residuals) at the data-sheet peaks, over the window's wall seconds, the
seconds chain_traj_per_s is taken over. None off the card (no trace)."""

from hmc_bench import yardstick as y


def read(ctx):
    if ctx.trace is None or ctx.wall_s <= 0:
        return None
    n, p = ctx.window, ctx.physics
    work = (y.refined_solves(ctx.C, ctx.V2, n.trajectories * y.solves_per_traj(p),
                             n.cg_iters)
            + y.force_steps(ctx.C, ctx.V2, n.trajectories * y.force_steps_per_traj(p),
                            y.hasenbusch(p)))
    if ctx.condensate:
        work = (work + y.condensate_inner(
            ctx.C, ctx.n_noise, ctx.V2, n.n_meas, n.condensate_iters)
            + y.condensate_residuals(ctx.C, ctx.n_noise, ctx.V2, n.n_meas))
    return 100.0 * work.compute_seconds() / ctx.wall_s
