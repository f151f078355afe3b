"""The timed window's share of the card's peak: the least time of all its
counted solver and force work (the refined solves, the force steps, and
with the condensate its inner solves and f64 residuals) at the data-sheet
peaks, over the window's wall seconds, the seconds chain_traj_per_s is
taken over. None off the card (no trace)."""

from hmc_bench import yardstick


def read(ctx):
    if ctx.trace is None or ctx.wall_s <= 0:
        return None
    n = ctx.window
    work = (yardstick.refined_solves(ctx.C, ctx.V2, n.trajectories * ctx.md_steps,
                                     n.cg_iters)
            + yardstick.force_steps(ctx.C, ctx.V2,
                                    n.trajectories * (ctx.md_steps - 1)))
    if ctx.condensate:
        work = (work + yardstick.condensate_inner(
            ctx.C, ctx.n_noise, ctx.V2, n.n_meas, n.condensate_iters)
            + yardstick.condensate_residuals(ctx.C, ctx.n_noise, ctx.V2,
                                             n.n_meas))
    return 100.0 * work.compute_seconds() / ctx.wall_s
