"""K6 (the measurement's f32 CG, csrc/cg_eo.cu) against its roofline: the
least time of the traced stretch's condensate inner solves, over K6's
device time in the stretch (its masked launches with no active entry
included)."""

from hmc_bench import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.condensate:
        return None
    t = ctx.trace.seconds_of("cg_eo")
    if not t:
        return None
    n = ctx.traced
    work = yardstick.condensate_inner(ctx.C, ctx.n_noise, ctx.V2, n.n_meas,
                                      n.condensate_iters)
    return 100.0 * work.seconds() / t
