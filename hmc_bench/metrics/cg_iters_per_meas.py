"""CG iterations of the condensate solves per chain-measurement of the
timed window (all noise vectors of a chain, every refinement pass)."""


def read(ctx):
    if not ctx.condensate or not ctx.window.n_meas:
        return None
    return ctx.window.condensate_iters / (ctx.C * ctx.window.n_meas)
