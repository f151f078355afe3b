"""Restart passes of the condensate's refinement (solvers/refine.py) that
solved nothing, per measurement of the timed window: cg.max_outer less the
passes in which any of the batch's solves was active
(RunResult.condensate_active_passes). Each such pass still launches K6 and
K9 with every entry masked. None without the condensate, or where the
program does not count the passes."""


def read(ctx):
    active = getattr(ctx.result, "condensate_active_passes", None)
    if not ctx.condensate or active is None or not len(active):
        return None
    max_outer = ctx.result.hmc.cg.max_outer
    return sum(max_outer - int(a) for a in active) / len(active)
