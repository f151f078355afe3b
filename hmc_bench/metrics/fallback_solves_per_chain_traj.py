"""Refined solves whose chain ran K4's f64 CG fallback inside K3's launch,
per chain-trajectory of the timed window (the program's block sums,
RunResult.cg_fallback_solves): near the critical mass the f32 recursion
leaves chains unconverged and K4 finishes them. None where the program
does not count them."""


def read(ctx):
    n = ctx.C * ctx.window.trajectories
    fb = getattr(ctx.result, "cg_fallback_solves", None)
    return fb / n if fb is not None and n else None
