"""Share of the traced stretch (from the trajectory step after both
programs' captures and first replays to the call's return) in which no
operation ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
