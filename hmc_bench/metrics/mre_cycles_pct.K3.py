"""Share of K3's clock cycles (csrc/solve_ru.cu, every refined solve of the
timed window's trajectories, summed over the chains) that the first thread
of each chain spent in the MRE forecast at the start of the launch, the
prologue that every solve runs under a history of K >= 2 solutions
(RunResult.k3_mre_cycles over RunResult.k3_cycles). None off the card,
where the program does not keep the count, or where K3 counted no
cycles."""


def read(ctx):
    total = getattr(ctx.result, "k3_cycles", None)
    mre = getattr(ctx.result, "k3_mre_cycles", None)
    if not total or mre is None:
        return None
    return 100.0 * mre / total
