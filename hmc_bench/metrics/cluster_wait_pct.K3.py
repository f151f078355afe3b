"""Share of K3's clock cycles (csrc/solve_ru.cu, every refined solve of the
timed window's trajectories, summed over the chains) that the first thread
of each chain's cluster spent waiting on the cluster's other blocks (for
their halo rows and block sums, and at full cluster barriers): the latency
of the cluster path that its work does not hide (RunResult.k3_wait_cycles
over RunResult.k3_cycles). 0 on the one-block paths; None off the card or
where the program does not keep the count."""


def read(ctx):
    total = getattr(ctx.result, "k3_cycles", None)
    wait = getattr(ctx.result, "k3_wait_cycles", None)
    if not total or wait is None:
        return None
    return 100.0 * wait / total
