"""Share of K3's clock cycles (csrc/solve_ru.cu, every refined solve of the
timed window's trajectories, summed over the chains) spent in its f64 true
residuals: the kernel's own clock64() counters, which the program's block
sums (RunResult.k3_res_cycles over RunResult.k3_cycles). None off the card
or where the program does not keep them."""


def read(ctx):
    total = getattr(ctx.result, "k3_cycles", None)
    res = getattr(ctx.result, "k3_res_cycles", None)
    if not total or res is None:
        return None
    return 100.0 * res / total
