"""Host seconds of the timed window's graph captures: the trajectory
program's and the measurement program's, each with its eager warm-up step
(the program's hmc.traj.capture and hmc.meas.capture spans, in
RunResult.perf["spans"]). Both are inside chain_traj_per_s's window. None
where no capture ran (off the card) or the program has no such spans."""


def read(ctx):
    spans = (ctx.result.perf or {}).get("spans") or {}
    got = [spans[n]["seconds"] for n in ("hmc.traj.capture", "hmc.meas.capture")
           if n in spans]
    return sum(got) if got else None
