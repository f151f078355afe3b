"""Readings that set a cell's data: its thermalization and its limits.

    python3 hmc_bench/calibrate.py therm --workload demo64.gen --seed 1 --calls 32 --per-call 25
    python3 hmc_bench/calibrate.py limits --workload demo64.gen --seeds 1,2,3 --n-meas 12 [--loose-seeds 3]

``therm`` runs the cell's chains from the hot start through ``run_hmc``,
through the configuration's anneal masses first (``harness.thermalize``'s
anneal, a line a mass), in calls of ``--per-call`` trajectories at its m0
and prints, a line a call, the mean plaquette, the CG iterations per
chain-trajectory, the unconverged chain-trajectories and fallback solves,
and the seconds: the thermalization is where the plaquette and the
iterations stop drifting. ``limits`` runs, for each
seed, the cell's set-up and a window of ``--n-meas`` measurements, and
prints the compared numbers of the program and of the two controls (the
plain reference one precision lower put in the program's place,
reference.CONTROLS) as one JSON line; with
``--loose-seeds N`` also, on the first N seeds, those of the program on
its own loose f32 contract.
Every line goes to standard output; nothing is written to disk.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def therm(cell, args, device):
    import numpy as np

    from hmc_bench import harness

    s = harness.Session(cell, args.seed, device)
    s.n_steps, s.condensate = 0, False      # a plaquette every trajectory
    anneal = cell.config.get("setup") or {}
    calls = [(m0, int(anneal["anneal_traj"])) for m0 in anneal.get("anneal_m0", ())]
    calls += [(None, args.per_call)] * args.calls
    for i, (m0, n) in enumerate(calls):
        s.sync()
        t0 = time.perf_counter()
        res = s.call(0, n, m0=m0)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "call": i, "m0": cell.config["physics"]["m0"] if m0 is None else m0,
            "trajectories": s.start,
            "plaquette": float(np.mean(res.chains["plaquette"])),
            "plaquette_last": float(np.mean(res.chains["plaquette"][-1])),
            "cg_iters_per_chain_traj": res.cg_iters_total / (s.C * n),
            "unconverged": res.unconverged_chain_trajs,
            "fallback_solves": res.cg_fallback_solves,
            "acceptance": res.acceptance_rate, "seconds": dt}), flush=True)


def limits(cell, args, device):
    from hmc_bench import harness
    from hmc_bench.reference import lattice as ref

    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        out = {"seed": seed}
        for loose in ((False, True) if i < args.loose_seeds else (False,)):
            s = harness.Session(cell, seed, device, refine=False if loose else None)
            harness.thermalize(s)
            t0 = time.perf_counter()
            w = harness.window(s, args.n_meas)
            gaps = harness.compare(s, w, cell.limits["dH_gap"],
                                   {} if loose else ref.CONTROLS)
            if loose:
                out["loose"] = gaps["program"]
            else:
                out.update(gaps, window_s=w.seconds,
                           check_s=time.perf_counter() - t0 - w.seconds,
                           row=w.row, failed=harness.count_failed(s, w),
                           chain_trajs=s.C * s.trajectories(args.n_meas))
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    t = sub.add_parser("therm")
    t.add_argument("--workload", required=True)
    t.add_argument("--seed", type=int, default=1)
    t.add_argument("--calls", type=int, default=32)
    t.add_argument("--per-call", type=int, default=25)
    lim = sub.add_parser("limits")
    lim.add_argument("--workload", required=True)
    lim.add_argument("--seeds", required=True)
    lim.add_argument("--n-meas", type=int, default=12)
    lim.add_argument("--loose-seeds", type=int, default=0,
                     help="run the loose contract on this many of the seeds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from hmc_bench import registry

    cell = registry.cell(ROOT, args.workload)
    (therm if args.what == "therm" else limits)(cell, args, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
