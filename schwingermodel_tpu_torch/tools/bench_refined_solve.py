"""Times of the refined solve (K3) on the card.

    python -m schwingermodel_tpu_torch.tools.bench_refined_solve \\
        [--nx 64 --nt 64 --chains 32,128] [--against DIR] [--out PATH]

For each chain count it solves three inputs made from ``--seed`` at m0 =
0.2: the cold certified solve (x0 = b, tol 1e-10), the force solve of the
main path (certify=False, tol 1e-8, from a forecast start: the certified
solution perturbed by 1e-3) and the same force solve from the MRE forecast
over a history of four such starts. It prints one JSON row per input with
the kernel's milliseconds by CUDA events (turns of ``--reps`` launches, no
clock read in the kernel), the CG iterations summed over the chains and of
the slowest chain, microseconds per iteration of the slowest chain, the
shares of the kernel's clock cycles spent in the f64 true residuals, waiting
on the chain's other blocks and in the MRE forecast (means over the
chains, from one more launch with the kernel's own counters on; the last
also as microseconds of the launch, ``mre_us``), the
path the lattice size and chain count take on this card and its waves a
launch (``ops/refined.ru_card_route``).

``--against DIR`` also imports the port of the checkout at DIR (e.g. a
``git archive`` of an earlier commit) beside this one, its wrapper with its
own kernel library, built under DIR, so that a K3 with another launch
interface compares too, and times its K3 in turns with this one (theirs,
ours, ours, theirs) on the same inputs, and says whether x64, the
iterations, the fallback's iterations and the flags are the same bits.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
from pathlib import Path

import torch

from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.utils.metrics import card_label

M0 = 0.2
# label, tol, certify, start
INPUTS = (("cold certified 1e-10", 1e-10, True, "b"),
          ("forecast force 1e-8", 1e-8, False, "forecast"),
          ("MRE K=4 force 1e-8", 1e-8, False, "history"))
HISTORY = 4


def _timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _their_refined(root: Path):
    """``ops.refined`` of the port at `root`, imported as a package of its own
    (its wrappers and kernel library; this process's modules are put back)."""
    pkg = "schwingermodel_tpu_torch"

    def loaded():
        return {k: m for k, m in sys.modules.items() if k == pkg or k.startswith(pkg + ".")}

    ours = loaded()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        mod = importlib.import_module(pkg + ".ops.refined")
    finally:
        sys.path.remove(str(root))
        for k in loaded():
            del sys.modules[k]
        sys.modules.update(ours)
    return mod


def _share(clocks, col):
    return float((clocks[:, col].double() / clocks[:, 0].double()).mean())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_refined_solve",
        description="K3 on the card: times, iterations, the f64, wait and MRE shares")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--chains", default="32,128", help="chain counts, comma-separated")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20, help="launches per timing")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="a checkout whose K3 is timed in turns with this one")
    p.add_argument("--out", default=None, metavar="PATH", help="also write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label(dev)
    theirs = None
    if args.against:
        theirs = _their_refined(Path(args.against).resolve())
        theirs._cuda.KERNELS.build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []

    for C in (int(c) for c in args.chains.split(",")):
        th = (2.0 * torch.rand((C, 2, args.nx, args.nt), generator=gen, device=dev)
              - 1.0) * math.pi
        thE, thO = tr.pack_planes(th)
        b = torch.randn((C, 2, 2, args.nx, args.nt // 2), generator=gen, device=dev)
        exact = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10)
        scale = 1e-3 * exact.x.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
        near = [exact.x + scale * torch.randn(b.shape, generator=gen, device=dev)
                for _ in range(HISTORY)]
        starts = {"b": b, "forecast": near[0], "history": torch.stack(near)}
        for label, tol, certify, start in INPUTS:
            x0 = starts[start]

            def solve(clocks=None, mod=rs):
                return mod.solve_refined(thE, thO, b, x0, m0=M0, tol=tol,
                                         certify=certify, clocks=clocks)

            def solve_theirs():
                return solve(mod=theirs)

            clocks = torch.zeros((C, 4), dtype=torch.int64, device=dev)
            sol = solve(clocks)
            it_max = int(sol.iters.max())
            path, n, waves = rs.ru_card_route(args.nx, args.nt // 2, C, dev)
            row = {"metric": "k3_ms", "input": label,
                   "shape": f"{args.nx}x{args.nt} C={C}",
                   "path": rs.ru_route_name(path, n), "waves": waves,
                   "card": card}
            if theirs is None:
                turns = [_timed(solve, args.reps) for _ in range(2)]
            else:
                ref = solve_theirs()
                against = [_timed(solve_theirs, args.reps)]
                turns = [_timed(solve, args.reps) for _ in range(2)]
                against.append(_timed(solve_theirs, args.reps))
                ms_against = sum(against) / 2
                row.update({
                    "against": args.against, "against_ms": ms_against,
                    "against_turns_ms": against,
                    "against_us_per_iter": 1e3 * ms_against / max(int(ref.iters.max()), 1),
                    "bits_equal": {
                        "x64": torch.equal(sol.x64, ref.x64),
                        "iters": torch.equal(sol.iters, ref.iters),
                        "fb_iters": torch.equal(sol.fb_iters, ref.fb_iters),
                        "conv": torch.equal(sol.converged, ref.converged)}})
            ms = sum(turns) / 2
            row.update({
                "ms": ms, "turns_ms": turns,
                "iters_sum": int(sol.iters.sum()), "iters_max": it_max,
                "us_per_iter": 1e3 * ms / max(it_max, 1),
                "f64_residual_share": _share(clocks, 1),
                "cluster_wait_pct": 100.0 * _share(clocks, 2),
                "mre_pct": 100.0 * _share(clocks, 3),
                "mre_us": 1e3 * ms * _share(clocks, 3),
                "all_converged": bool(sol.converged.all())})
            if theirs is not None:
                row["speedup"] = row["against_ms"] / ms
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
