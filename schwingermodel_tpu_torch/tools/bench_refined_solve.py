"""Times of the refined solve (K3) on the card.

    python -m schwingermodel_tpu_torch.tools.bench_refined_solve \\
        [--nx 64 --nt 64 --chains 32,128] [--out PATH]

For each chain count it solves two inputs made from ``--seed`` at m0 = 0.2:
the cold certified solve (x0 = b, tol 1e-10) and the force solve of the
main path (certify=False, tol 1e-8, from a forecast start: the certified
solution perturbed by 1e-3). It prints one JSON row per input with the
kernel's milliseconds by CUDA events (two turns of ``--reps`` launches, no
clock read in the kernel), the CG iterations summed over the chains and of
the slowest chain, microseconds per iteration of the slowest chain, the
share of the kernel's clock cycles spent in the f64 true residuals (mean
over the chains, from one more launch with the kernel's own counters on)
and the path the lattice size and chain count take on this card
(``ops/refined.ru_path``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from schwingermodel_tpu_torch.ops import _cuda
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.utils.metrics import card_label

M0 = 0.2
INPUTS = (("cold certified 1e-10", 1e-10, True), ("forecast force 1e-8", 1e-8, False))


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_refined_solve",
        description="K3 on the card: times, iterations, the f64 share")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--chains", default="32,128", help="chain counts, comma-separated")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20, help="launches per timing")
    p.add_argument("--out", default=None, metavar="PATH", help="also write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []

    for C in (int(c) for c in args.chains.split(",")):
        th = (2.0 * torch.rand((C, 2, args.nx, args.nt), generator=gen, device=dev)
              - 1.0) * math.pi
        thE, thO = tr.pack_planes(th)
        b = torch.randn((C, 2, 2, args.nx, args.nt // 2), generator=gen, device=dev)
        exact = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10)
        forecast = exact.x + 1e-3 * exact.x.abs().amax(
            dim=(1, 2, 3, 4), keepdim=True) * torch.randn(b.shape, generator=gen, device=dev)
        for label, tol, certify in INPUTS:
            x0 = b if certify else forecast
            clocks = torch.zeros((C, 2), dtype=torch.int64, device=dev)
            sol = rs.solve_refined(thE, thO, b, x0, m0=M0, tol=tol, certify=certify,
                                   clocks=clocks)
            turns = [_timed(lambda: rs.solve_refined(thE, thO, b, x0, m0=M0, tol=tol,
                                                     certify=certify), args.reps)
                     for _ in range(2)]
            ms = sum(turns) / 2
            it_max = int(sol.iters.max())
            row = {"metric": "k3_ms", "input": label,
                   "shape": f"{args.nx}x{args.nt} C={C}",
                   "path": rs.ru_path_name(args.nx, args.nt // 2, C, _cuda.sm_count(dev)),
                   "card": card, "ms": ms, "turns_ms": turns,
                   "iters_sum": int(sol.iters.sum()), "iters_max": it_max,
                   "us_per_iter": 1e3 * ms / max(it_max, 1),
                   "f64_residual_share": float(
                       (clocks[:, 1].double() / clocks[:, 0].double()).mean()),
                   "all_converged": bool(sol.converged.all())}
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
