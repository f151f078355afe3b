"""One row of tools/bench_points.py looked at chain by chain: which solves
of which chains did not converge.

A bench_points row carries one flag, ``all_converged``, over every solve of
every chain of its timed pass. This script runs the same point and contract
as the tool (``bench_points.run_packed``'s phases: the hot start, the anneal
masses, n_therm trajectories, the warm pass and the timed pass, with the
same seed and trajectory indices, so the same noise) and records, for every
pass, the chain-trajectories whose solves did not all converge, the chain
solves that ran K4's f64 CG inside K3's launch, and each unconverged
chain-trajectory's CG iterations, dH and accept decision. On a machine with
one CUDA card, from the repository root:

    python3 docs/near_critical_diag_torch.py 32x32_b2_m-0.19_tau1_hb refined_1e-10_f64 \
        [--n-therm 60] [--json OUT.json]

docs/near_critical_diag_torch.json holds the two refined near-critical
rows' runs (32x32 and 64x64), as a list of their --json outputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from schwingermodel_tpu_torch.runner import hot_start  # noqa: E402
from schwingermodel_tpu_torch.tools import bench_points as bp  # noqa: E402


def run_pass(model, theta, seed, stream, n, name, out):
    """n trajectories of the tool's stream; their per-chain record."""
    bad, fallbacks, acc, iters = [], 0, 0, 0
    for i in range(n):
        index = stream * bp.STREAM + i
        theta_new, st = bp._traj(model, theta, seed, index)
        conv = st.cg_converged.cpu()
        fallbacks += int(st.cg_fallbacks.sum())
        acc += int(st.accepted.sum())
        iters += int(st.cg_iters.sum())
        for c in torch.nonzero(~conv).flatten().tolist():
            bad.append({"trajectory": i, "chain": c, "cg_iters": int(st.cg_iters[c]),
                        "fallback_solves": int(st.cg_fallbacks[c]),
                        "delta_H": float(st.delta_H[c]), "accepted": bool(st.accepted[c])})
        theta = theta_new
    C = theta.shape[0]
    out.append({"pass": name, "m0": model.hmc.m0, "trajectories": n,
                "chain_trajectories_unconverged": len(bad),
                "chains_unconverged": sorted({b["chain"] for b in bad}),
                "fallback_chain_solves": fallbacks, "acceptance": acc / (n * C),
                "cg_iters_per_chain_traj": iters / (n * C), "unconverged": bad})
    print(json.dumps({k: v for k, v in out[-1].items() if k != "unconverged"}), flush=True)
    return theta


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 docs/near_critical_diag_torch.py")
    p.add_argument("point", help="a name of bench_points.POINTS")
    p.add_argument("contract", help="loose_f32_tol1e-6 or refined_1e-10_f64")
    p.add_argument("--n-therm", type=int, default=60)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    point = next(q for q in bp.POINTS if q[0] == args.point)
    _, _, _, _, m0, _, _, C, n_timed, _, max_iter, extras = point
    cg = dict(bp.contracts(extras, max_iter))[args.contract]
    model = bp.point_model(point, cg)
    seed, out = 0, []
    theta = hot_start(model.lattice, seed, C, torch.device("cuda"))
    for k, m0_a in enumerate(bp.anneal_schedule(m0)):
        m_a = dataclasses.replace(model, hmc=dataclasses.replace(model.hmc, m0=m0_a))
        theta = run_pass(m_a, theta, seed, bp.ANNEAL + k, args.n_therm, f"anneal {k}", out)
    theta = run_pass(model, theta, seed, bp.THERM, args.n_therm, "thermalization", out)
    run_pass(model, theta, seed, bp.WARM, n_timed, "warm", out)
    run_pass(model, theta, seed, bp.TIMED, n_timed, "timed", out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"point": args.point, "contract": args.contract, "passes": out}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
