"""Tensor-core stencil experiment: does the packed solve get faster when its
x-shifts are matrix products?

Counterpart of ``schwingermodel_tpu/tools/bench_mxu_stencil.py``. There the
question was put to the TPU's matrix unit; here it is put to the H100's
tensor cores. Two whole-CG variants solve the same right-hand sides in
turns:

- ``cuda_shift``: K2 (``ops/traj.solve_fused``), every neighbour gathered
  by index;
- ``mma_xshift``: K10 (``ops/traj.solve_fused_mxu``), the x-neighbours from
  products with one-hot [Nx, Nx] matrices on the tensor cores, only the
  k-steps of the band of each row tile (3 of Nx/4; its row says how many).

    python -m schwingermodel_tpu_torch.tools.bench_mxu_stencil

At 64x64, C=32 chains, m0=0.2, tol 1e-6, max_iter 300 and x0 = b it solves
REP=50 right-hand sides made from ``--seed``, checks for each that the two
variants return equal flags and iteration counts and solutions within 2e-4
(the shifts are exact and the site arithmetic is shared, so bit for bit is
expected), and prints one JSON row per variant (microseconds per lockstep
iteration, the slowest chain's) and the verdict row. Times
are CUDA events around the REP launches of a variant; on ``--device cpu``
the plain twins run on the host's clock, and the rows say so in
``backend``. The result is written to ``--out PATH`` only when that is
given. A negative result is a result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.utils.metrics import card_label

M0, TOL, MAX_ITER = 0.2, 1e-6, 300     # the solve, as the JAX tool fixes it
X_GATE = 2e-4


def _inputs(seed, rep, C, Nx, Nt, device):
    """Angles of both parities, REP right-hand sides; the draws of the JAX
    tool in the port's chain-major layout."""
    Nth = Nt // 2
    rng = np.random.default_rng(seed)
    thE, thO = (torch.from_numpy(
        rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nth)).astype(np.float32)).to(device)
        for _ in range(2))
    bs = torch.from_numpy(
        rng.standard_normal((rep, C, 2, 2, Nx, Nth)).astype(np.float32)).to(device)
    return thE, thO, bs


def _timed(solve, bs, device):
    """Solve every right-hand side, timed as a whole; (seconds, results)."""
    if device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        t0.record()
        out = [solve(b) for b in bs]
        t1.record()
        torch.cuda.synchronize(device)
        return 1e-3 * t0.elapsed_time(t1), out
    t0 = time.perf_counter()
    out = [solve(b) for b in bs]
    return time.perf_counter() - t0, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_mxu_stencil",
        description="K2 against K10: the x-shifts of the stencil as "
                    "tensor-core products")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--chains", type=int, default=32)
    p.add_argument("--rep", type=int, default=50, help="right-hand sides")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the verdict as JSON")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    if device.type == "cuda":
        # the twin and the checks use plain f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
    thE, thO, bs = _inputs(args.seed, args.rep, args.chains, args.nx, args.nt,
                           device)
    kw = dict(m0=M0, tol=TOL, max_iter=MAX_ITER)
    variants = (("cuda_shift", tr.solve_fused), ("mma_xshift", tr.solve_fused_mxu))
    card = card_label(device)
    backend = ("cuda kernels" if device.type == "cuda"
               else "plain PyTorch twins on the CPU (host clock)")

    rows, results = [], {}
    for name, fn in variants:
        # one untimed pass over every right-hand side first (the build, the
        # allocator, the card's clocks), as the JAX tool runs its scan twice
        _timed(lambda b: fn(thE, thO, b, b, **kw), bs, device)
        seconds, out = _timed(lambda b: fn(thE, thO, b, b, **kw), bs, device)
        iters = torch.stack([o.iters for o in out])            # [REP, C]
        lockstep = iters.max(dim=1).values                     # per solve
        results[name] = out
        us = 1e6 * seconds / max(int(lockstep.sum()), 1)
        row = {"metric": "cg_us_per_lockstep_iter", "variant": name,
               "value": round(us, 3), "unit": "us/iter",
               "us_per_iteration": us, "lockstep_iters": int(lockstep[0]),
               "shape": f"{args.nx}x{args.nt} C={args.chains}",
               "backend": backend, "card": card}
        if name == "mma_xshift":
            # m8n8k4 steps a row tile of 8 x-rows runs for each product,
            # against the dense product's
            row["k_steps_per_row_tile"] = len(tr.mxu_band_tiles(+1, 0, args.nx))
            row["k_steps_per_row_tile_dense"] = (args.nx + 3) // 4
        rows.append(row)
        print(json.dumps(row), flush=True)

    # per right-hand side: equal flags and iterations, x within the gate
    max_dx, bitwise = 0.0, True
    for i, (a, b) in enumerate(zip(results["cuda_shift"], results["mma_xshift"])):
        if not (torch.equal(a.converged, b.converged)
                and torch.equal(a.iters, b.iters)):
            print(f"error: right-hand side {i}: flags or iterations differ: "
                  f"{a.iters.tolist()} vs {b.iters.tolist()}", file=sys.stderr)
            return 1
        max_dx = max(max_dx, float((a.x - b.x).abs().max()))
        bitwise = bitwise and torch.equal(a.x, b.x)
    if not max_dx <= X_GATE:
        print(f"error: solutions differ by {max_dx} (gate {X_GATE})",
              file=sys.stderr)
        return 1

    verdict = {
        "metric": "mxu_stencil_experiment",
        "speedup_mxu_over_vpu": round(rows[0]["value"] / rows[1]["value"], 3),
        "max_abs_dx": max_dx, "bit_for_bit": bitwise,
        "all_converged": bool(torch.stack(
            [o.converged for o in results["mma_xshift"]]).all()),
        "rows": rows,
    }
    print(json.dumps(verdict), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
