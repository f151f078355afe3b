"""Beta-scan command-line tool.

Counterpart of ``schwingermodel_tpu/tools/betascan.py``: the reference's
validation study (HMC_doc.pdf Fig. 1: <P> against beta on 16x16) in one
command:

    python -m schwingermodel_tpu_torch.tools.betascan --nx 16 --nt 16 \\
        --betas 0.5:10:0.5 --quenched --nmeas 500

In quenched mode each point is checked against the exact 2D U(1) answer
I1(beta)/I0(beta). Output: a table on stdout and optionally ``--csv FILE``.
``--device {cuda,cpu}`` replaces ``--platform``; the working precision
defaults to float32 on the card and float64 on the CPU, as in JAX.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_betas(spec: str) -> np.ndarray:
    """'0.5,1,2' (list) or 'start:stop:step' (inclusive range)."""
    if ":" in spec:
        parts = [float(s) for s in spec.split(":")]
        if len(parts) != 3:
            raise ValueError("range spec must be start:stop:step")
        start, stop, step = parts
        n = int(round((stop - start) / step)) + 1
        return np.round(start + step * np.arange(n), 12)
    return np.asarray([float(s) for s in spec.split(",")])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.betascan",
        description="Average plaquette vs beta (HMC_doc.pdf Fig. 1 study)",
    )
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--nt", type=int, default=16)
    p.add_argument("--betas", default="0.5:10:0.5",
                   help="'a,b,c' list or 'start:stop:step' range")
    p.add_argument("--m0", type=float, default=0.2)
    p.add_argument("--md-steps", type=int, default=10)
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--ntherm", type=int, default=200)
    p.add_argument("--nmeas", type=int, default=200)
    p.add_argument("--nsteps", type=int, default=0)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--quenched", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=["float32", "float64"], default=None)
    p.add_argument("--csv", default=None, help="also write results as CSV")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but CUDA is not available", file=sys.stderr)
        return 1

    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.scan import run_beta_scan

    dtype = args.dtype or ("float32" if args.device == "cuda" else "float64")
    lattice = LatticeParams(Nx=args.nx, Nt=args.nt, real_dtype=dtype)
    even = not args.quenched and args.nx % 2 == 0 and args.nt % 2 == 0
    hmc = HMCParams(
        beta=1.0, m0=args.m0, md_steps=args.md_steps,
        trajectory_length=args.tau, quenched=args.quenched, even_odd=even,
        cg=CGParams(tol=1e-6 if dtype == "float32" else 1e-10),
    )
    betas = parse_betas(args.betas)
    print(f"# beta scan: {args.nx}x{args.nt}, m0={args.m0:g}, "
          f"{'quenched' if args.quenched else 'two-flavor'}, "
          f"{len(betas)} points, {args.nmeas} meas each", file=sys.stderr)

    res = run_beta_scan(
        lattice, hmc, betas,
        n_therm=args.ntherm, n_meas=args.nmeas, n_steps=args.nsteps,
        n_chains=args.chains, seed=args.seed, device=args.device,
        progress=lambda s: print(s, file=sys.stderr),
    )
    print(res.as_table())
    print(f"# elapsed: {res.elapsed_seconds:.1f} s", file=sys.stderr)

    if res.exact is not None:
        dev = np.abs(res.Ep - res.exact) / np.maximum(res.dEp, 1e-12)
        print(f"# quenched gate: max |Ep - I1/I0| = "
              f"{np.abs(res.Ep - res.exact).max():.2e} "
              f"(worst {dev.max():.1f} sigma)", file=sys.stderr)

    if args.csv:
        cols = [res.betas, res.Ep, res.dEp, res.acceptance]
        header = "beta,Ep,dEp,acceptance"
        if res.exact is not None:
            cols.append(res.exact)
            header += ",exact"
        np.savetxt(args.csv, np.column_stack(cols), delimiter=",",
                   header=header, comments="")
        print(f"# wrote {args.csv}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
