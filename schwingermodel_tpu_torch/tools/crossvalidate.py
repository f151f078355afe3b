"""Statistical cross-validation against the compiled C++ reference.

Counterpart of ``schwingermodel_tpu/tools/crossvalidate.py``: the same
flags, defaults, gates, row keys, table layout and exit status, over the
port's ``runner.run_hmc``. The golden data (tests/golden/refphys.json,
from the reference binary) carries <P> +- jackknife error and the
acceptance rate of 17 points: 8x8 and 16x16 at beta = 1..6, m0 = 0.2, the
near-critical beta=2, m0=-0.19 at 8, 16 and 32, 32x32 at beta=2 and the
64x64 demo point (reference README.md:100-111; HMC_doc.pdf Fig. 1).

Every point is re-run with the golden's MD parameters; the plaquette is
gated at ``--n-sigma`` 2 (combined jackknife errors) and the acceptance at
``--n-sigma-acc`` 3 binomial sigma, inflated by sqrt(2 tau_int) of the
plaquette series. Different RNGs mean the observables match only in
distribution, which is the reference's own notion of equality.

    python -m schwingermodel_tpu_torch.tools.crossvalidate              # all points
    python -m schwingermodel_tpu_torch.tools.crossvalidate --lattice 8  # 8x8 only
    ... --even-odd --plaquette-only --json out.json --markdown table.md
    ... --from-json a.json b.json --markdown table.md                   # assemble

``--device {cuda,cpu}`` (default cuda) replaces ``--platform``; the
working precision defaults to float32 with the refined 1e-10 contract on
the card and float64 on the CPU, as the JAX tool's TPU/CPU split. Each row
adds one key to JAX's, ``device``: the card's name and power limit as
nvidia-smi gives them (``seconds`` is a time on that card). A configuration
whose solve failed is dumped to the working directory (RunParams.out_dir).

Exit status 0 iff every point passes both gates.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

GOLDEN_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden", "refphys.json")


def compare_point(ref: dict, args) -> dict:
    """Run one golden point through run_hmc on args.device; the row of
    JAX's compare_point plus ``device``."""
    import torch

    from schwingermodel_tpu_torch.config import (
        CGParams, HMCParams, LatticeParams, RunParams,
    )
    from schwingermodel_tpu_torch.runner import run_hmc
    from schwingermodel_tpu_torch.utils import statistics as st
    from schwingermodel_tpu_torch.utils.metrics import card_label

    device = torch.device(args.device)
    dtype = args.dtype
    nmeas = args.nmeas or ref["nmeas"]
    lattice = LatticeParams(Nx=ref["Nx"], Nt=ref["Nt"], real_dtype=dtype)
    hmc = HMCParams(
        beta=ref["beta"], m0=ref["m0"],
        md_steps=args.md_steps or ref["md_steps"],
        trajectory_length=ref["tau"], even_odd=args.even_odd,
        integrator=args.integrator,
        hasenbusch_dm=args.hasenbusch_dm,
        cg=CGParams(tol=1e-10 if (dtype == "float64" or args.refine) else 1e-6,
                    max_iter=10000, refine=args.refine),
    )
    run = RunParams(n_therm=ref["ntherm"], n_meas=nmeas,
                    n_steps=ref["nsteps"], n_chains=args.chains,
                    seed=args.seed)
    res = run_hmc(lattice, hmc, run, device=device)

    # per-measurement chain means -> 20-bin jackknife, as the reference
    # (src/hmc.cpp:213-214) and the runner summary
    n_upd = nmeas * (1 + ref["nsteps"]) * max(args.chains, 1)

    sig = float(np.sqrt(ref["dEp"] ** 2 + res.dEp ** 2))
    dev = float(abs(res.Ep - ref["Ep"]))
    # acceptance: binomial errors from both runs, inflated by the
    # autocorrelation of the plaquette series, which carries the same slow
    # mode (near the critical mass tau_int >> 1). The series is the
    # [n_meas, n_chains] array flattened, in JAX's order.
    tau = max(1.0, float(st.autocorrelation_time(
        np.asarray(res.chains["plaquette"]).reshape(-1))))
    infl = float(np.sqrt(2.0 * tau))
    n_ref = ref["nmeas"] * (1 + ref["nsteps"])
    p_r, p_o = ref["acceptance"], res.acceptance_rate
    sig_acc = infl * float(
        np.sqrt(p_r * (1 - p_r) / n_ref + p_o * (1 - p_o) / n_upd))
    dev_acc = float(abs(p_o - p_r))
    plaquette_only = getattr(args, "plaquette_only", False)
    return {
        "Nx": ref["Nx"], "Nt": ref["Nt"], "beta": ref["beta"], "m0": ref["m0"],
        "ref_Ep": ref["Ep"], "ref_dEp": ref["dEp"],
        "Ep": res.Ep, "dEp": res.dEp,
        "n_sigma_Ep": dev / sig if sig else float("inf"),
        "ref_acceptance": p_r, "acceptance": p_o,
        "n_sigma_acc": dev_acc / sig_acc if sig_acc else float("inf"),
        "pass_Ep": dev <= args.n_sigma * sig,
        # --plaquette-only (even-odd runs): the acceptance is a property of
        # the full-D action's algorithm and not comparable; recorded ungated
        "acc_gated": not plaquette_only,
        "pass_acc": (None if plaquette_only
                     else dev_acc <= args.n_sigma_acc * sig_acc),
        "seconds": res.elapsed_seconds,
        "nmeas": nmeas, "chains": args.chains, "dtype": dtype,
        "refine": args.refine, "even_odd": args.even_odd,
        "md_steps": args.md_steps or ref["md_steps"],
        "hasenbusch_dm": args.hasenbusch_dm,
        "n_ill": res.n_ill,
        "backend": device.type,
        "device": card_label(device),
    }


def _row_ok(r) -> bool:
    return r["pass_Ep"] and (r["pass_acc"] if r["acc_gated"] else True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.crossvalidate",
        description="2-sigma physics gate vs the compiled C++ reference")
    p.add_argument("--golden", default=GOLDEN_DEFAULT)
    p.add_argument("--lattice", type=int, default=None,
                   help="restrict to NxN points")
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--m0", type=float, default=None)
    p.add_argument("--nmeas", type=int, default=None,
                   help="override measurement count (default: match golden)")
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--dtype", choices=["float32", "float64"], default=None)
    p.add_argument("--refine", action="store_true", default=None,
                   help="mixed-precision 1e-10 solves on f32 (default on)")
    p.add_argument("--no-refine", dest="refine", action="store_false")
    p.add_argument("--even-odd", dest="even_odd", action="store_true",
                   default=False,
                   help="use the even-odd preconditioned action (faster, "
                        "same gauge distribution -- plaquette gate valid). "
                        "Default OFF: acceptance is an ALGORITHM property "
                        "and only comparable to the reference with its "
                        "full-D pseudofermion action")
    p.add_argument("--plaquette-only", action="store_true",
                   help="gate only the plaquette (use with --even-odd: "
                        "acceptance is an algorithm property of the FULL-D "
                        "action and is not comparable under the Schur-"
                        "preconditioned pseudofermions)")
    p.add_argument("--hasenbusch-dm", type=float, default=None,
                   help="run with Hasenbusch mass preconditioning (two "
                        "pseudofermions at auxiliary mass m0+DM); forces "
                        "--plaquette-only -- the acceptance is a property "
                        "of the improved algorithm, not the reference's")
    p.add_argument("--md-steps", type=int, default=None,
                   help="override the golden's MD step count (sensible "
                        "with --hasenbusch-dm: the split needs fewer)")
    p.add_argument("--integrator", choices=["leapfrog", "omelyan"],
                   default="leapfrog")
    p.add_argument("--skip", default=None,
                   help="comma list of points to skip, each 'Nx:beta:m0' "
                        "or 'Nx:beta:m0:md_steps'")
    p.add_argument("--from-json", nargs="+", default=None, metavar="J",
                   help="merge previously produced row json files and "
                        "write --markdown/--json WITHOUT running anything "
                        "(assembling tables from per-algorithm runs)")
    p.add_argument("--n-sigma", type=float, default=2.0)
    p.add_argument("--n-sigma-acc", type=float, default=3.0,
                   help="acceptance gate (binomial, autocorrelation slack)")
    p.add_argument("--json", default=None)
    p.add_argument("--markdown", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--platform", default=None,
                   help="dropped: use --device {cuda,cpu}")
    args = p.parse_args(argv)
    if args.platform is not None:
        print("error: dropped in schwingermodel_tpu_torch: --platform "
              "(use --device {cuda,cpu})", file=sys.stderr)
        return 2
    if args.hasenbusch_dm is not None:
        args.plaquette_only = True
    if args.dtype is None:
        args.dtype = "float32" if args.device == "cuda" else "float64"
    if args.refine is None:
        args.refine = args.dtype == "float32"

    if args.from_json:
        rows = []
        for path in args.from_json:
            with open(path) as f:
                rows.extend(json.load(f))
        ok = all(_row_ok(r) for r in rows)
        _write_outputs(args, rows, ok)
        print("ALL PASS" if ok else "FAILURES PRESENT")
        return 0 if ok else 1

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but CUDA is not available", file=sys.stderr)
        return 1

    with open(args.golden) as f:
        points = json.load(f)
    if args.lattice:
        points = [r for r in points if r["Nx"] == args.lattice]
    if args.beta is not None:
        points = [r for r in points if r["beta"] == args.beta]
    if args.m0 is not None:
        points = [r for r in points if r["m0"] == args.m0]
    if args.skip:
        skips = set()
        for spec in args.skip.split(","):
            parts = spec.split(":")
            skips.add((int(parts[0]), float(parts[1]), float(parts[2]),
                       int(parts[3]) if len(parts) > 3 else None))

        def skipped(r):
            return any(
                r["Nx"] == nx and r["beta"] == b and r["m0"] == m
                and (md is None or r["md_steps"] == md)
                for (nx, b, m, md) in skips)

        points = [r for r in points if not skipped(r)]

    rows = []
    ok = True
    hdr = (f"{'lattice':>8} {'beta':>5} {'m0':>6} | {'Ep(ref)':>10} "
           f"{'Ep(this)':>10} {'nsig':>5} | {'acc(ref)':>8} {'acc(this)':>8} "
           f"{'nsig':>5} | verdict")
    print(hdr)
    print("-" * len(hdr))
    for ref in points:
        r = compare_point(ref, args)
        rows.append(r)
        ok &= _row_ok(r)
        v = "PASS" if _row_ok(r) else "FAIL"
        print(f"{r['Nx']}x{r['Nt']:<5} {r['beta']:>5g} {r['m0']:>6g} | "
              f"{r['ref_Ep']:>10.6f} {r['Ep']:>10.6f} {r['n_sigma_Ep']:>5.2f} | "
              f"{r['ref_acceptance']:>8.3f} {r['acceptance']:>8.3f} "
              f"{r['n_sigma_acc']:>5.2f} | {v}", flush=True)

    _write_outputs(args, rows, ok)
    print("ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


def _write_outputs(args, rows, ok):
    """--json: the rows; --markdown: JAX's table, its header naming the
    card (the rows' ``device``) where the rows carry one."""
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    if args.markdown:
        backend = rows[0].get("backend", "?") if rows else "?"
        card = rows[0].get("device") if rows else None
        if card and card != backend:
            backend = f"{backend} ({card})"
        dtype = rows[0].get("dtype", args.dtype) if rows else args.dtype
        any_hb = any(r.get("hasenbusch_dm") for r in rows)
        with open(args.markdown, "w") as f:
            f.write("# Cross-validation vs the C++ reference\n\n")
            acc_note = (
                "; acceptance columns are informational only (ungated: the "
                "Schur-preconditioned action's acceptance is not comparable "
                "to the full-D reference)"
                if getattr(args, "plaquette_only", False) or any_hb else
                f", |Δacc| ≤ {args.n_sigma_acc:g}σ (binomial)")
            f.write(f"Framework: dtype={dtype}, refine={rows[0].get('refine') if rows else args.refine}, "
                    f"even_odd={rows[0].get('even_odd') if rows else args.even_odd}, "
                    f"backend={backend}."
                    f" Gate: |ΔEp| ≤ {args.n_sigma:g}σ (combined jackknife)"
                    f"{acc_note}.\n\n")
            if any_hb:
                f.write("`hb` rows run Hasenbusch mass preconditioning "
                        "(two pseudofermions; --hasenbusch-dm) with their "
                        "own md_steps -- the near-critical regime where "
                        "the reference's single-pseudofermion algorithm "
                        "loses ergodicity (its own 32x32 md=20 golden sits "
                        "at acceptance 0.002).\n\n")
            f.write("| lattice | β | m0 | alg | Ep (reference) | Ep (this) "
                    "| nσ | acc (ref) | acc (this) | verdict |\n")
            f.write("|---|---|---|---|---|---|---|---|---|---|\n")
            for r in rows:
                v = "PASS" if _row_ok(r) else "FAIL"
                alg = (f"hb dm={r['hasenbusch_dm']:g} "
                       f"md={r.get('md_steps', '?')}"
                       if r.get("hasenbusch_dm") else "ref")
                f.write(f"| {r['Nx']}x{r['Nt']} | {r['beta']:g} | {r['m0']:g} "
                        f"| {alg} "
                        f"| {r['ref_Ep']:.6f} ± {r['ref_dEp']:.6f} "
                        f"| {r['Ep']:.6f} ± {r['dEp']:.6f} "
                        f"| {r['n_sigma_Ep']:.2f} "
                        f"| {r['ref_acceptance']:.3f} | {r['acceptance']:.3f} "
                        f"| {v} |\n")


if __name__ == "__main__":
    sys.exit(main())
