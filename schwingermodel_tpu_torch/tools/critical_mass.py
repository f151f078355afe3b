"""Locate the critical mass m_crit(beta) from the PCAC quark mass.

Counterpart of ``schwingermodel_tpu/tools/critical_mass.py``: the physics
behind the reference's critical-mass table (README.md:100-111, quoted from
Christian/Jansen/Nagai/Pollakowski, Nucl. Phys. B 739 (2006)). Scan m0 at
fixed beta, measure the PCAC quark mass m_PCAC = d_t C_A0P / (2 C_PP) from
point-source correlators (observables.meson_correlators) on decorrelated
configurations, and extrapolate m_PCAC(m0) -> 0 linearly. For Wilson
fermions m_PCAC vanishes at m0 = m_crit, linearly up to O(a) artifacts.

On the card the trajectories run on the packed path (hmc/packed.py: K1 and
K3, C chains together, f32 under the 1e-10 refined contract) and the
correlator solves through dirac_inverse (K6, K9, K4); on the CPU in f64 on
the unpacked sampler. The hot start comes from the generator of --seed
(runner.hot_start); each stream (the two annealing runs, the
thermalization, each block) takes its own range of trajectory indices, so
no two trajectories share noise.

    python -m schwingermodel_tpu_torch.tools.critical_mass \\
        --beta 2 --nx 16 --nt 16 --chains 16 --md-steps 36 \\
        --m0-list=-0.18,-0.16,-0.14,-0.12,-0.10 \\
        --json docs/critical_mass_torch_b2.json --markdown table.md

``--device {cuda,cpu}`` (default cuda); the summary adds one key to JAX's,
``device``: the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

# the reference's critical-mass table (README.md:100-111, from
# Christian/Jansen/Nagai/Pollakowski, Nucl. Phys. B 739 (2006))
LITERATURE = {1.0: (-0.3204, 0.0007), 2.0: (-0.1968, 0.0009),
              3.0: (-0.1351, 0.0002), 4.0: (-0.1033, 0.0001),
              5.0: (-0.0840, 0.0001), 6.0: (-0.0719, 0.0001)}


def jackknife_bins(samples: np.ndarray, n_bins: int = 20):
    """[n, ...] -> [n_bins, ...] leave-one-bin-out means."""
    n = (samples.shape[0] // n_bins) * n_bins
    s = samples[:n].reshape(n_bins, -1, *samples.shape[1:])
    bin_means = s.mean(axis=1)
    total = bin_means.mean(axis=0)
    return total, np.array([
        (total * n_bins - bin_means[i]) / (n_bins - 1)
        for i in range(n_bins)])


def pcac_plateau(C_PP: np.ndarray, C_A0P: np.ndarray, window):
    """Plateau-averaged m_PCAC with jackknife error from per-measurement
    correlators [n, Nt]."""
    from schwingermodel_tpu_torch.observables import pcac_mass

    n_bins = min(20, max(4, C_PP.shape[0] // 4))
    _, pp_jk = jackknife_bins(C_PP, n_bins)
    _, ap_jk = jackknife_bins(C_A0P, n_bins)
    t0, t1 = window
    # nanmean: pcac_mass masks C_PP <= 0 noise artifacts as NaN instead of
    # letting them flip the ratio's sign
    vals = np.array([
        np.nanmean(pcac_mass(pp_jk[i], ap_jk[i])[t0:t1])
        for i in range(pp_jk.shape[0])])
    center = np.nanmean(
        pcac_mass(C_PP.mean(axis=0), C_A0P.mean(axis=0))[t0:t1])
    err = float(np.sqrt((n_bins - 1) * np.var(vals)))
    return float(center), err


def fit_zero_crossing(m0s, ms, errs):
    """Weighted linear fit m_PCAC = a (m0 - m_crit); returns
    (m_crit, err, slope)."""
    w = 1.0 / np.maximum(np.asarray(errs), 1e-12) ** 2
    x = np.asarray(m0s)
    y = np.asarray(ms)
    S, Sx, Sy = w.sum(), (w * x).sum(), (w * y).sum()
    Sxx, Sxy = (w * x * x).sum(), (w * x * y).sum()
    D = S * Sxx - Sx * Sx
    a = (S * Sxy - Sx * Sy) / D          # slope
    b = (Sxx * Sy - Sx * Sxy) / D        # intercept
    var_a = S / D
    var_b = Sxx / D
    cov_ab = -Sx / D
    m_crit = -b / a
    # error propagation for -b/a
    err = abs(m_crit) * np.sqrt(
        var_b / b ** 2 + var_a / a ** 2 - 2 * cov_ab / (a * b))
    return float(m_crit), float(err), float(a)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.critical_mass")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--nt", type=int, default=16)
    # the subcritical side only (m0 > m_crit = -0.1968): beyond the
    # critical mass Wilson HMC sits on exceptional configurations and the
    # PCAC signal drowns; the zero crossing extrapolates linearly from
    # m_q > 0 as in the reference's source (Nucl. Phys. B 739)
    p.add_argument("--m0-list", default="-0.18,-0.16,-0.14,-0.12,-0.10")
    p.add_argument("--md-steps", type=int, default=20)
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--chains", type=int, default=8)
    p.add_argument("--n-therm", type=int, default=200)
    p.add_argument("--n-blocks", type=int, default=40,
                   help="measurement blocks (one correlator set per chain "
                        "per block)")
    p.add_argument("--n-skip", type=int, default=5,
                   help="decorrelation trajectories between blocks")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--min-acceptance", type=float, default=0.5,
                   help="points below this acceptance are reported but "
                        "excluded from the zero-crossing fit (stuck "
                        "chains bias the plateau)")
    p.add_argument("--json", default=None)
    p.add_argument("--markdown", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but CUDA is not available", file=sys.stderr)
        return 1

    from schwingermodel_tpu_torch import observables as obs
    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.hmc import packed as hp
    from schwingermodel_tpu_torch.hmc import sampler
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.runner import hot_start
    from schwingermodel_tpu_torch.utils.metrics import card_label

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    Nx, Nt, C = args.nx, args.nt, args.chains
    lat = LatticeParams(
        Nx=Nx, Nt=Nt, real_dtype="float32" if on_card else "float64")

    def run_point(m0: float):
        cg = CGParams(tol=1e-10, max_iter=20000, refine=on_card)
        model = SchwingerModel(lattice=lat, hmc=HMCParams(
            beta=args.beta, m0=m0, md_steps=args.md_steps,
            trajectory_length=args.tau, even_odd=True, cg=cg))
        step = (hp.hmc_trajectory_packed if hp.packed_eligible(model)
                else sampler.hmc_trajectory)
        th = hot_start(lat, args.seed, C, device)
        next_index = 0

        def block(th, model, n):
            """n trajectories on the next n indices; the accepted count
            stays on the device until the caller reads it."""
            nonlocal next_index
            acc = torch.zeros((), dtype=torch.int64, device=device)
            for i in range(next_index, next_index + n):
                th, st = step(model, th, args.seed, i)
                acc += st.accepted.sum()
            next_index += n
            return th, acc

        # anneal the thermalization through a safe mass (hot starts near
        # m_crit otherwise stick on exceptional configurations)
        if m0 < -0.05 and hp.packed_eligible(model):
            for m0_a in (0.0, m0 / 2):
                m_a = dataclasses.replace(
                    model, hmc=dataclasses.replace(model.hmc, m0=m0_a))
                th, a_ = block(th, m_a, args.n_therm // 2)
                int(a_)
        th, acc = block(th, model, args.n_therm)
        acc_count = int(acc)
        pps, aps = [], []
        all_conv = True
        for _ in range(args.n_blocks):
            th, acc = block(th, model, args.n_skip)
            acc_count += int(acc)
            r = obs.meson_correlators(model, th)
            all_conv &= bool(r.converged.all())
            pps.append(r.C_PP.cpu().numpy())
            aps.append(r.C_A0P.cpu().numpy())
        n_traj = (args.n_therm + args.n_blocks * args.n_skip) * C
        acc_rate = acc_count / n_traj
        C_PP = np.concatenate(pps, axis=0)
        C_A0P = np.concatenate(aps, axis=0)
        window = (3, max(5, Nt // 2 - 1))
        m, err = pcac_plateau(C_PP, C_A0P, window)
        return m, err, acc_rate, all_conv

    m0s = [float(x) for x in args.m0_list.split(",")]
    rows = []
    for m0 in m0s:
        m, err, acc, conv = run_point(m0)
        row = {"m0": m0, "m_pcac": m, "err": err,
               "acceptance": round(acc, 3), "all_converged": conv}
        rows.append(row)
        print(json.dumps(row), flush=True)

    fit_rows = [r for r in rows
                if r["acceptance"] >= args.min_acceptance]
    dropped = [r["m0"] for r in rows if r not in fit_rows]
    m_crit, m_err, slope = fit_zero_crossing(
        [r["m0"] for r in fit_rows], [r["m_pcac"] for r in fit_rows],
        [r["err"] for r in fit_rows])
    lit = LITERATURE.get(float(args.beta))
    card = card_label(device)
    summary = {
        "metric": "critical_mass",
        "beta": args.beta, "lattice": f"{Nx}x{Nt}",
        "m_crit": round(m_crit, 5), "err": round(m_err, 5),
        "slope": round(slope, 4),
        "fit_points": len(fit_rows),
        "dropped_low_acceptance": dropped,
        "literature": {"m_crit": lit[0] if lit else None,
                       "err": lit[1] if lit else None,
                       "source": "reference README.md:100-111 "
                                 "(Nucl. Phys. B 739 (2006))"},
        "rows": rows,
        "device": card,
    }
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    if args.markdown:
        numerics = ("f32 + 1e-10 native f64 refinement, packed path"
                    if on_card else "f64, unpacked sampler")
        with open(args.markdown, "w") as f:
            f.write(f"# Critical mass at beta = {args.beta:g}\n\n")
            f.write(
                f"PCAC quark-mass scan on {Nx}x{Nt} ({numerics}, {C} chains; "
                f"md_steps={args.md_steps}, tau={args.tau:g}; {card}).\n\n"
                "| m0 | m_PCAC | err | acceptance |\n|---|---|---|---|\n")
            for r in rows:
                f.write(f"| {r['m0']:g} | {r['m_pcac']:.5f} | "
                        f"{r['err']:.5f} | {r['acceptance']:.3f} |\n")
            lit_s = (f"{lit[0]:g}({round(lit[1] * 1e4):g}e-4)" if lit
                     else "n/a")
            f.write(
                f"\nLinear zero crossing: **m_crit = {m_crit:.4f} +- "
                f"{m_err:.4f}** (literature, infinite-volume: "
                f"{lit_s}, reference README.md:100-111; finite-{Nx}^2 "
                f"lattice artifacts shift the crossing at O(a, 1/L)).\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
