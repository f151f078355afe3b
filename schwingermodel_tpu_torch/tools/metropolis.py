"""Independent Metropolis sampler for 2D U(1) pure gauge theory.

A copy of ``schwingermodel_tpu/tools/metropolis.py`` in the port (plain
NumPy, nothing of either package), so that the port's quenched sampler has
the same independent check.

The reference validates its HMC against a SEPARATE Metropolis
implementation (HMC_doc.pdf Fig. 1: average plaquette on 16x16,
beta in [0, 10]; cited at README.md:60-66). This module closes the same
methodological loop for this framework: a link-local Metropolis chain
written in plain NumPy -- different algorithm, different arithmetic,
different RNG, zero shared code with either HMC stack -- whose
plaquette average is compared against (a) the exact 2D U(1) result
<P> = I1(beta)/I0(beta) and (b) the framework's quenched HMC
(tests/test_metropolis.py).

Update scheme: proposal theta' = theta + delta*u per link, accepted with
min(1, exp(-dS_local)); dS_local sums the two plaquettes containing the
link. Links are updated in four conflict-free classes (direction x site
parity): the two plaquettes of a mu-link at site n share no link with
those of any same-direction link at equal site parity, so each class
updates as one vectorized numpy step -- exact single-link Metropolis,
executed whole-class at a time.
"""

from __future__ import annotations

import json

import numpy as np


def _plaq_angle(theta: np.ndarray) -> np.ndarray:
    """th_P(n) = th0(n) + th1(n+t) - th0(n+x) - th1(n) (ops/gauge.py
    convention; reference Compute_Plaquette01, src/gauge_conf.cpp:41-48).
    np.roll(a, -1, ax) is the value at n+1 along ax."""
    t0, t1 = theta[0], theta[1]
    return t0 + np.roll(t1, -1, 1) - np.roll(t0, -1, 0) - t1


def _two_plaq_action(theta: np.ndarray, mu: int, beta: float) -> np.ndarray:
    """beta * sum of (1 - cos th_P) over the two plaquettes containing each
    mu-link, indexed by the link's site n: a 0-link sits in P(n) and
    P(n - x); a 1-link in P(n) and P(n - t)."""
    c = 1.0 - np.cos(_plaq_angle(theta))
    return beta * (c + np.roll(c, 1, 0 if mu == 0 else 1))


def plaquette_mean(theta: np.ndarray) -> float:
    return float(np.mean(np.cos(_plaq_angle(theta))))


def sweep(theta: np.ndarray, beta: float, rng: np.random.Generator,
          delta: float = 1.0) -> float:
    """One full Metropolis sweep (all links, 4 conflict-free classes),
    updating theta in place. Returns the acceptance fraction."""
    Nx, Nt = theta.shape[1:]
    par = (np.arange(Nx)[:, None] + np.arange(Nt)[None, :]) % 2
    acc = tot = 0
    for mu in (0, 1):
        for p in (0, 1):
            mask = par == p
            a_old = theta[mu].copy()
            S_old = _two_plaq_action(theta, mu, beta)
            prop = a_old + delta * rng.uniform(-1, 1, size=a_old.shape)
            theta_try = theta.copy()
            theta_try[mu] = np.where(mask, prop, a_old)
            # within a (mu, parity) class the per-link two-plaquette
            # neighborhoods are disjoint, so this dS is each link's own
            dS = _two_plaq_action(theta_try, mu, beta) - S_old
            u = rng.uniform(0, 1, size=a_old.shape)
            take = mask & ((dS <= 0) | (u < np.exp(-np.maximum(dS, 0.0))))
            theta[mu] = np.where(take, prop, a_old)
            acc += int(np.count_nonzero(take))
            tot += int(np.count_nonzero(mask))
    return acc / tot


def run(Nx: int, Nt: int, beta: float, n_therm: int, n_meas: int,
        seed: int = 0, delta: float | None = None):
    """Full Metropolis chain from a hot start.
    Returns (mean plaquette, binned error, mean acceptance)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, size=(2, Nx, Nt))
    if delta is None:
        delta = min(1.5, 2.5 / max(beta, 0.5))
    for _ in range(n_therm):
        sweep(theta, beta, rng, delta)
    vals = np.empty(n_meas)
    accs = np.empty(n_meas)
    for i in range(n_meas):
        accs[i] = sweep(theta, beta, rng, delta)
        vals[i] = plaquette_mean(theta)
    nb = 20                                  # 20-bin error (hmc.cpp:213)
    bins = vals[: (n_meas // nb) * nb].reshape(nb, -1).mean(axis=1)
    err = float(bins.std(ddof=1) / np.sqrt(nb))
    return float(vals.mean()), err, float(accs.mean())


def exact_plaquette(beta: float) -> float:
    """<P> = I1(beta)/I0(beta): exact 2D U(1) pure-gauge result."""
    from numpy import exp, pi

    # modified Bessel ratio via quadrature (no scipy dependency);
    # np.trapezoid is numpy>=2 -- fall back to the 1.x spelling
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    th = np.linspace(-pi, pi, 20001)
    w = exp(beta * np.cos(th))
    return float(trapezoid(w * np.cos(th), th) / trapezoid(w, th))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.metropolis")
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--nt", type=int, default=16)
    p.add_argument("--betas", default="1,2,4,6")
    p.add_argument("--ntherm", type=int, default=500)
    p.add_argument("--nmeas", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    for b in [float(x) for x in args.betas.split(",")]:
        ep, err, acc = run(args.nx, args.nt, b, args.ntherm, args.nmeas,
                           seed=args.seed)
        exact = exact_plaquette(b)
        print(json.dumps({
            "beta": b, "Ep": round(ep, 6), "dEp": round(err, 6),
            "acc": round(acc, 3), "exact_I1_I0": round(exact, 6),
            "n_sigma": round(abs(ep - exact) / max(err, 1e-12), 2),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
