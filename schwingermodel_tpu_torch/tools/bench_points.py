"""Operating-point benches beyond the demo configuration.

Counterpart of ``schwingermodel_tpu/tools/bench_points.py``: the same
points, flags, defaults, metric names and row keys. The demo point
(64x64, beta=4, m0=0.2, tau=0.1) thermalizes at acceptance ~0.998, the
easiest point; these are the points where the solver contracts are
stressed:

  - 128x128 beta=4 m0=0.2 tau=0.1      the flagship volume, C=8 chains
  - 64x64  beta=4 m0=0.2  tau=1 md=40  the physics trajectory length, hand
                                        set, autotuned (target 0.7) and with
                                        the MRE forecast (K=4, refined only)
  - 32x32 and 64x64 beta=2 m0=-0.19    near-critical (m_crit(beta=2) =
           tau=1, Hasenbusch dm=0.4    -0.1968(9)): the CG iteration counts
                                        blow up

Each point runs both solver contracts on the packed path
(``hmc/packed.hmc_trajectory_packed``: K1 with its CG and K2 under the
loose f32 contract at 1e-6; K1 and K3, with K4's f64 CG inside K3's launch
and, under ``mre_history``, K3's MRE prologue, under the refined one; K5
under Hasenbusch) and prints one JSON row: chain-trajectories per second,
acceptance, CG iterations per chain-trajectory and whether every solve of
every chain of the timed pass converged (a recorded result, not a gate:
the near-critical rows may read false).

A run starts from ``runner.hot_start``, thermalizes ``--n-therm``
trajectories (first through the masses (0, m0/2) for m0 < 0: annealing
from a safe mass, as production near-critical runs do), optionally tunes
the step size (``hmc/autotune.autotune``, 150 trajectories, target 0.7,
then ``min(40, n_therm)`` at the tuned md_steps), then runs n_timed
trajectories untimed (the warm pass: the kernels' build on first use and
their first launches) and the same n_timed again from the same
configuration, on other noise, timed on the host clock. Trajectories run
in chunks of 20, each ending with one host read of its statistics (the
JAX tool bounds its device programs the same way).

Differences from the JAX tool: the refined contract's label is
``refined_1e-10_f64`` (the port's high-precision half is native f64, not
double-float pairs), ``backend`` is "cuda" or "cpu", each row adds
``device`` (the card's name and power limit, ``utils/metrics.card_label``),
``--device {cuda,cpu}`` is added, and ``--platform``/``--devices`` are
refused with exit 2. The noise is the port's (seed, trajectory, chain)
streams (``utils/prng.py``), one stream of trajectory indices a phase.

    python -m schwingermodel_tpu_torch.tools.bench_points [--json BENCH_POINTS.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from schwingermodel_tpu_torch.tools import _bench

POINTS = [
    # name, Nx, Nt, beta, m0, md_steps, tau, chains, n_timed,
    #   integrator, max_iter, extras
    ("128x128_b4_tau0.1", 128, 128, 4.0, 0.2, 10, 0.1, 8, 60,
     "leapfrog", 10000, {}),
    # tau=1 at 64x64 needs dt fine enough for the 0.6-0.8 acceptance band
    ("64x64_b4_tau1", 64, 64, 4.0, 0.2, 40, 1.0, 32, 40,
     "leapfrog", 10000, {}),
    # the same point with the dual-averaging autotuner choosing the step
    ("64x64_b4_tau1_tuned", 64, 64, 4.0, 0.2, 40, 1.0, 32, 40,
     "leapfrog", 10000, {"tune": True}),
    # the MRE forecast (K=4) against the second-order extrapolation,
    # refined contract (the knob's only scope)
    ("64x64_b4_tau1_mre4", 64, 64, 4.0, 0.2, 40, 1.0, 32, 40,
     "leapfrog", 10000, {"mre_history": 4, "refined_only": True}),
    # near-critical at m_crit(beta=2) = -0.1968(9), with Hasenbusch mass
    # preconditioning (two pseudofermions) on the packed path
    ("32x32_b2_m-0.19_tau1_hb", 32, 32, 2.0, -0.19, 26, 1.0, 32, 40,
     "leapfrog", 20000, {"hasenbusch_dm": 0.4}),
    ("64x64_b2_m-0.19_tau1_hb", 64, 64, 2.0, -0.19, 36, 1.0, 16, 30,
     "leapfrog", 20000, {"hasenbusch_dm": 0.4}),
]

CHUNK = 20          # trajectories between two host reads
N_TUNE, TUNE_TARGET = 150, 0.7
# the phases' streams of trajectory indices (the JAX tool folds one key a
# phase): thermalization, warm pass, timed pass, re-thermalization after
# tuning, and the anneal masses from ANNEAL on
STREAM = 1 << 24
THERM, WARM, TIMED, RETHERM, ANNEAL = 0, 1, 2, 3, 500


def contracts(extras: dict, max_iter: int) -> list:
    """(label, CGParams) of the contracts a point runs: loose f32 at 1e-6,
    then refined at 1e-10; only the refined under ``refined_only``."""
    from schwingermodel_tpu_torch.config import CGParams

    out = [("loose_f32_tol1e-6", CGParams(tol=1e-6, max_iter=max_iter)),
           ("refined_1e-10_f64", CGParams(tol=1e-10, max_iter=max_iter, refine=True))]
    return out[1:] if extras.get("refined_only") else out


def anneal_schedule(m0: float) -> tuple:
    """The intermediate masses thermalized through before a negative m0."""
    return (0.0, (0.0 + m0) / 2) if m0 < 0 else ()


def point_model(point, cg):
    """The packed-path model of one POINTS entry under one contract."""
    from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel

    _, Nx, Nt, beta, m0, md, tau, _, _, integ, _, extras = point
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32"),
        hmc=HMCParams(beta=beta, m0=m0, md_steps=md, trajectory_length=tau,
                      even_odd=True, integrator=integ,
                      hasenbusch_dm=extras.get("hasenbusch_dm"),
                      mre_history=int(extras.get("mre_history", 0)), cg=cg))


def _run_chunks(model, theta, seed: int, stream: int, n: int):
    """n packed trajectories of the indices stream * STREAM + i, in chunks
    of CHUNK, each ended by one host read: (theta', accepted, CG
    iterations, converged chain-trajectories), the counts summed over the
    chains."""
    totals = [0.0, 0.0, 0.0]
    done = 0
    while done < n:
        m = min(CHUNK, n - done)
        acc = torch.zeros((), dtype=torch.float64, device=theta.device)
        its, conv = torch.zeros_like(acc), torch.zeros_like(acc)
        for i in range(done, done + m):
            theta, st = _traj(model, theta, seed, stream * STREAM + i)
            acc = acc + st.accepted.sum()
            its = its + st.cg_iters.sum()
            conv = conv + st.cg_converged.sum()
        for k, v in enumerate(torch.stack([acc, its, conv]).tolist()):
            totals[k] += v
        done += m
    return (theta, *totals)


def _traj(model, theta, seed, index, dt=None):
    from schwingermodel_tpu_torch.hmc import packed as hp

    return hp.hmc_trajectory_packed(model, theta, seed, index, dt=dt)


def run_packed(model, C: int, n_therm: int, n_timed: int, seed: int = 0,
               anneal=(), tune: bool = False, device=None, n_tune: int = N_TUNE):
    """One point under one contract on the packed path (the JAX tool's
    ``run_packed``): a hot start of C chains, the anneal masses, n_therm
    trajectories, the optional step-size tuning (n_tune warm-up
    trajectories, then min(40, n_therm) at the tuned md_steps), a warm pass
    and the timed pass of n_timed each. Returns (chain-trajectories per
    second, acceptance, CG iterations per chain-trajectory, every solve of
    the timed pass converged, the tuning's row keys)."""
    from schwingermodel_tpu_torch.hmc import autotune as at
    from schwingermodel_tpu_torch.runner import hot_start

    device = torch.device("cuda") if device is None else device
    theta = hot_start(model.lattice, seed, C, device)
    for k, m0_a in enumerate(anneal):
        m_a = dataclasses.replace(model, hmc=dataclasses.replace(model.hmc, m0=m0_a))
        theta, *_ = _run_chunks(m_a, theta, seed, ANNEAL + k, n_therm)
    theta, *_ = _run_chunks(model, theta, seed, THERM, n_therm)

    tune_info = {}
    if tune:
        theta, hmc_tuned, eps = at.autotune(
            model, theta, seed, n_tune=n_tune, target=TUNE_TARGET,
            traj_fn=lambda th, s, i, dt: _traj(model, th, s, i, dt))
        tune_info = {"tuned": True, "tuned_eps": round(float(eps), 6),
                     "md_steps_tuned": int(hmc_tuned.md_steps)}
        model = dataclasses.replace(model, hmc=hmc_tuned)
        # a short re-thermalization at the tuned step
        theta, *_ = _run_chunks(model, theta, seed, RETHERM, min(40, n_therm))

    _run_chunks(model, theta, seed, WARM, n_timed)
    t0 = time.perf_counter()
    _, acc, iters, conv = _run_chunks(model, theta, seed, TIMED, n_timed)
    dt = time.perf_counter() - t0
    n = n_timed * C
    return n / dt, acc / n, iters / n, conv == n, tune_info


def make_row(point, contract: str, result, device, card: str) -> dict:
    """The JAX tool's row of one point and contract, with ``device``."""
    name, Nx, Nt, beta, m0, md, tau, C, _, integ, _, extras = point
    v, acc, iters, conv, tune_info = result
    row = {"metric": f"hmc_traj_per_s_{name}",
           "value": round(v, 3), "unit": "traj/s/chip",
           "contract": contract, "lattice": f"{Nx}x{Nt}",
           "beta": beta, "m0": m0, "md_steps": md, "tau": tau,
           "integrator": integ,
           "chains": C, "acceptance": round(acc, 3),
           "cg_iters_per_traj": round(iters, 1),
           "all_converged": bool(conv),
           "backend": device.type, "device": card}
    if extras.get("hasenbusch_dm") is not None:
        row["hasenbusch_dm"] = extras["hasenbusch_dm"]
    if extras.get("mre_history"):
        row["mre_history"] = int(extras["mre_history"])
    row.update(tune_info)
    return row


def run_point(point, n_therm: int, device, n_tune: int = N_TUNE) -> list:
    """Every contract of one point: its rows, each printed as it comes."""
    from schwingermodel_tpu_torch.utils.metrics import card_label

    card = card_label(device)
    _, _, _, _, m0, _, _, C, n_timed, _, max_iter, extras = point
    rows = []
    for contract, cg in contracts(extras, max_iter):
        result = run_packed(point_model(point, cg), C, n_therm, n_timed,
                            anneal=anneal_schedule(m0), tune=bool(extras.get("tune")),
                            device=device, n_tune=n_tune)
        rows.append(make_row(point, contract, result, device, card))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_points")
    p.add_argument("--json", default=None)
    p.add_argument("--only", default=None,
                   help="substring filter on point names")
    p.add_argument("--n-therm", type=int, default=60)
    _bench.add_device_flags(p)
    args = p.parse_args(argv)
    rc = _bench.check_flags(args)
    if rc:
        return rc
    device = torch.device(args.device)
    rows = []
    for point in POINTS:
        if args.only and args.only not in point[0]:
            continue
        rows.extend(run_point(point, args.n_therm, device))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
