"""One point of the beta=2 critical-mass scan on 16x16, looked at chain by
chain: the run of tools/critical_mass (seed 3, C=16, md 36, 2 x 100
annealing trajectories, 200 thermalization, 40 blocks of 5; the same
trajectory indices, so the same noise), every block's correlators kept per
chain, each block's correlators through the kernels against the plain
twins, each chain's own plateau, and the tool's plateau without the chain
of the largest C_PP. On a machine with one CUDA card, from the repository
root:

    python3 docs/critical_mass_diag_torch.py -0.18

With ``--stuck-chain C --out DIR`` it stops instead at the start of the
measurement phase and writes what a test needs to hold the stuck chain
against the JAX package: DIR/critical_mass_b2_m0-0.18_chain13.npy (that
chain's angles, [2, 16, 16] f64 of the f32 state), and
DIR/critical_mass_diag_torch_b2.json with dH, the accept decision and the
CG iterations of every chain over the next ``--n-next`` trajectories (the
measurement phase's first indices, so the scan's noise) and the smallest
eigenvalues of the even-odd Dhat Dhat^+ at m0 of every chain's
configuration (dense, NumPy ``eigvalsh`` of the operator built column by
column in f64 from the stored angles):

    python3 docs/critical_mass_diag_torch.py -0.18 --stuck-chain 13 --out DIR

A second witness of how chain C got there runs the chain again, alone,
through the plain PyTorch twins of K1 and K3 (f32, as the kernels) on the
noise the card draws for it (the same seed, trajectory indices and global
chain index) from the same hot start. ``--witness C --out DIR`` runs the
kernels on the card and records that noise and, every ``--every``
trajectories, the chain's configuration before and after the kernels'
step; ``--replay NPZ --out DIR`` then runs the twins on the CPU (any
machine) and writes DIR/critical_mass_witness_torch_b2.json: at every
sample the lowest eigenvalue of the even-odd Dhat Dhat^+ at the current m0
of both copies of the chain, and one trajectory of the twins from the
kernels' configuration against the kernels' step of it (dH, the accept
decision, theta', and both steps' lowest eigenvalue at the scan's m0):

    python3 docs/critical_mass_diag_torch.py -0.18 --witness 13 --every 20 --out DIR
    python3 docs/critical_mass_diag_torch.py --replay DIR/critical_mass_witness_b2_chain13.npz --out docs
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from schwingermodel_tpu_torch import observables as obs  # noqa: E402
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams  # noqa: E402
from schwingermodel_tpu_torch.hmc import packed as hp  # noqa: E402
from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise  # noqa: E402
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel  # noqa: E402
from schwingermodel_tpu_torch.runner import hot_start  # noqa: E402
from schwingermodel_tpu_torch.solvers import refine  # noqa: E402
from schwingermodel_tpu_torch.tools.critical_mass import pcac_plateau  # noqa: E402

C, SEED, WINDOW = 16, 3, (3, 7)


def eo_normal_spectrum(theta, m0: float) -> np.ndarray:
    """Eigenvalues, ascending, of the even-odd Dhat Dhat^+ of one
    configuration theta [2, Nx, Nt] at m0: the dense operator built in f64
    by applying the port's operator to every unit vector of the even
    sublattice (2 spins x Nx x Nt/2 columns), then NumPy ``eigvalsh``."""
    theta = torch.as_tensor(theta, dtype=torch.float64)
    _, Nx, Nt = theta.shape
    n = 2 * Nx * (Nt // 2)
    model = SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float64"),
        hmc=HMCParams(beta=2.0, m0=m0, md_steps=1, trajectory_length=1.0,
                      even_odd=True))
    ops = model.eo_ops(theta.expand(n, 2, Nx, Nt), hi=True)
    basis = torch.eye(n, dtype=torch.complex128, device=theta.device)
    cols = ops.normal(basis.reshape(n, 2, Nx, Nt // 2)).reshape(n, n)
    return np.linalg.eigvalsh(cols.T.cpu().numpy())


def _thermalized(model, dev, each=None):
    """The tool's run of one point up to the start of its measurement
    phase: (theta [C, ...], the next trajectory index). ``each(i, m,
    theta, theta', stats)`` is called after every trajectory i, m the
    model of its annealing stage."""
    th = hot_start(model.lattice, SEED, C, dev)
    next_index = 0
    for m0_a, n in ((0.0, 100), (model.hmc.m0 / 2, 100), (model.hmc.m0, 200)):
        m = dataclasses.replace(model, hmc=dataclasses.replace(model.hmc, m0=m0_a))
        for i in range(next_index, next_index + n):
            th0 = th
            th, st = hp.hmc_trajectory_packed(m, th, SEED, i)
            if each is not None:
                each(i, m, th0, th, st)
        next_index += n
    return th, next_index


def witness(model, dev, chain: int, every: int, out: str) -> int:
    """On the card: the kernels' run of all C chains, keeping what the
    twins' run of one chain needs (module docstring), in
    DIR/critical_mass_witness_b2_chain{C}.npz: the chain's hot start, its
    noise and annealing mass of every trajectory, and every ``every``
    trajectories its configuration before and after the kernels' step with
    that step's dH, accept decision and convergence."""
    hot = hot_start(model.lattice, SEED, C, dev)[chain].cpu()
    rec = {k: [] for k in ("pi", "chi", "r", "m0", "kernel_accepted", "index",
                           "theta0", "theta1", "dH", "accepted", "converged")}

    def each(i, m, th0, th1, st):
        pi, chi, r = draw_chain_noise(m, SEED, i, 1, dev, chain_offset=chain)
        for k, v in (("pi", pi[0]), ("chi", chi[0]), ("r", r[0])):
            rec[k].append(v.cpu().numpy())
        rec["m0"].append(float(m.hmc.m0))
        rec["kernel_accepted"].append(bool(st.accepted[chain]))
        if (i + 1) % every == 0:
            rec["index"].append(i)
            rec["theta0"].append(th0[chain].cpu().numpy())
            rec["theta1"].append(th1[chain].cpu().numpy())
            rec["dH"].append(float(st.delta_H[chain]))
            rec["accepted"].append(bool(st.accepted[chain]))
            rec["converged"].append(bool(st.cg_converged[chain]))

    _thermalized(model, dev, each)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"critical_mass_witness_b2_chain{chain}.npz")
    np.savez(path, hot=hot.numpy(), chain=chain, every=every,
             device=torch.cuda.get_device_name(dev),
             **{k: np.asarray(v) for k, v in rec.items()})
    print(f"wrote {path}: chain {chain} accepted {sum(rec['kernel_accepted'])} "
          f"of {len(rec['m0'])} trajectories through the kernels")
    return 0


def replay(path: str, out: str) -> int:
    """On the CPU: the chain of ``witness``'s record alone through the
    plain twins on its recorded noise, with every sample's lowest eigenvalue
    of both copies and the twins' step from the kernels' configuration;
    DIR/critical_mass_witness_torch_b2.json."""
    z = np.load(path)
    lat = LatticeParams(Nx=16, Nt=16, real_dtype="float32")
    base = SchwingerModel(lattice=lat, hmc=HMCParams(
        beta=2.0, m0=float(z["m0"][-1]), md_steps=36, trajectory_length=1.0,
        even_odd=True, cg=CGParams(tol=1e-10, max_iter=20000, refine=True)))
    chain = int(z["chain"])
    twin = torch.from_numpy(z["hot"])[None]
    twin_acc, samples, k = 0, [], 0
    for i, m0 in enumerate(z["m0"]):
        m = dataclasses.replace(base, hmc=dataclasses.replace(base.hmc, m0=float(m0)))
        noise = [torch.from_numpy(np.asarray(z[n][i]))[None] for n in ("pi", "chi", "r")]
        noise[2] = noise[2].reshape(1)
        twin, st = hp.trajectory_packed_given_noise(m, twin, *noise)
        twin_acc += int(st.accepted[0])
        if k < len(z["index"]) and z["index"][k] == i:
            sth, sst = hp.trajectory_packed_given_noise(
                m, torch.from_numpy(z["theta0"][k])[None], *noise)
            d = np.remainder(sth[0].numpy() - z["theta1"][k] + np.pi, 2 * np.pi) - np.pi
            target = float(base.hmc.m0)
            samples.append({
                "traj_index": i, "m0": float(m0),
                "lambda_min_kernels": float(eo_normal_spectrum(z["theta1"][k], float(m0))[0]),
                "lambda_min_twins": float(eo_normal_spectrum(twin[0].double(), float(m0))[0]),
                # at the scan's mass: the kernels' step and the twins' step
                # from the same configuration
                "lambda_min_at_target_kernels_step": float(
                    eo_normal_spectrum(z["theta1"][k], target)[0]),
                "lambda_min_at_target_twins_step": float(
                    eo_normal_spectrum(sth[0].double(), target)[0]),
                "accepted_so_far_kernels": int(z["kernel_accepted"][:i + 1].sum()),
                "accepted_so_far_twins": twin_acc,
                "step_dH_kernels": float(z["dH"][k]),
                "step_dH_twins": float(sst.delta_H[0]),
                "step_accepted_kernels": bool(z["accepted"][k]),
                "step_accepted_twins": bool(sst.accepted[0]),
                "step_max_abs_dtheta": float(np.abs(d).max()),
                "step_converged": bool(z["converged"][k]) and bool(sst.cg_converged[0]),
            })
            print(json.dumps(samples[-1]), flush=True)
            k += 1
    rec = {"lattice": [16, 16], "beta": 2.0, "m0": float(z["m0"][-1]),
           "seed": SEED, "chains": C, "md_steps": 36, "tau": 1.0,
           "chain": chain, "every": int(z["every"]),
           "kernels_on": str(z["device"]), "twins_on": "cpu",
           "samples": samples}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "critical_mass_witness_torch_b2.json"), "w") as f:
        json.dump(rec, f, indent=1)
    last = samples[-1]
    print(f"chain {chain} at the start of the measurement phase: lambda_min "
          f"{last['lambda_min_kernels']:.6e} through the kernels, "
          f"{last['lambda_min_twins']:.6e} through the plain twins")
    return 0


def main(m0: float, chain=None, n_next: int = 10, out=None, witness_chain=None,
         every: int = 10, replay_path=None) -> int:
    if replay_path is not None:
        return replay(replay_path, out)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lat = LatticeParams(Nx=16, Nt=16, real_dtype="float32")
    model = SchwingerModel(lattice=lat, hmc=HMCParams(
        beta=2.0, m0=m0, md_steps=36, trajectory_length=1.0, even_odd=True,
        cg=CGParams(tol=1e-10, max_iter=20000, refine=True)))
    if chain is not None:
        return stuck(model, dev, chain, n_next, out)
    if witness_chain is not None:
        return witness(model, dev, witness_chain, every, out)
    plain = dataclasses.replace(model, eo_kernels=refine.PLAIN)
    th, next_index = _thermalized(model, dev)

    def block(th, m, n):
        nonlocal next_index
        for i in range(next_index, next_index + n):
            th, _ = hp.hmc_trajectory_packed(m, th, SEED, i)
        next_index += n
        return th

    pps, aps, diffs = [], [], []
    for _ in range(40):
        th = block(th, model, 5)
        r = obs.meson_correlators(model, th)
        p = obs.meson_correlators(plain, th)
        scale = p.C_PP.abs().amax(dim=1, keepdim=True)
        diffs.append(max(((r.C_PP - p.C_PP).abs() / scale).max().item(),
                         ((r.C_A0P - p.C_A0P).abs() / scale).max().item()))
        pps.append(r.C_PP.cpu().numpy())
        aps.append(r.C_A0P.cpu().numpy())
    pp, ap = np.stack(pps), np.stack(aps)          # [block, chain, t]
    Nt = pp.shape[-1]
    print("max rel kernel-vs-plain over blocks", max(diffs))
    print("C_PP(t=8) per chain, max over blocks:",
          np.round(pp[:, :, 8].max(axis=0), 4).tolist())
    print("C_PP(t=8) per chain, median over blocks:",
          np.round(np.median(pp[:, :, 8], axis=0), 4).tolist())
    big = np.unravel_index(np.argmax(pp[:, :, 8]), pp[:, :, 8].shape)
    print("largest C_PP(8) at (block, chain)", tuple(int(i) for i in big))
    print("tool plateau", pcac_plateau(pp.reshape(-1, Nt), ap.reshape(-1, Nt), WINDOW))
    for c in range(C):
        m = obs.pcac_mass(pp[:, c].mean(0), ap[:, c].mean(0))[WINDOW[0]:WINDOW[1]]
        print("chain", c, "plateau", np.round(np.nanmean(m), 5),
              "C_PP(8) mean", np.round(pp[:, c, 8].mean(), 5))
    keep = [c for c in range(C) if c != big[1]]
    print("without chain", int(big[1]), pcac_plateau(
        pp[:, keep].reshape(-1, Nt), ap[:, keep].reshape(-1, Nt), WINDOW))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("m0", type=float, nargs="?", default=-0.18)
    ap.add_argument("--stuck-chain", type=int, default=None)
    ap.add_argument("--n-next", type=int, default=10)
    ap.add_argument("--witness", type=int, default=None)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--replay", default=None)
    ap.add_argument("--out", default=".")
    a = ap.parse_args()
    sys.exit(main(a.m0, a.stuck_chain, a.n_next, a.out, a.witness, a.every,
                  a.replay))
