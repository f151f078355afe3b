"""Coupling (beta) scan.

Counterpart of ``schwingermodel_tpu/scan.py``: the reference's validation
study (HMC_doc.pdf Fig. 1: average plaquette against beta on 16x16) as one
function. ``beta`` is an argument of the trajectory (hmc/sampler.py), so one
model serves every point; each point warm-starts from the previous point's
final configuration. On a quenched scan the exact 2D U(1) answer
<P> = I1(beta)/I0(beta) is attached per point as a physics gate.

The scan runs the unpacked sampler (the packed kernels take the model's own
beta); the plaquettes and accept counts of a point stay on the device and
are read once when the point ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.utils import statistics


def exact_quenched_plaquette(beta) -> torch.Tensor:
    """Exact 2D U(1) pure-gauge mean plaquette <P> = I1(beta)/I0(beta), in
    f64; exponentially scaled Bessel functions, so a large beta does not
    overflow."""
    b = torch.as_tensor(beta, dtype=torch.float64)
    return torch.special.i1e(b) / torch.special.i0e(b)


@dataclasses.dataclass
class BetaScanResult:
    betas: np.ndarray             # [n_points]
    Ep: np.ndarray                # mean plaquette per point
    dEp: np.ndarray               # 20-bin jackknife error
    acceptance: np.ndarray        # acceptance rate per point
    plaquette_chains: np.ndarray  # [n_points, n_meas, n_chains]
    exact: Optional[np.ndarray]   # I1/I0 curve for quenched scans, else None
    elapsed_seconds: float
    all_converged: bool = True    # every solve of every point converged

    def as_table(self) -> str:
        lines = ["# beta       Ep          dEp        acc"
                 + ("       exact(I1/I0)" if self.exact is not None else "")]
        for i, b in enumerate(self.betas):
            row = (f"{b:8.4f}  {self.Ep[i]:.8f}  {self.dEp[i]:.2e}  "
                   f"{self.acceptance[i]:.3f}")
            if self.exact is not None:
                row += f"  {self.exact[i]:.8f}"
            lines.append(row)
        return "\n".join(lines)


def run_beta_scan(
    lattice: LatticeParams,
    hmc: HMCParams,
    betas,
    *,
    n_therm: int = 200,
    n_meas: int = 200,
    n_steps: int = 0,
    n_chains: int = 1,
    seed: int = 0,
    device="cuda",
    progress: Optional[Callable[[str], None]] = None,
) -> BetaScanResult:
    """Scan <P>(beta); hmc.beta is ignored (each point overrides it). Every
    point thermalizes n_therm trajectories from the previous point's final
    configuration (the first from a hot start), then measures the plaquette
    after each of n_meas blocks of n_steps + 1 trajectories."""
    from schwingermodel_tpu_torch.runner import hot_start

    t0 = time.perf_counter()
    log = progress or (lambda s: None)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    betas = np.atleast_1d(np.asarray(betas, dtype=np.float64))
    model = SchwingerModel(lattice=lattice, hmc=hmc)
    theta = hot_start(lattice, seed, n_chains, device)
    per = n_steps + 1
    traj_index = 0

    Ep, dEp, acc_rates, chains_all = [], [], [], []
    converged = torch.ones((), dtype=torch.bool, device=device)
    for b in betas:
        accepted = torch.zeros((), dtype=torch.int64, device=device)
        plaqs = []
        for i in range(n_therm + n_meas * per):
            theta, st = sampler.hmc_trajectory(model, theta, seed, traj_index,
                                               beta=float(b))
            traj_index += 1
            converged &= st.cg_converged.all()
            if i >= n_therm:
                accepted += st.accepted.sum()
                if (i - n_therm + 1) % per == 0:
                    plaqs.append(obs.mean_plaquette(theta))
        plaqs = torch.stack(plaqs).cpu().numpy()            # [n_meas, C]
        pooled = plaqs.mean(axis=1)
        n_bins = min(20, max(2, len(pooled) // 2))
        Ep.append(statistics.mean(pooled))
        dEp.append(statistics.jackknife_error(pooled, n_bins))
        acc_rates.append(int(accepted) / (n_meas * per * n_chains))
        chains_all.append(plaqs)
        log(f"beta={b:g}: Ep={Ep[-1]:.6f} +- {dEp[-1]:.1e}, acc={acc_rates[-1]:.3f}")

    exact = None
    if hmc.quenched:
        exact = exact_quenched_plaquette(betas).numpy()
    return BetaScanResult(
        betas=betas, Ep=np.asarray(Ep), dEp=np.asarray(dEp),
        acceptance=np.asarray(acc_rates),
        plaquette_chains=np.stack(chains_all), exact=exact,
        elapsed_seconds=time.perf_counter() - t0,
        all_converged=bool(converged))
