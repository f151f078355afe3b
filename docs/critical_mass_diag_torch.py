"""One point of the beta=2 critical-mass scan on 16x16, looked at chain by
chain: the run of tools/critical_mass (seed 3, C=16, md 36, 2 x 100
annealing trajectories, 200 thermalization, 40 blocks of 5; the same
trajectory indices, so the same noise), every block's correlators kept per
chain, each block's correlators through the kernels against the plain
twins, each chain's own plateau, and the tool's plateau without the chain
of the largest C_PP. On a machine with one CUDA card, from the repository
root:

    python3 docs/critical_mass_diag_torch.py -0.18
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from schwingermodel_tpu_torch import observables as obs  # noqa: E402
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams  # noqa: E402
from schwingermodel_tpu_torch.hmc import packed as hp  # noqa: E402
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel  # noqa: E402
from schwingermodel_tpu_torch.runner import hot_start  # noqa: E402
from schwingermodel_tpu_torch.solvers import refine  # noqa: E402
from schwingermodel_tpu_torch.tools.critical_mass import pcac_plateau  # noqa: E402

C, SEED, WINDOW = 16, 3, (3, 7)


def main(m0: float) -> int:
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lat = LatticeParams(Nx=16, Nt=16, real_dtype="float32")
    model = SchwingerModel(lattice=lat, hmc=HMCParams(
        beta=2.0, m0=m0, md_steps=36, trajectory_length=1.0, even_odd=True,
        cg=CGParams(tol=1e-10, max_iter=20000, refine=True)))
    plain = dataclasses.replace(model, eo_kernels=refine.PLAIN)
    th = hot_start(lat, SEED, C, dev)
    next_index = 0

    def block(th, m, n):
        nonlocal next_index
        for i in range(next_index, next_index + n):
            th, _ = hp.hmc_trajectory_packed(m, th, SEED, i)
        next_index += n
        return th

    for m0_a in (0.0, m0 / 2):
        th = block(th, dataclasses.replace(
            model, hmc=dataclasses.replace(model.hmc, m0=m0_a)), 100)
    th = block(th, model, 200)
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
    sys.exit(main(float(sys.argv[1]) if len(sys.argv) > 1 else -0.18))
