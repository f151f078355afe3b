"""One HMC trajectory on the port's checkerboard layout (the main path).

Counterpart of ``trajectory_packed_given_noise`` and
``hmc_trajectory_packed`` in ``schwingermodel_tpu/hmc/packed.py`` for the
configuration the CLI runs by default: even-odd pseudofermions, f32
working precision, the refined 1e-10 solver contract, leapfrog, one
pseudofermion, the 2nd-order chronological forecast (or none).

One trajectory runs the heat bath Phi = Dhat chi, H_old, md_steps-1 force
evaluations (a K3 solve at the force tolerance with certify=False, K4 for
any chain K3 left unconverged, then the K1 force step), one K3 (+K4)
action solve at cg.tol with certify=True, and the Metropolis step. The
Hamiltonian terms and dH are f64, where the TPU package uses
double-float.

At the public boundary the shapes are the JAX package's: theta and pi
[C, 2, Nx, Nt], chi complex [C, 2, Nx, Nt/2], r [C]. Inside, angles,
momenta and forces are per-parity planes [C, 2, Nx, Nt/2] and spinors
planar [C, 2, 2, Nx, Nt/2] (ops/traj.py).
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.hmc.sampler import TrajectoryStats, draw_noise
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.utils import prng


def packed_supported(model: SchwingerModel) -> None:
    """Raise NotImplementedError, naming the missing slice, unless the
    model is on the ported path."""
    h, cg = model.hmc, model.hmc.cg
    missing = []
    if h.hasenbusch_dm:
        missing.append("Hasenbusch mass preconditioning (kernel K5)")
    if h.integrator != "leapfrog":
        missing.append(f"the {h.integrator} integrator")
    if h.quenched:
        missing.append("quenched mode (the unpacked sampler, K6)")
    if not h.even_odd:
        missing.append("full-D pseudofermions (the unpacked sampler, K6)")
    if model.lattice.real_dtype != "float32":
        missing.append("f64 working precision (the unpacked sampler, K6)")
    if not cg.refine:
        missing.append("the loose solver contract (kernel K2)")
    if h.mre_history >= 2 and h.cg_forecast:
        missing.append("MRE forecasting (mre_history >= 2)")
    if missing:
        raise NotImplementedError(
            "not yet ported to schwingermodel_tpu_torch: " + "; ".join(missing))


def trajectory_packed_given_noise(model: SchwingerModel, theta, pi, chi, r,
                                  dt=None):
    """Deterministic HMC update of C chains given pre-drawn noise.

    theta, pi: f32 [C, 2, Nx, Nt]; chi: complex [C, 2, Nx, Nt/2]; r: [C].
    Returns (theta' [C, 2, Nx, Nt] folded to [-pi, pi], TrajectoryStats).
    """
    packed_supported(model)
    h, cg = model.hmc, model.hmc.cg
    m0, beta = float(h.m0), float(h.beta)
    dt = h.step_size if dt is None else dt
    forecast = h.cg_forecast
    ftol = float(cg.resolved_force_tol())
    # certify_forces=False trusts every recursive exit (cert_k = max_iter)
    cert_k = int(cg.cert_k) if cg.certify_forces else int(cg.max_iter)

    def solve(thE, thO, b, x0, tol, certify):
        kw = dict(m0=m0, tol=tol, tau=float(cg.inner_tol),
                  max_iter=int(cg.max_iter))
        sol = rs.solve_refined(thE, thO, b, x0, max_outer=int(cg.max_outer),
                               certify=certify, cert_k=cert_k, **kw)
        if cg.fallback:
            sol = rs.solve_f64_cg_fallback(thE, thO, b, sol, **kw)
        return sol

    th0E, th0O = tr.pack_planes(theta)
    piE, piO = tr.pack_planes(pi)
    chi_p = tr.to_planar(chi).to(th0E.dtype)
    phi = tr.dhat(th0E, th0O, chi_p, m0)                # Phi = Dhat chi

    # old Hamiltonian, f64: S_f(old) = |chi|^2 exactly since Phi = Dhat chi
    H_old = (tr.kinetic(piE, piO) + tr.gauge_action(th0E, th0O, beta)
             + (chi_p.double() ** 2).sum(dim=(1, 2, 3, 4)))

    C = theta.shape[0]
    iters = torch.zeros(C, dtype=torch.int32, device=theta.device)
    conv = torch.ones(C, dtype=torch.bool, device=theta.device)
    # forecast history [psi_1, psi_2], started at [Phi, Phi]
    fc = [phi, phi]

    def force(thE, thO, fc, iters, conv):
        x0 = 2.0 * fc[0] - fc[1] if forecast else phi
        sol = solve(thE, thO, phi, x0, ftol, certify=False)
        FE, FO = tr.force_step(thE, thO, sol.x, m0, beta)
        if forecast:
            fc = [sol.x, fc[0]]
        return FE, FO, fc, iters + sol.iters, conv & sol.converged

    # leapfrog, position first (reference src/hmc.cpp:63-103): md_steps-1
    # force evaluations
    thE = th0E + (0.5 * dt) * piE
    thO = th0O + (0.5 * dt) * piO
    FE, FO, fc, iters, conv = force(thE, thO, fc, iters, conv)
    fc = [fc[0], fc[0]]                  # no history yet: x0 = psi_1
    for _ in range(h.md_steps - 2):
        piE = piE + dt * FE
        piO = piO + dt * FO
        thE = thE + dt * piE
        thO = thO + dt * piO
        FE, FO, fc, iters, conv = force(thE, thO, fc, iters, conv)
    piE = piE + dt * FE
    piO = piO + dt * FO
    thE = thE + (0.5 * dt) * piE
    thO = thO + (0.5 * dt) * piO

    # action solve, half a step beyond the last force solve
    x0 = 1.5 * fc[0] - 0.5 * fc[1] if forecast else phi
    sol = solve(thE, thO, phi, x0, float(cg.tol), certify=True)
    iters = iters + sol.iters
    conv = conv & sol.converged
    H_new = (tr.kinetic(piE, piO) + tr.gauge_action(thE, thO, beta)
             + tr.dot_re(phi, sol.x64))
    dH = H_new - H_old
    exp_mdH = torch.exp(-dH)
    accept = r.double() <= exp_mdH                    # hmc.cpp:171
    keep = accept.reshape(C, 1, 1, 1)
    theta_new = eo.unpack(tr.fold(torch.where(keep, thE, th0E)),
                          tr.fold(torch.where(keep, thO, th0O)))
    return theta_new, TrajectoryStats(accepted=accept, delta_H=dH,
                                      exp_mdH=exp_mdH, cg_iters=iters,
                                      cg_converged=conv)


def draw_chain_noise(model: SchwingerModel, seed: int, traj_index: int,
                     n_chains: int, device):
    """(pi, chi, r) for all chains of one trajectory, each chain from its
    own generator (utils/prng.py)."""
    shape = (2, model.lattice.Nx, model.lattice.Nt)
    draws = [draw_noise(model, shape,
                        prng.chain_generator(seed, traj_index, c, device),
                        device)
             for c in range(n_chains)]
    pi, chi, r = (torch.stack(v) for v in zip(*draws))
    return pi, chi, r


def hmc_trajectory_packed(model: SchwingerModel, theta, seed: int,
                          traj_index: int, dt=None):
    """One trajectory of theta [C, 2, Nx, Nt] with noise drawn from
    (seed, traj_index, chain)."""
    pi, chi, r = draw_chain_noise(model, seed, traj_index, theta.shape[0],
                                  theta.device)
    return trajectory_packed_given_noise(model, theta, pi, chi, r, dt)
