"""One HMC trajectory on the port's checkerboard layout (the main path).

Counterpart of ``trajectory_packed_given_noise`` and
``hmc_trajectory_packed`` in ``schwingermodel_tpu/hmc/packed.py``, every
branch of it: even-odd pseudofermions, f32 working precision, either
solver contract, the leapfrog or the Omelyan 2MN integrator, one
pseudofermion or the Hasenbusch split, the chronological forecast (or
none), and under the refined contract the MRE forecast over the last
mre_history force solutions.

- Refined contract (cg.refine): every solve is one launch of K3, which
  under cg.fallback ends with K4's f64 CG for the chains its f32 recursion
  left unconverged; MD force solves at the force tolerance with
  certify=False, the heat-bath and action solves at cg.tol, certified. The
  force step is K1 with_solve=False.
- Loose contract: the force step is K1 with_solve=True (the f32 CG in the
  same launch), every other solve is K2, all at cg.tol. No K4.
- MRE forecasting (mre_history = K >= 2; refined, forecasting, one
  pseudofermion, as the JAX package uses it): the force history is the
  last K solutions, newest first, pushed after every force solve (K copies
  of Phi before the first), and every force solve and the action solve
  start from K3's MRE forecast over it, computed in the same launch.
- Hasenbusch (hasenbusch_dm): phi1 = Dhat1 chi1, phi2 = Dhat1^+ y with
  Dhat1 Dhat1^+ y = Dhat0 chi2 solved at the full cg.tol, so that
  S1_old + S2_old = |chi1|^2 + |chi2|^2. Each force evaluation is the heavy
  K1 at m1 with_gauge=False plus a light solve of rhs Dhat1 phi2 at m0 and
  K5 (ratio force + staples); two forecast histories.

The Hamiltonian terms and dH are f64 under both contracts (the TPU package
uses double-float under the refined one and f32 under the loose one).

At the public boundary the shapes are the JAX package's: theta and pi
[C, 2, Nx, Nt], chi complex [C, 2, Nx, Nt/2] ([C, 2, 2, Nx, Nt/2] under
Hasenbusch), r [C]. Inside, angles, momenta and forces are per-parity
planes [C, 2, Nx, Nt/2] and spinors planar [C, 2, 2, Nx, Nt/2]
(ops/traj.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from schwingermodel_tpu_torch.hmc.integrators import LAMBDA_2MN
from schwingermodel_tpu_torch.hmc.sampler import (
    TrajectoryStats, draw_chain_noise,
)
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr



def _off_path(model: SchwingerModel) -> list:
    """What keeps the model off the packed path (the unpacked sampler runs
    each of these)."""
    h = model.hmc
    off = []
    if h.integrator not in ("leapfrog", "omelyan"):
        off.append(f"the {h.integrator} integrator")
    if h.quenched:
        off.append("quenched mode")
    if not h.even_odd:
        off.append("full-D pseudofermions")
    if model.lattice.real_dtype != "float32":
        off.append("f64 working precision")
    if model.geom.is_sharded:
        off.append("a lattice mesh")
    return off


def packed_eligible(model: SchwingerModel) -> bool:
    """True where the runner takes the packed path (JAX
    ``packed_eligible``): even-odd f32 pseudofermions, not quenched, one
    lattice per chain, and hmc.packed not False."""
    return model.hmc.packed is not False and not _off_path(model)


def packed_supported(model: SchwingerModel) -> None:
    """Raise NotImplementedError unless the packed trajectory runs this
    model: it is off the packed path."""
    off = _off_path(model)
    if off:
        raise NotImplementedError(
            "the packed trajectory does not run " + "; ".join(off)
            + " (the unpacked sampler, hmc/sampler.py, does)")


def uses_mre(model: SchwingerModel) -> bool:
    """Where the JAX package runs MRE forecasting (hmc/packed.py:219);
    elsewhere it ignores mre_history."""
    h = model.hmc
    return (bool(h.cg.refine) and h.cg_forecast and h.mre_history >= 2
            and not model.hasenbusch_active)


class _Solved(NamedTuple):
    """A solve's outcome as the trajectory uses it."""
    x: torch.Tensor          # f32, what the forces and forecasts read
    hi: torch.Tensor         # what the H term reads: f64 refined, f32 loose
    iters: torch.Tensor
    converged: torch.Tensor


def trajectory_packed_given_noise(model: SchwingerModel, theta, pi, chi, r,
                                  dt=None, clocks=None):
    """Deterministic HMC update of C chains given pre-drawn noise.

    theta, pi: f32 [C, 2, Nx, Nt]; chi: complex [C, 2, Nx, Nt/2], or
    [C, 2, 2, Nx, Nt/2] under Hasenbusch; r: [C]. clocks: on the card, an
    int64 [C, 4] buffer into which every refined solve (K3) adds its clock
    cycles (``rs.solve_refined``). Returns (theta' [C, 2, Nx, Nt] folded to
    [-pi, pi], TrajectoryStats).
    """
    packed_supported(model)
    h, cg = model.hmc, model.hmc.cg
    m0, beta = float(h.m0), float(h.beta)
    m1 = model.m1
    hb = model.hasenbusch_active
    refined = bool(cg.refine)
    leap = h.integrator == "leapfrog"
    dt = h.step_size if dt is None else dt
    forecast = h.cg_forecast
    tol, max_iter = float(cg.tol), int(cg.max_iter)
    ftol = float(cg.resolved_force_tol())
    # certify_forces=False trusts every recursive exit (cert_k = max_iter)
    cert_k = int(cg.cert_k) if cg.certify_forces else max_iter

    def solve(thE, thO, b, x0, tol_, certify, mass):
        """Refined: K3 with the f64 fallback in the same launch, from the
        start x0 or the MRE forecast over a history [K, C, ...]; loose: K2
        at cg.tol (the JAX loose branch has no separate force tolerance and
        no fallback)."""
        if not refined:
            sol = tr.solve_fused(thE, thO, b, x0, m0=mass, tol=tol,
                                 max_iter=max_iter)
            return _Solved(sol.x, sol.x, sol.iters, sol.converged)
        sol = rs.solve_refined(
            thE, thO, b, x0, m0=mass, tol=tol_, tau=float(cg.inner_tol),
            max_iter=max_iter, max_outer=int(cg.max_outer), certify=certify,
            cert_k=cert_k, fallback=bool(cg.fallback), clocks=clocks)
        fell_back.append(sol.fb_iters)
        return _Solved(sol.x, sol.x64, sol.iters, sol.converged)

    def k1(thE, thO, phi_, x0, mass, with_gauge):
        """K1 under the refined contract (psi solved first by K3) or
        the loose one (the CG inside K1). Returns (K1 result, psi, iters,
        converged)."""
        if refined:
            sol = solve(thE, thO, phi_, x0, ftol, False, mass)
            res = tr.force_step(thE, thO, phi_, sol.x, m0=mass, beta=beta,
                                tol=tol, max_iter=max_iter, with_solve=False,
                                with_gauge=with_gauge)
            return res, sol.x, sol.iters, sol.converged
        res = tr.force_step(thE, thO, phi_, x0, m0=mass, beta=beta, tol=tol,
                            max_iter=max_iter, with_solve=True,
                            with_gauge=with_gauge)
        return res, res.psi, res.iters, res.converged

    th0E, th0O = tr.pack_planes(theta)
    piE, piO = tr.pack_planes(pi)
    chi_p = tr.to_planar(chi).to(th0E.dtype)
    C = theta.shape[0]
    iters = torch.zeros(C, dtype=torch.int32, device=theta.device)
    conv = torch.ones(C, dtype=torch.bool, device=theta.device)
    fell_back = []     # per refined solve, the fallback's iterations [C]

    # heat bath; S_f(old) = |chi|^2 exactly (f64)
    if hb:
        chi1, chi2 = chi_p[:, 0].contiguous(), chi_p[:, 1].contiguous()
        phi = tr.dhat(th0E, th0O, chi1, m1)              # phi1 = Dhat1 chi1
        b_hb = tr.dhat(th0E, th0O, chi2, m0)             # Dhat0 chi2
        sol = solve(th0E, th0O, b_hb, b_hb, tol, True, m1)
        iters, conv = iters + sol.iters, conv & sol.converged
        phi2 = tr.dhat_dag(th0E, th0O, sol.x, m1)        # Dhat1^{-1} Dhat0 chi2
    else:
        phi = tr.dhat(th0E, th0O, chi_p, m0)             # Phi = Dhat chi
    H_old = (tr.kinetic(piE, piO) + tr.gauge_action(th0E, th0O, beta)
             + (chi_p.double() ** 2).flatten(1).sum(dim=1))

    # forecast histories [psi_1, psi_2]: the (heavy) system of rhs phi, and
    # under Hasenbusch the light/ratio system of rhs Dhat1 phi2, which
    # equals Dhat0 chi2 = b_hb at the initial theta; under MRE the last K
    # solutions of the one system
    mre = uses_mre(model)
    fc = ([[phi] * h.mre_history] if mre
          else [[phi, phi]] + ([[b_hb, b_hb]] if hb else []))

    def x0_of(hist, default):
        if mre:
            return torch.stack(hist)
        if not forecast:
            return default
        return 2.0 * hist[0] - hist[1] if leap else hist[0]

    def force(thE, thO, fc, iters, conv):
        if not hb:
            res, psi, it, cv = k1(thE, thO, phi, x0_of(fc[0], phi), m0, True)
            FE, FO, new = res.FE, res.FO, [psi]
        else:
            b2f = tr.dhat(thE, thO, phi2, m1)
            res, psi1, it1, cv1 = k1(thE, thO, phi, x0_of(fc[0], phi), m1,
                                     False)
            sol2 = solve(thE, thO, b2f, x0_of(fc[1], b2f), ftol, False, m0)
            FE2, FO2 = tr.ratio_force(thE, thO, sol2.x, phi2, m0=m0, m1=m1,
                                      beta=beta)
            FE, FO, new = res.FE + FE2, res.FO + FO2, [psi1, sol2.x]
            it, cv = it1 + sol2.iters, cv1 & sol2.converged
        if forecast:       # push, newest first
            fc = [[psi] + hist[:-1] for psi, hist in zip(new, fc)]
        return FE, FO, fc, iters + it, conv & cv

    thE, thO = th0E, th0O
    if leap:
        # position first (reference src/hmc.cpp:63-103): md_steps-1 force
        # evaluations
        thE = thE + (0.5 * dt) * piE
        thO = thO + (0.5 * dt) * piO
        FE, FO, fc, iters, conv = force(thE, thO, fc, iters, conv)
        if not mre:         # no history yet: x0 = psi_1
            fc = [[hist[0], hist[0]] for hist in fc]
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
        # the action solve sits half a step beyond the last force solve
        x_act = [1.5 * hist[0] - 0.5 * hist[1] for hist in fc]
        if mre:             # or starts from the MRE forecast over the history
            x_act = [torch.stack(fc[0])]
    else:
        # Omelyan 2MN (hmc/integrators.omelyan): 2 md_steps force
        # evaluations, the forecast from psi_1
        lam = LAMBDA_2MN

        def half_step(thE, thO, piE, piO, FE, FO, fc, iters, conv, merge):
            piE = piE + (0.5 * dt) * FE
            piO = piO + (0.5 * dt) * FO
            thE = thE + ((1.0 - 2.0 * lam) * dt) * piE
            thO = thO + ((1.0 - 2.0 * lam) * dt) * piO
            FE, FO, fc, iters, conv = force(thE, thO, fc, iters, conv)
            piE = piE + (0.5 * dt) * FE
            piO = piO + (0.5 * dt) * FO
            s = (2.0 if merge else 1.0) * lam * dt
            thE = thE + s * piE
            thO = thO + s * piO
            if merge:
                FE, FO, fc, iters, conv = force(thE, thO, fc, iters, conv)
            return thE, thO, piE, piO, FE, FO, fc, iters, conv

        thE = thE + (lam * dt) * piE
        thO = thO + (lam * dt) * piO
        FE, FO, fc, iters, conv = force(thE, thO, fc, iters, conv)
        carry = (thE, thO, piE, piO, FE, FO, fc, iters, conv)
        for step in range(h.md_steps):
            carry = half_step(*carry, step < h.md_steps - 1)
        thE, thO, piE, piO, FE, FO, fc, iters, conv = carry
        x_act = [torch.stack(fc[0])] if mre else [hist[0] for hist in fc]

    # action solves at cg.tol, certified; S_f(new) in f64
    if hb:
        b2n = tr.dhat(thE, thO, phi2, m1)
        x1, x2 = x_act if forecast else (phi, b2n)
        sol1 = solve(thE, thO, phi, x1, tol, True, m1)
        sol2 = solve(thE, thO, b2n, x2, tol, True, m0)
        action_iters = sol1.iters + sol2.iters
        iters = iters + action_iters
        conv = conv & sol1.converged & sol2.converged
        sf_new = tr.dot_re(phi, sol1.hi) + tr.dot_re(b2n, sol2.hi)
    else:
        sol = solve(thE, thO, phi, x_act[0] if forecast else phi, tol, True,
                    m0)
        action_iters = sol.iters
        iters = iters + action_iters
        conv = conv & sol.converged
        sf_new = tr.dot_re(phi, sol.hi)
    H_new = tr.kinetic(piE, piO) + tr.gauge_action(thE, thO, beta) + sf_new
    dH = H_new - H_old
    exp_mdH = torch.exp(-dH)
    accept = r.double() <= exp_mdH                    # hmc.cpp:171
    keep = accept.reshape(C, 1, 1, 1)
    theta_new = eo.unpack(tr.fold(torch.where(keep, thE, th0E)),
                          tr.fold(torch.where(keep, thO, th0O)))
    fallbacks = ((torch.stack(fell_back) > 0).sum(dim=0) if fell_back
                 else torch.zeros_like(iters))
    return theta_new, TrajectoryStats(accepted=accept, delta_H=dH,
                                      exp_mdH=exp_mdH, cg_iters=iters,
                                      cg_converged=conv,
                                      cg_fallbacks=fallbacks,
                                      action_iters=action_iters)


def hmc_trajectory_packed(model: SchwingerModel, theta, seed: int,
                          traj_index, dt=None, chain_offset: int = 0,
                          clocks=None):
    """One trajectory of theta [C, 2, Nx, Nt] with noise drawn from
    (seed, traj_index, chain_offset + chain). traj_index: a Python int, or
    the 0-d int64 trajectory counter on theta's device (hmc/program.py),
    read there: on the card nothing here reads the host, so a CUDA graph
    can capture the call. clocks: as in ``trajectory_packed_given_noise``."""
    pi, chi, r = draw_chain_noise(model, seed, traj_index, theta.shape[0],
                                  theta.device, chain_offset)
    return trajectory_packed_given_noise(model, theta, pi, chi, r, dt, clocks)
