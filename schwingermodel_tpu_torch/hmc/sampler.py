"""One HMC trajectory of the unpacked sampler, statistics and noise draws.

Counterpart of ``schwingermodel_tpu/hmc/sampler.py`` (reference
HMC::HMC_Update, src/hmc.cpp:151-181): ``trajectory_given_noise`` is the
deterministic physics given pre-drawn noise, written against the model's
geometry, so the same function runs one lattice per chain or the blocks of
a mesh (parallel/sharded.py draws the noise on the global lattice and
shards it); ``hmc_trajectory`` draws the noise and calls it. Every mode of
the JAX sampler on one device: even-odd or full-D pseudofermions, one field
or the Hasenbusch pair, quenched, f32 under either contract or f64,
leapfrog and Omelyan, ``dt=`` and ``beta=`` overrides, with the exact
initial fermion action S_f(old) = |chi|^2 summed in f64. Without a mesh the
CLI runs the packed path (hmc/packed.py) where that applies.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from schwingermodel_tpu_torch.hmc.integrators import integrate
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel, SolveStats
from schwingermodel_tpu_torch.ops import noise
from schwingermodel_tpu_torch.ops.geometry import bcast


class TrajectoryStats(NamedTuple):
    accepted: torch.Tensor      # bool [C]
    delta_H: torch.Tensor       # f64 [C], H' - H
    exp_mdH: torch.Tensor       # f64 [C], exp(-dH)
    cg_iters: torch.Tensor      # int [C], CG iterations this trajectory
    cg_converged: torch.Tensor  # bool [C], every solve converged
    # int [C], refined solves of the packed path that ran the f64 fallback;
    # None where the path does not count them
    cg_fallbacks: Optional[torch.Tensor] = None
    # int [C], CG iterations of the Metropolis action solve(s), of cg_iters;
    # None where the path does not count them
    action_iters: Optional[torch.Tensor] = None


def draw_chain_noise(model: SchwingerModel, seed: int, traj_index,
                     n_chains: int, device, chain_offset: int = 0):
    """(pi, chi, r) of one trajectory for chains chain_offset ..
    chain_offset + n_chains - 1 on the global lattice, in one call
    (ops/noise.py: one kernel launch on the card): pi ~ N(0,1) of
    [C, 2, Nx, Nt], chi the pseudofermion noise of ``model.chi_shape``
    (complex, each part of variance 1/2; drawn in quenched mode too, so
    that the streams do not depend on the mode), r ~ U[0,1) the Metropolis
    draw [C], in the working precision. A chain's draw depends on (seed,
    traj_index, its global index) only, so a chain draws the same noise in
    whichever process holds it and beside however many others.
    traj_index: a Python int or a 0-d int64 tensor on `device`."""
    shape = (2, model.lattice.Nx, model.lattice.Nt)
    return noise.chain_noise(seed, traj_index, n_chains, shape,
                             model.chi_shape(shape), model.lattice.rdtype,
                             device, chain_offset)


def trajectory_given_noise(model: SchwingerModel, theta, pi, chi, r, dt=None,
                           beta=None):
    """Deterministic HMC update given pre-drawn noise, in the layout of the
    model's geometry: theta, pi [batch.., 2, Nx, Nt] in the working real
    dtype, chi complex of ``model.chi_shape`` (ignored in quenched mode), r
    a chain scalar. dt and beta override the model's step size and coupling.
    Returns (theta' wrapped to [-pi, pi), TrajectoryStats with [C]
    entries)."""
    geom = model.geom
    quenched = model.hmc.quenched
    stats = SolveStats.zero(r)
    phi = None
    if not quenched:
        phi, stats = model.pseudofermion_fields(theta, chi, stats)

    # old Hamiltonian; Phi = D chi, so S_f(old) = |chi|^2 exactly (both
    # fields of a Hasenbusch pair)
    if quenched:
        sf_old = 0.0
    elif model.hmc.exact_initial_fermion_action:
        axes = (-4, -3) if model.hasenbusch_active else -3
        sf_old = geom.gsum((chi.real.double() ** 2
                            + chi.imag.double() ** 2).sum(dim=axes))
    else:
        sf_old, stats = model.fermion_action(theta, phi, stats)
    H_old = model.kinetic(pi) + model.gauge_action(theta, beta) + sf_old

    theta_new, pi_new, stats, psi_last = integrate(model, theta, pi, phi,
                                                   stats, dt, beta)

    if quenched:
        sf_new = 0.0
    else:
        x0 = psi_last if model.hmc.cg_forecast else None
        sf_new, stats = model.fermion_action(theta_new, phi, stats, x0=x0)
    H_new = (model.kinetic(pi_new) + model.gauge_action(theta_new, beta)
             + sf_new)

    dH = H_new - H_old
    exp_mdH = torch.exp(-dH)
    accept = r.double() <= exp_mdH                      # hmc.cpp:171
    theta_next = torch.where(bcast(accept, theta), theta_new, theta)
    # keep the angles bounded over long runs (exact gauge periodicity)
    theta_next = torch.remainder(theta_next + math.pi, 2.0 * math.pi) - math.pi
    C = theta.shape[0]
    return theta_next, TrajectoryStats(
        accepted=accept.reshape(C), delta_H=dH.reshape(C),
        exp_mdH=exp_mdH.reshape(C), cg_iters=stats.iters.reshape(C),
        cg_converged=stats.all_converged.reshape(C))


def hmc_trajectory(model: SchwingerModel, theta, seed: int, traj_index,
                   dt=None, beta=None, chain_offset: int = 0):
    """One trajectory of theta [C, 2, Nx, Nt] (one lattice per chain) with
    noise drawn from (seed, traj_index, chain_offset + chain)."""
    pi, chi, r = draw_chain_noise(model, seed, traj_index, theta.shape[0],
                                  theta.device, chain_offset)
    return trajectory_given_noise(model, theta, pi, chi, r, dt, beta)
