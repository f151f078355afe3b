"""Molecular-dynamics integrators of the unpacked sampler.

Counterpart of ``schwingermodel_tpu/hmc/integrators.py``. ``leapfrog`` is
the reference's position-first scheme (HMC::Leapfrog, src/hmc.cpp:63-103):

    theta += dt/2 * pi ;  F
    repeat md_steps-2 times:  pi += dt*F ; theta += dt*pi ; F
    pi += dt*F ; theta += dt/2 * pi

with md_steps-1 force evaluations over (md_steps-1)/md_steps of the
trajectory length. ``omelyan`` is the 2MN position version over the full
length, two force evaluations per step with adjacent theta updates merged.

Chronological forecasting (hmc.cg_forecast): every force solve but the
first starts from the previous step's psi, a (psi1, psi2) pair under
Hasenbusch; none in quenched mode, where phi is None and no solve runs. (The packed path extrapolates
2 psi_1 - psi_2 instead; the trajectories agree, the iteration counts do
not.) The `lax.scan` of the JAX module is a Python loop here.
"""

from __future__ import annotations

from schwingermodel_tpu_torch.models.schwinger import SchwingerModel, SolveStats

# Omelyan/Mryglod/Folk 2nd-order minimum-norm coefficient (2MN),
# Comput. Phys. Commun. 151 (2003) 272, Eq. (31)
LAMBDA_2MN = 0.1931833275037836


def _forecasting(model: SchwingerModel, phi) -> bool:
    return bool(model.hmc.cg_forecast and not model.hmc.quenched
                and phi is not None)


def leapfrog(model: SchwingerModel, theta, pi, phi, stats: SolveStats, dt=None,
             beta=None):
    """One MD trajectory; returns (theta', pi', stats, psi_last). phi is a
    field, the Hasenbusch pair, or None (quenched: psi_last is None). dt and
    beta override the model's step size and coupling (autotuning, scans)."""
    dt = model.hmc.step_size if dt is None else dt
    forecast = _forecasting(model, phi)
    theta = theta + (0.5 * dt) * pi
    F, stats, psi = model.force(theta, phi, stats, beta)
    for _ in range(model.hmc.md_steps - 2):
        pi = pi + dt * F
        theta = theta + dt * pi
        F, stats, psi = model.force(theta, phi, stats, beta,
                                    x0=psi if forecast else None)
    pi = pi + dt * F
    theta = theta + (0.5 * dt) * pi
    return theta, pi, stats, psi


def omelyan(model: SchwingerModel, theta, pi, phi, stats: SolveStats, dt=None,
            beta=None):
    """2MN position-version integrator; returns (theta', pi', stats, psi).
    One step of size dt:

        theta += lam*dt*pi ; pi += dt/2*F ; theta += (1-2 lam)*dt*pi ;
        pi += dt/2*F ; theta += lam*dt*pi
    """
    dt = model.hmc.step_size if dt is None else dt
    lam = LAMBDA_2MN
    forecast = _forecasting(model, phi)
    n = model.hmc.md_steps

    def force(theta, stats, psi):
        return model.force(theta, phi, stats, beta,
                           x0=psi if forecast else None)

    theta = theta + (lam * dt) * pi
    F, stats, psi = model.force(theta, phi, stats, beta)
    for step in range(n):
        merge = step < n - 1
        pi = pi + (0.5 * dt) * F
        theta = theta + ((1.0 - 2.0 * lam) * dt) * pi
        F, stats, psi = force(theta, stats, psi)
        pi = pi + (0.5 * dt) * F
        theta = theta + ((2.0 if merge else 1.0) * lam * dt) * pi
        if merge:
            F, stats, psi = force(theta, stats, psi)
    return theta, pi, stats, psi


def integrate(model: SchwingerModel, theta, pi, phi, stats: SolveStats, dt=None,
              beta=None):
    """Dispatch on hmc.integrator ("leapfrog" | "omelyan")."""
    name = model.hmc.integrator
    if name == "leapfrog":
        return leapfrog(model, theta, pi, phi, stats, dt, beta)
    if name == "omelyan":
        return omelyan(model, theta, pi, phi, stats, dt, beta)
    raise ValueError(f"unknown integrator {name!r}")
