"""Observables measured on gauge configurations.

Counterpart of ``schwingermodel_tpu/observables.py``: the plaquette, the
gauge action density and the topological charge (reference MeasureSp_HMC /
Compute_gaugeAction, src/gauge_conf.cpp:427-449), evaluated in f64 from the
stored angles; the chiral condensate by Z2xZ2 stochastic estimation of
Tr D^{-1}, its noise drawn by the noise kernel's Z2 mode (ops/noise.py)
at a measurement index that may live on the card; the point-source meson
correlators and the PCAC mass. The condensate and the correlators solve
through ``SchwingerModel.dirac_inverse`` (K6, and under the refined
contract K9 and K4). Nothing here reads the host, so a CUDA graph captures
a measurement (hmc/program.MeasurementProgram).

theta is [C, 2, Nx, Nt] throughout; per-chain results are [C].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import gauge, noise
from schwingermodel_tpu_torch.ops.geometry import LOCAL
from schwingermodel_tpu_torch.ops.traj import pack_planes


def _plaquettes(theta):
    """The plaquettes anchored at the even and at the odd sites; on a
    lattice with an odd extent, which has no checkerboard, all of them as
    one field and an empty one."""
    if theta.shape[-2] % 2 or theta.shape[-1] % 2:
        P = gauge.plaquette_field(LOCAL, gauge.field_links(theta, torch.complex128))
        return P, P[..., :0]
    thE, thO = pack_planes(theta)
    return gauge.plaquette_planes(*gauge.links(thE, thO, torch.complex128))


def mean_plaquette(theta: torch.Tensor) -> torch.Tensor:
    """Ep = (1/V) sum_n Re P_01(n)."""
    pe, po = _plaquettes(theta)
    V = theta.shape[-2] * theta.shape[-1]
    return (pe.real.sum(dim=(-2, -1)) + po.real.sum(dim=(-2, -1))) / V


def gauge_action_density(theta: torch.Tensor, beta: float) -> torch.Tensor:
    """gS = S_g / V with S_g = beta sum_n (1 - Re P_01(n))."""
    return beta * (1.0 - mean_plaquette(theta))


def topological_charge(theta: torch.Tensor) -> torch.Tensor:
    """Geometric charge Q = (1/2pi) sum_n arg P_01(n), an integer."""
    pe, po = _plaquettes(theta)
    return (torch.angle(pe).sum(dim=(-2, -1))
            + torch.angle(po).sum(dim=(-2, -1))) / (2.0 * math.pi)


# ---------- the chiral condensate ----------

class CondensateResult(NamedTuple):
    value: torch.Tensor       # f64 [C], stochastic <psibar psi> per flavour
    iters: torch.Tensor       # int32 [C, n_noise], CG iterations per solve
    converged: torch.Tensor   # bool [C, n_noise], per solve
    # int32 [C, n_noise], restart passes in which each solve was active;
    # None where the solve is not the restart refinement
    passes: Optional[torch.Tensor] = None


def condensate_noise(seed: int, meas_index, n_chains: int, theta_shape,
                     n_noise: int, device, chain_offset: int = 0) -> torch.Tensor:
    """[C, n_noise, 2, Nx, Nt] complex64 Z2xZ2 noise of measurement
    `meas_index` (a Python int, or a 0-d int64 counter on `device`), each
    chain's keyed by (seed, measurement, chain_offset + chain): one launch
    of the noise kernel's Z2 mode on the card (ops/noise.z2_noise)."""
    return noise.z2_noise(seed, meas_index, n_chains, n_noise,
                          tuple(theta_shape)[-3:], device, chain_offset)


def chiral_condensate_given_noise(model: SchwingerModel, theta, zs
                                  ) -> CondensateResult:
    """<psibar psi> = mean_k Re(z_k^+ D^{-1} z_k) / V per chain, from the
    noise zs [C, n_noise, 2, Nx, Nt]: all C * n_noise solves in one
    dirac_inverse, at the model's solver contract."""
    w, res = model.dirac_inverse(theta, zs)
    est = (zs.to(torch.complex128).conj() * w.to(torch.complex128)).real
    value = est.sum(dim=(2, 3, 4)).mean(dim=1) / model.lattice.volume
    return CondensateResult(value=value, iters=res.iters,
                            converged=res.converged,
                            passes=getattr(res, "passes", None))


def chiral_condensate(model: SchwingerModel, theta, seed: int, meas_index,
                      n_noise: int = 8, chain_offset: int = 0) -> CondensateResult:
    """(1/V) Tr D^{-1} per chain by Z2xZ2 stochastic estimation, with the
    noise of measurement `meas_index` (an int or a 0-d int64 counter on
    theta's device; chain c's of global chain chain_offset + c)."""
    zs = condensate_noise(seed, meas_index, theta.shape[0], theta.shape,
                          n_noise, theta.device, chain_offset)
    return chiral_condensate_given_noise(model, theta, zs)


def measure_all(model: SchwingerModel, theta, *, with_condensate=False,
                seed: int = 0, meas_index=0, n_noise: int = 8) -> dict:
    """One measurement sweep -> dict of per-chain observables [C]; the
    condensate's noise that of measurement `meas_index` (an int or a 0-d
    int64 counter on theta's device)."""
    out = {
        "plaquette": mean_plaquette(theta),
        "gauge_action_density": gauge_action_density(theta, model.hmc.beta),
        "top_charge": topological_charge(theta),
    }
    if with_condensate:
        res = chiral_condensate(model, theta, seed, meas_index, n_noise)
        out["chiral_condensate"] = res.value
        out["condensate_cg_converged"] = res.converged.all(dim=1)
    return out


# ---------- meson correlators ----------

class CorrelatorResult(NamedTuple):
    C_PP: torch.Tensor        # f64 [C, Nt] pseudoscalar (pion) correlator
    C_A0P: torch.Tensor       # f64 [C, Nt] axial-temporal x pseudoscalar
    iters: torch.Tensor       # int32 [C, 2], per spin column
    converged: torch.Tensor   # bool [C, 2]


def meson_correlators(model: SchwingerModel, theta) -> CorrelatorResult:
    """Point-source correlators from the origin (JAX meson_correlators):
    both spin columns of the propagator S_{s s0}(x) = [D^{-1} delta_{0,s0}]_s
    in one dirac_inverse with B = 2, then

        C_PP(t)  = sum_x tr[S S^+],   C_A0P(t) = 2 Re sum_x (S S^+)_{01}

    in f64 from the f32 propagator."""
    C, _, Nx, Nt = theta.shape
    src = torch.zeros((C, 2, 2, Nx, Nt), dtype=torch.complex64,
                      device=theta.device)
    src[:, 0, 0, 0, 0] = 1.0
    src[:, 1, 1, 0, 0] = 1.0
    S, res = model.dirac_inverse(theta, src)      # [C, s0, s, Nx, Nt]
    S = S.to(torch.complex128)
    C_PP = (S.abs() ** 2).sum(dim=(1, 2, 3))
    C_A0P = 2.0 * (S[:, :, 0] * S[:, :, 1].conj()).sum(dim=(1, 2)).real
    return CorrelatorResult(C_PP=C_PP, C_A0P=C_A0P, iters=res.iters,
                            converged=res.converged)


def pcac_mass(C_PP, C_A0P):
    """m_PCAC(t) = -[C_A0P(t+1) - C_A0P(t-1)] / (4 C_PP(t)) along the last
    axis, NumPy f64; NaN where C_PP <= 0 (JAX pcac_mass: a noise artefact
    that must drop out of nanmean plateaus)."""
    C_PP, C_A0P = (np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c,
                              np.float64) for c in (C_PP, C_A0P))
    dA = 0.5 * (np.roll(C_A0P, -1, axis=-1) - np.roll(C_A0P, 1, axis=-1))
    with np.errstate(divide="ignore", invalid="ignore"):
        m = -dA / (2.0 * C_PP)
    return np.where(C_PP > 0.0, m, np.nan)
