"""Observables measured on gauge configurations.

Counterpart of ``mean_plaquette``, ``gauge_action_density`` and
``topological_charge`` in ``schwingermodel_tpu/observables.py:27-45``
(reference MeasureSp_HMC / Compute_gaugeAction,
src/gauge_conf.cpp:427-449). The chiral condensate and the meson
correlators are not ported yet. All take theta [C, 2, Nx, Nt] and return
f64 [C], evaluated in f64 from the stored angles.
"""

from __future__ import annotations

import math

import torch

from schwingermodel_tpu_torch.ops import gauge
from schwingermodel_tpu_torch.ops.traj import pack_planes


def _plaquettes(theta):
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
