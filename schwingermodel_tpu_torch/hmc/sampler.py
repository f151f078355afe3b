"""Trajectory statistics and noise draws.

Counterpart of ``TrajectoryStats`` and ``draw_noise`` in
``schwingermodel_tpu/hmc/sampler.py``. The unpacked sampler itself
(full-D, quenched, f64) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.utils import prng


class TrajectoryStats(NamedTuple):
    accepted: torch.Tensor      # bool [C]
    delta_H: torch.Tensor       # f64 [C], H' - H
    exp_mdH: torch.Tensor       # f64 [C], exp(-dH)
    cg_iters: torch.Tensor      # int [C], CG iterations this trajectory
    cg_converged: torch.Tensor  # bool [C], every solve converged


def draw_noise(model: SchwingerModel, shape, gen: torch.Generator, device):
    """(pi, chi, r) of one chain for one trajectory: pi ~ N(0,1) of theta's
    shape, chi the even-parity pseudofermion noise (complex, each part
    N(0, 1/sqrt(2))), r ~ U[0,1) the Metropolis draw."""
    rdtype = model.lattice.rdtype
    pi = prng.normal_real(gen, shape, rdtype, device)
    chi = prng.normal_complex(gen, model.chi_shape(shape), rdtype, device)
    r = prng.uniform_scalar(gen, rdtype, device)
    return pi, chi, r
