"""The antiperiodic time boundary of the fermions, folded into the links.

Counterpart of ``make_sign_mask`` and ``fermion_links`` in
``schwingermodel_tpu/ops/dirac.py``. The full-lattice Wilson operators of
that module are not ported yet (full-D pseudofermions).
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops.geometry import Geometry


def make_sign_mask(geom: Geometry, local_Nx: int, local_Nt: int,
                   global_Nt: int, rdtype, device=None) -> torch.Tensor:
    """Site tensor: -1 where the global t equals global_Nt - 1, else +1.
    Built from global coordinates, so the same on any mesh; local_Nx and
    local_Nt are the per-shard extents."""
    _, t = geom.global_coords(local_Nx, local_Nt, device)
    one = torch.ones((), dtype=rdtype, device=device)
    return torch.where(t == global_Nt - 1, -one, one)


def fermion_links(U: torch.Tensor, sign_mask: torch.Tensor) -> torch.Tensor:
    """U [batch.., 2, Nx, Nt] complex with the mu=0 links of the last
    global time slice negated (sign_mask from make_sign_mask)."""
    return torch.stack([U[..., 0, :, :] * sign_mask, U[..., 1, :, :]], dim=-3)
