"""The two-flavour Schwinger model: what the ported trajectory needs.

Counterpart of ``schwingermodel_tpu/models/schwinger.py``, reduced to the
lattice and HMC parameters, the pseudofermion noise shape and the
Hasenbusch switch. The operators and forces of the even-odd path live in
ops/ (eo.py, gauge.py, traj.py, refined.py).
"""

from __future__ import annotations

import dataclasses

from schwingermodel_tpu_torch.config import HMCParams, LatticeParams


@dataclasses.dataclass(frozen=True)
class SchwingerModel:
    lattice: LatticeParams
    hmc: HMCParams

    @property
    def hasenbusch_active(self) -> bool:
        """Two-pseudofermion split: not ported, so always False here
        (packed_supported refuses a configuration that asks for it)."""
        return False

    def chi_shape(self, theta_shape) -> tuple:
        """Shape of the pseudofermion noise for a theta of this shape: the
        even-parity half lattice [..., 2, Nx, Nt/2]."""
        *lead, _, Nx, Nt = theta_shape
        if Nx % 2 or Nt % 2:
            raise ValueError(
                f"even-odd preconditioning needs even lattice extents, got "
                f"{Nx}x{Nt}")
        return (*lead, 2, Nx, Nt // 2)
