"""The two-flavour Schwinger model: what the ported trajectory needs.

Counterpart of ``schwingermodel_tpu/models/schwinger.py``, reduced to the
lattice and HMC parameters, the pseudofermion noise shape and the
Hasenbusch split. The operators and forces of the even-odd path live in
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
        """Two-pseudofermion (mass-preconditioned) determinant split: on
        when hasenbusch_dm is set and the run is not quenched."""
        return bool(self.hmc.hasenbusch_dm) and not self.hmc.quenched

    @property
    def m1(self) -> float:
        """The heavy auxiliary mass m0 + hasenbusch_dm of the split."""
        return float(self.hmc.m0) + float(self.hmc.hasenbusch_dm or 0.0)

    def chi_shape(self, theta_shape) -> tuple:
        """Shape of the pseudofermion noise for a theta of this shape: the
        even-parity half lattice [..., 2, Nx, Nt/2]; under Hasenbusch a
        pair axis in front holds the two independent fields (chi1, chi2),
        [..., 2, 2, Nx, Nt/2]."""
        *lead, _, Nx, Nt = theta_shape
        if Nx % 2 or Nt % 2:
            raise ValueError(
                f"even-odd preconditioning needs even lattice extents, got "
                f"{Nx}x{Nt}")
        base = (*lead, 2, Nx, Nt // 2)
        if self.hasenbusch_active:
            return (*lead, 2, *base[-3:])
        return base
