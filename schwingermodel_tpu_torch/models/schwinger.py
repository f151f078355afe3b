"""The two-flavour Schwinger model: what the ported paths need.

Counterpart of ``schwingermodel_tpu/models/schwinger.py``, reduced to the
lattice and HMC parameters, the pseudofermion noise shape, the Hasenbusch
split, and the measurement solve: the folded links of a configuration, the
even-odd solve dispatch ``solve_eo`` and ``dirac_inverse``. The operators
and forces of the trajectory live in ops/ (eo.py, gauge.py, traj.py,
refined.py).
"""

from __future__ import annotations

import dataclasses

from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
from schwingermodel_tpu_torch.ops import eo, gauge
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.solvers import refine


@dataclasses.dataclass(frozen=True)
class SchwingerModel:
    lattice: LatticeParams
    hmc: HMCParams
    # the measurement solves' K6/K9/K4, or refine.PLAIN for their plain
    # twins on any device (the on-card comparison)
    eo_kernels: refine.EOKernels = refine.KERNELS

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

    # ---------- the measurement solve ----------

    @staticmethod
    def fermion_links(thE, thO):
        """f32 folded links of C configurations, planar [C, 2, 2, Nx, Nt/2]
        per parity: eo.pack of the JAX model's fermion_links (the
        antiperiodic sign on u0 at t = Nt-1), computed once per
        configuration and shared by every right-hand side and pass."""
        ue, uo = gauge.links(thE, thO)
        return tr.to_planar(ue).contiguous(), tr.to_planar(uo).contiguous()

    def solve_eo(self, thE, thO, ue, uo, b):
        """(Dhat Dhat^+)^{-1} b for C configurations of B right-hand sides
        b f32 planar [C, B, 2, 2, Nx, Nt/2] (JAX ``_solve_eo``): under the
        refined contract the restart refinement at cg.tol (K6 inner solves
        from 0, K9, K4); under the loose one K6 at cg.tol from x0 = b.
        Returns a result with x f32, iters and converged, each [C, B, ...]."""
        cg, m0 = self.hmc.cg, float(self.hmc.m0)
        if cg.refine:
            return refine.cg_refine(
                thE, thO, ue, uo, b, m0=m0, tol=float(cg.tol),
                inner_tol=float(cg.inner_tol), max_iter=int(cg.max_iter),
                max_outer=int(cg.max_outer), fallback=bool(cg.fallback),
                kernels=self.eo_kernels)
        return self.eo_kernels.cg(ue, uo, b, b, m0=m0, tol=float(cg.tol),
                                  max_iter=int(cg.max_iter))

    def dirac_inverse(self, theta, z):
        """w = D^{-1} z by the even-odd Schur solve (JAX ``dirac_inverse``):

            rhs = z_e + (1/2m) H_eo z_o,   x = (Dhat Dhat^+)^{-1} rhs,
            y_e = Dhat^+ x (f32),          y_o = (z_o + H_oe y_e / 2) / m.

        theta f32 [C, 2, Nx, Nt]; z complex64 [C, B, 2, Nx, Nt], B sources
        per configuration. Returns (w complex64 [C, B, 2, Nx, Nt], the
        solve's result). The assembly runs in f32 from the f32 round of
        the solution, as in JAX; the flags certify the normal solve."""
        m0 = float(self.hmc.m0)
        m, _ = eo.mass_terms(m0)
        thE, thO = tr.pack_planes(theta)
        ue, uo = self.fermion_links(thE, thO)
        Ue, Uo = tr.to_complex(ue)[:, None], tr.to_complex(uo)[:, None]
        Nx = theta.shape[-2]
        off_e = eo.row_offset(Nx, eo.EVEN, theta.device)
        off_o = eo.row_offset(Nx, eo.ODD, theta.device)
        ze, zo = eo.pack(z, eo.EVEN), eo.pack(z, eo.ODD)
        rhs = ze + (0.5 / m) * eo.hop(Ue, Uo, zo, off_e)
        res = self.solve_eo(thE, thO, ue, uo, tr.to_planar(rhs).contiguous())
        ye = eo.dhat_dag(Ue, Uo, tr.to_complex(res.x), m0)
        yo = (zo + 0.5 * eo.hop(Uo, Ue, ye, off_o)) / m
        return eo.unpack(ye, yo), res
