"""The two-flavour Schwinger model: what the ported paths need.

Counterpart of ``schwingermodel_tpu/models/schwinger.py``. Two groups of
methods:

- for the packed main path and the measurements: the lattice and HMC
  parameters, the pseudofermion noise shape, the Hasenbusch split, the
  folded links of a configuration on checkerboard planes, the even-odd
  solve dispatch ``solve_eo`` and ``dirac_inverse`` (the operators and
  forces of that path live in ops/traj.py and ops/refined.py);
- for the unpacked sampler (hmc/sampler.py), through the model's geometry
  ``geom``, with or without a mesh: links, the even-odd operators, the
  heat bath, the solve dispatch of the JAX model (``_solve_eo_lo``,
  ``_solve_eo_refined``, ``_solve_eo``), the even-odd ``force``,
  ``fermion_action``, ``kinetic`` and ``gauge_action``. Fields are in the
  geometry's layout (ops/geometry.py), spinors complex, per-chain scalars
  chain scalars. Ported of this group: even-odd pseudofermions in f32
  working precision under either contract; Hasenbusch, full-D, quenched
  and f64 working precision are not.

On a mesh with blocks that take the wide halo, the f32 solves run the
sharded K7 CG and the force K8 (ops/halo.py) unless ``hmc.fused_cg`` is
False, which selects the geometry-level composite ``EOOperatorsHalo`` with
the plain CG. Without a mesh the f32 solves run K6 (ops/cg_eo.py) on the
configuration's links, as the JAX model's ``_use_fused_cg`` decides: for
tensors on the card, or where ``hmc.fused_cg`` is True; ``fused_cg`` False
selects the plain CG. The Hamiltonian terms are summed in f64 under both
contracts, as on the packed path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
from schwingermodel_tpu_torch.ops import dirac as dops
from schwingermodel_tpu_torch.ops import cg_eo, eo, eo_halo, gauge, halo
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.geometry import LOCAL, Geometry
from schwingermodel_tpu_torch.solvers import refine
from schwingermodel_tpu_torch.solvers.cg import (
    CGResult, cg_solve_single_reduction,
)


class SolveStats(NamedTuple):
    """Per-chain solve diagnostics, accumulated over a trajectory."""

    iters: torch.Tensor          # int32 chain scalar, total CG iterations
    n_solves: int                # number of solves
    all_converged: torch.Tensor  # bool chain scalar: every solve converged

    @staticmethod
    def zero(like: torch.Tensor) -> "SolveStats":
        """No solve yet, for chain scalars of the shape of `like`."""
        return SolveStats(torch.zeros_like(like, dtype=torch.int32), 0,
                          torch.ones_like(like, dtype=torch.bool))

    def merge(self, res: CGResult) -> "SolveStats":
        return SolveStats(self.iters + res.iters, self.n_solves + 1,
                          self.all_converged & res.converged)


@dataclasses.dataclass(frozen=True)
class SchwingerModel:
    lattice: LatticeParams
    hmc: HMCParams
    # the measurement solves' K6/K9/K4, or refine.PLAIN for their plain
    # twins on any device (the on-card comparison)
    eo_kernels: refine.EOKernels = refine.KERNELS
    # one lattice per chain, or a ShardedGeometry over a mesh
    geom: Geometry = LOCAL

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

    # ---------- the unpacked sampler's fields and operators ----------

    def links(self, theta):
        """U = exp(i theta) in the working complex dtype."""
        return gauge.field_links(theta).to(self.lattice.cdtype)

    def sign_mask(self, theta, rdtype=None):
        """Antiperiodic-time sign mask of this (possibly local) block."""
        return dops.make_sign_mask(
            self.geom, theta.shape[-2], theta.shape[-1], self.lattice.Nt,
            rdtype or self.lattice.rdtype, theta.device)

    def field_fermion_links(self, theta, hi=False):
        """Folded full-lattice links (JAX ``fermion_links``); hi=True in
        complex128 from the stored angles (``fermion_links_hi``): the
        operator of the f64 true residual."""
        if hi:
            return dops.fermion_links(
                gauge.field_links(theta, torch.complex128),
                self.sign_mask(theta, torch.float64))
        return dops.fermion_links(self.links(theta), self.sign_mask(theta))

    def eo_ops(self, theta, hi=False) -> eo.EOOperators:
        """Dhat / Dhat^+ of this configuration through the geometry."""
        return eo.EOOperators(self.geom, self.field_fermion_links(theta, hi),
                              self.hmc.m0)

    def _unpacked_supported(self) -> None:
        h = self.hmc
        missing = []
        if self.hasenbusch_active:
            missing.append("Hasenbusch on the unpacked sampler")
        if h.quenched:
            missing.append("quenched mode")
        if not h.even_odd:
            missing.append("full-D pseudofermions")
        if self.lattice.real_dtype != "float32":
            missing.append("f64 working precision")
        if missing:
            raise NotImplementedError(
                "not yet ported to schwingermodel_tpu_torch: " + "; ".join(missing))

    def pseudofermion(self, theta, chi):
        """Phi = Dhat chi (even-packed)."""
        return self.eo_ops(theta).dhat(chi)

    def pseudofermion_fields(self, theta, chi, stats: SolveStats):
        """The heat bath from the noise chi: (phi, stats). No solve on the
        plain branch; the Hasenbusch pair is not ported here."""
        self._unpacked_supported()
        return self.pseudofermion(theta, chi), stats

    # ---------- the unpacked sampler's solves ----------

    def _refine_active(self) -> bool:
        return bool(self.hmc.cg.refine) and self.lattice.real_dtype == "float32"

    def _dot_re(self, x, y):
        return self.geom.gsum((torch.conj(x) * y).real.sum(dim=-3))

    def _dot_batch_re(self, pairs):
        return self.geom.gsum_stack([
            (a.real * b.real + a.imag * b.imag).sum(dim=(-3, -2, -1))
            for a, b in pairs])

    def _cg(self, apply_A, b, x0, tol) -> CGResult:
        """The plain CG of every non-fused solve."""
        return cg_solve_single_reduction(
            apply_A, b, self._dot_re, self._dot_batch_re, x0=x0, tol=tol,
            max_iter=int(self.hmc.cg.max_iter))

    def _use_fused_cg(self, b: torch.Tensor) -> bool:
        """hmc.fused_cg without a mesh: True = K6 (its plain twin on CPU
        tensors), False = the plain CG, None = K6 for f32 tensors on the
        card (the JAX model's automatic choice on its accelerator)."""
        if self.geom.is_sharded or not self.hmc.even_odd:
            return False
        if self.hmc.fused_cg is not None:
            return bool(self.hmc.fused_cg)
        return b.is_cuda and self.lattice.real_dtype == "float32"

    def _solve_fused_cg(self, ops: eo.EOOperators, b, x0, tol) -> CGResult:
        """K6 on the fields of the unpacked sampler: every leading entry a
        configuration with one right-hand side."""
        lead, (Nx, Nth) = b.shape[:-3], b.shape[-2:]

        def planes(z, *mid):
            return tr.to_planar(z).reshape(-1, *mid, 2, 2, Nx, Nth).contiguous()

        b_pl = planes(b, 1)
        res = cg_eo.cg_solve_eo(
            planes(ops.Ue), planes(ops.Uo), b_pl,
            b_pl if x0 is None else planes(x0, 1), m0=float(self.hmc.m0),
            tol=tol, max_iter=int(self.hmc.cg.max_iter))
        return CGResult(x=tr.to_complex(res.x).reshape(b.shape),
                        iters=res.iters.reshape(lead),
                        converged=res.converged.reshape(lead),
                        rel_residual=res.rel_residual.reshape(lead))

    def _use_fused_sharded(self) -> bool:
        """hmc.fused_cg on a mesh: None or True = the halo kernels K7 and
        K8 (their plain twins on CPU tensors), False = the geometry-level
        wide-halo composite with the plain CG."""
        return self.hmc.fused_cg is None or bool(self.hmc.fused_cg)

    def _fused_sharded(self, ops: eo.EOOperators) -> bool:
        Nx_l, Nth_l = ops.Ue.shape[-2:]
        return (halo.fused_supported(self.geom, Nx_l, Nth_l, self.lattice.rdtype)
                and self._use_fused_sharded())

    def _eo_cg_operator(self, ops: eo.EOOperators):
        """The (Dhat Dhat^+) closure of the plain CG: on a mesh whose local
        blocks take it, the wide-halo composite (4 ppermutes per apply, not
        16), else the per-hop operator. (The fused K7 apply has its own
        CG, ``_solve_eo_lo``.)"""
        Nx_l, Nth_l = ops.Ue.shape[-2:]
        if eo_halo.supported(self.geom, Nx_l, Nth_l):
            return eo_halo.EOOperatorsHalo(self.geom, ops.Uf, ops.m0).normal
        return ops.normal

    def _solve_eo_lo(self, ops: eo.EOOperators, b, x0=None, tol=None) -> CGResult:
        """Working-precision (Dhat Dhat^+)^{-1} b: K6 without a mesh, the
        sharded K7 CG on one where it applies, else the plain CG. `tol`
        overrides cg.tol (the refinement passes cg.inner_tol)."""
        tol = float(self.hmc.cg.tol if tol is None else tol)
        if self._use_fused_cg(b):
            return self._solve_fused_cg(ops, b, x0, tol)
        if self._fused_sharded(ops):
            return halo.cg_solve_sharded_fused(
                self.geom, ops.Uf, self.hmc.m0, b, x0, tol=tol,
                max_iter=int(self.hmc.cg.max_iter))
        return self._cg(self._eo_cg_operator(ops), b, x0, tol)

    def _solve_eo_refined(self, theta, ops, b, x0=None, tol=None) -> CGResult:
        """(Dhat Dhat^+)^{-1} b to cg.tol on the f64 true residual: f32
        inner solves (``_solve_eo_lo`` at cg.inner_tol) inside the restart
        refinement, the f64 operator through the geometry. x complex128."""
        cg = self.hmc.cg

        def inner(rhs, x0_lo):
            res = self._solve_eo_lo(ops, rhs, x0=x0_lo, tol=cg.inner_tol)
            return res.x, res.iters

        return refine.cg_refine_geom(
            self.eo_ops(theta, hi=True).normal, inner, b, self._dot_re,
            tol=float(cg.tol if tol is None else tol),
            max_outer=int(cg.max_outer), x0=x0,
            fallback_max_iter=int(cg.max_iter) if cg.fallback else 0)

    def _solve_eo(self, theta, ops, b, x0=None, tol=None) -> CGResult:
        """(Dhat Dhat^+)^{-1} b at the configured contract."""
        if self._refine_active():
            return self._solve_eo_refined(theta, ops, b, x0=x0, tol=tol)
        if x0 is not None:
            x0 = x0.to(b.dtype)
        return self._solve_eo_lo(ops, b, x0=x0, tol=tol)

    # ---------- forces and energies of the unpacked sampler ----------

    def force(self, theta, phi, stats: SolveStats, x0=None):
        """Total MD force F = fermion + gauge, of theta's shape (reference
        HMC::Force + Force_G, src/hmc.cpp:32-60). Returns (F, stats, psi);
        x0 is the solve's start (the integrator passes the previous psi).
        On a mesh with the fused path the force is one K8 launch."""
        self._unpacked_supported()
        beta, m0 = float(self.hmc.beta), float(self.hmc.m0)
        ops = self.eo_ops(theta)
        res = self._solve_eo(theta, ops, phi, x0=x0,
                             tol=self.hmc.cg.resolved_force_tol())
        # the force math runs at working precision; psi itself is returned
        # at solve precision, so the forecast keeps the f64 guess
        psi_w = res.x.to(self.lattice.cdtype)
        if self.geom.is_sharded and self._fused_sharded(ops):
            F = halo.force_halo_fused(self.geom, ops.Uf, m0, psi_w, beta)
            return F, stats.merge(res), res.x
        F = eo.eo_fermion_force(ops, psi_w, ops.dhat_dag(psi_w))
        F = F + gauge.gauge_force(self.geom, self.links(theta), beta)
        return F, stats.merge(res), res.x

    def gauge_action(self, theta):
        """S_g per chain, in f64 from the stored angles."""
        return gauge.field_gauge_action(
            self.geom, gauge.field_links(theta, torch.complex128),
            float(self.hmc.beta))

    def fermion_action(self, theta, phi, stats: SolveStats, x0=None):
        """S_f = Re<Phi, (Dhat Dhat^+)^{-1} Phi> per chain, the dot in
        f64; (S_f, stats)."""
        self._unpacked_supported()
        res = self._solve_eo(theta, self.eo_ops(theta), phi, x0=x0)
        return (self._dot_re(phi.to(torch.complex128),
                             res.x.to(torch.complex128)), stats.merge(res))

    def kinetic(self, pi):
        """0.5 sum pi^2 per chain, in f64."""
        return 0.5 * self.geom.gsum((pi.double() ** 2).sum(dim=-3))

    def plaquette_sum(self, theta):
        """sum_n Re P_01(n) per chain, in f64."""
        return gauge.field_plaquette_sum(
            self.geom, gauge.field_links(theta, torch.complex128))
