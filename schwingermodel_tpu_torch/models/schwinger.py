"""The two-flavour Schwinger model: what the ported paths need.

Counterpart of ``schwingermodel_tpu/models/schwinger.py``. Two groups of
methods:

- for the packed main path and the measurements: the lattice and HMC
  parameters, the pseudofermion noise shape, the Hasenbusch split, the
  folded links of a configuration on checkerboard planes, the even-odd
  solve dispatch ``solve_eo`` and ``dirac_inverse`` (the operators and
  forces of that path live in ops/traj.py and ops/refined.py);
- for the unpacked sampler (hmc/sampler.py), through the model's geometry
  ``geom``, with or without a mesh: links, the even-odd and the full
  operators, the heat bath (one pseudofermion or the Hasenbusch pair), the
  solve dispatch of the JAX model (``_solve_eo_lo``, ``_solve_eo_refined``,
  ``_solve_eo``, ``_solve_full``, ``_solve_full_refined``), ``force`` with
  its quenched, Hasenbusch, even-odd and full-D branches,
  ``fermion_action``, ``hamiltonian``, ``kinetic`` and ``gauge_action``.
  Fields are in the geometry's layout (ops/geometry.py), spinors complex,
  per-chain scalars chain scalars. Working precision f32 (under either
  contract) or f64 (``real_dtype="float64"``: native f64 CG at cg.tol, no
  refinement, no f32 kernel). The double-float branches of the JAX model
  are not ported: the port's high-precision half is native f64.

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

    def heavy_model(self) -> "SchwingerModel":
        """This model at the heavy auxiliary mass m1 = m0 + hasenbusch_dm,
        the split off: every solver dispatch serves the heavy operator."""
        return dataclasses.replace(self, hmc=dataclasses.replace(
            self.hmc, m0=self.m1, hasenbusch_dm=None))

    def chi_shape(self, theta_shape) -> tuple:
        """Shape of the pseudofermion noise for a theta of this shape: a
        full-lattice spinor, or in even-odd mode the even-parity half
        lattice [..., 2, Nx, Nt/2]; under Hasenbusch a pair axis in front of
        the spin axis holds the two independent fields (chi1, chi2)."""
        if self.hmc.even_odd:
            *lead, _, Nx, Nt = theta_shape
            if Nx % 2 or Nt % 2:
                raise ValueError(
                    f"even-odd preconditioning needs even (local) lattice "
                    f"extents, got {Nx}x{Nt}")
            base = (*lead, 2, Nx, Nt // 2)
        else:
            base = tuple(theta_shape)
        if self.hasenbusch_active:
            return (*base[:-3], 2, *base[-3:])
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
        the solution, as in JAX; the flags certify the normal solve. Full-D
        pseudofermions and f64 working precision take the plain solves of
        the unpacked sampler (``_dirac_inverse_plain``)."""
        m0 = float(self.hmc.m0)
        if not self.hmc.even_odd or self.lattice.real_dtype != "float32":
            return self._dirac_inverse_plain(theta, z)
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

    def _dirac_inverse_plain(self, theta, z):
        """``dirac_inverse`` through the geometry-level solves, the links of
        each configuration shared by its B sources: the Schur solve in
        even-odd mode (f64 working precision), else
        D^{-1} z = D^+ (D D^+)^{-1} z on the full operator."""
        m0 = float(self.hmc.m0)
        z = z.to(self.lattice.cdtype)
        theta_b = theta[:, None]
        if self.hmc.even_odd:
            ops = self.eo_ops(theta_b)
            ze, zo = eo.pack(z, eo.EVEN), eo.pack(z, eo.ODD)
            rhs = ze + (0.5 / ops.m) * eo.hop(ops.Ue, ops.Uo, zo, ops.off_e)
            res = self._solve_eo(theta_b, ops, rhs)
            ye = ops.dhat_dag(self._to_working(res.x))
            yo = (zo + 0.5 * eo.hop(ops.Uo, ops.Ue, ye, ops.off_o)) / ops.m
            return eo.unpack(ye, yo), res
        Uf = self.field_fermion_links(theta_b)
        res = self._solve_full(theta_b, Uf, z)
        return dops.dirac_dagger(self.geom, Uf, self._to_working(res.x), m0), res

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

    def D(self, theta, phi):
        return dops.dirac(self.geom, self.field_fermion_links(theta), phi,
                          self.hmc.m0)

    def Ddag(self, theta, phi):
        return dops.dirac_dagger(self.geom, self.field_fermion_links(theta),
                                 phi, self.hmc.m0)

    def DDdag(self, theta, phi):
        return dops.dirac_normal(self.geom, self.field_fermion_links(theta),
                                 phi, self.hmc.m0)

    def _to_working(self, v):
        """A (possibly f64-refined) complex field in the working dtype."""
        return v.to(self.lattice.cdtype)

    def pseudofermion(self, theta, chi):
        """Phi = D chi (reference src/hmc.cpp:159-160); Phi = Dhat chi
        (even-packed) in even-odd mode."""
        if self.hmc.even_odd:
            return self.eo_ops(theta).dhat(chi)
        return self.D(theta, chi)

    def pseudofermion_fields(self, theta, chi, stats: SolveStats):
        """The heat bath from the noise chi: (phi, stats). Plain: phi = D chi
        (Dhat chi even-odd), no solve. Hasenbusch: chi carries the pair axis
        (``chi_shape``) and the result is the pair (phi1, phi2) with

            phi1 = D1 chi1                (exact, like the reference)
            phi2 = D1^{-1} D0 chi2        (one heavy solve at cg.tol)

        so that S1_old + S2_old = |chi1|^2 + |chi2|^2 exactly."""
        if not self.hasenbusch_active:
            return self.pseudofermion(theta, chi), stats
        chi1 = chi[..., 0, :, :, :]
        chi2 = chi[..., 1, :, :, :]
        heavy = self.heavy_model()
        phi1 = heavy.pseudofermion(theta, chi1)
        b = self.pseudofermion(theta, chi2)            # D0 chi2
        if self.hmc.even_odd:
            ops1 = heavy.eo_ops(theta)
            res = heavy._solve_eo(theta, ops1, b)
            phi2 = ops1.dhat_dag(self._to_working(res.x))
        else:
            Uf = self.field_fermion_links(theta)
            res = heavy._solve_full(theta, Uf, b)
            phi2 = dops.dirac_dagger(self.geom, Uf, self._to_working(res.x),
                                     heavy.hmc.m0)
        return (phi1, phi2), stats.merge(res)

    # ---------- the unpacked sampler's solves ----------

    def _refine_active(self) -> bool:
        return bool(self.hmc.cg.refine) and self.lattice.real_dtype == "float32"

    def _dot_re(self, x, y):
        return self.geom.gsum((torch.conj(x) * y).real.sum(dim=-3))

    def _dot_batch_re(self, pairs):
        return dops.spinor_dot_re_batch(self.geom, pairs)

    def _cg(self, apply_A, b, x0, tol) -> CGResult:
        """The plain CG of every non-fused solve."""
        return cg_solve_single_reduction(
            apply_A, b, self._dot_re, self._dot_batch_re, x0=x0, tol=tol,
            max_iter=int(self.hmc.cg.max_iter))

    def _use_fused_cg(self, b: torch.Tensor) -> bool:
        """hmc.fused_cg without a mesh: True = K6 (its plain twin on CPU
        tensors), False = the plain CG, None = K6 for f32 tensors on the
        card (the JAX model's automatic choice on its accelerator)."""
        if (self.geom.is_sharded or not self.hmc.even_odd
                or self.lattice.real_dtype != "float32"):
            return False            # K6 is an f32 even-odd kernel
        if self.hmc.fused_cg is not None:
            return bool(self.hmc.fused_cg)
        return b.is_cuda

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

    def _solve_full_refined(self, theta, Uf, b, x0=None, tol=None) -> CGResult:
        """(D D^+)^{-1} b for the full operator to cg.tol on the f64 true
        residual: f32 inner solves by the plain CG at cg.inner_tol inside
        the restart refinement, the f64 operator in plain complex128 through
        the geometry (the x64 branch of the JAX model)."""
        cg, m0 = self.hmc.cg, self.hmc.m0
        Uf_hi = self.field_fermion_links(theta, hi=True)

        def inner(rhs, x0_lo):
            res = self._cg(lambda v: dops.dirac_normal(self.geom, Uf, v, m0),
                           rhs, x0_lo, cg.inner_tol)
            return res.x, res.iters

        return refine.cg_refine_geom(
            lambda v: dops.dirac_normal(self.geom, Uf_hi, v, m0), inner, b,
            self._dot_re, tol=float(cg.tol if tol is None else tol),
            max_outer=int(cg.max_outer), x0=x0,
            fallback_max_iter=int(cg.max_iter) if cg.fallback else 0)

    def _solve_full(self, theta, Uf, b, x0=None, tol=None) -> CGResult:
        """(D D^+)^{-1} b for the full (non-even-odd) operator, with the
        precision dispatch of ``_solve_eo``."""
        if self._refine_active():
            return self._solve_full_refined(theta, Uf, b, x0=x0, tol=tol)
        if x0 is not None:
            x0 = x0.to(b.dtype)
        return self._cg(
            lambda v: dops.dirac_normal(self.geom, Uf, v, self.hmc.m0), b, x0,
            float(self.hmc.cg.tol if tol is None else tol))

    def solve_normal(self, theta, b) -> CGResult:
        """psi = (D D^+)^{-1} b at the configured contract."""
        return self._solve_full(theta, self.field_fermion_links(theta), b)

    # ---------- forces and energies of the unpacked sampler ----------

    def force(self, theta, phi, stats: SolveStats, beta=None, x0=None):
        """Total MD force F = fermion + gauge, of theta's shape (reference
        HMC::Force + Force_G, src/hmc.cpp:32-60). Returns (F, stats, psi).
        Quenched (phi is None): the staple force alone, no solve, psi None.
        beta overrides hmc.beta (a beta scan); x0 is the solve's start (the
        integrator passes the previous psi; a pair under Hasenbusch). On a
        mesh with the fused path the even-odd force is one K8 launch."""
        beta = float(self.hmc.beta if beta is None else beta)
        m0 = float(self.hmc.m0)
        if self.hmc.quenched or phi is None:
            return gauge.gauge_force(self.geom, self.links(theta), beta), stats, None
        if self.hasenbusch_active:
            return self._force_hasenbusch(theta, phi, stats, beta, x0)
        ftol = self.hmc.cg.resolved_force_tol()
        if self.hmc.even_odd:
            ops = self.eo_ops(theta)
            res = self._solve_eo(theta, ops, phi, x0=x0, tol=ftol)
            # the force math runs at working precision; psi itself is
            # returned at solve precision, so the forecast keeps the f64 guess
            psi_w = self._to_working(res.x)
            if self.geom.is_sharded and self._fused_sharded(ops):
                F = halo.force_halo_fused(self.geom, ops.Uf, m0, psi_w, beta)
                return F, stats.merge(res), res.x
            F = eo.eo_fermion_force(ops, psi_w, ops.dhat_dag(psi_w))
        else:
            Uf = self.field_fermion_links(theta)
            res = self._solve_full(theta, Uf, phi, x0=x0, tol=ftol)
            psi_w = self._to_working(res.x)
            F = dops.fermion_force(self.geom, Uf, psi_w,
                                   dops.dirac_dagger(self.geom, Uf, psi_w, m0))
        F = F + gauge.gauge_force(self.geom, self.links(theta), beta)
        return F, stats.merge(res), res.x

    def _force_hasenbusch(self, theta, phi_pair, stats: SolveStats, beta, x0_pair):
        """Two-pseudofermion MD force. Term 1 (heavy): the pseudofermion
        force at mass m1. Term 2 (ratio): for
        S2 = (D1 phi2)^+ (D0 D0^+)^{-1} (D1 phi2) at fixed
        psi2 = (D0 D0^+)^{-1} D1 phi2 and chi2' = D0^+ psi2 the force is
        ``eo.eo_ratio_force`` even-odd; for the full operator the two
        bilinears share the mass-independent hopping gradient, so
        F2 = fermion_force(psi2, chi2' - phi2). The forecast threads
        (psi1, psi2) as a pair. The forces are the plain ones on a mesh too
        (as in JAX, K8 serves the unsplit force only); the solves take the
        dispatch of ``_solve_eo``, so K6 without a mesh and K7 on one."""
        phi1, phi2 = phi_pair
        x01, x02 = (None, None) if x0_pair is None else x0_pair
        heavy = self.heavy_model()
        m0, m1 = float(self.hmc.m0), float(heavy.hmc.m0)
        ftol = self.hmc.cg.resolved_force_tol()
        F = gauge.gauge_force(self.geom, self.links(theta), beta)
        if self.hmc.even_odd:
            ops1, ops0 = heavy.eo_ops(theta), self.eo_ops(theta)
            res1 = heavy._solve_eo(theta, ops1, phi1, x0=x01, tol=ftol)
            psi1_w = self._to_working(res1.x)
            F = F + eo.eo_fermion_force(ops1, psi1_w, ops1.dhat_dag(psi1_w))
            res2 = self._solve_eo(theta, ops0, ops1.dhat(phi2), x0=x02, tol=ftol)
            psi2_w = self._to_working(res2.x)
            F = F + eo.eo_ratio_force(ops0, ops1, psi2_w, ops0.dhat_dag(psi2_w),
                                      phi2)
        else:
            Uf = self.field_fermion_links(theta)
            res1 = heavy._solve_full(theta, Uf, phi1, x0=x01, tol=ftol)
            psi1_w = self._to_working(res1.x)
            F = F + dops.fermion_force(
                self.geom, Uf, psi1_w, dops.dirac_dagger(self.geom, Uf, psi1_w, m1))
            res2 = self._solve_full(theta, Uf, dops.dirac(self.geom, Uf, phi2, m1),
                                    x0=x02, tol=ftol)
            psi2_w = self._to_working(res2.x)
            chi2_p = dops.dirac_dagger(self.geom, Uf, psi2_w, m0)
            F = F + dops.fermion_force(self.geom, Uf, psi2_w, chi2_p - phi2)
        return F, stats.merge(res1).merge(res2), (res1.x, res2.x)

    def gauge_action(self, theta, beta=None):
        """S_g per chain, in f64 from the stored angles; beta overrides
        hmc.beta."""
        return gauge.field_gauge_action(
            self.geom, gauge.field_links(theta, torch.complex128),
            float(self.hmc.beta if beta is None else beta))

    def fermion_action(self, theta, phi, stats: SolveStats, x0=None):
        """S_f = Re<Phi, (D D^+)^{-1} Phi> per chain (reference HMC::Action,
        src/hmc.cpp:115-117; the Dhat analogue in even-odd mode), the dot in
        f64; (S_f, stats). Hasenbusch (phi the pair (phi1, phi2)):
        S_f = S1 + S2 with S1 = phi1^+ (D1 D1^+)^{-1} phi1 and
        S2 = b2^+ (D0 D0^+)^{-1} b2, b2 = D1 phi2; x0 forwards the
        (psi1, psi2) pair."""
        if self.hasenbusch_active and isinstance(phi, tuple):
            phi1, phi2 = phi
            x01, x02 = (None, None) if x0 is None else x0
            heavy = self.heavy_model()
            s1, stats = heavy.fermion_action(theta, phi1, stats, x0=x01)
            if self.hmc.even_odd:
                b2 = heavy.eo_ops(theta).dhat(phi2)
            else:
                b2 = dops.dirac(self.geom, self.field_fermion_links(theta),
                                phi2, heavy.hmc.m0)
            # a tensor phi falls through to the single-term path below
            s2, stats = self.fermion_action(theta, b2, stats, x0=x02)
            return s1 + s2, stats
        if self.hmc.even_odd:
            res = self._solve_eo(theta, self.eo_ops(theta), phi, x0=x0)
        else:
            res = self._solve_full(theta, self.field_fermion_links(theta), phi,
                                   x0=x0)
        return (self._dot_re(phi.to(torch.complex128),
                             res.x.to(torch.complex128)), stats.merge(res))

    def hamiltonian(self, theta, pi, phi, stats: SolveStats):
        """H = kinetic + S_g + S_f per chain; (H, stats)."""
        sf, stats = self.fermion_action(theta, phi, stats)
        return self.kinetic(pi) + self.gauge_action(theta) + sf, stats

    def kinetic(self, pi):
        """0.5 sum pi^2 per chain, in f64."""
        return 0.5 * self.geom.gsum((pi.double() ** 2).sum(dim=-3))

    def plaquette_sum(self, theta):
        """sum_n Re P_01(n) per chain, in f64."""
        return gauge.field_plaquette_sum(
            self.geom, gauge.field_links(theta, torch.complex128))
