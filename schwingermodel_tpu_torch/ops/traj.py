"""Trajectory-state operations on the port layout, and kernels K1, K2, K5, K10.

Counterpart of ``schwingermodel_tpu/ops/pallas_traj.py``. The TPU package
keeps the state lane-packed, [A, Nx, C*Nt/2]; the port keeps it
chain-major and planar in f32:

- angle, momentum and force planes [C, 2(dir), Nx, Nt/2], one per parity;
- even-parity spinors [C, 2(spin), 2(re/im), Nx, Nt/2]; the Hasenbusch
  noise carries a pair axis in front of the spin axis.

The kernels, each with its plain twin that a CPU tensor runs:

- ``force_step`` is K1 (``csrc/force_step.cu``, replacing
  ``pallas_traj._force_step_kernel``) in all four variants of
  ``with_solve`` and ``with_gauge``; twin ``force_step_reference``.
- ``solve_fused`` is K2 (``csrc/solve_fused.cu``, replacing
  ``pallas_traj._solve_kernel``), the loose-contract f32 solve; twin
  ``solve_fused_reference``. Where K1 and K2 keep their fields (one
  block's shared memory, several blocks a chain, or a global scratch)
  follows from the lattice size and the chain count: ``cg_path``.
- ``solve_fused_mxu`` is K10 (``csrc/solve_mxu.cu``, replacing
  ``tools/bench_mxu_stencil._solve_kernel_variant``): K2 with every x-shift
  of the stencil as a product with a one-hot matrix on the tensor cores;
  twin ``solve_fused_mxu_reference``, and ``shift_x_mxu`` the shifts alone.
- ``ratio_force`` is K5 (``csrc/ratio_force.cu``, replacing
  ``pallas_traj._ratio_force_kernel``), the Hasenbusch ratio force with the
  staples; twin ``ratio_force_reference``. On the shared path it runs K1's
  kernel body without the solve, with its two bilinears folded into one,
  on the blocks a chain ``ratio_force_path`` gives.

``from_jax_packed`` and ``to_jax_packed`` convert the JAX package's
lane-packed numpy planes (any leading axes, the pair axis included) to and
from this layout: the parameter bridge between the two packages.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, gauge
from schwingermodel_tpu_torch.ops.geometry import X_AXIS, Geometry


# ---------- layout conversions ----------

def pack_planes(a: torch.Tensor):
    """[C, A, Nx, Nt] full-lattice field -> (E, O) [C, A, Nx, Nt/2]."""
    return eo.pack(a, eo.EVEN), eo.pack(a, eo.ODD)


def to_planar(z: torch.Tensor) -> torch.Tensor:
    """complex [..., 2, Nx, Nth] -> planar [..., 2, 2(re/im), Nx, Nth]
    (real dtype)."""
    return torch.stack([z.real, z.imag], dim=-3)


def to_complex(p: torch.Tensor) -> torch.Tensor:
    """planar [..., 2, 2(re/im), Nx, Nth] -> complex [..., 2, Nx, Nth]."""
    return torch.complex(p[..., 0, :, :], p[..., 1, :, :])


def from_jax_packed(p, C: int, device=None) -> torch.Tensor:
    """JAX lane-packed numpy planes [A.., Nx, C*Nth] -> chain-major tensor
    [C, A.., Nx, Nth] (pallas_traj.pack_chains / pack_even layout; a
    Hasenbusch pair stacked in front, [2, 2, 2, Nx, C*Nth], becomes
    [C, 2, 2, 2, Nx, Nth])."""
    p = np.asarray(p)
    *lead, Nx, N = p.shape
    q = np.moveaxis(p.reshape(*lead, Nx, C, N // C), -2, 0)
    return torch.from_numpy(np.ascontiguousarray(q)).to(device)


def to_jax_packed(t: torch.Tensor) -> np.ndarray:
    """Chain-major tensor [C, A.., Nx, Nth] -> JAX lane-packed numpy planes
    [A.., Nx, C*Nth]."""
    q = t.detach().cpu().numpy()
    C, *lead, Nx, Nth = q.shape
    return np.ascontiguousarray(np.moveaxis(q, 0, -2).reshape(*lead, Nx, C * Nth))


# ---------- Hamiltonian terms (f64) and state utilities ----------

def kinetic(piE: torch.Tensor, piO: torch.Tensor) -> torch.Tensor:
    """0.5 sum pi^2 per chain [C], in f64 (kinetic_packed)."""
    return 0.5 * ((piE.double() ** 2).sum(dim=(1, 2, 3))
                  + (piO.double() ** 2).sum(dim=(1, 2, 3)))


def gauge_action(thE: torch.Tensor, thO: torch.Tensor, beta) -> torch.Tensor:
    """beta sum (1 - Re P) per chain [C], in f64 from the f32 angles."""
    return gauge.gauge_action(thE, thO, beta, torch.complex128)


def dot_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-chain Re<a, b> of planar spinors [C, 2, 2, Nx, Nth], in f64."""
    return (a.double() * b.double()).sum(dim=(1, 2, 3, 4))


def fold(th: torch.Tensor) -> torch.Tensor:
    """Fold angles to [-pi, pi] (fold_packed)."""
    two_pi = 2.0 * math.pi
    return th - two_pi * torch.round(th / two_pi)


def dhat(thE, thO, v: torch.Tensor, m0) -> torch.Tensor:
    """Phi = Dhat v on planar spinors (the heat bath; dhat_packed)."""
    ue, uo = gauge.links(thE, thO)
    return to_planar(eo.dhat(ue, uo, to_complex(v), m0))


def dhat_dag(thE, thO, v: torch.Tensor, m0) -> torch.Tensor:
    """Dhat^+ v on planar spinors (dhat_dag_packed)."""
    ue, uo = gauge.links(thE, thO)
    return to_planar(eo.dhat_dag(ue, uo, to_complex(v), m0))


# ---------- the f32 CG of K1 and K2 ----------

def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-chain Re<a, b> of complex [C, ...] fields, accumulated in f64 and
    rounded to f32 (the kernels' block_dot)."""
    dims = tuple(range(1, a.ndim))
    return (a.real.double() * b.real.double()
            + a.imag.double() * b.imag.double()).sum(dim=dims).float()


def _tol2(tol) -> float:
    """f32(tol^2) as a Python float: times an f32 tensor ||b||^2 it is an f32
    product, as in the kernels, and unlike a tensor made from it on the card
    it costs no copy from the host, which would wait for the card."""
    return float(np.float32(tol * tol))


def _converged(rho, bnorm2, tol):
    return rho < _tol2(tol) * bnorm2


def _cg_f32(apply_A, b, x0, tol, max_iter, guards=True, active=None):
    """Plain twin of stencil.cuh cg_f32 (pallas_traj._cg_planes) on complex
    [C, 2, Nx, Nth]: all chains batched, each with its own live mask, so a
    frozen chain does not change (torch.where, never 0 * d, which would
    turn an inf in d into NaN). guards=False drops the breakdown guards,
    as cg_f32<false> does (K6); a chain that `active` (bool [C]) leaves out
    never starts. Returns (x, iters int32, rho f32, bnorm2 f32), all per
    chain."""
    C = b.shape[0]
    bnorm2 = _dot32(b, b)
    stop2 = _tol2(tol) * bnorm2
    x = x0.clone()
    r = b - apply_A(x)
    d = r
    rho = _dot32(r, r)
    iters = torch.zeros(C, dtype=torch.int32, device=b.device)
    live = rho >= stop2                       # a NaN rho never starts
    if active is not None:
        live = live & active
    zero = torch.zeros((), dtype=torch.float32, device=b.device)

    def per_chain(v):
        return v.reshape(C, 1, 1, 1)

    k = 0
    while k < max_iter and bool(live.any()):
        Ad = apply_A(d)
        dAd = _dot32(d, Ad)
        alpha = rho / dAd
        if guards:
            # breakdown before the x/r update: non-positive curvature or a
            # non-finite alpha freezes the chain untouched
            live = live & (dAd > 0) & torch.isfinite(alpha)
        a = per_chain(torch.where(live, alpha, zero))
        x = torch.where(per_chain(live), x + a * d, x)
        r = torch.where(per_chain(live), r + (-a) * Ad, r)
        rho_c = _dot32(r, r)
        if guards:
            # overflow after it: frozen with x as updated
            live = live & torch.isfinite(rho_c)
        beta = per_chain(torch.where(live, rho_c / rho, zero))
        d = torch.where(per_chain(live), r + beta * d, d)
        rho = torch.where(live, rho_c, rho)
        iters = iters + live.to(torch.int32)
        live = live & (rho >= stop2)
        k += 1
    return x, iters, rho, bnorm2


# ---------- where K1, K2 (and K5, K6) keep their fields ----------

# Bytes of dynamic shared memory per half-lattice site on the shared path
# (csrc/shared_stencil.cuh, force_step.cu): the CG store, and K1's
# plaquette angles with the gauge force; the rows K1 without the solve holds
# on either side of its own when a chain spans several blocks (kHaloW).
_CG_SHARED_BYTES, _PLAQ_BYTES = 96, 8
_HALO_ROWS = 4
CG_GLOBAL, CG_SHARED = range(2)


def _rows_fit(Nx: int, Nth: int, n: int, per_site: int, skirt=False) -> bool:
    """n blocks a chain hold the fields: n divides Nx, and a block's Nx/n
    rows, with _HALO_ROWS rows on either side when n > 1 (for every n with
    `skirt`: the halo kernels' extended block carries them), fit its
    threads and its shared memory; a block of several owns at least as many
    rows as it computes again (32x32: 4 blocks a chain beat 8 on the
    card)."""
    if Nx % n or (n > 1 and Nx // n < 2 * _HALO_ROWS):
        return False
    sites = (Nx // n + (2 * _HALO_ROWS if n > 1 or skirt else 0)) * Nth
    return sites <= _cuda.BLOCK_SITES and per_site * sites <= _cuda.SHARED_MAX


def split_rows(Nx: int, Nth: int, C: int, sms: int, per_site: int,
               counts=(1, 2, 4, 8), skirt=False):
    """(path, blocks per chain) for C chains whose Nx rows of Nth sites may
    be split over any of `counts` blocks a chain (``_rows_fit``): the
    largest count that leaves all C chains' blocks running at once on `sms`
    multiprocessors, else the smallest that holds the rows; CG_GLOBAL where
    none does. K1's rule; K7 and K8 take it with `skirt`."""
    fits = [n for n in counts if _rows_fit(Nx, Nth, n, per_site, skirt)]
    if not fits:
        return CG_GLOBAL, 1
    at_once = [n for n in fits if n * C <= sms]
    return CG_SHARED, (max(at_once) if at_once else min(fits))


@functools.lru_cache(maxsize=None)
def cg_path(Nx: int, Nth: int, C: int, sms: int = _cuda.H100_SMS, solve=True,
            gauge=False):
    """Where K2 (solve=True, gauge=False; K6 too, C its entries) or K1 (its
    with_solve and with_gauge; K5 as K1 without the solve, with staples)
    keeps its fields for C chains of an Nx x 2 Nth lattice on a
    card of `sms` multiprocessors: (path, blocks per chain). CG_SHARED with
    one block a chain wherever the fields fit one block's shared memory and
    threads (up to 64x64). K1 without the solve spreads a chain over n
    blocks, each with its rows and _HALO_ROWS rows on either side: the
    largest n that leaves all C chains' blocks running at once, else the
    smallest that holds the lattice (128x128: 8 blocks a chain). What no
    block holds keeps every field in a global scratch (CG_GLOBAL)."""
    per_site = _CG_SHARED_BYTES + (_PLAQ_BYTES if gauge else 0)
    return split_rows(Nx, Nth, C, sms, per_site, (1,) if solve else (1, 2, 4, 8))


def cg_path_name(Nx: int, Nth: int, C: int, sms: int = _cuda.H100_SMS,
                 solve=True, gauge=False) -> str:
    path, n = cg_path(Nx, Nth, C, sms, solve, gauge)
    if path == CG_GLOBAL:
        return "global"
    return "shared" if n == 1 else f"shared, {n} blocks a chain"


# ---------- K2: the loose-contract solve ----------

class SolveResult(NamedTuple):
    x: torch.Tensor             # f32 [C, 2, 2, Nx, Nth]
    iters: torch.Tensor         # int32 [C]
    converged: torch.Tensor     # bool [C], rho < tol^2 ||b||^2 (recursive)
    rel_residual: torch.Tensor  # f32 [C], sqrt(rho / ||b||^2)


def _solve_result(x, iters, rho, bnorm2, tol) -> SolveResult:
    tiny = torch.finfo(torch.float32).tiny
    rel = torch.sqrt(rho) * torch.rsqrt(torch.clamp(bnorm2, min=tiny))
    return SolveResult(x=x, iters=iters, converged=_converged(rho, bnorm2, tol),
                       rel_residual=rel)


def solve_fused_reference(thE, thO, b, x0, *, m0, tol, max_iter) -> SolveResult:
    """Plain twin of K2."""
    ue, uo = gauge.links(thE, thO)
    x, iters, rho, bnorm2 = _cg_f32(lambda v: eo.normal(ue, uo, v, m0),
                                    to_complex(b), to_complex(x0), tol, max_iter)
    return _solve_result(to_planar(x), iters, rho, bnorm2, tol)


def _launch_solve(entry, per_site, thE, thO, b, x0, m0, tol, max_iter, *path):
    """Launch K2 or K10 (the same C interface, the path last) with
    `per_site` f32 values of scratch per half-lattice site, none where
    per_site is 0; (x, iters, rho, bnorm2)."""
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, 2, 2, Nx, Nth))
    _cuda.check(x0, "x0", torch.float32, (C, 2, 2, Nx, Nth))
    dev = b.device
    x = torch.empty_like(b)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    rho = torch.empty(C, dtype=torch.float32, device=dev)
    bnorm2 = torch.empty(C, dtype=torch.float32, device=dev)
    scratch = torch.empty(C * per_site * Nx * Nth, dtype=torch.float32,
                          device=dev)
    p = _cuda.ptr
    _cuda.KERNELS.call(entry, p(thE), p(thO), p(b), p(x0), p(x), p(iters),
                       p(rho), p(bnorm2), p(scratch) if per_site else None, C,
                       Nx, Nth, float(m0), float(tol), int(max_iter), *path)
    return x, iters, rho, bnorm2


_SOLVE_SCRATCH = 32      # f32 values per half-lattice site (solve_fused.cu)


def solve_fused(thE, thO, b, x0, *, m0, tol, max_iter) -> SolveResult:
    """K2: (Dhat Dhat^+)^{-1} b by f32 CG from x0, links built in-kernel
    (pallas_traj.solve_fused). thE/thO f32 [C, 2, Nx, Nth]; b, x0 f32
    [C, 2, 2, Nx, Nth]. converged: the recursive f32 residual is below
    tol ||b||. CUDA tensors run csrc/solve_fused.cu, in shared memory or
    through a global scratch as ``cg_path`` says; CPU tensors run
    solve_fused_reference."""
    if not b.is_cuda:
        return solve_fused_reference(thE, thO, b, x0, m0=m0, tol=tol,
                                     max_iter=max_iter)
    C, _, Nx, Nth = thE.shape
    path, _ = cg_path(Nx, Nth, C, _cuda.sm_count(b.device))
    x, iters, rho, bnorm2 = _launch_solve(
        "solve_fused_launch", _SOLVE_SCRATCH if path == CG_GLOBAL else 0, thE,
        thO, b, x0, m0, tol, max_iter, path)
    return _solve_result(x, iters, rho, bnorm2, tol)


# ---------- K10: K2 with its x-shifts as one-hot products ----------

def one_hot_shift_matrices(Nx: int, dtype=torch.float32, device=None):
    """(P+, P-), one-hot [Nx, Nx]: (P+ a)[x] = a[x+1] and (P- a)[x] = a[x-1],
    periodic (bench_mxu_stencil._mxu_roll_mats)."""
    i = torch.arange(Nx, device=device).reshape(Nx, 1)
    j = torch.arange(Nx, device=device).reshape(1, Nx)
    return ((j == (i + 1) % Nx).to(dtype), (j == (i - 1 + Nx) % Nx).to(dtype))


class OneHotShiftGeometry(Geometry):
    """One lattice per chain whose x-shifts are products with the one-hot
    matrices, a plain matmul on the real and the imaginary planes; the
    t-shifts stay rolls. A product with a one-hot matrix is exact in any
    float arithmetic that multiplies by 0 and 1 and adds zeros exactly: on
    the CPU, and on the card only while
    torch.backends.cuda.matmul.allow_tf32 is False."""

    def shift(self, a, axis, delta):
        if axis != X_AXIS or abs(delta) != 1:
            return super().shift(a, axis, delta)
        rdtype = a.real.dtype if a.is_complex() else a.dtype
        P = one_hot_shift_matrices(a.shape[-2], rdtype, a.device)[0 if delta > 0 else 1]
        if a.is_complex():
            return torch.complex(P @ a.real, P @ a.imag)
        return P @ a


ONE_HOT = OneHotShiftGeometry()


def mxu_band_tiles(delta: int, m0: int, Nx: int):
    """The k-tiles (4 values of k from a multiple of 4, below Nx rounded up
    to 4, K4) of P+ (delta = +1) or P- (-1) that K10 runs for the row tile
    of rows m0 .. m0+7 (m0 a multiple of 8): (m0 + 4 i) mod K4 for P+ and
    (m0 - 4 + 4 i) mod K4 for P-, i < min(3, K4 / 4) (csrc/solve_mxu.cu
    band_steps and band_tile). They hold every nonzero of the tile's rows,
    the wrap included, each once; the tiles left out are zero there."""
    K4 = (Nx + 3) & ~3
    base = m0 if delta > 0 else m0 - 4
    return [(base + 4 * i) % K4 for i in range(min(3, K4 // 4))]


def shift_x_mxu_reference(a: torch.Tensor):
    """Plain twin of the shift entry of K10's library: (P+ a, P- a) of real
    planes [.., Nx, Nth] by matmul."""
    return ONE_HOT.shift(a, X_AXIS, +1), ONE_HOT.shift(a, X_AXIS, -1)


def shift_x_mxu(a: torch.Tensor):
    """(P+ a, P- a) of f32 planes [n, Nx, Nth]: the tensor-core shifts of
    csrc/solve_mxu.cu alone (its stages' banded fragments, four planes a
    block), (a[x+1], a[x-1]) bit for bit for finite input, a -0 coming out
    +0. CPU tensors run shift_x_mxu_reference."""
    if not a.is_cuda:
        return shift_x_mxu_reference(a)
    n, Nx, Nth = a.shape
    _cuda.check(a, "a", torch.float32, (n, Nx, Nth))
    out_p, out_m = torch.empty_like(a), torch.empty_like(a)
    p = _cuda.ptr
    _cuda.KERNELS.call("shift_mxu_launch", p(a), p(out_p), p(out_m), n, Nx, Nth)
    return out_p, out_m


def solve_fused_mxu_reference(thE, thO, b, x0, *, m0, tol, max_iter) -> SolveResult:
    """Plain twin of K10: the CG of K2's twin on the operator whose x-shifts
    are products with explicit one-hot matrices."""
    ue, uo = gauge.links(thE, thO)
    x, iters, rho, bnorm2 = _cg_f32(
        lambda v: eo.normal(ue, uo, v, m0, ONE_HOT), to_complex(b),
        to_complex(x0), tol, max_iter)
    return _solve_result(to_planar(x), iters, rho, bnorm2, tol)


def solve_fused_mxu(thE, thO, b, x0, *, m0, tol, max_iter) -> SolveResult:
    """K10: K2's solve with every x-shift of the stencil computed as a
    product with a one-hot [Nx, Nx] matrix on the tensor cores
    (tools/bench_mxu_stencil of the JAX package, variant "mxu_xshift").
    Arguments and result as solve_fused. CUDA tensors run
    csrc/solve_mxu.cu on K2's path (``cg_path``: K2's shared store up to
    64x64, its global scratch beyond), never K2 or a twin in its place; CPU
    tensors run solve_fused_mxu_reference."""
    if not b.is_cuda:
        return solve_fused_mxu_reference(thE, thO, b, x0, m0=m0, tol=tol,
                                         max_iter=max_iter)
    C, _, Nx, Nth = thE.shape
    path, _ = cg_path(Nx, Nth, C, _cuda.sm_count(b.device))
    x, iters, rho, bnorm2 = _launch_solve(
        "solve_mxu_launch", _SOLVE_SCRATCH if path == CG_GLOBAL else 0, thE,
        thO, b, x0, m0, tol, max_iter, path)
    return _solve_result(x, iters, rho, bnorm2, tol)


# ---------- K1: the fused force step ----------

class ForceStepResult(NamedTuple):
    FE: torch.Tensor         # f32 [C, 2, Nx, Nth] force at even sites
    FO: torch.Tensor         # f32 [C, 2, Nx, Nth] force at odd sites
    psi: torch.Tensor        # f32 [C, 2, 2, Nx, Nth], the solved psi (or x0)
    iters: torch.Tensor      # int32 [C] CG iterations (0 without the solve)
    converged: torch.Tensor  # bool [C] (all True without the solve)


def force_step_reference(thE, thO, phi, x0, *, m0, beta, tol, max_iter,
                         with_solve=True, with_gauge=True) -> ForceStepResult:
    """Plain twin of K1: [the f32 CG for psi = (Dhat Dhat^+)^{-1} phi from
    x0, else psi = x0], then the fermion force at both parities, plus the
    staple force with_gauge."""
    ue, uo = gauge.links(thE, thO)
    C = thE.shape[0]
    if with_solve:
        psi_c, iters, rho, bnorm2 = _cg_f32(
            lambda v: eo.normal(ue, uo, v, m0), to_complex(phi),
            to_complex(x0), tol, max_iter)
        psi, conv = to_planar(psi_c), _converged(rho, bnorm2, tol)
    else:
        psi, psi_c = x0, to_complex(x0)
        iters = torch.zeros(C, dtype=torch.int32, device=x0.device)
        conv = torch.ones(C, dtype=torch.bool, device=x0.device)
    chi_p = eo.dhat_dag(ue, uo, psi_c, m0)
    FE, FO = eo.fermion_force_planes(ue, uo, psi_c, chi_p, m0)
    if with_gauge:
        gfe, gfo = gauge.gauge_force_planes(ue, uo, beta)
        FE, FO = FE + gfe, FO + gfo
    return ForceStepResult(FE=FE, FO=FO, psi=psi, iters=iters, converged=conv)


_FORCE_SCRATCH = 22        # f32 values per half-lattice site (force_step.cu)
_FORCE_SOLVE_SCRATCH = 34  # the same with the CG's r, d, Ad


def force_step(thE, thO, phi, x0, *, m0, beta, tol, max_iter, with_solve=True,
               with_gauge=True) -> ForceStepResult:
    """K1: one MD force evaluation (pallas_traj.force_step_fused): links,
    with_solve the f32 CG on (Dhat Dhat^+) psi = phi from x0 in the same
    launch (else psi = x0, solved outside), chi' = Dhat^+ psi, the fermion
    force, and with_gauge the staple force. CUDA tensors run the kernel of
    csrc/force_step.cu, in shared memory or through a global scratch as
    ``cg_path`` says; CPU tensors run force_step_reference."""
    if not x0.is_cuda:
        return force_step_reference(thE, thO, phi, x0, m0=m0, beta=beta,
                                    tol=tol, max_iter=max_iter,
                                    with_solve=with_solve, with_gauge=with_gauge)
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(x0, "x0", torch.float32, (C, 2, 2, Nx, Nth))
    dev = x0.device
    FE = torch.empty_like(thE)
    FO = torch.empty_like(thO)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    conv = torch.empty(C, dtype=torch.bool, device=dev)
    p = _cuda.ptr
    if with_solve:
        _cuda.check(phi, "phi", torch.float32, (C, 2, 2, Nx, Nth))
        psi = torch.empty_like(x0)
        phi_ptr, psi_ptr = p(phi), p(psi)
    else:
        psi, phi_ptr, psi_ptr = x0, None, None
    path, blocks = cg_path(Nx, Nth, C, _cuda.sm_count(dev), with_solve, with_gauge)
    per_site = 0
    if path == CG_GLOBAL:
        per_site = _FORCE_SOLVE_SCRATCH if with_solve else _FORCE_SCRATCH
    scratch = torch.empty(C * per_site * Nx * Nth, dtype=torch.float32,
                          device=dev)
    _cuda.KERNELS.call("force_step_launch", p(thE), p(thO), phi_ptr, p(x0),
                       psi_ptr, p(FE), p(FO), p(iters), p(conv),
                       p(scratch) if per_site else None,
                       C, Nx, Nth, float(m0), float(beta), float(tol),
                       int(max_iter), int(bool(with_solve)),
                       int(bool(with_gauge)), path, blocks)
    return ForceStepResult(FE=FE, FO=FO, psi=psi, iters=iters, converged=conv)

# ---------- K5: the Hasenbusch ratio force ----------

def ratio_force_reference(thE, thO, psi, phi2, *, m0, m1, beta):
    """Plain twin of K5: ff(psi, Dhat0^+ psi; c0) - ff(psi, phi2; c1) +
    staples, (FE, FO) f32 [C, 2, Nx, Nth]."""
    ue, uo = gauge.links(thE, thO)
    psi_c = to_complex(psi)
    chi_p = eo.dhat_dag(ue, uo, psi_c, m0)
    f0e, f0o = eo.fermion_force_planes(ue, uo, psi_c, chi_p, m0)
    f1e, f1o = eo.fermion_force_planes(ue, uo, psi_c, to_complex(phi2), m1)
    gfe, gfo = gauge.gauge_force_planes(ue, uo, beta)
    return f0e - f1e + gfe, f0o - f1o + gfo


_RATIO_SCRATCH = 26      # f32 values per half-lattice site (ratio_force.cu)


def ratio_force_path(Nx: int, Nth: int, C: int, sms: int = _cuda.H100_SMS):
    """Where K5 keeps its fields: K1's rule without the solve, with the
    staples (``cg_path``), since its shared path is that kernel body on the
    same store. (path, blocks per chain)."""
    return cg_path(Nx, Nth, C, sms, solve=False, gauge=True)


def _launch_ratio(thE, thO, psi, phi2, m0, m1, beta, sms, path=None, blocks=1):
    """K5's launch on psi's device, on the path and blocks a chain
    ``ratio_force_path`` gives, or on `path` and `blocks` where the caller
    names them (the tools time every block count): a scratch only on the
    global path; (FE, FO)."""
    C, _, Nx, Nth = thE.shape
    if path is None:
        path, blocks = ratio_force_path(Nx, Nth, C, sms)
    FE = torch.empty_like(thE)
    FO = torch.empty_like(thO)
    scratch = None
    if path == CG_GLOBAL:
        scratch = torch.empty(C * _RATIO_SCRATCH * Nx * Nth,
                              dtype=torch.float32, device=psi.device)
    p = _cuda.ptr
    _cuda.KERNELS.call("ratio_force_launch", p(thE), p(thO), p(psi), p(phi2),
                       p(FE), p(FO), None if scratch is None else p(scratch),
                       C, Nx, Nth, float(m0), float(m1), float(beta), path,
                       blocks)
    return FE, FO


def ratio_force(thE, thO, psi, phi2, *, m0, m1, beta):
    """K5: the force of the Hasenbusch ratio term
    (Dhat1 phi2)^+ (Dhat0 Dhat0^+)^{-1} (Dhat1 phi2) at the solved
    psi = (Dhat0 Dhat0^+)^{-1} Dhat1 phi2, plus the staple force
    (pallas_traj.ratio_force_fused). CUDA tensors run csrc/ratio_force.cu,
    on the path ``ratio_force_path`` says; CPU tensors run
    ratio_force_reference."""
    if not psi.is_cuda:
        return ratio_force_reference(thE, thO, psi, phi2, m0=m0, m1=m1,
                                     beta=beta)
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(psi, "psi", torch.float32, (C, 2, 2, Nx, Nth))
    _cuda.check(phi2, "phi2", torch.float32, (C, 2, 2, Nx, Nth))
    FE, FO = _launch_ratio(thE, thO, psi, phi2, m0, m1, beta,
                           _cuda.sm_count(psi.device))
    return FE, FO
