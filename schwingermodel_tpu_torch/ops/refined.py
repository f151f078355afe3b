"""Refined-contract solves of (Dhat Dhat^+) x = b: kernels K3, K4 and K9.

Counterpart of the reliable-update half of
``schwingermodel_tpu/ops/pallas_df.py`` (``solve_refined_fused`` and
``solve_df_cg_fused``). The TPU kernels hold the solution and the true
residual in double-float; the card has native f64, so the port keeps the
algorithm and uses f64 for that half.

- ``solve_refined`` is K3 (``csrc/solve_ru.cu``, replacing
  ``pallas_df._solve_ru_kernel``): an f32 CG recursion with the solution
  accumulated in f64 and reliable updates of the residual by the f64 true
  residual.
- ``solve_f64_cg_fallback`` is K4 (``csrc/cg_fallback.cu``, replacing
  ``pallas_df._df_cg_fb_kernel``): an f64 CG continuation for the chains
  K3 (or the restart refinement, ``solvers/refine.py``) left unconverged.
- ``residual_f64`` is K9 (``csrc/residual.cu``, replacing
  ``pallas_df._df_residual_kernel``): the f64 true residual
  r = b - (Dhat Dhat^+) x of the restart refinement, for C configurations
  of B right-hand sides each.

Per-chain semantics. The Pallas kernels advance all chains in lockstep and
couple them in three places: ``jnp.any`` over chains in the outer
progress test, the shared replacement gate of the force solves, and K4
iterating chains that had already converged. Here every decision reads
only the chain's own state, and ``max_iter`` caps each chain: the
reference's one CG per chain. Both the kernels (one thread block per
chain) and their plain twins below implement it.

CPU tensors run the plain twins; CUDA tensors run the kernels. Every dot
is accumulated in f64; the f32 recursion rounds it to f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, gauge
from schwingermodel_tpu_torch.ops.traj import to_complex, to_planar


class RefinedSolveResult(NamedTuple):
    x: torch.Tensor          # f32 [C, 2, 2, Nx, Nth], the f32 round of x64
    x64: torch.Tensor        # f64 [C, 2, 2, Nx, Nth]
    iters: torch.Tensor      # int32 [C], CG iterations
    converged: torch.Tensor  # bool [C], ||b - A x|| < tol ||b||


_f32 = np.float32


def _rdot(a: torch.Tensor, b: torch.Tensor) -> float:
    """Re<a, b> of complex tensors, accumulated in f64."""
    return float((a.real.double() * b.real.double()
                  + a.imag.double() * b.imag.double()).sum())


# ---------- K3 ----------

def _solve_ru_chain(ue, uo, ue64, uo64, b, x0, m0, tol, tau, max_iter,
                    max_outer, certify, cert_k):
    """One chain of the plain K3: complex b, x0 [2, Nx, Nth]. Returns
    (x64 complex128, iters, converged)."""
    b64 = b.to(torch.complex128)
    bnorm2 = _f32(_rdot(b, b))
    stop2 = _f32(tol * tol) * bnorm2
    tau2 = _f32(tau * tau)
    x = x0.to(torch.complex128)

    def true_residual():
        r = (b64 - eo.normal(ue64, uo64, x, m0)).to(torch.complex64)
        return r, _f32(_rdot(r, r))

    r, rho = true_residual()
    if rho > bnorm2:                      # forecast sanitizer
        x = torch.zeros_like(x)
        r, rho = b.clone(), bnorm2
    d = r
    rho_df, rho_df_prev = rho, _f32(np.inf)
    iters = k_tot = k_rep = ko = 0
    with np.errstate(all="ignore"):
        while (rho_df >= stop2 and ko < max_outer
               and (ko == 0 or rho_df * _f32(4.0) <= rho_df_prev)
               and k_tot < max_iter):
            tgt = max(stop2, tau2 * rho_df)
            dead = False
            while not dead and rho >= tgt and k_tot < max_iter:
                Ad = eo.normal(ue, uo, d, m0)
                dAd = _f32(_rdot(d, Ad))
                alpha = rho / dAd
                k_tot += 1
                if not dAd > 0 or not np.isfinite(alpha):
                    dead = True
                    break
                x = x + float(alpha) * d.to(torch.complex128)
                r = r + float(-alpha) * Ad
                rho_c = _f32(_rdot(r, r))
                if not np.isfinite(rho_c) or rho_c > _f32(1e6) * bnorm2:
                    dead = True
                    break
                beta = rho_c / rho
                d = r + float(beta) * d
                rho = rho_c
                iters += 1
            if certify or tgt > stop2 or k_tot - k_rep >= cert_k:
                r, rho = true_residual()
                k_rep = k_tot
            rho_df_prev, rho_df = rho_df, rho
            ko += 1
    return x, iters, bool(rho_df < stop2)


def solve_refined_reference(thE, thO, b, x0, *, m0, tol, tau=1e-5,
                            max_iter=10000, max_outer=12, certify=True,
                            cert_k=192) -> RefinedSolveResult:
    """Plain twin of K3, chain by chain."""
    ue, uo = gauge.links(thE, thO)
    ue64, uo64 = gauge.links(thE, thO, torch.complex128)
    bc, x0c = to_complex(b), to_complex(x0)
    xs, its, cvs = [], [], []
    for i in range(b.shape[0]):
        x, it, cv = _solve_ru_chain(ue[i], uo[i], ue64[i], uo64[i], bc[i],
                                    x0c[i], m0, tol, tau, max_iter, max_outer,
                                    certify, cert_k)
        xs.append(x)
        its.append(it)
        cvs.append(cv)
    x64 = to_planar(torch.stack(xs))
    return RefinedSolveResult(
        x=x64.float(), x64=x64,
        iters=torch.tensor(its, dtype=torch.int32, device=b.device),
        converged=torch.tensor(cvs, dtype=torch.bool, device=b.device))


_RU_S32, _RU_S64 = 32, 24   # scratch values per half-lattice site (solve_ru.cu)


def solve_refined(thE, thO, b, x0, *, m0, tol, tau=1e-5, max_iter=10000,
                  max_outer=12, certify=True, cert_k=192) -> RefinedSolveResult:
    """K3: (Dhat Dhat^+)^{-1} b to relative tolerance `tol`, certified on
    the f64 true residual, from the start x0.

    thE/thO f32 [C, 2, Nx, Nth]; b, x0 f32 [C, 2, 2, Nx, Nth]. tau: the
    contraction of the recursive residual between true-residual
    replacements. certify=False (the MD force solves) trusts the recursive
    exit for segments shorter than cert_k iterations. converged: the last
    replaced residual, or the recursive one where certify=False skipped the
    replacement, is below tol^2 ||b||^2."""
    if not b.is_cuda:
        return solve_refined_reference(
            thE, thO, b, x0, m0=m0, tol=tol, tau=tau, max_iter=max_iter,
            max_outer=max_outer, certify=certify, cert_k=cert_k)
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, 2, 2, Nx, Nth))
    _cuda.check(x0, "x0", torch.float32, (C, 2, 2, Nx, Nth))
    dev = b.device
    x = torch.empty_like(b)
    x64 = torch.empty(b.shape, dtype=torch.float64, device=dev)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    conv = torch.empty(C, dtype=torch.int32, device=dev)
    s32 = torch.empty(C * _RU_S32 * Nx * Nth, dtype=torch.float32, device=dev)
    s64 = torch.empty(C * _RU_S64 * Nx * Nth, dtype=torch.float64, device=dev)
    p = _cuda.ptr
    _cuda.KERNELS.call(
        "solve_ru_launch", p(thE), p(thO), p(b), p(x0), p(x), p(x64),
        p(iters), p(conv), p(s32), p(s64), C, Nx, Nth, float(m0), float(tol),
        float(tau), int(max_iter), int(max_outer), int(bool(certify)),
        int(cert_k))
    solve_refined.launches += 1
    return RefinedSolveResult(x=x, x64=x64, iters=iters,
                              converged=conv.to(torch.bool))


solve_refined.launches = 0


# ---------- K4 ----------

def _cg_fallback_chain(ue64, uo64, b, x_in, m0, tol, tau, max_iter,
                       max_rounds):
    """One unconverged chain of the plain K4: complex b [2, Nx, Nth] and
    x_in complex128. Returns (x complex128, iters, converged)."""
    b64 = b.to(torch.complex128)
    bnorm2 = _rdot(b64, b64)
    stop2 = tol * tol * bnorm2
    tau2 = tau * tau
    x = x_in

    def true_residual():
        r = b64 - eo.normal(ue64, uo64, x, m0)
        return r, _rdot(r, r)

    r, rho = true_residual()
    if rho > bnorm2:                      # zero-restart a poisoned entry
        x = torch.zeros_like(x)
        r, rho = b64.clone(), bnorm2
    x_entry, rho_entry = x, rho
    d = r
    rho_cert, rho_prev = rho, np.inf
    dead = False
    iters = k_tot = ko = 0
    with np.errstate(all="ignore"):
        while (rho_cert >= stop2 and not dead
               and (ko == 0 or rho_cert * 4.0 <= rho_prev)
               and k_tot < max_iter and ko < max_rounds):
            tgt = max(stop2 * 0.0625, tau2 * rho_cert)
            while not dead and rho >= tgt and k_tot < max_iter:
                Ad = eo.normal(ue64, uo64, d, m0)
                dAd = _rdot(d, Ad)
                alpha = np.float64(rho) / dAd
                k_tot += 1
                if not dAd > 0 or not np.isfinite(alpha):
                    dead = True
                    break
                x = x + float(alpha) * d
                r = r - float(alpha) * Ad
                rho_c = _rdot(r, r)
                if not np.isfinite(rho_c) or rho_c > 1e6 * bnorm2:
                    dead = True
                    break
                d = r + (rho_c / rho) * d
                rho = rho_c
                iters += 1
            r, rho = true_residual()
            if not dead:
                d = r
            rho_prev, rho_cert = rho_cert, rho
            ko += 1
    if not rho_cert < rho_entry:          # never worse than the entry
        x, rho_cert = x_entry, rho_entry
    return x, iters, bool(rho_cert < stop2)


def solve_f64_cg_fallback_reference(thE, thO, b, prev: RefinedSolveResult, *,
                                    m0, tol, tau=1e-5, max_iter=10000,
                                    max_rounds=4) -> RefinedSolveResult:
    """Plain twin of K4: chains that prev converged pass through."""
    conv = prev.converged.tolist()
    if all(conv):
        return prev
    ue64, uo64 = gauge.links(thE, thO, torch.complex128)
    bc = to_complex(b)
    xc = to_complex(prev.x64)
    its = prev.iters.tolist()
    xs = list(xc)
    for i, cv in enumerate(conv):
        if cv:
            continue
        xs[i], it, conv[i] = _cg_fallback_chain(
            ue64[i], uo64[i], bc[i], xc[i], m0, tol, tau, max_iter, max_rounds)
        its[i] += it
    x64 = to_planar(torch.stack(xs))
    return RefinedSolveResult(
        x=x64.float(), x64=x64,
        iters=torch.tensor(its, dtype=torch.int32, device=b.device),
        converged=torch.tensor(conv, dtype=torch.bool, device=b.device))


_FB_S64 = 36   # f64 scratch values per half-lattice site (cg_fallback.cu)


def solve_f64_cg_fallback(thE, thO, b, prev: RefinedSolveResult, *, m0, tol,
                          tau=1e-5, max_iter=10000, max_rounds=4
                          ) -> RefinedSolveResult:
    """K4: continue the chains that ``prev`` (a K3 result for the same
    system) left unconverged as an f64 CG, from prev.x64. A converged chain
    passes through unchanged; iterations add to prev.iters. On CUDA the
    flags are read on the device, so calling it after every K3 costs no
    host synchronisation."""
    if not b.is_cuda:
        return solve_f64_cg_fallback_reference(
            thE, thO, b, prev, m0=m0, tol=tol, tau=tau, max_iter=max_iter,
            max_rounds=max_rounds)
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, 2, 2, Nx, Nth))
    _cuda.check(prev.x64, "prev.x64", torch.float64, (C, 2, 2, Nx, Nth))
    _cuda.check(prev.iters, "prev.iters", torch.int32, (C,))
    dev = b.device
    conv_in = prev.converged.to(torch.int32)
    x = torch.empty_like(b)
    x64 = torch.empty_like(prev.x64)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    conv = torch.empty(C, dtype=torch.int32, device=dev)
    s64 = torch.empty(C * _FB_S64 * Nx * Nth, dtype=torch.float64, device=dev)
    p = _cuda.ptr
    _cuda.KERNELS.call(
        "cg_fallback_launch", p(thE), p(thO), p(b), p(prev.x64), p(conv_in),
        p(prev.iters), p(x), p(x64), p(iters), p(conv), p(s64), C, Nx, Nth,
        float(m0), float(tol), float(tau), int(max_iter), int(max_rounds))
    solve_f64_cg_fallback.launches += 1
    return RefinedSolveResult(x=x, x64=x64, iters=iters,
                              converged=conv.to(torch.bool))


solve_f64_cg_fallback.launches = 0


# ---------- K9 ----------

def residual_f64_reference(thE, thO, b, x, *, m0):
    """Plain twin of K9: (r f64 [C, B, 2, 2, Nx, Nth], ||r||^2 f64 [C, B])."""
    ue64, uo64 = gauge.links(thE, thO, torch.complex128)
    r = (to_complex(b).to(torch.complex128)
         - eo.normal(ue64[:, None], uo64[:, None], to_complex(x), m0))
    rp = to_planar(r)
    return rp, (rp * rp).sum(dim=(2, 3, 4, 5))


_RES_S64 = 20   # f64 scratch values per half-lattice site and entry (residual.cu)


def residual_f64(thE, thO, b, x, *, m0):
    """K9: r = b - (Dhat Dhat^+) x in f64, with the links evaluated in f64
    from the f32 angles, and each entry's f64 ||r||^2.

    thE/thO f32 [C, 2, Nx, Nth]; b f32 and x f64 [C, B, 2, 2, Nx, Nth].
    Returns (r f64 [C, B, 2, 2, Nx, Nth], rnorm2 f64 [C, B])."""
    if not b.is_cuda:
        return residual_f64_reference(thE, thO, b, x, m0=m0)
    C, B, _, _, Nx, Nth = b.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, B, 2, 2, Nx, Nth))
    _cuda.check(x, "x", torch.float64, (C, B, 2, 2, Nx, Nth))
    r = torch.empty_like(x)
    rnorm2 = torch.empty((C, B), dtype=torch.float64, device=b.device)
    s64 = torch.empty(C * B * _RES_S64 * Nx * Nth, dtype=torch.float64,
                      device=b.device)
    p = _cuda.ptr
    _cuda.KERNELS.call("residual_launch", p(thE), p(thO), p(b), p(x), p(r),
                       p(rnorm2), p(s64), C, B, Nx, Nth, float(m0))
    residual_f64.launches += 1
    return r, rnorm2


residual_f64.launches = 0
