"""Refined-contract solves of (Dhat Dhat^+) x = b: kernels K3, K4 and K9.

Counterpart of the reliable-update half of
``schwingermodel_tpu/ops/pallas_df.py`` (``solve_refined_fused`` and
``solve_df_cg_fused``). The TPU kernels hold the solution and the true
residual in double-float; the card has native f64, so the port keeps the
algorithm and uses f64 for that half.

- ``solve_refined`` is K3 (``csrc/solve_ru.cu``, replacing
  ``pallas_df._solve_ru_kernel``): an f32 CG recursion with the solution
  accumulated in f64 and reliable updates of the residual by the f64 true
  residual. With ``fallback=True`` the chains it leaves unconverged go on
  as K4's f64 CG at the end of the same launch (the ``lax.cond`` of
  ``solve_refined_fused``): one launch per refined solve. Given a history
  of 2 <= K <= MRE_MAX earlier solutions in place of the start, the launch
  begins with the MRE forecast over it, from one pass of Gram sums and a
  Cholesky solve (``mre_forecast_reference``, modified Gram-Schmidt, is the
  definition it is held to by tolerance).
- ``solve_f64_cg_fallback`` is K4 as an entry of its own
  (``csrc/cg_fallback.cu``, replacing ``pallas_df._df_cg_fb_kernel``): the
  same f64 CG continuation (``csrc/cg_fallback.cuh``) for the entries the
  restart refinement (``solvers/refine.py``) left unconverged.
- ``residual_f64`` is K9 (``csrc/residual.cu``, replacing
  ``pallas_df._df_residual_kernel``): the f64 true residual
  r = b - (Dhat Dhat^+) x of the restart refinement, for C configurations
  of B right-hand sides each, on slabs of rows in shared memory where a
  split of at most 8 holds the lattice (``residual_path``); a mask leaves
  entries as they were in buffers the caller passes. Its scratch (the
  slabs' partials, the tickets the launch zeroes on its stream) is
  allocated on every call, which is legal inside a CUDA graph capture (the
  graph's memory pool, a memset node).

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

import functools
from typing import NamedTuple

import numpy as np
import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, gauge
from schwingermodel_tpu_torch.ops.traj import (CG_GLOBAL, CG_SHARED, _rows_fit,
                                               to_complex, to_planar)


class RefinedSolveResult(NamedTuple):
    x: torch.Tensor          # f32 [C, 2, 2, Nx, Nth], the f32 round of x64
    x64: torch.Tensor        # f64 [C, 2, 2, Nx, Nth]
    iters: torch.Tensor      # int32 [C], CG iterations, the fallback's included
    converged: torch.Tensor  # bool [C], ||b - A x|| < tol ||b||
    fb_iters: torch.Tensor   # int32 [C], f64 fallback iterations (0: it did not run)


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


def mre_forecast_reference(thE, thO, b, hist, *, m0) -> torch.Tensor:
    """The MRE forecast as modified Gram-Schmidt defines it (chronological
    inversion, the K > 1 branch of ``pallas_df._solve_ru_kernel``, line by
    line): the start x0 = psi_1 + d, d the minimum-residual correction over
    span{psi_i - psi_1}, taken in the difference space about the newest
    solution psi_1 = hist[0]. K3 computes the same correction another way
    (the Gram sums of the w in one pass, a Cholesky solve with the drop rule
    on its pivots, x0 in f64; csrc/solve_ru.cu mre_forecast) and is held to
    this function by tolerance; the CPU path of ``solve_refined`` starts
    from it.

    thE/thO f32 [C, 2, Nx, Nth]; b [C, 2, 2, Nx, Nth]; hist [K, C, 2, 2,
    Nx, Nth], newest first, f32 (as the TPU kernel) or f64. The working
    precision is hist's: the operator A = Dhat Dhat^+ from links of that
    precision, every vector operation in it, each dot the real Re<u, v>
    accumulated in f64 and rounded to it. Per chain: w0 = A psi_1, r1 = b -
    w0; for i = 1..K-1, v = psi_i - psi_1 and w = A psi_i - w0, modified
    Gram-Schmidt of (w, v) against the earlier pairs, w and v scaled to a
    unit w where |w|^2 > 1e-8 of the largest |w|^2 so far (else dropped:
    a duplicate history gives x0 = psi_1 exactly), x0 += <r1, w> v.
    Returns x0 [C, 2, 2, Nx, Nth] in hist's dtype."""
    real = hist.dtype
    ue, uo = gauge.links(thE, thO, torch.complex64 if real == torch.float32
                         else torch.complex128)

    def A(v):
        return to_planar(eo.normal(ue, uo, to_complex(v), m0))

    def dot(u, v):
        return (u.double() * v.double()).sum(dim=(1, 2, 3, 4),
                                             keepdim=True).to(real)

    tiny = torch.finfo(real).tiny
    base = hist[0]
    w0 = A(base)
    r1 = b.to(real) - w0
    x0 = base
    vs, ws, nrm_max = [], [], None
    for i in range(1, hist.shape[0]):
        # about the fixed base, not the accumulating x0: (v, w = A v) stay
        # a consistent pair
        v = hist[i] - base
        w = A(hist[i]) - w0
        for vj, wj in zip(vs, ws):
            c = dot(w, wj)
            w = w - c * wj
            v = v - c * vj
        nrm = dot(w, w)
        nrm_max = nrm if nrm_max is None else torch.maximum(nrm_max, nrm)
        inv = torch.where(nrm > 1e-8 * nrm_max,
                          torch.rsqrt(torch.clamp(nrm, min=tiny)),
                          torch.zeros_like(nrm))
        w, v = inv * w, inv * v
        x0 = x0 + dot(r1, w) * v
        vs.append(v)
        ws.append(w)
    return x0


def _start(thE, thO, b, x0, m0):
    """The start of a solve from K3's x0 argument: a start [C, ...] as it
    is, a history [K, C, ...] its newest entry (K = 1) or its MRE
    forecast."""
    if x0.ndim == b.ndim:
        return x0
    if x0.shape[0] == 1:
        return x0[0]
    return mre_forecast_reference(thE, thO, b, x0, m0=m0)


def solve_refined_reference(thE, thO, b, x0, *, m0, tol, tau=1e-5,
                            max_iter=10000, max_outer=12, certify=True,
                            cert_k=192, fallback=False,
                            fb_max_iter=None) -> RefinedSolveResult:
    """Plain twin of K3, chain by chain, from the start or the history x0
    (``solve_refined``); with the fallback, the plain twin of K4 on its
    result."""
    x0 = _start(thE, thO, b, x0, m0)
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
    res = RefinedSolveResult(
        x=x64.float(), x64=x64,
        iters=torch.tensor(its, dtype=torch.int32, device=b.device),
        converged=torch.tensor(cvs, dtype=torch.bool, device=b.device),
        fb_iters=torch.zeros(len(its), dtype=torch.int32, device=b.device))
    if not fallback:
        return res
    return solve_f64_cg_fallback_reference(
        thE, thO, b, res, m0=m0, tol=tol, tau=tau,
        max_iter=max_iter if fb_max_iter is None else fb_max_iter)


# Where K3 keeps its vectors, chosen by lattice size and chain count before
# the launch (solve_ru.cu): bytes of dynamic shared memory per half-lattice
# site of the f32 recursion and of the f64 set (a block may ask for
# _cuda.SHARED_MAX and holds _cuda.BLOCK_SITES sites).
_RU_SHARED_F32, _RU_SHARED_F64 = 96, 160
_FB_MAX_ROUNDS = 4   # solve_f64_cg_fallback's default max_rounds
MRE_MAX = 4          # the longest history K3 takes (solve_ru.cu kMreMax)
RU_GLOBAL, RU_SHARED, RU_ALL_SHARED, RU_CLUSTER, RU_L2 = range(5)


def _blocks_fit(Nx: int, Nth: int, n: int, f64_too: bool = False) -> bool:
    """n blocks a chain hold the f32 recursion: n divides Nx, a block's rows
    fit its threads and, with the two halo rows of a cluster (and with the
    f64 set of the whole lattice, f64_too), its shared memory."""
    if Nx % n:
        return False
    rows = Nx // n
    shared = _RU_SHARED_F32 * (rows + (2 if n > 1 else 0)) * Nth
    if f64_too:
        shared += _RU_SHARED_F64 * Nx * Nth
    return rows * Nth <= _cuda.BLOCK_SITES and shared <= _cuda.SHARED_MAX


def ru_path(Nx: int, Nth: int, C: int, clusters: dict, blocks: dict):
    """K3's path for C chains of an Nx x 2 Nth lattice: (path, blocks per
    chain). One block a chain wherever the f32 recursion fits its shared
    memory: RU_ALL_SHARED where the f64 true residual fits too (up to 32x32
    and a little above), RU_SHARED else (up to 64x64). A larger lattice is
    split by rows over n = 2, 4 or 8 blocks a chain, by what the card runs
    at once, both by n (``ru_card_counts`` asks the card): `clusters`, its
    clusters of n blocks of K3, and `blocks`, the blocks of K3's L2 kernel
    a cooperative launch may hold:
    1. RU_CLUSTER, the largest n whose C clusters all run at once;
    2. else RU_L2, the smallest n whose C n blocks all run at once, the
       same recursion on blocks that exchange through L2, in one wave
       (128x128 C=32 on an H100: 30 clusters of 4, 132 blocks);
    3. else RU_CLUSTER, the smallest n, in waves.
    What no split holds keeps every vector in the global scratch
    (RU_GLOBAL)."""
    if _blocks_fit(Nx, Nth, 1, f64_too=True):
        return RU_ALL_SHARED, 1
    if _blocks_fit(Nx, Nth, 1):
        return RU_SHARED, 1
    fits = [n for n in (2, 4, 8) if _blocks_fit(Nx, Nth, n)]
    if not fits:
        return RU_GLOBAL, 1
    at_once = [n for n in fits if C <= clusters[n]]
    if at_once:
        return RU_CLUSTER, max(at_once)
    resident = [n for n in fits if C * n <= blocks[n]]
    if resident:
        return RU_L2, min(resident)
    return RU_CLUSTER, min(fits)


def ru_route_name(path: int, n: int) -> str:
    return ("global", "shared", "all shared", f"cluster of {n}", f"L2 of {n}")[path]


@functools.lru_cache(maxsize=None)
def _at_once(Nx: int, Nth: int, path: int, n: int, index: int) -> int:
    with torch.cuda.device(index):
        return _cuda.KERNELS.query("solve_ru_at_once", Nx, Nth, path, n)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def ru_card_counts(Nx: int, Nth: int, device: torch.device):
    """The counts ``ru_path`` takes, from the card `device`: its clusters
    of n blocks of K3 (cudaOccupancyMaxActiveClusters) and the blocks of
    K3's L2 kernel it runs at once (the cooperative occupancy), by each n
    that holds the lattice where one block does not."""
    i = _index(device)
    fits = [] if _blocks_fit(Nx, Nth, 1) else [n for n in (2, 4, 8) if _blocks_fit(Nx, Nth, n)]
    return ({n: _at_once(Nx, Nth, RU_CLUSTER, n, i) for n in fits},
            {n: _at_once(Nx, Nth, RU_L2, n, i) for n in fits})


def ru_card_route(Nx: int, Nth: int, C: int, device: torch.device):
    """K3's launch for C chains on the card `device`: (path, blocks per
    chain, waves), the waves ceil(C / the chains it runs at once on that
    path)."""
    path, n = ru_path(Nx, Nth, C, *ru_card_counts(Nx, Nth, device))
    i = _index(device)
    if path == RU_CLUSTER:
        at_once = _at_once(Nx, Nth, path, n, i)
    else:
        at_once = _at_once(Nx, Nth, path, n, i) // n
    return path, n, -(-C // max(at_once, 1))


def _ru_scratch(path: int, fallback: bool):
    """(f32, f64) scratch values per half-lattice site and chain
    (solve_ru.cu): the f32 planes on the global path; the f64 links (8)
    and the larger of the true residual's planes (12) and the fallback's
    (24, cg_fallback.cuh) unless the f64 set lies in shared memory."""
    if path == RU_ALL_SHARED:
        return 0, 24 if fallback else 0
    return (28 if path == RU_GLOBAL else 0), 8 + (24 if fallback else 12)


# device -> the L2 path's exchange areas, the last the largest
_RU_XCH: dict = {}


def _ru_xch(C: int, words: int, device: torch.device) -> torch.Tensor:
    """The L2 path's exchange areas for C chains of `words` 8-byte words
    each (the kernel library's ``solve_ru_l2_words``): 0 before its first
    launch, and each launch sets its chains' back to 0 behind its last
    barrier (solve_ru.cu), so a graph that captures the launch holds no
    memset of them. One buffer a device, replaced by a larger one, zeroed
    as it is made, where a launch needs more; none is freed, since a
    captured graph keeps the address it was given. Launches that share them run one after
    another on one stream, as K3's launches of a program do; the first
    launch of a size is to come before a capture (the program's first
    trajectory is eager), or the capture holds the zeroing."""
    need = C * words
    bufs = _RU_XCH.setdefault(device, [])
    if not bufs or bufs[-1].numel() < need:
        bufs.append(torch.zeros(need, dtype=torch.int64, device=device))
    return bufs[-1]


def _launch_ru(thE, thO, b, hist, route, clocks=None, *, m0, tol, tau=1e-5,
               max_iter=10000, max_outer=12, certify=True, cert_k=192,
               fallback=False, fb_max_iter=None) -> RefinedSolveResult:
    """K3's launch on b's device on `route`, (path, blocks per chain), with
    the history hist [K, C, ...] (``solve_refined`` takes the route from
    ``ru_path`` on the card's counts; the card's tests compare routes): the
    scratch the path needs, and on the L2 path its exchange areas."""
    C, _, Nx, Nth = thE.shape
    path, n = route
    dev = b.device
    n32, n64 = _ru_scratch(path, bool(fallback))
    x = torch.empty_like(b)
    x64 = torch.empty(b.shape, dtype=torch.float64, device=dev)
    counts = torch.empty((2, C), dtype=torch.int32, device=dev)
    conv = torch.empty(C, dtype=torch.bool, device=dev)
    s32 = torch.empty(C * n32 * Nx * Nth, dtype=torch.float32, device=dev)
    s64 = torch.empty(C * n64 * Nx * Nth, dtype=torch.float64, device=dev)
    xch = None
    if path == RU_L2:
        xch = _ru_xch(C, _cuda.KERNELS.query("solve_ru_l2_words", n, Nth), dev)

    def p(t):
        return None if t is None else _cuda.ptr(t)

    _cuda.KERNELS.call(
        "solve_ru_launch", p(thE), p(thO), p(b), p(hist), hist.shape[0], p(x),
        p(x64), p(counts[0]), p(counts[1]), p(conv), p(s32), p(s64), p(clocks),
        p(xch), C, Nx, Nth,
        float(m0), float(tol), float(tau), int(max_iter), int(max_outer),
        int(bool(certify)), int(cert_k), int(bool(fallback)),
        int(max_iter if fb_max_iter is None else fb_max_iter),
        _FB_MAX_ROUNDS, path, n)
    return RefinedSolveResult(x=x, x64=x64, iters=counts[0], converged=conv,
                              fb_iters=counts[1])


def solve_refined(thE, thO, b, x0, *, m0, tol, tau=1e-5, max_iter=10000,
                  max_outer=12, certify=True, cert_k=192, fallback=False,
                  fb_max_iter=None, clocks=None) -> RefinedSolveResult:
    """K3: (Dhat Dhat^+)^{-1} b to relative tolerance `tol`, certified on
    the f64 true residual, from the start x0, or from the MRE forecast over
    a history of earlier solutions.

    thE/thO f32 [C, 2, Nx, Nth]; b f32 [C, 2, 2, Nx, Nth]; x0 f32 the start
    [C, 2, 2, Nx, Nth] or a history [K, C, 2, 2, Nx, Nth], newest first
    (``pallas_df.solve_refined_fused``'s hist): K = 1 starts from hist[0],
    K >= 2 from the MRE forecast over it (``mre_forecast_reference``),
    computed at the start of the same launch, on the card from the
    history's applies and one chain sum with no scratch of its own, for at
    most MRE_MAX solutions (the kernel keeps K - 1 of them at each thread's
    sites; a deeper history raises ValueError there). tau: the
    contraction of the recursive residual between true-residual
    replacements. certify=False (the MD force solves) trusts the recursive
    exit for segments shorter than cert_k iterations. converged: the last
    replaced residual, or the recursive one where certify=False skipped the
    replacement, is below tol^2 ||b||^2.

    fallback=True continues each chain that ends unconverged as K4's f64
    CG in the same launch (the same m0, tol and tau; at most fb_max_iter
    iterations, by default max_iter, in K4's default of 4 rounds): the
    result is that of ``solve_f64_cg_fallback`` on K3's, and fb_iters says
    per chain how many iterations it added. clocks, on the card only: an
    int64 [C, 4] tensor to which K3 adds each chain's clock cycles in this
    launch, of those the cycles in its f64 true residuals, the cycles its
    first thread spent waiting on the other blocks of its chain (0 but on
    the cluster and L2 paths) and those that thread spent in the MRE
    forecast (0 at K = 1); zero the tensor to read one launch. Where the
    kernel keeps its vectors follows from the lattice size, C and what the
    card runs at once (``ru_path`` on ``ru_card_counts``)."""
    kw = dict(m0=m0, tol=tol, tau=tau, max_iter=max_iter, max_outer=max_outer,
              certify=certify, cert_k=cert_k, fallback=fallback,
              fb_max_iter=fb_max_iter)
    if not b.is_cuda:
        return solve_refined_reference(thE, thO, b, x0, **kw)
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, 2, 2, Nx, Nth))
    hist = x0 if x0.ndim == 6 else x0[None]
    K = hist.shape[0]
    _cuda.check(hist, "x0", torch.float32, (K, C, 2, 2, Nx, Nth))
    if K > MRE_MAX:
        raise ValueError(f"x0: K3's MRE forecast takes at most {MRE_MAX} "
                         f"solutions on the card, got a history of {K}")
    if clocks is not None:
        _cuda.check(clocks, "clocks", torch.int64, (C, 4))
    route = ru_path(Nx, Nth, C, *ru_card_counts(Nx, Nth, b.device))
    return _launch_ru(thE, thO, b, hist, route, clocks, **kw)


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
        return prev._replace(fb_iters=torch.zeros_like(prev.iters))
    ue64, uo64 = gauge.links(thE, thO, torch.complex128)
    bc = to_complex(b)
    xc = to_complex(prev.x64)
    its = prev.iters.tolist()
    fb_its = [0] * len(its)
    xs = list(xc)
    for i, cv in enumerate(conv):
        if cv:
            continue
        xs[i], fb_its[i], conv[i] = _cg_fallback_chain(
            ue64[i], uo64[i], bc[i], xc[i], m0, tol, tau, max_iter, max_rounds)
        its[i] += fb_its[i]
    x64 = to_planar(torch.stack(xs))
    return RefinedSolveResult(
        x=x64.float(), x64=x64,
        iters=torch.tensor(its, dtype=torch.int32, device=b.device),
        converged=torch.tensor(conv, dtype=torch.bool, device=b.device),
        fb_iters=torch.tensor(fb_its, dtype=torch.int32, device=b.device))


_FB_S64 = 32   # f64 scratch values per half-lattice site (cg_fallback.cu)


def solve_f64_cg_fallback(thE, thO, b, prev: RefinedSolveResult, *, m0, tol,
                          tau=1e-5, max_iter=10000, max_rounds=4
                          ) -> RefinedSolveResult:
    """K4: continue the chains that ``prev`` (a refined result for the same
    system) left unconverged as an f64 CG, from prev.x64. A converged chain
    passes through unchanged; iterations add to prev.iters, and fb_iters
    holds this call's own. On CUDA the flags are read on the device, so the
    caller needs no host synchronisation to decide. The packed trajectory
    does not call it: ``solve_refined(fallback=True)`` runs the same body in
    K3's launch."""
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
    _cuda.check(prev.converged, "prev.converged", torch.bool, (C,))
    dev = b.device
    x = torch.empty_like(b)
    x64 = torch.empty_like(prev.x64)
    counts = torch.empty((2, C), dtype=torch.int32, device=dev)
    conv = torch.empty(C, dtype=torch.bool, device=dev)
    s64 = torch.empty(C * _FB_S64 * Nx * Nth, dtype=torch.float64, device=dev)
    p = _cuda.ptr
    _cuda.KERNELS.call(
        "cg_fallback_launch", p(thE), p(thO), p(b), p(prev.x64),
        p(prev.converged), p(prev.iters), p(x), p(x64), p(counts[0]),
        p(counts[1]), p(conv), p(s64), C, Nx, Nth, float(m0), float(tol),
        float(tau), int(max_iter), int(max_rounds))
    return RefinedSolveResult(x=x, x64=x64, iters=counts[0], converged=conv,
                              fb_iters=counts[1])


# ---------- K9 ----------

def residual_f64_reference(thE, thO, b, x, *, m0, active=None, out=None):
    """Plain twin of K9: (r f64 [C, B, 2, 2, Nx, Nth], ||r||^2 f64 [C, B]);
    with `out` written into it, only at the entries of `active` where a
    mask is given (residual_f64)."""
    ue64, uo64 = gauge.links(thE, thO, torch.complex128)
    r = (to_complex(b).to(torch.complex128)
         - eo.normal(ue64[:, None], uo64[:, None], to_complex(x), m0))
    rp = to_planar(r)
    rn = (rp * rp).sum(dim=(2, 3, 4, 5))
    if out is None:
        return rp, rn
    if active is not None:
        rp = torch.where(active[:, :, None, None, None, None], rp, out[0])
        rn = torch.where(active, rn, out[1])
    out[0].copy_(rp)
    out[1].copy_(rn)
    return out


# Bytes a half-lattice site of K9's shared route (csrc/residual.cu
# kResidualSharedBytes: the f64 links of both parities and two f64 spinor
# planes), f64 values a site and entry of its global scratch, and the
# right-hand sides one block may take.
_RES_SHARED_BYTES, _RES_SCRATCH, _RES_MAX_RHS = 128, 20, 8


def residual_routes(Nx: int, Nth: int, B: int):
    """K9's shared routes for B right-hand sides of an Nx x 2 Nth lattice:
    (CG_SHARED, slabs a configuration, right-hand sides a block) for every
    slab count of at most 8 that holds the lattice (``traj._rows_fit``; an
    odd Nx only whole) and every count of right-hand sides up to 8 that
    divides B."""
    return [(CG_SHARED, n, rhs) for n in ((1, 2, 4, 8) if Nx % 2 == 0 else (1,))
            if _rows_fit(Nx, Nth, n, _RES_SHARED_BYTES)
            for rhs in range(1, min(B, _RES_MAX_RHS) + 1) if B % rhs == 0]


@functools.lru_cache(maxsize=None)
def residual_path(Nx: int, Nth: int, C: int, B: int, sms: int = _cuda.H100_SMS):
    """Where K9 keeps its fields for C configurations of B right-hand sides
    of an Nx x 2 Nth lattice on a card of `sms` multiprocessors: (path,
    slabs a configuration, right-hand sides a block). A block holds a slab
    of rows of one configuration with its f64 links, built once, and runs
    `rhs` of its right-hand sides through them in turn, so a launch has
    C * (B / rhs) * slabs blocks. Of ``residual_routes`` (an odd Nx is not
    split: its rows' offsets would not wrap), the route with the most
    blocks that still run at once is taken, ties to the fewer
    slabs (fewer halo rows computed again); where none runs at once, the
    fewest blocks. K1's rule without the solve (``traj.split_rows``) with
    the right-hand sides a block as a second count; chosen by the card's
    time at every shape timed (``PERF.md`` section 6): 64x64 C=32 B=8 on 2
    slabs of 4 right-hand sides, C=2 on 8 slabs of 1, 32x32 C=32 B=8 on 1
    slab of 2, 128x128 C=8 B=8 on 8 slabs of 4, 64x64 C=128 B=8 on 2 slabs
    of 8. CG_GLOBAL where no split holds the lattice (one block an entry
    over a global scratch)."""
    routes = [(C * (B // rhs) * n, n, rhs) for _, n, rhs in residual_routes(Nx, Nth, B)]
    if not routes:
        return CG_GLOBAL, 1, 1
    at_once = [r for r in routes if r[0] <= sms]
    if at_once:
        _, n, rhs = min(at_once, key=lambda r: (-r[0], r[1]))
    else:
        _, n, rhs = min(routes, key=lambda r: (r[0], r[1]))
    return CG_SHARED, n, rhs


def residual_path_name(Nx: int, Nth: int, C: int, B: int, sms: int = _cuda.H100_SMS) -> str:
    path, blocks, rhs = residual_path(Nx, Nth, C, B, sms)
    if path == CG_GLOBAL:
        return "global"
    return (f"shared, {blocks} slab{'s' if blocks > 1 else ''} a configuration, "
            f"{rhs} right-hand side{'s' if rhs > 1 else ''} a block")


def _residual_scratch(C, B, Nx, Nth, route, device):
    """K9's scratch on `route`: (fields, tickets). The global route's 20 f64
    values a site and entry and no tickets; on a split the slabs' f64
    partials [C * B * blocks] and a uint32 ticket a block group, which the
    launch zeroes on its stream; on one slab neither."""
    path, blocks, rhs = route
    if path == CG_GLOBAL:
        return torch.empty(C * B * _RES_SCRATCH * Nx * Nth, dtype=torch.float64,
                           device=device), None
    if blocks > 1:
        return (torch.empty(C * B * blocks, dtype=torch.float64, device=device),
                torch.empty(C * (B // rhs), dtype=torch.int32, device=device))
    return None, None


def _launch_residual(thE, thO, b, x, m0, sms, route=None, active=None,
                     out=None):
    """K9's launch on b's device on ``residual_path``'s route, or on `route`
    (path, blocks, rhs) where the caller names one (the tools time and
    compare every route): the global scratch only on the global path, the
    slabs' f64 partials and the tickets only where a configuration spans
    several blocks; into `out` (r, rnorm2) where given, only at the entries
    of the mask `active` where one is given; (r, rnorm2)."""
    C, B, _, _, Nx, Nth = b.shape
    route = route or residual_path(Nx, Nth, C, B, sms)
    if out is None:
        out = (torch.empty_like(x),
               torch.empty((C, B), dtype=torch.float64, device=b.device))
    r, rnorm2 = out
    scratch, tickets = _residual_scratch(C, B, Nx, Nth, route, b.device)
    p = _cuda.ptr
    _cuda.KERNELS.call("residual_launch", p(thE), p(thO), p(b), p(x), p(r),
                       p(rnorm2), None if scratch is None else p(scratch),
                       None if tickets is None else p(tickets), C, B, Nx, Nth,
                       float(m0), None if active is None else p(active), *route)
    return r, rnorm2


def residual_f64(thE, thO, b, x, *, m0, active=None, out=None):
    """K9: r = b - (Dhat Dhat^+) x in f64, with the links evaluated in f64
    from the f32 angles, and each entry's f64 ||r||^2.

    thE/thO f32 [C, 2, Nx, Nth]; b f32 and x f64 [C, B, 2, 2, Nx, Nth].
    Returns (r f64 [C, B, 2, 2, Nx, Nth], rnorm2 f64 [C, B]): new tensors,
    or `out` (r, rnorm2) written in place where given. active: bool [C, B]
    on b's device, or None for every entry; with a mask `out` is required
    and its entries outside the mask stay as they were (the kernel neither
    reads their x nor computes them). CUDA tensors run csrc/residual.cu on
    the route ``residual_path`` gives; CPU tensors run
    residual_f64_reference."""
    if active is not None and out is None:
        raise ValueError("residual_f64: a mask needs the buffers `out` it "
                         "leaves unchanged outside the mask")
    if not b.is_cuda:
        return residual_f64_reference(thE, thO, b, x, m0=m0, active=active,
                                      out=out)
    C, B, _, _, Nx, Nth = b.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, B, 2, 2, Nx, Nth))
    _cuda.check(x, "x", torch.float64, (C, B, 2, 2, Nx, Nth))
    if active is not None:
        _cuda.check(active, "active", torch.bool, (C, B))
    if out is not None:
        _cuda.check(out[0], "out[0]", torch.float64, (C, B, 2, 2, Nx, Nth))
        _cuda.check(out[1], "out[1]", torch.float64, (C, B))
    out = _launch_residual(thE, thO, b, x, m0, _cuda.sm_count(b.device),
                           active=active, out=out)
    return out
