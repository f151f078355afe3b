"""The restart refinement: f32 inner solves (K6), f64 true residual (K9),
f64 CG fallback (K4).

Counterpart of ``cg_refine`` in ``schwingermodel_tpu/solvers/refine.py``
(and of its double-float twin ``cg_refine_df`` and the packed
``solve_refined_packed``, which run the same passes), per entry, for C
configurations of B right-hand sides each. The measurement solves
(``models.schwinger.SchwingerModel.dirac_inverse``) run it under the
refined contract::

    x = 0, in f64;  r, rho = K9(b, x)
    max_outer times:
        active = rho >= stop2 and (first pass or rho * 4 <= rho_prev)
        d = K6(f32(r), x0 = 0, tol = inner_tol, active)
        x += d (f64) where active;  r, rho = K9(b, x, active)

with stop2 = tol^2 ||b||^2 in f64 and every test per entry: an entry that
stops keeps its state while the others go on, as the batched while_loop
of JAX's vmapped cg_refine does. An entry that stopped never starts again
(its rho and rho_prev stay as they were), so the passes after the last
active one change nothing: JAX's loop ends there, and here K6 and K9 skip
every entry outside the mask at once (their blocks return before any
work), so those passes cost their launches and no solve. iters sums the
inner iterations; passes counts, per entry, the passes in which it was
active (the largest over a batch is the number of passes that solved
anything; the rest of max_outer ran empty). With ``fallback`` the
entries still above stop2 continue in K4 from the f64 x (the
``cg_refine_df`` fallback ``_df_cg_finish``, with native f64 vectors and
its round contraction tau = 1e-5, not inner_tol); K4 reads the flags on
the device, so a converged entry passes through.

Host reads: none, so a CUDA graph captures the whole refinement (the
measurement program, hmc/program.py).

``cg_refine_geom`` is the same refinement for the unpacked sampler, on the
fields of a geometry (ops/geometry.py), with or without a mesh: the
counterpart of ``cg_refine`` with ``_f64_cg_finish`` as
``models.schwinger._solve_eo_refined`` calls it. The caller supplies the
f64 operator and the f32 inner solve (on a mesh the sharded K7 CG); the
true residual and the fallback, a plain f64 CG, are PyTorch through the
geometry, as JAX computes both outside any Pallas kernel. Both entry points
run the passes of ``_refine_passes``; this one ends them at the first pass
with no active entry, one host read a pass (its plain CG reads the host on
every iteration anyway).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from schwingermodel_tpu_torch.ops import cg_eo
from schwingermodel_tpu_torch.ops.geometry import bcast
from schwingermodel_tpu_torch.solvers.cg import CGResult, rel_residual
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops.refined import RefinedSolveResult


class EOKernels(NamedTuple):
    """The three solves of the refinement: the kernels, or their plain
    twins (PLAIN runs the twins on any device, for comparing the two on
    the card)."""
    cg: Callable           # K6, ops.cg_eo.cg_solve_eo
    residual: Callable     # K9, ops.refined.residual_f64
    fallback: Callable     # K4, ops.refined.solve_f64_cg_fallback


KERNELS = EOKernels(cg_eo.cg_solve_eo, rs.residual_f64,
                    rs.solve_f64_cg_fallback)
PLAIN = EOKernels(cg_eo.cg_solve_eo_reference, rs.residual_f64_reference,
                  rs.solve_f64_cg_fallback_reference)


class RefineResult(NamedTuple):
    """``cg_refine``'s result: a RefinedSolveResult's fields and the restart
    passes in which each entry was active."""
    x: torch.Tensor
    x64: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    fb_iters: torch.Tensor
    passes: torch.Tensor     # int32


def _refine_passes(residual, inner, x, stop2, max_outer, early_exit=False):
    """The passes of the restart refinement, per entry.

    residual(x, active=None, out=None) -> (r, rho): the f64 true residual
    of the f64 x and its squared norm; given a mask `active` and `out`, the
    previous (r, rho), it may leave the entries outside the mask as they
    are in `out` (K9 writes only the others). inner(r, active) -> (d,
    iters): the f32 solve of A d = r from 0 at the active entries (what it
    returns elsewhere is discarded). rho, stop2 and iters have one value
    per entry (any shape that ``bcast`` extends to x). An entry is active
    while rho >= stop2 and, after the first pass, its last pass contracted
    rho at least 4x; one that stops keeps its state and never starts
    again. All max_outer passes run, each masked, with no host read; with
    `early_exit` the loop ends at the first pass with no active entry (one
    host read a pass), with the same result. Returns (x, r, rho, iters,
    passes), passes the number of passes in which each entry was active."""
    r, rho = residual(x)
    rho_prev = torch.full_like(rho, float("inf"))
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=rho.device)
    actives = []
    for k in range(max_outer):
        active = rho >= stop2
        if k:
            active &= rho * 4.0 <= rho_prev      # stagnation: < 4x per pass
        if early_exit and not bool(active.any()):
            break
        d, it = inner(r, active)
        x = torch.where(bcast(active, x), x + d, x)
        rho_prev = torch.where(active, rho, rho_prev)
        r, rho_new = residual(x, active, (r, rho))
        rho = torch.where(active, rho_new, rho)
        iters = iters + torch.where(active, it, 0)
        actives.append(active)
    # counted once at the end: two operations, not one a pass
    passes = (torch.stack(actives).sum(dim=0, dtype=torch.int32) if actives
              else torch.zeros_like(iters))
    return x, r, rho, iters, passes


def cg_refine(thE, thO, ue, uo, b, *, m0, tol, inner_tol, max_iter,
              max_outer, fallback=True, kernels=KERNELS) -> RefineResult:
    """(Dhat Dhat^+)^{-1} b to the f64 relative tolerance `tol`.

    thE/thO f32 [C, 2, Nx, Nth] (K9 and K4 build f64 links from them);
    ue/uo their f32 folded links, planar [C, 2, 2, Nx, Nth] (K6); b f32
    planar [C, B, 2, 2, Nx, Nth]; the solve starts from x = 0 (the
    measurement solves have no forecast, as in JAX). Returns
    RefineResult with [C, B] leading axes: x64, its f32 round x, the
    summed iterations, converged = ||b - A x||^2 < tol^2 ||b||^2 on the
    f64 true residual, and the restart passes in which each entry was
    active."""
    C, B = b.shape[:2]
    bnorm2 = (b.double() ** 2).sum(dim=(2, 3, 4, 5))
    stop2 = (tol * tol) * bnorm2
    zero = torch.zeros_like(b)

    def inner(r, active):
        d = kernels.cg(ue, uo, r.float(), zero, m0=m0, tol=inner_tol,
                       max_iter=max_iter, active=active)
        return d.x.double(), d.iters

    def residual(x, active=None, out=None):
        return kernels.residual(thE, thO, b, x, m0=m0, active=active, out=out)

    x, _, rho, iters, passes = _refine_passes(
        residual, inner,
        torch.zeros(b.shape, dtype=torch.float64, device=b.device), stop2,
        max_outer)
    res = RefinedSolveResult(x=x.float(), x64=x, iters=iters,
                             converged=rho < stop2,
                             fb_iters=torch.zeros_like(iters))
    if fallback:
        flat = RefinedSolveResult(*(t.reshape(C * B, *t.shape[2:]) for t in res))

        def per_entry(th):
            """K4 takes the angles per entry: each configuration's B times."""
            return th[:, None].expand(C, B, *th.shape[1:]).reshape(C * B, *th.shape[1:])

        fb = kernels.fallback(per_entry(thE), per_entry(thO),
                              b.reshape(C * B, *b.shape[2:]), flat, m0=m0,
                              tol=tol, max_iter=max_iter)
        res = RefinedSolveResult(*(t.reshape(C, B, *t.shape[1:]) for t in fb))
    return RefineResult(*res, passes=passes)


# ---------- the refinement on a geometry ----------

def _f64_cg_finish(apply_A_hi, b_hi, x, r, rho, stop2, dot_re_hi, max_iter):
    """Plain f64 CG continuation from (x, r) for the chains still above
    stop2 (JAX ``_f64_cg_finish``): lifts the attainable residual from the
    f32 inner solves' floor to f64's. A chain below stop2 never starts; a
    chain that iterated is certified on its true residual afterwards. Per
    chain by masking, as solvers/cg.py. Returns (x, rho, iters)."""
    d = r
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=rho.device)
    for _ in range(max_iter):
        live = rho >= stop2
        if not bool(live.any()):
            break
        Ad = apply_A_hi(d)
        alpha = rho / dot_re_hi(d, Ad)
        lv = bcast(live, x)
        a = bcast(alpha, x)
        x = torch.where(lv, x + a * d, x)
        r = torch.where(lv, r - a * Ad, r)
        rho_new = dot_re_hi(r, r)
        d = torch.where(lv, r + bcast(rho_new / rho, x) * d, d)
        rho = torch.where(live, rho_new, rho)
        iters = iters + live.to(torch.int32)
    ran = iters > 0
    if bool(ran.any()):
        r_true = b_hi - apply_A_hi(x)
        rho = torch.where(ran, dot_re_hi(r_true, r_true), rho)
    return x, rho, iters


def cg_refine_geom(apply_A_hi, inner_solve, b, dot_re_hi, *, tol=1e-10,
                   max_outer=8, x0=None, fallback_max_iter=0) -> CGResult:
    """Solve A x = b per chain to the f64 relative tolerance `tol` (JAX
    ``cg_refine``).

    apply_A_hi: the operator on complex128 fields; inner_solve(rhs, x0) ->
    (dx, iters): an f32 solver of A d = rhs (complex64) to its own loose
    tolerance; b: any complex dtype; dot_re_hi: Re<x, y> over the global
    lattice, a chain scalar; x0: the start (a forecast), default 0. Returns
    CGResult with x complex128, iters the inner (and fallback) iterations,
    converged and rel_residual on the f64 true residual."""
    b_hi = b.to(torch.complex128)
    x = torch.zeros_like(b_hi) if x0 is None else x0.to(torch.complex128)
    b_norm2 = dot_re_hi(b_hi, b_hi)
    stop2 = (tol * tol) * b_norm2

    def residual(x, active=None, out=None):
        r = b_hi - apply_A_hi(x)
        return r, dot_re_hi(r, r)

    def inner(r, active):
        r_lo = r.to(torch.complex64)
        d, it = inner_solve(r_lo, torch.zeros_like(r_lo))
        return d.to(torch.complex128), it

    x, r, rho, iters, _ = _refine_passes(residual, inner, x, stop2,
                                         max_outer, early_exit=True)
    if fallback_max_iter > 0:
        x, rho, it_fb = _f64_cg_finish(apply_A_hi, b_hi, x, r, rho, stop2,
                                       dot_re_hi, fallback_max_iter)
        iters = iters + it_fb
    return CGResult(x=x, iters=iters, converged=rho < stop2,
                    rel_residual=rel_residual(rho, b_norm2))
