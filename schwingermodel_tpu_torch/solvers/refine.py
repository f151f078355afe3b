"""The restart refinement: f32 inner solves (K6), f64 true residual (K9),
f64 CG fallback (K4).

Counterpart of ``cg_refine`` in ``schwingermodel_tpu/solvers/refine.py``
(and of its double-float twin ``cg_refine_df`` and the packed
``solve_refined_packed``, which run the same passes), per entry, for C
configurations of B right-hand sides each. The measurement solves
(``models.schwinger.SchwingerModel.dirac_inverse``) run it under the
refined contract::

    x = 0, in f64;  r, rho = K9(b, x)
    while rho >= stop2, passes < max_outer, and (first pass or
          rho * 4 <= rho_prev):
        d = K6(f32(r), x0 = 0, tol = inner_tol)
        x += d (f64);  r, rho = K9(b, x)

with stop2 = tol^2 ||b||^2 in f64 and every test per entry: an entry that
stops keeps its state while the others go on, as the batched while_loop
of JAX's vmapped cg_refine does. iters sums the inner iterations. With
``fallback`` the entries still above stop2 continue in K4 from the f64 x
(the ``cg_refine_df`` fallback ``_df_cg_finish``, with native f64
vectors and its round contraction tau = 1e-5, not inner_tol); K4 reads the
flags on the device, so a converged entry passes through.

Host reads: one per pass (whether any entry is still active). The K4 call
needs none.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from schwingermodel_tpu_torch.ops import cg_eo
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


def cg_refine(thE, thO, ue, uo, b, *, m0, tol, inner_tol, max_iter,
              max_outer, fallback=True, kernels=KERNELS) -> RefinedSolveResult:
    """(Dhat Dhat^+)^{-1} b to the f64 relative tolerance `tol`.

    thE/thO f32 [C, 2, Nx, Nth] (K9 and K4 build f64 links from them);
    ue/uo their f32 folded links, planar [C, 2, 2, Nx, Nth] (K6); b f32
    planar [C, B, 2, 2, Nx, Nth]; the solve starts from x = 0 (the
    measurement solves have no forecast, as in JAX). Returns
    RefinedSolveResult with [C, B] leading axes: x64, its f32 round x, the
    summed iterations, and converged = ||b - A x||^2 < tol^2 ||b||^2 on the
    f64 true residual."""
    C, B = b.shape[:2]
    x = torch.zeros(b.shape, dtype=torch.float64, device=b.device)
    bnorm2 = (b.double() ** 2).sum(dim=(2, 3, 4, 5))
    stop2 = (tol * tol) * bnorm2
    r, rho = kernels.residual(thE, thO, b, x, m0=m0)
    rho_prev = torch.full_like(rho, float("inf"))
    iters = torch.zeros((C, B), dtype=torch.int32, device=b.device)
    zero = torch.zeros_like(b)
    for k in range(max_outer):
        active = rho >= stop2
        if k:
            active &= rho * 4.0 <= rho_prev      # stagnation: < 4x per pass
        if not bool(active.any()):
            break
        d = kernels.cg(ue, uo, r.float(), zero, m0=m0, tol=inner_tol,
                       max_iter=max_iter)
        per_entry = active.reshape(C, B, 1, 1, 1, 1)
        x = torch.where(per_entry, x + d.x.double(), x)
        r, rho_new = kernels.residual(thE, thO, b, x, m0=m0)
        rho_prev = torch.where(active, rho, rho_prev)
        rho = torch.where(active, rho_new, rho)
        iters = iters + torch.where(active, d.iters, 0)
    res = RefinedSolveResult(x=x.float(), x64=x, iters=iters,
                             converged=rho < stop2)
    if not fallback:
        return res
    flat = RefinedSolveResult(*(t.reshape(C * B, *t.shape[2:]) for t in res))
    # K4 takes the angles per entry: each configuration's repeated B times
    fb = kernels.fallback(thE.repeat_interleave(B, dim=0),
                          thO.repeat_interleave(B, dim=0),
                          b.reshape(C * B, *b.shape[2:]), flat, m0=m0,
                          tol=tol, max_iter=max_iter)
    return RefinedSolveResult(*(t.reshape(C, B, *t.shape[1:]) for t in fb))
