"""Conjugate gradient with one global reduction per iteration.

Counterpart of ``cg_solve_single_reduction`` in
``schwingermodel_tpu/solvers/cg.py``: the CG that every non-fused solve of
the unpacked sampler runs. All four inner products <r,r>, <d,Ad>, <Ad,Ad>,
<r,Ad> ride one batched reduction (one psum on a mesh), and the next
residual norm follows from

    ||r - alpha Ad||^2 = <r,r> - 2 alpha <r,Ad> + alpha^2 <Ad,Ad>;

<r,r> is measured anew every iteration, so the expansion's error does not
accumulate, and the flag and the residual are measured once more after the
loop.

Chains. JAX runs the loop per chain under ``vmap``, which freezes a chain
whose own stop rule has fired while the others go on. Here all chains
advance together and a chain is frozen by masking its updates
(``torch.where``, never 0 * d): a frozen chain does not change, so results
and iteration counts equal the per-chain loops'. The iteration counts stay
on the device; the host reads once per iteration whether any chain is
still live. The eager loop is bound by the host's launch rate (some 40
small launches per iteration), so that read costs a fraction of an
iteration, and reading less often (which adds iterations in which every
chain is frozen) measured no faster on an H100.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from schwingermodel_tpu_torch.ops.geometry import bcast

class CGResult(NamedTuple):
    x: torch.Tensor             # solution
    iters: torch.Tensor         # int32 chain scalar, iterations while live
    converged: torch.Tensor     # bool chain scalar
    rel_residual: torch.Tensor  # ||r|| / ||b|| at exit


def rel_residual(rho: torch.Tensor, b_norm2: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(b_norm2.dtype).tiny
    return torch.sqrt(rho.abs()) * torch.rsqrt(torch.clamp(b_norm2, min=tiny))


def cg_solve_single_reduction(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    dot_re: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dot_batch_re: Callable,
    *,
    x0: torch.Tensor | None = None,
    tol: float = 1e-10,
    max_iter: int = 10000,
) -> CGResult:
    """Solve A x = b per chain for hermitian positive-definite A, from x0
    (default b), until ||r|| < tol ||b|| or max_iter iterations.

    dot_re(x, y): Re<x, y> over the global lattice, a chain scalar.
    dot_batch_re(pairs): the same for a list of pairs with one reduction,
    stacked along the last axis."""
    x = b if x0 is None else x0
    b_norm2 = dot_re(b, b)
    stop2 = (tol * tol) * b_norm2
    r = b - apply_A(x)
    d = r
    rho = dot_re(r, r)
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=b.device)
    for _ in range(max_iter):
        live = rho >= stop2                  # a NaN rho never starts
        if not bool(live.any()):
            break
        Ad = apply_A(d)
        rr, dAd, AdAd, rAd = dot_batch_re(
            [(r, r), (d, Ad), (Ad, Ad), (r, Ad)]).unbind(-1)
        alpha = rr / dAd
        lv = bcast(live, x)
        a = bcast(alpha, x)
        x = torch.where(lv, x + a * d, x)
        r = torch.where(lv, r - a * Ad, r)
        rho_new = rr - 2.0 * alpha * rAd + alpha * alpha * AdAd
        d = torch.where(lv, r + bcast(rho_new / rr, x) * d, d)
        rho = torch.where(live, rho_new, rho)
        iters = iters + live.to(torch.int32)
    rho_exact = dot_re(r, r)                 # un-drifted exit check
    return CGResult(x=x, iters=iters, converged=rho_exact < stop2,
                    rel_residual=rel_residual(rho_exact, b_norm2))
