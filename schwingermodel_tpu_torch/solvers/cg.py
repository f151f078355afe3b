"""Conjugate gradient: the reference's loop, and one with one global
reduction per iteration.

Counterpart of ``schwingermodel_tpu/solvers/cg.py``: ``cg_solve``, the
reference's two-reduction loop, and ``cg_solve_single_reduction``, the CG
that every non-fused solve of the unpacked sampler runs. All four inner products <r,r>, <d,Ad>, <Ad,Ad>,
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
still live. On CPU tensors the loop runs eagerly. On the card an
iteration is some 100 small launches, bound by the host's launch rate, so
each solve captures one iteration as a CUDA graph and replays it: the
same kernels on the same buffers, one graph launch and one host read an
iteration.
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


def cg_solve(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    dot_re: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    x0: torch.Tensor | None = None,
    tol: float = 1e-10,
    max_iter: int = 10000,
) -> CGResult:
    """The reference's CG with its two reductions an iteration, <d,Ad> and
    then <r',r'> (JAX ``cg_solve``; src/conjugate_gradient.cpp:14-44), per
    chain: solve A x = b for hermitian positive-definite A from x0 (default
    b) until ||r|| < tol ||b|| or max_iter iterations, a chain whose stop
    rule has fired frozen by masking. The CG scalars are real (the
    reference's complex alpha and beta have imaginary parts of rounding
    only). The unpacked sampler runs ``cg_solve_single_reduction``; this
    is the library's plain form, run eagerly on any device."""
    x = (b if x0 is None else x0).clone()
    b_norm2 = dot_re(b, b)
    stop2 = (tol * tol) * b_norm2
    r = b - apply_A(x)
    d = r.clone()
    rho = dot_re(r, r)
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=b.device)
    for _ in range(max_iter):
        live = rho >= stop2                  # a NaN rho never starts
        if not bool(live.any()):
            break
        Ad = apply_A(d)
        alpha = rho / dot_re(d, Ad)
        lv = bcast(live, x)
        x = torch.where(lv, x + bcast(alpha, x) * d, x)
        r_new = torch.where(lv, r - bcast(alpha, r) * Ad, r)
        rho_new = dot_re(r_new, r_new)
        d = torch.where(lv, r_new + bcast(rho_new / rho, d) * d, d)
        r = r_new
        rho = torch.where(live, rho_new, rho)
        iters += live
    return CGResult(x=x, iters=iters, converged=rho < stop2,
                    rel_residual=rel_residual(rho, b_norm2))


def cg_solve_single_reduction(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    dot_re: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dot_batch_re: Callable,
    *,
    x0: torch.Tensor | None = None,
    tol: float = 1e-10,
    max_iter: int = 10000,
    graph: bool = True,
) -> CGResult:
    """Solve A x = b per chain for hermitian positive-definite A, from x0
    (default b), until ||r|| < tol ||b|| or max_iter iterations.

    dot_re(x, y): Re<x, y> over the global lattice, a chain scalar.
    dot_batch_re(pairs): the same for a list of pairs with one reduction,
    stacked along the last axis. graph=False runs the loop eagerly on the
    card too (an operator whose collectives leave the card cannot be
    captured)."""
    x = b if x0 is None else x0
    b_norm2 = dot_re(b, b)
    stop2 = (tol * tol) * b_norm2
    r = b - apply_A(x)
    x, d = x.clone(), r.clone()
    rho = dot_re(r, r)
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=b.device)

    def step():
        """One iteration, written into x, r, d, rho and iters in place (so
        that a CUDA graph of it replays on the same buffers)."""
        live = rho >= stop2                  # a NaN rho never starts
        Ad = apply_A(d)
        rr, dAd, AdAd, rAd = dot_batch_re(
            [(r, r), (d, Ad), (Ad, Ad), (r, Ad)]).unbind(-1)
        alpha = rr / dAd
        lv = bcast(live, x)
        a = bcast(alpha, x)
        x.copy_(torch.where(lv, torch.addcmul(x, a, d), x))
        r_new = torch.where(lv, torch.addcmul(r, a, Ad, value=-1.0), r)
        rho_new = torch.addcmul(torch.addcmul(rr, alpha, rAd, value=-2.0),
                                alpha * alpha, AdAd)
        d.copy_(torch.where(lv, torch.addcmul(r_new, bcast(rho_new / rr, x), d), d))
        r.copy_(r_new)
        rho.copy_(torch.where(live, rho_new, rho))
        iters.add_(live)

    def any_live() -> bool:
        return bool((rho >= stop2).any())

    (_loop_graphed if b.is_cuda and graph else _loop)(step, any_live, max_iter)
    rho_exact = dot_re(r, r)                 # un-drifted exit check
    return CGResult(x=x, iters=iters, converged=rho_exact < stop2,
                    rel_residual=rel_residual(rho_exact, b_norm2))


def _loop(step, any_live, max_iter: int) -> None:
    for _ in range(max_iter):
        if not any_live():
            break
        step()


def _loop_graphed(step, any_live, max_iter: int) -> None:
    """The same iterations on the card, the first one eager (on a side
    stream, as a capture's warm-up) and the rest replays of a CUDA graph
    of one iteration, captured for this solve (the operator's tensors
    change from solve to solve): the same kernels on the same buffers, so
    the same bits, at one graph launch and one host read an iteration in
    place of some 100 launches."""
    if max_iter < 1 or not any_live():
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(max_iter - 1):
        if not any_live():
            break
        graph.replay()
