"""The f32 CG on given links: kernel K6 (K6a and K6b in one).

Counterpart of ``schwingermodel_tpu/ops/pallas_eo.py`` (``cg_solve_eo_fused``
and its custom_vmap rule). The Pallas kernels solve (Dhat Dhat^+) x = b
from precomputed even-odd links, one system (``_cg_kernel``) or C systems
lane-packed (``_cg_kernel_mc``). The port has one entry point for both:
C configurations, each with B right-hand sides, one thread block per
(configuration, right-hand side) in ``csrc/cg_eo.cu``. K6a is C = B = 1.
Where an entry's vectors live follows from the lattice size
(K2's rule, ``ops/traj.cg_path`` with C*B entries): one block's shared
memory up to 64x64, a per-entry global scratch beyond.

The loop is the Pallas one: no breakdown guards, the stop rule
rho >= f32(tol^2) ||b||^2 on the recursive f32 residual, dots accumulated
in f64 and rounded to f32. So a zero right-hand side runs one iteration
(0/0) and leaves its entry unconverged with a NaN x, as the Pallas loop
does, where K2's guarded loop stops at 0 iterations. An optional mask
``active`` (bool [C, B]) leaves entries out: such an entry returns x = x0,
0 iterations and rho = ||b||^2 = 0 (so unconverged) at once, and the
others run as without the mask (the restart refinement's passes,
solvers/refine.py). Each entry stops on
its own (the Pallas K6b stops when no chain is live; a frozen chain does
not change, so the two agree, except that a NaN entry there stops every
chain: ROADMAP queue 3).

Layout: links ue, uo f32 planar [C, 2(dir), 2(re/im), Nx, Nt/2], the
antiperiodic sign folded into u0 (``eo.pack`` of the fermion links, as
``models.schwinger.SchwingerModel.fermion_links`` builds them); b, x0, x
f32 planar [C, B, 2(spin), 2(re/im), Nx, Nt/2]. CPU tensors run the plain
twin ``cg_solve_eo_reference``; CUDA tensors run the kernel.
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops import _cuda, eo
from schwingermodel_tpu_torch.ops.traj import (CG_GLOBAL, SolveResult, _cg_f32,
                                               _solve_result, cg_path,
                                               to_complex, to_planar)


def _result(x, iters, rho, bnorm2, tol, C, B) -> SolveResult:
    """SolveResult of C*B flat entries, reshaped to [C, B]."""
    res = _solve_result(x, iters, rho, bnorm2, tol)
    return SolveResult(*(t.reshape(C, B, *t.shape[1:]) for t in res))


def cg_solve_eo_reference(ue, uo, b, x0, *, m0, tol, max_iter,
                          active=None) -> SolveResult:
    """Plain twin of K6: every entry batched, each with its own live mask,
    no breakdown guards; the entries `active` leaves out as K6 leaves them."""
    C, B, _, _, Nx, Nth = b.shape
    uec = to_complex(ue)[:, None]
    uoc = to_complex(uo)[:, None]

    def apply_A(v):
        return eo.normal(uec, uoc, v.reshape(C, B, 2, Nx, Nth), m0).reshape(v.shape)

    flat = None if active is None else active.reshape(C * B)
    x, iters, rho, bnorm2 = _cg_f32(
        apply_A, to_complex(b).reshape(C * B, 2, Nx, Nth),
        to_complex(x0).reshape(C * B, 2, Nx, Nth), tol, max_iter, guards=False,
        active=flat)
    if flat is not None:
        rho, bnorm2 = (torch.where(flat, v, 0.0) for v in (rho, bnorm2))
    return _result(to_planar(x), iters, rho, bnorm2, tol, C, B)


_CG_EO_SCRATCH = 24      # f32 values per half-lattice site and entry (cg_eo.cu)


def _launch(ue, uo, b, x0, m0, tol, max_iter, sms, path=None, active=None):
    """K6's launch on b's device, on K2's path for its C*B entries
    (``cg_path``: one block an entry, in shared memory up to 64x64), or on
    `path` where the caller names one (the tools time and compare both): a
    scratch only on the global path; the mask `active` or none;
    (x, iters, rho, bnorm2)."""
    C, B, _, _, Nx, Nth = b.shape
    if path is None:
        path, _ = cg_path(Nx, Nth, C * B, sms)
    dev = b.device
    x = torch.empty_like(b)
    iters = torch.empty((C, B), dtype=torch.int32, device=dev)
    rho = torch.empty((C, B), dtype=torch.float32, device=dev)
    bnorm2 = torch.empty((C, B), dtype=torch.float32, device=dev)
    scratch = None
    if path == CG_GLOBAL:
        scratch = torch.empty(C * B * _CG_EO_SCRATCH * Nx * Nth,
                              dtype=torch.float32, device=dev)
    p = _cuda.ptr
    _cuda.KERNELS.call("cg_eo_launch", p(ue), p(uo), p(b), p(x0), p(x),
                       p(iters), p(rho), p(bnorm2),
                       None if scratch is None else p(scratch), C, B, Nx, Nth,
                       float(m0), float(tol), int(max_iter),
                       None if active is None else p(active), path)
    return x, iters, rho, bnorm2


def cg_solve_eo(ue, uo, b, x0, *, m0, tol, max_iter, active=None) -> SolveResult:
    """K6: (Dhat Dhat^+)^{-1} b by f32 CG from x0 on the given links, for C
    configurations of B right-hand sides each; `active` (bool [C, B] on b's
    device, or None for all) leaves entries out (module docstring). Returns
    SolveResult with [C, B] leading axes; converged: the recursive f32
    residual is below tol ||b||. CUDA tensors run csrc/cg_eo.cu, in shared
    memory or through a global scratch as ``cg_path`` says for its C*B
    entries."""
    if not b.is_cuda:
        return cg_solve_eo_reference(ue, uo, b, x0, m0=m0, tol=tol,
                                     max_iter=max_iter, active=active)
    C, B, _, _, Nx, Nth = b.shape
    _cuda.check(ue, "ue", torch.float32, (C, 2, 2, Nx, Nth))
    _cuda.check(uo, "uo", torch.float32, (C, 2, 2, Nx, Nth))
    _cuda.check(b, "b", torch.float32, (C, B, 2, 2, Nx, Nth))
    _cuda.check(x0, "x0", torch.float32, (C, B, 2, 2, Nx, Nth))
    if active is not None:
        _cuda.check(active, "active", torch.bool, (C, B))
    x, iters, rho, bnorm2 = _launch(ue, uo, b, x0, m0, tol, max_iter,
                                    _cuda.sm_count(b.device), active=active)
    return _solve_result(x, iters, rho, bnorm2, tol)
