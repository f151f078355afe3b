"""Trajectory-state operations on the port layout, and kernel K1.

Counterpart of ``schwingermodel_tpu/ops/pallas_traj.py``. The TPU package
keeps the state lane-packed, [A, Nx, C*Nt/2]; the port keeps it
chain-major and planar in f32:

- angle, momentum and force planes [C, 2(dir), Nx, Nt/2], one per parity;
- even-parity spinors [C, 2(spin), 2(re/im), Nx, Nt/2].

``force_step`` is kernel K1 (``csrc/force_step.cu``, replacing
``pallas_traj._force_step_kernel`` with ``with_solve=False``); on a CPU
tensor it runs ``force_step_reference``, its plain twin. ``from_jax_packed``
and ``to_jax_packed`` convert the JAX package's lane-packed numpy planes to
and from this layout: the parameter bridge between the two packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, gauge


# ---------- layout conversions ----------

def pack_planes(a: torch.Tensor):
    """[C, A, Nx, Nt] full-lattice field -> (E, O) [C, A, Nx, Nt/2]."""
    return eo.pack(a, eo.EVEN), eo.pack(a, eo.ODD)


def to_planar(z: torch.Tensor) -> torch.Tensor:
    """complex [C, 2, Nx, Nth] -> planar [C, 2, 2, Nx, Nth] (real dtype)."""
    return torch.stack([z.real, z.imag], dim=2)


def to_complex(p: torch.Tensor) -> torch.Tensor:
    """planar [C, 2, 2, Nx, Nth] -> complex [C, 2, Nx, Nth]."""
    return torch.complex(p[:, :, 0], p[:, :, 1])


def from_jax_packed(p, C: int, device=None) -> torch.Tensor:
    """JAX lane-packed numpy planes [A.., Nx, C*Nth] -> chain-major tensor
    [C, A.., Nx, Nth] (pallas_traj.pack_chains / pack_even layout)."""
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


# ---------- the fermion force ----------

def _fermion_force_p(u, x_p, y_p, x_q, y_q, off_p):
    """(f0, f1) at parity-p sites: the reference force stencil (reference
    src/dirac_operator.cpp:486-505, Eqs (37)-(38)) with left operand x and
    right operand y; the opposite-parity x_q, y_q are gathered at n+t and
    n+x (pallas_traj._fermion_force_p)."""
    u0, u1 = u[:, 0], u[:, 1]
    x0, x1 = x_p[:, 0], x_p[:, 1]
    y0, y1 = y_p[:, 0], y_p[:, 1]
    yt = eo._gather_pt(y_q[:, 0] - y_q[:, 1], off_p)
    xt = eo._gather_pt(x_q[:, 0] + x_q[:, 1], off_p)
    yx = eo._px(y_q[:, 0] + 1j * y_q[:, 1])
    xx = eo._px(x_q[:, 0] - 1j * x_q[:, 1])
    f0 = (u0 * (torch.conj(x0 - x1) * yt)).imag \
        - (torch.conj(u0) * (torch.conj(xt) * (y0 + y1))).imag
    f1 = (u1 * (torch.conj(x0 + 1j * x1) * yx)).imag \
        + (torch.conj(u1) * (torch.conj(xx) * (-y0 + 1j * y1))).imag
    return torch.stack([f0, f1], dim=1)


def fermion_force_planes(ue, uo, psi, chi_p, m0):
    """(FE, FO) = 2c f(x = psi (+) b, y = a (+) chi') on both parities, with
    a = H_oe chi' and b = (H_eo)^+ psi (pallas_traj.fermion_force_planes):
    F = -dS_f/dtheta for S_f = Phi^+ (Dhat Dhat^+)^{-1} Phi at
    psi = (Dhat Dhat^+)^{-1} Phi, chi' = Dhat^+ psi. Complex operands."""
    _, c = eo.mass_terms(m0)
    Nx = psi.shape[-2]
    off_e = eo.row_offset(Nx, eo.EVEN, psi.device)
    off_o = eo.row_offset(Nx, eo.ODD, psi.device)
    a_o = eo.hop(uo, ue, chi_p, off_o)
    b_o = eo.hop_dag(uo, ue, psi, off_o)
    two_c = 2.0 * c
    fe = _fermion_force_p(ue, psi, chi_p, b_o, a_o, off_e)
    fo = _fermion_force_p(uo, b_o, a_o, psi, chi_p, off_o)
    return two_c * fe, two_c * fo


# ---------- K1: the fused force step ----------

def force_step_reference(thE, thO, psi, m0, beta):
    """Plain twin of K1: total MD force (fermion + staple) at both parities
    from the solved psi (planar f32 [C, 2, 2, Nx, Nth]). Returns (FE, FO)
    f32 [C, 2, Nx, Nth]."""
    ue, uo = gauge.links(thE, thO)
    psi_c = to_complex(psi)
    chi_p = eo.dhat_dag(ue, uo, psi_c, m0)
    ffe, ffo = fermion_force_planes(ue, uo, psi_c, chi_p, m0)
    gfe, gfo = gauge.gauge_force_planes(ue, uo, beta)
    return ffe + gfe, ffo + gfo


_FORCE_SCRATCH = 22      # f32 values per half-lattice site (force_step.cu)


def force_step(thE, thO, psi, m0, beta):
    """K1: one MD force evaluation (links, chi' = Dhat^+ psi, fermion force,
    staple force) with psi solved outside. CUDA tensors run the kernel of
    csrc/force_step.cu; CPU tensors run force_step_reference."""
    if not psi.is_cuda:
        return force_step_reference(thE, thO, psi, m0, beta)
    C, _, Nx, Nth = thE.shape
    _cuda.check(thE, "thE", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(thO, "thO", torch.float32, (C, 2, Nx, Nth))
    _cuda.check(psi, "psi", torch.float32, (C, 2, 2, Nx, Nth))
    FE = torch.empty_like(thE)
    FO = torch.empty_like(thO)
    scratch = torch.empty(C * _FORCE_SCRATCH * Nx * Nth, dtype=torch.float32,
                          device=psi.device)
    p = _cuda.ptr
    _cuda.KERNELS.call("force_step_launch", p(thE), p(thO), p(psi), p(FE),
                       p(FO), p(scratch), C, Nx, Nth, float(m0), float(beta))
    force_step.launches += 1
    return FE, FO


force_step.launches = 0
