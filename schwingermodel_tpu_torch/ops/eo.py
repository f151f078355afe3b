"""Even-odd (Schur-complement) Wilson operator on checkerboard planes.

Counterpart of ``schwingermodel_tpu/ops/eo.py:55-205`` and of the packed
stencil in ``schwingermodel_tpu/ops/pallas_eo.py:118-181``. Plain PyTorch on
complex tensors; the plain versions of the kernels (ops/traj.py,
ops/refined.py) are built from it, and ``csrc/stencil.cuh`` computes the
same stencil on the card.

Layout: a parity field stores row x's sites of that parity,
E[x, k] = a[x, 2k + off_e(x)] with off_e(x) = x mod 2 and
off_o(x) = (x+1) mod 2; shape [..., Nx, Nt/2]. Links are [..., 2(dir),
Nx, Nt/2] with the antiperiodic time sign folded into u0; spinors are
[..., 2(spin), Nx, Nt/2].

With D = m - H/2 (m = m0 + 2) and c = 1/(4m):
    Dhat = m - c H_eo H_oe,   Dhat^+ = m - c (H_oe)^+ (H_eo)^+.
"""

from __future__ import annotations

import torch

EVEN = 0
ODD = 1


def row_offset(Nx: int, parity: int, device=None) -> torch.Tensor:
    """[Nx, 1] bool: True where row x's `parity` sites sit at odd t-subindex
    (off_e(x) = x mod 2, off_o(x) = (x+1) mod 2)."""
    x = torch.arange(Nx, device=device).reshape(Nx, 1)
    return ((x + parity) % 2) == 1


def pack(a: torch.Tensor, parity: int) -> torch.Tensor:
    """The `parity` checkerboard of a[..., Nx, Nt] -> [..., Nx, Nt/2]."""
    *lead, Nx, Nt = a.shape
    ar = a.reshape(*lead, Nx, Nt // 2, 2)
    off = row_offset(Nx, parity, a.device)
    return torch.where(off, ar[..., 1], ar[..., 0])


def unpack(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Interleave the two parities back to [..., Nx, Nt]."""
    *lead, Nx, Nth = even.shape
    off_e = row_offset(Nx, EVEN, even.device)
    sub0 = torch.where(off_e, odd, even)
    sub1 = torch.where(off_e, even, odd)
    return torch.stack([sub0, sub1], dim=-1).reshape(*lead, Nx, 2 * Nth)


def _gather_pt(s: torch.Tensor, off_tgt: torch.Tensor) -> torch.Tensor:
    """Source-parity field at the target site's t+1 neighbour: packed index
    k + off (eo._gather_pt)."""
    return torch.where(off_tgt, torch.roll(s, -1, dims=-1), s)


def _gather_mt(w: torch.Tensor, off_tgt: torch.Tensor) -> torch.Tensor:
    """Source-parity field at the target site's t-1 neighbour: packed index
    k + off - 1 (eo._gather_mt)."""
    return torch.where(off_tgt, w, torch.roll(w, 1, dims=-1))


def _px(a: torch.Tensor) -> torch.Tensor:
    """a[x+1] along the x axis (second from last)."""
    return torch.roll(a, -1, dims=-2)


def _mx(a: torch.Tensor) -> torch.Tensor:
    """a[x-1] along the x axis."""
    return torch.roll(a, 1, dims=-2)


def hop(U_tgt, U_src, S, off_tgt):
    """Hopping term H from the source parity to the target parity
    (eo.hop): forward hops use the target-site links, backward hops the
    link-multiplied spin projection formed at the source site."""
    u0t, u1t = U_tgt[..., 0, :, :], U_tgt[..., 1, :, :]
    u0s, u1s = U_src[..., 0, :, :], U_src[..., 1, :, :]
    s0, s1 = S[..., 0, :, :], S[..., 1, :, :]
    p0_pt = _gather_pt(s0, off_tgt)
    p1_pt = _gather_pt(s1, off_tgt)
    bt = _gather_mt(torch.conj(u0s) * (s0 + s1), off_tgt)
    p0_px, p1_px = _px(s0), _px(s1)
    bx0 = _mx(torch.conj(u1s) * (s0 - 1j * s1))
    bx1 = _mx(torch.conj(u1s) * (1j * s0 + s1))
    h0 = u0t * (p0_pt - p1_pt) + u1t * (p0_px + 1j * p1_px) + bt + bx0
    h1 = u0t * (p1_pt - p0_pt) + u1t * (p1_px - 1j * p0_px) + bt + bx1
    return torch.stack([h0, h1], dim=-3)


def hop_dag(U_tgt, U_src, S, off_tgt):
    """Adjoint hopping H^+ from the source parity to the target parity
    (eo.hop_dag)."""
    u0t, u1t = U_tgt[..., 0, :, :], U_tgt[..., 1, :, :]
    u0s, u1s = U_src[..., 0, :, :], U_src[..., 1, :, :]
    s0, s1 = S[..., 0, :, :], S[..., 1, :, :]
    p0_pt = _gather_pt(s0, off_tgt)
    p1_pt = _gather_pt(s1, off_tgt)
    fwd_t = u0t * (p0_pt + p1_pt)
    bt = _gather_mt(torch.conj(u0s) * (s0 - s1), off_tgt)
    p0_px, p1_px = _px(s0), _px(s1)
    bx0 = _mx(torch.conj(u1s) * (s0 + 1j * s1))
    bx1 = _mx(torch.conj(u1s) * (s1 - 1j * s0))
    h0 = bt + bx0 + fwd_t + u1t * (p0_px - 1j * p1_px)
    h1 = -bt + bx1 + fwd_t + u1t * (p1_px + 1j * p0_px)
    return torch.stack([h0, h1], dim=-3)


def mass_terms(m0: float):
    """(m, c) = (m0 + 2, 1/(4(m0 + 2))) as Python floats."""
    m = float(m0) + 2.0
    return m, 1.0 / (4.0 * m)


def dhat(ue, uo, v, m0):
    """Dhat v = m v - c H_eo H_oe v, v on the even sublattice."""
    m, c = mass_terms(m0)
    Nx = v.shape[-2]
    w = hop(uo, ue, v, row_offset(Nx, ODD, v.device))
    return m * v - c * hop(ue, uo, w, row_offset(Nx, EVEN, v.device))


def dhat_dag(ue, uo, v, m0):
    """Dhat^+ v = m v - c (H_oe)^+ (H_eo)^+ v."""
    m, c = mass_terms(m0)
    Nx = v.shape[-2]
    w = hop_dag(uo, ue, v, row_offset(Nx, ODD, v.device))
    return m * v - c * hop_dag(ue, uo, w, row_offset(Nx, EVEN, v.device))


def normal(ue, uo, v, m0):
    """(Dhat Dhat^+) v, the CG operator."""
    return dhat(ue, uo, dhat_dag(ue, uo, v, m0), m0)
