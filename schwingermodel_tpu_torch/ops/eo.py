"""Even-odd (Schur-complement) Wilson operator on checkerboard planes.

Counterpart of ``schwingermodel_tpu/ops/eo.py`` and of the packed stencil
in ``schwingermodel_tpu/ops/pallas_eo.py:118-181``. Plain PyTorch on complex
tensors; the plain versions of the kernels (ops/traj.py, ops/refined.py,
ops/halo.py) are built from it, and ``csrc/stencil.cuh`` computes the same
stencil on the card.

Layout: a parity field stores row x's sites of that parity,
E[x, k] = a[x, 2k + off_e(x)] with off_e(x) = x mod 2 and
off_o(x) = (x+1) mod 2; shape [..., Nx, Nt/2]. Links are [..., 2(dir),
Nx, Nt/2] with the antiperiodic time sign folded into u0; spinors are
[..., 2(spin), Nx, Nt/2].

Every shift goes through a geometry (ops/geometry.py). The default is one
lattice per chain, where the row offsets follow from the row index; given
a ``ShardedGeometry`` the same code runs on the blocks of a mesh, with the
offsets from the global x (an odd local Nx makes neighbouring shards
differ) and one halo slice exchanged per shift. The local Nt of a shard
must be even.

With D = m - H/2 (m = m0 + 2) and c = 1/(4m):
    Dhat = m - c H_eo H_oe,   Dhat^+ = m - c (H_oe)^+ (H_eo)^+.
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops.geometry import (
    LOCAL, T_AXIS, Geometry, shift_m_x, shift_p_x, site,
)

EVEN = 0
ODD = 1


def row_offset(Nx: int, parity: int, device=None, geom: Geometry = LOCAL,
               ) -> torch.Tensor:
    """Bool site tensor [.., Nx, 1]: True where row x's `parity` sites sit
    at odd t-subindex (off_e(x) = x mod 2, off_o(x) = (x+1) mod 2), from
    the geometry's global x; Nx is the local extent on a mesh."""
    x, _ = geom.global_coords(Nx, 1, device)
    return ((x + parity) % 2) == 1


def pack(a: torch.Tensor, parity: int, geom: Geometry = LOCAL) -> torch.Tensor:
    """The `parity` checkerboard of a[..., Nx, Nt] -> [..., Nx, Nt/2]."""
    *lead, Nx, Nt = a.shape
    ar = a.reshape(*lead, Nx, Nt // 2, 2)
    off = site(row_offset(Nx, parity, a.device, geom), ar[..., 0])
    return torch.where(off, ar[..., 1], ar[..., 0])


def unpack(even: torch.Tensor, odd: torch.Tensor, geom: Geometry = LOCAL,
           ) -> torch.Tensor:
    """Interleave the two parities back to [..., Nx, Nt]."""
    *lead, Nx, Nth = even.shape
    off_e = site(row_offset(Nx, EVEN, even.device, geom), even)
    sub0 = torch.where(off_e, odd, even)
    sub1 = torch.where(off_e, even, odd)
    return torch.stack([sub0, sub1], dim=-1).reshape(*lead, Nx, 2 * Nth)


def _gather_pt(s: torch.Tensor, off_tgt: torch.Tensor, geom: Geometry = LOCAL,
               ) -> torch.Tensor:
    """Source-parity field at the target site's t+1 neighbour: packed index
    k + off (eo._gather_pt)."""
    return torch.where(site(off_tgt, s), geom.shift(s, T_AXIS, +1), s)


def _gather_mt(w: torch.Tensor, off_tgt: torch.Tensor, geom: Geometry = LOCAL,
               ) -> torch.Tensor:
    """Source-parity field at the target site's t-1 neighbour: packed index
    k + off - 1 (eo._gather_mt)."""
    return torch.where(site(off_tgt, w), w, geom.shift(w, T_AXIS, -1))


def _px(a: torch.Tensor, geom: Geometry = LOCAL) -> torch.Tensor:
    """a[x+1] along the x axis (second from last)."""
    return shift_p_x(geom, a)


def _mx(a: torch.Tensor, geom: Geometry = LOCAL) -> torch.Tensor:
    """a[x-1] along the x axis."""
    return shift_m_x(geom, a)


def hop(U_tgt, U_src, S, off_tgt, geom: Geometry = LOCAL):
    """Hopping term H from the source parity to the target parity
    (eo.hop): forward hops use the target-site links, backward hops the
    link-multiplied spin projection formed at the source site. Operands of
    the same direction are shifted together: four shifts per hop, so four
    halo exchanges on a mesh."""
    u0t, u1t = U_tgt[..., 0, :, :], U_tgt[..., 1, :, :]
    u0s, u1s = U_src[..., 0, :, :], U_src[..., 1, :, :]
    s0, s1 = S[..., 0, :, :], S[..., 1, :, :]
    S_pt = _gather_pt(S, off_tgt, geom)
    p0_pt, p1_pt = S_pt[..., 0, :, :], S_pt[..., 1, :, :]
    bt = _gather_mt(torch.conj(u0s) * (s0 + s1), off_tgt, geom)
    S_px = _px(S, geom)
    p0_px, p1_px = S_px[..., 0, :, :], S_px[..., 1, :, :]
    bx = _mx(torch.stack([torch.conj(u1s) * (s0 - 1j * s1),
                          torch.conj(u1s) * (1j * s0 + s1)], dim=-3), geom)
    bx0, bx1 = bx[..., 0, :, :], bx[..., 1, :, :]
    h0 = u0t * (p0_pt - p1_pt) + u1t * (p0_px + 1j * p1_px) + bt + bx0
    h1 = u0t * (p1_pt - p0_pt) + u1t * (p1_px - 1j * p0_px) + bt + bx1
    return torch.stack([h0, h1], dim=-3)


def hop_dag(U_tgt, U_src, S, off_tgt, geom: Geometry = LOCAL):
    """Adjoint hopping H^+ from the source parity to the target parity
    (eo.hop_dag)."""
    u0t, u1t = U_tgt[..., 0, :, :], U_tgt[..., 1, :, :]
    u0s, u1s = U_src[..., 0, :, :], U_src[..., 1, :, :]
    s0, s1 = S[..., 0, :, :], S[..., 1, :, :]
    S_pt = _gather_pt(S, off_tgt, geom)
    p0_pt, p1_pt = S_pt[..., 0, :, :], S_pt[..., 1, :, :]
    fwd_t = u0t * (p0_pt + p1_pt)
    bt = _gather_mt(torch.conj(u0s) * (s0 - s1), off_tgt, geom)
    S_px = _px(S, geom)
    p0_px, p1_px = S_px[..., 0, :, :], S_px[..., 1, :, :]
    bx = _mx(torch.stack([torch.conj(u1s) * (s0 + 1j * s1),
                          torch.conj(u1s) * (s1 - 1j * s0)], dim=-3), geom)
    bx0, bx1 = bx[..., 0, :, :], bx[..., 1, :, :]
    h0 = bt + bx0 + fwd_t + u1t * (p0_px - 1j * p1_px)
    h1 = -bt + bx1 + fwd_t + u1t * (p1_px + 1j * p0_px)
    return torch.stack([h0, h1], dim=-3)


def mass_terms(m0: float):
    """(m, c) = (m0 + 2, 1/(4(m0 + 2))) as Python floats."""
    m = float(m0) + 2.0
    return m, 1.0 / (4.0 * m)


def dhat(ue, uo, v, m0, geom: Geometry = LOCAL):
    """Dhat v = m v - c H_eo H_oe v, v on the even sublattice. geom: an
    unsharded geometry (its shifts may be computed another way, as the
    one-hot products of ops/traj.py)."""
    m, c = mass_terms(m0)
    Nx = v.shape[-2]
    w = hop(uo, ue, v, row_offset(Nx, ODD, v.device), geom)
    return m * v - c * hop(ue, uo, w, row_offset(Nx, EVEN, v.device), geom)


def dhat_dag(ue, uo, v, m0, geom: Geometry = LOCAL):
    """Dhat^+ v = m v - c (H_oe)^+ (H_eo)^+ v."""
    m, c = mass_terms(m0)
    Nx = v.shape[-2]
    w = hop_dag(uo, ue, v, row_offset(Nx, ODD, v.device), geom)
    return m * v - c * hop_dag(ue, uo, w, row_offset(Nx, EVEN, v.device), geom)


def normal(ue, uo, v, m0, geom: Geometry = LOCAL):
    """(Dhat Dhat^+) v, the CG operator."""
    return dhat(ue, uo, dhat_dag(ue, uo, v, m0, geom), m0, geom)


class EOOperators:
    """Dhat / Dhat^+ on the even sublattice of one configuration per chain,
    through a geometry (JAX ``EOOperators``). Uf: the folded full-lattice
    links [batch.., 2, Nx, Nt] (ops/dirac.fermion_links)."""

    def __init__(self, geom: Geometry, Uf: torch.Tensor, m0):
        *_, Nx, _ = Uf.shape
        self.geom = geom
        self.Uf = Uf                      # kept for the wide-halo operators
        self.Ue = pack(Uf, EVEN, geom)
        self.Uo = pack(Uf, ODD, geom)
        self.off_e = row_offset(Nx, EVEN, Uf.device, geom)
        self.off_o = row_offset(Nx, ODD, Uf.device, geom)
        self.m0 = float(m0)
        self.m, self.c = mass_terms(m0)

    def dhat(self, v):
        w = hop(self.Uo, self.Ue, v, self.off_o, self.geom)          # H_oe v
        return self.m * v - self.c * hop(self.Ue, self.Uo, w, self.off_e,
                                         self.geom)

    def dhat_dag(self, v):
        w = hop_dag(self.Uo, self.Ue, v, self.off_o, self.geom)  # (H_eo)^+ v
        return self.m * v - self.c * hop_dag(self.Ue, self.Uo, w, self.off_e,
                                             self.geom)

    def normal(self, v):
        """(Dhat Dhat^+) v: 16 shifts, so 16 halo exchanges on a mesh."""
        return self.dhat(self.dhat_dag(v))


# ---------- the fermion force ----------

def _fermion_force_p(u, x_p, y_p, x_q, y_q, off_p, geom: Geometry = LOCAL):
    """(f0, f1) at parity-p sites: the reference force stencil (reference
    src/dirac_operator.cpp:486-505, Eqs (37)-(38)) with left operand x and
    right operand y; the opposite-parity x_q, y_q are gathered at n+t and
    n+x (pallas_traj._fermion_force_p)."""
    u0, u1 = u[..., 0, :, :], u[..., 1, :, :]
    x0, x1 = x_p[..., 0, :, :], x_p[..., 1, :, :]
    y0, y1 = y_p[..., 0, :, :], y_p[..., 1, :, :]
    xq0, xq1 = x_q[..., 0, :, :], x_q[..., 1, :, :]
    yq0, yq1 = y_q[..., 0, :, :], y_q[..., 1, :, :]
    t = _gather_pt(torch.stack([yq0 - yq1, xq0 + xq1], dim=-3), off_p, geom)
    x = _px(torch.stack([yq0 + 1j * yq1, xq0 - 1j * xq1], dim=-3), geom)
    yt, xt = t[..., 0, :, :], t[..., 1, :, :]
    yx, xx = x[..., 0, :, :], x[..., 1, :, :]
    f0 = (u0 * (torch.conj(x0 - x1) * yt)).imag \
        - (torch.conj(u0) * (torch.conj(xt) * (y0 + y1))).imag
    f1 = (u1 * (torch.conj(x0 + 1j * x1) * yx)).imag \
        + (torch.conj(u1) * (torch.conj(xx) * (-y0 + 1j * y1))).imag
    return torch.stack([f0, f1], dim=-3)


def fermion_force_planes(ue, uo, psi, chi_p, m0, geom: Geometry = LOCAL,
                         off_e=None, off_o=None):
    """(FE, FO) = 2c f(x = psi (+) b, y = a (+) chi') on both parities, with
    a = H_oe chi' and b = (H_eo)^+ psi (pallas_traj.fermion_force_planes):
    F = -dS_f/dtheta for S_f = Phi^+ (Dhat Dhat^+)^{-1} Phi at
    psi = (Dhat Dhat^+)^{-1} Phi, chi' = Dhat^+ psi. Complex operands.
    off_e/off_o: the rows' packed offsets, where they are not the
    geometry's own (a shard's extended block)."""
    _, c = mass_terms(m0)
    Nx = psi.shape[-2]
    if off_e is None:
        off_e = row_offset(Nx, EVEN, psi.device, geom)
        off_o = row_offset(Nx, ODD, psi.device, geom)
    a_o = hop(uo, ue, chi_p, off_o, geom)
    b_o = hop_dag(uo, ue, psi, off_o, geom)
    two_c = 2.0 * c
    fe = _fermion_force_p(ue, psi, chi_p, b_o, a_o, off_e, geom)
    fo = _fermion_force_p(uo, b_o, a_o, psi, chi_p, off_o, geom)
    return two_c * fe, two_c * fo


def eo_ratio_force(ops0: EOOperators, ops1: EOOperators, psi, chi_p, phi2,
                   ) -> torch.Tensor:
    """Force of the Hasenbusch ratio term
    S2 = (Dhat_1 phi2)^+ (Dhat_0 Dhat_0^+)^{-1} (Dhat_1 phi2) at fixed
    psi = (Dhat_0 Dhat_0^+)^{-1} Dhat_1 phi2 and chi_p = Dhat_0^+ psi, on
    the full lattice (JAX ``eo_ratio_force``, there the autodiff gradient of
    2 Re<psi, Dhat_0 chi_p> - 2 Re<psi, Dhat_1 phi2>). In closed form the
    two bilinears are two force stencils on the same links that differ in
    their Schur prefactor 1/(4 m_i): ops0 and ops1 are the operators of one
    configuration at the light and the heavy mass."""
    return eo_fermion_force(ops0, psi, chi_p) - eo_fermion_force(ops1, psi, phi2)


def eo_fermion_force(ops: EOOperators, psi, chi_p) -> torch.Tensor:
    """F_mu(n) = -dS_f/dtheta_mu(n) on the full lattice [batch.., 2, Nx, Nt]
    for the Dhat action, through the geometry of `ops`. The JAX package
    takes it as the autodiff gradient of 2 Re<psi, Dhat(theta) chi'>
    (``eo_fermion_force``); this is the same force in closed form, the
    checkerboard stencil of the fused force kernels."""
    fe, fo = fermion_force_planes(ops.Ue, ops.Uo, psi, chi_p, ops.m0, ops.geom,
                                  ops.off_e, ops.off_o)
    return unpack(fe, fo, ops.geom)
