"""The full-lattice Wilson-Dirac operator, its adjoint, the normal operator
and the fermion force, through a geometry.

Counterpart of ``schwingermodel_tpu/ops/dirac.py`` (reference
src/dirac_operator.cpp: D_phi :24, D_dagger_phi :247,
phi_dag_partialD_phi :486; HMC_doc.pdf Eqs (34)-(38)): whole-array shifted
products, on one lattice per chain or on the blocks of a mesh. The
antiperiodic time boundary of the fermions is folded into the mu=0 links of
the last global time slice once per configuration (``fermion_links``), so
every hop is a plain periodic shift.

Layout: spinors complex [batch.., 2(spin), Nx, Nt], links complex
[batch.., 2(mu), Nx, Nt], mu=0 the time direction. Operands that move in the
same direction ride one shift: four shifts per apply, four halo exchanges on
a mesh. These are the operators of full-D pseudofermions (``--no-even-odd``,
odd lattices); the even-odd ones are in ops/eo.py.
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops.geometry import (
    Geometry, shift_m_t, shift_m_x, shift_p_t, shift_p_x,
)


def make_sign_mask(geom: Geometry, local_Nx: int, local_Nt: int,
                   global_Nt: int, rdtype, device=None) -> torch.Tensor:
    """Site tensor: -1 where the global t equals global_Nt - 1, else +1.
    Built from global coordinates, so the same on any mesh; local_Nx and
    local_Nt are the per-shard extents."""
    _, t = geom.global_coords(local_Nx, local_Nt, device)
    one = torch.ones((), dtype=rdtype, device=device)
    return torch.where(t == global_Nt - 1, -one, one)


def fermion_links(U: torch.Tensor, sign_mask: torch.Tensor) -> torch.Tensor:
    """U [batch.., 2, Nx, Nt] complex with the mu=0 links of the last
    global time slice negated (sign_mask from make_sign_mask)."""
    return torch.stack([U[..., 0, :, :] * sign_mask, U[..., 1, :, :]], dim=-3)


def _hops(geom: Geometry, Uf, phi, dagger: bool):
    """The hopping sums (h0, h1) of D (dagger False) or D^+ (True) on phi:
    D = m - h/2. Backward hops ship the link-multiplied, spin-projected
    product formed at the source site. The spin projectors' second rows
    are -+1 (t) and -+i (x) times their first, so each hop carries one
    field: h1 = -+((A - bt) + i (B - bx)), for D and D^+."""
    u0, u1 = Uf[..., 0, :, :], Uf[..., 1, :, :]
    p0, p1 = phi[..., 0, :, :], phi[..., 1, :, :]
    pt = shift_p_t(geom, phi)
    px = shift_p_x(geom, phi)
    s = -1j if dagger else 1j
    t = 1.0 if dagger else -1.0
    A = u0 * torch.add(pt[..., 0, :, :], pt[..., 1, :, :], alpha=t)
    bt = shift_m_t(geom, torch.conj(u0) * torch.add(p0, p1, alpha=-t))
    B = u1 * torch.add(px[..., 0, :, :], px[..., 1, :, :], alpha=s)
    bx = shift_m_x(geom, torch.conj(u1) * torch.add(p0, p1, alpha=-s))
    if not dagger:
        return (A + bt) + (B + bx), torch.add(bt - A, bx - B, alpha=1j)
    return (A + bt) + (B + bx), torch.add(A - bt, B - bx, alpha=1j)


def dirac(geom: Geometry, Uf, phi, m0):
    """D phi (reference D_phi, doc Eq (34)); Uf the folded links."""
    m = float(m0) + 2.0
    return torch.add(m * phi, torch.stack(_hops(geom, Uf, phi, dagger=False), dim=-3),
                     alpha=-0.5)


def dirac_dagger(geom: Geometry, Uf, phi, m0):
    """D^+ phi (reference D_dagger_phi, doc Eqs (35)-(36))."""
    m = float(m0) + 2.0
    return torch.add(m * phi, torch.stack(_hops(geom, Uf, phi, dagger=True), dim=-3),
                     alpha=-0.5)


def dirac_normal(geom: Geometry, Uf, phi, m0):
    """(D D^+) phi (reference D_D_dagger_phi)."""
    return dirac(geom, Uf, dirac_dagger(geom, Uf, phi, m0), m0)


def fermion_force(geom: Geometry, Uf, left, right) -> torch.Tensor:
    """Fermion force F_mu(n) (reference phi_dag_partialD_phi, doc Eqs
    (37)-(38)) with left = psi = (D D^+)^{-1} Phi and right = chi' = D^+ psi;
    real [batch.., 2, Nx, Nt]. The mass enters D only on the diagonal, so
    the force does not depend on it."""
    u0, u1 = Uf[..., 0, :, :], Uf[..., 1, :, :]
    l0, l1 = left[..., 0, :, :], left[..., 1, :, :]
    r0, r1 = right[..., 0, :, :], right[..., 1, :, :]
    sh_t = shift_p_t(geom, torch.stack([r0 - r1, l0 + l1], dim=-3))
    sh_x = shift_p_x(geom, torch.stack([r0 + 1j * r1, l0 - 1j * l1], dim=-3))
    f0 = (u0 * torch.conj(l0 - l1) * sh_t[..., 0, :, :]
          - torch.conj(u0) * torch.conj(sh_t[..., 1, :, :]) * (r0 + r1)).imag
    f1 = (u1 * torch.conj(l0 + 1j * l1) * sh_x[..., 0, :, :]
          + torch.conj(u1) * torch.conj(sh_x[..., 1, :, :]) * (-r0 + 1j * r1)).imag
    return torch.stack([f0, f1], dim=-3)


def spinor_dot(geom: Geometry, x, y) -> torch.Tensor:
    """Global <x, y> = sum conj(x) y per chain (complex chain scalar)."""
    return geom.gsum((torch.conj(x) * y).sum(dim=-3))


def spinor_dot_re_batch(geom: Geometry, pairs) -> torch.Tensor:
    """Re<a_i, b_i> of several spinor pairs with one global reduction,
    stacked along a new last axis (the single-reduction CG's lever): one
    product and one sum over the stacked pairs, real and imaginary parts as
    a last axis."""
    a = torch.view_as_real(torch.stack([a for a, _ in pairs]))
    b = torch.view_as_real(torch.stack([b for _, b in pairs]))
    return geom.gsum_stack(list((a * b).sum(dim=(-4, -3, -2, -1))))


def spinor_norm2(geom: Geometry, x) -> torch.Tensor:
    """Global ||x||^2 per chain."""
    return geom.gsum((x.real ** 2 + x.imag ** 2).sum(dim=-3))
