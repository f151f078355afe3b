"""U(1) links, plaquettes, gauge action and staple force.

Counterpart of ``schwingermodel_tpu/ops/gauge.py`` and of the plane forms
in ``schwingermodel_tpu/ops/pallas_traj.py:145-166,206-231``, in two
layouts. The checkerboard functions take angles per parity,
[..., 2(dir), Nx, Nt/2] (ops/eo.py layout): the main path and the plain
twins of its kernels use them. The ``field_*`` functions, ``staples`` and
``gauge_force`` take full-lattice fields [batch.., 2(dir), Nx, Nt] through
a geometry (ops/geometry.py), as the JAX module does: the unpacked sampler
uses them, with or without a mesh.

The antiperiodic fermion sign sits on u0 at global t = Nt-1, i.e. at packed
column Nt/2-1 of the rows whose packed offset is 1. It cancels inside every
plaquette (u0 enters twice at equal t), so the folded links serve both the
Dirac operator and the gauge terms.
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops.geometry import (
    Geometry, shift_m_t, shift_m_x, shift_p_t, shift_p_x,
)


def boundary_sign(Nx: int, Nth: int, parity: int, dtype, device=None):
    """[Nx, Nth]: -1 at the parity sites with global t = Nt-1, else +1."""
    off = eo.row_offset(Nx, parity, device)
    last = torch.arange(Nth, device=device).reshape(1, Nth) == Nth - 1
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where(off & last, -one, one)


def parity_links(th: torch.Tensor, parity: int, cdtype=None) -> torch.Tensor:
    """Folded complex links [..., 2, Nx, Nth] from one parity's angles.

    cdtype=torch.complex128 evaluates exp(i theta) in f64 from the (exact)
    stored angles: the operator of the f64 true residual."""
    if cdtype == torch.complex128:
        th = th.double()
    Nx, Nth = th.shape[-2:]
    u = torch.complex(torch.cos(th), torch.sin(th))
    sign = boundary_sign(Nx, Nth, parity, th.dtype, th.device)
    return torch.stack([u[..., 0, :, :] * sign, u[..., 1, :, :]], dim=-3)


def links(thE, thO, cdtype=None):
    """(ue, uo) folded links of both parities."""
    return parity_links(thE, eo.EVEN, cdtype), parity_links(thO, eo.ODD, cdtype)


def plaquette_planes(ue, uo, off_e=None, off_o=None):
    """(Pe, Po): P(n) = u0(n) u1(n+t) conj(u0(n+x)) conj(u1(n)) anchored at
    even / odd sites. off_e/off_o: the rows' packed offsets, where they do
    not follow from the row index (a shard's extended block)."""
    Nx = ue.shape[-2]
    if off_e is None:
        off_e = eo.row_offset(Nx, eo.EVEN, ue.device)
        off_o = eo.row_offset(Nx, eo.ODD, ue.device)
    u0e, u1e = ue[..., 0, :, :], ue[..., 1, :, :]
    u0o, u1o = uo[..., 0, :, :], uo[..., 1, :, :]
    pe = u0e * eo._gather_pt(u1o, off_e) * torch.conj(eo._px(u0o) * u1e)
    po = u0o * eo._gather_pt(u1e, off_o) * torch.conj(eo._px(u0e) * u1o)
    return pe, po


def plaquette_sum(thE, thO, cdtype=torch.complex128) -> torch.Tensor:
    """sum_n Re P(n) per chain [C] (reference MeasureSp_HMC)."""
    pe, po = plaquette_planes(*links(thE, thO, cdtype))
    return pe.real.sum(dim=(-2, -1)) + po.real.sum(dim=(-2, -1))


def gauge_action(thE, thO, beta, cdtype=torch.complex128) -> torch.Tensor:
    """S_g = beta sum_n (1 - Re P(n)) per chain [C], in f64 by default."""
    pe, po = plaquette_planes(*links(thE, thO, cdtype))
    return beta * ((1.0 - pe.real).sum(dim=(-2, -1))
                   + (1.0 - po.real).sum(dim=(-2, -1)))


def gauge_force_planes(ue, uo, beta, off_e=None, off_o=None):
    """(FE, FO) [..., 2, Nx, Nth] staple force:
    F0(n) = -beta [sin P(n) - sin P(n-x)], F1(n) = beta [sin P(n) - sin P(n-t)]
    (== -beta Im[U conj(staple)], reference Force_G, src/hmc.cpp:32-39)."""
    Nx = ue.shape[-2]
    if off_e is None:
        off_e = eo.row_offset(Nx, eo.EVEN, ue.device)
        off_o = eo.row_offset(Nx, eo.ODD, ue.device)
    pe, po = plaquette_planes(ue, uo, off_e, off_o)
    se, so = pe.imag, po.imag
    f0e = -beta * (se - eo._mx(so))
    f0o = -beta * (so - eo._mx(se))
    f1e = beta * (se - eo._gather_mt(so, off_e))
    f1o = beta * (so - eo._gather_mt(se, off_o))
    return torch.stack([f0e, f1e], dim=-3), torch.stack([f0o, f1o], dim=-3)


# ---------- full-lattice fields through a geometry ----------

def field_links(theta: torch.Tensor, cdtype=None) -> torch.Tensor:
    """U = exp(i theta) on the full lattice (JAX ``links``); with
    cdtype=torch.complex128 evaluated in f64 from the stored angles."""
    if cdtype == torch.complex128:
        theta = theta.double()
    return torch.complex(torch.cos(theta), torch.sin(theta))


def plaquette_field(geom: Geometry, U: torch.Tensor) -> torch.Tensor:
    """P_01(n) = U_0(n) U_1(n+t) U*_0(n+x) U*_1(n)."""
    u0, u1 = U[..., 0, :, :], U[..., 1, :, :]
    return (u0 * shift_p_t(geom, u1) * torch.conj(shift_p_x(geom, u0))
            * torch.conj(u1))


def field_plaquette_sum(geom: Geometry, U: torch.Tensor) -> torch.Tensor:
    """sum_n Re P_01(n) per chain (JAX ``plaquette_sum``)."""
    return geom.gsum(plaquette_field(geom, U).real)


def field_gauge_action(geom: Geometry, U: torch.Tensor, beta) -> torch.Tensor:
    """S_g = beta sum_n (1 - Re P_01(n)) per chain (JAX ``gauge_action``)."""
    return beta * geom.gsum(1.0 - plaquette_field(geom, U).real)


def staples(geom: Geometry, U: torch.Tensor) -> torch.Tensor:
    """Staple field A_mu(n) (reference Compute_Staple,
    src/gauge_conf.cpp:89-133); the diagonal neighbours are two shifts of a
    locally formed product."""
    u0, u1 = U[..., 0, :, :], U[..., 1, :, :]
    u0_px = shift_p_x(geom, u0)
    u1_pt = shift_p_t(geom, u1)
    s0 = (u1 * u0_px * torch.conj(u1_pt)
          + shift_m_x(geom, torch.conj(u1) * u0 * u1_pt))
    s1 = (u0 * u1_pt * torch.conj(u0_px)
          + shift_m_t(geom, torch.conj(u0) * u1 * u0_px))
    return torch.stack([s0, s1], dim=-3)


def gauge_force(geom: Geometry, U: torch.Tensor, beta) -> torch.Tensor:
    """F^g_mu(n) = -beta Im[U_mu(n) conj(A_mu(n))] (reference Force_G,
    src/hmc.cpp:32-39): real, of theta's shape."""
    return -beta * (U * torch.conj(staples(geom, U))).imag
