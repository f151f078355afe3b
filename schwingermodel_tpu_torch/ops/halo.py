"""The lattice-sharded fast path: kernels K7 and K8 on one shard's block.

Counterpart of ``schwingermodel_tpu/ops/pallas_halo.py``. The local work of
one wide-halo normal apply (all four hops on the width-4-extended block,
the crop, and the four CG inner-product partials) is one kernel launch for
all shards of all chains, and so is the MD force (chi' = Dhat^+ psi, the
checkerboard fermion force and the staple force). The halo exchange
(``eo_halo.extend``: 4 ppermutes) and the psum of the partials stay outside
the kernels, which therefore serve any shard of any mesh:

- ``halo_normal`` is K7 (``csrc/halo_normal.cu``, replacing
  ``pallas_halo._halo_normal_kernel``); twin ``halo_normal_reference``.
- ``halo_force`` is K8 (``csrc/halo_force.cu``, replacing
  ``pallas_halo._halo_force_kernel``); twin ``halo_force_reference``.

Both take f32 planes with any leading block axes ``[*lead, ...]`` (on the
mesh of this package ``lead = (C, rx, rt)``), one thread block per entry of
``lead``. CPU tensors run the twins; CUDA tensors run the kernels.

Per sharded CG iteration (``cg_solve_sharded_fused``): 4 ppermutes, one K7
launch and one psum of the four partials. K7 accumulates its partials in
f64 and rounds them once to f32, so against an unsharded solve the psum
over the shards (f32 adds of rx * rt partials) is the only reordering: the
recursive rho agrees to a few f32 ulps, and the solutions to the same
2e-4 as any two f32 CGs of this package.
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, eo_halo, gauge
from schwingermodel_tpu_torch.ops.eo_halo import W, _ext_offsets, extend
from schwingermodel_tpu_torch.ops.geometry import LOCAL, ShardedGeometry, bcast
from schwingermodel_tpu_torch.ops.traj import to_complex, to_planar
from schwingermodel_tpu_torch.solvers.cg import CGResult, rel_residual

# a block too large for the shared memory a kernel may ask for
# (_cuda.SHARED_MAX) keeps its intermediates in a scratch
_NORMAL_PLANES, _NORMAL_SCRATCH = 20, 8     # halo_normal.cu, floats per site
_FORCE_PLANES, _FORCE_SCRATCH = 26, 14      # halo_force.cu


def _ext_operands(ue_ext, uo_ext, off_ext):
    """Complex links and bool (off_e, off_o) site tensors of the twins."""
    off_e = (off_ext == 1).unsqueeze(-1)
    return to_complex(ue_ext), to_complex(uo_ext), off_e, ~off_e


def _crop(a: torch.Tensor) -> torch.Tensor:
    return a[..., W:-W, W:-W]


# ---------- K7 ----------

def halo_normal_reference(ue_ext, uo_ext, off_ext, v_ext, r_loc=None, *, m0,
                          with_dots=False):
    """Plain twin of K7: the four hops on the extended block with plain
    periodic shifts, cropped; the partials accumulated in f64 and rounded
    to f32."""
    ue, uo, off_e, off_o = _ext_operands(ue_ext, uo_ext, off_ext)
    m, c = eo.mass_terms(m0)
    v = to_complex(v_ext)
    w1 = eo.hop_dag(uo, ue, v, off_o, LOCAL)
    u = m * v - c * eo.hop_dag(ue, uo, w1, off_e, LOCAL)
    w2 = eo.hop(uo, ue, u, off_o, LOCAL)
    out = to_planar(_crop(m * u - c * eo.hop(ue, uo, w2, off_e, LOCAL)))
    if not with_dots:
        return out
    d, Ad, r = _crop(v_ext).double(), out.double(), r_loc.double()
    dots = torch.stack([(a * b).sum(dim=(-4, -3, -2, -1)) for a, b in
                        ((r, r), (d, Ad), (Ad, Ad), (r, Ad))], dim=-1)
    return out, dots.float()


def _scratch(lead_n, planes, per_site, V, device):
    """None where the block fits in shared memory, else the kernel's global
    scratch."""
    if 4 * planes * V <= _cuda.SHARED_MAX:
        return None
    return torch.empty(lead_n * per_site * V, dtype=torch.float32, device=device)


def halo_normal(ue_ext, uo_ext, off_ext, v_ext, r_loc=None, *, m0,
                with_dots=False):
    """K7: out = crop((Dhat Dhat^+) v_ext) on every block
    (pallas_halo.halo_normal_fused).

    ue_ext, uo_ext: f32 [*lead, 2(dir), 2(re/im), Nxe, Nthe], the extended
    packed links with the antiperiodic sign folded; off_ext: int32
    [*lead, Nxe], the extended rows' even-parity offsets; v_ext: f32
    [*lead, 2(spin), 2, Nxe, Nthe]. Returns f32 [*lead, 2, 2, Nxe-2W,
    Nthe-2W]. with_dots: r_loc f32 of the output's shape, the un-extended
    local residual; also returns the local partials
    [<r,r>, <d,Ad>, <Ad,Ad>, <r,Ad>] f32 [*lead, 4] with d = crop(v_ext)
    and Ad = out."""
    *lead, _, _, Nxe, Nthe = v_ext.shape
    if Nxe <= 2 * W or Nthe <= 2 * W:
        raise ValueError(f"extended block {Nxe}x{Nthe} has no interior")
    if not v_ext.is_cuda:
        return halo_normal_reference(ue_ext, uo_ext, off_ext, v_ext, r_loc,
                                     m0=m0, with_dots=with_dots)
    ext = (*lead, 2, 2, Nxe, Nthe)
    loc = (*lead, 2, 2, Nxe - 2 * W, Nthe - 2 * W)
    _cuda.check(ue_ext, "ue_ext", torch.float32, ext)
    _cuda.check(uo_ext, "uo_ext", torch.float32, ext)
    _cuda.check(off_ext, "off_ext", torch.int32, (*lead, Nxe))
    _cuda.check(v_ext, "v_ext", torch.float32, ext)
    dev = v_ext.device
    n = off_ext.numel() // Nxe
    out = torch.empty(loc, dtype=torch.float32, device=dev)
    p = _cuda.ptr
    r_ptr = dots_ptr = dots = None
    if with_dots:
        _cuda.check(r_loc, "r_loc", torch.float32, loc)
        dots = torch.empty((*lead, 4), dtype=torch.float32, device=dev)
        r_ptr, dots_ptr = p(r_loc), p(dots)
    scratch = _scratch(n, _NORMAL_PLANES, _NORMAL_SCRATCH, Nxe * Nthe, dev)
    _cuda.KERNELS.call("halo_normal_launch", p(ue_ext), p(uo_ext), p(off_ext),
                       p(v_ext), r_ptr, p(out), dots_ptr,
                       None if scratch is None else p(scratch), n, Nxe, Nthe,
                       float(m0), int(bool(with_dots)))
    halo_normal.launches += 1
    return (out, dots) if with_dots else out


halo_normal.launches = 0


# ---------- K8 ----------

def halo_force_reference(ue_ext, uo_ext, off_ext, psi_ext, *, m0, beta):
    """Plain twin of K8: (FE, FO) f32 [*lead, 2, Nx, Nth], cropped."""
    ue, uo, off_e, off_o = _ext_operands(ue_ext, uo_ext, off_ext)
    m, c = eo.mass_terms(m0)
    psi = to_complex(psi_ext)
    w1 = eo.hop_dag(uo, ue, psi, off_o, LOCAL)
    chi_p = m * psi - c * eo.hop_dag(ue, uo, w1, off_e, LOCAL)
    ffe, ffo = eo.fermion_force_planes(ue, uo, psi, chi_p, m0, LOCAL, off_e,
                                       off_o)
    gfe, gfo = gauge.gauge_force_planes(ue, uo, beta, off_e, off_o)
    return _crop(ffe + gfe), _crop(ffo + gfo)


def halo_force(ue_ext, uo_ext, off_ext, psi_ext, *, m0, beta):
    """K8: the total MD force of every block from its extended planes
    (the kernel of pallas_halo.force_halo_fused): chi' = Dhat^+ psi, the
    checkerboard fermion force and the staple force, cropped. Inputs as
    ``halo_normal``; returns (FE, FO) f32 [*lead, 2(mu), Nxe-2W, Nthe-2W],
    the force at the even and the odd sites."""
    *lead, _, _, Nxe, Nthe = psi_ext.shape
    if Nxe <= 2 * W or Nthe <= 2 * W:
        raise ValueError(f"extended block {Nxe}x{Nthe} has no interior")
    if not psi_ext.is_cuda:
        return halo_force_reference(ue_ext, uo_ext, off_ext, psi_ext, m0=m0,
                                    beta=beta)
    ext = (*lead, 2, 2, Nxe, Nthe)
    _cuda.check(ue_ext, "ue_ext", torch.float32, ext)
    _cuda.check(uo_ext, "uo_ext", torch.float32, ext)
    _cuda.check(off_ext, "off_ext", torch.int32, (*lead, Nxe))
    _cuda.check(psi_ext, "psi_ext", torch.float32, ext)
    dev = psi_ext.device
    n = off_ext.numel() // Nxe
    FE = torch.empty((*lead, 2, Nxe - 2 * W, Nthe - 2 * W), dtype=torch.float32,
                     device=dev)
    FO = torch.empty_like(FE)
    scratch = _scratch(n, _FORCE_PLANES, _FORCE_SCRATCH, Nxe * Nthe, dev)
    p = _cuda.ptr
    _cuda.KERNELS.call("halo_force_launch", p(ue_ext), p(uo_ext), p(off_ext),
                       p(psi_ext), p(FE), p(FO),
                       None if scratch is None else p(scratch), n, Nxe, Nthe,
                       float(m0), float(beta))
    halo_force.launches += 1
    return FE, FO


halo_force.launches = 0


# ---------- the operators of the sharded path ----------

def fused_supported(geom, Nx_l: int, Nth_l: int, rdtype) -> bool:
    """The fused sharded path applies: the wide halo fits the local block
    and the working dtype is f32 (the kernels are f32 planar)."""
    return eo_halo.supported(geom, Nx_l, Nth_l) and rdtype == torch.float32


class EOOperatorsHaloFused:
    """``eo_halo.EOOperatorsHalo`` with the local compute of each apply in
    one K7 launch, on f32 planes (the sharded CG's layout). Uf: folded
    links [C, rx, rt, 2, Nx, Nt] complex64. The links are extended once,
    at construction (4 ppermutes)."""

    def __init__(self, geom: ShardedGeometry, Uf: torch.Tensor, m0):
        *lead, _, Nx, _ = Uf.shape
        self.geom = geom
        self.m0 = float(m0)
        Ue = eo.pack(Uf, eo.EVEN, geom)
        Uo = eo.pack(Uf, eo.ODD, geom)
        both = extend(geom, to_planar(torch.cat([Ue, Uo], dim=-3)))
        self.ue_ext = both[..., :2, :, :, :].contiguous()
        self.uo_ext = both[..., 2:, :, :, :].contiguous()
        off_e, _ = _ext_offsets(geom, Nx, W, Uf.device)
        self.off_ext = off_e[..., 0].expand(*lead, Nx + 2 * W).contiguous()

    def normal_planes(self, p: torch.Tensor, r: torch.Tensor | None = None):
        """K7 on planar f32 p [C, rx, rt, 2, 2, Nx, Nth]: 4 ppermutes and
        one launch; with r also the local dot partials."""
        return halo_normal(self.ue_ext, self.uo_ext, self.off_ext,
                           extend(self.geom, p), r, m0=self.m0,
                           with_dots=r is not None)


def force_halo_fused(geom: ShardedGeometry, Uf: torch.Tensor, m0, psi, beta,
                     ) -> torch.Tensor:
    """Total MD force F = F_fermion(psi) + F_gauge on a lattice-sharded
    block: 8 ppermutes (one stacked link extension, one psi extension) and
    one K8 launch. psi: complex64 even-packed [C, rx, rt, 2, Nx, Nth];
    returns the real full-lattice local force [C, rx, rt, 2(mu), Nx, Nt]."""
    op = EOOperatorsHaloFused(geom, Uf, m0)
    psi_ext = extend(geom, to_planar(psi))
    FE, FO = halo_force(op.ue_ext, op.uo_ext, op.off_ext, psi_ext,
                        m0=float(m0), beta=float(beta))
    return eo.unpack(FE, FO, geom)


def cg_solve_sharded_fused(geom: ShardedGeometry, Uf: torch.Tensor, m0,
                           b: torch.Tensor, x0: torch.Tensor | None = None, *,
                           tol: float, max_iter: int) -> CGResult:
    """Sharded (Dhat Dhat^+)^{-1} b with the whole per-iteration local work
    in K7: the apply and all four single-reduction inner products
    (solvers/cg.cg_solve_single_reduction semantics, the same update
    formulas, on f32 planes). Per iteration: 4 ppermutes, 1 launch, 1 psum
    of the [4] partials. Per chain, as solvers/cg.py: a chain whose stop
    rule has fired is frozen by masking, and the host is asked once per
    iteration whether any chain is live. b, x0: complex64
    [C, rx, rt, 2, Nx, Nth]; x0 defaults to b."""
    op = EOOperatorsHaloFused(geom, Uf, m0)
    b_pl = to_planar(b).contiguous()
    x = b_pl if x0 is None else to_planar(x0).contiguous()
    b_norm2 = geom.gsum_all(b_pl * b_pl)
    stop2 = torch.tensor(tol * tol, dtype=torch.float32,
                         device=b.device) * b_norm2
    r = b_pl - op.normal_planes(x)
    d = r
    rho = geom.gsum_all(r * r)
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=b.device)
    for _ in range(max_iter):
        live = rho >= stop2
        if not bool(live.any()):
            break
        Ad, dots = op.normal_planes(d, r)
        rr, dAd, AdAd, rAd = geom.mesh.psum(dots).unbind(-1)
        alpha = rr / dAd
        lv = bcast(live, x)
        a = bcast(alpha, x)
        x = torch.where(lv, torch.addcmul(x, a, d), x)
        r = torch.where(lv, torch.addcmul(r, -a, Ad), r)
        rho_new = rr - 2.0 * alpha * rAd + alpha * alpha * AdAd
        d = torch.where(lv, torch.addcmul(r, bcast(rho_new / rr, x), d), d)
        rho = torch.where(live, rho_new, rho)
        iters = iters + live.to(torch.int32)
    rho_exact = geom.gsum_all(r * r)
    return CGResult(x=to_complex(x), iters=iters, converged=rho_exact < stop2,
                    rel_residual=rel_residual(rho_exact, b_norm2))
