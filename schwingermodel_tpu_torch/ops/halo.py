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
``lead``, or 2-8 each with its rows of the block (``halo_path``). CPU
tensors run the twins; CUDA tensors run the kernels.

Per sharded CG iteration (``cg_solve_sharded_fused``): 4 ppermutes, one K7
launch and one psum of the four partials. K7 accumulates its partials in
f64 and rounds them once to f32, so against an unsharded solve the psum
over the shards (f32 adds of rx * rt partials) is the only reordering: the
recursive rho agrees to a few f32 ulps, and the solutions to the same
2e-4 as any two f32 CGs of this package.
"""

from __future__ import annotations

import functools

import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, eo_halo, gauge
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.eo_halo import W, _ext_offsets, extend
from schwingermodel_tpu_torch.ops.geometry import LOCAL, ShardedGeometry, bcast
from schwingermodel_tpu_torch.ops.traj import to_complex, to_planar
from schwingermodel_tpu_torch.solvers.cg import CGResult, rel_residual

# Bytes a site of K7's and K8's stores on the shared path (csrc/halo_normal.cu
# kNormalSharedBytes: links, v, w1, u; K8: K1's store with the plaquette
# angles) and f32 values a site of their global scratch.
_NORMAL_BYTES, _NORMAL_SCRATCH = 80, 8
_FORCE_BYTES, _FORCE_SCRATCH = tr._CG_SHARED_BYTES + tr._PLAQ_BYTES, 14


@functools.lru_cache(maxsize=None)
def halo_path(Nxe: int, Nthe: int, entries: int, sms: int = _cuda.H100_SMS,
              per_site: int = _NORMAL_BYTES):
    """Where K7 (per_site _NORMAL_BYTES) or K8 (_FORCE_BYTES) keeps the
    fields of `entries` extended blocks of Nxe x Nthe half-lattice sites on
    a card of `sms` multiprocessors: (path, blocks a shard), K1's rule
    without the solve (traj.split_rows) on the Nxe - 2W interior rows, each
    block holding the W extended rows on either side of its own: the most
    blocks a shard that leave all blocks running at once (64x64 over 2x2 at
    C=32, 128 shards: 1; 128x128 over 2x2 at C=2: 8), else the fewest that
    hold the block (C=128: 1); the global scratch (traj.CG_GLOBAL) where no
    split of at most 8 holds it."""
    return tr.split_rows(Nxe - 2 * W, Nthe, entries, sms, per_site, skirt=True)


def halo_path_name(Nxe: int, Nthe: int, entries: int, sms: int = _cuda.H100_SMS,
                   per_site: int = _NORMAL_BYTES) -> str:
    path, n = halo_path(Nxe, Nthe, entries, sms, per_site)
    if path == tr.CG_GLOBAL:
        return "global"
    return "shared" if n == 1 else f"shared, {n} blocks a shard"


def _check_planes(ue_ext, uo_ext, off_ext) -> None:
    """Raise unless the extended links are contiguous f32
    [*lead, 2, 2, Nxe, Nthe] with an interior and the row offsets int32
    [*lead, Nxe], all on one device (a CUDA one where the links are)."""
    if ue_ext.dim() < 4 or tuple(ue_ext.shape[-4:-2]) != (2, 2):
        raise ValueError(f"ue_ext: expected [*lead, 2, 2, Nxe, Nthe], got "
                         f"{tuple(ue_ext.shape)}")
    *lead, _, _, Nxe, Nthe = ue_ext.shape
    if Nxe <= 2 * W or Nthe <= 2 * W:
        raise ValueError(f"extended block {Nxe}x{Nthe} has no interior")
    for t, name, dtype, shape in ((ue_ext, "ue_ext", torch.float32, ue_ext.shape),
                                  (uo_ext, "uo_ext", torch.float32, ue_ext.shape),
                                  (off_ext, "off_ext", torch.int32, (*lead, Nxe))):
        if t.device != ue_ext.device:
            raise ValueError(f"{name}: on {t.device}, ue_ext on {ue_ext.device}")
        _cuda.check(t, name, dtype, shape, cuda=ue_ext.is_cuda)


class _Launch:
    """K7's or K8's launches on one set of extended planes (links and row
    offsets, checked by the caller): their pointers, the path and blocks a
    shard (``halo_path`` on `sms` multiprocessors, the card's by default,
    or the (path, blocks) `route` that a check or a timing tool asks for,
    e.g. the global path where the rule takes another), and the global
    scratch where the path needs one, worked out once; a call checks only
    the fields it is given."""

    def __init__(self, ue_ext, uo_ext, off_ext, entry, per_site, scratch_floats, sms=None,
                 route=None):
        *lead, _, _, Nxe, Nthe = ue_ext.shape
        self.device = ue_ext.device
        self.planes = (ue_ext, uo_ext, off_ext)     # alive while their pointers are used
        self.ptrs = tuple(t.data_ptr() for t in self.planes)
        self.lead, self.Nxe, self.Nthe = tuple(lead), Nxe, Nthe
        self.ext = ue_ext.shape
        self.loc = (Nxe - 2 * W, Nthe - 2 * W)
        self.n = off_ext.numel() // Nxe
        if route is None:
            sms = _cuda.sm_count(self.device) if sms is None else sms
            route = halo_path(Nxe, Nthe, self.n, sms, per_site)
        self.path, self.blocks = route
        self.scratch = (None if self.path == tr.CG_SHARED else torch.empty(
            self.n * scratch_floats * Nxe * Nthe, dtype=torch.float32, device=self.device))
        self.scratch_ptr = None if self.scratch is None else self.scratch.data_ptr()
        self.entry = entry
        self.fn = _cuda.KERNELS.entry(entry)

    def _check(self, t, name, shape):
        # the common case in one test; the full check names what is wrong
        if not (t.dtype == torch.float32 and t.shape == shape and t.device == self.device
                and t.is_contiguous()):
            _cuda.check(t, name, torch.float32, shape, cuda=self.device.type == "cuda")
            raise ValueError(f"{name}: on {t.device}, the planes on {self.device}")

    def _launch(self, *args):
        err = self.fn(*args, torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.entry}: CUDA error {err}")


class _NormalLaunch(_Launch):
    """K7 on one operator's planes: ``(v_ext)`` -> out, ``(v_ext, r)`` ->
    (out, dots)."""

    def __init__(self, ue_ext, uo_ext, off_ext, m0, sms=None, route=None):
        super().__init__(ue_ext, uo_ext, off_ext, "halo_normal_launch", _NORMAL_BYTES,
                         _NORMAL_SCRATCH, sms, route)
        self.m0 = float(m0)
        self.out_shape = (*self.lead, 2, 2, *self.loc)
        if self.path == tr.CG_SHARED and self.blocks > 1:
            # the blocks' f64 partials [n, blocks, 4] and a uint32 ticket a
            # shard, zero between launches (csrc/halo_normal.cu)
            self.scratch = torch.zeros(self.n * self.blocks * 4 + (self.n + 1) // 2,
                                       dtype=torch.float64, device=self.device)
            self.scratch_ptr = self.scratch.data_ptr()

    def __call__(self, v_ext, r_loc=None):
        self._check(v_ext, "v_ext", self.ext)
        out = torch.empty(self.out_shape, dtype=torch.float32, device=self.device)
        r_ptr = dots_ptr = dots = None
        if r_loc is not None:
            self._check(r_loc, "r_loc", self.out_shape)
            dots = torch.empty((*self.lead, 4), dtype=torch.float32, device=self.device)
            r_ptr, dots_ptr = r_loc.data_ptr(), dots.data_ptr()
        self._launch(*self.ptrs, v_ext.data_ptr(), r_ptr, out.data_ptr(), dots_ptr,
                     self.scratch_ptr, self.n, self.Nxe, self.Nthe, self.m0,
                     int(r_loc is not None), self.path, self.blocks)
        return out if r_loc is None else (out, dots)


class _ForceLaunch(_Launch):
    """K8 on one set of extended planes: ``(psi_ext, m0, beta)`` -> (FE, FO)."""

    def __init__(self, ue_ext, uo_ext, off_ext, sms=None, route=None):
        super().__init__(ue_ext, uo_ext, off_ext, "halo_force_launch", _FORCE_BYTES,
                         _FORCE_SCRATCH, sms, route)

    def __call__(self, psi_ext, m0, beta):
        self._check(psi_ext, "psi_ext", self.ext)
        FE = torch.empty((*self.lead, 2, *self.loc), dtype=torch.float32, device=self.device)
        FO = torch.empty_like(FE)
        self._launch(*self.ptrs, psi_ext.data_ptr(), FE.data_ptr(), FO.data_ptr(),
                     self.scratch_ptr, self.n, self.Nxe, self.Nthe, float(m0), float(beta),
                     self.path, self.blocks)
        return FE, FO


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


def halo_normal(ue_ext, uo_ext, off_ext, v_ext, r_loc=None, *, m0,
                with_dots=False):
    """K7: out = crop((Dhat Dhat^+) v_ext) on every block
    (pallas_halo.halo_normal_fused).

    ue_ext, uo_ext: f32 [*lead, 2(dir), 2(re/im), Nxe, Nthe], the extended
    packed links with the antiperiodic sign folded; off_ext: int32
    [*lead, Nxe], the extended rows' even-parity offsets (alternating by
    row, as ``eo_halo._ext_offsets`` makes them: the kernel reads the first
    row's of each block); v_ext: f32 [*lead, 2(spin), 2, Nxe, Nthe].
    Returns f32 [*lead, 2, 2, Nxe-2W, Nthe-2W]. with_dots: r_loc f32 of the
    output's shape, the un-extended local residual; also returns the local
    partials [<r,r>, <d,Ad>, <Ad,Ad>, <r,Ad>] f32 [*lead, 4] with
    d = crop(v_ext) and Ad = out. CUDA tensors run the kernel on the path
    ``halo_path`` gives; CPU tensors run the twin."""
    *lead, _, _, Nxe, Nthe = v_ext.shape
    if Nxe <= 2 * W or Nthe <= 2 * W:
        raise ValueError(f"extended block {Nxe}x{Nthe} has no interior")
    if with_dots and r_loc is None:
        raise ValueError("with_dots needs r_loc")
    if not v_ext.is_cuda:
        return halo_normal_reference(ue_ext, uo_ext, off_ext, v_ext, r_loc,
                                     m0=m0, with_dots=with_dots)
    _check_planes(ue_ext, uo_ext, off_ext)
    return _NormalLaunch(ue_ext, uo_ext, off_ext, m0)(v_ext, r_loc if with_dots else None)


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
    _check_planes(ue_ext, uo_ext, off_ext)
    return _ForceLaunch(ue_ext, uo_ext, off_ext)(psi_ext, m0, beta)


# ---------- the operators of the sharded path ----------

def fused_supported(geom, Nx_l: int, Nth_l: int, rdtype) -> bool:
    """The fused sharded path applies: the wide halo fits the local block
    and the working dtype is f32 (the kernels are f32 planar)."""
    return eo_halo.supported(geom, Nx_l, Nth_l) and rdtype == torch.float32


class EOOperatorsHaloFused:
    """``eo_halo.EOOperatorsHalo`` with the local compute of each apply in
    one K7 launch, on f32 planes (the sharded CG's layout). Uf: folded
    links [C, rx, rt, 2, Nx, Nt] complex64. The links are extended once,
    at construction (4 ppermutes), and checked there; on the card each
    kernel's constant pointers, path and scratch are worked out at its first
    launch, so an apply checks only its spinors."""

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
        _check_planes(self.ue_ext, self.uo_ext, self.off_ext)
        self._k7 = self._k8 = None

    def normal_planes(self, p: torch.Tensor, r: torch.Tensor | None = None):
        """K7 on planar f32 p [C, rx, rt, 2, 2, Nx, Nth]: 4 ppermutes and
        one launch; with r also the local dot partials."""
        return self.normal_ext(extend(self.geom, p), r)

    def normal_ext(self, p_ext: torch.Tensor, r: torch.Tensor | None = None):
        """K7 on the extended planar f32 p_ext [C, rx, rt, 2, 2, Nxe, Nthe]:
        one launch; with r also the local dot partials."""
        if self.ue_ext.is_cuda:
            if self._k7 is None:
                self._k7 = _NormalLaunch(self.ue_ext, self.uo_ext, self.off_ext, self.m0)
            return self._k7(p_ext, r)
        return halo_normal(self.ue_ext, self.uo_ext, self.off_ext, p_ext, r,
                           m0=self.m0, with_dots=r is not None)

    def force_planes(self, psi_ext: torch.Tensor, beta):
        """K8 on the extended planar f32 psi_ext [C, rx, rt, 2, 2, Nxe, Nthe]
        and these links: (FE, FO)."""
        if self.ue_ext.is_cuda:
            if self._k8 is None:
                self._k8 = _ForceLaunch(self.ue_ext, self.uo_ext, self.off_ext)
            return self._k8(psi_ext, self.m0, beta)
        return halo_force(self.ue_ext, self.uo_ext, self.off_ext, psi_ext,
                          m0=self.m0, beta=float(beta))


def force_halo_fused(geom: ShardedGeometry, Uf: torch.Tensor, m0, psi, beta,
                     ) -> torch.Tensor:
    """Total MD force F = F_fermion(psi) + F_gauge on a lattice-sharded
    block: 8 ppermutes (one stacked link extension, one psi extension) and
    one K8 launch. psi: complex64 even-packed [C, rx, rt, 2, Nx, Nth];
    returns the real full-lattice local force [C, rx, rt, 2(mu), Nx, Nt]."""
    op = EOOperatorsHaloFused(geom, Uf, m0)
    FE, FO = op.force_planes(extend(geom, to_planar(psi)), float(beta))
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
