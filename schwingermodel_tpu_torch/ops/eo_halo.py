"""Wide-halo composite even-odd normal apply: one halo ring per apply.

Counterpart of ``schwingermodel_tpu/ops/eo_halo.py``. The per-hop sharded
stencil (ops/eo.py through a ShardedGeometry) exchanges one halo slice per
shift, 16 per application of Dhat Dhat^+. Here a width-4 ring is exchanged
once per apply (4 ppermutes; corners ride along because the x extension
acts on the t-extended array), all four hops run locally on the extended
block, and the crop removes the 4 sites of validity the hops consumed. The
links are extended once per solve.

Inside the extended block the shifts are plain periodic (the one-lattice
``Geometry``): the wrap-around garbage enters one ring per hop and never
reaches the cropped interior. The checkerboard offsets of the extended
rows come from the global x, and the antiperiodic sign arrives folded in
the extended links.

Needs halo width W <= both local packed extents (``supported``).
"""

from __future__ import annotations

import torch

from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops.geometry import (
    LOCAL, T_AXIS, X_AXIS, ShardedGeometry,
)

# Dhat Dhat^+ = 4 hops; each hop consumes one ring of each axis.
W = 4


def supported(geom, local_Nx: int, local_Nth: int) -> bool:
    """True where the width-4 composite fits this shard size and saves
    collectives: on a mesh with both axes trivial the skirt would be
    redundant work for nothing."""
    if not (isinstance(geom, ShardedGeometry)
            and local_Nx >= W and local_Nth >= W):
        return False
    return (geom.mesh.axis_size(geom.x_name) > 1
            or geom.mesh.axis_size(geom.t_name) > 1)


def _extend_axis(mesh, a: torch.Tensor, axis: int, name: str, w: int):
    """Prepend and append the w-slice halos of the ring neighbours along one
    mesh axis (2 ppermutes; local slicing where the axis has one shard)."""
    lo = a.narrow(axis, 0, w)                       # our first w slices
    hi = a.narrow(axis, a.shape[axis] - w, w)
    if mesh.axis_size(name) == 1:
        left, right = hi, lo                        # periodic wrap
    else:
        # right halo = the next shard's first w; left = the previous one's
        # last w
        right = mesh.ppermute(lo, name, -1)
        left = mesh.ppermute(hi, name, +1)
    return torch.cat([left, a, right], dim=axis)


def extend(geom: ShardedGeometry, a: torch.Tensor, w: int = W) -> torch.Tensor:
    """[..., Nx, K] -> [..., Nx+2w, K+2w] with the neighbours' data in the
    skirt: t first, then x of the t-extended array, so the corners are
    right."""
    a = _extend_axis(geom.mesh, a, T_AXIS, geom.t_name, w)
    return _extend_axis(geom.mesh, a, X_AXIS, geom.x_name, w)


def _ext_offsets(geom: ShardedGeometry, Nx: int, w: int, device=None):
    """(off_e, off_o) of the extended rows, int32 site tensors
    [1, rx, 1, Nx+2w, 1] (or [1, 1, 1, ...]: this process's shard), from
    the global row index."""
    ix = geom.mesh.axis_index(geom.x_name, device).reshape(1, -1, 1, 1, 1)
    j = torch.arange(Nx + 2 * w, device=device).reshape(1, 1, 1, -1, 1)
    off_e = ((ix * Nx + j - w) % 2).to(torch.int32)
    return off_e, 1 - off_e


class EOOperatorsHalo:
    """Sharded (Dhat Dhat^+) with one width-4 halo ring per apply: the CG
    operator of the sharded path with ``fused_cg=False``. ``normal(v)``
    takes and returns local blocks [C, rx, rt, 2, Nx, Nth]; equals
    ``eo.EOOperators.normal`` through the ShardedGeometry."""

    def __init__(self, geom: ShardedGeometry, Uf: torch.Tensor, m0):
        *_, Nx, _ = Uf.shape
        self.geom = geom
        Ue = eo.pack(Uf, eo.EVEN, geom)
        Uo = eo.pack(Uf, eo.ODD, geom)
        # one stacked extension for both parities: 4 ppermutes, not 8
        both = extend(geom, torch.cat([Ue, Uo], dim=-3))
        self.Ue, self.Uo = both[..., :2, :, :], both[..., 2:, :, :]
        off_e, off_o = _ext_offsets(geom, Nx, W, Uf.device)
        self.off_e, self.off_o = off_e == 1, off_o == 1
        self.m, self.c = eo.mass_terms(m0)

    def normal(self, v: torch.Tensor) -> torch.Tensor:
        """(Dhat Dhat^+) v, 4 ppermutes in all."""
        ve = extend(self.geom, v)
        w1 = eo.hop_dag(self.Uo, self.Ue, ve, self.off_o, LOCAL)
        u = self.m * ve - self.c * eo.hop_dag(self.Ue, self.Uo, w1,
                                              self.off_e, LOCAL)
        w2 = eo.hop(self.Uo, self.Ue, u, self.off_o, LOCAL)
        out = self.m * u - self.c * eo.hop(self.Ue, self.Uo, w2, self.off_e,
                                           LOCAL)
        return out[..., W:-W, W:-W]
