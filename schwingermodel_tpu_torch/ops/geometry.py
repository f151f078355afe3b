"""Lattice geometry: periodic shifts and global reductions.

Counterpart of ``schwingermodel_tpu/ops/geometry.py``. The unpacked sampler
and every operator it uses are written against

    shift(a, axis, delta) -> b with b(n) = a(n + delta * hat_axis)
    gsum(a)               -> sum over the global lattice

``Geometry`` is one lattice per chain: shift is ``torch.roll``, gsum a sum.
``ShardedGeometry`` is a lattice cut into rx x rt blocks over a mesh
(parallel/mesh.py): shift is a local roll plus a one-slice halo fix through
``mesh.ppermute``, reductions are local sums plus ``mesh.psum``, and the
global coordinates come from the shard index. The mesh holds every shard
on one device, or this process's shard of a mesh across processes.

Layouts. x is axis -2, t is axis -1 of every field. The leading axes are
batch axes: ``[C, ...]`` without a mesh, ``[C, rx, rt, ...]`` on one (a JAX
function under ``shard_map`` sees one shard's block; here every shard's
block sits side by side). Component axes (spin, direction) lie between the
batch axes and the lattice axes. Two kinds of small tensors go with that:

- a *site tensor* (row offsets, the sign mask, coordinates) has batch axes
  and the two lattice axes but no component axes: ``site(t, like)`` inserts
  the singleton axes that let it broadcast against the field ``like``;
- a *chain scalar* (a dot product, alpha) has batch axes only, each shard
  axis of size 1 after the psum: ``bcast(s, like)`` appends singleton axes.

``gsum_df`` is not ported: f64 sums take the place of double-float ones.
"""

from __future__ import annotations

import torch

X_AXIS = -2
T_AXIS = -1


def site(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A site tensor [batch.., X, T] viewed so that it broadcasts against
    the field `like` [batch.., comp.., X, T]."""
    extra = like.ndim - t.ndim
    if extra <= 0 or t.ndim == 2:
        return t
    return t.reshape(*t.shape[:-2], *(1,) * extra, *t.shape[-2:])


def bcast(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A chain scalar [batch..] viewed so that it broadcasts against the
    field `like` [batch.., ...]."""
    return s.reshape(*s.shape, *(1,) * (like.ndim - s.ndim))


class Geometry:
    """One periodic lattice per chain: fields are [C, comp.., Nx, Nt]."""

    is_sharded = False
    batch_ndim = 1
    # whether a CUDA graph may capture an operator through this geometry
    # (a mesh across processes communicates through the host)
    graph_safe = True

    def shift(self, a: torch.Tensor, axis: int, delta: int) -> torch.Tensor:
        """b with b[..., n] = a[..., n + delta * hat(axis)]: gathering the
        value at n+1 rolls the contents backwards."""
        return torch.roll(a, -delta, dims=axis)

    def gsum(self, a: torch.Tensor) -> torch.Tensor:
        """Sum over the lattice axes; leading axes are kept."""
        return a.sum(dim=(X_AXIS, T_AXIS))

    def gsum_all(self, a: torch.Tensor) -> torch.Tensor:
        """Sum over every axis but the batch axes: one value per chain."""
        return a.sum(dim=tuple(range(self.batch_ndim, a.ndim)))

    def gsum_stack(self, locals_: list) -> torch.Tensor:
        """Reduce a list of already lattice-summed chain scalars with one
        collective; they come back stacked along a new last axis."""
        return torch.stack(locals_, dim=-1)

    def global_coords(self, Nx: int, Nt: int, device=None):
        """(x, t) integer coordinate grids, site tensors [Nx, Nt]."""
        x = torch.arange(Nx, device=device).reshape(Nx, 1).expand(Nx, Nt)
        t = torch.arange(Nt, device=device).reshape(1, Nt).expand(Nx, Nt)
        return x, t


LOCAL = Geometry()


class ShardedGeometry(Geometry):
    """The lattice cut into mesh.shape = (rx, rt) blocks: fields are
    [C, rx, rt, comp.., Nx/rx, Nt/rt]."""

    is_sharded = True
    batch_ndim = 3

    def __init__(self, mesh):
        self.mesh = mesh
        self.x_name, self.t_name = mesh.axis_names
        self.graph_safe = mesh.graph_safe

    def _mesh_axis(self, axis: int) -> str:
        # fields are [..., x, t]: axis -2 (even) -> x, axis -1 (odd) -> t
        return self.x_name if axis % 2 == 0 else self.t_name

    def shift(self, a: torch.Tensor, axis: int, delta: int) -> torch.Tensor:
        name = self._mesh_axis(axis)
        rolled = torch.roll(a, -delta, dims=axis)
        if self.mesh.axis_size(name) == 1:
            return rolled
        last = a.shape[axis] - 1
        if delta == 1:
            # the next shard's first slice lands in our last slot: every
            # shard sends its first slice to the previous shard of the ring
            recv = self.mesh.ppermute(a.narrow(axis, 0, 1), name, -1)
            rolled.narrow(axis, last, 1).copy_(recv)
        elif delta == -1:
            recv = self.mesh.ppermute(a.narrow(axis, last, 1), name, +1)
            rolled.narrow(axis, 0, 1).copy_(recv)
        else:
            raise NotImplementedError("only unit shifts are used by the stencils")
        return rolled

    def gsum(self, a: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(a.sum(dim=(X_AXIS, T_AXIS)))

    def gsum_all(self, a: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(super().gsum_all(a))

    def gsum_stack(self, locals_: list) -> torch.Tensor:
        return self.mesh.psum(torch.stack(locals_, dim=-1))

    def global_coords(self, Nx: int, Nt: int, device=None):
        """Global coordinates of the shards' sites, site tensors
        [1, rx, rt, Nx, Nt] (every shard) or [1, 1, 1, Nx, Nt] (this
        process's); Nx, Nt are the local extents."""
        ix = self.mesh.axis_index(self.x_name, device).reshape(1, -1, 1, 1, 1)
        it = self.mesh.axis_index(self.t_name, device).reshape(1, 1, -1, 1, 1)
        x = torch.arange(Nx, device=device).reshape(1, 1, 1, Nx, 1) + ix * Nx
        t = torch.arange(Nt, device=device).reshape(1, 1, 1, 1, Nt) + it * Nt
        shape = (1, ix.shape[1], it.shape[2], Nx, Nt)
        return x.expand(shape), t.expand(shape)


def shift_p_t(geom: Geometry, a):
    return geom.shift(a, T_AXIS, +1)


def shift_m_t(geom: Geometry, a):
    return geom.shift(a, T_AXIS, -1)


def shift_p_x(geom: Geometry, a):
    return geom.shift(a, X_AXIS, +1)


def shift_m_x(geom: Geometry, a):
    return geom.shift(a, X_AXIS, -1)
