"""The mesh of lattice shards and its collectives.

Counterpart of ``schwingermodel_tpu/parallel/mesh.py`` (the reference's 2D
Cartesian MPI grid ranks_x x ranks_t, include/mpi_setup.h:39-71), together
with the collectives that JAX takes from ``lax`` inside ``shard_map``.

Two implementations of one small interface (``axis_size``, ``axis_index``,
``ppermute``, ``psum``, ``all_gather``); the per-shard kernels (ops/halo.py)
and the geometry (ops/geometry.py) do not see which runs.

- ``LatticeMesh``: every shard of the mesh lives on the one device, and
  the mesh axes are leading tensor axes. A sharded field is
  ``[C, rx, rt, comp.., Nx/rx, Nt/rt]``: chain c's block (i, j) is what
  ``jax.shard_map`` with ``P(None, 'x', 't')`` hands the shard at mesh
  position (i, j). The collectives are tensor operations over those axes:
  ``ppermute`` along a ring is a roll, ``psum`` a sum that keeps the axis
  at size 1 (so that it broadcasts back to every shard), ``axis_index`` an
  arange.
- ``DistLatticeMesh``: one process a shard, each holding the (1, 1) slice
  of the same axes, ``[C, 1, 1, comp.., Nx/rx, Nt/rt]``, the collectives
  ``torch.distributed`` calls: ``ppermute`` one send and one receive along
  the ring (``batch_isend_irecv``), ``psum`` an ``all_gather`` of the
  shards' partials. Built by ``parallel.multihost.multihost_mesh``.

``psum`` adds the shards' partials one by one in mesh order (row-major
over (x, t)) in both, so that every process of a plane holds the same
bits, and they are the one-process mesh's bits: the role of JAX's
``gsum_df`` all_gather (ops/geometry.py there), here on f64 or f32 values
as the caller gives them. Every solver decision reads psum-reduced values,
so the processes of a plane decide alike without a further collective
(JAX's ``sync_any``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

X_AXIS_NAME = "x"
T_AXIS_NAME = "t"
# tensor axis of each mesh axis in the sharded layout [C, rx, rt, ...]
_DIM = {X_AXIS_NAME: 1, T_AXIS_NAME: 2}


@dataclasses.dataclass(frozen=True)
class LatticeMesh:
    """An rx x rt mesh with axes ('x', 't'), all shards on one device."""

    shape: Tuple[int, int]
    axis_names = (X_AXIS_NAME, T_AXIS_NAME)
    # its collectives are tensor operations, which a CUDA graph can replay
    graph_safe = True

    def axis_size(self, name: str) -> int:
        return self.shape[_DIM[name] - 1]

    def axis_index(self, name: str, device=None) -> torch.Tensor:
        """Every shard's position along the axis, in the batch layout
        [1, rx, 1] or [1, 1, rt]."""
        shape = [1, 1, 1]
        shape[_DIM[name]] = self.axis_size(name)
        return torch.arange(self.axis_size(name), device=device).reshape(shape)

    def ppermute(self, a: torch.Tensor, name: str, shift: int) -> torch.Tensor:
        """Ring permutation: shard i's block goes to shard i + shift."""
        return torch.roll(a, shift, dims=_DIM[name])

    def psum(self, a: torch.Tensor, names=None) -> torch.Tensor:
        """Sum over the named mesh axes (default both), kept at size 1: the
        shards' values added one by one in mesh order."""
        parts = [a]
        for d in sorted(_DIM[n] for n in (names or self.axis_names)):
            parts = [q.narrow(d, k, 1) for q in parts for k in range(a.shape[d])]
        return _ordered_sum(parts)

    def all_gather(self, a: torch.Tensor) -> torch.Tensor:
        """Every shard's block [C, rx, rt, ...]: here already the field."""
        return a

    def _cut(self, a: torch.Tensor) -> torch.Tensor:
        """Global [C, comp.., X, T] -> the shards' blocks."""
        return _blocks(a, self.shape)


def _ordered_sum(parts) -> torch.Tensor:
    acc = parts[0]
    for q in parts[1:]:
        acc = acc + q
    return acc


def _blocks(a: torch.Tensor, shape) -> torch.Tensor:
    """[C, comp.., X, T] -> [C, rx, rt, comp.., X/rx, T/rt]."""
    rx, rt = shape
    *lead, X, T = a.shape
    if X % rx or T % rt:
        raise ValueError(f"field {X}x{T} not divisible by mesh {rx}x{rt}")
    a = a.reshape(*lead, rx, X // rx, rt, T // rt)
    return a.movedim(-4, 1).movedim(-2, 2).contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class DistLatticeMesh:
    """An rx x rt mesh across processes, one shard a process: this
    process holds shard ``index`` = (i, j) of its chain group's plane,
    fields [C, 1, 1, comp.., Nx/rx, Nt/rt]. ``plane``: the global ranks of
    the plane's processes in mesh order (rank base + i rt + j); ``groups``:
    this process's process groups, keyed by the mesh axes they span (the
    plane, its x ring, its t ring; none for an axis of one shard). With
    ``nccl`` the collectives move the tensors on the card (one card a
    process); else gloo moves CPU copies, which serves processes on the
    CPU or sharing one card (that is not multi-GPU). ``p2p``: the process
    group of the sends and receives (None: the default group)."""

    shape: Tuple[int, int]
    index: Tuple[int, int]
    plane: Tuple[int, ...]
    groups: dict
    nccl: bool = False
    p2p: object = None
    axis_names = (X_AXIS_NAME, T_AXIS_NAME)
    graph_safe = False

    def axis_size(self, name: str) -> int:
        return self.shape[_DIM[name] - 1]

    def axis_index(self, name: str, device=None) -> torch.Tensor:
        """This shard's position along the axis, [1, 1, 1]."""
        return torch.tensor(self.index[_DIM[name] - 1],
                            device=device).reshape(1, 1, 1)

    def _rank(self, i: int, j: int) -> int:
        rx, rt = self.shape
        return self.plane[(i % rx) * rt + j % rt]

    def _wire(self, a: torch.Tensor) -> torch.Tensor:
        a = a.contiguous()
        return a if self.nccl else a.cpu()

    def ppermute(self, a: torch.Tensor, name: str, shift: int) -> torch.Tensor:
        """Ring permutation: this shard's block goes to the shard `shift`
        further along the axis, and the block of the shard `shift` before
        comes back."""
        import torch.distributed as dist

        if self.axis_size(name) == 1:
            return a.clone()
        d = _DIM[name] - 1
        i, j = self.index
        to = self._rank(i + shift * (d == 0), j + shift * (d == 1))
        frm = self._rank(i - shift * (d == 0), j - shift * (d == 1))
        send = self._wire(a)
        recv = torch.empty_like(send)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, to, group=self.p2p),
                dist.P2POp(dist.irecv, recv, frm, group=self.p2p)]):
            w.wait()
        return recv.to(a.device)

    def _gather(self, a: torch.Tensor, names) -> list:
        """The named axes' shards' values of a, in mesh order."""
        import torch.distributed as dist

        key = tuple(n for n in self.axis_names if n in names)
        group = self.groups.get(key)
        if group is None:            # the named axes hold one shard
            return [a]
        wire = self._wire(a)
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire, group=group)
        return [q.to(a.device) for q in parts]

    def psum(self, a: torch.Tensor, names=None) -> torch.Tensor:
        """Sum over the named mesh axes (default both): every shard's
        value, added one by one in mesh order (LatticeMesh.psum's bits)."""
        return _ordered_sum(self._gather(a, names or self.axis_names))

    def all_gather(self, a: torch.Tensor) -> torch.Tensor:
        """Every shard's block of the plane, [C, rx, rt, ...]."""
        rx, rt = self.shape
        parts = self._gather(a, self.axis_names)
        return torch.cat(parts, dim=1).reshape(
            a.shape[0], rx, rt, *a.shape[3:])

    def _cut(self, a: torch.Tensor) -> torch.Tensor:
        """Global [C, comp.., X, T] -> this shard's block."""
        i, j = self.index
        b = _blocks(a, self.shape)
        return b[:, i:i + 1, j:j + 1].contiguous()


def choose_mesh_shape(n_devices: int, Nx: int, Nt: int) -> Tuple[int, int]:
    """(rx, rt) with rx * rt == n_devices whose blocks are the closest to
    square (the least halo surface per volume): JAX ``choose_mesh_shape``,
    the automatic counterpart of the reference's ranks_x/ranks_t prompts
    (src/main.cpp; validated at mpi_setup.h:6-23)."""
    best = None
    for rx in range(1, n_devices + 1):
        if n_devices % rx:
            continue
        rt = n_devices // rx
        if Nx % rx or Nt % rt:
            continue
        wx, wt = Nx // rx, Nt // rt
        # surface-to-volume of the local block = 2(wx+wt)/(wx*wt)
        cost = (wx + wt) / (wx * wt)
        if best is None or cost < best[0]:
            best = (cost, rx, rt)
    if best is None:
        raise ValueError(
            f"cannot tile {Nx}x{Nt} lattice over {n_devices} devices: no "
            f"factorization rx*rt={n_devices} divides (Nx, Nt) evenly "
            f"(reference exits the same way, mpi_setup.h:12-19)"
        )
    return best[1], best[2]


def lattice_mesh(shape: Optional[Tuple[int, int]] = None) -> LatticeMesh:
    """A LatticeMesh of shape (rx, rt); one shard where no shape is given."""
    rx, rt = (1, 1) if shape is None else shape
    if rx < 1 or rt < 1:
        raise ValueError(f"mesh shape {shape}: extents must be positive")
    return LatticeMesh((int(rx), int(rt)))


def shard(field, mesh, device=None) -> torch.Tensor:
    """Global field [C, comp.., X, T] (tensor or numpy; T the full or the
    even-odd packed time extent) -> sharded [C, rx, rt, comp.., X/rx, T/rt]:
    block (i, j) holds rows [i X/rx, (i+1) X/rx) and columns
    [j T/rt, (j+1) T/rt), as ``shard_map`` cuts with ``P(None, 'x', 't')``;
    on a DistLatticeMesh this process's block, [C, 1, 1, ...]."""
    # np.array copies: an array handed over by another framework may be
    # read-only
    a = field if isinstance(field, torch.Tensor) else torch.from_numpy(np.array(field))
    if device is not None:
        a = a.to(device)
    return mesh._cut(a)


def unshard(field: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of ``shard``: [C, rx, rt, comp.., X/rx, T/rt] ->
    [C, comp.., X, T]; on a DistLatticeMesh from this process's block, the
    plane's blocks gathered on every process."""
    rx, rt = mesh.shape
    field = mesh.all_gather(field)
    C, _, _, *comp, xl, tl = field.shape
    a = field.movedim(2, -2).movedim(1, -4)      # [C, comp.., rx, xl, rt, tl]
    return a.reshape(C, *comp, rx * xl, rt * tl)
