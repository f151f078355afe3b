"""The mesh of lattice shards and its collectives.

Counterpart of ``schwingermodel_tpu/parallel/mesh.py`` (the reference's 2D
Cartesian MPI grid ranks_x x ranks_t, include/mpi_setup.h:39-71), together
with the collectives that JAX takes from ``lax`` inside ``shard_map``.

One implementation: every shard of the mesh lives on the one device, and
the mesh axes are leading tensor axes. A sharded field is
``[C, rx, rt, comp.., Nx/rx, Nt/rt]``: chain c's block (i, j) is what
``jax.shard_map`` with ``P(None, 'x', 't')`` hands the shard at mesh
position (i, j). The collectives are tensor operations over those axes:
``ppermute`` along a ring is a roll, ``psum`` a sum that keeps the axis at
size 1 (so that it broadcasts back to every shard), ``axis_index`` an
arange. The interface is kept this small so that an implementation that
holds one (1, 1) slice of the same axes per process and speaks
``torch.distributed`` can take its place; the per-shard kernels
(ops/halo.py) do not see the difference.
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
        """Sum over the named mesh axes (default both), kept at size 1."""
        dims = tuple(_DIM[n] for n in (names or self.axis_names))
        return a.sum(dim=dims, keepdim=True)


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


def shard(field, mesh: LatticeMesh, device=None) -> torch.Tensor:
    """Global field [C, comp.., X, T] (tensor or numpy; T the full or the
    even-odd packed time extent) -> sharded [C, rx, rt, comp.., X/rx, T/rt]:
    block (i, j) holds rows [i X/rx, (i+1) X/rx) and columns
    [j T/rt, (j+1) T/rt), as ``shard_map`` cuts with ``P(None, 'x', 't')``."""
    # np.array copies: an array handed over by another framework may be
    # read-only
    a = field if isinstance(field, torch.Tensor) else torch.from_numpy(np.array(field))
    if device is not None:
        a = a.to(device)
    rx, rt = mesh.shape
    *lead, X, T = a.shape
    if X % rx or T % rt:
        raise ValueError(f"field {X}x{T} not divisible by mesh {rx}x{rt}")
    a = a.reshape(*lead, rx, X // rx, rt, T // rt)
    return a.movedim(-4, 1).movedim(-2, 2).contiguous()


def unshard(field: torch.Tensor, mesh: LatticeMesh) -> torch.Tensor:
    """The inverse of ``shard``: [C, rx, rt, comp.., X/rx, T/rt] ->
    [C, comp.., X, T]."""
    rx, rt = mesh.shape
    C, _, _, *comp, xl, tl = field.shape
    a = field.movedim(2, -2).movedim(1, -4)      # [C, comp.., rx, xl, rt, tl]
    return a.reshape(C, *comp, rx * xl, rt * tl)
