"""Multi-process runs: chain groups, each over one process or a lattice
mesh of them.

Counterpart of ``schwingermodel_tpu/parallel/multihost.py``. The reference
scales with one flat MPI world (``mpirun -n N``, include/mpi_setup.h:39-71);
the JAX package brings up ``jax.distributed`` and builds a global
('chain', 'x', 't') mesh over the devices of every process. Here a process
drives one device, so a run of N processes is the mesh (rc, rx, rt) with
rc rx rt = N, rank r at (c, i, j) chain-major (r = c rx rt + i rt + j), as
JAX's device grid:

- rx = rt = 1 (``multihost_mesh()``): N chain groups, process i holds
  chains [i C/N, (i+1) C/N) on its own device, with the lattice whole
  there, and no collective runs inside a trajectory (the chains are
  independent);
- a lattice mesh (``multihost_mesh(rx, rt)``): rc chain groups, each cut
  over the rx rt processes of its plane, one shard a process, through a
  ``parallel.mesh.DistLatticeMesh`` (halo exchanges and psums inside the
  trajectory; the configuration gathered on the plane after each).

What crosses the chain groups is small: the block statistics and the
observables, gathered once per block, the pooled acceptance of the
step-size warm-up, once per warm-up trajectory, and the configuration for
I/O. Every process of a plane holds its group's results bit for bit, so a
gather takes one process a plane.

I/O follows the reference's rank-0 pattern (gauge_conf.cpp:378-419): every
process computes, only the primary writes; ``gather_global`` assembles the
chains of every process, in global chain order, on every process.

Where the collectives run: every process runs on
``cuda:{LOCAL_RANK % device_count}`` (``--device cpu``: the CPU). Where
each rank has a card of its own, the gathers use NCCL on the cards; where
ranks share a card (NCCL refuses two ranks on one card) or run on the CPU,
they use gloo on CPU copies of the small gathered tensors. Two processes
on one card time-slice it: that is not a multi-GPU run, and the banner
(``layout``) says so.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Tuple

import numpy as np
import torch

# plane: the processes of one chain group (rx rt of a lattice mesh, else 1)
_state = {"initialized": False, "nccl": None, "devices": 1, "backend": None,
          "plane": 1}


def _multi(var: str) -> bool:
    v = os.environ.get(var)
    try:
        return v is not None and int(v) > 1
    except ValueError:
        return False


# (rank, world size) variables of the launchers whose worlds start from the
# environment: torchrun, SLURM, Open MPI
_LAUNCHERS = (("RANK", "WORLD_SIZE"), ("SLURM_PROCID", "SLURM_NTASKS"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"))


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda") -> bool:
    """Start ``torch.distributed`` if (and only if) a multi-process launch
    is given or detected; idempotent; True when running distributed.

    Detection, as the JAX package's: explicit arguments win
    (``--coordinator host:port --num-processes N --process-id i``:
    ``tcp://host:port``, world N, rank i); otherwise a world above 1 in
    torchrun's ``RANK``/``WORLD_SIZE`` or in ``SLURM_NTASKS`` or
    ``OMPI_COMM_WORLD_SIZE`` (with their ranks) starts from ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``; torchrun sets them, a SLURM or MPI
    job script exports them). A bare ``SLURM_JOB_ID`` (any single-task
    job), a plain single-process run, or a cluster's world without the
    rendezvous address returns False and leaves torch.distributed
    untouched. ``device`` ("cuda" or "cpu") chooses the gathers' backend
    (module docstring)."""
    import torch.distributed as dist

    if _state["initialized"]:
        return True
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError("--coordinator, --num-processes and --process-id "
                             "go together")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    else:
        found = [(r, w) for r, w in _LAUNCHERS
                 if _multi(w) and r in os.environ]
        if not found or not {"MASTER_ADDR", "MASTER_PORT"} <= set(os.environ):
            return False
        r, w = found[0]
        dist.init_process_group("gloo", init_method="env://",
                                rank=int(os.environ[r]),
                                world_size=int(os.environ[w]))
    _state["initialized"] = True
    dev = local_device(device)
    # which card (or host's CPU) each rank holds, to pick the gathers'
    # backend
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(), str(dev)))
    _state["devices"] = len(set(where))
    own_card = dev.type == "cuda" and len(set(where)) == len(where)
    if own_card:
        _state["nccl"] = dist.new_group(backend="nccl")
    _state["backend"] = "nccl" if own_card else "gloo"
    return True


def shutdown() -> None:
    """End the process group of a distributed run (a no-op otherwise)."""
    import torch.distributed as dist

    if _state["initialized"]:
        dist.destroy_process_group()
        _state.update(initialized=False, nccl=None, devices=1, backend=None,
                      plane=1)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d else 1


def is_primary() -> bool:
    """True on the process allowed to write files (reference: rank == 0)."""
    return process_index() == 0


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK % device_count}`` (the
    rank where no launcher set LOCAL_RANK), made the current CUDA device;
    the CPU for ``device="cpu"``."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    dev = torch.device("cuda", local % n)
    torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """The multi-process layout ('chain', 'x', 't') = (rc, rx, rt): chain
    group ``index`` of ``shape[0]``, with the lattice whole on its
    process's device (rx = rt = 1), or cut over the rx rt processes of its
    plane, this process's shard through ``lattice`` (a
    parallel.mesh.DistLatticeMesh)."""

    shape: Tuple[int, int, int]
    index: int
    lattice: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def groups(self) -> int:
        return self.shape[0]

    def local_chains(self, n_chains: int) -> slice:
        """This group's chains of n_chains (a multiple of the groups)."""
        if n_chains % self.groups:
            raise ValueError(f"n_chains={n_chains} not divisible by the mesh "
                             f"chain axis ({self.groups})")
        n = n_chains // self.groups
        return slice(self.index * n, (self.index + 1) * n)


def multihost_mesh(rx: int = 1, rt: int = 1) -> ChainMesh:
    """The multi-process mesh (process_count / (rx rt), rx, rt): by default
    the chain axis across processes and the lattice whole on each
    process's one device (the JAX package tiles a process's local devices
    with the lattice axes, ``choose_mesh_shape``; a process here drives one
    device, so that tiling is 1 x 1); with rx rt > 1 a lattice mesh of one
    shard a process, ranks chain-major. Every process must call it, with
    the same shape: it creates the process groups of every plane."""
    world, rank = process_count(), process_index()
    n = rx * rt
    if n < 1 or world % n:
        raise ValueError(f"mesh {rx}x{rt} does not divide {world} processes")
    _state["plane"] = n
    lattice = _dist_lattice_mesh(rx, rt) if n > 1 else None
    return ChainMesh((world // n, rx, rt), rank // n, lattice)


def _dist_lattice_mesh(rx: int, rt: int):
    """This process's DistLatticeMesh, after creating every plane's process
    groups (the plane, its x rings, its t rings) in the same order on every
    process, as torch.distributed requires; on NCCL where each process has
    its own card."""
    import torch.distributed as dist

    from schwingermodel_tpu_torch.parallel.mesh import DistLatticeMesh

    world, rank, n = process_count(), process_index(), rx * rt
    nccl = _state["backend"] == "nccl"
    mine = {}
    for base in range(0, world, n):
        spans = [(("x", "t"), [base + k for k in range(n)])]
        if rx > 1:
            spans += [(("x",), [base + i * rt + j for i in range(rx)])
                      for j in range(rt)]
        if rt > 1:
            spans += [(("t",), [base + i * rt + j for j in range(rt)])
                      for i in range(rx)]
        for key, ranks in spans:
            group = dist.new_group(ranks, backend="nccl" if nccl else None)
            if rank in ranks:
                mine[key] = group
    base, k = divmod(rank, n)
    return DistLatticeMesh((rx, rt), divmod(k, rt),
                           tuple(base * n + q for q in range(n)), mine,
                           nccl=nccl, p2p=_state["nccl"])


def gather_chains(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A per-chain tensor of this process's chains along ``dim`` -> the
    global one, every chain group's chains in global (rank) order, as a CPU
    tensor on every process (one process: a CPU copy); of a lattice mesh's
    plane, whose processes hold the same values, its first process's. A
    0-d tensor becomes one entry a chain group."""
    src = (x.reshape(1) if x.ndim == 0 else x).detach()
    dist = _dist()
    if dist is None:
        return src.cpu()
    wire = (src.to(torch.uint8) if src.dtype == torch.bool else src).contiguous()
    group = _state["nccl"] if _state["nccl"] is not None and src.is_cuda else None
    if group is None:
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p.cpu().to(src.dtype) for p in parts[::_state["plane"]]],
                     dim=dim)


def gather_global(x) -> np.ndarray:
    """Every process's chains (the leading axis) as one NumPy array on
    every process, for I/O on the primary (the reference's MPI_Gatherv,
    gauge_conf.cpp:378-395)."""
    return gather_chains(torch.as_tensor(x)).numpy()


def broadcast_scalar(value: float) -> float:
    """The primary's value of a host scalar on every process (reference:
    the Metropolis draw is made on rank 0 and broadcast, hmc.cpp:166-169)."""
    dist = _dist()
    if dist is None:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.broadcast(t, src=0)
    return float(t[0])


def describe() -> Tuple[int, int, int]:
    """(process_index, process_count, local_device_count) for banners."""
    return process_index(), process_count(), torch.cuda.device_count()


def shares_devices() -> bool:
    """True where the processes share cards (or a host's CPU): fewer
    distinct devices than processes, which is not a multi-GPU run."""
    return _state["devices"] < process_count()


def layout() -> str:
    """The banner's layout, "N processes on M device(s) (backend)": M counts
    the distinct cards (or hosts' CPUs) the processes run on."""
    n, m = process_count(), _state["devices"]
    return (f"{n} process{'es' if n > 1 else ''} on {m} "
            f"device{'s' if m > 1 else ''} ({_state['backend'] or 'none'})")
