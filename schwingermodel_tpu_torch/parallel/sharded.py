"""The HMC trajectory on a mesh of lattice shards.

Counterpart of ``schwingermodel_tpu/parallel/sharded.py`` (running the
reference under ``mpirun -n ranks_x*ranks_t``): the trajectory of
hmc/sampler.py runs with a ``ShardedGeometry``, so every shift exchanges a
halo through the mesh's ``ppermute`` and every global reduction is a
``psum`` (parallel/mesh.py); with blocks that take the wide halo the solves
and the force run the per-shard kernels K7 and K8 (ops/halo.py).

Determinism: the noise (pi, chi) and the Metropolis uniform are drawn on
the global lattice outside the mesh and then sharded, so a sharded and an
unsharded run consume identical fields.

Chains are a batch axis: C chains over rx * rt shards each. Where the JAX
package needs a ('chain', 'x', 't') mesh and ORs the CG's stop over the
chain groups, here every solver decision reads only that chain's
psum-reduced state.

Across processes (parallel/multihost.py) the chains are cut into groups,
one a process, each with the lattice whole on its device:
``make_chain_sharded_packed_traj_fn`` runs a group's chains through the
packed main path (K1, K3 with K4 inside its launch) with no collective,
each chain on the noise of its global index. On a lattice mesh across
processes (a ``DistLatticeMesh``, one shard a process) each chain group is
cut over its plane's processes: ``make_sharded_traj_fn`` with that mesh
runs the same step on this process's shard, the global configuration of
the group on every process of the plane before and after it (its blocks
gathered on the plane after each trajectory), so the measurements are the
one-process mesh's.
"""

from __future__ import annotations

import dataclasses

from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.hmc.program import packed_step
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops.geometry import ShardedGeometry
from schwingermodel_tpu_torch.parallel.multihost import ChainMesh
from schwingermodel_tpu_torch.parallel.mesh import T_AXIS_NAME, shard, unshard


def sharded_model(model: SchwingerModel, mesh) -> SchwingerModel:
    """The same model with the mesh's ppermute/psum geometry."""
    return dataclasses.replace(model, geom=ShardedGeometry(mesh))


def make_sharded_traj_fn(model: SchwingerModel, mesh, chain_group: int = 0):
    """The sharded HMC step ``step(theta, seed, traj_index, dt=None,
    beta=None) -> (theta', stats)`` on the global theta [C, 2, Nx, Nt]; the
    noise is that of the unsharded paths (``sampler.draw_chain_noise``), of
    the chains chain_group x C .. (a chain group of several).
    ``step.given_noise(theta, pi, chi, r, dt=None, beta=None)`` is the same
    update on pre-drawn global noise. Every mode of the sampler runs here;
    under Hasenbusch the heavy and the ratio solves go through K7's sharded
    CG and the forces through the plain geometry. mesh: a LatticeMesh (every
    shard here) or a DistLatticeMesh (this process's shard; theta and the
    noise are the group's global fields on every process of its plane, and
    so is theta')."""
    rx, rt = mesh.shape
    lat = model.lattice
    if lat.Nx % rx or lat.Nt % rt:
        raise ValueError(f"lattice {lat.Nx}x{lat.Nt} not divisible by mesh "
                         f"{rx}x{rt}")
    if model.hmc.even_odd and (lat.Nt // rt) % 2:
        raise ValueError(
            f"even-odd mode needs an even local Nt per shard; Nt={lat.Nt} "
            f"over {mesh.axis_size(T_AXIS_NAME)} t-shards gives {lat.Nt // rt}")
    inner = sharded_model(model, mesh)

    def given_noise(theta, pi, chi, r, dt=None, beta=None):
        theta_s, st = sampler.trajectory_given_noise(
            inner, shard(theta, mesh), shard(pi, mesh), shard(chi, mesh),
            r.reshape(-1, 1, 1), dt, beta)
        return unshard(theta_s, mesh), st

    def step(theta, seed: int, traj_index, dt=None, beta=None):
        C = theta.shape[0]
        pi, chi, r = sampler.draw_chain_noise(model, seed, traj_index, C,
                                              theta.device, chain_group * C)
        return given_noise(theta, pi, chi, r, dt, beta)

    step.given_noise = given_noise
    return step


def chain_packed_supported(model: SchwingerModel, mesh) -> bool:
    """True where the packed trajectory runs a chain group of this mesh (JAX
    ``chain_packed_supported``): a chain-only layout (both lattice axes 1,
    the multi-process default) and a model on the packed path."""
    return (isinstance(mesh, ChainMesh) and tuple(mesh.shape[1:]) == (1, 1)
            and hp.packed_eligible(model))


def make_chain_sharded_packed_traj_fn(model: SchwingerModel, mesh: ChainMesh):
    """The packed trajectory (hmc/packed.py) of this process's chain group
    (JAX ``make_chain_sharded_packed_traj_fn``, where ``shard_map`` hands
    each device group its chains): ``step(theta, seed, traj_index, dt=None)
    -> (theta', stats)`` on the group's theta [C/R, 2, Nx, Nt], each chain on
    the noise of its global index (group index x C/R + c), with no
    collective; the stats are the group's, [C/R]. ``step.given_noise(theta,
    pi, chi, r, dt=None)`` is the same update on pre-drawn noise of the
    group's chains."""
    if not chain_packed_supported(model, mesh):
        raise ValueError(f"the packed trajectory does not run this model on "
                         f"mesh {mesh}")
    hp.packed_supported(model)

    step = packed_step(model, group=mesh.index)

    def given_noise(theta, pi, chi, r, dt=None):
        return hp.trajectory_packed_given_noise(model, theta, pi, chi, r, dt)

    step.given_noise = given_noise
    return step
