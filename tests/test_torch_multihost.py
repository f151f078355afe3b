"""The port's multi-process support (parallel/multihost.py) in one process,
against the JAX package's (the counterparts of tests/test_multihost.py):
the no-cluster detection that never starts torch.distributed by accident,
the single-process semantics every code path relies on, and the mesh
factorization. Two real processes: tests/test_torch_multiprocess.py.
"""

import numpy as np
import pytest
import torch

from schwingermodel_tpu.parallel import mesh as jmesh
from schwingermodel_tpu_torch.parallel import mesh, multihost

CLUSTER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID",
                "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "LOCAL_RANK")


@pytest.mark.parametrize("env", [
    {},
    {"SLURM_JOB_ID": "1234"},                     # a single-task SLURM job
    {"SLURM_JOB_ID": "1234", "SLURM_NTASKS": "1"},
    {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
     "MASTER_PORT": "1"},                          # torchrun with one process
    {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "0"},  # no rendezvous
], ids=["none", "slurm-job-id", "slurm-one-task", "torchrun-one", "ompi-no-address"])
def test_maybe_initialize_noop_without_cluster(monkeypatch, env):
    """No multi-process launch: False, and torch.distributed stays down."""
    import torch.distributed as dist

    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, v in env.items():
        monkeypatch.setenv(var, v)
    assert multihost.maybe_initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.process_count() == 1


def test_maybe_initialize_wants_all_three_flags():
    with pytest.raises(ValueError, match="go together"):
        multihost.maybe_initialize("localhost:1", None, 0, device="cpu")


def test_is_primary_single_process():
    assert multihost.is_primary() is True
    assert multihost.process_index() == 0


@pytest.mark.parametrize("Nx,Nt", [(8, 8), (16, 8), (6, 10), (12, 16), (64, 64),
                                   (7, 8)])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_choose_mesh_shape_matches_jax(n, Nx, Nt):
    """The same factorization as JAX's, and the same error where none
    divides the lattice."""
    try:
        want = jmesh.choose_mesh_shape(n, Nx, Nt)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.choose_mesh_shape(n, Nx, Nt)
        assert str(got.value) == str(e)
        return
    assert mesh.choose_mesh_shape(n, Nx, Nt) == want


def test_multihost_mesh_single_process_layout():
    """One process: one chain group, the lattice whole, every chain ours."""
    m = multihost.multihost_mesh()
    assert m.shape == (1, 1, 1) and m.index == 0 and m.groups == 1
    assert m.local_chains(4) == slice(0, 4)
    # process 1 of 2 holds the second half; an odd count is refused
    two = multihost.ChainMesh((2, 1, 1), 1)
    assert two.local_chains(4) == slice(2, 4)
    with pytest.raises(ValueError):
        two.local_chains(3)


def test_gather_global_identity_single_process():
    x = torch.arange(12.0).reshape(3, 4)
    out = multihost.gather_global(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(12.0).reshape(3, 4))
    # per-chain statistics along another axis, bools and scalars
    g = multihost.gather_chains(torch.tensor([[True, False]]), dim=1)
    assert g.dtype == torch.bool and g.tolist() == [[True, False]]
    assert multihost.gather_chains(torch.tensor(2.5)).tolist() == [2.5]


def test_broadcast_scalar_single_process():
    assert multihost.broadcast_scalar(0.125) == 0.125


def test_describe():
    pi, pc, ld = multihost.describe()
    assert (pi, pc) == (0, 1)
    assert ld == torch.cuda.device_count()
    assert multihost.local_device("cpu") == torch.device("cpu")
