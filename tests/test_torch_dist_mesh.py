"""The lattice mesh across processes (parallel/mesh.DistLatticeMesh): one
shard a process, the halos and the psums through torch.distributed (gloo on
the CPU), against the one-process mesh that holds every shard and against
JAX's ``make_sharded_step``.

- The CLI in 4 gloo processes against the CLI in one process with the same
  mesh, at 16x16: 2x2 under the refined contract with ``--condensate``,
  2x2 under the loose one, and 2 chain groups of 2x1 (``--ranks-chain 2``)
  with the Hasenbusch split. Every chain's theta and observables in the
  checkpoint, the printed results and the SimData files are equal bit for
  bit: the psum adds the shards' partials in mesh order in both meshes.
- One trajectory of the sharded step in 4 processes (a small script run by
  each) against the one-process mesh's on the same noise, bit for bit, and
  against JAX's ``make_sharded_step`` on 4 virtual CPU devices at the f32
  gates (dH 5e-3, theta' 2e-4, the same decision).
- A mesh that does not match the number of processes exits 1 naming both.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams as JaxCG
from schwingermodel_tpu.config import HMCParams as JaxHMC
from schwingermodel_tpu.config import LatticeParams as JaxLattice
from schwingermodel_tpu.hmc import sampler as jsampler
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.parallel.mesh import lattice_mesh as jax_lattice_mesh
from schwingermodel_tpu.parallel.sharded import make_sharded_step as jax_sharded_step
from schwingermodel_tpu.utils import prng as jprng
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.parallel import multihost
from schwingermodel_tpu_torch.parallel.mesh import LatticeMesh, lattice_mesh
from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
FLAGS = ["--device", "cpu", "--nx", "16", "--nt", "16", "--m0", "0.1",
         "--md-steps", "4", "--tau", "0.5", "--beta", "2", "--ntherm", "1",
         "--nmeas", "3", "--nsteps", "0", "--seed", "3"]
RESULTS = ("Average plaquette", "Average gauge action", "Acceptance rate",
           "<exp(-dH)>", "Chiral condensate")
# name: (flags of both runs, chain groups of the 4-process run)
RUNS = {
    "2x2-refined-condensate": (["--ranks-x", "2", "--ranks-t", "2", "--chains", "2",
                                "--condensate", "--n-noise", "2"], 1),
    "2x2-loose": (["--ranks-x", "2", "--ranks-t", "2", "--chains", "2",
                   "--no-cg-refine"], 1),
    "2x(2x1)-hasenbusch": (["--ranks-x", "2", "--ranks-t", "1", "--chains", "4",
                            "--hasenbusch-dm", "0.4"], 2),
}
NX = NT = 16
C = 2
# the one trajectory of the sharded step (tests/test_torch_sharded.py's)
STEP = dict(beta=2.0, m0=0.1, even_odd=True, md_steps=4, trajectory_length=0.2)
# run by each of 4 processes: the sharded step on this process's shard of a
# 2x2 mesh across processes, from given noise, under both contracts
HARNESS = r"""
import json, sys
import numpy as np, torch
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.parallel import multihost
from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn
torch.set_num_threads(1)
port, rank, path, step = sys.argv[1], int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
multihost.maybe_initialize(f"localhost:{port}", 4, rank, device="cpu")
mesh = multihost.multihost_mesh(2, 2)
z = np.load(path)
out = {}
for refine in (False, True):
    model = SchwingerModel(
        lattice=LatticeParams(Nx=16, Nt=16, real_dtype="float32"),
        hmc=HMCParams(**step, cg=CGParams(tol=1e-10 if refine else 1e-6, max_iter=2000,
                                          refine=refine, inner_tol=1e-5)))
    th, st = make_sharded_traj_fn(model, mesh.lattice).given_noise(
        *(torch.from_numpy(z[k]) for k in ("theta", "pi", "chi", "r")))
    out[f"theta_{refine}"] = th.numpy()
    for k in ("delta_H", "accepted", "cg_iters", "cg_converged"):
        out[f"{k}_{refine}"] = getattr(st, k).numpy()
if rank == 0:
    np.savez(path[:-4] + "_out.npz", **out)
multihost.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argvs, timeout=300):
    """Start every process at once; (returncode, stdout, stderr) each."""
    procs = [subprocess.Popen(argv, cwd=REPO, env=ENV, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for argv in argvs]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    return outs


def _cli(*args):
    return [sys.executable, "-m", "schwingermodel_tpu_torch", *FLAGS, *args]


def _four(*args):
    port = _free_port()
    return [_cli(*args, "--coordinator", f"localhost:{port}", "--num-processes", "4",
                 "--process-id", str(i)) for i in range(4)]


def _ok(outs):
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} (rc={rc}):\n{out[-2000:]}\n{err[-3000:]}"


def _results(out):
    return [line for line in out.splitlines() if line.startswith(RESULTS)]


def _jax_model(refine):
    return JaxModel(
        lattice=JaxLattice(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=JaxHMC(**STEP, fused_cg=False,
                   cg=JaxCG(tol=1e-10 if refine else 1e-6, max_iter=2000, refine=refine,
                            refine_impl="x64", inner_tol=1e-5)))


def _port_model(refine):
    return SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(**STEP, cg=CGParams(tol=1e-10 if refine else 1e-6, max_iter=2000,
                                          refine=refine, inner_tol=1e-5)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """At once: each run of RUNS in one process and in 4 (with
    --ranks-chain for 2 chain groups), each writing a checkpoint, the 2x2
    mesh in 2 processes (refused), and the sharded step's script in 4
    processes on JAX-drawn noise."""
    rng = np.random.default_rng(31)
    theta = rng.uniform(-np.pi, np.pi, (C, 2, NX, NT)).astype(np.float32)
    jm = _jax_model(False)
    keys = [jprng.trajectory_key(jprng.root_key(9), c) for c in range(C)]
    draws = [jsampler.draw_noise(jm, theta.shape[1:], k) for k in keys]
    pi, chi, r = (np.stack([np.asarray(d[i]) for d in draws]) for i in range(3))
    step_dir = tmp_path_factory.mktemp("step")
    np.savez(step_dir / "noise.npz", theta=theta, pi=pi, chi=chi, r=r)

    argvs, where = [], {}
    for name, (flags, groups) in RUNS.items():
        one, four = (tmp_path_factory.mktemp(f"{name}-{n}") for n in ("one", "four"))
        where[name] = (one, four)
        argvs.append(_cli(*flags, "--out-dir", str(one), "--checkpoint", str(one / "ck.npz")))
        argvs += _four(*flags, *(["--ranks-chain", "2"] if groups > 1 else []),
                       "--out-dir", str(four), "--checkpoint", str(four / "ck.npz"))
    port = _free_port()
    argvs += [_cli("--ranks-x", "2", "--ranks-t", "2", "--out-dir", str(step_dir),
                   "--coordinator", f"localhost:{port}", "--num-processes", "2",
                   "--process-id", str(i)) for i in range(2)]
    port = _free_port()
    argvs += [[sys.executable, "-c", HARNESS, str(port), str(i),
               str(step_dir / "noise.npz"), json.dumps(STEP)] for i in range(4)]
    outs = _launch(argvs)
    got, k = {}, 0
    for name in RUNS:
        got[name] = {"dirs": where[name], "one": outs[k], "four": outs[k + 1:k + 5]}
        k += 5
    refused, harness = outs[k:k + 2], outs[k + 2:]
    for name in RUNS:
        _ok([got[name]["one"], *got[name]["four"]])
    _ok(harness)
    return {"runs": got, "refused": refused,
            "step": (theta, pi, chi, r, keys, np.load(step_dir / "noise_out.npz"))}


@pytest.mark.parametrize("name", list(RUNS))
def test_four_processes_equal_the_one_process_mesh(runs, name):
    """Every chain's theta and observables (the condensate's included) in
    the checkpoint, the printed results and the SimData files, but for
    their times, of the 4-process run equal the one-process mesh's bit for
    bit; one SimData and one checkpoint, written by process 0, which alone
    prints; SimData's ranks line is the mesh's."""
    r = runs["runs"][name]
    one, four = r["dirs"]
    a, b = np.load(one / "ck.npz"), np.load(four / "ck.npz")
    flags, groups = RUNS[name]
    n_chains = int(flags[flags.index("--chains") + 1])
    assert a["theta"].shape == (n_chains, 2, NX, NT)
    for k in a.files:
        if k != "meta_json":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    (_, o1, _), (_, o4, _) = r["one"], r["four"][0]
    want = _results(o1)
    assert _results(o4) == want and len(want) == 4 + ("--condensate" in flags)
    assert "all solves converged: True" in o4
    assert all(out == "" for _, out, _ in r["four"][1:])
    keep = []
    for d in (one, four):
        assert len(list(d.glob("*SimData*"))) == 1 and len(list(d.glob("*.npz"))) == 1
        lines = next(d.glob("*SimData*")).read_text().splitlines()
        keep.append([line for i, line in enumerate(lines)
                     if i == 0 or "time" not in lines[i - 1].lower()])
    assert keep[0] == keep[1] and len(keep[0]) > 20
    rx, rt = flags[flags.index("--ranks-x") + 1], flags[flags.index("--ranks-t") + 1]
    i = keep[1].index("#ranks_x     #ranks_t     #ranks")
    assert keep[1][i + 1].split() == [rx, rt, str(int(rx) * int(rt))]
    banner = (f"* Device mesh = {rx}x{rt} shards, one a process: 4 processes on 1 "
              f"device (gloo), not multi-GPU")
    assert banner in o4
    assert f"* Chain groups = {groups} (one a plane of {4 // groups} processes)" in o4
    for p, (_, _, err) in enumerate(r["four"]):
        assert f"process {p} of 4 on cpu: graphs {{}}" in err


def test_a_mesh_the_processes_do_not_fill_exits_1(runs):
    """A 2x2 mesh in 2 processes exits 1 naming both counts, in every
    process, before any run."""
    for rc, out, err in runs["refused"]:
        assert rc == 1 and "error: mesh 2x2 needs 4 processes, have 2" in err
        assert "Average plaquette" not in out


@pytest.mark.parametrize("refine", [False, True], ids=["loose", "refined"])
def test_step_across_processes_matches_one_process_and_jax(runs, refine):
    """One trajectory of the sharded step, each of 4 processes on its
    shard, equals the one-process mesh's on the same noise bit for bit (θ',
    dH, decisions, iterations, flags), and every chain meets the f32 gates
    against JAX's make_sharded_step on 4 virtual CPU devices (its plain
    sharded CG, x64 refinement)."""
    theta, pi, chi, r, keys, out = runs["step"]
    th, st = make_sharded_traj_fn(_port_model(refine), lattice_mesh((2, 2))).given_noise(
        *(torch.from_numpy(a) for a in (theta, pi, chi, r)))
    np.testing.assert_array_equal(out[f"theta_{refine}"], th.numpy())
    for k in ("delta_H", "accepted", "cg_iters", "cg_converged"):
        np.testing.assert_array_equal(out[f"{k}_{refine}"], getattr(st, k).numpy(), err_msg=k)
    assert bool(st.cg_converged.all())
    jm = _jax_model(refine)
    step = jax_sharded_step(jm, jax_lattice_mesh((2, 2)))
    for c in range(C):
        jth, jst = step(jnp.asarray(theta[c]), keys[c])
        assert bool(jst.cg_converged)
        np.testing.assert_allclose(out[f"delta_H_{refine}"][c], float(jst.delta_H),
                                   rtol=0, atol=5e-3)
        assert bool(out[f"accepted_{refine}"][c]) == bool(jst.accepted)
        d = np.remainder(out[f"theta_{refine}"][c] - np.asarray(jth) + np.pi,
                         2 * np.pi) - np.pi
        assert np.abs(d).max() <= 2e-4


def test_in_device_psum_adds_the_shards_in_mesh_order():
    """LatticeMesh.psum is the sum of the shards one by one in mesh order
    (row-major over (x, t)), the order DistLatticeMesh.psum adds the
    gathered partials in; over one axis, that axis's shards in order."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn((3, 2, 4, 5), generator=g, dtype=torch.float32) * 1e4
    mesh = LatticeMesh((2, 4))
    want = a[:, 0, 0]
    for k in range(1, 8):
        want = want + a[:, k // 4, k % 4]
    got = mesh.psum(a)
    assert got.shape == (3, 1, 1, 5) and torch.equal(got[:, 0, 0], want)
    along_t = a[:, :, 0] + a[:, :, 1] + a[:, :, 2] + a[:, :, 3]
    assert torch.equal(mesh.psum(a, ("t",))[:, :, 0], along_t)


def test_multihost_mesh_of_one_process():
    """One process: the chain-only mesh; a lattice mesh of 2x2 shards,
    one a process, needs 4 processes."""
    m = multihost.multihost_mesh()
    assert m.shape == (1, 1, 1) and m.index == 0 and m.lattice is None
    with pytest.raises(ValueError, match="2x2 does not divide 1 processes"):
        multihost.multihost_mesh(2, 2)
