"""Chain-parallel runs of the port across processes (parallel/multihost.py):
two gloo processes on the CPU at 8x8, C=4, md 4, against one process
holding all four chains, and each process's chains against the JAX packed
trajectory on the same noise (the counterparts of
tests/test_multiprocess.py:62-91, which run there only as `slow`).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc import packed as jhp
from schwingermodel_tpu.hmc.sampler import trajectory_given_noise
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel as TorchModel
from schwingermodel_tpu_torch.parallel import sharded
from schwingermodel_tpu_torch.parallel.multihost import ChainMesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
FLAGS = ["--device", "cpu", "--nx", "8", "--nt", "8", "--m0", "0.1",
         "--md-steps", "4", "--tau", "0.5", "--beta", "2", "--ntherm", "2",
         "--nmeas", "4", "--nsteps", "1", "--ranks-x", "1", "--ranks-t", "1",
         "--seed", "5"]
# the lines every run prints that carry its results
RESULTS = ("Average plaquette", "Average gauge action", "Acceptance rate",
           "<exp(-dH)>", "Chiral condensate", "autotune:")
# the step-size warm-up (its acceptance pooled over every process's chains)
# and the condensate (its noise drawn per global chain)
TUNED = ["--autotune", "--n-tune", "2", "--condensate", "--n-noise", "2"]
C, NX, NT = 4, 8, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argvs, timeout=120):
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
    return [sys.executable, "-m", "schwingermodel_tpu_torch", *args]


def _two(port, *extra):
    """The CLI in two processes, started by the three multi-host flags."""
    return [_cli(*FLAGS, "--coordinator", f"localhost:{port}",
                 "--num-processes", "2", "--process-id", str(i), *extra)
            for i in range(2)]


def _ok(outs):
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} (rc={rc}):\n{out[-2000:]}\n{err[-3000:]}"


def _results(out):
    return [line for line in out.splitlines() if line.startswith(RESULTS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """At once: one process with C=4, two processes with C=4 (2 chains
    each) started by the multi-host flags, and two started by torchrun with
    --chains 3, each writing a checkpoint; then at once: the first two
    resumed from their checkpoints for 2 more measurements, one and two
    processes with the warm-up and the condensate (TUNED), and the
    runs of test_cli_refuses_chain_layouts_it_cannot_run: its refusals and
    a 2x1 lattice mesh in two processes and in one."""
    one, two, trun, tune1, tune2, mesh1, mesh2 = (tmp_path_factory.mktemp(n) for n in (
        "one", "two", "trun", "tune1", "tune2", "mesh1", "mesh2"))
    outs = _launch(
        [_cli(*FLAGS, "--chains", "4", "--out-dir", str(one),
              "--checkpoint", str(one / "ck.npz"))]
        + _two(_free_port(), "--chains", "4", "--out-dir", str(two),
               "--checkpoint", str(two / "ck.npz"))
        + [[sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "schwingermodel_tpu_torch", *FLAGS,
            "--chains", "3", "--out-dir", str(trun),
            "--checkpoint", str(trun / "ck.npz")]])
    _ok(outs)
    port = _free_port()
    later = _launch(
        [_cli("--device", "cpu", "--resume", str(one / "ck.npz"),
              "--nmeas", "2", "--out-dir", str(one),
              "--checkpoint", str(one / "ck2.npz"))]
        + [_cli("--device", "cpu", "--resume", str(two / "ck.npz"),
                "--nmeas", "2", "--out-dir", str(two),
                "--checkpoint", str(two / "ck2.npz"),
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2", "--process-id", str(i))
           for i in range(2)]
        + [_cli(*FLAGS, *TUNED, "--chains", "4", "--out-dir", str(tune1),
                "--checkpoint", str(tune1 / "ck.npz"))]
        + _two(_free_port(), *TUNED, "--chains", "4", "--out-dir", str(tune2),
               "--checkpoint", str(tune2 / "ck.npz"))
        + [_cli(*FLAGS, "--ranks-chain", "2")]
        + _two(_free_port(), "--chains", "3", "--ranks-chain", "2")
        + _two(_free_port(), "--ranks-x", "2", "--ranks-t", "1", "--chains", "2",
               "--out-dir", str(mesh2), "--checkpoint", str(mesh2 / "ck.npz"))
        + [_cli(*FLAGS, "--ranks-x", "2", "--ranks-t", "1", "--chains", "2",
                "--out-dir", str(mesh1), "--checkpoint", str(mesh1 / "ck.npz"))])
    _ok(later[:6])
    return {"one": one, "two": two, "trun": trun, "outs2": outs[1:3],
            "torchrun": outs[3], "res1": later[:1], "res2": later[1:3],
            "tune1": tune1, "tune2": tune2, "tuned": later[3:6],
            "refused": later[6:], "mesh": (mesh1, mesh2)}


def test_cli_two_processes_end_to_end_and_resume(runs):
    """Two processes run the CLI: one chain group each, one SimData and one
    checkpoint (written by process 0), the results printed by process 0
    only, each process's device and device programs on its own stderr
    line; both resume from the checkpoint."""
    two = runs["two"]
    assert len(list(two.glob("*SimData*"))) == 1
    assert sorted(p.name for p in two.glob("*.npz")) == ["ck.npz", "ck2.npz"]
    (rc0, out0, err0), (rc1, out1, err1) = runs["outs2"]
    assert "* Chain groups = 2 processes on 1 device (gloo)" in out0
    assert out0.count("Average plaquette value") == 1
    assert out1 == ""
    assert "process 0 of 2 on cpu: graphs {'graph': {'captures': 0, 'replays': 0" in err0
    assert "process 1 of 2 on cpu: graphs {'graph': {'captures': 0, 'replays': 0" in err1
    (_, rout0, _), (_, rout1, _) = runs["res2"]
    assert rout0.count("Average plaquette value") == 1 and rout1 == ""
    assert "all solves converged: True" in rout0


def test_two_processes_equal_one_process_bit_for_bit(runs):
    """Every chain's theta, the observables' chains in the checkpoint, the
    printed averages and the SimData results of two processes equal one
    process's with the same four chains, bit for bit, before and after the
    resume."""
    one, two = runs["one"], runs["two"]
    for name in ("ck.npz", "ck2.npz"):
        a, b = np.load(one / name), np.load(two / name)
        assert a["theta"].shape == (C, 2, NX, NT)
        np.testing.assert_array_equal(a["theta"], b["theta"])
        for k in a.files:
            if k.startswith("chain_"):
                np.testing.assert_array_equal(a[k], b[k])
    (_, o1, _), = runs["res1"]
    (_, o2, _), _ = runs["res2"]
    assert _results(o1) == _results(o2) and len(_results(o1)) == 4
    # the SimData files but for the values under "#Date and time" and
    # "#Execution time"
    keep = []
    for d in (one, two):
        lines = next(d.glob("*SimData*")).read_text().splitlines()
        keep.append([line for i, line in enumerate(lines)
                     if i == 0 or "time" not in lines[i - 1].lower()])
    assert keep[0] == keep[1] and len(keep[0]) > 20


def test_two_processes_tune_and_measure_the_condensate_as_one(runs):
    """With the step-size warm-up and the condensate: the warm-up pools the
    acceptance over both processes' chains in global order, so both tune
    the one-process step (the same autotune line, the same md_steps, and
    every later trajectory's bits); the condensate's noise is drawn per
    global chain. Every chain's theta and observables (the condensate's
    included) and every printed result equal one process's bit for bit."""
    (_, o1, _), (_, o2, _), (_, o3, _) = runs["tuned"]
    assert o3 == ""
    got, want = _results(o2), _results(o1)
    assert got == want and len(want) == 6
    assert want[0].startswith("autotune: eps=")
    a, b = np.load(runs["tune1"] / "ck.npz"), np.load(runs["tune2"] / "ck.npz")
    assert "chain_chiral_condensate" in a.files
    for k in a.files:
        if k != "meta_json":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the parameters as run (md_steps as tuned), but for the output folder
    meta = [json.loads(bytes(z["meta_json"]).decode()) for z in (a, b)]
    for m in meta:
        m["run"].pop("out_dir")
    assert meta[0] == meta[1]


def test_torchrun_rounds_chains_up_and_matches(runs):
    """torchrun's environment starts the same run: --chains 3 in two
    processes rounds up to 4 with a note, and the run equals the one
    process with four chains bit for bit."""
    _, out, _ = runs["torchrun"]
    assert "note: --chains 3 rounded up to 4 (chain mesh axis = 2)" in out
    np.testing.assert_array_equal(np.load(runs["trun"] / "ck.npz")["theta"],
                                  np.load(runs["one"] / "ck.npz")["theta"])
    assert out.count("Average plaquette value") == 1
    assert len(list(runs["trun"].glob("*SimData*"))) == 1


def test_cli_refuses_chain_layouts_it_cannot_run(runs):
    """--ranks-chain 2 in one process exits 1 naming both sizes; in two
    processes --chains 3 --ranks-chain 2 exits 1. A 2x1 lattice mesh in two
    processes, which exited 2 before the lattice mesh across processes was
    ported, runs one shard a process and equals the one-process mesh: every
    chain's theta and the printed results bit for bit."""
    outs = runs["refused"]
    assert outs[0][0] == 1
    assert "error: --ranks-chain 2 needs 2 processes, have 1" in outs[0][2]
    for rc, _, err in outs[1:3]:
        assert rc == 1 and "--chains 3 not divisible by --ranks-chain 2" in err
    _ok(outs[3:6])
    (_, o2, _), (_, o2b, _), (_, o1, _) = outs[3:6]
    assert "* Device mesh = 2x1 shards, one a process: 2 processes" in o2
    assert o2b == "" and "all solves converged: True" in o2
    assert _results(o2) == _results(o1) and len(_results(o1)) == 4
    mesh1, mesh2 = runs["mesh"]
    np.testing.assert_array_equal(np.load(mesh1 / "ck.npz")["theta"],
                                  np.load(mesh2 / "ck.npz")["theta"])


def _jax_model(refine: bool):
    return SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=0.1, even_odd=True, md_steps=2,
                      trajectory_length=0.5, packed=True,
                      cg=(CGParams(tol=1e-10, max_iter=2000, refine=True,
                                   refine_impl="x64", inner_tol=1e-5)
                          if refine else CGParams(tol=1e-6, max_iter=2000))))


@pytest.mark.parametrize("refine", [False, True], ids=["loose", "refined"])
def test_chain_group_trajectory_matches_jax(refine):
    """Each process's chain group (group p of 2: chains 2p, 2p+1) after one
    trajectory from given NumPy noise equals JAX's trajectory of those
    chains of the whole batch: the packed trajectory
    (hmc/packed.trajectory_packed_given_noise, Pallas in interpret mode)
    under the loose contract; under the refined one the x64 refined
    sampler (JAX's refined packed path runs its double-float kernels only
    on the TPU). The ROADMAP's f32 gates: dH to 5e-3, equal accept
    decisions, theta' to 2e-4. The group's drawn noise is that of its
    global chains: its step equals its slice of the one-group step bit for
    bit."""
    rng = np.random.default_rng(12)
    model = _jax_model(refine)
    theta = rng.uniform(-np.pi, np.pi, (C, 2, NX, NT)).astype(np.float32)
    pi = rng.standard_normal((C, 2, NX, NT)).astype(np.float32)
    chi = ((rng.standard_normal((C, 2, NX, NT // 2))
            + 1j * rng.standard_normal((C, 2, NX, NT // 2))) / np.sqrt(2)
           ).astype(np.complex64)
    r = rng.uniform(0.0, 1.0, C).astype(np.float32)
    @jax.jit
    def reference(theta, pi, chi, r):
        if refine:
            return jax.vmap(lambda t, p, c, u: trajectory_given_noise(
                model, t, p, c, u))(theta, pi, chi, r)
        piE, piO = pt.pack_chains(model.geom, pi)
        th1, st = jhp.trajectory_packed_given_noise(
            model, jhp.pack_theta(model, theta), piE, piO, chi, r)
        return jhp.unpack_theta(model, th1, C), st

    th_ref, st_ref = reference(*(jnp.asarray(a) for a in (theta, pi, chi, r)))
    th_ref = np.asarray(th_ref)

    lat, hmc, _ = from_jax_config(model.lattice, model.hmc)
    tmodel = TorchModel(lattice=lat, hmc=hmc)
    whole = hp.hmc_trajectory_packed(tmodel, torch.from_numpy(theta), 9, 3)[0]
    for p in range(2):
        mesh = ChainMesh((2, 1, 1), p)
        step = sharded.make_chain_sharded_packed_traj_fn(tmodel, mesh)
        mine = mesh.local_chains(C)
        th, st = step.given_noise(*(torch.from_numpy(a[mine])
                                    for a in (theta, pi, chi, r)))
        assert bool(st.cg_converged.all())
        np.testing.assert_allclose(st.delta_H.numpy(),
                                   np.asarray(st_ref.delta_H)[mine],
                                   rtol=0, atol=5e-3)
        np.testing.assert_array_equal(st.accepted.numpy(),
                                      np.asarray(st_ref.accepted)[mine])
        d = np.remainder(th.numpy() - th_ref[mine] + np.pi, 2 * np.pi) - np.pi
        assert np.abs(d).max() <= 2e-4
        drawn, _ = step(torch.from_numpy(theta[mine]), 9, 3)
        assert torch.equal(drawn, whole[mine])


def test_chain_packed_supported_follows_jax():
    """A chain-only mesh on the packed path; not a lattice-sharded one, not
    a model off the packed path (JAX ``chain_packed_supported``)."""
    jm = _jax_model(True)
    lat, hmc, _ = from_jax_config(jm.lattice, jm.hmc)
    tmodel = TorchModel(lattice=lat, hmc=hmc)
    assert sharded.chain_packed_supported(tmodel, ChainMesh((2, 1, 1), 0))
    assert not sharded.chain_packed_supported(tmodel, ChainMesh((2, 2, 1), 0))
    lat64, _, _ = from_jax_config(
        LatticeParams(Nx=NX, Nt=NT, real_dtype="float64"), jm.hmc)
    f64 = TorchModel(lattice=lat64, hmc=hmc)
    assert not sharded.chain_packed_supported(f64, ChainMesh((2, 1, 1), 0))
    with pytest.raises(ValueError):
        sharded.make_chain_sharded_packed_traj_fn(f64, ChainMesh((2, 1, 1), 0))
    assert ChainMesh((2, 1, 1), 1).local_chains(4) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ChainMesh((2, 1, 1), 1).local_chains(3)
