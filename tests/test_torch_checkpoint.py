"""Checkpoint and resume of the PyTorch port, against the JAX package's
files, and the CLI options that run the unpacked sampler, the warm-up and the mesh.

The ``.npz`` layout is JAX's: a checkpoint written by either package loads
in the other (theta, configuration, chains, trajectory counter; the
threefry key of a JAX file is kept as an opaque array, the port's streams
start from ``run.seed``). The port's noise is a function of (seed,
trajectory, chain), so a resumed run equals the unbroken one bit for bit on
the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from schwingermodel_tpu import config as jconfig
from schwingermodel_tpu.io import checkpoint as jck
from schwingermodel_tpu.utils import prng as jprng
from schwingermodel_tpu_torch.config import (
    CGParams, HMCParams, LatticeParams, RunParams, from_jax_config,
)
from schwingermodel_tpu_torch.io import checkpoint as ck
from schwingermodel_tpu_torch.runner import run_hmc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(tmp_path, **hmc_kw):
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float32")
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=0.4,
                    even_odd=True, cg=CGParams(tol=1e-6, max_iter=2000, cert_k=77),
                    **hmc_kw)
    run = RunParams(n_therm=2, n_meas=6, n_chains=2, seed=9, out_dir=str(tmp_path),
                    mesh_shape=(1, 1))
    return lat, hmc, run


def test_round_trip(tmp_path, rng):
    lat, hmc, run = _params(tmp_path, hasenbusch_dm=0.3)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, 8, 8)).astype(np.float32)
    path = str(tmp_path / "state.ckpt")
    ck.save_checkpoint(path, theta=theta, key=ck.seed_key(run.seed), traj_index=17,
                       lattice=lat, hmc=hmc, run=run,
                       chains={"plaquette": [0.5, 0.6]}, extra={"note": "x"})
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    got = ck.load_checkpoint(path)
    np.testing.assert_array_equal(got["theta"], theta)
    assert got["theta"].dtype == np.float32
    np.testing.assert_array_equal(got["key"], [0, 9])
    assert got["traj_index"] == 17
    assert (got["lattice"], got["hmc"], got["run"]) == (lat, hmc, run)
    assert got["hmc"].cg.cert_k == 77 and got["run"].mesh_shape == (1, 1)
    np.testing.assert_array_equal(got["chains"]["plaquette"], [0.5, 0.6])
    assert got["extra"]["note"] == "x"
    assert ck.FORMAT_VERSION == jck.FORMAT_VERSION


def test_seed_key_is_the_threefry_root_of_the_seed():
    for seed in (0, 9, 2 ** 31 + 5):
        np.testing.assert_array_equal(ck.seed_key(seed), _jax_key(seed))


def _jax_key(seed):
    import jax

    k = jprng.root_key(seed)
    try:
        return np.asarray(jax.random.key_data(k))
    except TypeError:
        return np.asarray(k)


def test_jax_written_checkpoint_loads(tmp_path, rng):
    jlat = jconfig.LatticeParams(Nx=8, Nt=8, real_dtype="float32")
    jhmc = jconfig.HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=0.4,
                             even_odd=True, quenched=False,
                             cg=jconfig.CGParams(tol=1e-6, refine_impl="x64"))
    jrun = jconfig.RunParams(n_therm=2, n_meas=3, n_chains=2, seed=4,
                             mesh_shape=(1, 1, 1), autotune=True, n_tune=7)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, 8, 8)).astype(np.float32)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, theta=theta, key=_jax_key(4), traj_index=5,
                        lattice=jlat, hmc=jhmc, run=jrun,
                        chains={"plaquette": np.arange(3.0)})
    got = ck.load_checkpoint(path)
    want = from_jax_config(jlat, jhmc, jrun)
    assert (got["lattice"], got["hmc"], got["run"]) == want
    assert got["run"].autotune and got["run"].n_tune == 7       # carried by name
    assert not hasattr(got["hmc"].cg, "refine_impl")
    np.testing.assert_array_equal(got["theta"], theta)
    assert got["traj_index"] == 5 and got["key"].shape == (2,)
    # the port continues from it
    res = run_hmc(got["lattice"], got["hmc"],
                  dataclasses.replace(got["run"], n_therm=0, n_meas=2, autotune=False,
                                      mesh_shape=None, out_dir=str(tmp_path)),
                  device="cpu", initial_theta=got["theta"],
                  start_traj_index=got["traj_index"])
    assert res.traj_index == 7 and res.all_converged


def test_port_written_checkpoint_loads_in_jax(tmp_path, rng):
    lat, hmc, run = _params(tmp_path)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, 8, 8)).astype(np.float32)
    path = str(tmp_path / "port.npz")
    ck.save_checkpoint(path, theta=theta, key=ck.seed_key(run.seed), traj_index=11,
                       lattice=lat, hmc=hmc, run=run, chains={"plaquette": [0.1]})
    got = jck.load_checkpoint(path)
    np.testing.assert_array_equal(got["theta"], theta)
    assert got["traj_index"] == 11
    assert got["hmc"].md_steps == 4 and got["hmc"].even_odd and got["hmc"].cg.tol == 1e-6
    assert got["lattice"].Nx == 8 and got["run"].seed == 9
    assert from_jax_config(got["lattice"], got["hmc"], got["run"]) == (
        lat, dataclasses.replace(hmc, cg=dataclasses.replace(hmc.cg, cert_k=192)), run)


def test_from_jax_config_carries_every_shared_field():
    jlat = jconfig.LatticeParams(Nx=7, Nt=8, real_dtype="float64")
    jhmc = jconfig.HMCParams(quenched=True, even_odd=False, hasenbusch_dm=0.2,
                             integrator="omelyan", mre_history=3)
    jrun = jconfig.RunParams(autotune=True, tune_target=0.8, n_tune=13,
                             mesh_shape=(2, 2))
    lat, hmc, run = from_jax_config(jlat, jhmc, jrun)
    assert lat.real_dtype == "float64" and lat.cdtype == torch.complex128
    assert hmc.quenched and not hmc.even_odd and hmc.hasenbusch_dm == 0.2
    assert (run.autotune, run.tune_target, run.n_tune) == (True, 0.8, 13)
    for ours, theirs in ((lat, jlat), (hmc, jhmc), (run, jrun)):
        for f in dataclasses.fields(ours):
            if hasattr(theirs, f.name) and f.name != "cg":
                assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("mode", ["packed", "quenched", "mesh"])
def test_resumed_run_equals_the_unbroken_one(tmp_path, mode):
    """2 + 6 trajectories in one run against 2 + 2, a checkpoint, and 4 more
    from it: the final configuration and the plaquette chain are equal bit
    for bit."""
    lat, hmc, run = _params(tmp_path, quenched=(mode == "quenched"))
    if mode == "mesh":
        lat = dataclasses.replace(lat, Nx=16, Nt=16)
        run = dataclasses.replace(run, mesh_shape=(2, 2))
    whole = run_hmc(lat, hmc, run, device="cpu")
    first = run_hmc(lat, hmc, dataclasses.replace(run, n_meas=2), device="cpu")
    path = str(tmp_path / "mid.npz")
    ck.save_checkpoint(path, theta=first.theta, key=first.key,
                       traj_index=first.traj_index, lattice=lat, hmc=first.hmc,
                       run=run)
    state = ck.load_checkpoint(path)
    assert state["traj_index"] == 4
    rest = run_hmc(state["lattice"], state["hmc"],
                   dataclasses.replace(state["run"], n_therm=0, n_meas=4),
                   device="cpu", initial_theta=state["theta"],
                   start_traj_index=state["traj_index"])
    assert rest.traj_index == whole.traj_index == 8
    np.testing.assert_array_equal(rest.theta, whole.theta)
    np.testing.assert_array_equal(rest.chains["plaquette"],
                                  whole.chains["plaquette"][2:])
    np.testing.assert_array_equal(first.chains["plaquette"],
                                  whole.chains["plaquette"][:2])


def _cli(*argv, stdin=""):
    return subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu_torch", "--device", "cpu", *argv],
        input=stdin, cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


FLAGS = ["--nx", "8", "--nt", "8", "--m0", "0.1", "--md-steps", "4", "--tau", "0.4",
         "--beta", "2", "--ntherm", "2", "--nmeas", "2", "--nsteps", "0",
         "--ranks-x", "1", "--ranks-t", "1"]


def test_cli_checkpoint_then_resume(tmp_path):
    """--checkpoint writes the state, --resume --nmeas continues it with no
    thermalization; the two halves equal the unbroken run."""
    path = str(tmp_path / "run.ckpt")
    out = _cli(*FLAGS, "--out-dir", str(tmp_path), "--checkpoint", path)
    assert out.returncode == 0, out.stderr
    assert f"Checkpoint written to {path}" in out.stdout
    state = ck.load_checkpoint(path)
    assert state["traj_index"] == 4 and state["chains"]["plaquette"].shape == (2,)
    path2 = str(tmp_path / "run2.ckpt")
    out = _cli("--resume", path, "--nmeas", "3", "--out-dir", str(tmp_path),
               "--checkpoint", path2)
    assert out.returncode == 0, out.stderr
    assert "* Thermalization confs = 0" in out.stdout
    assert "* Measurement confs = 3" in out.stdout
    assert "all solves converged: True" in out.stdout
    resumed = ck.load_checkpoint(path2)
    assert resumed["traj_index"] == 7
    path3 = str(tmp_path / "whole.ckpt")
    flags = [f if f != "2" or FLAGS[i - 1] != "--nmeas" else "5"
             for i, f in enumerate(FLAGS)]
    out = _cli(*flags, "--out-dir", str(tmp_path), "--checkpoint", path3)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(ck.load_checkpoint(path3)["theta"], resumed["theta"])


@pytest.mark.parametrize("argv,shows", [
    (["--autotune", "--n-tune", "2", "--tune-target", "0.8"], "autotune: eps="),
    (["--quenched", "--autotune", "--n-tune", "2"], "autotune: eps="),
    (["--hasenbusch-dm", "0.4", "--no-even-odd"], "Hasenbusch split"),
    (["--hasenbusch-dm", "0.4", "--dtype", "float64"], "Hasenbusch split"),
    (["--no-even-odd", "--condensate", "--n-noise", "2"], "Chiral condensate:"),
    (["--dtype", "float64", "--condensate", "--n-noise", "2"], "Chiral condensate:"),
    (["--quenched", "--integrator", "omelyan", "--chains", "2"], "(quenched)"),
    (["--dtype", "float64", "--mre-history", "4"], "dtype = float64"),
])
def test_cli_runs_the_sampler_options(tmp_path, argv, shows):
    """Exit 0, every solve converged, a SimData file; f64 runs with the
    refinement off at tol 1e-10, and MRE is ignored off the packed path."""
    out = _cli(*FLAGS, "--out-dir", str(tmp_path), *argv)
    assert out.returncode == 0, out.stderr
    assert shows in out.stdout
    assert "all solves converged: True" in out.stdout
    assert "WARNING" not in out.stdout
    assert list(tmp_path.glob("*SimData*"))
    if "float64" in argv:
        assert "CG tolerance = 1e-10 (f64 CG)" in out.stdout


@pytest.mark.parametrize("argv", [
    # chain groups of a lattice mesh: one process a shard, so 8 processes
    ["--ranks-chain", "2", "--ranks-x", "2", "--ranks-t", "2"],
    ["--mre-history", "2"]])
def test_cli_still_refuses(tmp_path, argv):
    """Both used to exit 2 ("not yet ported"). A lattice mesh with chain
    groups now runs one shard a process, so in one process it exits 1
    naming the processes it needs; --mre-history 2 runs on the packed
    refined path."""
    out = _cli(*FLAGS, "--out-dir", str(tmp_path), *argv)
    if "--ranks-chain" in argv:
        assert out.returncode == 1
        assert "error: mesh 2x2x2 needs 8 processes, have 1" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert "all solves converged: True" in out.stdout
        assert list(tmp_path.glob("*SimData*"))
