"""The PyTorch port's main path end to end: one refined trajectory against
the JAX sampler on the same noise, the package's independence from jax,
and the CLI's reference-style run with its SimData file.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc.sampler import draw_noise, trajectory_given_noise
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.utils import prng
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel as TorchModel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden",
                      "2D_U1_8x8_m00.10000000000000001_SimData.txt")


@pytest.fixture(scope="module")
def same_noise_pair():
    """One trajectory of C=2 chains through the JAX refined sampler
    (f32, refine x64, even-odd: the setup of
    test_refine.py::test_refined_trajectory_dH_matches_f64, at
    trajectory length 1) and through the port, on the same JAX-drawn noise.
    Run once per module: the JAX reference takes most of the time."""
    rng = np.random.default_rng(2024)
    C, Nx, Nt = 2, 8, 8
    lattice = LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32")
    hmc = HMCParams(beta=2.0, m0=0.1, even_odd=True, md_steps=10,
                    trajectory_length=1.0,
                    cg=CGParams(tol=1e-10, max_iter=10000, refine=True,
                                refine_impl="x64", inner_tol=1e-5))
    model = SchwingerModel(lattice=lattice, hmc=hmc)
    theta = rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt)).astype(np.float32)
    keys = jax.vmap(lambda i: prng.trajectory_key(prng.root_key(7), i))(
        jnp.arange(C))
    pi, chi, r = jax.vmap(lambda k: draw_noise(model, (2, Nx, Nt), k))(keys)
    th_ref, st_ref = jax.vmap(
        lambda t, p, c, u: trajectory_given_noise(model, t, p, c, u))(
        jnp.asarray(theta), pi, chi, r)

    lat_t, hmc_t, _ = from_jax_config(lattice, hmc)
    tmodel = TorchModel(lattice=lat_t, hmc=hmc_t)
    th_got, st_got = hp.trajectory_packed_given_noise(
        tmodel, torch.from_numpy(theta), torch.from_numpy(np.array(pi)),
        torch.from_numpy(np.array(chi)), torch.from_numpy(np.array(r)))
    return (np.asarray(th_ref), st_ref), (th_got.numpy(), st_got)


def test_trajectory_matches_jax_refined_sampler(same_noise_pair):
    """The packed-vs-standard gates of test_pallas_traj.py: dH to atol
    5e-3, equal accept decisions, theta' to atol 2e-4."""
    (th_ref, st_ref), (th_got, st) = same_noise_pair
    assert bool(st.cg_converged.all())
    assert bool(np.all(np.asarray(st_ref.cg_converged)))
    assert st.delta_H.dtype == torch.float64
    np.testing.assert_allclose(st.delta_H.numpy(), np.asarray(st_ref.delta_H),
                               rtol=0, atol=5e-3)
    np.testing.assert_array_equal(st.accepted.numpy(),
                                  np.asarray(st_ref.accepted))
    np.testing.assert_allclose(th_got, th_ref, rtol=0, atol=2e-4)


def test_trajectory_stats_are_consistent(same_noise_pair):
    _, (th_got, st) = same_noise_pair
    assert th_got.dtype == np.float32
    assert np.abs(th_got).max() <= np.pi + 1e-6
    np.testing.assert_allclose(st.exp_mdH.numpy(), np.exp(-st.delta_H.numpy()))
    assert (st.cg_iters.numpy() > 0).all()


def test_unported_configurations_are_refused():
    """The packed trajectory refuses what is off its path (the runner sends
    those to the unpacked sampler), and nothing else is unported on one
    device but MRE forecasting."""
    lat, hmc, _ = from_jax_config(
        LatticeParams(Nx=8, Nt=8),
        HMCParams(even_odd=True, quenched=True, cg=CGParams(refine=True)))
    model = TorchModel(lattice=lat, hmc=hmc)
    assert hmc.quenched and not hp.packed_eligible(model)
    with pytest.raises(NotImplementedError, match="quenched"):
        hp.packed_supported(model)
    on_path = TorchModel(lattice=lat, hmc=dataclasses.replace(hmc, quenched=False))
    assert hp.packed_eligible(on_path)
    hp.packed_supported(on_path)
    assert not hp.packed_eligible(TorchModel(lattice=lat, hmc=dataclasses.replace(
        hmc, quenched=False, packed=False)))


def test_package_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    neither jax nor the JAX package (``__main__`` runs the CLI when it is
    imported; it imports only ``cli``)."""
    code = ("import sys, importlib, pkgutil\n"
            "import schwingermodel_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')\n"
            "         if not m.name.endswith('.__main__')]\n"
            "for m in names:\n"
            "    importlib.import_module(m)\n"
            "for m in ('tools.crossvalidate', 'tools.critical_mass', 'tools.bench_refined_solve',"
            " 'tools.bench_force_solve', 'cli', 'ops._cuda', 'parallel.sharded'):\n"
            "    assert 'schwingermodel_tpu_torch.' + m in names, m\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k.startswith('schwingermodel_tpu.') or k == 'schwingermodel_tpu'"
            " for k in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _simdata_layout(path):
    """Comment lines, and the column widths of the value lines."""
    with open(path) as f:
        lines = f.read().split("\n")
    keep = []
    skip = False
    for ln in lines:
        if ln.startswith("#CG force tolerance"):
            skip = True                 # the split-contract block, optional
            continue
        if skip:
            skip = False
            continue
        keep.append(ln)
    return [ln if ln.startswith("#") else len(ln) for ln in keep[4:]]


def test_cli_runs_reference_pipe_on_cpu(tmp_path):
    """`python -m schwingermodel_tpu_torch --device cpu` with the ten
    parameters piped as in examples/run.sh: 5 thermalization and 5
    measurement trajectories, and a SimData file laid out like the
    reference's."""
    params = "1\n1\n0.1\n10\n1.0\n2\n5\n5\n0\n0\n"
    out = subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu_torch", "--device", "cpu",
         "--nx", "8", "--nt", "8", "--out-dir", str(tmp_path)],
        input=params, cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "Acceptance rate:" in out.stdout
    assert "WARNING" not in out.stdout
    sim = tmp_path / os.path.basename(GOLDEN)
    assert sim.exists()
    got, want = _simdata_layout(sim), _simdata_layout(GOLDEN)
    # same comment lines, and value lines of the same fixed-width columns
    assert got == want
    text = sim.read_text()
    assert "#CG force tolerance (MD solves)" in text


@pytest.mark.parametrize("argv,message", [
    (["--quenched"], "(quenched)"),
    (["--no-even-odd"], "all solves converged: True"),
    (["--dtype", "float64"], "dtype = float64"),
    (["--nx", "7", "--nt", "8"], "Nx = 7, Nt = 8"),
    (["--ranks-chain", "2"], "not yet ported"),
    (["--device", "cuda"], "CUDA is not available"),
    (["--coordinator", "localhost:1234"],
     "error: not yet ported to schwingermodel_tpu_torch: --coordinator "
     "(multi-host)\n"),
    (["--num-processes", "2"],
     "error: not yet ported to schwingermodel_tpu_torch: --num-processes "
     "(multi-host)\n"),
    (["--process-id", "0"],
     "error: not yet ported to schwingermodel_tpu_torch: --process-id "
     "(multi-host)\n"),
    (["--cg-refine-impl", "x64"],
     "error: dropped in schwingermodel_tpu_torch: --cg-refine-impl (native "
     "float64 replaces the double-float pairs)\n"),
    (["--platform", "cpu"],
     "error: dropped in schwingermodel_tpu_torch: --platform (use --device "
     "{cuda,cpu})\n"),
    (["--num-cpu-devices", "8"],
     "error: dropped in schwingermodel_tpu_torch: --num-cpu-devices "
     "(--ranks-x/--ranks-t put all shards on the one device)\n"),
    (["--profile", "trace"], "Profiler trace written to"),
])
def test_cli_refuses_what_it_cannot_run(argv, message, tmp_path):
    """What the CLI refuses and what it no longer does: --ranks-chain 2
    (multi-GPU) and the multi-host flags exit 2 with "not yet ported"; the
    three flags of the JAX parser that the port drops exit 2 and name what
    replaces them (exact messages); --device cuda without a card
    exits non-zero instead of falling back to the CPU; --profile DIR runs
    and leaves a trace file in DIR; --quenched,
    --no-even-odd, --dtype float64 and an odd lattice, which used to be
    refused, run the unpacked sampler to the end (exit 0, every solve
    converged, a SimData file)."""
    args = [] if "--device" in argv else ["--device", "cpu"]
    size = [] if "--nx" in argv else ["--nx", "8", "--nt", "8"]
    if argv[0] == "--profile":
        argv = ["--profile", str(tmp_path / argv[1])]
    out = subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu_torch", *args, *size, *argv,
         "--out-dir", str(tmp_path)],
        input="1\n1\n0.1\n4\n0.4\n2\n2\n2\n0\n0\n", cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    if message == "not yet ported":
        assert out.returncode == 2 and message in out.stderr
    elif message.startswith("error: "):
        assert out.returncode == 2 and out.stderr == message
        assert out.stdout == ""
    elif message == "CUDA is not available":
        assert out.returncode != 0
        if not torch.cuda.is_available():
            assert message in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert message in out.stdout
        assert "all solves converged: True" in out.stdout
        assert "WARNING" not in out.stdout
        assert list(tmp_path.glob("*SimData*"))
    if argv[0] == "--profile":
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_ctxt_matches_jax_and_reference_bytes(tmp_path):
    """The port's .ctxt reader parses the reference's binary and text files
    as the JAX package does, and its writer reproduces the reference's
    bytes; the file names are the reference's."""
    from schwingermodel_tpu.io import ctxt as jctxt
    from schwingermodel_tpu_torch.io import ctxt

    golden = os.path.join(REPO, "tests", "golden")
    for i in range(3):
        name = ctxt.conf_filename(8, 8, 2.0, 0.1, i)
        assert name == jctxt.conf_filename(8, 8, 2.0, 0.1, i)
        path = os.path.join(golden, name)
        U = ctxt.read_conf(path, 8, 8)
        np.testing.assert_array_equal(U, jctxt.read_conf(path, 8, 8))
        out = tmp_path / name
        ctxt.write_conf(str(out), U)
        assert out.read_bytes() == open(path, "rb").read()
    text = os.path.join(golden, "golden_text_0.txt")
    np.testing.assert_array_equal(
        ctxt.read_conf(text, 8, 8),
        ctxt.read_conf(os.path.join(golden, ctxt.conf_filename(8, 8, 2.0, 0.1, 0)), 8, 8))
    assert (ctxt.ill_conf_filename(64, 64, 4.0, -0.2, 3)
            == jctxt.ill_conf_filename(64, 64, 4.0, -0.2, 3))


def test_statistics_match_jax(rng):
    """The jackknife helpers the runner's summary uses give the JAX
    package's numbers."""
    from schwingermodel_tpu.utils import statistics as jstats
    from schwingermodel_tpu_torch.utils import statistics as stats

    x = rng.standard_normal(200).cumsum() * 0.01 + 0.5
    assert stats.mean(x) == jstats.mean(x)
    for n_bins in (2, 20):
        assert stats.jackknife_error(x, n_bins) == jstats.jackknife_error(x, n_bins)
    assert stats.autocorrelation_time(x) == jstats.autocorrelation_time(x)


def test_runner_dumps_configuration_before_failed_solve(tmp_path):
    """A starved solver fails every solve: the runner reports it, and dumps
    per chain the pre-trajectory configuration of the first failure, which
    for the first trajectory is the hot start itself."""
    from schwingermodel_tpu_torch import config
    from schwingermodel_tpu_torch.io import ctxt
    from schwingermodel_tpu_torch.runner import hot_start, run_hmc

    lat = config.LatticeParams(Nx=8, Nt=8)
    hmc = config.HMCParams(beta=2.0, m0=0.1, md_steps=3, trajectory_length=0.3,
                           even_odd=True,
                           cg=config.CGParams(max_iter=3, refine=True))
    run = config.RunParams(n_therm=1, n_meas=2, n_chains=2, seed=5,
                           out_dir=str(tmp_path))
    res = run_hmc(lat, hmc, run, device="cpu")
    assert not res.all_converged
    assert res.n_ill == 4          # one per chain, thermalization and measurement
    first = [r for r in res.ill_records if r["traj_index"] == 0]
    assert sorted(r["chain"] for r in first) == [0, 1]
    start = hot_start(lat, 5, 2, "cpu").double().numpy()
    for r in first:
        U = ctxt.read_conf(str(tmp_path / r["file"]), 8, 8)
        np.testing.assert_allclose(U, ctxt.links_from_theta(start[r["chain"]]),
                                   rtol=0, atol=1e-15)
