"""Every branch of the port's packed trajectory against the JAX package on
the same noise, and the CLI options that reach them.

- Loose contract (leapfrog and Omelyan, one pseudofermion and Hasenbusch)
  against ``hmc/packed.trajectory_packed_given_noise`` with its Pallas
  kernels in interpret mode (tests/test_pallas_traj.py's ``_model32``
  setup).
- Refined contract, Hasenbusch and Omelyan, against the unpacked sampler
  ``trajectory_given_noise`` with the x64 refinement.

Same-noise gates of test_pallas_traj.py: |ddH| <= 5e-3, equal accept
decisions, theta' to atol 2e-4. The port's H terms are f64 under both
contracts; the JAX loose path sums them in f32.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc import packed as jhp
from schwingermodel_tpu.hmc.sampler import draw_noise, trajectory_given_noise
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu.utils import prng
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel as TorchModel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden",
                      "2D_U1_8x8_m00.10000000000000001_SimData.txt")
C, NX, NT = 2, 8, 8


def _noise(model, seed=7):
    keys = jax.vmap(lambda i: prng.trajectory_key(prng.root_key(seed), i))(
        jnp.arange(C))
    return jax.vmap(lambda k: draw_noise(model, (2, NX, NT), k))(keys)


def _port(model, theta, pi, chi, r):
    lat, hmc, _ = from_jax_config(model.lattice, model.hmc)
    tmodel = TorchModel(lattice=lat, hmc=hmc)
    th, st = hp.trajectory_packed_given_noise(
        tmodel, torch.from_numpy(theta), torch.from_numpy(np.array(pi)),
        torch.from_numpy(np.array(chi)), torch.from_numpy(np.array(r)))
    return th.numpy(), st


def _assert_same_trajectory(th_ref, st_ref, th_got, st):
    assert bool(st.cg_converged.all())
    assert bool(np.all(np.asarray(st_ref.cg_converged)))
    assert st.delta_H.dtype == torch.float64
    np.testing.assert_allclose(st.delta_H.numpy(), np.asarray(st_ref.delta_H),
                               rtol=0, atol=5e-3)
    np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(st_ref.accepted))
    np.testing.assert_allclose(th_got, np.asarray(th_ref), rtol=0, atol=2e-4)
    assert (st.cg_iters.numpy() > 0).all()


@pytest.mark.parametrize("hasenbusch", [False, True], ids=["single", "hasenbusch"])
@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
def test_loose_trajectory_matches_jax_packed(rng, integrator, hasenbusch):
    """The loose contract (K1 with its CG, K2, K5) against the JAX packed
    trajectory in interpret mode, same noise."""
    m0, dm, md = (-0.19, 0.4, 4) if hasenbusch else (0.1, None, 6)
    model = SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=m0, even_odd=True, md_steps=md,
                      trajectory_length=0.6, integrator=integrator,
                      packed=True, hasenbusch_dm=dm,
                      cg=CGParams(tol=1e-6, max_iter=2000)))
    theta = rng.uniform(-np.pi, np.pi, (C, 2, NX, NT)).astype(np.float32)
    pi, chi, r = _noise(model)
    th0 = jhp.pack_theta(model, jnp.asarray(theta))
    piE, piO = pt.pack_chains(model.geom, pi)
    th1, st_ref = jhp.trajectory_packed_given_noise(model, th0, piE, piO, chi, r)
    th_ref = jhp.unpack_theta(model, th1, C)

    th_got, st = _port(model, theta, pi, chi, r)
    _assert_same_trajectory(th_ref, st_ref, th_got, st)


@pytest.mark.parametrize("integrator,dm,m0,md", [
    ("leapfrog", 0.4, -0.19, 8),
    ("omelyan", None, 0.1, 5),
], ids=["hasenbusch-leapfrog", "omelyan"])
def test_refined_trajectory_matches_jax_sampler(rng, integrator, dm, m0, md):
    """The refined contract (K3 + K4, K1 without its CG, K5) with the
    Hasenbusch split or the Omelyan integrator against the JAX unpacked
    sampler with the x64 refinement, same noise (the fixture of
    test_torch_trajectory.py)."""
    model = SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=m0, even_odd=True, md_steps=md,
                      trajectory_length=1.0, integrator=integrator,
                      hasenbusch_dm=dm,
                      cg=CGParams(tol=1e-10, max_iter=10000, refine=True,
                                  refine_impl="x64", inner_tol=1e-5)))
    theta = rng.uniform(-np.pi, np.pi, (C, 2, NX, NT)).astype(np.float32)
    pi, chi, r = _noise(model, seed=11)
    th_ref, st_ref = jax.vmap(
        lambda t, p, c, u: trajectory_given_noise(model, t, p, c, u))(
        jnp.asarray(theta), pi, chi, r)

    th_got, st = _port(model, theta, pi, chi, r)
    _assert_same_trajectory(th_ref, st_ref, th_got, st)


# ---------- the CLI ----------

def _cli(tmp_path, *argv, params="1\n1\n0.1\n4\n0.4\n2\n2\n3\n0\n0\n"):
    return subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu_torch", "--device", "cpu",
         "--nx", "8", "--nt", "8", "--out-dir", str(tmp_path), *argv],
        input=params, cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def _layout(path):
    """Comment lines, and the widths of the value lines, after the date and
    host."""
    with open(path) as f:
        lines = f.read().split("\n")
    return [ln if ln.startswith("#") else len(ln) for ln in lines[4:]]


def test_cli_loose_contract_writes_reference_simdata(tmp_path):
    """--no-cg-refine: the loose f32 contract at the JAX CLI's default
    tol 1e-6; the force tolerance equals it, so the SimData file has no
    split-contract block and matches the reference layout line for line."""
    out = _cli(tmp_path, "--no-cg-refine",
               params="1\n1\n0.1\n10\n1.0\n2\n5\n5\n0\n0\n")
    assert out.returncode == 0, out.stderr
    assert "Acceptance rate:" in out.stdout
    assert "CG tolerance = 1e-06" in out.stdout
    assert "WARNING" not in out.stdout
    sim = tmp_path / os.path.basename(GOLDEN)
    assert _layout(sim) == _layout(GOLDEN)
    assert "#CG force tolerance" not in sim.read_text()


@pytest.mark.parametrize("argv", [
    ["--hasenbusch-dm", "0.4"],
    ["--integrator", "omelyan"],
    ["--mre-history", "4", "--no-cg-forecast"],
    ["--mre-history", "4", "--hasenbusch-dm", "0.4"],
], ids=["hasenbusch", "omelyan", "mre-without-forecast", "mre-with-hasenbusch"])
def test_cli_runs_the_ported_options(tmp_path, argv):
    """The options of this slice run to the end; --mre-history is ignored
    where the JAX package ignores it (no forecast, or Hasenbusch)."""
    out = _cli(tmp_path, *argv)
    assert out.returncode == 0, out.stderr
    assert "Acceptance rate:" in out.stdout
    assert "all solves converged: True" in out.stdout
    if "--hasenbusch-dm" in argv:
        assert "Hasenbusch split: auxiliary mass m1 = 0.5" in out.stdout


def test_cli_refuses_mre_where_jax_uses_it(tmp_path):
    """--mre-history 4 on the packed refined path, where the JAX package
    uses MRE, used to exit 2 ("not yet ported"); it runs now: exit 0, every
    solve converged (K3 starts each solve from the MRE forecast)."""
    out = _cli(tmp_path, "--mre-history", "4")
    assert out.returncode == 0, out.stderr
    assert "Acceptance rate:" in out.stdout
    assert "all solves converged: True" in out.stdout
    assert "WARNING" not in out.stdout


@pytest.mark.parametrize("refine,forecast,dm,uses", [
    (True, True, None, True),
    (True, False, None, False),
    (False, True, None, False),
    (True, True, 0.4, False),
])
def test_packed_supported_refuses_mre_only_where_jax_uses_it(refine, forecast,
                                                             dm, uses):
    """hmc/packed.py:219: use_mre = refined and forecast and K >= 2 and not
    Hasenbusch; elsewhere mre_history is ignored. The packed trajectory runs
    every case (MRE is ported: the first case, which it used to refuse)."""
    lat, hmc, _ = from_jax_config(
        LatticeParams(Nx=8, Nt=8),
        HMCParams(even_odd=True, mre_history=4, cg_forecast=forecast,
                  hasenbusch_dm=dm, cg=CGParams(refine=refine)))
    model = TorchModel(lattice=lat, hmc=hmc)
    hp.packed_supported(model)
    assert hp.uses_mre(model) == uses
