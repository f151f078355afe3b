"""Step-size autotuning and the beta scan of the PyTorch port against the
JAX package's.

``da_update`` is held against JAX's on the same sequence of acceptances
(JAX keeps the state in f32, the port in host floats: rtol 1e-5);
``finalize`` is exact; the warm-up lands the pooled acceptance in the band
of tests/test_tuning_scan.py (0.7 +- 0.12 on the quenched 8x8 model);
``exact_quenched_plaquette`` against scipy's Bessel functions; a quenched
scan inside its I1/I0 gate (4 max(dEp, 0.004), as there); the runner's
warm-up end to end on the packed path and on the unpacked sampler.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from schwingermodel_tpu.config import HMCParams as JaxHMCParams
from schwingermodel_tpu.hmc import autotune as jat
from schwingermodel_tpu.scan import exact_quenched_plaquette as jax_exact
from schwingermodel_tpu.tools.betascan import parse_betas as jax_parse_betas
from schwingermodel_tpu_torch.config import (
    CGParams, HMCParams, LatticeParams, RunParams,
)
from schwingermodel_tpu_torch.hmc import autotune as at
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.runner import hot_start, run_hmc
from schwingermodel_tpu_torch.scan import exact_quenched_plaquette, run_beta_scan
from schwingermodel_tpu_torch.tools import betascan

torch.set_num_threads(1)


def test_da_update_matches_jax(rng):
    probs = rng.uniform(0.0, 1.0, 40)
    js, ps = jat.da_init(0.1), at.da_init(0.1)
    for p in probs:
        js = jat.da_update(js, jnp.float32(p), target=0.65)
        ps = at.da_update(ps, float(p), target=0.65)
        np.testing.assert_allclose(
            [ps.log_eps, ps.log_eps_bar, ps.h_bar, ps.t, ps.mu],
            [float(v) for v in js], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
@pytest.mark.parametrize("eps", [0.052, 2.0, 1e-9, 0.3])
def test_finalize_matches_jax_exactly(integrator, eps):
    kw = dict(beta=2.0, m0=0.1, md_steps=10, trajectory_length=1.0,
              integrator=integrator)
    got = at.finalize(HMCParams(**kw), eps)
    want = jat.finalize(JaxHMCParams(**kw), eps)
    assert got.md_steps == want.md_steps
    assert got.trajectory_length == want.trajectory_length == 1.0
    assert at.finalize(HMCParams(**kw), eps, max_md_steps=7).md_steps == \
        jat.finalize(JaxHMCParams(**kw), eps, max_md_steps=7).md_steps


def test_dual_averaging_converges_to_target():
    """On the quenched 8x8 model a 150-trajectory warm-up lands the pooled
    acceptance probability near the target."""
    model = SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=8, real_dtype="float64"),
        hmc=HMCParams(beta=2.0, m0=0.1, md_steps=8, trajectory_length=1.0,
                      quenched=True))
    theta = hot_start(model.lattice, 11, 4, "cpu")
    res = at.tune_step_size(model, theta, 11, n_tune=150, target=0.7)
    assert 0.0 < res.eps < 1.0
    th, ps = res.theta, []
    for i in range(30):
        th, st = sampler.hmc_trajectory(model, th, 11, 1000 + i, dt=res.eps)
        ps.append(float(torch.clamp(st.exp_mdH, max=1.0).mean()))
    assert abs(np.mean(ps) - 0.7) < 0.12, f"acceptance {np.mean(ps)} far from 0.7"


@pytest.mark.parametrize("beta", [0.5, 1.0, 2.0, 4.0, 50.0, 700.0])
def test_exact_quenched_plaquette_matches_scipy_and_jax(beta):
    want = scipy.special.i1e(beta) / scipy.special.i0e(beta)
    got = exact_quenched_plaquette(beta)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    np.testing.assert_allclose(float(got), float(jax_exact(beta)), rtol=1e-12)


def test_beta_scan_quenched_matches_exact():
    """A 3-point quenched scan on 8x8 agrees with I1/I0 within errors."""
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
    hmc = HMCParams(beta=1.0, m0=0.1, md_steps=12, trajectory_length=1.0,
                    quenched=True)
    msgs = []
    res = run_beta_scan(lat, hmc, [1.0, 2.0, 4.0], n_therm=150, n_meas=150,
                        n_chains=2, seed=2, device="cpu", progress=msgs.append)
    assert res.exact is not None and res.all_converged and len(msgs) == 3
    assert res.plaquette_chains.shape == (3, 150, 2)
    for i, b in enumerate(res.betas):
        tol = 4 * max(res.dEp[i], 0.004)
        assert abs(res.Ep[i] - res.exact[i]) < tol, (
            f"beta={b}: Ep={res.Ep[i]:.5f} exact={res.exact[i]:.5f} "
            f"dEp={res.dEp[i]:.1e}")
    assert (res.acceptance > 0.5).all()
    assert "exact(I1/I0)" in res.as_table()


def test_beta_scan_two_flavor_runs_and_the_tool_prints_its_table(tmp_path, capsys):
    """The dynamical scan through the tool's main: fermions raise <P> above
    the quenched value, and the CSV has the table's columns."""
    csv = tmp_path / "scan.csv"
    rc = betascan.main(["--device", "cpu", "--nx", "8", "--nt", "8", "--betas", "2,3",
                        "--m0", "0.1", "--md-steps", "8", "--ntherm", "15",
                        "--nmeas", "20", "--seed", "3", "--csv", str(csv)])
    assert rc == 0
    table = capsys.readouterr().out.strip().splitlines()
    assert table[0].startswith("# beta") and len(table) == 3
    rows = np.loadtxt(csv, delimiter=",", skiprows=1)
    assert rows.shape == (2, 4)
    assert rows[0, 1] > float(exact_quenched_plaquette(2.0)) - 0.05
    assert rows[1, 1] > rows[0, 1]                      # <P> grows with beta


@pytest.mark.parametrize("spec", ["0.5:10:0.5", "1,2,4.5", "2:2:1", "0.1:0.35:0.05"])
def test_parse_betas_matches_jax(spec):
    np.testing.assert_array_equal(betascan.parse_betas(spec), jax_parse_betas(spec))


def test_parse_betas_refuses_a_bad_range():
    with pytest.raises(ValueError):
        betascan.parse_betas("1:2")


@pytest.mark.parametrize("path", ["packed", "sampler"])
def test_runner_autotune_end_to_end(tmp_path, path):
    """The warm-up with JAX's bookkeeping: n_tune = min(n_tune, n_therm)
    trajectories come off the thermalization, the log line, the model
    rebuilt with the tuned md_steps; on the packed path (even-odd f32, whose
    kernels take the step size on the host side only) and on the unpacked
    sampler (quenched, f64)."""
    if path == "packed":
        lat = LatticeParams(Nx=8, Nt=8, real_dtype="float32")
        hmc = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=1.0,
                        even_odd=True, cg=CGParams(tol=1e-6, max_iter=2000))
        run = RunParams(n_therm=12, n_meas=6, n_chains=2, seed=5,
                        out_dir=str(tmp_path), autotune=True, n_tune=10)
    else:
        lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
        hmc = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=1.0,
                        quenched=True)
        run = RunParams(n_therm=80, n_meas=30, n_chains=2, seed=5,
                        out_dir=str(tmp_path), autotune=True, n_tune=60)
    msgs = []
    result = run_hmc(lat, hmc, run, device="cpu", progress=msgs.append)
    assert sum("autotune" in m for m in msgs) == 1
    therm = [m for m in msgs if "thermalization configurations" in m]
    assert therm[-1].startswith(f"{run.n_therm - run.n_tune} ")
    assert result.tuned_eps is not None and 0.0 < result.tuned_eps < 1.0
    assert result.hmc.md_steps == at.finalize(hmc, result.tuned_eps).md_steps
    assert result.hmc.md_steps != hmc.md_steps          # dt 0.25 is far too coarse
    assert result.traj_index == run.n_therm - run.n_tune + run.n_meas
    assert result.all_converged
    if path == "sampler":
        # quenched 8x8 beta=2: <P> = I1(2)/I0(2)
        assert abs(result.Ep - 0.69777) < 5 * max(result.dEp, 0.01)
        assert 0.4 < result.acceptance_rate <= 1.0
        assert result.cg_iters_total == 0
    else:
        assert 0.0 < result.Ep < 1.0 and result.cg_iters_total > 0


def test_autotune_hands_dt_to_the_step_it_is_given():
    """tune_step_size calls traj_fn(theta, seed, index, dt) with the
    exploring step exp(log_eps) of the dual-averaging state."""
    model = SchwingerModel(lattice=LatticeParams(Nx=4, Nt=4),
                           hmc=HMCParams(md_steps=4, trajectory_length=0.4))
    seen = []

    def traj_fn(theta, seed, i, dt):
        seen.append((i, dt))
        st = sampler.TrajectoryStats(*(torch.ones(2),) * 2, torch.tensor([0.5, 2.0]),
                                     *(torch.ones(2),) * 2)
        return theta, st

    res = at.tune_step_size(model, torch.zeros((2, 2, 4, 4)), 0, n_tune=3,
                            target=0.7, traj_fn=traj_fn)
    assert [i for i, _ in seen] == [at.TUNE_STREAM + k for k in range(3)]
    assert seen[0][1] == pytest.approx(0.1)
    da = at.da_update(at.da_init(0.1), 0.75, target=0.7)     # pooled min(1, .)
    assert seen[1][1] == pytest.approx(math.exp(da.log_eps))
    assert res.accept_prob_last == pytest.approx(0.75)
