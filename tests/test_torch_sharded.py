"""The lattice-sharded trajectory of the PyTorch port: the unpacked even-odd
sampler without a mesh against JAX's on the same noise, the sharded step
against JAX's ``make_sharded_step`` under both solver contracts, the
port's sharded trajectory against its own unsharded one, chains on a mesh,
and the CLI's ``--ranks-x``/``--ranks-t``.

On the CPU the port runs the plain twins of K7 and K8; the JAX side runs
under ``shard_map`` on the 8 virtual CPU devices of tests/conftest.py with
its halo kernels in interpret mode (``fused_cg=True``) and x64 on. The
noise is JAX's ``sampler.draw_noise``, handed to both packages.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc import sampler as jsampler
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.parallel.mesh import lattice_mesh as jax_lattice_mesh
from schwingermodel_tpu.parallel.sharded import make_sharded_step as jax_sharded_step
from schwingermodel_tpu.utils import prng as jprng
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import cg_eo
from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard, unshard
from schwingermodel_tpu_torch.parallel.sharded import (
    make_sharded_traj_fn, sharded_model,
)
from schwingermodel_tpu_torch.runner import run_hmc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_model(Nx, Nt, *, refine, fused, integrator="leapfrog", md_steps=4,
               tau=0.2, forecast=True):
    return JaxModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=0.1, even_odd=True, md_steps=md_steps,
                      trajectory_length=tau, fused_cg=fused,
                      integrator=integrator, cg_forecast=forecast,
                      cg=CGParams(tol=1e-10 if refine else 1e-6, max_iter=2000,
                                  refine=refine, refine_impl="x64",
                                  inner_tol=1e-5)))


def _port(jmodel):
    lat, hmc, _ = from_jax_config(jmodel.lattice, jmodel.hmc)
    assert hmc.fused_cg == jmodel.hmc.fused_cg          # carried by field name
    return SchwingerModel(lattice=lat, hmc=hmc)


def _noise(jmodel, theta, seed):
    """JAX-drawn (pi, chi, r) for every chain of theta [C, 2, Nx, Nt], and
    the keys."""
    keys = [jprng.trajectory_key(jprng.root_key(seed), c)
            for c in range(theta.shape[0])]
    draws = [jsampler.draw_noise(jmodel, theta.shape[1:], k) for k in keys]
    pi, chi, r = (np.stack([np.asarray(d[i]) for d in draws]) for i in range(3))
    return keys, pi, chi, r


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _away_from_threshold(r, dH, margin=2e-2):
    """Chains whose accept decision a dH difference of 5e-3 cannot flip."""
    return np.abs(np.asarray(r) - np.exp(-np.asarray(dH))) > margin


# ---------- without a mesh ----------

@pytest.mark.parametrize("integrator,refine", [("leapfrog", False),
                                               ("omelyan", False),
                                               ("leapfrog", True)])
def test_unpacked_trajectory_matches_jax(rng, integrator, refine):
    """sampler.trajectory_given_noise without a mesh against JAX's on the
    same noise (f32 even-odd, fused_cg=False: the plain single-reduction CG
    in both): dH to atol 5e-3, theta' to atol 2e-4, equal accept decisions,
    CG iterations within 5%."""
    Nx = Nt = 8
    jm = _jax_model(Nx, Nt, refine=refine, fused=False, integrator=integrator)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, Nx, Nt)).astype(np.float32)
    keys, pi, chi, r = _noise(jm, theta, 11)
    model = _port(jm)
    th, st = sampler.trajectory_given_noise(model, *_t(theta, pi, chi, r))
    assert st.delta_H.dtype == torch.float64 and st.delta_H.shape == (2,)
    assert bool(st.cg_converged.all())
    for c in range(2):
        jth, jst = jsampler.trajectory_given_noise(
            jm, jnp.asarray(theta[c]), jnp.asarray(pi[c]), jnp.asarray(chi[c]),
            jnp.asarray(r[c]))
        assert bool(jst.cg_converged)
        print(integrator, refine, "dH port", float(st.delta_H[c]), "jax",
              float(jst.delta_H), "iterations", int(st.cg_iters[c]),
              int(jst.cg_iters))
        np.testing.assert_allclose(float(st.delta_H[c]), float(jst.delta_H),
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(th[c].numpy(), np.asarray(jth), rtol=0, atol=2e-4)
        if _away_from_threshold(r[c], jst.delta_H):
            assert bool(st.accepted[c]) == bool(jst.accepted)
        assert abs(int(st.cg_iters[c]) - int(jst.cg_iters)) <= 0.05 * int(jst.cg_iters)
    assert np.abs(th.numpy()).max() <= np.pi


def test_unpacked_trajectory_matches_packed_path(rng):
    """The unpacked sampler and the packed main path on the same noise: the
    same trajectory (dH to 5e-3, theta' to 2e-4), other iteration counts
    (the forecast is psi_1 here, 2 psi_1 - psi_2 there)."""
    jm = _jax_model(8, 8, refine=True, fused=None, md_steps=6, tau=0.3)
    model = _port(jm)
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, 2, 8, 8)).astype(np.float32))
    pi, chi, r = sampler.draw_chain_noise(model, 3, 0, 2, "cpu")
    th_u, st_u = sampler.trajectory_given_noise(model, theta, pi, chi, r)
    th_p, st_p = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    assert bool(st_u.cg_converged.all()) and bool(st_p.cg_converged.all())
    np.testing.assert_allclose(st_u.delta_H.numpy(), st_p.delta_H.numpy(),
                               rtol=0, atol=5e-3)
    # the packed path folds to [-pi, pi], this one wraps to [-pi, pi)
    d = torch.remainder(th_u - th_p + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) <= 2e-4
    th_h, _ = sampler.hmc_trajectory(model, theta, 3, 0)
    assert torch.equal(th_h, th_u)
    # Hasenbusch runs on this sampler too: the pair axis in front of spin
    hb = dataclasses.replace(model, hmc=dataclasses.replace(
        model.hmc, hasenbusch_dm=0.4))
    _, st_h = sampler.trajectory_given_noise(hb, theta, pi, chi[:, None].expand(
        2, 2, 2, 8, 4), r)
    assert bool(st_h.cg_converged.all()) and bool(torch.isfinite(st_h.delta_H).all())


@pytest.mark.parametrize("refine", [False, True])
def test_unpacked_solves_without_a_mesh_dispatch_to_k6(rng, refine):
    """Without a mesh hmc.fused_cg = True sends the f32 solves of the
    unpacked sampler to K6 (its plain twin on the CPU), as JAX's
    _use_fused_cg sends them to its fused CG (interpret mode here): the
    trajectory agrees with JAX's (dH to 5e-3, theta' to 2e-4) and with the
    plain-CG one; fused_cg = None on CPU tensors keeps the plain CG."""
    Nx = Nt = 8
    jm = _jax_model(Nx, Nt, refine=refine, fused=True)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, Nx, Nt)).astype(np.float32)
    keys, pi, chi, r = _noise(jm, theta, 12)
    model = _port(jm)
    args = _t(theta, pi, chi, r)
    assert model._use_fused_cg(args[2])
    auto = dataclasses.replace(model, hmc=dataclasses.replace(model.hmc, fused_cg=None))
    plain = dataclasses.replace(model, hmc=dataclasses.replace(model.hmc, fused_cg=False))
    assert not auto._use_fused_cg(args[2]) and not plain._use_fused_cg(args[2])
    assert not sharded_model(model, lattice_mesh((2, 2)))._use_fused_cg(args[2])
    calls = []
    twin = cg_eo.cg_solve_eo_reference

    def counting(*a, **k):
        calls.append(a[2].shape)
        return twin(*a, **k)

    cg_eo.cg_solve_eo_reference = counting
    try:
        th, st = sampler.trajectory_given_noise(model, *args)
    finally:
        cg_eo.cg_solve_eo_reference = twin
    assert len(calls) >= model.hmc.md_steps and set(calls) == {(2, 1, 2, 2, Nx, Nt // 2)}
    th_p, st_p = sampler.trajectory_given_noise(plain, *args)
    assert bool(st.cg_converged.all()) and st.cg_iters.shape == (2,)
    np.testing.assert_allclose(st.delta_H.numpy(), st_p.delta_H.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(th.numpy(), th_p.numpy(), rtol=0, atol=2e-4)
    for c in range(2):
        jth, jst = jsampler.trajectory_given_noise(
            jm, jnp.asarray(theta[c]), jnp.asarray(pi[c]), jnp.asarray(chi[c]),
            jnp.asarray(r[c]))
        assert bool(jst.cg_converged)
        np.testing.assert_allclose(float(st.delta_H[c]), float(jst.delta_H),
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(th[c].numpy(), np.asarray(jth), rtol=0, atol=2e-4)
        assert abs(int(st.cg_iters[c]) - int(jst.cg_iters)) <= 0.05 * int(jst.cg_iters) + 1


# ---------- on a mesh, against JAX ----------

@pytest.fixture(scope="module")
def sharded_pairs():
    """One trajectory at 16x16 on a 2x2 mesh (local 8x4 packed: the smallest
    block that takes the fused path) through JAX's make_sharded_step with
    its halo kernels in interpret mode, and through the port's sharded
    step on the same noise, under the loose and the refined contract."""
    rng = np.random.default_rng(77)
    Nx = Nt = 16
    theta = rng.uniform(-np.pi, np.pi, (1, 2, Nx, Nt)).astype(np.float32)
    out = {}
    for refine in (False, True):
        jm = _jax_model(Nx, Nt, refine=refine, fused=True)
        keys, pi, chi, r = _noise(jm, theta, 9)
        jth, jst = jax_sharded_step(jm, jax_lattice_mesh((2, 2)))(
            jnp.asarray(theta[0]), keys[0])
        model = _port(jm)
        step = make_sharded_traj_fn(model, lattice_mesh((2, 2)))
        th, st = step.given_noise(*_t(theta, pi, chi, r))
        out[refine] = (model, theta, pi, chi, r, np.asarray(jth), jst, th, st)
    return out


@pytest.mark.parametrize("refine", [False, True])
def test_sharded_step_matches_jax(sharded_pairs, refine):
    """JAX's own cross-path gate (test_pallas_halo.py:181-184): dH to atol
    5e-3, theta' to atol 5e-3, every solve converged, and an equal accept
    decision away from the threshold."""
    model, theta, pi, chi, r, jth, jst, th, st = sharded_pairs[refine]
    print("refine", refine, "dH port", st.delta_H.tolist(), "jax",
          float(jst.delta_H), "iterations", st.cg_iters.tolist(), int(jst.cg_iters))
    assert bool(st.cg_converged.all()) and bool(jst.cg_converged)
    np.testing.assert_allclose(st.delta_H.numpy(), [float(jst.delta_H)],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(th[0].numpy(), jth, rtol=0, atol=5e-3)
    if _away_from_threshold(r[0], jst.delta_H):
        assert bool(st.accepted[0]) == bool(jst.accepted)
    assert st.cg_iters.dtype == torch.int32 and int(st.cg_iters[0]) > 0


def test_sharded_refined_action_solve_meets_the_contract(sharded_pairs):
    """Under the refined contract on the mesh the action solve's f64 true
    residual, recomputed on the unsharded lattice, is below 1e-10 ||b||, and
    the inner solves are the sharded K7 CG (its twin here)."""
    model, theta, pi, chi, r, *_ = sharded_pairs[True]
    mesh = lattice_mesh((2, 2))
    inner = sharded_model(model, mesh)
    th_s = shard(theta, mesh)
    ops = inner.eo_ops(th_s)
    assert inner._fused_sharded(ops)
    phi = inner.pseudofermion(th_s, shard(chi, mesh))
    res = inner._solve_eo(th_s, ops, phi)
    assert res.x.dtype == torch.complex128 and bool(res.converged.all())
    # the unsharded f64 operator on the gathered solution
    x, b = unshard(res.x, mesh), unshard(phi, mesh).to(torch.complex128)
    resid = b - model.eo_ops(torch.from_numpy(theta), hi=True).normal(x)
    rel = float(resid.abs().pow(2).sum().sqrt() / b.abs().pow(2).sum().sqrt())
    print("refined action solve on the mesh: true residual", rel, "iterations",
          res.iters.flatten().tolist())
    assert rel < 1e-10
    assert float(res.rel_residual.max()) < 1e-10


# ---------- on a mesh, against the port's own unsharded trajectory ----------

@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 2)])
@pytest.mark.parametrize("fused", [None, False])
def test_sharded_trajectory_equals_unsharded(rng, mesh_shape, fused):
    """The port's sharded trajectory against its unsharded one in f32 on
    the same noise, loose contract: with fused_cg=False (the same plain CG
    on the wide-halo composite) theta' agrees to 2e-5 and dH to 1e-4; with
    the halo twins dH to 5e-3, theta' to 2e-4. Iterations within 2."""
    jm = _jax_model(16, 16, refine=False, fused=fused, md_steps=3, tau=0.15)
    model = _port(jm)
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, 2, 16, 16)).astype(np.float32))
    pi, chi, r = sampler.draw_chain_noise(model, 5, 0, 2, "cpu")
    th_u, st_u = sampler.trajectory_given_noise(model, theta, pi, chi, r)
    th_s, st_s = make_sharded_traj_fn(model, lattice_mesh(mesh_shape)).given_noise(
        theta, pi, chi, r)
    assert bool(st_s.cg_converged.all()) and bool(st_u.cg_converged.all())
    atol_th, atol_dH = (2e-5, 1e-4) if fused is False else (2e-4, 5e-3)
    np.testing.assert_allclose(st_s.delta_H.numpy(), st_u.delta_H.numpy(),
                               rtol=0, atol=atol_dH)
    np.testing.assert_allclose(th_s.numpy(), th_u.numpy(), rtol=0, atol=atol_th)
    assert int((st_s.cg_iters - st_u.cg_iters).abs().max()) <= 2
    assert bool(st_s.accepted.any())        # theta' is a moved configuration


def test_chain_of_a_batch_on_a_mesh_equals_chain_alone(rng):
    """Chains are a batch axis on the mesh: chain c of a batch equals chain
    c run alone, bit for bit, under the refined contract (every solver
    decision reads that chain's psum-reduced state only)."""
    jm = _jax_model(16, 16, refine=True, fused=None, md_steps=3, tau=0.15)
    model = _port(jm)
    mesh = lattice_mesh((2, 2))
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (3, 2, 16, 16)).astype(np.float32))
    theta[1] *= 0.1
    pi, chi, r = sampler.draw_chain_noise(model, 6, 0, 3, "cpu")
    step = make_sharded_traj_fn(model, mesh)
    th, st = step.given_noise(theta, pi, chi, r)
    assert len(set(st.cg_iters.tolist())) > 1
    for c in range(3):
        s = slice(c, c + 1)
        th1, st1 = step.given_noise(theta[s], pi[s], chi[s], r[s])
        assert torch.equal(th1[0], th[c])
        assert float(st1.delta_H) == float(st.delta_H[c])
        assert int(st1.cg_iters) == int(st.cg_iters[c])
    # the step that draws its own noise uses the unsharded paths' stream
    th2, _ = step(theta, 6, 0)
    assert torch.equal(th2, th)


def test_sharded_step_refuses_bad_meshes_and_measures(rng):
    model = _port(_jax_model(16, 16, refine=False, fused=None))
    with pytest.raises(ValueError, match="even local Nt"):
        make_sharded_traj_fn(model, lattice_mesh((1, 16)))
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_traj_fn(model, lattice_mesh((3, 1)))
    # the Hamiltonian's gauge terms through the sharded geometry equal the
    # measurements on the global theta
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, 2, 16, 16)).astype(np.float32))
    mesh = lattice_mesh((2, 2))
    inner, th = sharded_model(model, mesh), shard(theta, mesh)
    np.testing.assert_allclose(inner.plaquette_sum(th).reshape(2).numpy() / 256,
                               obs.mean_plaquette(theta).numpy(), rtol=1e-12)
    np.testing.assert_allclose(inner.gauge_action(th).reshape(2).numpy() / 256,
                               obs.gauge_action_density(theta, 2.0).numpy(),
                               rtol=1e-12)


# ---------- the runner and the CLI ----------

def test_run_hmc_on_a_mesh_counts_no_packed_kernel(tmp_path):
    """runner.run_hmc with a mesh runs the sharded step (16x16 over 2x2 takes
    the halo twins), writes ranks_x/ranks_t, and measures on the global
    theta; the same seeds without a mesh give the packed path's run."""
    from schwingermodel_tpu_torch import config
    lat = config.LatticeParams(Nx=16, Nt=16)
    hmc = config.HMCParams(beta=2.0, m0=0.1, md_steps=3, trajectory_length=0.15,
                           even_odd=True, cg=config.CGParams(tol=1e-6, max_iter=2000))
    run = config.RunParams(n_therm=1, n_meas=2, n_chains=2, seed=4,
                           out_dir=str(tmp_path))
    res = run_hmc(lat, hmc, run, device="cpu", mesh=lattice_mesh((2, 2)),
                  write_simdata=True, measure_condensate=True, n_noise=2)
    assert res.all_converged and res.condensate_converged
    assert res.theta.shape == (2, 2, 16, 16)
    assert res.chains["chiral_condensate"].shape == (2, 2)
    text = next(tmp_path.glob("*SimData*")).read_text().split("\n")
    i = text.index("#ranks_x     #ranks_t     #ranks")
    assert text[i + 1].split() == ["2", "2", "4"]
    packed = run_hmc(lat, hmc, run, device="cpu")
    np.testing.assert_allclose(res.chains["plaquette"], packed.chains["plaquette"],
                               rtol=0, atol=1e-5)
    # Hasenbusch on the mesh: the same chain as the packed Hasenbusch path
    hb = dataclasses.replace(hmc, hasenbusch_dm=0.4)
    res_hb = run_hmc(lat, hb, run, device="cpu", mesh=lattice_mesh((2, 2)))
    assert res_hb.all_converged
    np.testing.assert_allclose(res_hb.chains["plaquette"],
                               run_hmc(lat, hb, run, device="cpu").chains["plaquette"],
                               rtol=0, atol=1e-5)


def test_run_hmc_takes_the_mesh_from_run_params(tmp_path):
    """run.mesh_shape alone selects the sharded step (the same run as with
    the mesh handed over, ranks written to SimData), and a mesh that
    disagrees with it is refused."""
    from schwingermodel_tpu_torch import config
    lat = config.LatticeParams(Nx=16, Nt=16)
    hmc = config.HMCParams(beta=2.0, m0=0.1, md_steps=3, trajectory_length=0.15,
                           even_odd=True, cg=config.CGParams(tol=1e-6, max_iter=2000))
    run = config.RunParams(n_therm=1, n_meas=2, n_chains=1, seed=4,
                           out_dir=str(tmp_path), mesh_shape=(2, 2))
    res = run_hmc(lat, hmc, run, device="cpu", write_simdata=True)
    text = next(tmp_path.glob("*SimData*")).read_text().split("\n")
    i = text.index("#ranks_x     #ranks_t     #ranks")
    assert text[i + 1].split() == ["2", "2", "4"]
    given = run_hmc(lat, hmc, dataclasses.replace(run, mesh_shape=None), device="cpu",
                    mesh=lattice_mesh((2, 2)))
    assert np.array_equal(res.theta, given.theta)
    packed = run_hmc(lat, hmc, dataclasses.replace(run, mesh_shape=(1, 1)), device="cpu")
    assert not np.array_equal(res.theta, packed.theta)
    with pytest.raises(ValueError, match="disagrees"):
        run_hmc(lat, hmc, run, device="cpu", mesh=lattice_mesh((4, 1)))


def _cli(args, stdin="", timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu_torch", "--device", "cpu", *args],
        input=stdin, cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


FLAGS = ["--nx", "8", "--nt", "8", "--m0", "0.1", "--md-steps", "4", "--tau", "0.4",
         "--beta", "2", "--ntherm", "2", "--nmeas", "2", "--nsteps", "0"]


@pytest.mark.parametrize("extra", [
    ["--ranks-x", "2", "--ranks-t", "2"],
    ["--ranks-x", "2", "--ranks-t", "2", "--no-cg-refine", "--integrator", "omelyan",
     "--no-cg-forecast", "--chains", "2"],
    ["--ranks-x", "2", "--ranks-t", "1", "--condensate", "--n-noise", "2",
     "--mre-history", "4"],
])
def test_cli_runs_on_a_mesh(tmp_path, extra):
    out = _cli([*FLAGS, "--out-dir", str(tmp_path), *extra])
    assert out.returncode == 0, out.stderr
    rx, rt = extra[1], extra[3]
    assert f"* Device mesh = {rx}x{rt} shards on 1 device (cpu)" in out.stdout
    assert "all solves converged: True" in out.stdout
    assert "WARNING" not in out.stdout
    text = next(tmp_path.glob("*SimData*")).read_text().split("\n")
    i = text.index("#ranks_x     #ranks_t     #ranks")
    assert text[i + 1].split() == [rx, rt, str(int(rx) * int(rt))]
    if "--condensate" in extra:
        assert "Chiral condensate:" in out.stdout


def test_cli_mesh_from_the_prompts(tmp_path):
    """The first two reference prompts set the mesh."""
    out = _cli(["--nx", "8", "--nt", "8", "--out-dir", str(tmp_path)],
               stdin="2\n2\n0.1\n4\n0.4\n2\n1\n2\n0\n0\n")
    assert out.returncode == 0, out.stderr
    assert "* Device mesh = 2x2 shards on 1 device (cpu)" in out.stdout


@pytest.mark.parametrize("extra,code,message", [
    (["--ranks-x", "3", "--ranks-t", "1"], 1, "not divisible"),
    (["--ranks-x", "1", "--ranks-t", "8"], 1, "even local Nt"),
    # chain groups on a lattice mesh: one process a shard, 8 processes
    (["--ranks-chain", "2", "--ranks-x", "2", "--ranks-t", "2"], 1,
     "error: mesh 2x2x2 needs 8 processes, have 1"),
    (["--ranks-x", "2", "--ranks-t", "2", "--hasenbusch-dm", "0.4"], 0,
     "Hasenbusch split"),
])
def test_cli_refuses_meshes_it_cannot_run(tmp_path, extra, code, message):
    args = [a for a in FLAGS]
    if "--ranks-x" not in extra:
        args += ["--ranks-x", "1", "--ranks-t", "1"]
    out = _cli([*args, "--out-dir", str(tmp_path), *extra])
    assert out.returncode == code
    if code == 0:       # Hasenbusch on a mesh used to be refused; it runs now
        assert message in out.stdout
        assert "all solves converged: True" in out.stdout
    else:
        assert message in out.stderr
