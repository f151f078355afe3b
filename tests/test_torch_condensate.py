"""The measurement path of the PyTorch port: kernel K6 (the f32 CG on given
links), K9 (the f64 true residual), the restart refinement, dirac_inverse,
the chiral condensate, the meson correlators and the CLI's --condensate.

On the CPU each wrapper runs its plain twin. The JAX side runs its own
solves through K6 in interpret mode (a model with fused_cg=True, the x64
refinement, jax x64 on), at 8x8 and 6x12 with inputs made from a numpy
seed; the refinement and the condensate are also held against the NumPy
oracle (tests/reference_impl.py). The CUDA kernels are held against the
same twins on the card by tests/test_torch_card_kernels.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu import observables as jobs
from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu.ops.pallas_eo import cg_solve_eo_fused
from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import cg_eo, eo
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.solvers import refine
from tests import reference_impl as ref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M0, BETA = 0.2, 4.0


def _jax_model(Nx=8, Nt=8, m0=M0, refine_=True, tol=1e-10, inner_tol=1e-5,
               fallback=True, max_iter=10000, max_outer=8):
    """f32 even-odd model whose solves run K6 in interpret mode."""
    return JaxModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32"),
        hmc=HMCParams(beta=BETA, m0=m0, even_odd=True, fused_cg=True,
                      cg=CGParams(tol=tol, max_iter=max_iter, refine=refine_,
                                  refine_impl="x64", inner_tol=inner_tol,
                                  fallback=fallback, max_outer=max_outer)))


def _port(jmodel):
    lat, hmc, _ = from_jax_config(jmodel.lattice, jmodel.hmc)
    return SchwingerModel(lattice=lat, hmc=hmc)


def _theta(rng, C, Nx=8, Nt=8):
    return rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt)).astype(np.float32)


def _cspinor(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _links(theta):
    """The port's planar folded links (ue, uo) of theta [C, 2, Nx, Nt]."""
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    return (thE, thO, *SchwingerModel.fermion_links(thE, thO))


def _oracle_normal(theta, v, m0):
    """(Dhat Dhat^+) v in complex128 from the full-lattice NumPy oracle D,
    for one configuration: theta [2, Nx, Nt], v even-packed [2, Nx, Nth]."""
    U = np.exp(1j * theta.astype(np.float64))
    m = m0 + 2.0

    def schur(v_e, D):
        z = np.zeros_like(v_e)
        full = eo.unpack(torch.from_numpy(v_e), torch.from_numpy(z)).numpy()
        y_o = eo.pack(torch.from_numpy(D(U, full, m0)), eo.ODD).numpy()
        w = eo.unpack(torch.from_numpy(z), torch.from_numpy(-y_o / m)).numpy()
        return m * v_e + eo.pack(torch.from_numpy(D(U, w, m0)), eo.EVEN).numpy()

    return schur(schur(v, ref.dirac_dagger_ref), ref.dirac_ref)


def _dense_dirac(theta):
    """Dense D of one configuration from the oracle, on the basis vectors."""
    _, Nx, Nt = theta.shape
    U = np.exp(1j * theta.astype(np.float64))
    n = 2 * Nx * Nt
    D = np.empty((n, n), np.complex128)
    for k in range(n):
        e = np.zeros(n, np.complex128)
        e[k] = 1.0
        D[:, k] = ref.dirac_ref(U, e.reshape(2, Nx, Nt), M0).reshape(-1)
    return D


# ---------- K6 ----------

def _k6_pair(Ue, Uo, b, x0, tol, max_iter):
    """JAX cg_solve_eo_fused (interpret) for one system."""
    return cg_solve_eo_fused(Ue, Uo, jnp.asarray(b), jnp.asarray(x0), m0=M0,
                             tol=tol, max_iter=max_iter, interpret=True)


@pytest.mark.parametrize("shape", [(8, 8), (6, 12)])
def test_cg_solve_eo_matches_pallas_single(rng, shape):
    """K6a: the twin on the port's folded links against the Pallas kernel
    on the JAX model's, from x0 = b (test_pallas.py's setup): flags equal,
    iterations within 1, x to atol 1e-5 rtol 1e-4."""
    Nx, Nt = shape
    jmodel = _jax_model(Nx, Nt)
    theta = _theta(rng, 1, Nx, Nt)
    ops = jmodel.eo_ops(jnp.asarray(theta[0]))
    b = np.array(ops.dhat(jnp.asarray(_cspinor(rng, (2, Nx, Nt // 2)))))
    want = _k6_pair(ops.Ue, ops.Uo, b, b, 1e-5, 500)
    _, _, ue, uo = _links(theta)
    bp = tr.to_planar(torch.from_numpy(b))[None, None]
    got = cg_eo.cg_solve_eo(ue, uo, bp, bp, m0=M0, tol=1e-5, max_iter=500)
    assert got.x.shape == (1, 1, 2, 2, Nx, Nt // 2) and got.iters.shape == (1, 1)
    print("K6a iterations: port", int(got.iters), "pallas", int(want.iters))
    assert bool(got.converged) and bool(want.converged)
    assert abs(int(got.iters) - int(want.iters)) <= 1
    np.testing.assert_allclose(tr.to_complex(got.x)[0, 0].numpy(),
                               np.asarray(want.x), atol=1e-5, rtol=1e-4)


def test_cg_solve_eo_matches_pallas_vmapped_per_chain_links(rng):
    """K6b: C=3 configurations of B=2 right-hand sides each against the
    lane-packed Pallas kernel (jax.vmap over the 6 systems with their
    configurations' links, test_pallas.py's per-chain-links setup)."""
    C, B = 3, 2
    jmodel = _jax_model()
    theta = _theta(rng, C)
    v = _cspinor(rng, (C, B, 2, 8, 4))

    def system(th, vv):
        ops = jmodel.eo_ops(th)
        return ops.Ue, ops.Uo, ops.dhat(vv)

    Ue, Uo, b = jax.vmap(jax.vmap(system, (None, 0)), (0, 0))(
        jnp.asarray(theta), jnp.asarray(v))
    flat = [a.reshape(C * B, *a.shape[2:]) for a in (Ue, Uo, b)]
    want = jax.vmap(lambda u, w, bb: cg_solve_eo_fused(
        u, w, bb, bb, m0=M0, tol=1e-5, max_iter=500, interpret=True))(*flat)
    _, _, ue, uo = _links(theta)
    bp = tr.to_planar(torch.from_numpy(np.array(b)))
    got = cg_eo.cg_solve_eo(ue, uo, bp, bp, m0=M0, tol=1e-5, max_iter=500)
    w_iters = np.asarray(want.iters).reshape(C, B)
    print("K6b iterations: port", got.iters.tolist(), "pallas", w_iters.tolist())
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged).reshape(C, B))
    assert bool(got.converged.all())
    assert np.abs(got.iters.numpy() - w_iters).max() <= 1
    np.testing.assert_allclose(tr.to_complex(got.x).numpy(),
                               np.asarray(want.x).reshape(C, B, 2, 8, 4),
                               atol=1e-5, rtol=1e-4)


def test_cg_solve_eo_given_links_equal_theta_path(rng):
    """The given-links entry on SchwingerModel.fermion_links solves the
    same system as K2's twin, which builds the links from theta: a wrong
    antiperiodic fold would still converge, to another x."""
    theta = _theta(rng, 2)
    thE, thO, ue, uo = _links(theta)
    b = tr.to_planar(torch.from_numpy(_cspinor(rng, (2, 1, 2, 8, 4))))
    got = cg_eo.cg_solve_eo(ue, uo, b, b, m0=M0, tol=1e-6, max_iter=500)
    want = tr.solve_fused(thE, thO, b[:, 0], b[:, 0], m0=M0, tol=1e-6,
                          max_iter=500)
    assert torch.equal(got.x[:, 0], want.x)
    assert torch.equal(got.iters[:, 0], want.iters)


def test_cg_solve_eo_starved_reports_unconverged(rng):
    """max_iter=3 at tol 1e-12: every entry exits unconverged after 3
    iterations with a finite x (test_fused_cg_nonconvergence_flag)."""
    theta = _theta(rng, 2)
    _, _, ue, uo = _links(theta)
    b = tr.to_planar(torch.from_numpy(_cspinor(rng, (2, 2, 2, 8, 4))))
    got = cg_eo.cg_solve_eo(ue, uo, b, b, m0=M0, tol=1e-12, max_iter=3)
    assert not bool(got.converged.any())
    assert (got.iters.numpy() == 3).all()
    assert bool(torch.isfinite(got.x).all())


def test_cg_solve_eo_nan_entry_is_isolated(rng):
    """A NaN in one entry's right-hand side: that entry exits unconverged
    at 0 iterations; every other entry is solved as if alone. (K6b's
    block-indicator matmul spreads the NaN to every chain: ROADMAP
    queue 3.)"""
    theta = _theta(rng, 2)
    _, _, ue, uo = _links(theta)
    bc = _cspinor(rng, (2, 2, 2, 8, 4))
    bc[1, 0, 0, 3, 1] = np.nan
    b = tr.to_planar(torch.from_numpy(bc))
    x0 = torch.zeros_like(b)
    got = cg_eo.cg_solve_eo(ue, uo, b, x0, m0=M0, tol=1e-6, max_iter=500)
    np.testing.assert_array_equal(got.converged.numpy(), [[True, True], [False, True]])
    assert int(got.iters[1, 0]) == 0
    for c, j in ((0, 0), (0, 1), (1, 1)):
        alone = cg_eo.cg_solve_eo(ue[c:c + 1], uo[c:c + 1], b[c:c + 1, j:j + 1],
                                  x0[c:c + 1, j:j + 1], m0=M0, tol=1e-6,
                                  max_iter=500)
        assert int(alone.iters) == int(got.iters[c, j])
        assert torch.equal(alone.x[0, 0], got.x[c, j])


# ---------- K9 ----------

def test_residual_f64_matches_jax_x64_and_oracle(rng):
    """K9's twin against JAX x64 b - EOOperators(fermion_links_hi).normal(x)
    and against the NumPy oracle: relative 1e-12."""
    C, B = 2, 2
    jmodel = _jax_model()
    theta = _theta(rng, C)
    thE, thO, _, _ = _links(theta)
    b = _cspinor(rng, (C, B, 2, 8, 4))
    x = (rng.standard_normal((C, B, 2, 8, 4))
         + 1j * rng.standard_normal((C, B, 2, 8, 4)))
    bp = tr.to_planar(torch.from_numpy(b))
    xp = tr.to_planar(torch.from_numpy(x))
    r, rn = rs.residual_f64(thE, thO, bp, xp, m0=M0)
    assert r.dtype == torch.float64 and rn.shape == (C, B)
    rc = tr.to_complex(r).numpy()
    for c in range(C):
        th = jnp.asarray(theta[c])
        ops = jeo.EOOperators(jmodel.geom, jmodel.fermion_links_hi(th), M0)
        for j in range(B):
            want = np.asarray(jnp.asarray(b[c, j]).astype(jnp.complex128)
                              - ops.normal(jnp.asarray(x[c, j])))
            oracle = b[c, j].astype(np.complex128) - _oracle_normal(theta[c], x[c, j], M0)
            scale = np.abs(want).max()
            assert np.abs(rc[c, j] - want).max() <= 1e-12 * scale
            assert np.abs(rc[c, j] - oracle).max() <= 1e-12 * scale
            np.testing.assert_allclose(float(rn[c, j]), np.vdot(want, want).real,
                                       rtol=1e-12)


# ---------- the restart refinement ----------

def _refine_pair(rng, jmodel, C=2, B=2):
    """The port's refinement and JAX model._solve_eo_refined (inner solves
    through K6 in interpret mode) on the same systems."""
    pmodel = _port(jmodel)
    theta = _theta(rng, C)
    b = _cspinor(rng, (C, B, 2, 8, 4))
    thE, thO, ue, uo = _links(theta)
    got = pmodel.solve_eo(thE, thO, ue, uo, tr.to_planar(torch.from_numpy(b)))
    want = []
    for c in range(C):
        th = jnp.asarray(theta[c])
        ops = jmodel.eo_ops(th)
        want.append([jmodel._solve_eo_refined(th, ops, jnp.asarray(b[c, j]))[0]
                     for j in range(B)])
    return theta, b, got, want


def test_refinement_matches_jax_refined_solve(rng):
    """Flags equal, the oracle's f64 true residual below tol ||b||, x within
    1e-8 relative of JAX's x64 refinement, inner iterations printed."""
    jmodel = _jax_model()
    theta, b, got, want = _refine_pair(rng, jmodel)
    assert got.x64.dtype == torch.float64 and got.iters.shape == (2, 2)
    xg = tr.to_complex(got.x64).numpy()
    for c in range(2):
        for j in range(2):
            w = want[c][j]
            print("refinement iterations: port", int(got.iters[c, j]), "jax",
                  int(w.iters))
            assert bool(got.converged[c, j]) == bool(w.converged) is True
            rr = b[c, j] - _oracle_normal(theta[c], xg[c, j], M0)
            assert np.linalg.norm(rr) < 1e-10 * np.linalg.norm(b[c, j])
            xw = np.asarray(w.x)
            assert np.linalg.norm(xg[c, j] - xw) < 1e-8 * np.linalg.norm(xw)


@pytest.mark.parametrize("fallback", [False, True])
def test_refinement_stagnation_and_fallback(rng, fallback):
    """inner_tol 0.9 contracts ||r||^2 by ~0.8 a pass: both packages stop
    at the stagnation test unconverged; with the fallback the f64 CG (K4's
    twin here, JAX's _f64_cg_finish) finishes to the contract. Compared on
    the contract: flags equal, the oracle residual, x within 1e-8."""
    jmodel = _jax_model(inner_tol=0.9, fallback=fallback)
    theta, b, got, want = _refine_pair(rng, jmodel, C=1, B=2)
    no_fb = refine.cg_refine(*_links(theta),
                             tr.to_planar(torch.from_numpy(b)), m0=M0,
                             tol=1e-10, inner_tol=0.9, max_iter=10000,
                             max_outer=8, fallback=False)
    assert not bool(no_fb.converged.any())
    xg = tr.to_complex(got.x64).numpy()
    for j in range(2):
        w = want[0][j]
        print(f"fallback={fallback} iterations: port", int(got.iters[0, j]),
              "jax", int(w.iters))
        assert bool(got.converged[0, j]) == bool(w.converged) == fallback
        if fallback:
            assert int(got.iters[0, j]) > int(no_fb.iters[0, j])
            rr = b[0, j] - _oracle_normal(theta[0], xg[0, j], M0)
            assert np.linalg.norm(rr) < 1e-10 * np.linalg.norm(b[0, j])
            xw = np.asarray(w.x)
            assert np.linalg.norm(xg[0, j] - xw) < 1e-8 * np.linalg.norm(xw)


def test_refinement_entries_are_independent(rng):
    """Entry (c, j) of a C=2, B=2 batch is that system solved alone."""
    theta = _theta(rng, 2)
    thE, thO, ue, uo = _links(theta)
    b = tr.to_planar(torch.from_numpy(_cspinor(rng, (2, 2, 2, 8, 4))))
    kw = dict(m0=M0, tol=1e-10, inner_tol=1e-5, max_iter=10000, max_outer=8)
    batch = refine.cg_refine(thE, thO, ue, uo, b, **kw)
    for c in range(2):
        for j in range(2):
            one = refine.cg_refine(thE[c:c + 1], thO[c:c + 1], ue[c:c + 1],
                                   uo[c:c + 1], b[c:c + 1, j:j + 1], **kw)
            assert int(one.iters) == int(batch.iters[c, j])
            assert bool(one.converged) and bool(batch.converged[c, j])
            assert torch.equal(one.x64[0, 0], batch.x64[c, j])


# ---------- dirac_inverse and the condensate ----------

def test_dirac_inverse_matches_jax(rng):
    """w = D^{-1} z against JAX model.dirac_inverse (refined, K6 inner
    solves in interpret mode) on the same source: rtol 1e-5 in norm and
    atol 1e-5 max|w| elementwise, every flag true."""
    jmodel = _jax_model()
    theta = _theta(rng, 2)
    z = _cspinor(rng, (2, 2, 2, 8, 8))
    w, res = _port(jmodel).dirac_inverse(torch.from_numpy(theta),
                                         torch.from_numpy(z))
    assert w.dtype == torch.complex64 and w.shape == z.shape
    assert bool(res.converged.all())
    for c in range(2):
        for j in range(2):
            w_j, r_j = jmodel.dirac_inverse(jnp.asarray(theta[c]),
                                            jnp.asarray(z[c, j]))
            assert bool(r_j.converged)
            w_j = np.asarray(w_j)
            got = w[c, j].numpy()
            assert np.linalg.norm(got - w_j) < 1e-5 * np.linalg.norm(w_j)
            np.testing.assert_allclose(got, w_j, rtol=0,
                                       atol=1e-5 * np.abs(w_j).max())


def _jax_condensate(jmodel, theta, zs):
    res = jax.vmap(lambda t, z: jobs.chiral_condensate_given_noise(
        jmodel, t, z))(jnp.asarray(theta), jnp.asarray(zs))
    return np.asarray(res.value), np.asarray(res.solves.all_converged)


@pytest.mark.parametrize("refined,rtol", [(True, 1e-5), (False, 1e-4)])
def test_condensate_given_noise_matches_jax(refined, rtol):
    """C=2 chains, 2 noise vectors each, drawn by the port's generator:
    the value within rtol 1e-5 of JAX's (refined) or 1e-4 (loose, tol
    1e-6, the solve from x0 = b), flags equal."""
    rng = np.random.default_rng(31)
    jmodel = _jax_model(refine_=refined, tol=1e-10 if refined else 1e-6)
    theta = _theta(rng, 2)
    zs = obs.condensate_noise(3, 0, 2, theta.shape, 2, "cpu")
    got = obs.chiral_condensate_given_noise(_port(jmodel), torch.from_numpy(theta), zs)
    value, conv = _jax_condensate(jmodel, theta, zs.numpy())
    print("condensate: port", got.value.tolist(), "jax", value.tolist(),
          "iterations", got.iters.tolist())
    np.testing.assert_array_equal(got.converged.all(dim=1).numpy(), conv)
    assert conv.all()
    np.testing.assert_allclose(got.value.numpy(), value, rtol=rtol)


def test_condensate_matches_dense_oracle():
    """The refined condensate against mean_k z_k^+ D^{-1} z_k / V from the
    dense f64 oracle D on the same noise: rtol 2e-4 (f32 assembly;
    test_condensate_f32_refined_shipped_contract's gate)."""
    rng = np.random.default_rng(9)
    theta = _theta(rng, 1)
    pmodel = _port(_jax_model())
    zs = obs.condensate_noise(0, 5, 1, theta.shape, 4, "cpu")
    got = obs.chiral_condensate_given_noise(pmodel, torch.from_numpy(theta), zs)
    assert bool(got.converged.all())
    assert int(got.iters.sum()) < 4 * 2000
    D = _dense_dirac(theta[0])
    ests = [np.real(z.conj() @ np.linalg.solve(D, z))
            for z in zs[0].numpy().astype(np.complex128).reshape(4, -1)]
    np.testing.assert_allclose(float(got.value[0]), np.mean(ests) / 64, rtol=2e-4)


def test_condensate_noise_is_z2_and_keyed_per_chain():
    """Entries (+-1 +- i)/sqrt(2); a chain's noise depends on (seed,
    measurement, chain) only; measurements and seeds differ."""
    shape = (3, 2, 8, 8)
    zs = obs.condensate_noise(0, 4, 3, shape, 5, "cpu")
    assert zs.shape == (3, 5, 2, 8, 8) and zs.dtype == torch.complex64
    s = 2 ** -0.5
    assert torch.all((zs.real.abs() - s).abs() < 1e-7)
    assert torch.all((zs.imag.abs() - s).abs() < 1e-7)
    assert torch.equal(obs.condensate_noise(0, 4, 1, shape, 5, "cpu")[0], zs[0])
    assert not torch.equal(obs.condensate_noise(0, 5, 1, shape, 5, "cpu")[0], zs[0])
    assert not torch.equal(obs.condensate_noise(1, 4, 1, shape, 5, "cpu")[0], zs[0])
    assert not torch.equal(zs[1], zs[0])


def test_measure_all_keys_and_condensate_flag():
    """measure_all with the condensate has JAX's keys, per chain."""
    rng = np.random.default_rng(4)
    theta = torch.from_numpy(_theta(rng, 2))
    out = obs.measure_all(_port(_jax_model()), theta, with_condensate=True,
                          seed=0, meas_index=1, n_noise=2)
    assert set(out) == {"plaquette", "gauge_action_density", "top_charge",
                        "chiral_condensate", "condensate_cg_converged"}
    assert out["chiral_condensate"].shape == (2,)
    assert bool(out["condensate_cg_converged"].all())
    assert set(obs.measure_all(_port(_jax_model()), theta)) == {
        "plaquette", "gauge_action_density", "top_charge"}


# ---------- mesons ----------

def test_meson_correlators_match_jax():
    """C_PP and C_A0P at 8x8 on random angles against JAX's (refined, K6
    in interpret mode): rtol 1e-5 (atol 1e-5 of the correlator's scale)."""
    rng = np.random.default_rng(17)
    jmodel = _jax_model()
    theta = _theta(rng, 2)
    got = obs.meson_correlators(_port(jmodel), torch.from_numpy(theta))
    assert got.C_PP.shape == (2, 8) and bool(got.converged.all())
    for c in range(2):
        want = jobs.meson_correlators(jmodel, jnp.asarray(theta[c]))
        for g, w in ((got.C_PP[c], want.C_PP), (got.C_A0P[c], want.C_A0P)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def test_pcac_mass_free_field():
    """Free Wilson fermions at 16x16, m0 = 0.1 (test_pcac_mass_free_field):
    the PCAC plateau t in [3, 5] reproduces m0 to 12%, and the pion
    correlator decays away from the source."""
    m0 = 0.10
    pmodel = _port(_jax_model(16, 16, m0=m0))
    res = obs.meson_correlators(pmodel, torch.zeros((1, 2, 16, 16)))
    assert bool(res.converged.all())
    m_t = obs.pcac_mass(res.C_PP, res.C_A0P)[0]
    plateau = m_t[3:6]
    assert np.all(np.isfinite(plateau))
    np.testing.assert_allclose(plateau.mean(), m0, rtol=0.12)
    C = res.C_PP[0].numpy()
    assert C[1] > C[4] > 0


def test_pcac_mass_nan_where_cpp_not_positive(rng):
    """NaN exactly where C_PP <= 0, JAX's values elsewhere."""
    C_PP = rng.standard_normal((2, 10))
    C_A0P = rng.standard_normal((2, 10))
    got = obs.pcac_mass(torch.from_numpy(C_PP), C_A0P)
    assert np.array_equal(np.isnan(got), C_PP <= 0)
    for c in range(2):
        np.testing.assert_array_equal(got[c], jobs.pcac_mass(C_PP[c], C_A0P[c]))


# ---------- the CLI ----------

def _results_block(path):
    """The SimData results block: its lines from '#Ep' on, and its numbers."""
    lines = open(path).read().split("\n")
    block = lines[next(i for i, ln in enumerate(lines) if ln.startswith("#Ep")):]
    nums = [float(v) for ln in block if not ln.startswith("#") for v in ln.split()]
    return "\n".join(block), nums


@pytest.mark.parametrize("extra", [[], ["--no-cg-refine"], ["--hasenbusch-dm", "0.4"],
                                   ["--integrator", "omelyan"]])
def test_cli_condensate_on_cpu(tmp_path, extra):
    """--condensate --n-noise 2 on the CPU, on the refined, loose,
    Hasenbusch and Omelyan paths: exit 0, JAX's 'Chiral condensate:' line,
    and a SimData whose results block is byte for byte what the JAX writer
    makes of the same numbers."""
    from schwingermodel_tpu.io.simdata import SimData as JaxSimData

    params = "1\n1\n0.2\n4\n0.4\n4\n2\n4\n0\n0\n"
    out = subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu_torch", "--device", "cpu",
         "--nx", "8", "--nt", "8", "--chains", "2", "--condensate",
         "--n-noise", "2", "--out-dir", str(tmp_path), *extra],
        input=params, cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("Chiral condensate:")]
    assert len(line) == 1 and "+-" in line[0] and "tau_int" in line[0]
    assert "did not converge" not in out.stdout
    sim = next(tmp_path.glob("*_SimData.txt"))
    text, nums = _results_block(sim)
    assert "#chiral_condensate" in text and "#dchiral_condensate" in text
    Ep, dEp, gS, dgS, acc, t, cc, dcc = nums
    assert np.isfinite(cc) and 0.0 < cc < 2.0
    jpath = tmp_path / "jax_SimData.txt"
    jpath.write_text("")
    JaxSimData(str(jpath)).append_results(
        Ep=Ep, dEp=dEp, gS=gS, dgS=dgS, acceptance_rate=acc, elapsed_seconds=t,
        extra={"chiral_condensate": (cc, dcc)})
    assert text == jpath.read_text()
