"""Kernels K2 (loose solve), K1's in-kernel CG and heavy variant, and K5
(Hasenbusch ratio force) of the PyTorch port against the Pallas kernels
they replace.

On the CPU each wrapper runs its plain twin; the JAX side runs
``pallas_traj`` in interpret mode, as tests/test_pallas_traj.py does, at
8x8 with inputs made from a numpy seed. Gates are that file's: x and psi
to atol 2e-4, forces to atol 3e-5 * max(scale, 1) (5e-5 for the
Hasenbusch force against the model's autodiff force), equal converged
flags. Solves are compared on the contract, so iteration counts may differ
by one (f64-accumulated dots against the MXU's f32 ones). The CUDA kernels
are held against the same twins on the card by tests/test_torch_card_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel, SolveStats
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu.ops.geometry import Geometry
from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops import traj as tr

torch.set_num_threads(1)

C, NX, NT = 2, 8, 8
NTH = NT // 2
TOL, MAX_ITER = 1e-6, 2000


def _theta(rng, C=C, Nx=NX, Nt=NT, scale=np.pi):
    return rng.uniform(-scale, scale, (C, 2, Nx, Nt)).astype(np.float32)


def _spinor(rng, C=C, Nx=NX, Nth=NTH):
    return (rng.standard_normal((C, 2, Nx, Nth))
            + 1j * rng.standard_normal((C, 2, Nx, Nth))).astype(np.complex64)


def _both(theta, *spinors):
    """(JAX packed planes, port planes) of the same angles and spinors."""
    E, O = pt.pack_chains(Geometry(), jnp.asarray(theta))
    jax_in = (E, O, *(pt.pack_even(jnp.asarray(s)) for s in spinors))
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    port_in = (thE, thO, *(tr.to_planar(torch.from_numpy(s)) for s in spinors))
    return jax_in, port_in


def _planar(p_jax, C=C):
    """JAX lane-packed planes -> the port's chain-major numpy array."""
    return tr.from_jax_packed(np.asarray(p_jax), C).numpy()


def _assert_forces(FE, FO, FE_j, FO_j, rel):
    FE_j, FO_j = np.asarray(FE_j), np.asarray(FO_j)
    scale = max(np.abs(FE_j).max(), np.abs(FO_j).max())
    for got, want in ((FE, FE_j), (FO, FO_j)):
        np.testing.assert_allclose(tr.to_jax_packed(got), want, rtol=0,
                                   atol=rel * max(scale, 1.0))


# ---------- K2 ----------

@pytest.mark.parametrize("m0,cold", [(0.1, True), (-0.19, False), (0.2, True)])
def test_solve_fused_matches_pallas_kernel(rng, m0, cold):
    """K2's twin against pt.solve_fused: x to atol 2e-4, flags equal, from
    x0 = b (cold) or from a nearby forecast."""
    theta, b = _theta(rng), _spinor(rng)
    x0 = b if cold else (b + 0.1 * _spinor(rng)).astype(np.complex64)
    (E, O, b_j, x0_j), (thE, thO, b_t, x0_t) = _both(theta, b, x0)
    ref = pt.solve_fused(E, O, b_j, x0_j, m0=m0, tol=TOL, max_iter=MAX_ITER,
                         Nth=NTH, interpret=True)
    got = tr.solve_fused(thE, thO, b_t, x0_t, m0=m0, tol=TOL, max_iter=MAX_ITER)
    assert got.x.dtype == torch.float32 and got.x.shape == (C, 2, 2, NX, NTH)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all())
    np.testing.assert_allclose(got.x.numpy(), _planar(ref.x), rtol=0, atol=2e-4)
    assert np.abs(got.iters.numpy() - np.asarray(ref.iters)).max() <= 1
    assert (got.rel_residual.numpy() < TOL).all()


def test_solve_fused_starved_reports_unconverged(rng):
    """max_iter=3: every chain exits with converged=False and no NaN."""
    theta, b = _theta(rng), _spinor(rng)
    _, (thE, thO, b_t) = _both(theta, b)
    got = tr.solve_fused(thE, thO, b_t, b_t, m0=0.1, tol=TOL, max_iter=3)
    assert not bool(got.converged.any())
    assert (got.iters.numpy() == 3).all()
    assert bool(torch.isfinite(got.x).all())


def test_solve_fused_zero_rhs_freezes_like_pallas(rng):
    """A chain with b = 0 and x0 = 0 breaks down at once (dAd = 0): it
    exits at 0 iterations with x = 0 and converged=False, in both packages,
    and the other chain converges as usual."""
    theta, b = _theta(rng), _spinor(rng)
    b[1] = 0
    x0 = np.where(np.arange(C)[:, None, None, None] == 1, 0, b).astype(np.complex64)
    (E, O, b_j, x0_j), (thE, thO, b_t, x0_t) = _both(theta, b, x0)
    ref = pt.solve_fused(E, O, b_j, x0_j, m0=0.1, tol=TOL, max_iter=MAX_ITER,
                         Nth=NTH, interpret=True)
    got = tr.solve_fused(thE, thO, b_t, x0_t, m0=0.1, tol=TOL, max_iter=MAX_ITER)
    np.testing.assert_array_equal(got.converged.numpy(), [True, False])
    np.testing.assert_array_equal(np.asarray(ref.converged), [True, False])
    assert int(got.iters[1]) == 0 and int(np.asarray(ref.iters)[1]) == 0
    assert float(got.x[1].abs().max()) == 0.0
    np.testing.assert_allclose(got.x.numpy(), _planar(ref.x), rtol=0, atol=2e-4)


def test_solve_fused_nan_chain_is_isolated(rng):
    """A NaN in one chain's right-hand side: that chain exits with
    converged=False and x = x0 (finite); the other chains are solved as if
    alone. (The Pallas kernel's block-indicator matmul spreads the NaN to
    every chain's dots, so there all chains stop at 0 iterations; the port's
    dots are per chain.)"""
    theta, b = _theta(rng, C=3), _spinor(rng, C=3)
    b[1, 0, 2, 1] = np.nan
    x0 = np.zeros_like(b)
    _, (thE, thO, b_t, x0_t) = _both(theta, b, x0)
    got = tr.solve_fused(thE, thO, b_t, x0_t, m0=0.1, tol=TOL, max_iter=MAX_ITER)
    np.testing.assert_array_equal(got.converged.numpy(), [True, False, True])
    assert int(got.iters[1]) == 0
    assert bool(torch.isfinite(got.x).all())
    keep = [0, 2]
    alone = tr.solve_fused(thE[keep], thO[keep], b_t[keep], x0_t[keep], m0=0.1,
                           tol=TOL, max_iter=MAX_ITER)
    np.testing.assert_array_equal(got.iters[keep].numpy(), alone.iters.numpy())
    np.testing.assert_allclose(got.x[keep].numpy(), alone.x.numpy(), rtol=0,
                               atol=1e-6)


# ---------- K1 ----------

@pytest.mark.parametrize("with_gauge", [True, False])
def test_force_step_with_solve_matches_pallas_kernel(rng, with_gauge):
    """K1's twin with the in-kernel CG against pt.force_step_fused: forces
    to 3e-5 * max(scale, 1), psi to 2e-4, flags equal."""
    m0, beta = 0.1, 2.0
    theta, chi = _theta(rng), _spinor(rng)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    phi = tr.dhat(thE, thO, tr.to_planar(torch.from_numpy(chi)), m0)
    phi_c = tr.to_complex(phi).numpy()
    (E, O, phi_j), _ = _both(theta, phi_c)
    ref = pt.force_step_fused(E, O, phi_j, phi_j, m0=m0, beta=beta, tol=TOL,
                              max_iter=MAX_ITER, Nth=NTH, with_solve=True,
                              with_gauge=with_gauge, interpret=True)
    got = tr.force_step(thE, thO, phi, phi, m0=m0, beta=beta, tol=TOL,
                        max_iter=MAX_ITER, with_solve=True, with_gauge=with_gauge)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all())
    assert np.abs(got.iters.numpy() - np.asarray(ref.iters)).max() <= 1
    _assert_forces(got.FE, got.FO, ref.FE, ref.FO, 3e-5)
    np.testing.assert_allclose(got.psi.numpy(), _planar(ref.psi), rtol=0, atol=2e-4)


def test_force_step_heavy_without_solve_matches_pallas_kernel(rng):
    """with_solve=False, with_gauge=False (the refined Hasenbusch heavy
    term): fermion force only, psi passed through, no iterations."""
    theta, psi = _theta(rng, scale=2 * np.pi), _spinor(rng)
    (E, O, psi_j), (thE, thO, psi_t) = _both(theta, psi)
    ref = pt.force_step_fused(E, O, psi_j, psi_j, m0=0.21, beta=2.0, tol=TOL,
                              max_iter=MAX_ITER, Nth=NTH, with_solve=False,
                              with_gauge=False, interpret=True)
    got = tr.force_step(thE, thO, psi_t, psi_t, m0=0.21, beta=2.0, tol=TOL,
                        max_iter=MAX_ITER, with_solve=False, with_gauge=False)
    assert got.psi is psi_t and int(got.iters.sum()) == 0
    assert bool(got.converged.all())
    _assert_forces(got.FE, got.FO, ref.FE, ref.FO, 3e-5)


def test_force_step_starved_solve_reports_unconverged(rng):
    theta, chi = _theta(rng), _spinor(rng)
    _, (thE, thO, phi) = _both(theta, chi)
    got = tr.force_step(thE, thO, phi, phi, m0=0.1, beta=2.0, tol=TOL,
                        max_iter=3, with_solve=True, with_gauge=True)
    assert not bool(got.converged.any())
    assert (got.iters.numpy() == 3).all()
    assert all(bool(torch.isfinite(t).all()) for t in (got.FE, got.FO, got.psi))


# ---------- K5 ----------

def test_ratio_force_matches_pallas_kernel(rng):
    """K5's twin against pt.ratio_force_fused on the same psi and phi2."""
    m0, m1, beta = -0.19, 0.21, 2.0
    theta, psi, phi2 = _theta(rng, scale=2 * np.pi), _spinor(rng), _spinor(rng)
    (E, O, psi_j, phi2_j), (thE, thO, psi_t, phi2_t) = _both(theta, psi, phi2)
    FE_j, FO_j = pt.ratio_force_fused(E, O, psi_j, phi2_j, m0=m0, m1=m1,
                                      beta=beta, Nth=NTH, interpret=True)
    FE, FO = tr.ratio_force(thE, thO, psi_t, phi2_t, m0=m0, m1=m1, beta=beta)
    assert FE.dtype == torch.float32 and FE.shape == (C, 2, NX, NTH)
    _assert_forces(FE, FO, FE_j, FO_j, 3e-5)


def test_hasenbusch_force_matches_model(rng):
    """Heavy K1 (m1, with_solve, with_gauge=False) + K2 light solve + K5 ==
    the model's Hasenbusch force (autodiff bilinears + staples) on the
    fields of its heat bath: test_ratio_force_fused_matches_model's setup,
    forces to 5e-5 * max(scale, 1)."""
    dm, m0, beta = 0.4, -0.19, 2.0
    m1 = m0 + dm
    model = SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=beta, m0=m0, even_odd=True, md_steps=6,
                      trajectory_length=0.6, packed=True, hasenbusch_dm=dm,
                      cg=CGParams(tol=TOL, max_iter=MAX_ITER)))
    theta = jnp.asarray(_theta(rng))
    chi = jnp.asarray(np.stack([_spinor(rng), _spinor(rng)], axis=1))

    def heat_bath(t, c):
        return model.pseudofermion_fields(t, c, SolveStats.zero())[0]

    phi1, phi2 = jax.vmap(heat_bath)(theta, chi)
    F_ref = jax.vmap(lambda t, p1, p2: model.force(
        t, (p1, p2), SolveStats.zero())[0])(theta, phi1, phi2)

    thE, thO = tr.pack_planes(torch.from_numpy(np.array(theta)))
    phi1_t = tr.to_planar(torch.from_numpy(np.array(phi1)))
    phi2_t = tr.to_planar(torch.from_numpy(np.array(phi2)))
    heavy = tr.force_step(thE, thO, phi1_t, phi1_t, m0=m1, beta=beta, tol=TOL,
                          max_iter=MAX_ITER, with_solve=True, with_gauge=False)
    b2 = tr.dhat(thE, thO, phi2_t, m1)
    sol2 = tr.solve_fused(thE, thO, b2, b2, m0=m0, tol=TOL, max_iter=MAX_ITER)
    FE2, FO2 = tr.ratio_force(thE, thO, sol2.x, phi2_t, m0=m0, m1=m1, beta=beta)
    assert bool(heavy.converged.all()) and bool(sol2.converged.all())
    F_got = eo.unpack(heavy.FE + FE2, heavy.FO + FO2).numpy()
    scale = np.abs(np.asarray(F_ref)).max()
    np.testing.assert_allclose(F_got, np.asarray(F_ref), rtol=0,
                               atol=5e-5 * max(scale, 1.0))


# ---------- the state bridge ----------

def test_jax_packed_bridge_carries_the_pair_axis(rng):
    """from_jax_packed / to_jax_packed round-trip the Hasenbusch pair of
    fields [2(pair), 2, 2, Nx, C*Nth], and the pair of noise fields maps to
    pt.pack_even of each member."""
    chi = np.stack([_spinor(rng), _spinor(rng)], axis=1)        # [C, 2, 2, Nx, Nth]
    planar = tr.to_planar(torch.from_numpy(chi))                  # [C, 2, 2, 2, Nx, Nth]
    assert planar.shape == (C, 2, 2, 2, NX, NTH)
    packed = tr.to_jax_packed(planar)
    assert packed.shape == (2, 2, 2, NX, C * NTH)
    for k in range(2):
        np.testing.assert_array_equal(packed[k],
                                      np.asarray(pt.pack_even(jnp.asarray(chi[:, k]))))
    back = tr.from_jax_packed(packed, C)
    assert torch.equal(back, planar)
    assert torch.equal(tr.to_complex(back), torch.from_numpy(chi))
