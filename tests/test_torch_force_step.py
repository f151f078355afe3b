"""Kernel K1 (the fused MD force step) of the PyTorch port against the
Pallas kernel it replaces.

On the CPU ``force_step`` runs its plain twin ``force_step_reference``;
the JAX side is ``pallas_traj.force_step_fused(with_solve=False)`` in
interpret mode. The gate is test_pallas_traj.py's: forces agree to
atol 3e-5 * max(scale, 1). Angles are drawn in [-2pi, 2pi], which
includes MD drift. The CUDA kernel itself is held against the same twin
on the card by tests/test_torch_card_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu.ops.geometry import Geometry
from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops import traj as tr

torch.set_num_threads(1)

C = 2


def _inputs(rng, Nx, Nt):
    Nth = Nt // 2
    theta = rng.uniform(-2 * np.pi, 2 * np.pi, (C, 2, Nx, Nt)).astype(np.float32)
    psi = (rng.standard_normal((C, 2, Nx, Nth))
           + 1j * rng.standard_normal((C, 2, Nx, Nth))).astype(np.complex64)
    return theta, psi


@pytest.mark.parametrize("Nx,Nt,m0,beta", [(8, 8, 0.1, 2.0), (8, 12, 0.2, 4.0)])
def test_force_step_matches_pallas_kernel(rng, Nx, Nt, m0, beta):
    Nth = Nt // 2
    theta, psi = _inputs(rng, Nx, Nt)
    E_j, O_j = pt.pack_chains(Geometry(), jnp.asarray(theta))
    psi_j = pt.pack_even(jnp.asarray(psi))
    res = pt.force_step_fused(E_j, O_j, psi_j, psi_j, m0=m0, beta=beta,
                              tol=1e-8, max_iter=100, Nth=Nth,
                              with_solve=False, interpret=True)

    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    psi_t = tr.to_planar(torch.from_numpy(psi))
    res_t = tr.force_step(thE, thO, psi_t, psi_t, m0=m0, beta=beta, tol=1e-8,
                          max_iter=100, with_solve=False)
    FE, FO = res_t.FE, res_t.FO
    assert FE.dtype == torch.float32 and FE.shape == (C, 2, Nx, Nth)

    FE_j, FO_j = np.asarray(res.FE), np.asarray(res.FO)
    scale = max(np.abs(FE_j).max(), np.abs(FO_j).max())
    np.testing.assert_allclose(tr.to_jax_packed(FE), FE_j, rtol=0,
                               atol=3e-5 * max(scale, 1.0))
    np.testing.assert_allclose(tr.to_jax_packed(FO), FO_j, rtol=0,
                               atol=3e-5 * max(scale, 1.0))


def test_force_step_is_minus_gradient_of_action(rng):
    """Finite-difference check of the total force: F = -dS/dtheta for
    S = beta sum(1 - Re P) + Phi^+ (Dhat Dhat^+)^{-1} Phi, in f64 with psi
    solved exactly (dense solve on the 8x8 even sublattice)."""
    from schwingermodel_tpu_torch.ops import eo, gauge

    Nx, Nt, m0, beta = 8, 8, 0.1, 2.0
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (1, 2, Nx, Nt)))
    phi = torch.from_numpy(rng.standard_normal((1, 2, Nx, Nt // 2))
                           + 1j * rng.standard_normal((1, 2, Nx, Nt // 2)))

    def dense_normal(th):
        ue, uo = gauge.links(*tr.pack_planes(th), torch.complex128)
        n = 2 * Nx * (Nt // 2)
        eye = torch.eye(n, dtype=torch.complex128).reshape(n, 2, Nx, Nt // 2)
        cols = eo.normal(ue[0], uo[0], eye, m0).reshape(n, n)
        return cols.T

    def action(th):
        A = dense_normal(th)
        x = torch.linalg.solve(A, phi.reshape(-1))
        sf = torch.vdot(phi.reshape(-1), x).real
        thE, thO = tr.pack_planes(th)
        return gauge.gauge_action(thE, thO, beta)[0] + sf

    A = dense_normal(theta)
    psi = torch.linalg.solve(A, phi.reshape(-1)).reshape(phi.shape)
    thE, thO = tr.pack_planes(theta)
    ue, uo = gauge.links(thE, thO, torch.complex128)
    chi = eo.dhat_dag(ue, uo, psi, m0)
    ffe, ffo = eo.fermion_force_planes(ue, uo, psi, chi, m0)
    gfe, gfo = gauge.gauge_force_planes(ue, uo, beta)
    F = eo.unpack(ffe + gfe, ffo + gfo)[0]

    h = 1e-5
    for mu, x, t in [(0, 1, 2), (1, 3, 7), (0, 6, 7), (1, 0, 0)]:
        tp, tm = theta.clone(), theta.clone()
        tp[0, mu, x, t] += h
        tm[0, mu, x, t] -= h
        fd = -(action(tp) - action(tm)) / (2 * h)
        assert abs(float(fd) - float(F[mu, x, t])) < 1e-6 * max(1.0, abs(float(fd)))
