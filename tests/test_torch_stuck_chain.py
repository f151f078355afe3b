"""The stuck chain of the port's beta=2 critical-mass scan against the JAX
package and a NumPy oracle.

The scan (tools/critical_mass, 16x16, beta=2, seed 3, C=16, md 36, tau 1)
has one chain, chain 13, that sat on one configuration through every
measurement block at m0=-0.18 (docs/CRITICAL_MASS_torch.md). That chain's
configuration at the start of the measurement phase was saved on the card
by ``docs/critical_mass_diag_torch.py -0.18 --stuck-chain 13``:
tests/golden/critical_mass_b2_m0-0.18_chain13.npy (the f32 state as f64)
and, beside it, tests/golden/critical_mass_diag_torch_b2.json (dH, accept
and CG iterations of every chain's next trajectories on the card, and the
smallest eigenvalues of the even-odd Dhat Dhat^+ at m0 of every chain's
configuration, from the port's operator built densely in f64).

Here, on the CPU: the same configuration and one set of NumPy-seeded noise
(pi, chi, r) through JAX's ``hmc/sampler.trajectory_given_noise`` (x64,
even-odd) and the port's (f64); and the recorded eigenvalues against the
Schur complement of the reference's Wilson operator written out site by
site (tests/reference_impl.py), diagonalized by NumPy.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import reference_impl as ref
from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc.sampler import trajectory_given_noise as jax_trajectory
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel as TorchModel

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CONF = os.path.join(GOLDEN, "critical_mass_b2_m0-0.18_chain13.npy")
DIAG = os.path.join(GOLDEN, "critical_mass_diag_torch_b2.json")
M0, BETA, MD, TAU = -0.18, 2.0, 36, 1.0


def _record():
    with open(DIAG) as f:
        return json.load(f)


def eo_normal_spectrum_oracle(theta: np.ndarray, m0: float) -> np.ndarray:
    """Eigenvalues, ascending, of Dhat Dhat^+ with Dhat = D_ee - D_eo
    D_oo^{-1} D_oe, the Schur complement of the reference's Wilson operator
    on the even sites (x + t even), D built column by column from the
    site-by-site oracle."""
    _, Nx, Nt = theta.shape
    U = np.exp(1j * theta)
    n = 2 * Nx * Nt
    D = np.empty((n, n), dtype=np.complex128)
    for j in range(n):
        e = np.zeros(n, dtype=np.complex128)
        e[j] = 1.0
        D[:, j] = ref.dirac_ref(U, e.reshape(2, Nx, Nt), m0).reshape(-1)
    x, t = np.meshgrid(np.arange(Nx), np.arange(Nt), indexing="ij")
    even = np.tile(((x + t) % 2 == 0).reshape(-1), 2)
    E, O = even, ~even
    Dh = D[np.ix_(E, E)] - D[np.ix_(E, O)] @ np.linalg.solve(
        D[np.ix_(O, O)], D[np.ix_(O, E)])
    return np.linalg.eigvalsh(Dh @ Dh.conj().T)


def test_recorded_eigenvalues_match_numpy_oracle():
    """The smallest eigenvalues the diagnosis recorded on the card, for the
    stuck chain and for a healthy one, equal the oracle's on the committed
    configuration to 1e-9 relative; the stuck chain's lowest mode is the
    smallest of all sixteen chains'."""
    rec = _record()
    theta = np.load(CONF)
    assert theta.shape == (2, 16, 16) and theta.dtype == np.float64
    stuck = str(rec["stuck_chain"])
    got = np.asarray(rec["smallest_eigenvalues"][stuck])
    want = eo_normal_spectrum_oracle(theta, M0)[:len(got)]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    lam = np.asarray(rec["lambda_min"])
    assert lam[int(stuck)] == lam.min()
    assert rec["healthy_chain"] != int(stuck)


@pytest.fixture(scope="module")
def same_noise():
    """One trajectory of the stuck configuration in both packages on the
    same NumPy-seeded noise, at the scan's parameters and CG stop."""
    theta = np.load(CONF)
    rng = np.random.default_rng(20261017)
    pi = rng.standard_normal((2, 16, 16))
    chi = (rng.standard_normal((2, 16, 8))
           + 1j * rng.standard_normal((2, 16, 8))) / np.sqrt(2.0)
    r = rng.uniform()
    jm = SchwingerModel(
        lattice=LatticeParams(Nx=16, Nt=16, real_dtype="float64"),
        hmc=HMCParams(beta=BETA, m0=M0, md_steps=MD, trajectory_length=TAU,
                      even_odd=True, cg=CGParams(tol=1e-10, max_iter=20000)))
    jth, jst = jax.jit(lambda *a: jax_trajectory(jm, *a))(
        jnp.asarray(theta), jnp.asarray(pi), jnp.asarray(chi), jnp.asarray(r))
    lat, hmc, _ = from_jax_config(jm.lattice, jm.hmc)
    th, st = sampler.trajectory_given_noise(
        TorchModel(lattice=lat, hmc=hmc), torch.from_numpy(theta)[None],
        torch.from_numpy(pi)[None], torch.from_numpy(chi)[None],
        torch.tensor([r], dtype=torch.float64))
    return (np.asarray(jth), jst), (th[0].numpy(), st), r


def test_stuck_chain_trajectory_matches_jax(same_noise):
    """dH, the accept decision and theta' of the port equal JAX's, with both
    packages' solves at the scan's 1e-10 stop. theta' to 1e-9, the f64
    trajectory tests' gate (tests/test_torch_fulld.py). dH to 1e-9 or to
    1e-10 of |dH|, the larger: on this configuration dH is of order 1e7,
    almost all of it the new fermion action phi^+ x, and two action solves
    that each stop at ||r|| < 1e-10 ||phi|| leave that action uncertain at
    a relative 1e-10, not at 1e-9 absolute. The trajectory is rejected in
    both: the chain stays where it is, as it did on the card."""
    (jth, jst), (th, st), r = same_noise
    assert bool(jst.cg_converged) and bool(st.cg_converged.all())
    dH, jdH = float(st.delta_H[0]), float(jst.delta_H)
    print("dH port", dH, "jax", jdH, "CG iterations port",
          int(st.cg_iters[0]), "jax", int(jst.cg_iters))
    assert abs(dH - jdH) <= max(1e-9, 1e-10 * abs(jdH))
    assert bool(st.accepted[0]) == bool(jst.accepted)
    d = np.remainder(th - jth + np.pi, 2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-9
    assert jdH > 1e3 and not bool(jst.accepted)
    np.testing.assert_array_equal(th, np.load(CONF))
