"""The PyTorch port's operators against the JAX package and the NumPy oracle.

Same inputs, made from a seeded numpy generator, go through the JAX
lane-packed operators (ops/pallas_traj.py, ops/eo.py, ops/gauge.py) and the
port's chain-major ones (schwingermodel_tpu_torch/ops), converted at the
boundary by ops/traj.from_jax_packed / to_jax_packed. The f64 versions are
held against tests/reference_impl.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu.ops.geometry import Geometry
from schwingermodel_tpu_torch.ops import eo, gauge
from schwingermodel_tpu_torch.ops import traj as tr
from tests import reference_impl as ref

torch.set_num_threads(1)

SHAPES = [(8, 8), (8, 12)]
C = 3


def _theta(rng, Nx, Nt, scale=np.pi):
    return rng.uniform(-scale, scale, (C, 2, Nx, Nt)).astype(np.float32)


def _spinor(rng, Nx, Nth):
    return (rng.standard_normal((C, 2, Nx, Nth))
            + 1j * rng.standard_normal((C, 2, Nx, Nth))).astype(np.complex64)


def _port_planes(theta):
    return tr.pack_planes(torch.from_numpy(theta))


@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_pack_unpack_matches_jax(rng, Nx, Nt):
    a = rng.standard_normal((C, 2, Nx, Nt)).astype(np.float32)
    geom = Geometry()
    for parity in (eo.EVEN, eo.ODD):
        got = eo.pack(torch.from_numpy(a), parity).numpy()
        want = np.stack([np.asarray(jeo.pack(geom, jnp.asarray(x), parity))
                         for x in a])
        np.testing.assert_array_equal(got, want)
    E, O = _port_planes(a)
    np.testing.assert_array_equal(eo.unpack(E, O).numpy(), a)


@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_converters_roundtrip_jax_lanes(rng, Nx, Nt):
    theta = _theta(rng, Nx, Nt)
    E_j, O_j = pt.pack_chains(Geometry(), jnp.asarray(theta))
    E, O = _port_planes(theta)
    np.testing.assert_array_equal(tr.from_jax_packed(np.asarray(E_j), C).numpy(),
                                  E.numpy())
    np.testing.assert_array_equal(tr.to_jax_packed(O), np.asarray(O_j))
    v = _spinor(rng, Nx, Nt // 2)
    vp = np.asarray(pt.pack_even(jnp.asarray(v)))
    np.testing.assert_array_equal(tr.to_jax_packed(tr.to_planar(torch.from_numpy(v))),
                                  vp)


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_dhat_matches_jax_packed(rng, Nx, Nt, dagger):
    Nth = Nt // 2
    theta = _theta(rng, Nx, Nt)
    v = _spinor(rng, Nx, Nth)
    E_j, O_j = pt.pack_chains(Geometry(), jnp.asarray(theta))
    fn = pt.dhat_dag_packed if dagger else pt.dhat_packed
    want = np.asarray(fn(E_j, O_j, pt.pack_even(jnp.asarray(v)), 0.1, Nth))
    E, O = _port_planes(theta)
    port = tr.dhat_dag if dagger else tr.dhat
    got = port(E, O, tr.to_planar(torch.from_numpy(v)), 0.1)
    np.testing.assert_allclose(tr.to_jax_packed(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_gauge_action_and_plaquette_match_jax(rng, Nx, Nt):
    theta = _theta(rng, Nx, Nt)
    E_j, O_j = pt.pack_chains(Geometry(), jnp.asarray(theta))
    E, O = _port_planes(theta)
    np.testing.assert_allclose(
        gauge.gauge_action(E, O, 2.0).numpy(),
        np.asarray(pt.gauge_action_packed(E_j, O_j, 2.0, C, Nt // 2)),
        rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(
        gauge.plaquette_sum(E, O).numpy(),
        np.asarray(pt.plaquette_sum_packed(E_j, O_j, C, Nt // 2)),
        rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_staple_force_matches_jax_planes(rng, Nx, Nt):
    Nth = Nt // 2
    theta = _theta(rng, Nx, Nt, scale=2 * np.pi)
    E_j, O_j = pt.pack_chains(Geometry(), jnp.asarray(theta))
    ue_j, uo_j = pt.links_from_theta(E_j, O_j, Nth)
    mask_e, mask_o = pt.parity_masks(Nx)
    (f0e, f1e), (f0o, f1o) = pt.gauge_force_planes(
        ue_j, uo_j, mask_e, mask_o, pt.lane_tshifts(C * Nth, Nth), 2.7)
    FE, FO = gauge.gauge_force_planes(*gauge.links(*_port_planes(theta)), 2.7)
    for got, want in ((FE, (f0e, f1e)), (FO, (f0o, f1o))):
        np.testing.assert_allclose(tr.to_jax_packed(got),
                                   np.stack([np.asarray(w) for w in want]),
                                   rtol=0, atol=2e-5)


# ---------- f64 against the per-site NumPy oracle ----------

def _oracle_dhat(U, v_e, m0, dagger=False):
    """Dhat (or Dhat^+) of an even-packed spinor through the full-lattice
    oracle D: the Schur complement D_ee - D_eo D_oo^{-1} D_oe, D_oo = m."""
    Nth = v_e.shape[-1]
    m = m0 + 2.0
    D = ref.dirac_dagger_ref if dagger else ref.dirac_ref
    z = np.zeros_like(v_e)
    full = eo.unpack(torch.from_numpy(v_e), torch.from_numpy(z)).numpy()
    y_o = eo.pack(torch.from_numpy(D(U, full, m0)), eo.ODD).numpy()
    w = eo.unpack(torch.from_numpy(z), torch.from_numpy(-y_o / m)).numpy()
    z_e = eo.pack(torch.from_numpy(D(U, w, m0)), eo.EVEN).numpy()
    assert z_e.shape[-1] == Nth
    return m * v_e + z_e


@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_f64_operators_match_oracle(rng, Nx, Nt):
    Nth = Nt // 2
    m0 = 0.1
    theta = rng.uniform(-np.pi, np.pi, (1, 2, Nx, Nt))
    v = (rng.standard_normal((1, 2, Nx, Nth))
         + 1j * rng.standard_normal((1, 2, Nx, Nth)))
    U = np.exp(1j * theta[0])
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    ue, uo = gauge.links(thE, thO, torch.complex128)
    vt = torch.from_numpy(v)
    for dagger, fn in ((False, eo.dhat), (True, eo.dhat_dag)):
        got = fn(ue, uo, vt, m0)[0].numpy()
        want = _oracle_dhat(U, v[0], m0, dagger)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    # plaquette and staple force
    pe, po = gauge.plaquette_planes(ue, uo)
    P = eo.unpack(pe, po)[0].numpy()
    np.testing.assert_allclose(P, ref.plaquette_ref(U), rtol=0, atol=1e-12)
    FE, FO = gauge.gauge_force_planes(ue, uo, 2.0)
    want_g = -2.0 * np.imag(U * np.conj(ref.staples_ref(U)))
    np.testing.assert_allclose(eo.unpack(FE, FO)[0].numpy(), want_g,
                               rtol=0, atol=1e-12)

    # fermion force: 2c f(x = psi (+) b, y = a (+) chi') on the full lattice
    _, c = eo.mass_terms(m0)
    chi = eo.dhat_dag(ue, uo, vt, m0)
    off_o = eo.row_offset(Nx, eo.ODD)
    a_o = eo.hop(uo, ue, chi, off_o)
    b_o = eo.hop_dag(uo, ue, vt, off_o)
    FE, FO = eo.fermion_force_planes(ue, uo, vt, chi, m0)
    left = eo.unpack(vt, b_o)[0].numpy()
    right = eo.unpack(chi, a_o)[0].numpy()
    np.testing.assert_allclose(eo.unpack(FE, FO)[0].numpy(),
                               2 * c * ref.fermion_force_ref(U, left, right),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("Nx,Nt", SHAPES)
def test_observables_match_jax(rng, Nx, Nt):
    """Plaquette, gauge action density and topological charge per chain,
    f64, against schwingermodel_tpu/observables.py."""
    from schwingermodel_tpu import observables as jobs
    from schwingermodel_tpu.config import HMCParams, LatticeParams
    from schwingermodel_tpu.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch import observables as obs

    theta = rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt))
    model = SchwingerModel(lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float64"),
                           hmc=HMCParams(beta=2.5, m0=0.1))
    th = torch.from_numpy(theta)
    got = {"P": obs.mean_plaquette(th), "gS": obs.gauge_action_density(th, 2.5),
           "Q": obs.topological_charge(th)}
    for c in range(C):
        tj = jnp.asarray(theta[c])
        want = {"P": jobs.mean_plaquette(model, tj),
                "gS": jobs.gauge_action_density(model, tj),
                "Q": jobs.topological_charge(model, tj)}
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k][c]), float(w), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["Q"].numpy(), np.round(got["Q"].numpy()),
                               rtol=0, atol=1e-9)
