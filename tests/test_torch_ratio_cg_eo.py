"""K5 (the Hasenbusch ratio force) and K6 (the f32 CG on given links) as
their shared-memory kernels run them.

- K5's shared path runs K1's force body once, on Y = c0 chi' - c1 phi2,
  in place of the two bilinears ff(psi, chi'; c0) - ff(psi, phi2; c1): the
  force stencil is real-linear in y. The fold is built here from the port's
  existing functions, in f64 against the plain twin and in f32 against the
  Pallas kernel in interpret mode; no second twin is in the package.
- K6's loop has no breakdown guards (pallas_eo.py:246-259): a zero
  right-hand side runs one iteration to a NaN x and stays unconverged, in
  the twin as in the Pallas kernel, and leaves every other entry as if
  solved alone.
- Both wrappers launch on the path and the blocks a chain of
  ``ops/traj.cg_path``: their launch functions run here on CPU tensors with
  the C entry replaced by a recorder, so a wrapper that stops following the
  rule fails without a card.

The CUDA kernels are held against the same twins on the card by
tests/test_torch_card_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu.ops.geometry import Geometry
from schwingermodel_tpu.ops.pallas_eo import cg_solve_eo_fused
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import _cuda, cg_eo, eo, gauge
from schwingermodel_tpu_torch.ops import traj as tr

torch.set_num_threads(1)

BETA = 2.0


def _theta(rng, C, Nx, Nt, dtype=np.float64):
    return rng.uniform(-2 * np.pi, 2 * np.pi, (C, 2, Nx, Nt)).astype(dtype)


def _cspinor(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _folded_force(thE, thO, psi, phi2, m0, m1, beta):
    """K5's shared-path arithmetic from the port's functions: one force
    stencil at the light mass on y = chi' - (c1/c0) phi2 (its 2 c0 prefactor
    makes c0 chi' - c1 phi2 of it), plus the staples."""
    ue, uo = gauge.links(thE, thO)
    psi_c = tr.to_complex(psi)
    chi_p = eo.dhat_dag(ue, uo, psi_c, m0)
    (_, c0), (_, c1) = eo.mass_terms(m0), eo.mass_terms(m1)
    FE, FO = eo.fermion_force_planes(ue, uo, psi_c,
                                     chi_p - (c1 / c0) * tr.to_complex(phi2), m0)
    gfe, gfo = gauge.gauge_force_planes(ue, uo, beta)
    return FE + gfe, FO + gfo


# ---------- K5: the fold ----------

@pytest.mark.parametrize("m0,m1", [(-0.19, 0.21), (0.2, 0.6)])
@pytest.mark.parametrize("Nx,Nt", [(8, 8), (8, 12)])
def test_folded_ratio_force_equals_twin_f64(rng, Nx, Nt, m0, m1):
    """In f64 the folded force equals ratio_force_reference (the two
    bilinears) to 1e-12 of the force's size."""
    C = 2
    thE, thO = tr.pack_planes(torch.from_numpy(_theta(rng, C, Nx, Nt)))
    psi, phi2 = (tr.to_planar(torch.from_numpy(_cspinor(rng, (C, 2, Nx, Nt // 2))))
                 for _ in range(2))
    FE, FO = _folded_force(thE, thO, psi, phi2, m0, m1, BETA)
    RE, RO = tr.ratio_force_reference(thE, thO, psi, phi2, m0=m0, m1=m1, beta=BETA)
    assert FE.dtype == torch.float64
    scale = max(RE.abs().max().item(), RO.abs().max().item())
    err = max((FE - RE).abs().max().item(), (FO - RO).abs().max().item())
    assert err <= 1e-12 * scale, (err, scale)


@pytest.mark.parametrize("m0,m1", [(-0.19, 0.21), (0.2, 0.6)])
def test_folded_ratio_force_matches_pallas_f32(rng, m0, m1):
    """In f32 at 8x8 the folded force is within the port's force tolerance,
    3e-5 max(scale, 1), of pallas_traj.ratio_force_fused (interpret)."""
    C, Nx, Nt = 2, 8, 8
    theta = _theta(rng, C, Nx, Nt, np.float32)
    psi, phi2 = (_cspinor(rng, (C, 2, Nx, Nt // 2), np.complex64) for _ in range(2))
    E, O = pt.pack_chains(Geometry(), jnp.asarray(theta))
    FE_j, FO_j = pt.ratio_force_fused(E, O, pt.pack_even(jnp.asarray(psi)),
                                      pt.pack_even(jnp.asarray(phi2)), m0=m0, m1=m1,
                                      beta=BETA, Nth=Nt // 2, interpret=True)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    FE, FO = _folded_force(thE, thO, tr.to_planar(torch.from_numpy(psi)),
                           tr.to_planar(torch.from_numpy(phi2)), m0, m1, BETA)
    assert FE.dtype == torch.float32
    FE_j, FO_j = np.asarray(FE_j), np.asarray(FO_j)
    scale = max(np.abs(FE_j).max(), np.abs(FO_j).max())
    for got, want in ((FE, FE_j), (FO, FO_j)):
        np.testing.assert_allclose(tr.to_jax_packed(got), want, rtol=0,
                                   atol=3e-5 * max(scale, 1.0))


# ---------- K6: the loop without guards ----------

def test_cg_solve_eo_zero_rhs_runs_one_iteration_like_pallas(rng):
    """One zero right-hand side among random ones: the twin and the Pallas
    kernel (interpret) both run it 1 iteration to a non-finite x,
    unconverged; every other entry equals its solve alone, bit for bit."""
    C, B, Nx, Nt, m0, tol = 2, 2, 8, 8, 0.2, 1e-6
    theta = _theta(rng, C, Nx, Nt, np.float32)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    bc = _cspinor(rng, (C, B, 2, Nx, Nt // 2), np.complex64)
    bc[1, 0] = 0
    b = tr.to_planar(torch.from_numpy(bc))
    x0 = torch.zeros_like(b)
    got = cg_eo.cg_solve_eo(ue, uo, b, x0, m0=m0, tol=tol, max_iter=500)
    np.testing.assert_array_equal(got.converged.numpy(), [[True, True], [False, True]])
    assert int(got.iters[1, 0]) == 1
    assert not bool(torch.isfinite(got.x[1, 0]).any())
    for c, j in ((0, 0), (0, 1), (1, 1)):
        alone = cg_eo.cg_solve_eo(ue[c:c + 1], uo[c:c + 1], b[c:c + 1, j:j + 1],
                                  x0[c:c + 1, j:j + 1], m0=m0, tol=tol, max_iter=500)
        assert torch.equal(alone.x[0, 0], got.x[c, j])
        assert int(alone.iters) == int(got.iters[c, j])
        assert bool(torch.isfinite(got.x[c, j]).all())

    jmodel = JaxModel(lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32"),
                      hmc=HMCParams(beta=BETA, m0=m0, even_odd=True, fused_cg=True,
                                    cg=CGParams(tol=tol, max_iter=500)))
    ops = jmodel.eo_ops(jnp.asarray(theta[1]))
    want = cg_solve_eo_fused(ops.Ue, ops.Uo, jnp.asarray(bc[1, 0]),
                             jnp.zeros_like(jnp.asarray(bc[1, 0])), m0=m0, tol=tol,
                             max_iter=500, interpret=True)
    assert int(want.iters) == 1 and not bool(want.converged)
    assert not np.isfinite(np.asarray(want.x)).any()


# ---------- the paths the wrappers launch on ----------

class _Recorder:
    """Stands in for _cuda.KERNELS.call: keeps each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_cuda.KERNELS, "call", rec)
    return rec


@pytest.mark.parametrize("Nx,Nt,C,B,path", [
    (64, 64, 32, 8, tr.CG_SHARED),     # the condensate's 256 entries
    (64, 64, 32, 1, tr.CG_SHARED),     # the unpacked sampler's solves
    (32, 32, 32, 8, tr.CG_SHARED),
    (128, 128, 2, 2, tr.CG_GLOBAL),
    (126, 128, 2, 2, tr.CG_GLOBAL)])
def test_cg_solve_eo_launches_on_k2s_path(recorder, Nx, Nt, C, B, path):
    """K6 launches on cg_path's path for C*B entries with the solve (K2's
    rule), with a scratch only on the global path."""
    Nth = Nt // 2
    assert tr.cg_path(Nx, Nth, C * B, 132) == (path, 1)
    links = torch.zeros((C, 2, 2, Nx, Nth))
    b = torch.zeros((C, B, 2, 2, Nx, Nth))
    cg_eo._launch(links, links, b, b, 0.2, 1e-6, 100, 132)
    (name, args), = recorder.calls
    assert name == "cg_eo_launch"
    assert args[9:13] == (C, B, Nx, Nth)
    assert args[-1] == path
    assert (args[8] is None) == (path == tr.CG_SHARED)


@pytest.mark.parametrize("Nx,Nt,C,path,blocks", [
    (64, 64, 32, tr.CG_SHARED, 4),     # the Hasenbusch demo
    (64, 64, 128, tr.CG_SHARED, 1),
    (32, 32, 32, tr.CG_SHARED, 4),     # the near-critical row
    (128, 128, 8, tr.CG_SHARED, 8),
    (126, 128, 2, tr.CG_GLOBAL, 1)])
def test_ratio_force_launches_on_k1s_path(recorder, Nx, Nt, C, path, blocks):
    """K5 launches on K1's path without the solve, with staples, and its
    blocks a chain, with a scratch only on the global path."""
    Nth = Nt // 2
    want = tr.cg_path(Nx, Nth, C, 132, solve=False, gauge=True)
    assert tr.ratio_force_path(Nx, Nth, C, 132) == want == (path, blocks)
    th = torch.zeros((C, 2, Nx, Nth))
    psi = torch.zeros((C, 2, 2, Nx, Nth))
    FE, FO = tr._launch_ratio(th, th, psi, psi, -0.19, 0.21, BETA, 132)
    assert FE.shape == FO.shape == th.shape
    (name, args), = recorder.calls
    assert name == "ratio_force_launch"
    assert args[7:10] == (C, Nx, Nth)
    assert args[-2:] == (path, blocks)
    assert (args[6] is None) == (path == tr.CG_SHARED)
