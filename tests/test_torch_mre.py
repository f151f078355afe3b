"""K3's MRE forecast (``--mre-history K``, K >= 2) of the PyTorch port.

The JAX packed refined path, the only place JAX runs MRE, compiles its
double-float kernels only on the TPU (tests/test_torch_refined.py), so the
port is held against:

- a NumPy transcription of the forecast of
  ``schwingermodel_tpu/ops/pallas_df.py:454-492`` (below, the lines cited),
  in f32 and in f64: x0 to 1e-4 (f32) and 1e-12 (f64) of ||x0||; a history
  of K copies of one vector gives x0 = that vector exactly, in both;
- the solver contract on the history of tests_tpu/test_tpu_resident.py:
  444-478 (the certified solution, a copy scaled by 1.001, b, zeros): the
  complex128 true residual of tests/reference_impl.py's operator under
  1e-10 ||b||, in no more iterations than the solve from b;
- one K = 4 trajectory against JAX's x64 refined sampler
  (``hmc/sampler.trajectory_given_noise``) on the same NumPy noise, at the
  f32 gates of ROADMAP.md: dH to 5e-3, the same decision, theta' to 2e-4;
- the history the packed trajectory keeps (``hmc/packed.py:213-236``):
  K copies of Phi before the first force solve, each solution pushed
  newest first with no "no history yet" copy, every force solve and the
  action solve over the whole history.

The CUDA prologue of K3 is held against the same plain twin on the card by
tests/test_torch_card_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc.sampler import trajectory_given_noise
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel as TorchModel
from schwingermodel_tpu_torch.ops import eo
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from tests import reference_impl as ref

torch.set_num_threads(1)

M0 = 0.1
C, NX, NT = 2, 8, 8


def _oracle_normal(theta, v):
    """(Dhat Dhat^+) v in complex128 from the full-lattice oracle D of one
    chain: theta [2, Nx, Nt], v even-packed complex [2, Nx, Nth]."""
    U = np.exp(1j * theta.astype(np.float64))
    m = M0 + 2.0

    def schur(v_e, D):
        z = np.zeros_like(v_e)
        full = eo.unpack(torch.from_numpy(v_e), torch.from_numpy(z)).numpy()
        y_o = eo.pack(torch.from_numpy(D(U, full, M0)), eo.ODD).numpy()
        w = eo.unpack(torch.from_numpy(z), torch.from_numpy(-y_o / m)).numpy()
        return m * v_e + eo.pack(torch.from_numpy(D(U, w, M0)), eo.EVEN).numpy()

    return schur(schur(v.astype(np.complex128), ref.dirac_dagger_ref), ref.dirac_ref)


def _numpy_forecast(theta, b, hist, real):
    """pallas_df.py:454-492 for one chain in NumPy, every value in `real`
    (np.float32 or np.float64): b, hist[i] planar [2, 2, Nx, Nth]. The
    operator apply_A (:422-426) is the oracle's, rounded to `real`."""
    def apply_A(v):                                   # :422-426
        out = _oracle_normal(theta, v[:, 0] + 1j * v[:, 1])
        return np.stack([out.real, out.imag], axis=1).astype(real)

    def dot_pc(u, v):                                 # pallas_traj.py:246-253
        return np.sum(u * v, dtype=real)              # Re<u, v> of the planes

    one = real(1.0)
    tiny = real(np.finfo(real).tiny)
    b = b.astype(real)
    hist = hist.astype(real)
    base = hist[0]                                    # :469
    w0 = apply_A(base)                                # :470
    r1 = one * b + (-one) * w0                        # :471
    x0 = base                                         # :472
    vs, ws = [], []
    nrm_max = None
    for i in range(1, len(hist)):                     # :475
        hi = hist[i]
        v = one * hi + (-one) * base                  # :479
        w = one * apply_A(hi) + (-one) * w0           # :480
        for vj, wj in zip(vs, ws):                    # :481-484
            cij = dot_pc(w, wj)
            w = one * w + (-cij) * wj
            v = one * v + (-cij) * vj
        nrm = dot_pc(w, w)                            # :485
        nrm_max = nrm if nrm_max is None else np.maximum(nrm_max, nrm)
        keep = nrm > real(1e-8) * nrm_max             # :490
        inv = (one / np.sqrt(np.maximum(nrm, tiny))).astype(real) if keep \
            else real(0.0)                            # :491-493
        w = inv * w
        v = inv * v
        x0 = one * x0 + dot_pc(r1, w) * v             # :496
        vs.append(v)
        ws.append(w)
    return x0


def _system(rng, n=C):
    theta = rng.uniform(-np.pi, np.pi, (n, 2, NX, NT)).astype(np.float32)
    b = rng.standard_normal((n, 2, 2, NX, NT // 2)).astype(np.float32)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    return theta, b, thE, thO, torch.from_numpy(b)


def _walk_history(rng, thE, thO, bp, K=4):
    """K solutions of slowly moving systems, newest first: the certified
    solution of (thE, thO, b) and of the angles moved back by 0.01 steps,
    as an MD trajectory leaves them."""
    step = 0.01 * torch.from_numpy(rng.standard_normal(thE.shape).astype(np.float32))
    hist = [rs.solve_refined(thE - k * step, thO - k * step, bp, bp, m0=M0,
                             tol=1e-10).x for k in range(K)]
    return torch.stack(hist)


@pytest.mark.parametrize("history", ["walk", "tpu"])
@pytest.mark.parametrize("real,rtol", [(np.float32, 1e-4), (np.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_forecast_matches_numpy_transcription(rng, real, rtol, history):
    """mre_forecast_reference (the twin of K3's prologue) against the NumPy
    transcription, per chain, in f32 and f64."""
    theta, b, thE, thO, bp = _system(rng)
    if history == "walk":
        hist = _walk_history(rng, thE, thO, bp)
    else:
        x = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=1e-10).x
        hist = torch.stack([x, 1.001 * x, bp, torch.zeros_like(bp)])
    dtype = torch.float32 if real is np.float32 else torch.float64
    got = rs.mre_forecast_reference(thE, thO, bp.to(dtype), hist.to(dtype), m0=M0)
    assert got.dtype == dtype
    for c in range(C):
        want = _numpy_forecast(theta[c], b[c], hist[:, c].numpy(), real)
        err = np.linalg.norm(got[c].numpy() - want) / np.linalg.norm(want)
        assert err <= rtol, (c, err)
        # the forecast moved the start: it is not hist[0] itself
        assert not np.array_equal(want, hist[0, c].numpy().astype(real))


def test_duplicate_history_gives_the_base_exactly(rng):
    """K copies of one vector (the history at the start of every
    trajectory): every direction is dropped (|w|^2 = 0 is not above 1e-8 of
    the largest, 0), so x0 is the vector bit for bit, in the transcription,
    in the twin and through the solve (max_iter=0 returns the start)."""
    theta, b, thE, thO, bp = _system(rng)
    x = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=1e-8).x
    hist = torch.stack([x] * 4)
    assert torch.equal(rs.mre_forecast_reference(thE, thO, bp, hist, m0=M0), x)
    for c in range(C):
        np.testing.assert_array_equal(
            _numpy_forecast(theta[c], b[c], hist[:, c].numpy(), np.float32), x[c])
    start = rs.solve_refined(thE, thO, bp, hist, m0=M0, tol=1e-10, max_iter=0)
    assert torch.equal(start.x, x)


def test_history_of_one_is_the_start(rng):
    """K = 1 (a history [1, C, ...]) starts from hist[0]: the solve is the
    one from that start, bit for bit."""
    _, _, thE, thO, bp = _system(rng)
    x0 = 0.5 * bp
    a = rs.solve_refined(thE, thO, bp, x0, m0=M0, tol=1e-10)
    h = rs.solve_refined(thE, thO, bp, x0[None], m0=M0, tol=1e-10)
    assert torch.equal(a.x64, h.x64) and torch.equal(a.iters, h.iters)


def test_solve_over_the_tpu_history_meets_the_contract(rng):
    """tests_tpu/test_tpu_resident.py:444-478's history: the certified
    solution, 1.001 times it, b and zeros. The solve from its forecast meets
    1e-10 on the oracle residual and takes no more iterations than the solve
    from b; the forecast itself is within 1e-6 of the solution."""
    theta, b, thE, thO, bp = _system(rng)
    base = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=1e-10)
    hist = torch.stack([base.x, 1.001 * base.x, bp, torch.zeros_like(bp)])
    sol = rs.solve_refined(thE, thO, bp, hist, m0=M0, tol=1e-10)
    assert bool(sol.converged.all()) and bool(base.converged.all())
    xc = tr.to_complex(sol.x64).numpy()
    for c in range(C):
        bc = b[c, :, 0] + 1j * b[c, :, 1]
        r = bc - _oracle_normal(theta[c], xc[c])
        assert np.linalg.norm(r) < 1e-10 * np.linalg.norm(bc)
    assert (sol.iters <= base.iters).all(), (sol.iters, base.iters)
    x0 = rs.mre_forecast_reference(thE, thO, bp, hist, m0=M0)
    assert ((x0 - base.x).flatten(1).norm(dim=1)
            <= 1e-6 * base.x.flatten(1).norm(dim=1)).all()


def _models(K, md=4):
    jm = SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=M0, even_odd=True, md_steps=md,
                      trajectory_length=1.0, mre_history=K, packed=True,
                      cg=CGParams(tol=1e-10, max_iter=10000, refine=True,
                                  refine_impl="x64", inner_tol=1e-5)))
    lat, hmc, _ = from_jax_config(jm.lattice, jm.hmc)
    return jm, TorchModel(lattice=lat, hmc=hmc)


def _noise(rng):
    theta = rng.uniform(-np.pi, np.pi, (C, 2, NX, NT)).astype(np.float32)
    pi = rng.standard_normal((C, 2, NX, NT)).astype(np.float32)
    chi = ((rng.standard_normal((C, 2, NX, NT // 2))
            + 1j * rng.standard_normal((C, 2, NX, NT // 2))) / np.sqrt(2)
           ).astype(np.complex64)
    r = rng.uniform(0.0, 1.0, C).astype(np.float32)
    return theta, pi, chi, r


def test_mre_trajectory_matches_jax_x64_sampler(rng):
    """One trajectory with --mre-history 4 (every solve from K3's MRE
    forecast) against JAX's x64 refined sampler on the same NumPy noise, at
    the f32 gates; the same trajectory with K = 0 (the second-order
    forecast) meets them too, with its CG iterations beside."""
    jm, tm = _models(4)
    assert hp.uses_mre(tm) and hp.packed_eligible(tm)
    theta, pi, chi, r = _noise(rng)
    th_ref, st_ref = jax.vmap(lambda t, p, c, u: trajectory_given_noise(jm, t, p, c, u))(
        *(jnp.asarray(a) for a in (theta, pi, chi, r)))
    th_ref, dh_ref = np.asarray(th_ref), np.asarray(st_ref.delta_H)
    iters = {}
    for K in (4, 0):
        model = dataclasses.replace(
            tm, hmc=dataclasses.replace(tm.hmc, mre_history=K))
        th, st = hp.trajectory_packed_given_noise(
            model, *(torch.from_numpy(a) for a in (theta, pi, chi, r)))
        assert bool(st.cg_converged.all())
        np.testing.assert_allclose(st.delta_H.numpy(), dh_ref, rtol=0, atol=5e-3)
        np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(st_ref.accepted))
        d = np.remainder(th.numpy() - th_ref + np.pi, 2 * np.pi) - np.pi
        assert np.abs(d).max() <= 2e-4
        iters[K] = st.cg_iters.tolist()
    assert all(n > 0 for n in iters[4] + iters[0]), iters


@pytest.mark.parametrize("integrator,md,n_force", [("leapfrog", 5, 4),
                                                   ("omelyan", 2, 4)])
def test_packed_trajectory_keeps_the_mre_history(rng, integrator, md, n_force):
    """The history of hmc/packed.py:213-236, 282-302, 389-392, 441-444: the
    first force solve sees K copies of Phi; each later solve's history is
    the previous solutions, newest first (fc_push), with no copy after the
    first force solve; the action solve sees the last K force solutions."""
    _, tm = _models(3, md)
    tm = dataclasses.replace(tm, hmc=dataclasses.replace(tm.hmc, integrator=integrator))
    theta, pi, chi, r = _noise(rng)
    calls, solve = [], rs.solve_refined

    def recorded(thE, thO, b, x0, **kw):
        out = solve(thE, thO, b, x0, **kw)
        calls.append((b, x0, out.x))
        return out
    rs.solve_refined = recorded
    try:
        hp.trajectory_packed_given_noise(
            tm, *(torch.from_numpy(a) for a in (theta, pi, chi, r)))
    finally:
        rs.solve_refined = solve
    assert len(calls) == n_force + 1
    phi = calls[0][0]
    sols = []
    for b, hist, x in calls:
        assert hist.shape == (3, C, 2, 2, NX, NT // 2)
        want = (sols[::-1] + [phi] * 3)[:3]
        for got, w in zip(hist, want):
            assert torch.equal(got, w)
        sols.append(x)
