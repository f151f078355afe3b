"""The measurement phase as a device program, on the CPU.

On the card the condensate's Z2xZ2 noise comes from the noise kernel's Z2
mode (ops/noise.z2_noise), K6 and K9 take a per-entry mask so that the
restart refinement (solvers/refine.cg_refine) runs all its passes with no
host read, and the measurement is captured once as a CUDA graph
(hmc/program.MeasurementProgram); tests/test_torch_card_kernels.py and
tests/test_torch_card_program.py hold those against the twins and eager calls there. Here, on the plain twins: the Z2
stream's layout, invariants and moments; K6's and K9's twins with a mask
against the unmasked twins bit for bit and against JAX (K6: the Pallas
kernel in interpret mode; K9: JAX's x64 residual); the read-free
refinement against JAX's cg_refine on the contract with entries that stop
at different passes, and its pass loop on pure-torch stubs with every host
read patched to raise; the measurement program's rows against eager
calls and, with the port's Z2 noise, against JAX's condensate; run_hmc
with the condensate on the program against the eager loop; and the
critical-mass tool's device programs against its eager run. 8x8 lattices.
"""

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.ops.pallas_eo import cg_solve_eo_fused
from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams, RunParams
from schwingermodel_tpu_torch.hmc.program import MeasurementProgram
from schwingermodel_tpu_torch.ops import cg_eo, noise
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.runner import run_hmc
from schwingermodel_tpu_torch.solvers import refine
from schwingermodel_tpu_torch.tools import critical_mass as cm
from schwingermodel_tpu_torch.utils import prng
from tests.test_torch_condensate import (M0, _cspinor, _jax_condensate, _jax_model,
                                         _links, _port, _theta)

torch.set_num_threads(1)

S = np.float32(2 ** -0.5)
SITES = (2, 8, 8)


# ---------- the Z2 mode's twin ----------

def test_z2_entries_and_layout():
    """Every entry is (+-f32(2^-1/2)) + i (+-f32(2^-1/2)) exactly, and entry
    4q + k of a vector takes its signs from bits 31 and 30 of word k of the
    Philox words at counter (q, j | (meas >> 32) << 16, chain, meas mod
    2^32) under the key of the _MEAS tag."""
    seed, meas, C, off, n = 9, 2 ** 33 + 5, 2, 3, 3
    z, w = noise.z2_noise(seed, meas, C, n, SITES, "cpu", chain_offset=off, words=True)
    assert z.shape == (C, n, *SITES) and z.dtype == torch.complex64
    assert set(z.real.flatten().tolist()) == {float(S), float(-S)}
    assert set(z.imag.flatten().tolist()) == {float(S), float(-S)}
    n_groups = math.prod(SITES) // 4
    ctr = torch.tensor([[q, j | (meas >> 32) << 16, off + c, meas & 0xFFFFFFFF]
                        for c in range(C) for j in range(n) for q in range(n_groups)])
    want = prng.philox4x32_10(ctr, prng.philox_key(seed, prng._MEAS))
    assert torch.equal(w.reshape(-1, 4), want)
    bits = want.reshape(C, n, -1)
    sign = lambda b: torch.where(b == 1, -torch.tensor(S), torch.tensor(S))
    assert torch.equal(z.real.reshape(C, n, -1), sign((bits >> 31) & 1))
    assert torch.equal(z.imag.reshape(C, n, -1), sign((bits >> 30) & 1))


def test_z2_ragged_vector_drops_the_spare_words():
    """A vector of 2 * 3 * 5 = 30 entries takes 8 counters and drops the
    last group's two spare words: its entries are the first 30 of a 32-entry
    draw's words."""
    z, w = noise.z2_noise(1, 4, 2, 2, (2, 3, 5), "cpu", words=True)
    assert z.shape == (2, 2, 2, 3, 5) and w.shape == (2, 2, 8, 4)
    bits = w.reshape(2, 2, 32)[..., :30]
    re = torch.where((bits >> 31) & 1 == 1, -torch.tensor(S), torch.tensor(S))
    assert torch.equal(z.real.reshape(2, 2, 30), re)


def test_z2_chain_draw_independent_of_batch_and_index_type():
    """Chains 2-3 of a C=4 draw equal a C=2 draw at chain_offset 2, and a
    0-d int64 tensor index draws what the int does."""
    whole = noise.z2_noise(5, 7, 4, 3, SITES, "cpu")
    part = noise.z2_noise(5, 7, 2, 3, SITES, "cpu", chain_offset=2)
    assert torch.equal(whole[2:], part)
    for meas in (0, 7, 2 ** 40 + 1):
        a = noise.z2_noise(5, meas, 3, 2, SITES, "cpu", chain_offset=1, words=True)
        b = noise.z2_noise(5, torch.tensor(meas), 3, 2, SITES, "cpu", chain_offset=1,
                           words=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_z2_shares_no_counter_with_the_trajectories_or_other_measurements():
    """Distinct (measurement, chain, vector, group) give distinct counters,
    the measurement's high word included; the _MEAS key differs from the
    trajectory stream's under every seed, so no (key, counter) of the two
    streams coincide; neighbouring measurements, chains and vectors differ."""
    ctrs = [prng.z2_counters(m, 3, off, 4, 32, "cpu")
            for m in (0, 1, 2 ** 32, 2 ** 32 + 1) for off in (0, 3)]
    flat = torch.cat([c.reshape(-1, 4) for c in ctrs])
    assert (flat >= 0).all() and (flat <= 0xFFFFFFFF).all()
    assert torch.unique(flat, dim=0).shape[0] == flat.shape[0]
    for seed in (0, 1, 2 ** 32, 2 ** 55):
        assert prng.philox_key(seed, prng._MEAS) != prng.philox_key(seed, prng._TRAJ)
    traj = prng.trajectory_counters(0, 3, 0, 64, 64, "cpu").reshape(-1, 4)
    pairs = {(prng._TRAJ, *c) for c in traj.tolist()}
    pairs |= {(prng._MEAS, *c) for c in flat.tolist()}
    assert len(pairs) == traj.shape[0] + flat.shape[0]
    z = noise.z2_noise(0, 0, 2, 2, SITES, "cpu")
    assert not torch.equal(z[0], z[1]) and not torch.equal(z[0, 0], z[0, 1])
    assert not torch.equal(z, noise.z2_noise(0, 1, 2, 2, SITES, "cpu"))


@pytest.mark.parametrize("meas,n_noise", [(-1, 2), (2 ** 48, 2), (0, 0), (0, 2 ** 16)])
def test_z2_refuses_what_the_layout_cannot_count(meas, n_noise):
    with pytest.raises(ValueError):
        noise.z2_noise(0, meas, 1, n_noise, SITES, "cpu")


def test_z2_moments():
    """Over 256 chains x 4 vectors of one measurement: each part's mean 0
    and the entries' E[z z'^*] between neighbours 0 within 5 sigma, E|z|^2
    = 1 exactly, E[z^2] (re^2 - im^2 + 2i re im) 0 within 5 sigma."""
    z = noise.z2_noise(3, 11, 256, 4, SITES, "cpu").to(torch.complex128).flatten()
    n = z.numel()
    tol = 5 / math.sqrt(n)
    assert abs(z.real.mean().item()) < tol * S and abs(z.imag.mean().item()) < tol * S
    assert torch.allclose((z.abs() ** 2).mean(), torch.tensor(1.0, dtype=torch.float64),
                          rtol=0, atol=1e-7)
    assert abs((z[1:] * z[:-1].conj()).mean()) < tol
    assert abs((z * z).mean()) < tol


# ---------- K6 and K9 with a mask ----------

MASK = torch.tensor([[True, False], [False, True], [True, True]])


def test_k6_twin_with_a_mask(rng):
    """C=3, B=2 from a random x0, tol 1e-5: the active entries bit for bit
    the unmasked twin's and, against the Pallas kernel in interpret mode
    (as test_torch_condensate's K6b test), flags equal, iterations within
    1, x to atol 1e-5 rtol 1e-4; the inactive entries x = x0, 0
    iterations, unconverged."""
    C, B = 3, 2
    jmodel = _jax_model()
    theta = _theta(rng, C)
    v = _cspinor(rng, (C, B, 2, 8, 4))
    x0c = _cspinor(rng, (C, B, 2, 8, 4))

    def system(th, vv):
        ops = jmodel.eo_ops(th)
        return ops.Ue, ops.Uo, ops.dhat(vv)

    Ue, Uo, b = jax.vmap(jax.vmap(system, (None, 0)), (0, 0))(
        jnp.asarray(theta), jnp.asarray(v))
    _, _, ue, uo = _links(theta)
    bp = tr.to_planar(torch.from_numpy(np.array(b)))
    x0 = tr.to_planar(torch.from_numpy(x0c))
    kw = dict(m0=M0, tol=1e-5, max_iter=500)
    masked = cg_eo.cg_solve_eo(ue, uo, bp, x0, active=MASK, **kw)
    full = cg_eo.cg_solve_eo(ue, uo, bp, x0, **kw)
    for c in range(C):
        for j in range(B):
            if not MASK[c, j]:
                assert torch.equal(masked.x[c, j], x0[c, j])
                assert int(masked.iters[c, j]) == 0 and not bool(masked.converged[c, j])
                continue
            assert torch.equal(masked.x[c, j], full.x[c, j])
            assert int(masked.iters[c, j]) == int(full.iters[c, j])
            assert bool(masked.converged[c, j]) == bool(full.converged[c, j]) is True
            want = cg_solve_eo_fused(Ue[c, j], Uo[c, j], b[c, j], jnp.asarray(x0c[c, j]),
                                     m0=M0, tol=1e-5, max_iter=500, interpret=True)
            assert bool(want.converged)
            assert abs(int(masked.iters[c, j]) - int(want.iters)) <= 1
            np.testing.assert_allclose(tr.to_complex(masked.x)[c, j].numpy(),
                                       np.asarray(want.x), atol=1e-5, rtol=1e-4)


def test_k9_twin_with_a_mask(rng):
    """C=3, B=2: with a mask the twin writes the active entries into the
    buffers given, bit for bit the unmasked twin's and within 1e-12 of
    JAX's x64 b - A x, and leaves the others as they were; a mask without
    buffers is refused."""
    C, B = 3, 2
    jmodel = _jax_model()
    theta = _theta(rng, C)
    thE, thO, _, _ = _links(theta)
    bc = _cspinor(rng, (C, B, 2, 8, 4))
    xc = (rng.standard_normal((C, B, 2, 8, 4))
          + 1j * rng.standard_normal((C, B, 2, 8, 4)))
    bp, xp = tr.to_planar(torch.from_numpy(bc)), tr.to_planar(torch.from_numpy(xc))
    r_full, n_full = rs.residual_f64(thE, thO, bp, xp, m0=M0)
    out = (torch.full_like(r_full, 7.0), torch.full_like(n_full, -1.0))
    r, n = rs.residual_f64(thE, thO, bp, xp, m0=M0, active=MASK, out=out)
    assert r is out[0] and n is out[1]
    rc = tr.to_complex(r).numpy()
    for c in range(C):
        ops = jeo.EOOperators(jmodel.geom, jmodel.fermion_links_hi(jnp.asarray(theta[c])), M0)
        for j in range(B):
            if not MASK[c, j]:
                assert bool((r[c, j] == 7.0).all()) and float(n[c, j]) == -1.0
                continue
            assert torch.equal(r[c, j], r_full[c, j]) and torch.equal(n[c, j], n_full[c, j])
            want = np.asarray(jnp.asarray(bc[c, j]).astype(jnp.complex128)
                              - ops.normal(jnp.asarray(xc[c, j])))
            assert np.abs(rc[c, j] - want).max() <= 1e-12 * np.abs(want).max()
    with pytest.raises(ValueError, match="mask"):
        rs.residual_f64(thE, thO, bp, xp, m0=M0, active=MASK)


# ---------- the refinement without host reads ----------

def _recording(kernels, masks):
    def cg(*a, active=None, **k):
        masks.append(active.clone())
        return kernels.cg(*a, active=active, **k)
    return refine.EOKernels(cg, kernels.residual, kernels.fallback)


@pytest.mark.parametrize("fallback", [False, True])
def test_refinement_entries_stop_at_different_passes(fallback):
    """A cold, a smooth and a hot configuration of B=2 (the cold one's
    second right-hand side constant), inner_tol 0.03: the entries stop after
    different numbers of passes, every one of the 8 passes launches K6 (its
    twin here) masked, and on the contract against JAX's refinement
    (model._solve_eo_refined, K6 in interpret mode): flags equal, x within
    1e-8 relative, the f64 true residual below 1e-10 ||b||."""
    rng = np.random.default_rng(1)
    C, B = 3, 2
    theta = _theta(rng, C)
    theta[0] = 0.0
    theta[1] *= 0.2
    b = _cspinor(rng, (C, B, 2, 8, 4))
    b[0, 1] = 1.0
    jmodel = _jax_model(inner_tol=0.03, fallback=fallback)
    masks = []
    got = refine.cg_refine(*_links(theta), tr.to_planar(torch.from_numpy(b)), m0=M0,
                           tol=1e-10, inner_tol=0.03, max_iter=10000, max_outer=8,
                           fallback=fallback, kernels=_recording(refine.PLAIN, masks))
    passes = torch.stack(masks).sum(dim=0)
    print("passes per entry", passes.tolist(), "iterations", got.iters.tolist())
    assert len(masks) == 8 and len(set(passes.flatten().tolist())) > 1
    assert bool(got.converged.all())
    xg = tr.to_complex(got.x64).numpy()
    for c in range(C):
        th = jnp.asarray(theta[c])
        ops = jmodel.eo_ops(th)
        for j in range(B):
            want = jmodel._solve_eo_refined(th, ops, jnp.asarray(b[c, j]))[0]
            assert bool(want.converged)
            xw = np.asarray(want.x)
            assert np.linalg.norm(xg[c, j] - xw) < 1e-8 * np.linalg.norm(xw)
            ops_hi = jeo.EOOperators(jmodel.geom, jmodel.fermion_links_hi(th), M0)
            rr = np.asarray(jnp.asarray(b[c, j]).astype(jnp.complex128)
                            - ops_hi.normal(jnp.asarray(xg[c, j])))
            assert np.linalg.norm(rr) < 1e-10 * np.linalg.norm(b[c, j])


def _stub(a, b, eps):
    """A diagonal system a x = b per entry (f64 rows) and an inner solve
    d = r / (a (1 + eps)) whose error eps differs per entry: the callees of
    _refine_passes, in pure torch. Returns (residual, inner)."""

    def residual(x, active=None, out=None):
        r = b - a * x
        rho = (r * r).sum(-1)
        if out is None:
            return r, rho
        out[0].copy_(torch.where(active[:, None], r, out[0]))
        out[1].copy_(torch.where(active, rho, out[1]))
        return out

    def inner(r, active):
        return r / (a * (1.0 + eps[:, None])), torch.full(eps.shape, 3, dtype=torch.int32)

    return residual, inner


def _stub_problem():
    """Six entries of 5 unknowns whose inner errors make them converge
    (eps 1e-3 .. 0.3), stagnate (eps 1.5: rho contracts by 0.36 a pass)
    or run out of passes (0.6)."""
    g = torch.Generator().manual_seed(0)
    a = 1.0 + torch.rand((6, 5), generator=g, dtype=torch.float64)
    b = torch.randn((6, 5), generator=g, dtype=torch.float64)
    eps = torch.tensor([1e-3, 0.05, 0.3, 0.6, 1.5, 0.01], dtype=torch.float64)
    return a, b, eps, 1e-20 * (b * b).sum(-1)


def _host_loop(a, b, eps, stop2, max_outer):
    """The refinement entry by entry with Python control flow, as JAX's
    per-entry while_loop runs it: (x, rho, iterations)."""
    xs, rhos, its = [], [], []
    for e in range(a.shape[0]):
        residual, inner = _stub(a[e:e + 1], b[e:e + 1], eps[e:e + 1])
        x = torch.zeros_like(b[e:e + 1])
        r, rho = residual(x)
        rho, prev, k, it = rho.item(), math.inf, 0, 0
        while rho >= stop2[e].item() and k < max_outer and (k == 0 or rho * 4 <= prev):
            x = x + inner(r, None)[0]
            r, rho_new = residual(x)
            prev, rho, it, k = rho, rho_new.item(), it + 3, k + 1
        xs.append(x[0])
        rhos.append(rho)
        its.append(it)
    return (torch.stack(xs), torch.tensor(rhos, dtype=torch.float64),
            torch.tensor(its, dtype=torch.int32))


def test_refine_passes_read_nothing_on_the_host(monkeypatch):
    """_refine_passes on pure-torch stubs, with Tensor.__bool__, .item and
    .tolist patched to raise: it runs, and its x, rho and iterations equal
    the loop with its early exit (one host read a pass) bit for bit, and an
    entry-by-entry loop with host control flow to 1e-12; the entries stop
    at different passes, one by stagnation."""
    a, b, eps, stop2 = _stub_problem()
    residual_fn, inner_fn = _stub(a, b, eps)
    x0 = torch.zeros_like(b)
    want = refine._refine_passes(residual_fn, inner_fn, x0, stop2, 8, early_exit=True)

    def host_read(*_a, **_k):
        raise AssertionError("host read inside the refinement's passes")

    for name in ("__bool__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    got = refine._refine_passes(residual_fn, inner_fn, x0, stop2, 8)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hx, hrho, hit = _host_loop(a, b, eps, stop2, 8)
    torch.testing.assert_close(got[0], hx, rtol=1e-12, atol=0)
    torch.testing.assert_close(got[2], hrho, rtol=1e-9, atol=1e-30)
    assert torch.equal(got[3], hit)
    assert len(set(hit.tolist())) > 2
    assert not bool((got[2] < stop2).all()) and bool((got[2] < stop2).any())


# ---------- the measurement program ----------

def test_measurement_program_rows_equal_eager_calls():
    """Three steps of the program (eager on the CPU, the counter a 0-d
    tensor) against measure_all with int indices 0, 1, 2 after each of
    three theta updates: every row bit for bit, the counter at 3."""
    model = _port(_jax_model(refine_=False, tol=1e-6))
    rng = np.random.default_rng(2)
    thetas = [torch.from_numpy(_theta(rng, 2)) for _ in range(3)]
    static = thetas[0].clone()

    def measure(th, i):
        return obs.measure_all(model, th, with_condensate=True, seed=4, meas_index=i,
                               n_noise=2)

    prog = MeasurementProgram(measure, static, 3)
    for th in thetas:
        static.copy_(th)
        prog.step()
    assert int(prog.index) == 3
    assert not prog.graphed and prog.stats()["replays"] == 0
    for i, th in enumerate(thetas):
        want = measure(th, i)
        for k, v in want.items():
            assert torch.equal(prog.out[k][i], v), k


def test_program_condensate_on_z2_noise_matches_jax():
    """The slice against the JAX package: the program's refined condensate
    rows (the Z2 noise at the counter, chain offset 3, the read-free
    refinement) against JAX's chiral_condensate_given_noise on the same
    noise (the twin at the int index): rtol 1e-5 and every flag true, as
    test_condensate_given_noise_matches_jax."""
    jmodel = _jax_model()
    model = _port(jmodel)
    theta = torch.from_numpy(_theta(np.random.default_rng(31), 2))

    def measure(th, i):
        cc = obs.chiral_condensate(model, th, 3, i, 2, chain_offset=3)
        return {"value": cc.value, "converged": cc.converged}

    prog = MeasurementProgram(measure, theta, 2)
    prog.run(2)
    for i in range(2):
        zs = obs.condensate_noise(3, i, 2, theta.shape, 2, "cpu", chain_offset=3)
        value, conv = _jax_condensate(jmodel, theta.numpy(), zs.numpy())
        assert conv.all() and bool(prog.out["converged"][i].all())
        np.testing.assert_allclose(prog.out["value"][i].numpy(), value, rtol=1e-5)


@pytest.mark.parametrize("refined", [True, False], ids=["refined", "loose"])
def test_runner_condensate_on_the_program_equals_the_eager_loop(tmp_path, refined):
    """run_hmc with --condensate on the device programs (graph=True, eager
    on the CPU) against the eager loop (graph=False): theta, every
    observable chain, the condensate's iterations and flags, equal."""
    lattice = LatticeParams(Nx=8, Nt=8, real_dtype="float32")
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=3, trajectory_length=0.5, even_odd=True,
                    cg=CGParams(tol=1e-10 if refined else 1e-6, max_iter=2000,
                                refine=refined))
    run = RunParams(n_therm=2, n_meas=3, n_steps=1, n_chains=2, seed=3,
                    out_dir=str(tmp_path))
    a, b = (run_hmc(lattice, hmc, run, device="cpu", graph=g, measure_condensate=True,
                    n_noise=2) for g in (True, False))
    np.testing.assert_array_equal(a.theta, b.theta)
    assert set(a.chains) == set(b.chains) == {
        "plaquette", "gauge_action_density", "top_charge", "chiral_condensate"}
    for k in a.chains:
        np.testing.assert_array_equal(a.chains[k], b.chains[k])
    assert a.chains["chiral_condensate"].shape == (3, 2)
    assert (a.condensate_iters, a.condensate_converged) == (
        b.condensate_iters, b.condensate_converged)
    assert a.condensate_converged and a.condensate_iters > 0


def test_critical_mass_programs_equal_the_eager_run():
    """tools/critical_mass.run_point at 8x8 C=2 on the packed path (f32,
    refined): the trajectory programs of the annealing masses and the
    point's, and the meson measurement's program, against its eager run:
    the row (m_PCAC, err, acceptance, all_converged) equal."""
    args = argparse.Namespace(beta=2.0, md_steps=4, tau=0.5, chains=2, n_therm=4,
                              n_blocks=4, n_skip=1, seed=3)
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float32")
    graphed = cm.run_point(args, -0.1, torch.device("cpu"), lat, graph=True)
    eager = cm.run_point(args, -0.1, torch.device("cpu"), lat, graph=False)
    print("row", graphed)
    assert graphed == eager
    assert all(math.isfinite(v) for v in graphed[:3]) and graphed[3] is True
