"""Kernels K3 (reliable-update solve) and K4 (f64 CG fallback) of the
PyTorch port, held to the solver contract.

The JAX packed refined solve cannot run on the CPU (its interpret-mode
double-float jaxpr takes hours to compile), so the plain twins that CPU
tensors run are held to the contract instead: the complex128 true residual
from the per-site NumPy oracle (tests/reference_impl.py), the JAX x64
refinement (solvers/refine.cg_refine through the model) and its f64 CG
finish (solvers/refine._f64_cg_finish). The CUDA kernels are held against
the same twins on the card by tests/test_torch_card_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu.solvers.refine import _f64_cg_finish
from schwingermodel_tpu_torch.ops import _cuda, halo
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.eo_halo import W
from tests import reference_impl as ref
from tests import test_torch_card_kernels as card

torch.set_num_threads(1)

M0 = 0.1
TOL = 1e-10


def _system(rng, C, Nx=8, Nt=8):
    theta = rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt)).astype(np.float32)
    b = (rng.standard_normal((C, 2, Nx, Nt // 2))
         + 1j * rng.standard_normal((C, 2, Nx, Nt // 2))).astype(np.complex64)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    return theta, b, thE, thO, tr.to_planar(torch.from_numpy(b))


def _oracle_normal(theta, v):
    """(Dhat Dhat^+) v in complex128 from the full-lattice oracle D, for one
    chain: theta [2, Nx, Nt], v even-packed [2, Nx, Nth]."""
    from schwingermodel_tpu_torch.ops import eo

    U = np.exp(1j * theta.astype(np.float64))
    m = M0 + 2.0

    def schur(v_e, D):
        z = np.zeros_like(v_e)
        full = eo.unpack(torch.from_numpy(v_e), torch.from_numpy(z)).numpy()
        y_o = eo.pack(torch.from_numpy(D(U, full, M0)), eo.ODD).numpy()
        w = eo.unpack(torch.from_numpy(z), torch.from_numpy(-y_o / m)).numpy()
        return m * v_e + eo.pack(torch.from_numpy(D(U, w, M0)), eo.EVEN).numpy()

    return schur(schur(v, ref.dirac_dagger_ref), ref.dirac_ref)


def _rel_residual(theta, b, x64):
    """Per-chain ||b - A x|| / ||b|| in complex128 (oracle operator)."""
    xc = tr.to_complex(x64).numpy()
    out = []
    for c in range(len(b)):
        r = b[c].astype(np.complex128) - _oracle_normal(theta[c], xc[c])
        out.append(np.linalg.norm(r) / np.linalg.norm(b[c]))
    return np.array(out)


def _jax_model(refine=True, fallback=True, max_iter=10000):
    return SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=8, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=M0, even_odd=True,
                      cg=CGParams(tol=TOL, max_iter=max_iter, refine=refine,
                                  refine_impl="x64", fallback=fallback)))


def test_solve_refined_certified_meets_contract(rng):
    """certify=True at 1e-10: oracle residual below 1e-10 ||b||, the flag is
    set, and x agrees with the JAX x64 refinement to 1e-8 relative."""
    theta, b, thE, thO, bp = _system(rng, 2)
    sol = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL, certify=True)
    assert sol.x64.dtype == torch.float64 and sol.x.dtype == torch.float32
    assert bool(sol.converged.all())
    assert (_rel_residual(theta, b, sol.x64) < TOL).all()

    model = _jax_model()
    for c in range(2):
        th = jnp.asarray(theta[c])
        res = model._solve_eo(th, model.eo_ops(th), jnp.asarray(b[c]))
        assert bool(res.converged)
        x_ref = np.asarray(res.x)
        x_got = tr.to_complex(sol.x64)[c].numpy()
        assert np.linalg.norm(x_got - x_ref) < 1e-8 * np.linalg.norm(x_ref)


def test_solve_refined_force_contract_from_forecast(rng):
    """certify=False at 1e-8 from a forecast start (a nearby solution): the
    trusted recursive exit still meets 1e-8 on the oracle residual."""
    theta, b, thE, thO, bp = _system(rng, 2)
    exact = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=1e-12)
    noise = torch.from_numpy(rng.standard_normal(bp.shape).astype(np.float32))
    x0 = exact.x + 1e-3 * noise * exact.x.abs().max()
    sol = rs.solve_refined(thE, thO, bp, x0, m0=M0, tol=1e-8, certify=False)
    assert bool(sol.converged.all())
    assert (_rel_residual(theta, b, sol.x64) < 1e-8).all()
    cold = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=1e-8, certify=False)
    assert (sol.iters < cold.iters).all()


def test_solve_refined_zero_restarts_poisoned_start(rng):
    """A start worse than x = 0 (x0 = 1e3 b) is replaced by x = 0: the
    solve is the cold solve from zero, iterate for iterate."""
    theta, b, thE, thO, bp = _system(rng, 2)
    poisoned = rs.solve_refined(thE, thO, bp, 1e3 * bp, m0=M0, tol=TOL)
    zero = rs.solve_refined(thE, thO, bp, torch.zeros_like(bp), m0=M0, tol=TOL)
    assert bool(poisoned.converged.all())
    assert torch.equal(poisoned.iters, zero.iters)
    assert torch.equal(poisoned.x64, zero.x64)
    assert (_rel_residual(theta, b, poisoned.x64) < TOL).all()


def test_solve_refined_starved_reports_unconverged(rng):
    theta, b, thE, thO, bp = _system(rng, 2)
    sol = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL, max_iter=5)
    assert not bool(sol.converged.any())
    assert (sol.iters <= 5).all()
    assert bool(torch.isfinite(sol.x64).all())


@pytest.mark.parametrize("certify,tol", [(True, TOL), (False, 1e-8)])
def test_solve_refined_per_chain_semantics(rng, certify, tol):
    """Chain i of a C=3 batch is chain i solved alone: no decision couples
    the chains (per-chain semantics)."""
    theta, b, thE, thO, bp = _system(rng, 3)
    batch = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=tol, certify=certify)
    for c in range(3):
        one = rs.solve_refined(thE[c:c + 1], thO[c:c + 1], bp[c:c + 1],
                               bp[c:c + 1], m0=M0, tol=tol, certify=certify)
        assert int(one.iters[0]) == int(batch.iters[c])
        assert bool(one.converged[0]) == bool(batch.converged[c])
        np.testing.assert_allclose(one.x64[0].numpy(), batch.x64[c].numpy(),
                                   rtol=0, atol=1e-12)


def _truncated(rng, C=2, max_iter=12):
    theta, b, thE, thO, bp = _system(rng, C)
    prev = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL,
                            max_iter=max_iter)
    assert not bool(prev.converged.any())
    return theta, b, thE, thO, bp, prev


def test_fallback_reaches_contract_like_jax_f64_finish(rng):
    """K4 from a truncated K3 result reaches 1e-10 on the oracle and agrees
    with solvers/refine._f64_cg_finish started from the same x."""
    theta, b, thE, thO, bp, prev = _truncated(rng)
    fb = rs.solve_f64_cg_fallback(thE, thO, bp, prev, m0=M0, tol=TOL)
    assert bool(fb.converged.all())
    assert (_rel_residual(theta, b, fb.x64) < TOL).all()
    assert (fb.iters > prev.iters).all()

    model = _jax_model()
    for c in range(2):
        th = jnp.asarray(theta[c])
        ops = jeo.EOOperators(model.geom, model.fermion_links_hi(th), M0)
        b_hi = jnp.asarray(b[c]).astype(jnp.complex128)
        x = jnp.asarray(tr.to_complex(prev.x64)[c].numpy())
        r = b_hi - ops.normal(x)

        def dot(u, v):
            return jnp.sum(jnp.real(jnp.conj(u) * v))

        stop2 = TOL * TOL * dot(b_hi, b_hi)
        x_ref, _, rho, _ = _f64_cg_finish(ops.normal, b_hi, x, r, dot(r, r),
                                          stop2, dot, 10000)
        assert float(rho) < float(stop2)
        x_got = tr.to_complex(fb.x64)[c].numpy()
        x_ref = np.asarray(x_ref)
        assert np.linalg.norm(x_got - x_ref) < 1e-8 * np.linalg.norm(x_ref)


def test_fallback_never_worse_than_entry(rng):
    """With a budget of one iteration K4 cannot reach the target; whatever
    it does, the returned residual is not above the entry residual."""
    theta, b, thE, thO, bp, prev = _truncated(rng)
    entry = _rel_residual(theta, b, prev.x64)
    for max_iter in (1, 2, 3):
        fb = rs.solve_f64_cg_fallback(thE, thO, bp, prev, m0=M0, tol=TOL,
                                      max_iter=max_iter)
        assert not bool(fb.converged.any())
        assert (_rel_residual(theta, b, fb.x64) <= entry * (1 + 1e-12)).all()


def test_fallback_zero_restarts_poisoned_entry(rng):
    """An entry worse than x = 0 restarts from zero: the result is the K4
    solve from a zero entry."""
    theta, b, thE, thO, bp, prev = _truncated(rng)
    poisoned = prev._replace(x64=1e3 * bp.double(), x=1e3 * bp)
    zero = prev._replace(x64=torch.zeros_like(prev.x64),
                         x=torch.zeros_like(prev.x))
    fb_p = rs.solve_f64_cg_fallback(thE, thO, bp, poisoned, m0=M0, tol=TOL)
    fb_z = rs.solve_f64_cg_fallback(thE, thO, bp, zero, m0=M0, tol=TOL)
    assert bool(fb_p.converged.all())
    assert torch.equal(fb_p.x64, fb_z.x64)
    assert torch.equal(fb_p.iters, fb_z.iters)
    assert (_rel_residual(theta, b, fb_p.x64) < TOL).all()


def test_fallback_passes_converged_chains_through(rng):
    theta, b, thE, thO, bp = _system(rng, 2)
    sol = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL)
    fb = rs.solve_f64_cg_fallback(thE, thO, bp, sol, m0=M0, tol=TOL)
    assert torch.equal(fb.x64, sol.x64) and torch.equal(fb.iters, sol.iters)


# ---------- the fallback in K3's call ----------

def _mixed_system(rng, C=3):
    """A batch whose chains meet K3 differently under max_iter=5 at
    MIXED_TOL: chain 0 starts from the certified solution (its f32 round
    has a residual near 1e-7 ||b||, so K3 accepts it at once at a
    tolerance above that), chain 1 from x0 = b (starved), chain 2 from a
    start worse than x = 0 (poisoned: zero-restarted, then starved)."""
    theta, b, thE, thO, bp = _system(rng, C)
    exact = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL)
    x0 = bp.clone()
    x0[0] = exact.x64[0].float()
    x0[2] = 1e3 * bp[2]
    return theta, b, thE, thO, bp, x0, exact


MIXED_TOL = 1e-6


@pytest.mark.parametrize("certify", [True, False])
def test_one_call_equals_two_call_composition(rng, certify, tol=MIXED_TOL):
    """solve_refined(fallback=True) is solve_f64_cg_fallback on
    solve_refined's result, bit for bit, for converged, starved and
    poisoned chains; the fallback's own iteration count is 0 exactly where
    K3 converged."""
    theta, b, thE, thO, bp, x0, exact = _mixed_system(rng)
    kw = dict(m0=M0, tol=tol, max_iter=5, certify=certify)
    k3 = rs.solve_refined(thE, thO, bp, x0, **kw)
    assert k3.converged.tolist() == [True, False, False]
    assert not bool(k3.fb_iters.any())
    two = rs.solve_f64_cg_fallback(thE, thO, bp, k3, m0=M0, tol=tol,
                                   max_iter=10000)
    one = rs.solve_refined(thE, thO, bp, x0, fallback=True, fb_max_iter=10000,
                           **kw)
    for got, want in zip(one, two):
        assert torch.equal(got, want)
    assert bool(one.converged.all())
    assert (one.fb_iters > 0).tolist() == (~k3.converged).tolist()
    assert torch.equal(one.iters, k3.iters + one.fb_iters)
    # the chain K3 converged is K3's own x
    assert torch.equal(one.x64[0], k3.x64[0])
    assert (_rel_residual(theta, b, one.x64) < tol).all()


def test_one_call_fallback_shares_max_iter_by_default(rng):
    """Without fb_max_iter the fallback runs under K3's max_iter, as the
    packed trajectory calls it: a budget of 5 starves both."""
    theta, b, thE, thO, bp = _system(rng, 2)
    one = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL, max_iter=5,
                           fallback=True)
    two = rs.solve_f64_cg_fallback(
        thE, thO, bp, rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL,
                                       max_iter=5),
        m0=M0, tol=TOL, max_iter=5)
    assert not bool(one.converged.any())
    assert (one.fb_iters == 5).all()
    for got, want in zip(one, two):
        assert torch.equal(got, want)


def test_one_call_per_chain_semantics(rng):
    """With the fallback on, chain i of the mixed batch is chain i solved
    alone, bit for bit: no decision of K3 or of the fallback couples the
    chains."""
    theta, b, thE, thO, bp, x0, _ = _mixed_system(rng)
    kw = dict(m0=M0, tol=MIXED_TOL, max_iter=5, fallback=True,
              fb_max_iter=10000)
    batch = rs.solve_refined(thE, thO, bp, x0, **kw)
    assert (batch.fb_iters > 0).tolist() == [False, True, True]
    for c in range(3):
        one = rs.solve_refined(thE[c:c + 1], thO[c:c + 1], bp[c:c + 1],
                               x0[c:c + 1], **kw)
        for got, want in zip(one, batch):
            assert torch.equal(got[0], want[c])


def test_fallback_off_reports_no_fallback_iterations(rng):
    theta, b, thE, thO, bp = _system(rng, 2)
    sol = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL, max_iter=5)
    assert not bool(sol.converged.any()) and not bool(sol.fb_iters.any())
    done = rs.solve_refined(thE, thO, bp, bp, m0=M0, tol=TOL, fallback=True)
    assert bool(done.converged.all()) and not bool(done.fb_iters.any())


# What an H100 runs at once of K3 (the kernel library's solve_ru_at_once
# on the card): clusters of n blocks, as its GPCs hold them, and blocks of
# the L2 kernel, one a multiprocessor
H100 = {2: 66, 4: 30, 8: 15}
H100_BLOCKS = {2: 132, 4: 132, 8: 132}


def _path_name(Nx, Nth, C, clusters=H100, blocks=H100_BLOCKS):
    return rs.ru_route_name(*rs.ru_path(Nx, Nth, C, clusters, blocks))


@pytest.mark.parametrize("Nx,Nt,C,path,scratch", [
    (8, 12, 3, "all shared", ((0, 0), (0, 24))),
    (32, 32, 32, "all shared", ((0, 0), (0, 24))),
    (20, 34, 2, "all shared", ((0, 0), (0, 24))),
    (48, 72, 4, "shared", ((0, 20), (0, 32))),
    (64, 64, 1, "shared", ((0, 20), (0, 32))),
    (64, 64, 128, "shared", ((0, 20), (0, 32))),
    (128, 128, 2, "cluster of 8", ((0, 20), (0, 32))),
    (128, 128, 32, "L2 of 4", ((0, 20), (0, 32))),
    (128, 128, 128, "cluster of 4", ((0, 20), (0, 32))),
    (64, 128, 8, "cluster of 8", ((0, 20), (0, 32))),
    (64, 128, 64, "cluster of 2", ((0, 20), (0, 32))),
    (126, 128, 2, "global", ((28, 20), (28, 32))),
    (127, 128, 2, "global", ((28, 20), (28, 32))),
    (256, 256, 2, "global", ((28, 20), (28, 32)))])
def test_ru_path_by_lattice_size(Nx, Nt, C, path, scratch):
    """Where K3 keeps its vectors follows from the lattice size and the
    chain count alone on an H100, within what a block's shared memory (220
    KiB) and threads (4 sites each) hold, and the scratch the wrapper
    allocates follows the path."""
    Nth = Nt // 2
    assert _path_name(Nx, Nth, C) == path
    idx, n = rs.ru_path(Nx, Nth, C, H100, H100_BLOCKS)
    V2, halo = Nx * Nth, 96 * (Nx // n + (2 if n > 1 else 0)) * Nth
    if path == "all shared":
        assert halo + 160 * V2 <= 220 * 1024
    elif path == "shared":
        assert halo <= 220 * 1024 < halo + 160 * V2 and V2 <= 2048
    elif idx in (rs.RU_CLUSTER, rs.RU_L2):
        assert Nx % n == 0 and Nx // n * Nth <= 2048 and halo <= 220 * 1024
    assert (rs._ru_scratch(idx, False), rs._ru_scratch(idx, True)) == scratch


@pytest.mark.parametrize("sms,C,path", [
    (132, 16, "cluster of 8"), (114, 16, "cluster of 4"),
    (132, 33, "cluster of 4"), (114, 28, "cluster of 4"),
    (114, 29, "cluster of 4"), (60, 32, "cluster of 4")])
def test_ru_cluster_follows_the_cards_multiprocessors(sms, C, path):
    """At 128x128 on a card of `sms` multiprocessors whose clusters of n
    tile them (sms // n at once): the cluster is the largest whose C
    clusters all run at once, else the smallest that holds the lattice
    (where the C n blocks do not all run at once either)."""
    assert _path_name(128, 64, C, {n: sms // n for n in (4, 8)}, {4: sms, 8: sms}) == path


@pytest.mark.parametrize("Nx,Nt,C,clusters,blocks,path", [
    (128, 128, 32, H100, H100_BLOCKS, "L2 of 4"),
    (128, 128, 33, H100, H100_BLOCKS, "L2 of 4"),
    (128, 128, 32, H100, {4: 128, 8: 128}, "L2 of 4"),
    (128, 128, 30, H100, H100_BLOCKS, "cluster of 4"),
    (128, 128, 16, H100, H100_BLOCKS, "cluster of 4"),
    (128, 128, 15, H100, H100_BLOCKS, "cluster of 8"),
    (128, 128, 40, H100, H100_BLOCKS, "cluster of 4"),
    (128, 128, 32, H100, {4: 120, 8: 132}, "cluster of 4"),
    (64, 128, 8, H100, H100_BLOCKS, "cluster of 8"),
    (64, 128, 16, H100, H100_BLOCKS, "cluster of 4"),
    (64, 128, 64, H100, H100_BLOCKS, "cluster of 2"),
    (64, 128, 64, {2: 60, 4: 30, 8: 15}, H100_BLOCKS, "L2 of 2"),
    (64, 128, 67, H100, H100_BLOCKS, "cluster of 2"),
    (64, 64, 128, H100, H100_BLOCKS, "shared"),
    (126, 128, 32, H100, H100_BLOCKS, "global")])
def test_ru_path_by_the_cards_counts(Nx, Nt, C, clusters, blocks, path):
    """The rule for a lattice that one block does not hold, from what the
    card runs at once (``ru_path`` takes both counts: its clusters of n
    blocks, and the blocks of the L2 kernel a cooperative launch holds):
    the largest cluster whose C clusters all run at once (C=16 at 128x128
    takes clusters of 4, since 15 of 8 run), else the L2 path on the
    smallest n whose C n blocks all run at once (C=32 and 33 on 132 blocks;
    64x128 C=64 where only 60 clusters of 2 run), else clusters of the
    smallest n in waves (C=40: 160 blocks; 64x128 C=67: 134)."""
    assert _path_name(Nx, Nt // 2, C, clusters, blocks) == path


def test_ru_card_route_counts_the_waves(monkeypatch):
    """ru_card_route takes the card's counts (here an H100's answers to the
    kernel library's query: 30 clusters of 4, 15 of 8, 132 blocks of the
    L2 kernel and of the shared kernel) and gives the launch's waves: at
    128x128 C=32 the L2 path in one wave, where the cluster rule alone
    (the parent's: clusters of 4 as 4 C <= 132) took two; C=30 one wave of
    clusters; C=40 two; 64x64 C=128 one wave of single blocks."""
    answers = {(rs.RU_CLUSTER, 4): 30, (rs.RU_CLUSTER, 8): 15, (rs.RU_L2, 4): 132,
               (rs.RU_L2, 8): 132, (rs.RU_SHARED, 1): 132}
    monkeypatch.setattr(rs, "_at_once", lambda Nx, Nth, path, n, i: answers[path, n])
    dev = torch.device("cuda", 0)
    assert rs.ru_card_route(128, 64, 32, dev) == (rs.RU_L2, 4, 1)
    assert rs.ru_card_route(128, 64, 30, dev) == (rs.RU_CLUSTER, 4, 1)
    assert rs.ru_card_route(128, 64, 40, dev) == (rs.RU_CLUSTER, 4, 2)
    assert rs.ru_card_route(128, 64, 2, dev) == (rs.RU_CLUSTER, 8, 1)
    assert rs.ru_card_route(64, 32, 128, dev) == (rs.RU_SHARED, 1, 1)


def test_ru_l2_exchange_areas_are_kept_and_grown_zeroed(monkeypatch):
    """The L2 path's exchange areas: one zeroed buffer a device, the same
    for launches it holds, a larger zeroed one where a launch needs more,
    and the smaller kept (a captured graph holds its address); C chains of
    the words a chain the kernel library gives (16544 at 128x128 on 4
    blocks)."""
    monkeypatch.setattr(rs, "_RU_XCH", {})
    dev = torch.device("cpu")
    small = rs._ru_xch(2, 16544, dev)
    assert small.numel() == 2 * 16544 and small.dtype == torch.int64
    assert not bool(small.any()) and rs._ru_xch(1, 16544, dev) is small
    big = rs._ru_xch(32, 16544, dev)
    assert big.numel() == 32 * 16544 and not bool(big.any())
    assert rs._RU_XCH[dev] == [small, big] and rs._ru_xch(8, 16544, dev) is big


def test_bench_tool_imports_another_checkouts_wrapper():
    """tools/bench_refined_solve --against DIR times DIR's K3 through DIR's
    own wrapper, so that a K3 with another launch interface compares too:
    the module is imported as a package of its own (here the checkout
    itself stands for DIR), with its own kernel library, and this
    process's modules are put back."""
    import sys
    from pathlib import Path

    from schwingermodel_tpu_torch.ops import _cuda
    from schwingermodel_tpu_torch.tools import bench_refined_solve as brs

    root = Path(__file__).resolve().parents[1]
    theirs = brs._their_refined(root)
    assert theirs is not rs and theirs._cuda is not _cuda
    assert theirs._cuda.KERNELS is not _cuda.KERNELS
    assert Path(theirs.__file__) == root / "schwingermodel_tpu_torch" / "ops" / "refined.py"
    assert sys.modules["schwingermodel_tpu_torch.ops.refined"] is rs
    assert sys.modules["schwingermodel_tpu_torch.ops._cuda"] is _cuda


def test_card_kernel_shapes_reach_every_route():
    """The card's kernel tests take every route of the rules on an H100: a
    route is the path and whether a chain (a shard) spans one block or
    several. K3: all five of ru_path's paths (L2 at 128x128 C=32, the
    shape K3's own twin test adds); K1 in its four variants, K2,
    K10, K5 and K6 (its C*B entries): the shared path on one block, on
    several where the rule splits, and the global path; K9's rule on the
    shared path on one slab and on several, and the global path (the test
    runs every other route too); K7 and K8 shared on one block and on
    several, and the global path, which their global tests launch by
    route."""
    sms = _cuda.H100_SMS

    def kinds(routes):
        return {(path, n > 1) for path, n, *_ in routes}

    one, split, glob = (tr.CG_SHARED, False), (tr.CG_SHARED, True), (tr.CG_GLOBAL, False)
    shapes = [(nx, nt // 2, C) for nx, nt, C in card.SHAPES]
    assert {rs.ru_path(nx, nt // 2, C, H100, H100_BLOCKS)[0]
            for nx, nt, C in card.K3_SHAPES + card.MRE_SHAPES} == set(range(5))
    for solve, gauge in ((False, True), (False, False), (True, True), (True, False)):
        got = kinds(tr.cg_path(*s, sms, solve, gauge) for s in shapes)
        assert got == ({one, glob} if solve else {one, split, glob}), (solve, gauge)
    assert kinds(tr.cg_path(*s, sms) for s in shapes) == {one, glob}
    assert kinds(tr.ratio_force_path(nx, nt // 2, C, sms)
                 for nx, nt, C in card.K5_SHAPES) == {one, split, glob}
    assert kinds(tr.cg_path(nx, nth, C * card.RHS[C], sms)
                 for nx, nth, C in shapes) == {one, glob}
    assert kinds(rs.residual_path(nx, nth, C, card.RHS[C], sms)
                 for nx, nth, C in shapes) == {one, split, glob}
    for per_site in (halo._NORMAL_BYTES, halo._FORCE_BYTES):
        got = kinds(halo.halo_path(nx // rx + 2 * W, nt // rt // 2 + 2 * W, C * rx * rt,
                                   sms, per_site)
                    for nx, nt, (rx, rt), C in card.HALO_SHAPES)
        assert got | {glob} == {one, split, glob} and card.HALO_GLOBAL, per_site
        assert set(map(tuple, card.HALO_GLOBAL)) <= set(map(tuple, card.HALO_SHAPES))
