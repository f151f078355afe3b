"""On the card: every CUDA kernel of the port against its plain PyTorch twin.

At m0 = 0.2, beta = 4 and random angles, at shapes that take every route
each kernel has (the tables below; tests/test_torch_refined.py holds them
to every route ``ru_path``, ``traj.cg_path``, ``residual_path`` and
``halo.halo_path`` can return): the noise kernel (Random123's known
answers, the words and values of every chi shape in f32 and f64, the Z2
mode), K1 in its four variants, K2, K10 (its shifts bit for bit
``torch.roll``, its solve bit for bit K2's), K5, K3 certified and forced
with every chain alone equal to its chain of the batch, K3's MRE forecast,
K4 inside K3's launch and as its own entry, K6 and K9 on their routes with
and without a mask, K7 and K8 on the blocks of a mesh of shards, and the
refined ``dirac_inverse`` against the twins on the CPU.

Run on a machine with a CUDA card:

    python -m pytest --noconftest tests/test_torch_card_kernels.py -m card

Without a card every test skips before it builds a kernel. The module
imports neither JAX nor the JAX package.
"""

import math

import pytest
import torch

from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import _cuda, cg_eo, eo, gauge, halo, noise
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.eo_halo import extend
from schwingermodel_tpu_torch.ops.geometry import ShardedGeometry
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard, unshard
from schwingermodel_tpu_torch.utils import prng

M0, BETA = 0.2, 4.0
M0_HB, M1_HB = -0.19, 0.21
LOOSE, MAX_ITER = 1e-6, 10000

# (Nx, Nt, C) of K1, K2, K10, K3, K4, K6 and K9: the main path's shape, one
# chain, a small non-square lattice, K3 all in shared memory, odd extents, a
# cluster of blocks a chain, and the global scratch
SHAPES = [(64, 64, 32), (64, 64, 1), (8, 12, 3), (32, 32, 32), (20, 34, 2),
          (128, 128, 2), (126, 128, 2)]
# K6's and K9's right-hand sides a configuration, by C
RHS = {32: 8, 1: 1, 3: 2, 2: 2}
# K5 also on one block a chain (C = 128) and on 8 (128x128 C = 8)
K5_SHAPES = [(64, 64, 32), (64, 64, 1), (8, 12, 3), (32, 32, 32), (20, 34, 2),
             (128, 128, 2), (126, 128, 2), (64, 64, 128), (128, 128, 8)]
# K10's shifts alone
SHIFT_SHAPES = SHAPES[:3]
# K3 also at the 128x128 cell's 32 chains, whose clusters of 4 the card
# does not run at once: the L2 path
K3_SHAPES = SHAPES + [(128, 128, 32)]
# K3's MRE forecast on each of its paths
MRE_SHAPES = [(32, 32, 32), (64, 64, 32), (128, 128, 2), (126, 128, 2)]
# (Nx, Nt, mesh, C) of K7 and K8; their global kernels are also run by
# route at HALO_GLOBAL, where the rule splits the block instead
HALO_SHAPES = [(64, 64, (2, 2), 32), (64, 64, (4, 1), 32), (64, 64, (1, 4), 32),
               (16, 16, (2, 2), 3), (128, 128, (2, 2), 2)]
HALO_GLOBAL = [(64, 64, (2, 2), 32), (128, 128, (2, 2), 2)]

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")


DEV = torch.device("cuda", 0)


def _sms():
    return _cuda.sm_count(DEV)


def _ids(shapes):
    """Nx x Nt, the mesh where there is one, and C."""
    return ["-".join(["x".join(map(str, s[:2])), *("x".join(map(str, m)) for m in s[2:-1]),
                      f"C{s[-1]}"]) for s in shapes]


def _gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def _angles(g, C, nx, nt):
    return (2.0 * torch.rand((C, 2, nx, nt), generator=g, device=DEV) - 1.0) * math.pi


def _inputs(seed, nx, nt, C):
    """Folded angles of both parities and a right-hand side, f32."""
    g = _gen(seed)
    thE, thO = tr.pack_planes(_angles(g, C, nx, nt))
    return thE, thO, torch.randn((C, 2, 2, nx, nt // 2), generator=g, device=DEV), g


def _rel_residual(thE, thO, b, x):
    """Per-chain f64 ||b - A x|| / ||b|| of the plain operator."""
    ue, uo = gauge.links(thE, thO, torch.complex128)
    bc = tr.to_complex(b).to(torch.complex128)
    r = bc - eo.normal(ue, uo, tr.to_complex(x).to(torch.complex128), M0)
    return ((r.abs() ** 2).sum(dim=(1, 2, 3)) / (bc.abs() ** 2).sum(dim=(1, 2, 3))).sqrt()


def _eo_rel_residual(thE, thO, b, x):
    """Per-entry f64 ||b - A x|| / ||b|| of [C, B] systems (K9's twin)."""
    _, rn = rs.residual_f64_reference(thE, thO, b, x.double(), m0=M0)
    return (rn / (b.double() ** 2).sum(dim=(2, 3, 4, 5))).sqrt()


def _close(got, want, rel=3e-5):
    """max |got - want| <= rel * max(scale, 1), scale the largest |want|."""
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * max(scale, 1.0), (err, scale)


# ---------- the noise kernel and its Z2 mode ----------

# Random123's known-answer vectors of philox4x32_10: (counter, key, words)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
NX = NT = 64
C_MAIN = 32
PI_SHAPE = (2, NX, NT)
CHI_SHAPES = {"even-odd": (2, NX, NT // 2), "hasenbusch": (2, 2, NX, NT // 2),
              "full-d": (2, NX, NT)}


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = noise.philox(torch.tensor([ctr], dtype=torch.int64, device=DEV), key)
    assert got[0].tolist() == list(want)


@pytest.mark.parametrize("rdtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("chi", list(CHI_SHAPES))
def test_noise_against_its_twin(chi, rdtype, tol):
    """64x64 C=32, the counter on the card at 123: the Philox words equal
    the twin's; the values too but for ties (at most 1e-5 of them, within
    tol of each other); r in [0, 1)."""
    traj = torch.full((), 123, dtype=torch.int64, device=DEV)
    chi_shape = CHI_SHAPES[chi]
    pi, chi_, r, w = noise.chain_noise(5, traj, C_MAIN, PI_SHAPE, chi_shape, rdtype, DEV,
                                       words=True)
    pp, cp, rp, wp = prng.trajectory_noise_reference(
        5, 123, C_MAIN, 0, math.prod(PI_SHAPE), math.prod(chi_shape), rdtype, DEV,
        words=True)
    torch.cuda.synchronize()
    assert torch.equal(w, wp)
    a = torch.cat([pi.flatten(), torch.view_as_real(chi_).flatten(), r])
    b = torch.cat([pp.flatten(), torch.view_as_real(cp).flatten(), rp])
    assert bool(torch.isfinite(a).all()) and bool(((r >= 0) & (r < 1)).all())
    assert int((a != b).sum()) <= 1e-5 * a.numel()
    assert float((a - b).abs().max()) <= tol


def test_noise_chain_offset_and_counter():
    """Chains 2-3 of C=4 drawn at the counter on the card equal C=2 at
    chain_offset 2 drawn at the int index."""
    traj = torch.full((), 123, dtype=torch.int64, device=DEV)
    eo_shape = CHI_SHAPES["even-odd"]
    whole = noise.chain_noise(5, traj, 4, PI_SHAPE, eo_shape, torch.float32, DEV)
    part = noise.chain_noise(5, 123, 2, PI_SHAPE, eo_shape, torch.float32, DEV,
                             chain_offset=2)
    assert all(torch.equal(x[2:], y) for x, y in zip(whole, part))


def test_z2_mode_against_its_twin():
    """64x64 C=32, 8 vectors, the counter on the card: words and values
    equal the twin's; chains 1.. equal C=31 at chain_offset 1 drawn at the
    int index."""
    n_noise, sites = 8, PI_SHAPE
    meas = torch.full((), 123, dtype=torch.int64, device=DEV)
    z, w = noise.z2_noise(5, meas, C_MAIN, n_noise, sites, DEV, words=True)
    zp, wp = prng.z2_noise_reference(5, 123, C_MAIN, 0, n_noise, math.prod(sites), DEV,
                                     words=True)
    torch.cuda.synchronize()
    assert torch.equal(w, wp)
    assert torch.equal(z.reshape(C_MAIN, n_noise, -1), zp)
    part = noise.z2_noise(5, 123, C_MAIN - 1, n_noise, sites, DEV, chain_offset=1)
    assert torch.equal(z[1:], part)


# ---------- K1, K2, K10, K5 ----------

@pytest.mark.parametrize("with_solve,with_gauge", [(False, True), (False, False),
                                                   (True, True), (True, False)])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_k1_against_its_twin(shape, with_solve, with_gauge):
    """K1 on the path its size takes: forces to 3e-5 max(scale, 1); with
    the solve (from x0 = phi = b, tol 1e-6) psi to 2e-4 and equal flags,
    all converged."""
    thE, thO, b, _ = _inputs(11, *shape)
    kw = dict(m0=M0, beta=BETA, tol=LOOSE, max_iter=MAX_ITER, with_solve=with_solve,
              with_gauge=with_gauge)
    k = tr.force_step(thE, thO, b, b, **kw)
    p = tr.force_step_reference(thE, thO, b, b, **kw)
    _close(k.FE, p.FE)
    _close(k.FO, p.FO)
    if with_solve:
        assert (k.psi - p.psi).abs().max().item() <= 2e-4
        assert torch.equal(k.converged, p.converged) and bool(k.converged.all())


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_k2_and_k10_against_their_twins(shape, monkeypatch):
    """K2 and K10 at tol 1e-6 from x0 = b: equal flags, all converged, x to
    2e-4 of the twin's, every f64 true residual under 2e-6 ||b||; K10's
    flags, iterations and x bit for bit K2's (its twin's one-hot matmul is
    exact only in full f32)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert torch.get_float32_matmul_precision() == "highest"
    thE, thO, b, _ = _inputs(12, *shape)
    kw = dict(m0=M0, tol=LOOSE, max_iter=MAX_ITER)
    k2, p2 = tr.solve_fused(thE, thO, b, b, **kw), tr.solve_fused_reference(thE, thO, b, b, **kw)
    k10 = tr.solve_fused_mxu(thE, thO, b, b, **kw)
    p10 = tr.solve_fused_mxu_reference(thE, thO, b, b, **kw)
    torch.cuda.synchronize()
    for k, p in ((k2, p2), (k10, p10)):
        assert torch.equal(k.converged, p.converged) and bool(k.converged.all())
        assert (k.x - p.x).abs().max().item() <= 2e-4
        assert bool((_rel_residual(thE, thO, b, k.x) < 2 * LOOSE).all())
        assert bool((_rel_residual(thE, thO, b, p.x) < 2 * LOOSE).all())
    assert torch.equal(k10.converged, k2.converged) and torch.equal(k10.iters, k2.iters)
    assert torch.equal(k10.iters, p10.iters)
    assert torch.equal(k10.x, k2.x)


@pytest.mark.parametrize("shape", SHIFT_SHAPES, ids=_ids(SHIFT_SHAPES))
def test_k10_shifts_are_torch_roll(shape, monkeypatch):
    """K10's shifts alone, P+ a and P- a of 16 f32 planes across 30 binades,
    and its twin's, equal torch.roll bit for bit."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    nx, nt, _ = shape
    g = _gen(13)
    planes = (torch.randn((16, nx, nt // 2), generator=g, device=DEV)
              * torch.exp2(torch.randint(-15, 16, (16, nx, nt // 2), generator=g,
                                         device=DEV).float()))
    sp, sm = tr.shift_x_mxu(planes)
    tp, tm = tr.shift_x_mxu_reference(planes)
    torch.cuda.synchronize()
    for got, twin, d in ((sp, tp, -1), (sm, tm, 1)):
        want = torch.roll(planes, d, dims=1).view(torch.int32)
        assert torch.equal(got.view(torch.int32), want)
        assert torch.equal(twin.view(torch.int32), want)


def test_k10_tool_at_full_width():
    """tools/bench_mxu_stencil at its defaults (64x64 C=32, 50 right-hand
    sides): exit 0, so K10's flags and iterations equal K2's and x lies
    within its gate on every right-hand side."""
    from schwingermodel_tpu_torch.tools import bench_mxu_stencil

    assert bench_mxu_stencil.main(["--seed", "0"]) == 0


@pytest.mark.parametrize("shape", K5_SHAPES, ids=_ids(K5_SHAPES))
def test_k5_against_its_twin(shape):
    """K5 near the critical mass (m0 = -0.19, m1 = 0.21) on the path and
    blocks a chain its size takes: forces to 3e-5 max(scale, 1)."""
    thE, thO, b, g = _inputs(14, *shape)
    phi2 = torch.randn(b.shape, generator=g, device=DEV)
    kw = dict(m0=M0_HB, m1=M1_HB, beta=BETA)
    FE, FO = tr.ratio_force(thE, thO, b, phi2, **kw)
    RE, RO = tr.ratio_force_reference(thE, thO, b, phi2, **kw)
    _close(FE, RE)
    _close(FO, RO)


# ---------- K3 and K4 ----------

@pytest.mark.parametrize("certify", [True, False], ids=["certified", "force"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=_ids(K3_SHAPES))
def test_k3_against_its_twin(shape, certify):
    """K3 certified at 1e-10 from x0 = b, or on the force contract at 1e-8
    from a forecast start (the certified solution perturbed by 1e-3): every
    chain's f64 true residual under tol ||b|| in kernel and twin, equal
    flags, all converged, no fallback iterations, and each chain alone on
    the batch's route (``ru_path`` on the card's counts; alone it would
    take another at 128x128 C=32) equal to its chain of the batch bit for
    bit."""
    nx, nt, C = shape
    route = rs.ru_path(nx, nt // 2, C, *rs.ru_card_counts(nx, nt // 2, DEV))
    if shape == (128, 128, 32):
        assert route == (rs.RU_L2, 4)
    thE, thO, b, g = _inputs(15, *shape)
    x0, tol = b, 1e-10
    if not certify:
        exact = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10).x
        x0 = exact + 1e-3 * exact.abs().amax(dim=(1, 2, 3, 4), keepdim=True) * torch.randn(
            b.shape, generator=g, device=DEV)
        tol = 1e-8
    kw = dict(m0=M0, tol=tol, certify=certify)
    k = rs.solve_refined(thE, thO, b, x0, **kw)
    p = rs.solve_refined_reference(thE, thO, b, x0, **kw)
    assert bool((_rel_residual(thE, thO, b, k.x64) < tol).all())
    assert bool((_rel_residual(thE, thO, b, p.x64) < tol).all())
    assert torch.equal(k.converged, p.converged) and bool(k.converged.all())
    assert not bool(k.fb_iters.any())
    for i in range(C):
        s = slice(i, i + 1)
        one = rs._launch_ru(thE[s], thO[s], b[s], x0[None, s], route, **kw)
        assert torch.equal(one.x64[0], k.x64[i]) and int(one.iters[0]) == int(k.iters[i]), i


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_k4_from_a_starved_k3(shape):
    """From a K3 starved at 5 iterations, K4 inside K3's launch
    (fallback=True) and as its own entry after it: both reach 1e-10 with
    the flags of the composed twins, fallback iterations in every chain
    (the one call ran them) and iterations the starved ones plus those,
    and equal each other bit for bit."""
    thE, thO, b, _ = _inputs(16, *shape)
    kw = dict(m0=M0, tol=1e-10, max_iter=5)
    starved = rs.solve_refined(thE, thO, b, b, **kw)
    assert not bool(starved.converged.any())
    folded = rs.solve_refined(thE, thO, b, b, fallback=True, fb_max_iter=MAX_ITER, **kw)
    own = rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0, tol=1e-10)
    twin = rs.solve_f64_cg_fallback_reference(
        thE, thO, b, rs.solve_refined_reference(thE, thO, b, b, **kw), m0=M0, tol=1e-10)
    for res in (folded, own):
        assert bool((_rel_residual(thE, thO, b, res.x64) < 1e-10).all())
        assert bool(res.converged.all()) and torch.equal(res.converged, twin.converged)
        assert bool((res.fb_iters > 0).all())
        assert torch.equal(res.iters, starved.iters + res.fb_iters)
    assert all(torch.equal(a, c) for a, c in zip(folded, own))


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] > 1],
                         ids=_ids([s for s in SHAPES if s[2] > 1]))
def test_k3_mixed_batch(shape):
    """Under max_iter=5 at 1e-6: the first half of the chains starts from
    the certified solution, which K3 accepts at once, the second half from
    x0 = b, which it cannot finish. With the fallback only the second half
    falls back (in kernel and twin), the first keeps K3's x and iterations
    bit for bit, and every chain ends under 1e-6 ||b||."""
    thE, thO, b, _ = _inputs(17, *shape)
    C, half = shape[2], shape[2] // 2
    exact = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10).x
    x0 = b.clone()
    x0[:half] = exact[:half]
    kw = dict(m0=M0, tol=LOOSE, max_iter=5)
    alone = rs.solve_refined(thE, thO, b, x0, **kw)
    mixed = rs.solve_refined(thE, thO, b, x0, fallback=True, fb_max_iter=MAX_ITER, **kw)
    twin = rs.solve_refined_reference(thE, thO, b, x0, fallback=True, fb_max_iter=MAX_ITER,
                                      **kw)
    assert alone.converged.tolist() == [True] * half + [False] * (C - half)
    assert (mixed.fb_iters > 0).tolist() == (~alone.converged).tolist()
    assert (twin.fb_iters > 0).tolist() == (~alone.converged).tolist()
    assert torch.equal(mixed.x64[:half], alone.x64[:half])
    assert torch.equal(mixed.iters[:half], alone.iters[:half])
    assert bool(mixed.converged.all()) and bool(twin.converged.all())
    assert bool((_rel_residual(thE, thO, b, mixed.x64) < LOOSE).all())


def _mre_model(nx, nt):
    return SchwingerModel(
        lattice=LatticeParams(Nx=nx, Nt=nt, real_dtype="float32"),
        hmc=HMCParams(beta=BETA, m0=M0, md_steps=40, trajectory_length=1.0, even_odd=True,
                      mre_history=4, cg=CGParams(tol=1e-10, max_iter=MAX_ITER, refine=True,
                                                 inner_tol=1e-5)))


@pytest.mark.parametrize("history", ["tpu", "trajectory"])
@pytest.mark.parametrize("shape", MRE_SHAPES, ids=_ids(MRE_SHAPES))
def test_k3_mre_against_its_twin(shape, history, monkeypatch):
    """K3 with a history of K = 4 solutions on each of its paths: the TPU
    test's (the certified solution, 1.001 times it, b and zeros), or the
    last four force solutions of a refined MRE trajectory (md=40, tau=1)
    with the inputs of its action solve. The forecast alone (max_iter=0) to
    1e-4 of ||x0|| against mre_forecast_reference; the solve from it at
    1e-10 under 1e-10 ||b|| with the twin's flags, all converged; chains 0
    and 1 alone bit for bit their chains of the batch."""
    nx, nt, C = shape
    thE, thO, b, g = _inputs(18, *shape)
    if history == "tpu":
        exact = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10).x
        hist = torch.stack([exact, 1.001 * exact, b, torch.zeros_like(b)])
    else:
        calls, solve = [], rs.solve_refined

        def recorded(thE_, thO_, b_, x0_, **kw):
            calls.append((thE_, thO_, b_, x0_))
            return solve(thE_, thO_, b_, x0_, **kw)

        model = _mre_model(nx, nt)
        theta = _angles(g, C, nx, nt)
        pi, chi, r = hp.draw_chain_noise(model, 5, 0, C, DEV)
        monkeypatch.setattr(rs, "solve_refined", recorded)
        hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
        monkeypatch.undo()
        assert len(calls) == 40 and calls[-1][3].shape[0] == 4
        thE, thO, b, hist = calls[-1]
    kw = dict(m0=M0, tol=1e-10)
    x0 = rs.solve_refined(thE, thO, b, hist, max_iter=0, **kw).x
    want = rs.mre_forecast_reference(thE, thO, b, hist, m0=M0)
    gap = (x0 - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert gap.max().item() <= 1e-4
    k = rs.solve_refined(thE, thO, b, hist, **kw)
    p = rs.solve_refined_reference(thE, thO, b, hist, **kw)
    assert bool((_rel_residual(thE, thO, b, k.x64) < 1e-10).all())
    assert bool((_rel_residual(thE, thO, b, p.x64) < 1e-10).all())
    assert torch.equal(k.converged, p.converged) and bool(k.converged.all())
    for i in range(2):
        s = slice(i, i + 1)
        one = rs.solve_refined(thE[s], thO[s], b[s], hist[:, s].contiguous(), **kw)
        assert torch.equal(one.x64[0], k.x64[i]) and int(one.iters[0]) == int(k.iters[i])


# K3's L2 path against the cluster path at 128x128: (C, blocks a chain)
L2_ROUTES = [(2, 4), (2, 8), (30, 4), (32, 4)]


@pytest.mark.parametrize("start", ["cold", "MRE K=4", "fallback"])
@pytest.mark.parametrize("C,n", L2_ROUTES, ids=[f"C{C}-{n}-blocks" for C, n in L2_ROUTES])
def test_k3_l2_against_the_cluster(C, n, start):
    """K3 at 128x128 on n blocks a chain, launched on the L2 path and on the
    cluster path by the launch's path argument (``refined._launch_ru``):
    x, x64, the iterations, the flags and the fallback's iterations bit
    for bit, cold at 1e-10 from x0 = b, from the MRE forecast over four
    forecast starts (K = 4) at 1e-8 uncertified, and at 1e-10 from x0 = b
    with the fallback on for every chain, held unconverged by max_iter 20
    (the cold solves take ~40);
    on the L2 path every chain's third clock column (its waits on the
    chain's other blocks) above 0 and below its total; a second L2 launch,
    from the counters the first set back to 0, the same bits."""
    thE, thO, b, g = _inputs(19, 128, 128, C)
    kw = dict(m0=M0, tol=1e-10)
    hist = b[None]
    if start == "MRE K=4":
        exact = rs.solve_refined(thE, thO, b, b, **kw).x
        scale = 1e-3 * exact.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
        hist = torch.stack([exact + scale * torch.randn(b.shape, generator=g, device=DEV)
                            for _ in range(4)])
        kw = dict(m0=M0, tol=1e-8, certify=False)
    elif start == "fallback":
        kw.update(max_iter=20, fallback=True, fb_max_iter=MAX_ITER)
    ref = rs._launch_ru(thE, thO, b, hist, (rs.RU_CLUSTER, n), **kw)
    clocks = torch.zeros((C, 4), dtype=torch.int64, device=DEV)
    got = rs._launch_ru(thE, thO, b, hist, (rs.RU_L2, n), clocks, **kw)
    again = rs._launch_ru(thE, thO, b, hist, (rs.RU_L2, n), **kw)
    torch.cuda.synchronize()
    for field in ref._fields:
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
        assert torch.equal(getattr(again, field), getattr(ref, field)), field
    assert bool(((clocks[:, 2] > 0) & (clocks[:, 2] < clocks[:, 0])).all())
    assert bool(ref.converged.all())
    if start == "fallback":
        assert bool((ref.fb_iters > 0).all())


# ---------- K6 and K9 ----------

def _systems(seed, nx, nt, C):
    """Folded angles, their f32 links and RHS[C] right-hand sides a
    configuration."""
    thE, thO, _, g = _inputs(seed, nx, nt, C)
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    bb = torch.randn((C, RHS[C], 2, 2, nx, nt // 2), generator=g, device=DEV)
    return thE, thO, ue, uo, bb, g


def _k6_global(ue, uo, bb, x0, tol):
    """K6's launch on the global path: (x, iters, rho, bnorm2)."""
    return cg_eo._launch(ue, uo, bb, x0, M0, tol, MAX_ITER, _sms(), tr.CG_GLOBAL)


@pytest.mark.parametrize("start", ["zero", "b"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_k6_against_its_twin(shape, start):
    """K6 on given links, from x0 = 0 at 1e-5 (the refinement's inner
    solve) or from x0 = b at 1e-6 (the loose solve): equal flags, all
    converged, x to 2e-4, every f64 true residual under 2 tol ||b||; on
    the shared path where V2 is a multiple of 512, x, iterations and flags
    bit for bit the global path's."""
    nx, nt, C = shape
    thE, thO, ue, uo, bb, _ = _systems(19, *shape)
    x0, tol = (torch.zeros_like(bb), 1e-5) if start == "zero" else (bb, LOOSE)
    k = cg_eo.cg_solve_eo(ue, uo, bb, x0, m0=M0, tol=tol, max_iter=MAX_ITER)
    p = cg_eo.cg_solve_eo_reference(ue, uo, bb, x0, m0=M0, tol=tol, max_iter=MAX_ITER)
    assert torch.equal(k.converged, p.converged) and bool(k.converged.all())
    assert (k.x - p.x).abs().max().item() <= 2e-4
    assert bool((_eo_rel_residual(thE, thO, bb, k.x) < 2 * tol).all())
    assert bool((_eo_rel_residual(thE, thO, bb, p.x) < 2 * tol).all())
    path, _ = tr.cg_path(nx, nt // 2, C * RHS[C], _sms())
    if path == tr.CG_SHARED and (nx * nt // 2) % 512 == 0:
        gx, gi, grho, gbn = _k6_global(ue, uo, bb, x0, tol)
        assert torch.equal(k.x, gx) and torch.equal(k.iters, gi)
        assert torch.equal(k.converged, tr._converged(grho, gbn, tol))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_k6_starved(shape):
    """max_iter=3 from x0 = b: unconverged and finite in kernel and twin."""
    _, _, ue, uo, bb, _ = _systems(20, *shape)
    kw = dict(m0=M0, tol=LOOSE, max_iter=3)
    for res in (cg_eo.cg_solve_eo(ue, uo, bb, bb, **kw),
                cg_eo.cg_solve_eo_reference(ue, uo, bb, bb, **kw)):
        assert not bool(res.converged.any()) and bool(torch.isfinite(res.x).all())


def test_k6_zero_entry():
    """No breakdown guards, as the twin and the Pallas loop: a zero
    right-hand side among random ones (64x64 C=2 B=4) runs 1 iteration to
    a NaN x, unconverged, in kernel, twin and global path; the other
    entries converge with the twin's iterations, x bit for bit the global
    path's."""
    thE, thO, _, g = _inputs(21, 64, 64, 2)
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    bb = torch.randn((2, 4, 2, 2, 64, 32), generator=g, device=DEV)
    bb[1, 2] = 0
    zero = torch.zeros_like(bb)
    k = cg_eo.cg_solve_eo(ue, uo, bb, zero, m0=M0, tol=1e-5, max_iter=MAX_ITER)
    p = cg_eo.cg_solve_eo_reference(ue, uo, bb, zero, m0=M0, tol=1e-5, max_iter=MAX_ITER)
    gx, gi, _, _ = _k6_global(ue, uo, bb, zero, 1e-5)
    want = torch.ones((2, 4), dtype=torch.bool, device=DEV)
    want[1, 2] = False

    def finite(x):
        return torch.isfinite(x).flatten(2).all(dim=2)

    assert torch.equal(k.iters, p.iters) and torch.equal(k.iters, gi)
    assert int(k.iters[1, 2]) == 1
    assert torch.equal(k.converged, want) and torch.equal(p.converged, want)
    for x in (k.x, p.x, gx):
        assert torch.equal(finite(x), want)
    assert torch.equal(k.x[want], gx[want])


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_k9_on_every_route(shape):
    """K9 on a random f64 x, on the route residual_path takes and on every
    other (each slab count with each count of right-hand sides a block, and
    the global scratch): |r - r_plain| <= 1e-12 (max|b| + max|A x|),
    ||r||^2 to 1e-12 relative, r bit for bit the taken route's on all,
    two launches equal."""
    nx, nt, C = shape
    thE, thO, _, _, bb, g = _systems(22, *shape)
    x = torch.randn(bb.shape, generator=g, device=DEV, dtype=torch.float64)
    rp, np_ = rs.residual_f64_reference(thE, thO, bb, x, m0=M0)
    bound = 1e-12 * (bb.abs().max().item() + (bb.double() - rp).abs().max().item())
    r0, n0 = rs.residual_f64(thE, thO, bb, x, m0=M0)
    r1, n1 = rs.residual_f64(thE, thO, bb, x, m0=M0)
    torch.cuda.synchronize()
    assert torch.equal(r0, r1) and torch.equal(n0, n1)
    taken = rs.residual_path(nx, nt // 2, C, RHS[C], _sms())
    for route in [(tr.CG_GLOBAL, 1, 1), *rs.residual_routes(nx, nt // 2, RHS[C])]:
        rk, nk = rs._launch_residual(thE, thO, bb, x, M0, _sms(), route)
        torch.cuda.synchronize()
        assert (rk - rp).abs().max().item() <= bound, route
        assert ((nk - np_).abs() / np_).max().item() <= 1e-12, route
        assert torch.equal(rk, r0), (route, taken)


def test_k6_and_k9_with_a_mask():
    """64x64 C=32 B=8, about half the entries active: the active entries bit
    for bit the unmasked launches', the others untouched (K6: x = x0, 0
    iterations, unconverged; K9: the out buffers as given); against the
    twins with the same mask K6's x to 2e-4 of its scale with equal flags,
    K9's r to 1e-12 (max|b| + max|A x|) and ||r||^2 to 1e-12 relative."""
    thE, thO, ue, uo, bb, g = _systems(23, 64, 64, C_MAIN)
    x0 = torch.randn(bb.shape, generator=g, device=DEV)
    active = torch.rand(bb.shape[:2], generator=g, device=DEV) < 0.5
    a6 = active[:, :, None, None, None, None].expand_as(bb)
    kw = dict(m0=M0, tol=1e-5, max_iter=MAX_ITER)
    full = cg_eo.cg_solve_eo(ue, uo, bb, x0, **kw)
    masked = cg_eo.cg_solve_eo(ue, uo, bb, x0, active=active, **kw)
    twin = cg_eo.cg_solve_eo_reference(ue, uo, bb, x0, active=active, **kw)
    torch.cuda.synchronize()
    assert torch.equal(masked.x[a6], full.x[a6])
    assert torch.equal(masked.iters[active], full.iters[active])
    assert torch.equal(masked.converged[active], full.converged[active])
    assert torch.equal(masked.x[~a6], x0[~a6])
    assert not bool(masked.iters[~active].any()) and not bool(masked.converged[~active].any())
    assert (masked.x - twin.x).abs().max().item() <= 2e-4 * twin.x.abs().max().item()
    assert torch.equal(masked.converged, twin.converged)

    x = torch.randn(bb.shape, generator=g, device=DEV, dtype=torch.float64)
    r_full, n_full = rs.residual_f64(thE, thO, bb, x, m0=M0)

    def given():
        return torch.full_like(r_full, 7.0), torch.full_like(n_full, -1.0)

    r_m, n_m = rs.residual_f64(thE, thO, bb, x, m0=M0, active=active, out=given())
    r_p, n_p = rs.residual_f64_reference(thE, thO, bb, x, m0=M0, active=active, out=given())
    torch.cuda.synchronize()
    assert torch.equal(r_m[a6], r_full[a6]) and torch.equal(n_m[active], n_full[active])
    assert bool((r_m[~a6] == 7.0).all()) and bool((n_m[~active] == -1.0).all())
    scale = bb.abs().max().item() + (bb.double() - r_p).abs().max().item()
    assert (r_m - r_p).abs().max().item() <= 1e-12 * scale
    assert ((n_m - n_p).abs() / n_p.abs()).max().item() <= 1e-12


def test_refined_dirac_inverse_against_the_cpu_twins():
    """The refined dirac_inverse (K6, K9, K4) at 64x64 C=2 with 4 noise
    vectors against the plain twins on the CPU, same noise: every flag true,
    each estimate Re(z^+ w) to rtol 1e-6."""
    model = SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=BETA, m0=M0, even_odd=True,
                      cg=CGParams(tol=1e-10, max_iter=MAX_ITER, refine=True, inner_tol=1e-5)))
    theta = _angles(_gen(24), 2, NX, NT)
    zs = obs.condensate_noise(0, 0, 2, theta.shape, 4, DEV)

    def estimates(theta, zs):
        w, res = model.dirac_inverse(theta, zs)
        est = (zs.to(torch.complex128).conj() * w.to(torch.complex128)).real
        return est.sum(dim=(2, 3, 4)).cpu(), res.converged.cpu()

    ek, ck = estimates(theta, zs)
    ep, cp = estimates(theta.cpu(), zs.cpu())
    assert bool(ck.all()) and bool(cp.all())
    assert ((ek - ep).abs() / ep.abs()).max().item() <= 1e-6


# ---------- K7 and K8 ----------

def _halo_setup(nx, nt, mesh_shape, C, seed):
    mesh = lattice_mesh(mesh_shape)
    geom = ShardedGeometry(mesh)
    model = SchwingerModel(lattice=LatticeParams(Nx=nx, Nt=nt, real_dtype="float32"),
                           hmc=HMCParams(beta=BETA, m0=M0, even_odd=True), geom=geom)
    g = _gen(seed)
    theta = _angles(g, C, nx, nt)
    Uf = model.field_fermion_links(shard(theta, mesh))
    op = halo.EOOperatorsHaloFused(geom, Uf, M0)
    lead = (C, *mesh_shape)
    loc = (nx // mesh_shape[0], nt // mesh_shape[1] // 2)
    v, r, psi = (torch.randn((*lead, 2, 2, *loc), generator=g, device=DEV) for _ in range(3))
    planes = (op.ue_ext, op.uo_ext, op.off_ext)
    return mesh, geom, theta, Uf, planes, extend(geom, v), r, extend(geom, psi), g


def _partials_close(got, want):
    """Relative to the block's largest partial: <r, A d> of a random r is a
    cancelling sum."""
    rel = (got - want).abs() / want.abs().amax(dim=-1, keepdim=True)
    assert rel.max().item() <= 1e-5


@pytest.mark.parametrize("shape", HALO_SHAPES, ids=_ids(HALO_SHAPES))
def test_k7_k8_against_their_twins(shape):
    """K7 (with and without the dot partials) and K8 on the blocks of a
    mesh of shards, on the path ``halo_path`` takes: out and forces to 3e-5
    max(scale, 1), partials to 1e-5 of the block's largest, out equal with
    and without the partials, two launches on the same inputs equal bit
    for bit (no atomics)."""
    _, _, _, _, planes, v_ext, r, psi_ext, _ = _halo_setup(*shape, seed=25)
    out_k, dots_k = halo.halo_normal(*planes, v_ext, r, m0=M0, with_dots=True)
    out_2, dots_2 = halo.halo_normal(*planes, v_ext, r, m0=M0, with_dots=True)
    out_p, dots_p = halo.halo_normal_reference(*planes, v_ext, r, m0=M0, with_dots=True)
    _close(out_k, out_p)
    assert torch.equal(out_k, halo.halo_normal(*planes, v_ext, m0=M0))
    assert torch.equal(out_k, out_2) and torch.equal(dots_k, dots_2)
    _partials_close(dots_k, dots_p)
    FE, FO = halo.halo_force(*planes, psi_ext, m0=M0, beta=BETA)
    RE, RO = halo.halo_force_reference(*planes, psi_ext, m0=M0, beta=BETA)
    _close(FE, RE)
    _close(FO, RO)


@pytest.mark.parametrize("shape", HALO_GLOBAL, ids=_ids(HALO_GLOBAL))
def test_halo_global_kernels_by_route(shape):
    """The global-scratch K7 and K8, which the rule keeps for blocks no
    split holds, launched by route where the blocks fit as well: to the
    twins' tolerances, K7 equal with and without the partials, two
    launches of each equal bit for bit."""
    _, _, _, _, planes, v_ext, r, psi_ext, _ = _halo_setup(*shape, seed=26)
    out_p, dots_p = halo.halo_normal_reference(*planes, v_ext, r, m0=M0, with_dots=True)
    k7 = halo._NormalLaunch(*planes, M0, route=(tr.CG_GLOBAL, 1))
    out_g, dots_g = k7(v_ext, r)
    out_2, dots_2 = k7(v_ext, r)
    _close(out_g, out_p)
    assert torch.equal(k7(v_ext), out_g)
    assert torch.equal(out_g, out_2) and torch.equal(dots_g, dots_2)
    _partials_close(dots_g, dots_p)
    RE, RO = halo.halo_force_reference(*planes, psi_ext, m0=M0, beta=BETA)
    k8 = halo._ForceLaunch(*planes, route=(tr.CG_GLOBAL, 1))
    GE, GO = k8(psi_ext, M0, BETA)
    GE2, GO2 = k8(psi_ext, M0, BETA)
    _close(GE, RE)
    _close(GO, RO)
    assert torch.equal(GE, GE2) and torch.equal(GO, GO2)


SHARDED = [s for s in HALO_SHAPES if s[0] != 128]


@pytest.mark.parametrize("shape", SHARDED, ids=_ids(SHARDED))
def test_sharded_k7_cg_and_k8_against_k2_and_k1(shape):
    """The sharded K7 CG against the unsharded K2 on the same theta and b
    (tol 1e-6 from x0 = b): flags, f64 true residuals under 2e-6 ||b||, x
    to 2e-4; K8's force, unsharded again, against K1's (with_solve=False)
    to 3e-5 max(scale, 1)."""
    nx, nt, _, C = shape
    mesh, geom, theta, Uf, _, _, _, _, g = _halo_setup(*shape, seed=27)
    thE, thO = tr.pack_planes(theta)
    b = torch.randn((C, 2, 2, nx, nt // 2), generator=g, device=DEV)
    sh = halo.cg_solve_sharded_fused(geom, Uf, M0, shard(tr.to_complex(b), mesh), tol=LOOSE,
                                     max_iter=MAX_ITER)
    k2 = tr.solve_fused(thE, thO, b, b, m0=M0, tol=LOOSE, max_iter=MAX_ITER)
    x_sh = tr.to_planar(unshard(sh.x, mesh))
    assert bool(sh.converged.all()) and bool(k2.converged.all())
    assert bool((_rel_residual(thE, thO, b, x_sh) < 2 * LOOSE).all())
    assert bool((_rel_residual(thE, thO, b, k2.x) < 2 * LOOSE).all())
    assert (x_sh - k2.x).abs().max().item() <= 2e-4
    psi = torch.randn((C, 2, 2, nx, nt // 2), generator=g, device=DEV)
    F8 = unshard(halo.force_halo_fused(geom, Uf, M0, shard(tr.to_complex(psi), mesh), BETA),
                 mesh)
    k1 = tr.force_step(thE, thO, psi, psi, m0=M0, beta=BETA, tol=LOOSE, max_iter=10,
                       with_solve=False, with_gauge=True)
    _close(F8, eo.unpack(k1.FE, k1.FO))
