"""The ``tau1_64`` deployment: unit-length trajectories (tau 1, 40 leapfrog
steps) with every refined solve started from K3's MRE forecast over the
last 4 force solutions, and the benchmark's pieces for it.

On the CPU, at 8x8:
- the benchmark's plain forecast (``hmc_bench/reference/mre.py``, float64,
  its operator the benchmark's reference lattice) against the port's plain
  twin of K3's prologue (``ops/refined.mre_forecast_reference``) in float64,
  on two random histories about a solution and on the duplicate history;
- the port's packed trajectory at tau 1, md 40 and mre_history 4 against
  the benchmark's float64 reference trajectory with the same noise;
- the configuration file, its cell and the ``mre_cycles_pct.K3`` reader.

On the card (``-m card``; this file imports neither JAX nor the JAX
package, so ``python -m pytest --noconftest tests/test_torch_tau1.py -m
card`` runs there): K3's clock columns at K = 1 and K = 4; the forecast K3
starts from against the float64 MGS forecast on each of K3's paths and four
histories (a walk, the TPU test's, a near-degenerate one, a duplicate); and
on a history taken from a graphed trajectory.
"""

import json
import math
import types
from pathlib import Path

import pytest
import torch

from hmc_bench import registry
from hmc_bench.reference import lattice as ref
from hmc_bench.reference import mre
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc.program import TrajectoryProgram
from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.runner import hot_start

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "hmc_bench" / "configs" / "tau1_64.json"
M0 = 0.2


def _packed_normal(thE, thO, m0):
    """(Dhat Dhat^+) of the benchmark's reference lattice in float64, on
    planar even-site spinors [C, 2 (spin), 2 (re, im), Nx, Nt/2] as the port
    packs them (row x, its k-th even site at t = 2k + x mod 2)."""
    Nx, Nth = thE.shape[-2:]
    Nt = 2 * Nth
    theta = ref.from_packed(thE.double(), Nt, 0) + ref.from_packed(thO.double(), Nt, 1)
    op = ref.Dirac(ref.fermion_links(theta, torch.complex128), m0)
    x = torch.arange(Nx, device=thE.device).reshape(Nx, 1)
    t = 2 * torch.arange(Nth, device=thE.device).reshape(1, Nth) + x % 2

    def A(p):
        y = op.normal(ref.from_packed(torch.complex(p[:, :, 0], p[:, :, 1]), Nt))[..., x, t]
        return torch.stack([y.real, y.imag], dim=2)
    return A


def _angles(C, n, seed, device="cpu", spread=0.3, nt=None):
    g = torch.Generator(device=device).manual_seed(seed)
    th = (2 * torch.rand((C, 2, n, nt or n), generator=g, device=device) - 1) * spread * math.pi
    return tr.pack_planes(th.float())


@pytest.mark.parametrize("history", ["random-1", "random-2", "duplicate"])
def test_reference_forecast_matches_the_ports_twin(history):
    """In float64 the benchmark's forecast and the port's plain twin of K3's
    prologue agree to 1e-12 of ||x0|| (two implementations of the same
    float64 arithmetic on a 4x4-conditioned Gram-Schmidt: rounding differs
    by the order of the operator's sums, ~1e-15 a step); a history of K
    copies of Phi gives Phi exactly in both."""
    C, n, K = 2, 8, 4
    thE, thO = _angles(C, n, 3)
    A = _packed_normal(thE, thO, M0)
    g = torch.Generator().manual_seed(7)
    b = torch.randn((C, 2, 2, n, n // 2), generator=g, dtype=torch.float64)
    if history == "duplicate":
        hist = b.expand(K, *b.shape).clone()
    else:
        g.manual_seed(int(history[-1]))
        x = torch.randn(b.shape, generator=g, dtype=torch.float64)
        hist = torch.stack([x + 1e-2 * torch.randn(b.shape, generator=g, dtype=torch.float64)
                            for _ in range(K)])
    got = mre.forecast(A, b, hist)
    twin = rs.mre_forecast_reference(thE, thO, b, hist, m0=M0)
    assert got.dtype == twin.dtype == torch.float64
    if history == "duplicate":
        assert torch.equal(got, b) and torch.equal(twin, b)
        return
    scale = got.flatten(1).norm(dim=1)
    assert float(((got - twin).flatten(1).norm(dim=1) / scale).max()) < 1e-12
    # the forecast does what it is for: a smaller residual than its newest
    # solution's
    res = (b - A(got)).flatten(1).norm(dim=1)
    assert bool((res < (b - A(hist[0])).flatten(1).norm(dim=1)).all())


def _tau1_model(mre_history):
    h = HMCParams(beta=4.0, m0=M0, md_steps=40, trajectory_length=1.0,
                  even_odd=True, mre_history=mre_history,
                  cg=CGParams(tol=1e-10, refine=True))
    return SchwingerModel(lattice=LatticeParams(Nx=8, Nt=8), hmc=h)


def test_tau1_mre_trajectory_agrees_with_the_reference():
    """The port's packed trajectory at tau 1, 40 steps, mre_history 4, 8x8
    C=3, against the float64 reference trajectory on the same noise: the
    same decisions; dH within 1e-4 and theta within 1e-5, the gates of the
    tau 0.1 comparison (hmc_bench/tests/test_bench_reference.py), which the
    float32 MD meets here too (dH 4e-6 to 9.1e-6, theta 4.7e-7 to 8.3e-7 on
    three seeds: forty steps of float32 rounding on H of a few hundred).
    The forecast takes effect: fewer CG iterations than the second-order
    extrapolation on the same trajectory."""
    C, seed, traj = 3, 2**31 + 5, 3
    g = torch.Generator().manual_seed(1)
    theta = ((2 * torch.rand((C, 2, 8, 8), generator=g) - 1) * 0.3 * math.pi).float()
    model = _tau1_model(4)
    assert hp.uses_mre(model)
    pi, chi, r = draw_chain_noise(model, seed, traj, C, "cpu")
    th_new, st = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    out = ref.trajectory(theta, pi, ref.even_from_packed(chi, 8), r, beta=4.0,
                         m0=M0, md_steps=40, tau=1.0)
    assert out.converged.all() and st.cg_converged.all()
    assert torch.equal(out.accept, st.accepted)
    assert float((out.dH - st.delta_H).abs().max()) < 1e-4
    kept = torch.where(out.accept.reshape(-1, 1, 1, 1), out.theta, theta.double())
    assert float(ref.wrap(th_new.double() - kept).abs().max()) < 1e-5
    _, plain = hp.trajectory_packed_given_noise(_tau1_model(0), theta, pi, chi, r)
    assert int(st.cg_iters.sum()) < int(plain.cg_iters.sum())


def test_tau1_configuration_builds_the_ports_parameters():
    """The configuration is demo64's but for tau, md and the history, builds
    the port's HMCParams on the MRE path, and its cell is declared as the
    benchmark reads it."""
    conf = json.loads(CONFIG.read_text())
    demo = json.loads((CONFIG.parent / "demo64.json").read_text())
    changed = {k for k in conf["physics"] if conf["physics"][k] != demo["physics"][k]}
    assert changed == {"trajectory_length", "md_steps", "mre_history"}
    assert (conf["physics"]["trajectory_length"], conf["physics"]["md_steps"],
            conf["physics"]["mre_history"]) == (1.0, 40, 4)
    assert conf["solver"] == demo["solver"] and conf["lattice"] == demo["lattice"]
    assert conf["reduced"] == [] and len(conf["source"]) <= 200
    hmc = HMCParams(**conf["physics"], cg=CGParams(**conf["solver"]))
    model = SchwingerModel(lattice=LatticeParams(**conf["lattice"]), hmc=hmc)
    assert hp.uses_mre(model) and hp.packed_eligible(model)
    cell = registry.cell(REPO, "tau1_64.gen")
    assert cell.config == conf and cell.traffic["chains"] == 128
    assert registry.chips(REPO, "tau1_64.gen") == 1
    names = {m["name"] for m, _ in cell.per_layer}
    assert names == {"graph_nodes.traj", "cg_iters_per_chain_traj",
                     "cg_iters_per_chain_traj.action", "roofline_pct.K3",
                     "f64_cycles_pct.K3", "idle_pct", "mfu_pct", "capture_s",
                     "mre_cycles_pct.K3"}
    assert cell.limits["act_res"] == 1.001e-10


def _mre_reader():
    return registry.metric_reader(REPO / "hmc_bench" / "metrics" / "mre_cycles_pct.K3.py")


@pytest.mark.parametrize("result,share", [
    (dict(), None),                                     # no clock fields at all
    (dict(k3_cycles=400, k3_res_cycles=100), None),     # the parent's clocks
    (dict(k3_cycles=0, k3_mre_cycles=0), None),
    (dict(k3_cycles=None, k3_mre_cycles=None), None),
    (dict(k3_cycles=400, k3_mre_cycles=0), 0.0),        # K = 1
    (dict(k3_cycles=400, k3_mre_cycles=80), 20.0),
], ids=["no-fields", "no-counter", "zero-cycles", "none", "no-history", "mre"])
def test_mre_cycles_reader(result, share):
    """mre_cycles_pct.K3 is 100 k3_mre_cycles / k3_cycles, and None where
    either is missing or K3 counted no cycles."""
    res = types.SimpleNamespace(**result)
    got = _mre_reader()(types.SimpleNamespace(result=res))
    assert got == share if share is not None else got is None


def test_cpu_run_keeps_no_mre_clock(tmp_path):
    """A CPU run_hmc on the MRE path keeps no K3 clocks: the reader reads
    nothing from it."""
    from schwingermodel_tpu_torch.config import RunParams
    from schwingermodel_tpu_torch.runner import run_hmc

    hmc = HMCParams(beta=4.0, m0=M0, md_steps=4, trajectory_length=0.4,
                    even_odd=True, mre_history=4, cg=CGParams(tol=1e-10, refine=True))
    run = RunParams(n_therm=1, n_meas=2, n_steps=0, n_chains=2, seed=3,
                    out_dir=str(tmp_path))
    res = run_hmc(LatticeParams(Nx=8, Nt=8), hmc, run, device="cpu")
    assert res.k3_cycles is None and res.k3_mre_cycles is None
    assert _mre_reader()(types.SimpleNamespace(result=res)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: K3 runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("K", [1, 4])
def test_k3_clock_columns(card, K):
    """On the card, 64x64 (one block a chain): with a start (K = 1) the MRE
    column stays 0; with a history of 4 it counts the prologue, above 0 and
    below the total. Either way the residual cycles lie below the total,
    the one-block path waits on no cluster, and x, x64 and the iterations
    are bit for bit those of a launch without clocks."""
    C, n = 4, 64
    thE, thO = _angles(C, n, 11, card, spread=1.0)
    g = torch.Generator(device=card).manual_seed(12)
    b = torch.randn((C, 2, 2, n, n // 2), generator=g, device=card)
    kw = dict(m0=M0, tol=1e-10, fallback=True)
    exact = rs.solve_refined(thE, thO, b, b, **kw).x
    x0 = (b if K == 1 else torch.stack(
        [exact + 1e-3 * torch.randn(b.shape, generator=g, device=card) for _ in range(K)]))
    plain = rs.solve_refined(thE, thO, b, x0, certify=False, **kw)
    clocks = torch.zeros((C, 4), dtype=torch.int64, device=card)
    got = rs.solve_refined(thE, thO, b, x0, certify=False, clocks=clocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.x, plain.x) and torch.equal(got.x64, plain.x64)
    assert torch.equal(got.iters, plain.iters)
    total, res, wait, prologue = clocks.T
    assert bool(((res > 0) & (res < total)).all()) and int(wait.abs().sum()) == 0
    if K == 1:
        assert int(prologue.abs().sum()) == 0
    else:
        assert bool(((prologue > 0) & (prologue < total)).all())


def _nudged(x, every):
    """x moved up by one ulp at every `every`-th value."""
    flat = x.flatten().clone()
    flat[::every] = torch.nextafter(flat[::every], torch.full_like(flat[::every], math.inf))
    return flat.reshape(x.shape)


@pytest.mark.card
@pytest.mark.parametrize("history", ["walk", "tpu", "near-degenerate", "duplicate"])
@pytest.mark.parametrize("nx,nt,path", [(64, 64, rs.RU_SHARED), (128, 128, rs.RU_CLUSTER),
                                        (126, 128, rs.RU_GLOBAL)],
                         ids=["shared", "cluster", "global"])
def test_k3_forecast_matches_the_mgs_reference(card, nx, nt, path, history):
    """On the card, C=2, on each of K3's paths for a lattice of its size:
    the start of a launch with max_iter 0 (the forecast from K3's Gram sums
    and Cholesky solve, x0 in f64) against mre_forecast_reference in f64
    (modified Gram-Schmidt) to 1e-6 of ||x0||. Histories of 4 solutions,
    newest first: the walk of tests/test_torch_mre.py (certified solutions
    of the angles moved back by 0.01 steps), the TPU test's (the solution,
    1.001 times it, b, zeros), a near-degenerate walk (the solutions one to
    three steps back, the third one the second moved by one ulp at every
    4096th value: its w within ~1e-7 of the second's, so its squared
    Schmidt norm lies ~1e-13 below the largest and both drop it), and the
    duplicate history, which gives hist[0] bit for bit."""
    C = 2
    assert rs.ru_card_route(nx, nt // 2, C, card)[0] == path
    thE, thO = _angles(C, nx, 21, card, spread=1.0, nt=nt)
    g = torch.Generator(device=card).manual_seed(22)
    b = torch.randn((C, 2, 2, nx, nt // 2), generator=g, device=card)
    step = 0.01 * torch.randn(thE.shape, generator=g, device=card)

    def back(k):
        return rs.solve_refined(thE - k * step, thO - k * step, b, b, m0=M0, tol=1e-10).x

    if history == "walk":
        hist = torch.stack([back(k) for k in range(4)])
    elif history == "tpu":
        x = back(0)
        hist = torch.stack([x, 1.001 * x, b, torch.zeros_like(b)])
    elif history == "near-degenerate":
        s1, s2, s3 = back(1), back(2), back(3)
        hist = torch.stack([s1, s2, _nudged(s2, 4096), s3])
    else:
        hist = torch.stack([back(0)] * 4)
    start = rs.solve_refined(thE, thO, b, hist, m0=M0, tol=1e-10, max_iter=0)
    torch.cuda.synchronize()
    if history == "duplicate":
        assert torch.equal(start.x, hist[0]) and torch.equal(start.x64, hist[0].double())
        return
    want = rs.mre_forecast_reference(thE, thO, b.double(), hist.double(), m0=M0)
    gap = (start.x64 - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert float(gap.max()) < 1e-6, gap.tolist()


@pytest.mark.card
def test_graphed_mre_forecast_matches_the_reference(card, monkeypatch):
    """On the card: the trajectory graph at 64x64 C=4 with mre_history 4;
    the action solve's arguments are kept from the capture, so that after
    the replays they hold the last replay's history. The forecast K3 starts
    from (a launch with max_iter 0 returns its start) agrees with the
    float64 reference forecast over that history to 1e-6 of ||x0|| (f32
    applies and axpys with f64 sums: ~1e-7 of each vector), and the block
    counts the prologue in K3's fourth clock column."""
    calls = []

    def keep(thE, thO, b, x0, **kw):
        calls.append((thE, thO, b, x0, kw))
        return rs.solve_refined(thE, thO, b, x0, **kw)

    hmc = HMCParams(beta=4.0, m0=M0, md_steps=8, trajectory_length=0.2,
                    even_odd=True, mre_history=4, cg=CGParams(tol=1e-10, refine=True))
    model = SchwingerModel(lattice=LatticeParams(Nx=64, Nt=64), hmc=hmc)
    theta = hot_start(model.lattice, 5, 4, card)
    # the packed trajectory reaches K3 through its module name `rs`
    monkeypatch.setattr(hp, "rs", types.SimpleNamespace(solve_refined=keep))
    prog = TrajectoryProgram(model, theta, 5, 0)
    prog.run(6)
    torch.cuda.synchronize()
    assert prog.graphed and prog.stats()["replays"] == 5
    thE, thO, b, hist, kw = calls[-1]
    assert kw["certify"] and hist.shape[0] == 4
    start = rs.solve_refined(thE, thO, b, hist, m0=M0, tol=1e-10, max_iter=0).x
    want = mre.forecast(_packed_normal(thE, thO, M0), b, hist)
    gap = (start.double() - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert float(gap.max()) < 1e-6, gap.tolist()
    sums = prog.block.read()
    assert 0 < sums.k3_mre_cycles < sums.k3_cycles
