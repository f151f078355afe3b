"""The port's tracing: spans (utils/metrics.PerfMonitor), the counters the
device programs keep (hmc/program.Block, the restart passes of
solvers/refine.py, K3's clocks), the idle split, and the benchmark's
readers of them.

This file imports neither JAX nor the JAX package, so its card test runs on
the card alone: ``python -m pytest --noconftest tests/test_torch_tracing.py
-m card`` (skipped without a card)."""

import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import (
    CGParams, HMCParams, LatticeParams, RunParams,
)
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc.program import Block, MeasurementProgram
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.runner import hot_start, run_hmc
from schwingermodel_tpu_torch.solvers import refine
from schwingermodel_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parents[1]
NX = NT = 8
SPANS = {"hmc.run", "hmc.thermalize", "hmc.measure", "hmc.block.read",
         "hmc.gather", "hmc.summary", "hmc.dump"}


def _lattice():
    return LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")


def _hmc(max_iter=2000, max_outer=8):
    return HMCParams(beta=2.0, m0=0.1, md_steps=3, trajectory_length=0.5,
                     even_odd=True,
                     cg=CGParams(tol=1e-10, max_iter=max_iter, refine=True,
                                 inner_tol=1e-5, max_outer=max_outer))


def _run(tmp_path, hmc=None, **kw):
    run = RunParams(n_therm=2, n_meas=3, n_steps=1, n_chains=2, seed=3,
                    out_dir=str(tmp_path), **kw)
    return run_hmc(_lattice(), hmc or _hmc(), run, device="cpu",
                   measure_condensate=True, n_noise=2)


@pytest.fixture
def ticks(monkeypatch):
    """time.perf_counter_ns of the tracer as a clock that advances 10 ns at
    every read."""
    clock = iter(range(0, 10**6, 10))
    monkeypatch.setattr(metrics.time, "perf_counter_ns", lambda: next(clock))


def test_spans_nest_with_parent_and_self_time(ticks):
    perf = metrics.PerfMonitor()
    with perf.span("a") as a:                  # reads 0 ... 70
        assert a.parent is None and perf.current is a
        with perf.span("b") as b:              # 10 ... 20
            assert b.parent is a
        with perf.span("b") as b2:             # 30 ... 60
            with perf.span("c") as c:          # 40 ... 50
                assert c.parent is b2 and b2.parent is a
            perf.add(trajectories=2, cg_iters=7)
    assert perf.current is None
    assert (a.start, a.end, c.start, c.end) == (0, 70, 40, 50)
    s = perf.summary()["spans"]
    assert list(s) == ["a", "b", "c"]
    assert s["a"]["count"] == 1 and s["a"]["parents"] == []
    assert s["b"]["count"] == 2 and s["b"]["parents"] == ["a"]
    assert s["c"]["parents"] == ["b"]
    assert s["a"]["seconds"] == pytest.approx(70e-9)
    assert s["a"]["self_seconds"] == pytest.approx(30e-9)   # 70 - 10 - 30
    assert s["b"]["seconds"] == pytest.approx(40e-9)
    assert s["b"]["self_seconds"] == pytest.approx(30e-9)   # 40 - 10
    assert s["c"]["self_seconds"] == s["c"]["seconds"] == pytest.approx(10e-9)
    assert (s["b"]["trajectories"], s["b"]["cg_iters"]) == (2, 7)
    assert "trajectories" not in s["a"]
    assert any(line.startswith("b: ") and "2 x" in line and "traj/s" in line
               for line in perf.report_lines())


def test_replay_spans_give_the_host_time_per_replay(ticks):
    """A program's stats() take the host's microseconds a replay from its
    replay spans in the tracer it was given."""
    perf = metrics.PerfMonitor()
    theta = hot_start(_lattice(), 0, 2, "cpu")
    prog = MeasurementProgram(lambda th, i: {"p": th.sum()}, theta, 2,
                              tracer=perf)
    assert prog.tracer is perf and prog.stats()["host_us_per_replay"] is None
    for _ in range(2):
        with perf.span(prog.SPAN + ".replay"):
            pass
    assert prog.stats()["host_us_per_replay"] == pytest.approx(10e-3)


def test_no_profiler_range_without_a_profiler(monkeypatch, tmp_path):
    """A span opens no profiler range while no profiler records, and one
    range of its name while one does."""
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    perf = metrics.PerfMonitor()
    with perf.span("hmc.x"):
        pass
    res = _run(tmp_path)
    assert opened == [] and SPANS - {"hmc.dump"} <= set(res.perf["spans"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with perf.span("hmc.y"):
            pass
    assert opened == ["hmc.y"]


def test_every_span_of_a_run_is_a_profiler_range(tmp_path):
    """Under a CPU torch.profiler every hmc.* span of a run_hmc call at 8x8
    (a configuration saved at every measurement, so hmc.dump too) is among
    the trace's events, and each is nested in hmc.run."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        res = _run(tmp_path, save_conf=True)
    spans = res.perf["spans"]
    assert set(spans) == SPANS
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("hmc.")]
    assert {e.name() for e in events} == SPANS
    assert not any(e.is_user_annotation() for e in events)
    run = next(e for e in events if e.name() == "hmc.run")
    for e in events:
        assert run.start_ns() <= e.start_ns() <= e.end_ns() <= run.end_ns()
        assert sum(x.name() == e.name() for x in events) == spans[e.name()]["count"]
    parents = {"hmc.run": [], "hmc.thermalize": ["hmc.run"],
               "hmc.measure": ["hmc.run"], "hmc.summary": ["hmc.run"],
               "hmc.block.read": ["hmc.measure", "hmc.thermalize"],
               "hmc.dump": ["hmc.measure"], "hmc.gather": ["hmc.measure"]}
    for name, d in spans.items():
        assert d["parents"] == parents[name], name
        assert 0 <= d["self_seconds"] <= d["seconds"]
    assert spans["hmc.dump"]["count"] == 3


@pytest.mark.parametrize("starved", [False, True], ids=["converged", "starved"])
def test_run_hmc_counts_action_iterations_and_unconverged(tmp_path, starved):
    """On the CPU path: the action solves' iterations within all of them,
    and every unconverged chain-trajectory counted, as a recount of eager
    calls of the same trajectories finds them; no clocks off the card."""
    hmc = _hmc(max_iter=6 if starved else 2000)
    res = _run(tmp_path, hmc)
    assert 0 < res.action_iters_total <= res.cg_iters_total
    assert res.k3_cycles is None and res.k3_res_cycles is None
    model = SchwingerModel(lattice=_lattice(), hmc=hmc)
    theta = hot_start(model.lattice, 3, 2, "cpu")
    bad = act = 0
    for i in range(res.traj_index):
        theta, st = hp.hmc_trajectory_packed(model, theta, 3, i)
        bad += int((~st.cg_converged).sum())
        act += int(st.action_iters.sum())
    assert res.unconverged_chain_trajs == bad
    assert (bad > 0) is starved and res.all_converged is not starved
    assert res.action_iters_total == act


def test_condensate_passes_recount_the_active_mask(tmp_path):
    """The passes each entry of the restart refinement was active equal a
    plain recount of _refine_passes's mask (8x8, C=2, B=2, the plain twins
    with the inner solve recording its mask), and run_hmc's active passes
    a measurement are the largest over its chains' solves."""
    masks = []

    def cg(*a, active=None, **kw):
        masks.append(active.clone())
        return refine.PLAIN.cg(*a, active=active, **kw)

    hmc = _hmc(max_outer=6)
    hmc = dataclasses.replace(hmc, cg=dataclasses.replace(
        hmc.cg, tol=1e-12, inner_tol=1e-3))
    model = SchwingerModel(lattice=_lattice(), hmc=hmc,
                           eo_kernels=refine.PLAIN._replace(cg=cg))
    theta = hot_start(model.lattice, 4, 2, "cpu")
    cc = obs.chiral_condensate(model, theta, 4, 0, n_noise=2)
    assert len(masks) == 6 and cc.passes.shape == (2, 2)
    assert torch.equal(cc.passes, torch.stack(masks).sum(dim=0, dtype=torch.int32))
    assert 0 < int(cc.passes.min()) and int(cc.passes.max()) < 6

    res = _run(tmp_path)
    active = res.condensate_active_passes
    assert active.shape == (3,) and ((1 <= active) & (active <= 8)).all()
    assert "condensate_passes" not in res.chains


@pytest.mark.parametrize("ops,window,expect", [
    # idle 0-10 before an op issued at 5: starved; 20-30 before one issued
    # at 15 (before the gap opened): queued; 40-50 after the last: starved
    ([(10, 20, 5), (30, 40, 15)], (0, 50), (20, 10)),
    # overlapping ops, one launch unknown, ops clipped to the window
    ([(-5, 12, None), (8, 15, 0), (20, 25, None), (22, 30, 21), (35, 60, 10)],
     (0, 50), (5, 5)),
    ([], (0, 7), (7, 0)),
])
def test_idle_split_on_synthetic_intervals(ops, window, expect):
    starved, queued = metrics.idle_split(ops, window)
    assert (starved, queued) == pytest.approx(tuple(1e-9 * v for v in expect))
    busy, edge = 0, window[0]
    for a, b, _ in sorted((max(a, window[0]), min(b, window[1]), i)
                          for a, b, i in ops if b > window[0] and a < window[1]):
        busy += max(0, b - max(a, edge))
        edge = max(edge, b)
    assert starved + queued == pytest.approx(1e-9 * (window[1] - window[0] - busy))


def test_no_idle_split_without_device_operations():
    perf = metrics.PerfMonitor()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with perf.span("hmc.run"):
            torch.ones(4).sum()
    assert metrics.trace_idle(prof) is None


def _metric(name):
    from hmc_bench import registry

    return registry.metric_reader(REPO / "hmc_bench" / "metrics" / f"{name}.py")


def test_benchmark_readers_of_the_counters(tmp_path):
    """The benchmark's readers of this tracing on a CPU run: the action
    iterations a chain-trajectory and the empty restart passes a
    measurement from the run's counts; no clocks and no capture off the
    card; nothing from a result without these counters."""
    res = _run(tmp_path)
    C, traj = 2, res.traj_index
    ctx = types.SimpleNamespace(result=res, C=C, condensate=True,
                                window=types.SimpleNamespace(trajectories=traj))
    assert _metric("cg_iters_per_chain_traj.action")(ctx) == \
        res.action_iters_total / (C * traj)
    assert _metric("masked_passes_per_meas")(ctx) == \
        8 - float(np.mean(res.condensate_active_passes))
    assert _metric("f64_cycles_pct.K3")(ctx) is None
    assert _metric("capture_s")(ctx) is None
    ctx.result = types.SimpleNamespace(perf={"spans": {
        "hmc.traj.capture": {"seconds": 0.25}, "hmc.meas.capture": {"seconds": 0.5}}},
        k3_cycles=400, k3_res_cycles=100)
    assert _metric("capture_s")(ctx) == 0.75
    assert _metric("f64_cycles_pct.K3")(ctx) == 25.0
    ctx.result = types.SimpleNamespace(perf={"graph": {}})
    for name in ("cg_iters_per_chain_traj.action", "masked_passes_per_meas",
                 "f64_cycles_pct.K3", "capture_s"):
        assert _metric(name)(ctx) is None, name
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    new = [m for m in bench["per_layer"] if m["name"] in (
        "cg_iters_per_chain_traj.action", "f64_cycles_pct.K3",
        "masked_passes_per_meas", "capture_s")]
    assert len(new) == 4 and all(m["moves"] == "chain_traj_per_s" for m in new)


@pytest.mark.parametrize("result,share", [
    (None, None),                                   # a run without the counter
    (dict(k3_cycles=400, k3_res_cycles=100), None),  # the parent's clocks
    (dict(k3_cycles=0, k3_wait_cycles=0), None),
    (dict(k3_cycles=None, k3_wait_cycles=None), None),
    (dict(k3_cycles=400, k3_wait_cycles=0), 0.0),    # a one-block path
    (dict(k3_cycles=400, k3_wait_cycles=60), 15.0),
], ids=["cpu-run", "no-counter", "zero-cycles", "none", "one-block", "cluster"])
def test_cluster_wait_reader(tmp_path, result, share):
    """cluster_wait_pct.K3 is 100 k3_wait_cycles / k3_cycles, and None where
    either is missing or K3 counted no cycles; a CPU run keeps no clocks."""
    res = _run(tmp_path) if result is None else types.SimpleNamespace(**result)
    if result is None:
        assert res.k3_wait_cycles is None and res.k3_cycles is None
    got = _metric("cluster_wait_pct.K3")(types.SimpleNamespace(result=res))
    assert got == share if share is not None else got is None


def test_cluster_wait_metric_is_declared_for_the_cluster_cell():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == "cluster_wait_pct.K3"]
    assert m == {"name": "cluster_wait_pct.K3", "unit": "%", "better": "lower",
                 "source": "program_counter", "layer": "kernels",
                 "moves": "chain_traj_per_s", "workloads": ["vol128.gen"]}
    assert (REPO / "hmc_bench" / "metrics" / "cluster_wait_pct.K3.py").is_file()


def test_block_keeps_the_clock_layout_the_runner_reads():
    """Block.clocks is K3's [C, 4] buffer (total, f64 residuals, cluster
    waits, MRE forecast: ops/refined.solve_refined's layout), zeroed by
    reset, and read() sums each column over the chains into the BlockSums
    fields the runner adds up; without clocks the four are None."""
    C = 3
    theta = torch.zeros((C, 2, 4, 4))
    blk = Block(theta, clocks=True)
    assert blk.clocks.shape == (C, 4) and blk.clocks.dtype == torch.int64
    blk.clocks.copy_(torch.tensor([[100, 10, 5, 9], [200, 20, 0, 18], [300, 30, 7, 0]]))
    sums = blk.read()
    assert (sums.k3_cycles, sums.k3_res_cycles, sums.k3_wait_cycles,
            sums.k3_mre_cycles) == (600, 60, 12, 27)
    blk.reset()
    assert int(blk.clocks.abs().sum()) == 0
    none = Block(theta).read()
    assert (none.k3_cycles, none.k3_res_cycles, none.k3_wait_cycles,
            none.k3_mre_cycles) == (None,) * 4


@pytest.mark.card
def test_k3_adds_its_clocks():
    """On the card: two K3 launches into one zeroed clocks buffer leave each
    chain's total above its first launch's, the residual cycles below the
    total, no cluster waits on the one-block path, no MRE cycles from a
    start (K = 1), and x and the iterations bit for bit those of a call
    without clocks."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: K3 runs only there")
    dev = torch.device("cuda")
    C, n = 4, 32
    g = torch.Generator(device=dev).manual_seed(5)
    th = (2.0 * torch.rand((C, 2, n, n), generator=g, device=dev) - 1.0) * np.pi
    thE, thO = tr.pack_planes(th)
    b = torch.randn((C, 2, 2, n, n // 2), generator=g, device=dev)
    kw = dict(m0=0.2, tol=1e-10, fallback=True)
    plain = rs.solve_refined(thE, thO, b, b, **kw)
    clocks = torch.zeros((C, 4), dtype=torch.int64, device=dev)
    first = rs.solve_refined(thE, thO, b, b, clocks=clocks, **kw)
    once = clocks.clone()
    rs.solve_refined(thE, thO, b, b, clocks=clocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first.x, plain.x) and torch.equal(first.x64, plain.x64)
    assert torch.equal(first.iters, plain.iters)
    assert bool((once[:, 1] > 0).all() and (once[:, 1] < once[:, 0]).all())
    assert bool((clocks[:, 0] > once[:, 0]).all())
    assert bool((clocks[:, 1] > once[:, 1]).all() and (clocks[:, 1] < clocks[:, 0]).all())
    assert int(clocks[:, 2:].abs().sum()) == 0


@pytest.mark.card
def test_k3_counts_its_cluster_waits():
    """On the card, at 128x128 (a cluster of blocks a chain): each chain's
    cycles waiting on its cluster are above 0 and below its total, and x and
    the iterations are bit for bit those of a call without clocks."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: K3 runs only there")
    dev = torch.device("cuda")
    C, n = 4, 128
    assert rs.ru_card_route(n, n // 2, C, dev)[0] == rs.RU_CLUSTER
    g = torch.Generator(device=dev).manual_seed(6)
    th = (2.0 * torch.rand((C, 2, n, n), generator=g, device=dev) - 1.0) * np.pi
    thE, thO = tr.pack_planes(th)
    b = torch.randn((C, 2, 2, n, n // 2), generator=g, device=dev)
    kw = dict(m0=0.2, tol=1e-10, fallback=True)
    plain = rs.solve_refined(thE, thO, b, b, **kw)
    clocks = torch.zeros((C, 4), dtype=torch.int64, device=dev)
    got = rs.solve_refined(thE, thO, b, b, clocks=clocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.x64, plain.x64) and torch.equal(got.iters, plain.iters)
    assert bool(((clocks[:, 2] > 0) & (clocks[:, 2] < clocks[:, 0])).all())
