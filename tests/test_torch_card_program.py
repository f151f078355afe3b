"""On the card: the port's device programs and main paths.

The trajectory program's replays against eager steps bit for bit on six
branches, with the kernels one replay runs by name; the packed and the
mesh trajectory against the plain twins on the CPU on the same noise; the
main paths through ``run_hmc`` at 64x64 beta=4 m0=0.2 tau=0.1 C=32 (10 + 20
trajectories) and the rest of the sampler held to the run's gates; the
measurement program's replays against eager calls bit for bit, the
measurement phase under ``torch.cuda.set_sync_debug_mode("error")`` but
for the block reads, the gathers and the captures, against ``graph=False``
bit for bit; the condensate and the meson correlators against the twins
on the card; a checkpointed and resumed run against the unbroken one.

Run on a machine with a CUDA card:

    python -m pytest --noconftest tests/test_torch_card_program.py -m card

Without a card every test skips before it builds a kernel. The module
imports neither JAX nor the JAX package.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import (
    CGParams, HMCParams, LatticeParams, RunParams,
)
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc import program, sampler
from schwingermodel_tpu_torch.hmc.program import (
    Block, MeasurementProgram, TrajectoryProgram,
)
from schwingermodel_tpu_torch.io import checkpoint
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.parallel import multihost as mh
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh
from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn
from schwingermodel_tpu_torch.runner import hot_start, run_hmc
from schwingermodel_tpu_torch.scan import exact_quenched_plaquette
from schwingermodel_tpu_torch.solvers import cg as cg_mod
from schwingermodel_tpu_torch.solvers import refine
from schwingermodel_tpu_torch.tools import critical_mass
from schwingermodel_tpu_torch.utils import metrics

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")


DEV = torch.device("cuda", 0)
M0, BETA, NX, NT, C = 0.2, 4.0, 64, 64, 32
LATTICE = LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")
RUN = RunParams(n_therm=10, n_meas=20, n_steps=0, n_chains=C, seed=0)
RUN_SHORT = dataclasses.replace(RUN, n_therm=4, n_meas=8)
N_NOISE = 8
# the kernels by the names of their device functions
FAMILIES = {"K1 K5 K8": ("force_step_kernel", "force_shared_kernel", "ratio_force_kernel",
                         "halo_force"),
            "K2": ("solve_fused_kernel", "solve_shared_kernel"), "K3": ("solve_ru",),
            "K4": ("cg_fallback_kernel",), "K6": ("cg_eo",), "K7": ("halo_normal",),
            "K9": ("residual",), "noise": ("noise_kernel",), "z2": ("z2_kernel",)}
SOLVERS = ("K1 K5 K8", "K2", "K3", "K4", "K6", "K7", "K9")


def hmc_params(md_steps=10, refine_=True, tau=0.1, **kw):
    return HMCParams(beta=BETA, m0=M0, md_steps=md_steps, trajectory_length=tau,
                     even_odd=True, **kw,
                     cg=CGParams(tol=1e-10 if refine_ else 1e-6, max_iter=10000,
                                 refine=refine_, inner_tol=1e-5))


def _angles(seed, n, nx=NX, nt=NT):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (2.0 * torch.rand((n, 2, nx, nt), generator=g, device=DEV) - 1.0) * math.pi


def families(kernels):
    """The launches of each kernel family of FAMILIES among kernels by name."""
    return {fam: sum(c for k, c in kernels.items() if any(m in k for m in marks))
            for fam, marks in FAMILIES.items()}


def launches(fn):
    """fn() under a short torch.profiler window: the launches of each kernel
    family on the card (the trace may miss some of them)."""
    kernels = metrics.device_kernels(fn)
    assert kernels, "no kernel in the trace"
    return families(kernels)


def replayed(prog):
    """The launches of each kernel family a replay of a captured program
    makes: its graph's kernel nodes by the name the driver gives each."""
    assert "?" not in prog.kernels and sum(prog.kernels.values()) == prog.kernel_nodes > 0
    return families(prog.kernels)


def main_gates(res, run=RUN, n_chains=C):
    """What every main-path run must show."""
    assert res.all_converged and res.n_ill == 0
    assert 0.3 < res.acceptance_rate <= 1.0
    assert 0.0 < res.Ep < 1.0
    assert res.theta.shape == (n_chains, 2, NX, NT)
    assert bool(np.isfinite(np.asarray(res.theta)).all())
    assert abs(res.exp_mdH_mean - 1.0) < 0.1


# ---------- the trajectory program ----------

ACCUMULATORS = ("accepted", "cg_iters", "converged", "exp_mdH", "fallbacks", "action_iters",
                "unconverged", "fail_theta", "fail_seen", "fail_index")
BIG = LatticeParams(Nx=128, Nt=128, real_dtype="float32")
# (lattice, C, HMC parameters, launches of each family a replay: a count, or
# None for "some")
NO_MESH = {"K6": 0, "K7": 0}
BRANCHES = {
    "refined": (LATTICE, C, hmc_params(), {"K3": 10, "K1 K5 K8": 9, "K2": 0, **NO_MESH}),
    "loose": (LATTICE, C, hmc_params(refine_=False),
              {"K2": None, "K1 K5 K8": None, "K3": 0, "K9": 0, **NO_MESH}),
    "hasenbusch": (LATTICE, C, hmc_params(hasenbusch_dm=0.4), {"K3": None, "K2": 0}),
    "omelyan": (LATTICE, C, hmc_params(md_steps=5, integrator="omelyan"), {"K3": None}),
    "mre": (LATTICE, C, hmc_params(mre_history=4), {"K3": 10}),
    "mre tau=1": (LATTICE, C, hmc_params(md_steps=40, tau=1.0, mre_history=4), {"K3": 40}),
    "128x128": (BIG, 8, hmc_params(), {"K3": 10, "K2": 0}),
    "128x128 C=32": (BIG, 32, hmc_params(), {"K3": 10, "K2": 0}),
}
# the kernel nodes of a branch's replay, where the benchmark reads them
# (graph_nodes.traj: 128x128 C=32 is vol128.gen, K3 on the L2 path)
NODES = {"refined": 485, "128x128 C=32": 485}
# K3's kernel at 128x128 by its chains: clusters of 8 at C=8, and at C=32,
# whose clusters of 4 the card does not run at once, the L2 path
K3_KERNEL = {"128x128": "solve_ru_cluster_kernel", "128x128 C=32": "solve_ru_l2_kernel"}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_program_replays_equal_eager_steps(branch):
    """One step (the eager warm-up and the capture), then 10 replays, against
    11 eager hmc_trajectory_packed calls at the same indices into a Block:
    theta, every accumulator, the counter and the updates bit for bit; K3's
    clocks in the block on the refined branches; a replay's graph launches
    the noise kernel once, never K4's own entry, and the branch's kernels
    (its kernel nodes by name: one K3 node a solve), as many kernel nodes
    as the benchmark's cells read where NODES names them, and at 128x128
    K3's nodes all of the kernel K3_KERNEL names; a new step size is
    captured anew."""
    lat, n_chains, hmc, want = BRANCHES[branch]
    model = SchwingerModel(lattice=lat, hmc=hmc)
    theta0 = hot_start(lat, 0, n_chains, DEV)
    prog = TrajectoryProgram(model, theta0, 0, 0)
    prog.run(11)
    theta, blk = theta0.clone(), Block(theta0)
    for i in range(11):
        theta_next, st = hp.hmc_trajectory_packed(model, theta, 0, i)
        blk.add(theta, st, i)
        theta = theta_next
    torch.cuda.synchronize()
    assert torch.equal(prog.theta, theta)
    for name in ACCUMULATORS:
        assert torch.equal(getattr(prog.block, name), getattr(blk, name)), name
    assert int(prog.index) == 11 and prog.block.updates == blk.updates == 11 * n_chains
    assert prog.stats()["captures"] == 1 and prog.stats()["replays"] == 10
    if hmc.cg.refine:
        cyc = prog.block.clocks
        assert bool((cyc[:, 0] > cyc[:, 1]).all() and (cyc[:, 1] > 0).all())
    got = replayed(prog)
    assert got["noise"] == 1 and got["K4"] == 0, got
    assert prog.kernel_nodes == NODES.get(branch, prog.kernel_nodes)
    if branch in K3_KERNEL:
        assert sum(c for k, c in prog.kernels.items() if K3_KERNEL[branch] in k) == got["K3"]
    for fam, n in want.items():
        assert (got[fam] > 0 if n is None else got[fam] == n), (fam, got)
    prog.dt = 0.5 * hmc.step_size
    prog.step()
    torch.cuda.synchronize()
    assert prog.captures == 2


@pytest.mark.parametrize("branch", ["refined leapfrog", "loose leapfrog",
                                    "refined hasenbusch omelyan", "loose hasenbusch leapfrog"])
def test_packed_trajectory_against_the_cpu_twins(branch):
    """One 64x64 trajectory of 4 chains through the kernels against the same
    trajectory through the plain twins on the CPU, same noise: |ddH| <
    5e-3, |dtheta'| < 2e-4, equal accept decisions, every solve
    converged."""
    hmc = {"refined leapfrog": hmc_params(), "loose leapfrog": hmc_params(refine_=False),
           "refined hasenbusch omelyan": hmc_params(md_steps=3, hasenbusch_dm=0.4,
                                                    integrator="omelyan"),
           "loose hasenbusch leapfrog": hmc_params(md_steps=6, refine_=False,
                                                   hasenbusch_dm=0.4)}[branch]
    model = SchwingerModel(lattice=LATTICE, hmc=hmc)
    theta = _angles(31, 4)
    pi, chi, r = hp.draw_chain_noise(model, 99, 0, 4, DEV)
    th_k, st_k = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    th_p, st_p = hp.trajectory_packed_given_noise(model, theta.cpu(), pi.cpu(), chi.cpu(),
                                                  r.cpu())
    assert bool(st_k.cg_converged.all()) and bool(st_p.cg_converged.all())
    assert (st_k.delta_H.cpu() - st_p.delta_H).abs().max().item() < 5e-3
    assert (th_k.cpu() - th_p).abs().max().item() < 2e-4
    assert torch.equal(st_k.accepted.cpu(), st_p.accepted)


def _wrapped(a, b):
    """max |a - b| of angles, a difference of 2 pi counting as none (the
    packed path folds to [-pi, pi], the sampler wraps to [-pi, pi))."""
    return (torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi).abs().max().item()


@pytest.mark.parametrize("refine_", [True, False], ids=["refined", "loose"])
def test_mesh_trajectory_against_twins_packed_and_unpacked(refine_):
    """One 64x64 trajectory of 4 chains on 2x2 shards (K7, K8) against the
    same on the plain twins on the CPU, against the packed path and
    against the unpacked sampler without a mesh (its f32 solves on K6), all
    on the same noise: |ddH| < 5e-3, |dtheta'| < 2e-4, equal accept
    decisions, every solve converged."""
    model = SchwingerModel(lattice=LATTICE, hmc=hmc_params(refine_=refine_))
    theta = _angles(32, 4)
    pi, chi, r = hp.draw_chain_noise(model, 98, 0, 4, DEV)
    step = make_sharded_traj_fn(model, lattice_mesh((2, 2)))
    th_k, st_k = step.given_noise(theta, pi, chi, r)
    th_p, st_p = step.given_noise(theta.cpu(), pi.cpu(), chi.cpu(), r.cpu())
    th_m, st_m = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    out = {}
    k6 = launches(lambda: out.update(u=sampler.trajectory_given_noise(model, theta, pi, chi,
                                                                      r)))["K6"]
    th_u, st_u = out["u"]
    assert k6 >= model.hmc.md_steps
    for st in (st_k, st_p, st_m, st_u):
        assert bool(st.cg_converged.all())
    assert (st_k.delta_H.cpu() - st_p.delta_H).abs().max().item() < 5e-3
    assert (th_k.cpu() - th_p).abs().max().item() < 2e-4
    for th, st in ((th_m, st_m), (th_u, st_u)):
        assert (st_k.delta_H - st.delta_H).abs().max().item() < 5e-3
        assert _wrapped(th_k, th) < 2e-4
        assert torch.equal(st_k.accepted, st.accepted)
    assert torch.equal(st_k.accepted.cpu(), st_p.accepted)


# ---------- the main paths and the rest of the sampler ----------

@pytest.mark.parametrize("hmc", [hmc_params(), hmc_params(refine_=False),
                                 hmc_params(hasenbusch_dm=0.4),
                                 hmc_params(md_steps=5, integrator="omelyan")],
                         ids=["refined", "loose", "hasenbusch", "omelyan"])
def test_main_path(hmc):
    """The packed path on its device program, 10 + 20 trajectories of 32
    chains: every solve converged, the gates of the run."""
    main_gates(run_hmc(LATTICE, hmc, RUN, device=DEV))


def test_near_critical_hasenbusch_row():
    """tools/bench_points' near-critical row (32x32 beta=2 m0=-0.19 dm=0.4
    md=26 tau=1, refined, max_iter 20000) from a cold start, 4 + 8
    trajectories of 32 chains: every dH finite."""
    model = SchwingerModel(
        lattice=LatticeParams(Nx=32, Nt=32, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=-0.19, md_steps=26, trajectory_length=1.0, even_odd=True,
                      hasenbusch_dm=0.4, cg=CGParams(tol=1e-10, max_iter=20000, refine=True,
                                                     inner_tol=1e-5)))
    theta = torch.zeros((C, 2, 32, 32), device=DEV)
    for i in range(12):
        theta, st = hp.hmc_trajectory_packed(model, theta, 0, i)
        assert bool(torch.isfinite(st.delta_H).all()), i


MESH22 = lattice_mesh((2, 2))
F64 = LatticeParams(Nx=NX, Nt=NT, real_dtype="float64")
# the kernel families one eager trajectory of each run's path launches, and
# those it must not (no packed solve on the mesh paths, no hand-written
# solver kernel on the quenched, full-D and f64 sampler)
PATH_KERNELS = {
    "refined on 2x2": (("K7",), ("K2", "K3", "K4", "K6")),
    "loose on 2x2": (("K7",), ("K2", "K3", "K4", "K6")),
    "autotune": (("K3",), ("K2", "K4", "K6", "K7")),
    "quenched": ((), SOLVERS),
    "full-d": ((), SOLVERS),
    "f64": ((), SOLVERS),
    "hasenbusch on 2x2": (("K7",), ("K1 K5 K8", "K2", "K3", "K4", "K6")),
}


@pytest.mark.parametrize("case", list(PATH_KERNELS))
def test_sampler_run(case):
    """The rest of the sampler, 4 + 8 trajectories (the autotune 8 + 20
    with 8 warm-up trajectories) of 32 chains at the demo point: the
    refined and the loose demo on 2x2 shards, the refined demo with
    --autotune (one warm-up line, md_steps >= 2), a quenched run (no CG
    iteration, <P> below I1(4)/I0(4) + 0.05 on its way up from the hot
    start), the refined demo on full-D pseudofermions, the demo in f64 and
    Hasenbusch dm=0.4 on 2x2 shards; each held to the gates of the run.
    Then one more trajectory of 4 of its chains, eager, under the profiler:
    the kernel families of PATH_KERNELS that its path runs, and none of
    those it must not."""
    lat, hmc, run, mesh = LATTICE, hmc_params(), RUN_SHORT, None
    if case == "autotune":
        run = dataclasses.replace(RUN, n_therm=8, autotune=True, n_tune=8)
    elif case == "quenched":
        hmc = hmc_params(quenched=True)
    elif case == "full-d":
        hmc = dataclasses.replace(hmc, even_odd=False)
    elif case == "f64":
        lat, hmc = F64, dataclasses.replace(hmc, cg=CGParams(tol=1e-10, max_iter=10000,
                                                             refine=False))
    elif case.endswith("on 2x2"):
        mesh = MESH22
        hmc = {"refined": hmc, "loose": hmc_params(refine_=False),
               "hasenbusch": hmc_params(hasenbusch_dm=0.4)}[case.split()[0]]
    msgs = []
    res = run_hmc(lat, hmc, run, device=DEV, mesh=mesh, progress=msgs.append)
    main_gates(res, run)
    if run.autotune:
        tune = [m for m in msgs if m.startswith("autotune")]
        assert len(tune) == 1 and res.hmc.md_steps >= 2 and res.tuned_eps > 0
    if hmc.quenched:
        assert res.cg_iters_total == 0
        assert res.Ep < float(exact_quenched_plaquette(BETA)) + 0.05
    model = SchwingerModel(lattice=lat, hmc=res.hmc)
    if mesh is not None:
        step = make_sharded_traj_fn(model, mesh)
    elif hp.packed_eligible(model):
        step = lambda th, s, i: hp.hmc_trajectory_packed(model, th, s, i)  # noqa: E731
    else:
        step = lambda th, s, i: sampler.hmc_trajectory(model, th, s, i)  # noqa: E731
    theta = torch.as_tensor(res.theta[:4], device=DEV)
    got = launches(lambda: step(theta, 0, res.traj_index))
    present, absent = PATH_KERNELS[case]
    for fam in present:
        assert got[fam] > 0, (fam, got)
    for fam in absent:
        assert got[fam] == 0, (fam, got)


def test_plain_cg_graph_equals_its_eager_loop(monkeypatch):
    """The plain CG of the unpacked sampler replays one iteration as a CUDA
    graph: on a 16x16 f64 full-D solve of 4 chains x and the iterations
    equal the eager loop's bit for bit, every chain converged."""
    model = SchwingerModel(lattice=LatticeParams(Nx=16, Nt=16, real_dtype="float64"),
                           hmc=HMCParams(beta=2.0, m0=0.2, cg=CGParams(tol=1e-10,
                                                                       max_iter=10000)))
    g = torch.Generator(device=DEV).manual_seed(33)
    theta = (2.0 * torch.rand((4, 2, 16, 16), generator=g, device=DEV,
                              dtype=torch.float64) - 1.0) * math.pi
    b = torch.randn((4, 2, 16, 16), generator=g, device=DEV, dtype=torch.complex128)
    graphed = model.solve_normal(theta, b)
    monkeypatch.setattr(cg_mod, "_loop_graphed", cg_mod._loop)
    eager = model.solve_normal(theta, b)
    assert torch.equal(graphed.x, eager.x) and torch.equal(graphed.iters, eager.iters)
    assert bool(graphed.converged.all())


def test_checkpoint_and_resume_equal_the_unbroken_run(tmp_path):
    """The refined demo, 4 + 4 trajectories, a checkpoint, and 4 more from it:
    the final configuration and the plaquette chain bit for bit those of
    the unbroken 4 + 8 run, which passes the gates."""
    first = run_hmc(LATTICE, hmc_params(), dataclasses.replace(RUN_SHORT, n_meas=4),
                    device=DEV)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, theta=first.theta, key=first.key,
                               traj_index=first.traj_index, lattice=LATTICE, hmc=first.hmc,
                               run=RUN_SHORT)
    state = checkpoint.load_checkpoint(path)
    rest = run_hmc(state["lattice"], state["hmc"],
                   dataclasses.replace(state["run"], n_therm=0, n_meas=4), device=DEV,
                   initial_theta=state["theta"], start_traj_index=state["traj_index"])
    whole = run_hmc(LATTICE, hmc_params(), RUN_SHORT, device=DEV)
    assert rest.traj_index == whole.traj_index == 12
    np.testing.assert_array_equal(rest.theta, whole.theta)
    np.testing.assert_array_equal(rest.chains["plaquette"], whole.chains["plaquette"][4:])
    np.testing.assert_array_equal(first.chains["plaquette"], whole.chains["plaquette"][:4])
    main_gates(whole, RUN_SHORT)


# ---------- the measurement ----------

@pytest.fixture(scope="module")
def final_theta():
    """The refined demo's final configurations, 10 + 20 trajectories."""
    res = run_hmc(LATTICE, hmc_params(), RUN, device=DEV)
    main_gates(res)
    return torch.as_tensor(res.theta, device=DEV)


def test_condensate_kernels_against_twins_on_the_card(final_theta):
    """The refined condensate of 8 noise vectors on the demo's final
    configurations through the kernels and through the plain twins on the
    card, same noise: every flag true, the values to rtol 1e-6."""
    model = SchwingerModel(lattice=LATTICE, hmc=hmc_params())
    zs = obs.condensate_noise(1, 0, C, final_theta.shape, N_NOISE, DEV)
    k = obs.chiral_condensate_given_noise(model, final_theta, zs)
    p = obs.chiral_condensate_given_noise(
        dataclasses.replace(model, eo_kernels=refine.PLAIN), final_theta, zs)
    assert bool(k.converged.all()) and bool(p.converged.all())
    assert ((k.value - p.value).abs() / p.value.abs()).max().item() <= 1e-6


def test_mesons_against_twins_on_the_card(final_theta):
    """The meson correlators at 64x64 on two of the demo's final
    configurations through the kernels and the plain twins on the card:
    every flag true, C_PP and C_A0P to 1e-6 of each chain's scale (the
    far-t values lie below the solves' 1e-10 absolute accuracy)."""
    model = SchwingerModel(lattice=LATTICE, hmc=hmc_params())
    k = obs.meson_correlators(model, final_theta[:2])
    p = obs.meson_correlators(dataclasses.replace(model, eo_kernels=refine.PLAIN),
                              final_theta[:2])
    assert bool(k.converged.all()) and bool(p.converged.all())
    for a, b in ((k.C_PP, p.C_PP), (k.C_A0P, p.C_A0P)):
        assert ((a - b).abs() / b.abs().amax(dim=1, keepdim=True)).max().item() <= 1e-6


@pytest.mark.parametrize("refine_", [True, False], ids=["refined", "loose"])
def test_measurement_replays_equal_eager_calls(final_theta, refine_):
    """The measurement with the condensate of 8 vectors on the demo's final
    configurations as a MeasurementProgram: 10 replays after the capture
    against 10 eager calls at the same indices, every value, flag and
    iteration bit for bit, every solve converged; a replay's graph draws the
    Z2 noise once and runs K6, and K9 and K4's own entry (once) only on the
    refined contract (its kernel nodes by name)."""
    model = SchwingerModel(lattice=LATTICE, hmc=hmc_params(refine_=refine_))

    def measure(th, i):
        out = obs.measure_all(model, th)
        cc = obs.chiral_condensate(model, th, 1, i, N_NOISE)
        out.update(chiral_condensate=cc.value, converged=cc.converged, iters=cc.iters)
        return out

    static = final_theta.clone()
    prog = MeasurementProgram(measure, static, 12)
    prog.run(11)
    rows = [measure(static, i) for i in range(1, 11)]
    torch.cuda.synchronize()
    for i, row in enumerate(rows):
        for k, v in row.items():
            assert torch.equal(prog.out[k][i + 1], v), (i, k)
    assert bool(prog.out["converged"][:11].all())
    got = replayed(prog)
    assert got["z2"] == 1 and got["K6"] > 0 and (got["K9"] > 0) is refine_, got
    assert got["K4"] == int(refine_), got


def _sync_guard(monkeypatch):
    """torch.cuda.set_sync_debug_mode("error") over the runner's measurement
    phase, off for its block reads, its final gathers and the programs'
    captures (a host read inside a capture fails the capture itself);
    returns the list of measurement phases it guarded."""
    phases = []
    span = metrics.PerfMonitor.span

    @contextlib.contextmanager
    def guarded(mon, name):
        with span(mon, name) as st:
            if name != "hmc.measure":
                yield st
                return
            phases.append(name)
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield st
            finally:
                torch.cuda.set_sync_debug_mode(0)

    def allowed(fn):
        def call(*a, **k):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call

    monkeypatch.setattr(metrics.PerfMonitor, "span", guarded)
    monkeypatch.setattr(program.Block, "read", allowed(program.Block.read))
    monkeypatch.setattr(program._GraphedStep, "_capture",
                        allowed(program._GraphedStep._capture))
    monkeypatch.setattr(mh, "gather_chains", allowed(mh.gather_chains))
    return phases


@pytest.mark.parametrize("refine_", [True, False], ids=["refined", "loose"])
def test_condensate_demo_on_the_graph_equals_eager(refine_, monkeypatch):
    """The demo with --condensate --n-noise 8 on its device programs, its
    measurement phase under set_sync_debug_mode("error") but for the block
    reads, the gathers and the captures: the gates of the run, every
    condensate solve converged, a finite [n_meas, C] condensate chain, one
    measurement capture and n_meas - 1 replays; theta, every observable's
    chain and the condensate's iterations bit for bit the eager run's
    (graph=False)."""
    hmc = hmc_params(refine_=refine_)
    kw = dict(device=DEV, measure_condensate=True, n_noise=N_NOISE)
    with monkeypatch.context() as m:
        phases = _sync_guard(m)
        a = run_hmc(LATTICE, hmc, RUN, graph=True, **kw)
    assert phases == ["hmc.measure"]
    b = run_hmc(LATTICE, hmc, RUN, graph=False, **kw)
    main_gates(a)
    assert a.condensate_converged
    cc = a.chains["chiral_condensate"]
    assert cc.shape == (RUN.n_meas, C) and bool(np.isfinite(cc).all())
    mg = a.perf["measurement_graph"]
    assert mg["captures"] == 1 and mg["replays"] == RUN.n_meas - 1
    np.testing.assert_array_equal(a.theta, b.theta)
    for k in a.chains:
        np.testing.assert_array_equal(a.chains[k], b.chains[k])
    assert a.condensate_iters == b.condensate_iters


def test_critical_mass_point_on_programs_equals_eager():
    """tools/critical_mass.run_point at 8x8 beta=2 m0=-0.1 C=8 on its
    device programs against its eager run: the row equal."""
    import argparse

    args = argparse.Namespace(beta=2.0, md_steps=20, tau=1.0, chains=8, n_therm=20,
                              n_blocks=4, n_skip=2, seed=3)
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float32")
    rows = [critical_mass.run_point(args, -0.1, DEV, lat, graph=g) for g in (True, False)]
    assert rows[0] == rows[1]
