"""The outer Monte-Carlo loop: thermalize, measure, accumulate, summarize.

Counterpart of ``run_hmc`` in ``schwingermodel_tpu/runner.py`` on one
device (reference HMC::HMC_algorithm, src/hmc.cpp:183-215, and
src/main.cpp:148-174): hot or cold start (or a resumed configuration and
trajectory counter), an optional step-size warm-up (hmc/autotune.py), C
independent chains advanced together by the main-path trajectory
(hmc/packed.py) where it applies (even-odd f32 pseudofermions without a
mesh), else by the unpacked sampler (hmc/sampler.py: quenched, full-D, f64)
or, given a mesh, by the lattice-sharded step (parallel/sharded.py: the
unpacked sampler on the blocks of the mesh, all shards on the one device),
thermalization and
measurement blocks in the reference's order (update, measure, then
n_steps decorrelation updates, none after the last measurement), the
20-bin jackknife with multi-chain pooling, the dump of the configuration
that preceded a failed solve, and the SimData summary.

On the packed paths the trajectories of a block run as the JAX runner runs
its jitted ``block``: as a device program (hmc/program.py), on the card one
replay of a CUDA graph a trajectory that draws the noise at a trajectory
counter on the card, runs the trajectory and adds to the block's
accumulators; and each measurement as one replay of a second graph
(``MeasurementProgram``) that measures the program's static theta, draws
the condensate's noise at a measurement counter on the card and writes
its row of the phase's buffers on the card. So nothing reads the host
inside the measurement phase but the block's read (once a phase, or once
a measurement with ``save_conf``) and the final gather. The
configurations and the first-failure dump read clones of the static
theta. The warm-up stays eager; so do the mesh and the unpacked paths
and ``graph=False``, on the same noise.

Per-trajectory statistics (accept flags, CG iterations, convergence flags)
and the first-failure capture stay on the device and are read once per
block, as the JAX runner's ``_stat_scalars`` does: a thermalization block
is 100 trajectories, the measurement phase is one block (or one per
measurement when configurations are saved). With ``measure_condensate``
each measurement adds the chiral condensate of every chain
(observables.chiral_condensate, ``n_noise`` Z2xZ2 vectors per chain, all
C * n_noise solves in one batch, the restart refinement with no host
read); its values and flags stay on the device until the phase ends.
The configuration stays global between trajectories, so the measurements
are the same with and without a mesh. The warm-up reads the pooled
acceptance once per trajectory (the next step size depends on it).

Across processes (``mesh=parallel.multihost.multihost_mesh()``, one
chain group a process, or ``multihost_mesh(rx, rt)``, one a plane of rx rt
processes, each with one shard of its group's lattice) each process holds
its group's slice of the chains: its slice of the one-process hot start,
and the noise of each chain's global index. The block statistics are kept
per chain and gathered once per block in global chain order, then reduced
in that order on the host, as the observables are at the end of the run,
so the averages are those of one process holding every chain. SimData, configurations and ill
configurations are written by the primary only, after the gather (JAX
runner.py:262,339-356,535-537).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import HMCParams, LatticeParams, RunParams
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc import program
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.io import ctxt
from schwingermodel_tpu_torch.io.checkpoint import seed_key
from schwingermodel_tpu_torch.io.simdata import SimData, simdata_filename
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import _cuda
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.parallel import multihost as mh
from schwingermodel_tpu_torch.utils import prng, statistics
from schwingermodel_tpu_torch.utils.metrics import PerfMonitor

THERM_BLOCK = 100


def _traj_fn(model: SchwingerModel, mesh, chains=None) -> Callable:
    """The trajectory step (theta, seed, traj_index, dt=None) -> (theta',
    stats): the sharded step on a mesh; without one the packed main path
    where the model is on it, else the unpacked sampler; with ``chains``
    (a multihost.ChainMesh) any of them on this process's chain group, the
    sharded step on this process's shard of the group's lattice mesh. The
    packed steps carry ``.program(theta, seed, start_index)``, their
    hmc/program.TrajectoryProgram."""
    if chains is not None:
        from schwingermodel_tpu_torch.parallel import sharded

        if chains.lattice is not None:
            return sharded.make_sharded_traj_fn(model, chains.lattice,
                                                chain_group=chains.index)
        if sharded.chain_packed_supported(model, chains):
            return sharded.make_chain_sharded_packed_traj_fn(model, chains)
        return lambda theta, seed, i, dt=None: sampler.hmc_trajectory(
            model, theta, seed, i, dt=dt,
            chain_offset=chains.index * theta.shape[0])
    if mesh is not None:
        from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn

        return make_sharded_traj_fn(model, mesh)
    if hp.packed_eligible(model):
        return program.packed_step(model)
    return lambda theta, seed, i, dt=None: sampler.hmc_trajectory(
        model, theta, seed, i, dt=dt)


@dataclasses.dataclass
class RunResult:
    Ep: float               # mean plaquette (per site)
    dEp: float              # 20-bin jackknife error
    gS: float               # gauge action density
    dgS: float
    acceptance_rate: float  # accepted / total post-thermalization updates
    elapsed_seconds: float
    chains: dict            # observable -> np.ndarray [n_meas, n_chains]
    n_ill: int              # ill (unconverged-solve) configurations dumped
    theta: np.ndarray       # final configuration(s)
    traj_index: int         # trajectories consumed (per chain)
    key: Optional[np.ndarray] = None     # the root seed as a key array (checkpoints)
    hmc: Optional[HMCParams] = None      # the parameters as run (md_steps after tuning)
    tuned_eps: Optional[float] = None    # the warm-up's step size, if it ran
    cg_iters_total: int = 0
    all_converged: bool = True
    exp_mdH_mean: float = float("nan")   # <exp(-dH)> over measured trajectories
    # the spans, each device program's stats and, where K3 ran on the card,
    # "k3": {"path": its path's name, "waves": its waves a launch}
    perf: Optional[dict] = None
    ill_records: list = dataclasses.field(default_factory=list)
    condensate_converged: bool = True    # every condensate solve converged
    condensate_iters: int = 0            # CG iterations of the condensate solves
    cg_fallback_solves: int = 0          # chain solves of the packed path that ran the f64 fallback
    action_iters_total: int = 0          # of cg_iters_total, the Metropolis action solves' (packed path)
    unconverged_chain_trajs: int = 0     # chain-trajectories with an unconverged solve
    # K3's clock cycles summed over its launches and the chains, of those the
    # cycles in its f64 true residuals, those its first thread spent waiting
    # on the other blocks of its cluster (0 off the cluster path), and those
    # that thread spent in the MRE forecast (0 without it): the device
    # program's, on the card; else None
    k3_cycles: Optional[int] = None
    k3_res_cycles: Optional[int] = None
    k3_wait_cycles: Optional[int] = None
    k3_mre_cycles: Optional[int] = None
    # per measurement, the restart passes of the condensate's refinement in
    # which any solve was active (of cg.max_outer); None without it
    condensate_active_passes: Optional[np.ndarray] = None

    def summary(self, name: str) -> dict:
        return statistics.binned_summary(np.asarray(self.chains[name]).reshape(-1))


def hot_start(lattice: LatticeParams, seed: int, n_chains: int, device):
    """Uniform random angles in [-pi, pi) (reference RandomU1,
    src/gauge_conf.cpp:23-36) of n_chains chains, drawn from one generator
    (a chain group takes its slice of the draw of every chain)."""
    g = prng.init_generator(seed, device)
    u = torch.rand((n_chains, 2, lattice.Nx, lattice.Nt), generator=g,
                   dtype=lattice.rdtype, device=device)
    return (2.0 * u - 1.0) * math.pi


def cold_start(lattice: LatticeParams, n_chains: int = 1, device="cpu"):
    """Zero angles, unit links (JAX ``cold_start``): [2, Nx, Nt] for one
    chain, else [n_chains, 2, Nx, Nt], in the working real dtype."""
    shape = (2, lattice.Nx, lattice.Nt)
    if n_chains > 1:
        shape = (n_chains,) + shape
    return torch.zeros(shape, dtype=lattice.rdtype, device=device)


def run_hmc(
    lattice: LatticeParams,
    hmc: HMCParams,
    run: RunParams,
    *,
    device="cuda",
    initial_theta=None,
    start_traj_index: int = 0,
    progress: Optional[Callable[[str], None]] = None,
    write_simdata: bool = False,
    measure_condensate: bool = False,
    n_noise: int = 8,
    mesh=None,
    graph: bool = True,
) -> RunResult:
    """Full simulation on one device (reference main.cpp:148-174 +
    hmc.cpp:183-215). The lattice mesh is run.mesh_shape = (rx, rt): the
    lattice-sharded step on rx x rt shards, or the packed main path for
    None and (1, 1) (the unpacked sampler where the model is off that
    path). mesh: the parallel.mesh.LatticeMesh to use for it, in place of
    one built here; it must agree with run.mesh_shape where that is set.
    start_traj_index: the trajectory counter to continue from (a resumed
    run: with initial_theta from the checkpoint, the noise streams go on
    where they stopped). A multihost.ChainMesh as ``mesh`` runs this
    process's chain group of the run.n_chains chains (module docstring);
    initial_theta is then the configuration of every chain (or one, for
    all), and the result's theta and chains are every chain's on every
    process. The packed paths (one process, or its chain group) run their
    thermalization and measurement trajectories as a device program
    (hmc/program.py: on the card one CUDA graph replay each, captured once
    after the warm-up); graph=False issues them from the host one eager
    call each instead (the on-card comparison)."""
    t_begin = time.perf_counter()
    log = progress or (lambda s: None)
    perf = PerfMonitor()
    with perf.span("hmc.run"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if device.type == "cuda":
            with perf.span("hmc.library"):
                _cuda.KERNELS.build()
        chain_mesh = None
        if isinstance(mesh, mh.ChainMesh):
            if run.mesh_shape not in (None, (1, 1), mesh.shape, mesh.shape[1:]):
                raise ValueError(f"run.mesh_shape {run.mesh_shape} disagrees with "
                                 f"the chain mesh {mesh.shape}")
            chain_mesh, mesh = mesh, None
        elif mesh is None and run.mesh_shape not in (None, (1, 1)):
            from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh

            mesh = lattice_mesh(run.mesh_shape)
        elif mesh is not None and run.mesh_shape not in (None, mesh.shape):
            raise ValueError(f"run.mesh_shape {run.mesh_shape} disagrees with the "
                             f"mesh given, {mesh.shape}")
        model = SchwingerModel(lattice=lattice, hmc=hmc)
        n_chains = run.n_chains
        mine = (chain_mesh.local_chains(n_chains) if chain_mesh is not None
                else slice(0, n_chains))
        n_groups = chain_mesh.groups if chain_mesh is not None else 1

        if initial_theta is None:
            theta = hot_start(lattice, run.seed, n_chains, device)
        else:
            theta = torch.as_tensor(np.asarray(initial_theta), dtype=lattice.rdtype,
                                    device=device)
            if theta.ndim == 3:
                theta = theta.expand(n_chains, *theta.shape)
        theta = theta[mine].contiguous()

        # ---- optional step-size warm-up (hmc/autotune.py) ----
        n_therm_left = run.n_therm
        tuned_eps = None
        if run.autotune:
            from schwingermodel_tpu_torch.hmc import autotune as at

            tune_step = _traj_fn(model, mesh, chain_mesh)
            n_tune = min(run.n_tune, run.n_therm) if run.n_therm else run.n_tune
            theta, hmc_tuned, tuned_eps = at.autotune(
                model, theta, run.seed, n_tune=n_tune, target=run.tune_target,
                traj_fn=lambda th, seed, i, dt: tune_step(th, seed, i, dt=dt))
            n_therm_left = max(0, run.n_therm - n_tune)
            if hmc_tuned.md_steps != hmc.md_steps:
                log(f"autotune: eps={tuned_eps:.5f} -> md_steps "
                    f"{hmc.md_steps} -> {hmc_tuned.md_steps} "
                    f"(dt {hmc.step_size:.5f} -> {hmc_tuned.step_size:.5f})")
            else:
                log(f"autotune: eps={tuned_eps:.5f}, md_steps={hmc.md_steps} kept")
            hmc = hmc_tuned
            model = SchwingerModel(lattice=lattice, hmc=hmc)
        traj = _traj_fn(model, mesh, chain_mesh)

        simdata = None
        if write_simdata and mh.is_primary():
            simdata = SimData(os.path.join(
                run.out_dir, simdata_filename(lattice.Nx, lattice.Nt, hmc.m0)))
            rx, rt = (mesh.shape if mesh is not None else chain_mesh.shape[1:]
                      if chain_mesh is not None else (1, 1))
            simdata.write_header(
                Nx=lattice.Nx, Nt=lattice.Nt, ranks_x=rx, ranks_t=rt,
                beta=hmc.beta, n_therm=run.n_therm, n_meas=run.n_meas,
                n_steps=run.n_steps, trajectory_length=hmc.trajectory_length,
                md_steps=hmc.md_steps, cg_max_iter=hmc.cg.max_iter,
                cg_tol=hmc.cg.tol, m0=hmc.m0,
                cg_force_tol=hmc.cg.resolved_force_tol(),
            )

        traj_index = int(start_traj_index)
        n_ill = 0
        cg_iters_total = 0
        fallback_solves = 0
        action_iters_total = 0
        unconverged = 0
        k3 = None      # K3's [cycles, of those in f64 residuals, in waits, in MRE], on the card
        all_converged = True
        ill_records = []

        # the packed paths run as a device program (hmc/program.py): on the card
        # one CUDA graph replay a trajectory, eager on the CPU
        prog = (traj.program(theta, run.seed, traj_index, tracer=perf)
                if graph and hasattr(traj, "program") else None)

        def new_block(theta) -> program.Block:
            if prog is None:
                return program.Block(theta)
            prog.block.reset()
            return prog.block

        def advance(theta, blk: program.Block, n: int):
            nonlocal traj_index
            if prog is not None:
                prog.run(n)
                traj_index += n
                return prog.theta.clone()
            for _ in range(n):
                theta_next, st = traj(theta, run.seed, traj_index)
                blk.add(theta, st, traj_index)
                theta = theta_next
                traj_index += 1
            return theta

        def close(blk: program.Block):
            """Read the block's statistics once; dump the captured first-failure
            configurations (reference dumps from inside Force,
            src/hmc.cpp:48-56)."""
            nonlocal cg_iters_total, all_converged, fallback_solves
            nonlocal action_iters_total, unconverged, k3
            with perf.span("hmc.block.read"):
                sums = blk.read()
            cg_iters_total += sums.cg_iters
            fallback_solves += sums.fallbacks
            action_iters_total += sums.action_iters
            unconverged += sums.unconverged
            all_converged &= sums.all_converged
            if sums.k3_cycles is not None:
                k3 = [a + b for a, b in zip(
                    k3 or (0, 0, 0, 0), (sums.k3_cycles, sums.k3_res_cycles,
                                         sums.k3_wait_cycles, sums.k3_mre_cycles))]
            if not sums.all_converged:
                dump(blk)
            return sums.accepted, sums.cg_iters, sums.exp_mdH

        def dump(blk: program.Block):
            nonlocal n_ill
            with perf.span("hmc.dump"):
                # every process takes part in the gathers; chains in global order
                seen = mh.gather_chains(blk.fail_seen).tolist()
                th = mh.gather_global(blk.fail_theta)
                idx = mh.gather_chains(blk.fail_index).tolist()
                for c in np.nonzero(seen)[0]:
                    name = ctxt.ill_conf_filename(lattice.Nx, lattice.Nt,
                                                  hmc.beta, hmc.m0, n_ill)
                    if mh.is_primary():
                        ctxt.write_conf(os.path.join(run.out_dir, name),
                                        ctxt.links_from_theta(th[c]))
                    ill_records.append({"traj_index": idx[c], "chain": int(c),
                                        "file": name})
                    n_ill += 1
                    log(f"CG failed to converge at trajectory {idx[c]}"
                        + (f" (chain {c})" if n_chains > 1 else "")
                        + f"; pre-trajectory configuration dumped to {name}")

        # ---- thermalization (hmc.cpp:187-191) ----
        done = 0
        with perf.span("hmc.thermalize"):
            while done < n_therm_left:
                n = min(THERM_BLOCK, n_therm_left - done)
                blk = new_block(theta)
                theta = advance(theta, blk, n)
                _, it, _ = close(blk)
                perf.add(trajectories=blk.updates * n_groups, cg_iters=it)
                done += n
                log(f"{done} thermalization configurations generated")

        # ---- measurements (hmc.cpp:196-212): update, measure, then n_steps
        # decorrelation updates (none after the last measurement) ----
        def measure(th, i):
            """The measurement of configuration(s) th at measurement index i (an
            int, or the measurement program's counter on the card)."""
            out = obs.measure_all(model, th)
            if measure_condensate:
                cc = obs.chiral_condensate(model, th, run.seed, i, n_noise,
                                           chain_offset=mine.start)
                out["chiral_condensate"] = cc.value
                out["condensate_converged"] = cc.converged.all(dim=1)
                out["condensate_iters"] = cc.iters.sum(dim=1, dtype=torch.int64)
                if cc.passes is not None:
                    # the restart passes its noise vectors' solves kept active
                    out["condensate_passes"] = cc.passes.amax(dim=1)
            return out

        # the packed paths measure the program's static theta as a device
        # program too: on the card one CUDA graph replay a measurement
        mprog = (program.MeasurementProgram(measure, prog.theta, run.n_meas,
                                            tracer=perf)
                 if prog is not None else None)
        rows = []
        accepted_total = 0
        updates_total = 0
        exp_mdH_sum = 0.0
        with perf.span("hmc.measure"):
            iters_before = cg_iters_total
            blk = new_block(theta)
            for i in range(run.n_meas):
                theta = advance(theta, blk, 1 if i == 0 else 1 + run.n_steps)
                if mprog is not None:
                    mprog.step()
                else:
                    rows.append(measure(theta, i))
                if run.save_conf:
                    acc, _, em = close(blk)
                    accepted_total += acc
                    updates_total += blk.updates * n_groups
                    exp_mdH_sum += em
                    with perf.span("hmc.dump"):
                        _save_confs(theta, i, lattice, hmc, run)
                    blk = new_block(theta)
            if blk.updates:
                acc, _, em = close(blk)
                accepted_total += acc
                updates_total += blk.updates * n_groups
                exp_mdH_sum += em
            with perf.span("hmc.gather"):
                # [n_meas, every chain], one gather per observable
                meas = (mprog.out if mprog is not None else
                        {k: torch.stack([r[k] for r in rows]) for k in rows[0]})
                chains = {k: mh.gather_chains(v, dim=1).numpy()
                          for k, v in meas.items()
                          if not k.startswith("condensate_")}
                condensate_converged, condensate_iters = True, 0
                active_passes = None
                if measure_condensate:
                    condensate_converged = bool(mh.gather_chains(
                        meas["condensate_converged"], dim=1).all())
                    # the iterations and the active passes in one gather
                    parts = [meas["condensate_iters"]]
                    if "condensate_passes" in meas:
                        parts.append(meas["condensate_passes"])
                    counts = mh.gather_chains(torch.stack(
                        [c.to(torch.int64) for c in parts]), dim=2)
                    condensate_iters = int(counts[0].sum())
                    if len(counts) > 1:
                        active_passes = counts[1].amax(dim=1).numpy()
            if not condensate_converged:
                log("a condensate solve did not converge")
            perf.add(trajectories=updates_total,
                     cg_iters=cg_iters_total - iters_before)
        if prog is not None:
            perf.graphs["graph"] = prog.stats()
            perf.graphs["measurement_graph"] = mprog.stats()
        if fallback_solves:
            log(f"{fallback_solves} chain solves ran the f64 fallback")
        elapsed = time.perf_counter() - t_begin

        # ---- summary (hmc.cpp:213-214: mean + 20-bin jackknife) ----
        with perf.span("hmc.summary"):
            def _jack(name):
                x = chains[name].reshape(len(chains[name]), -1)   # [n_meas, n_chains]
                n_meas, n_ch = x.shape
                n_bins_t = min(20, max(2, n_meas // 2))
                if n_ch == 1:
                    return statistics.mean(x[:, 0]), statistics.jackknife_error(
                        x[:, 0], n_bins_t)
                # bin along time within each chain, then jackknife over the pooled
                # chain x bin means
                m = (n_meas // n_bins_t) * n_bins_t
                b = x[:m].reshape(n_bins_t, m // n_bins_t, n_ch).mean(axis=1)
                pooled = b.reshape(-1)
                return float(x.mean()), statistics.jackknife_error(pooled, len(pooled))

            Ep, dEp = _jack("plaquette")
            gS, dgS = _jack("gauge_action_density")
            acceptance = accepted_total / max(updates_total, 1)
            theta_np = mh.gather_global(theta)
            result = RunResult(
                Ep=Ep, dEp=dEp, gS=gS, dgS=dgS, acceptance_rate=acceptance,
                elapsed_seconds=elapsed, chains=chains, n_ill=n_ill,
                theta=theta_np if n_chains > 1 else theta_np[0],
                traj_index=traj_index, key=seed_key(run.seed), hmc=hmc,
                tuned_eps=tuned_eps, cg_iters_total=cg_iters_total,
                all_converged=all_converged,
                exp_mdH_mean=exp_mdH_sum / max(updates_total, 1),
                ill_records=ill_records, condensate_converged=condensate_converged,
                condensate_iters=condensate_iters, cg_fallback_solves=fallback_solves,
                action_iters_total=action_iters_total,
                unconverged_chain_trajs=unconverged,
                k3_cycles=None if k3 is None else k3[0],
                k3_res_cycles=None if k3 is None else k3[1],
                k3_wait_cycles=None if k3 is None else k3[2],
                k3_mre_cycles=None if k3 is None else k3[3],
                condensate_active_passes=active_passes)
            if simdata is not None:
                extra = ({"chiral_condensate": _jack("chiral_condensate")}
                         if measure_condensate else None)
                simdata.append_results(Ep=Ep, dEp=dEp, gS=gS, dgS=dgS,
                                       acceptance_rate=acceptance,
                                       elapsed_seconds=elapsed, extra=extra)
    result.perf = perf.summary()
    for line in perf.report_lines():
        log("perf: " + line)
    if k3 is not None and k3[0]:
        # K3's launch on this card (ops/refined.ru_card_route): its path and
        # the waves in which the card runs a launch's chains
        path, n, waves = rs.ru_card_route(lattice.Nx, lattice.Nt // 2, theta.shape[0], device)
        result.perf["k3"] = {"path": rs.ru_route_name(path, n), "waves": waves}
        log(f"perf: K3 path: {result.perf['k3']['path']}, {waves} wave(s) a launch")
        log(f"perf: K3 clocks: {k3[0]} cycles, {100 * k3[1] / k3[0]:.1f}% in f64 "
            f"residuals, {100 * k3[2] / k3[0]:.1f}% in cluster waits, "
            f"{100 * k3[3] / k3[0]:.1f}% in the MRE forecast")
    return result


def _save_confs(theta, index, lattice, hmc, run):
    """Write configuration(s) like the reference (hmc.cpp:201-208): every
    chain, gathered from every process, written by the primary."""
    th = mh.gather_global(theta)
    if not mh.is_primary():
        return
    n_chains = th.shape[0]
    for c, th_c in enumerate(th):
        name = ctxt.conf_filename(
            lattice.Nx, lattice.Nt, hmc.beta, hmc.m0,
            index if n_chains == 1 else index * n_chains + c)
        ctxt.write_conf(os.path.join(run.out_dir, name),
                        ctxt.links_from_theta(th_c))
