"""Command-line driver of the PyTorch port.

Counterpart of ``schwingermodel_tpu/cli.py``: its flags, apart from the
three named below as dropped, and with parameters missing from the flags
the same ten prompts on stderr, read from stdin in the same order, so
reference-style parameter pipes work:

    printf '1\\n1\\n0.2\\n10\\n0.1\\n4\\n10\\n10\\n10\\n0\\n' | \\
        python -m schwingermodel_tpu_torch --nx 64 --nt 64 --device cuda

``--device {cuda,cpu}`` replaces ``--platform``. Both devices run the same
paths: on ``cuda`` through the CUDA kernels, on ``cpu`` through their plain
PyTorch twins. The working precision is float32 on both unless ``--dtype
float64`` is given: ``--device cpu`` keeps float32, where the JAX package
on the CPU takes float64. The default is the packed path: f32 working precision,
even-odd pseudofermions, the refined 1e-10 contract; ``--no-cg-refine``
selects the loose f32 contract (tol 1e-6 unless ``--cg-tol``),
``--integrator omelyan`` the Omelyan 2MN integrator and ``--hasenbusch-dm
DM`` the two-pseudofermion split at the heavy mass m0+DM, in any
combination; ``--condensate`` (with ``--n-noise``) measures the chiral
condensate on every path. Off the packed path the unpacked sampler
(hmc/sampler.py) runs: ``--quenched`` (pure gauge, no solve),
``--no-even-odd`` or an odd lattice extent (full-D pseudofermions) and
``--dtype float64`` (f64 working precision: no refinement, native f64 CG at
1e-10). ``--autotune`` (with ``--tune-target``, ``--n-tune``) tunes the step
size over the first thermalization trajectories and re-quantizes md_steps.
``--checkpoint CKPT`` writes the final state as one ``.npz``; ``--resume
CKPT`` continues from one (its configuration, parameters and trajectory
counter; ``--nmeas`` extends the run without thermalization; the warm-up
of ``--autotune`` is switched off, since the checkpoint carries the tuned
md_steps), also from a checkpoint the JAX package wrote. ``--profile DIR``
writes a ``torch.profiler`` trace of the run to ``DIR/trace.json``, the
run's ``hmc.*`` spans among its ranges, and on the card prints the device's
idle share in ``hmc.run``, starved and queued (``utils.metrics.idle_split``).
``--mre-history K`` (K >= 2; at most 4 on the card) starts every solve of
the packed refined path from the MRE forecast over the last K force
solutions, computed in K3's launch; it is ignored where the JAX package
ignores it (the loose contract, ``--no-cg-forecast``, Hasenbusch, off the
packed path).

``--ranks-x RX --ranks-t RT`` (or the first two prompts) cut the lattice
into RX x RT shards and run the lattice-sharded trajectory
(parallel/sharded.py) with the per-shard halo kernels, with or without
``--hasenbusch-dm``. In one process all shards live on the one device:
the domain decomposition of a multi-GPU run without the GPUs, not a
multi-GPU run. In RC x RX x RT processes (``--ranks-chain RC``, default 1)
each process holds one shard (parallel/mesh.DistLatticeMesh, rank r at
chain group r // (RX RT)); another number of processes exits with status
1. A lattice that the mesh does not divide (or an odd local Nt in even-odd
mode) exits with status 1, as the reference does; 1 x 1 runs without a
mesh.

Several processes run the chains in groups, one group a process, each on
its own device with the lattice whole there (parallel/multihost.py), started
by torchrun (``python -m torch.distributed.run --nproc-per-node N -m
schwingermodel_tpu_torch ...``; also from SLURM's or Open MPI's variables)
or by the three multi-host flags in each process (``--coordinator
host:port --num-processes N --process-id i``). Process i runs on
``cuda:{LOCAL_RANK % device_count}``; ``--chains`` is rounded up to a
multiple of the processes (with a note), or with ``--ranks-chain R`` must
be divisible by R, and R must be the number of processes (else status 1).
Every process computes; the primary alone echoes and writes SimData,
configurations and the checkpoint, after gathering the chains; on
``--resume`` every process reads the checkpoint and takes its chains. Give
the parameters as flags: the processes of one launcher share its stdin.
With a lattice mesh the chain groups are its planes (above).

Three flags of the JAX parser are dropped, parsed only to say so (status 2,
"dropped in schwingermodel_tpu_torch" and what replaces the flag):
``--cg-refine-impl`` (the card has native float64, which replaces the
double-float pairs, so there is no implementation to choose), ``--platform``
(``--device``) and ``--num-cpu-devices`` (a lattice mesh needs no virtual
devices here: ``--ranks-x/--ranks-t`` put all shards on the one device).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def _prompt(question: str, cast, interactive: bool):
    """Reference-style parameter input: prompt on stderr, value from stdin
    (src/main.cpp:30-58)."""
    if interactive:
        print(question, file=sys.stderr)
    line = sys.stdin.readline()
    if not line:
        raise SystemExit(f"missing input for: {question}")
    return cast(line.split()[0])


# The multi-host flags, given all three or none (else exit status 2).
MULTI_HOST = ("--coordinator", "--num-processes", "--process-id")
# Flags of the JAX parser that the port answers with exit status 2.
DROPPED = {
    "--cg-refine-impl": "native float64 replaces the double-float pairs",
    "--platform": "use --device {cuda,cpu}",
    "--num-cpu-devices": "--ranks-x/--ranks-t put all shards on the one device",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch",
        description="HMC for the two-flavor Schwinger model (PyTorch + CUDA)",
    )
    p.add_argument("--nx", type=int, default=64, help="lattice extent in x")
    p.add_argument("--nt", type=int, default=64, help="lattice extent in t")
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--m0", type=float, default=None)
    p.add_argument("--md-steps", type=int, default=None)
    p.add_argument("--tau", type=float, default=None, help="trajectory length")
    p.add_argument("--ntherm", type=int, default=None)
    p.add_argument("--nmeas", type=int, default=None)
    p.add_argument("--nsteps", type=int, default=None,
                   help="decorrelation sweeps between measurements")
    p.add_argument("--save-conf", action="store_true", default=None)
    p.add_argument("--ranks-x", type=int, default=None,
                   help="shards of the lattice mesh in x (in one process "
                        "all shards on the one device, else one a process)")
    p.add_argument("--ranks-t", type=int, default=None,
                   help="shards of the lattice mesh in t")
    p.add_argument("--ranks-chain", type=int, default=1,
                   help="chain groups, one a process (requires --chains "
                        "divisible by it and as many processes)")
    p.add_argument("--cg-tol", type=float, default=None,
                   help="CG relative tolerance (default 1e-10; 1e-6 with "
                        "--no-cg-refine)")
    p.add_argument("--cg-max-iter", type=int, default=10000)
    p.add_argument("--cg-refine", dest="cg_refine", action="store_true",
                   default=None,
                   help="mixed-precision solves: f32 recursion, f64 solution "
                        "and true residual (the default)")
    p.add_argument("--no-cg-refine", dest="cg_refine", action="store_false",
                   help="the loose f32 contract: f32 CG throughout")
    p.add_argument("--cg-inner-tol", type=float, default=1e-5)
    p.add_argument("--cg-force-tol", type=float, default=None,
                   help="MD force-solve tolerance under the refined contract "
                        "(default 1e-8; the Metropolis action solves run at "
                        "--cg-tol)")
    p.add_argument("--mre-history", type=int, default=0,
                   help="refined-contract forecast history depth: >= 2 "
                        "MRE-projects each solve's start onto the span of "
                        "the last K solutions in-kernel (at most 4 on the "
                        "card); 0 = the 2nd-order extrapolation (default)")
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="working precision (default float32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chains", type=int, default=1,
                   help="independent chains advanced together")
    p.add_argument("--quenched", action="store_true")
    p.add_argument("--integrator", choices=["leapfrog", "omelyan"],
                   default="leapfrog")
    p.add_argument("--hasenbusch-dm", type=float, default=None, metavar="DM")
    p.add_argument("--no-even-odd", dest="even_odd", action="store_false",
                   default=True)
    p.add_argument("--no-cg-forecast", dest="cg_forecast", action="store_false",
                   default=True,
                   help="restart every solve from b like the reference")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--tune-target", type=float, default=0.7)
    p.add_argument("--n-tune", type=int, default=100)
    p.add_argument("--condensate", action="store_true")
    p.add_argument("--n-noise", type=int, default=8)
    p.add_argument("--cold-start", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--resume", default=None, metavar="CKPT")
    p.add_argument("--read-conf", default=None, metavar="CTXT",
                   help="start from a saved gauge configuration (.ctxt)")
    p.add_argument("--checkpoint", default=None, metavar="CKPT")
    p.add_argument("--no-simdata", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json (view in chrome://tracing or Perfetto)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: the address of process 0's rendezvous "
                        "(also honored: torchrun's, SLURM's and Open MPI's "
                        "variables)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's id")
    for flag, instead in DROPPED.items():
        p.add_argument(flag, default=None, help=f"dropped: {instead}")
    return p


def _dest(flag: str) -> str:
    return flag[2:].replace("-", "_")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.dtype = args.dtype or "float32"
    for flag, instead in DROPPED.items():
        if getattr(args, _dest(flag)) is not None:
            print(f"error: dropped in schwingermodel_tpu_torch: {flag} "
                  f"({instead})", file=sys.stderr)
            return 2
    given = [f for f in MULTI_HOST if getattr(args, _dest(f)) is not None]
    if given and len(given) < len(MULTI_HOST):
        missing = ", ".join(f for f in MULTI_HOST if f not in given)
        print(f"error: {', '.join(given)} needs {missing} (multi-host)",
              file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but CUDA is not available", file=sys.stderr)
        return 1

    from schwingermodel_tpu_torch.parallel import multihost

    # bring up the processes before anything touches a device (reference:
    # MPI_Init first, main.cpp:13); a no-op for one process
    multihost.maybe_initialize(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    try:
        return _main(args)
    finally:
        multihost.shutdown()


def _main(args) -> int:
    import torch

    from schwingermodel_tpu_torch.parallel import multihost

    distributed = multihost.process_count() > 1
    echo = print if multihost.is_primary() else (lambda *a, **k: None)

    from schwingermodel_tpu_torch.config import (
        CGParams, HMCParams, LatticeParams, RunParams,
    )
    from schwingermodel_tpu_torch.io import ctxt
    from schwingermodel_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh
    from schwingermodel_tpu_torch.runner import run_hmc
    from schwingermodel_tpu_torch.utils.metrics import profiler_trace

    # ---- parameters: flags, else reference-style stdin prompts ----
    need_stdin = any(
        v is None for v in (args.ranks_x, args.ranks_t, args.m0, args.md_steps,
                            args.tau, args.beta, args.ntherm, args.nmeas,
                            args.nsteps)) and args.resume is None
    if not need_stdin and args.save_conf is None:
        args.save_conf = False
    interactive = sys.stdin.isatty()
    if need_stdin:
        if interactive:
            print("  -----------------------------", file=sys.stderr)
            print("|  Two-flavor Schwinger model   |", file=sys.stderr)
            print("| Hybrid Monte Carlo simulation |", file=sys.stderr)
            print("  -----------------------------", file=sys.stderr)
            print(f"Nx {args.nx} Nt {args.nt}", file=sys.stderr)
        get = lambda q, c, cur: cur if cur is not None else _prompt(q, c, interactive)
        args.ranks_x = get("ranks_x: ", int, args.ranks_x)
        args.ranks_t = get("ranks_t: ", int, args.ranks_t)
        args.m0 = get("m0: ", float, args.m0)
        args.md_steps = get("Molecular dynamics steps: ", int, args.md_steps)
        args.tau = get("Trajectory length: ", float, args.tau)
        args.beta = get("beta: ", float, args.beta)
        args.ntherm = get("Thermalization: ", int, args.ntherm)
        args.nmeas = get("Measurements: ", int, args.nmeas)
        args.nsteps = get("Step (sweeps between measurements): ", int, args.nsteps)
        args.save_conf = bool(get("Save configurations yes/no (1 or 0): ", int,
                                  None if args.save_conf is None else int(args.save_conf)))

    initial_theta = None
    start_traj = 0
    if args.resume:
        ck = load_checkpoint(args.resume)
        lattice, hmc, run = ck["lattice"], ck["hmc"], ck["run"]
        initial_theta = ck["theta"]
        start_traj = ck["traj_index"]
        run = dataclasses.replace(run, out_dir=args.out_dir, autotune=False)
        if args.nmeas is not None:                  # extend the run
            run = dataclasses.replace(run, n_meas=args.nmeas, n_therm=0)
    else:
        # f64 working precision solves at full precision natively
        refine = args.cg_refine is not False and args.dtype == "float32"
        cg_tol = args.cg_tol if args.cg_tol is not None else (
            1e-6 if (args.dtype == "float32" and not refine) else 1e-10)
        lattice = LatticeParams(Nx=args.nx, Nt=args.nt, real_dtype=args.dtype)
        # an odd lattice has no checkerboard: full-D pseudofermions
        even_odd = args.even_odd and lattice.Nx % 2 == 0 and lattice.Nt % 2 == 0
        hmc = HMCParams(
            beta=args.beta, m0=args.m0, md_steps=args.md_steps,
            trajectory_length=args.tau, quenched=args.quenched,
            even_odd=even_odd, cg_forecast=args.cg_forecast,
            integrator=args.integrator, mre_history=args.mre_history,
            hasenbusch_dm=args.hasenbusch_dm,
            cg=CGParams(tol=cg_tol, max_iter=args.cg_max_iter, refine=refine,
                        inner_tol=args.cg_inner_tol,
                        force_tol=args.cg_force_tol),
        )
        run = RunParams(n_therm=args.ntherm, n_meas=args.nmeas,
                        n_steps=args.nsteps, save_conf=bool(args.save_conf),
                        n_chains=args.chains, seed=args.seed,
                        out_dir=args.out_dir,
                        mesh_shape=(args.ranks_x, args.ranks_t),
                        autotune=args.autotune, tune_target=args.tune_target,
                        n_tune=args.n_tune)
    # a checkpoint of the JAX package may carry a ('chain', 'x', 't') mesh
    rx, rt = (run.mesh_shape or (1, 1))[-2:]
    run = dataclasses.replace(run, mesh_shape=(rx, rt))
    mesh = None
    if rx < 1 or rt < 1:
        print(f"error: mesh {rx}x{rt}: extents must be positive", file=sys.stderr)
        return 1
    rc, world = args.ranks_chain, multihost.process_count()
    across = rx * rt > 1 and (distributed or rc > 1)
    if across and rc * rx * rt != world:
        # JAX: "mesh ... needs n devices, have m"
        shape = f"{rc}x{rx}x{rt}" if rc > 1 else f"{rx}x{rt}"
        print(f"error: mesh {shape} needs {rc * rx * rt} processes, have "
              f"{world}", file=sys.stderr)
        return 1
    if rx * rt == 1 and rc > 1 and rc != world:
        print(f"error: --ranks-chain {rc} needs {rc} processes, have {world}",
              file=sys.stderr)
        return 1
    if rx * rt > 1:
        if lattice.Nx % rx or lattice.Nt % rt:
            # the reference exits the same way (mpi_setup.h:12-19)
            print(f"error: lattice {lattice.Nx}x{lattice.Nt} not divisible "
                  f"by mesh {rx}x{rt}", file=sys.stderr)
            return 1
        if hmc.even_odd and (lattice.Nt // rt) % 2:
            print(f"error: even-odd mode needs an even local Nt per shard; "
                  f"Nt={lattice.Nt} over {rt} t-shards gives "
                  f"{lattice.Nt // rt}", file=sys.stderr)
            return 1
    if distributed:
        # chain groups: one a process with the lattice whole on each
        # device, or one a plane of rx x rt processes, one shard each
        mesh = multihost.multihost_mesh(rx, rt)
        groups = mesh.groups
        if rc > 1 and run.n_chains % rc:
            print(f"error: --chains {run.n_chains} not divisible by "
                  f"--ranks-chain {rc}", file=sys.stderr)
            return 1
        if run.n_chains % groups:
            # round UP to the next multiple of the chain groups: never
            # silently reduce the statistics asked for
            n_new = groups * (-(-run.n_chains // groups))
            echo(f"note: --chains {run.n_chains} rounded up to {n_new} "
                 f"(chain mesh axis = {groups})")
            run = dataclasses.replace(run, n_chains=n_new)
    elif rx * rt > 1:
        mesh = lattice_mesh((rx, rt))

    if args.read_conf:
        initial_theta = ctxt.theta_from_links(
            ctxt.read_conf(args.read_conf, lattice.Nx, lattice.Nt))
    elif args.cold_start and initial_theta is None:
        initial_theta = np.zeros((2, lattice.Nx, lattice.Nt))

    device = multihost.local_device(args.device)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")
    echo("*" * 70)
    echo("*                              PARAMETERS")
    echo(f"* Nx = {lattice.Nx}, Nt = {lattice.Nt}")
    echo(f"* m0 = {hmc.m0:g}, kappa = {hmc.kappa:g}")
    if hmc.hasenbusch_dm:
        echo(f"* Hasenbusch split: auxiliary mass m1 = "
             f"{hmc.m0 + hmc.hasenbusch_dm:g} (dm = {hmc.hasenbusch_dm:g})")
    echo(f"* beta = {hmc.beta:g}" + ("  (quenched)" if hmc.quenched else ""))
    echo(f"* Thermalization confs = {run.n_therm}")
    echo(f"* Measurement confs = {run.n_meas}")
    echo(f"* Decorrelation steps (confs dropped between measurements) = {run.n_steps}")
    echo(f"* Trajectory length = {hmc.trajectory_length:g}, "
         f"Leapfrog steps = {hmc.md_steps}, "
         f"Integration step = {hmc.step_size:g}")
    refine_desc = (f" (mixed-precision: f32 recursion + f64 true residual, "
                   f"replacement every {hmc.cg.inner_tol:g})"
                   if hmc.cg.refine else
                   f" ({'f32' if lattice.real_dtype == 'float32' else 'f64'} CG)")
    echo(f"* CG max iterations = {hmc.cg.max_iter}, "
         f"CG tolerance = {hmc.cg.tol:g}{refine_desc}")
    ftol = hmc.cg.resolved_force_tol()
    if ftol != hmc.cg.tol:
        echo(f"* CG force tolerance = {ftol:g} "
             f"(action solves at {hmc.cg.tol:g})")
    echo(f"* Device = {device} ({device_name})")
    if distributed and rx * rt > 1:
        echo(f"* Device mesh = {rx}x{rt} shards, one a process: "
             f"{multihost.layout()}"
             + (", not multi-GPU" if multihost.shares_devices() else ""))
        echo(f"* Chain groups = {mesh.groups} (one a plane of {rx * rt} "
             f"processes)")
    else:
        echo(f"* Device mesh = {rx}x{rt} shards on 1 device ({device_name})")
    if distributed and rx * rt == 1:
        echo(f"* Chain groups = {multihost.layout()}")
    echo(f"* Chains = {run.n_chains}, dtype = {lattice.real_dtype}, "
         f"seed = {run.seed}")
    echo("*" * 70)

    with profiler_trace(args.profile) as trace:
        result = run_hmc(lattice, hmc, run, device=device,
                         initial_theta=initial_theta,
                         start_traj_index=start_traj, progress=echo,
                         write_simdata=not args.no_simdata,
                         measure_condensate=args.condensate,
                         n_noise=args.n_noise, mesh=mesh)
    if args.profile:
        print(f"Profiler trace written to {args.profile}")
        idle = trace["idle"]
        if idle is not None:
            pct = {k: 100.0 * idle[k] / idle["window_s"]
                   for k in ("idle_s", "starved_s", "queued_s")}
            print(f"Device idle in hmc.run: {pct['idle_s']:.2f}% of "
                  f"{idle['window_s']:.4f} s (starved {pct['starved_s']:.2f}%, "
                  f"queued {pct['queued_s']:.2f}%)")

    echo(f"Average plaquette value / volume: Ep = {result.Ep:.17g} "
         f"dEp = {result.dEp:.17g}")
    echo(f"Average gauge action / volume: gS = {result.gS:.17g} "
         f"dgS = {result.dgS:.17g}")
    if args.condensate:
        s = result.summary("chiral_condensate")
        echo(f"Chiral condensate: {s['mean']:.10g} +- {s['error']:.3g} "
             f"(tau_int {s['tau_int']:.2f})")
    echo(f"Acceptance rate: {result.acceptance_rate:.17g}")
    echo(f"<exp(-dH)> = {result.exp_mdH_mean:.6f}, all solves converged: "
         f"{result.all_converged} (unconverged chain-trajectories: "
         f"{result.unconverged_chain_trajs})")
    echo(f"Execution time = {result.elapsed_seconds:.6f} s")
    echo("-------------------------------")
    if result.n_ill:
        echo(f"WARNING: {result.n_ill} ill (CG-failed) configurations dumped")
    if distributed:
        # each process's own line: where it ran and its device programs'
        # captures, replays and kernel nodes; one write, so that the
        # processes' lines do not interleave
        graphs = {k: {s: g[s] for s in ("captures", "replays", "kernel_nodes")}
                  for k, g in result.perf.items() if "captures" in g}
        sys.stderr.write(f"process {multihost.process_index()} of "
                         f"{multihost.process_count()} on {device}: graphs "
                         f"{graphs}\n")
        sys.stderr.flush()
    if args.checkpoint and multihost.is_primary():
        # primary-only, like every other writer (result.theta holds every
        # process's chains); result.hmc carries the tuned md_steps, so a
        # resumed run goes on with the step it ended with
        save_checkpoint(
            args.checkpoint, theta=result.theta, key=result.key,
            traj_index=result.traj_index, lattice=lattice, hmc=result.hmc,
            run=run,
            chains={k: v.reshape(len(v), -1).mean(axis=1)
                    for k, v in result.chains.items()})
        echo(f"Checkpoint written to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
