"""Scaling harness: trajectory throughput against the mesh shape, and
against the number of processes of a chain-parallel run.

Counterpart of ``schwingermodel_tpu/tools/bench_scaling.py``: the same
flags, defaults, metric names and row keys.

- ``--meshes`` (default 1x1,1x2,2x2,1x4): the same physics at a fixed
  global lattice on each mesh shape, one JSON row each with the ratio to
  the first row. 1x1 runs the unpacked sampler (hmc/sampler.py; K6 for the
  f32 solves on the card); rx x rt runs the sharded step
  (``parallel/sharded.make_sharded_traj_fn``) on a ``LatticeMesh``, which
  holds every shard on the one device as leading tensor axes (K7 in every
  f32 solve and K8 in every force where the blocks take the wide halo); a
  shape RCxRXxRT runs C = RC chains on the RX x RT mesh. Every row carries
  ``"shards_on": "one device"``: ``vs_single_device`` is then the mesh
  path's own cost on one card against the unsharded sampler's, not a
  scaling across cards. A shape is skipped (with the reason) where it does
  not divide the lattice or leaves a shard an odd Nt: holding the shards
  needs no further devices, where the JAX tool skipped shapes of more
  devices than it had.
- ``--chain-scaling P1,P2,...``: each listed process count as real OS
  processes (``--chain-worker`` of this module, pinned one to a core with
  taskset where it exists, brought up by
  ``parallel/multihost.maybe_initialize`` from the three multi-host flags,
  localhost), one chain group of ``--chains-per-slot`` chains a process on
  the packed path where ``parallel/sharded.chain_packed_supported`` holds
  (at the default tol 1e-6, no refinement: K1 with its CG, and K2), each
  chain on the noise of its global index. Global chain-traj/s per process
  count and the efficiencies against linear and against the host's cores.
  On one card the processes share it and gather through gloo (NCCL puts no
  two ranks on one card): the rows say so in ``layout``; that is not a
  multi-GPU run.

Timing: the host clock around a block of trajectories from a thermalized
configuration, fenced by a host read of its summed CG iterations (after an
untimed pass of the same length: the kernels' build on first use and their
first launches); a chain worker also gathers once across the processes
before and after its block, so that the time is the slowest process's.

Differences from the JAX tool: ``--device {cuda,cpu}`` replaces
``--platform``, and ``--devices`` (JAX's virtual CPU device count) is not
needed: both are refused with exit 2. ``backend`` is "cuda" or "cpu", and
each row adds ``device`` (the card's name and power limit,
``utils/metrics.card_label``). The noise is the port's (seed, trajectory,
chain) streams (``utils/prng.py``).

    python -m schwingermodel_tpu_torch.tools.bench_scaling \
        --nx 64 --nt 64 --meshes 1x1,1x2,2x2,1x4 [--chain-scaling 1,2,4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from schwingermodel_tpu_torch.tools import _bench

# the phases' streams of trajectory indices: thermalization, warm pass,
# timed pass (the JAX tool folds one key a phase)
STREAM = 1 << 24
THERM, WARM, TIMED = 0, 1, 2


def _parse_meshes(spec: str):
    out = []
    for part in spec.split(","):
        dims = tuple(int(d) for d in part.strip().split("x"))
        if len(dims) not in (2, 3):
            raise ValueError(f"mesh {part!r}: want RXxRT or RCxRXxRT")
        out.append(dims)
    return out


def make_model(args):
    """The JAX tool's model from its flags: even-odd, max_iter 2000, no
    refinement."""
    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel

    return SchwingerModel(
        lattice=LatticeParams(Nx=args.nx, Nt=args.nt, real_dtype=args.dtype),
        hmc=HMCParams(beta=args.beta, m0=args.m0, md_steps=args.md_steps,
                      trajectory_length=args.tau, even_odd=True,
                      cg=CGParams(tol=args.tol, max_iter=2000)))


def mesh_fits(mesh_shape, Nx: int, Nt: int):
    """None where every shard of this shape holds a block of the lattice
    (rx | Nx, rt | Nt and an even local Nt for the even-odd fields), else
    the reason."""
    rx, rt = mesh_shape[-2:]
    if Nx % rx or Nt % rt:
        return f"{rx}x{rt} does not divide {Nx}x{Nt}"
    if (Nt // rt) % 2:
        return f"local Nt {Nt // rt} is odd"
    return None


def _block(traj, theta, seed: int, stream: int, n: int):
    """n trajectories of indices stream * STREAM + i: (theta', CG
    iterations summed on the device)."""
    its = torch.zeros((), dtype=torch.int64, device=theta.device)
    for i in range(n):
        theta, st = traj(theta, seed, stream * STREAM + i)
        its = its + st.cg_iters.sum()
    return theta, its


def measure(model, mesh_shape, n_therm: int, n_timed: int, device, seed: int = 0):
    """(chain-trajectories per second, CG iterations of the timed block) on
    one mesh shape: n_therm trajectories from a hot start, an untimed pass
    of n_timed, then the timed pass of n_timed from the same
    configuration on other noise."""
    from schwingermodel_tpu_torch.hmc.sampler import hmc_trajectory
    from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh
    from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn
    from schwingermodel_tpu_torch.runner import hot_start

    n_chains = mesh_shape[0] if len(mesh_shape) == 3 else 1
    theta = hot_start(model.lattice, seed, n_chains, device)
    if tuple(mesh_shape[-2:]) == (1, 1) and n_chains == 1:
        def traj(th, s, i):
            return hmc_trajectory(model, th, s, i)
    else:
        traj = make_sharded_traj_fn(model, lattice_mesh(tuple(mesh_shape[-2:])))
    theta, it = _block(traj, theta, seed, THERM, n_therm)
    int(it)
    _, it = _block(traj, theta, seed, WARM, n_timed)
    int(it)
    t0 = time.perf_counter()
    _, it = _block(traj, theta, seed, TIMED, n_timed)
    iters = int(it)                                   # the host-read fence
    dt = time.perf_counter() - t0
    return n_timed * n_chains / dt, iters


def mesh_rows(args, device) -> list:
    """One row per mesh shape of --meshes, each printed as it comes."""
    from schwingermodel_tpu_torch.utils.metrics import card_label

    card = card_label(device)
    model = make_model(args)
    base = None
    rows = []
    for mesh_shape in _parse_meshes(args.meshes):
        name = "x".join(map(str, mesh_shape))
        why = mesh_fits(mesh_shape, args.nx, args.nt)
        if why:
            print(json.dumps({"mesh": name, "skipped": why}), flush=True)
            continue
        tps, iters = measure(model, mesh_shape, args.n_therm, args.n_timed, device)
        if base is None:
            base = tps
        rows.append({
            "metric": "hmc_traj_per_s",
            "mesh": name,
            "lattice": f"{args.nx}x{args.nt}",
            "dtype": args.dtype,
            "backend": device.type,
            "value": round(tps, 3),
            "unit": "traj/s",
            "cg_iters": iters,
            "vs_single_device": round(tps / base, 3),
            "shards_on": "one device",
            "device": card,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _chain_scaling_worker(args) -> int:
    """One process of a chain-parallel run: its chain group of
    --chains-per-slot chains through the packed step (the unpacked sampler
    where the model is off the packed path); process 0 prints the global
    chain-traj/s."""
    from schwingermodel_tpu_torch.hmc.sampler import hmc_trajectory
    from schwingermodel_tpu_torch.parallel import multihost as mh
    from schwingermodel_tpu_torch.parallel.sharded import (
        chain_packed_supported, make_chain_sharded_packed_traj_fn)
    from schwingermodel_tpu_torch.runner import hot_start
    from schwingermodel_tpu_torch.utils.metrics import card_label

    mh.maybe_initialize(args.coordinator, args.num_processes, args.process_id,
                        device=args.device)
    try:
        device = mh.local_device(args.device)
        model = make_model(args)
        mesh = mh.multihost_mesh()
        C = mesh.groups * args.chains_per_slot
        theta = hot_start(model.lattice, 0, C, device)[mesh.local_chains(C)]
        if chain_packed_supported(model, mesh):
            traj = make_chain_sharded_packed_traj_fn(model, mesh)
        else:
            def traj(th, s, i):
                return hmc_trajectory(model, th, s, i,
                                      chain_offset=mesh.index * th.shape[0])
        theta, it = _block(traj, theta, 0, THERM, args.n_therm)
        mh.gather_chains(it)
        _, it = _block(traj, theta, 0, WARM, args.n_timed)
        mh.gather_chains(it)
        t0 = time.perf_counter()
        _, it = _block(traj, theta, 0, TIMED, args.n_timed)
        mh.gather_chains(it)             # every process's block has ended
        dt = time.perf_counter() - t0
        if mh.is_primary():
            print(json.dumps({
                "metric": "chain_scaling_traj_per_s",
                "processes": mh.process_count(),
                "chains_total": C,
                "lattice": f"{args.nx}x{args.nt}",
                "value": round(args.n_timed * C / dt, 3),
                "unit": "traj/s (global)",
                "layout": mh.layout(),
                "device": card_label(device),
            }), flush=True)
    finally:
        mh.shutdown()
    return 0


def _chain_scaling_parent(args) -> int:
    """Spawn each process count as real OS processes (a localhost
    rendezvous) and report the chain-axis scaling efficiency
    eff(P) = rate(P) / (P rate(1)), and against the cores the processes
    can use, rate(P) / (min(P, cores) / min(P1, cores) rate(P1))."""
    import os
    import shutil
    import socket
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    ncores = os.cpu_count() or 1
    pin = shutil.which("taskset") is not None
    rows = []
    for P in [int(x) for x in args.chain_scaling.split(",")]:
        env = {**os.environ, "PYTHONPATH": repo}
        cmd0 = [sys.executable, "-m", "schwingermodel_tpu_torch.tools.bench_scaling",
                "--chain-worker", "--device", args.device,
                "--nx", str(args.nx), "--nt", str(args.nt),
                "--beta", str(args.beta), "--m0", str(args.m0),
                "--md-steps", str(args.md_steps), "--tau", str(args.tau),
                "--dtype", args.dtype, "--tol", str(args.tol),
                "--n-therm", str(args.n_therm), "--n-timed", str(args.n_timed),
                "--chains-per-slot", str(args.chains_per_slot),
                "--coordinator", f"localhost:{free_port()}",
                "--num-processes", str(P)]

        # one core a worker, so that eff(P) measures the processes'
        # communication and sharing, not how many cores the P=1 run took
        def cmd_for(i):
            base = cmd0 + ["--process-id", str(i)]
            return (["taskset", "-c", str(i % ncores)] if pin else []) + base

        procs = [subprocess.Popen(cmd_for(i), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env,
                                  cwd=repo)
                 for i in range(P)]
        try:
            outs = [pr.communicate(timeout=1800)[0] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        if any(pr.returncode for pr in procs):
            for i, o in enumerate(outs):
                print(f"--- P={P} proc {i} rc={procs[i].returncode} ---")
                print(o[-2000:])
            return 1
        row = None
        for line in outs[0].splitlines():
            try:
                cand = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(cand, dict) and cand.get("metric") == "chain_scaling_traj_per_s":
                row = cand
        if row is None:
            print(f"--- P={P}: no result row ---\n{outs[0][-2000:]}")
            return 1
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = rows[0]
    for r in rows:
        scale = r["processes"] / base["processes"]
        r["efficiency_vs_linear"] = round(r["value"] / (base["value"] * scale), 3)
        # with fewer cores than processes, linear scaling is out of reach:
        # the processes time-share the cores; against the core-saturated
        # ideal rate(min(P, cores)) the rest is the communication's share
        sat = min(r["processes"], ncores) / min(base["processes"], ncores)
        r["efficiency_vs_core_saturated"] = round(r["value"] / (base["value"] * sat), 3)
    summary = {
        "metric": "chain_axis_scaling_efficiency",
        "per_process_devices": 1,
        "host_cores": ncores,
        "rows": rows,
        "efficiency": rows[-1]["efficiency_vs_linear"],
        "efficiency_core_saturated": rows[-1]["efficiency_vs_core_saturated"],
        "device": rows[-1]["device"],
    }
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_scaling")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--m0", type=float, default=0.2)
    p.add_argument("--md-steps", type=int, default=10)
    p.add_argument("--tau", type=float, default=0.1)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--meshes", default="1x1,1x2,2x2,1x4")
    p.add_argument("--n-therm", type=int, default=30)
    p.add_argument("--n-timed", type=int, default=30)
    # ---- multi-process chain-axis scaling ----
    p.add_argument("--chain-scaling", default=None, metavar="P1,P2,...",
                   help="spawn each listed process count as real OS "
                        "processes (torch.distributed, localhost) and report "
                        "global chain-traj/s against the process count and "
                        "the scaling efficiency")
    p.add_argument("--chains-per-slot", type=int, default=2,
                   help="chains of each process's chain group")
    p.add_argument("--json", default=None,
                   help="write the chain-scaling result table here")
    p.add_argument("--chain-worker", action="store_true",
                   help="run the chain-parallel measurement in THIS process "
                        "(a multi-process launch from the flags below or "
                        "torchrun's environment)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    _bench.add_device_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = _bench.check_flags(args)
    if rc:
        return rc
    if args.chain_scaling:
        return _chain_scaling_parent(args)
    if args.coordinator is not None or args.chain_worker:
        return _chain_scaling_worker(args)
    mesh_rows(args, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
