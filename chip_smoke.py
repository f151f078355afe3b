"""On-card smoke run of the PyTorch port (schwingermodel_tpu_torch).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

1. the card's tests, ``python -m pytest --noconftest -m card
   tests/test_torch_card_*.py`` in a process of their own (a long run of
   profiler windows leaves later windows missing launches): every kernel
   against its plain twin at
   shapes that take each of its routes, the device programs against eager
   calls bit for bit, the main paths, the measurement, the CLI across
   processes and the physics tools (each module's docstring lists its
   checks);
2. the main paths' device programs at beta=4 m0=0.2: the refined, loose,
   Hasenbusch (dm=0.4), Omelyan (md=5) and MRE (K=4, md=40, tau=1)
   trajectories of 32 chains at 64x64, the refined one of 32 chains at
   128x128 (the 128x128 cell's, K3 on its L2 path, as every one of its 10
   K3 nodes a replay is to name), and the refined and loose measurements
   with the condensate of 8 noise vectors; each is captured and replayed
   once: the launches of each entry point a replay, from its graph's
   kernel nodes by the name the CUDA driver gives each (``program.kernels``),
   then held to what
   N_REPLAYS replays under torch.profiler launch on the card; then one
   eager trajectory of 4 chains at 16x16 on 2x2 shards, the path of K7 and
   K8, which no device program runs;
3. the kernels line: each of the twelve entry points at 64x64 C=32 (K7 and
   K8 on 2x2 shards) against its plain twin on the same inputs
   (max_abs_err, held to the tolerance of the card's tests relative to the
   twin's largest value), launches of its own kernels in 3 calls under the
   profiler, its milliseconds by CUDA events as the host issues the
   launches (ms) and queued behind a spin of the card (device_ms,
   utils/metrics.device_ms), the least time the card could take for its
   work by the counts and peaks of hmc_bench/yardstick.py (bound_ms,
   bound_by), the one PyTorch call that computes the same function where
   there is one (library_ms: torch.randn and torch.randint of as many
   values for the noise kernel and its Z2 mode), and its launches a replay
   on each device program of 2 (by_path);
then the card line and the last line {"ok": ..., "device": {...}}. A failed
check is printed and the run goes on; the exit code is 1 if a test or a
check failed.

Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import collections
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from hmc_bench.yardstick import (
    F_CG_ITER, F_DHAT, F_FORCE, F_HOP, F_LINKS, F_NORMAL, F_PLAQ, F_RESIDUAL, PEAK_BYTES,
    Work, condensate_inner, refined_solves,
)
from schwingermodel_tpu_torch import observables as obs
from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.hmc.program import MeasurementProgram, TrajectoryProgram
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import cg_eo, halo, noise
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.eo_halo import W, extend
from schwingermodel_tpu_torch.ops.geometry import ShardedGeometry
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard
from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn
from schwingermodel_tpu_torch.runner import hot_start
from schwingermodel_tpu_torch.utils import prng
from schwingermodel_tpu_torch.utils.metrics import card_label, device_kernels, device_ms

REPO = Path(__file__).resolve().parent
DEV = torch.device("cuda", 0)
M0, BETA, NX, NT, C = 0.2, 4.0, 64, 64, 32
V2 = NX * NT // 2
N_REPLAYS = 3
LATTICE = LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")
FAILED = []

# each entry point: its source, what it replaces in the JAX package, and the
# device functions it launches (the force body's template arguments
# <WITH_SOLVE, WITH_GAUGE, RATIO, HALO> tell K1, K5 and K8 apart)
ENTRIES = {
    "force_step": ("csrc/force_step.cu", "schwingermodel_tpu/ops/pallas_traj.py:339",
                   ("force_step_kernel",)),
    "solve_fused": ("csrc/solve_fused.cu", "schwingermodel_tpu/ops/pallas_traj.py:532",
                    ("solve_fused_kernel", "solve_shared_kernel")),
    "solve_fused_mxu": ("csrc/solve_mxu.cu", "schwingermodel_tpu/tools/bench_mxu_stencil.py:54",
                        ("solve_mxu_shared_kernel", "solve_mxu_global_kernel")),
    "ratio_force": ("csrc/ratio_force.cu", "schwingermodel_tpu/ops/pallas_traj.py:465",
                    ("ratio_force_kernel",)),
    "solve_refined": ("csrc/solve_ru.cu", "schwingermodel_tpu/ops/pallas_df.py:402",
                      ("solve_ru_",)),
    "solve_f64_cg_fallback": ("csrc/cg_fallback.cu", "schwingermodel_tpu/ops/pallas_df.py:674",
                              ("cg_fallback_kernel",)),
    "cg_solve_eo": ("csrc/cg_eo.cu", "schwingermodel_tpu/ops/pallas_eo.py:208",
                    ("cg_eo_kernel", "cg_eo_shared_kernel")),
    "residual_f64": ("csrc/residual.cu", "schwingermodel_tpu/ops/pallas_df.py:145",
                     ("residual_kernel", "residual_shared_kernel")),
    "halo_normal": ("csrc/halo_normal.cu", "schwingermodel_tpu/ops/pallas_halo.py:48",
                    ("halo_normal_",)),
    "halo_force": ("csrc/halo_force.cu", "schwingermodel_tpu/ops/pallas_halo.py:178",
                   ("halo_force_global_kernel",)),
    # jax.random inside the jitted trajectory and the jitted measurement's
    # condensate (not Pallas kernels)
    "chain_noise": ("csrc/noise.cu", "schwingermodel_tpu/hmc/packed.py:485", ("noise_kernel",)),
    "z2_noise": ("csrc/noise.cu", "schwingermodel_tpu/observables.py:53", ("z2_kernel",)),
}


def check(cond, msg):
    if not cond:
        FAILED.append(msg)
        print("FAILED: " + msg, flush=True)


def entry_of(kernel: str):
    """The entry point whose launch a device function of that name is, or
    None (PyTorch's own kernels)."""
    if "force_shared_kernel" in kernel:
        # demangled <false, true, false, false>, or mangled ILb0ELb1ELb0ELb0E
        args = kernel.split("force_shared_kernel", 1)[1].split("(", 1)[0]
        flags = [w in ("true", "Lb1E") for w in re.findall(r"true|false|Lb[01]E", args)]
        return "halo_force" if flags[3] else "ratio_force" if flags[2] else "force_step"
    return next((name for name, (_, _, fns) in ENTRIES.items()
                 if any(fn in kernel for fn in fns)), None)


def by_entry(kernels, n):
    """Launches a call of each entry point (None: PyTorch's own kernels)
    from the kernel names of n calls."""
    out = collections.Counter()
    for name, count in kernels.items():
        out[entry_of(name)] += count
    return {k: v / n for k, v in out.items()}


def timed(fn, reps):
    """Mean milliseconds a call over `reps` calls by CUDA events, as the host
    issues them, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def hmc_params(md_steps=10, refine=True, tau=0.1, **kw):
    return HMCParams(beta=BETA, m0=M0, md_steps=md_steps, trajectory_length=tau,
                     even_odd=True, **kw,
                     cg=CGParams(tol=1e-10 if refine else 1e-6, max_iter=10000,
                                 refine=refine, inner_tol=1e-5))


# ---- phase 1 ----

def card_tests() -> int:
    files = sorted(str(p.relative_to(REPO)) for p in (REPO / "tests").glob("test_torch_card_*.py"))
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "card", "-p",
           "no:cacheprovider", *files]
    print(f"phase 1: {' '.join(cmd[1:])}", flush=True)
    return subprocess.run(cmd, cwd=REPO).returncode


# ---- phase 2 ----

PROGRAMS = {   # label: (lattice, chains, HMC parameters, launches a replay)
    "refined": (LATTICE, C, hmc_params(), {"solve_refined": 10, "force_step": 9}),
    "loose": (LATTICE, C, hmc_params(refine=False), {"solve_refined": 0}),
    "hasenbusch": (LATTICE, C, hmc_params(hasenbusch_dm=0.4), {"solve_fused": 0}),
    "omelyan": (LATTICE, C, hmc_params(md_steps=5, integrator="omelyan"), {}),
    "mre tau=1": (LATTICE, C, hmc_params(md_steps=40, tau=1.0, mre_history=4),
                  {"solve_refined": 40}),
    "128x128": (LatticeParams(Nx=128, Nt=128, real_dtype="float32"), 32, hmc_params(),
                {"solve_refined": 10, "force_step": 9}),
}
# the device function of a program's K3 nodes, where it is checked
K3_KERNEL = {"128x128": "solve_ru_l2_kernel"}


def replayed(label, prog):
    """Launches a replay of a captured program by entry point, from its
    graph's named kernel nodes, held to those of N_REPLAYS replays under
    the profiler."""
    got = by_entry(prog.kernels, 1)
    seen = by_entry(device_kernels(prog.step, N_REPLAYS), N_REPLAYS)
    check("?" not in prog.kernels, f"{label}: a kernel node the driver does not name")
    check(all(seen.get(k, 0) == n for k, n in got.items() if k),
          f"{label}: launches a replay {got} in the graph, {seen} under the profiler")
    print(f"phase 2: {label}: {prog.kernel_nodes} kernel nodes; launches a replay "
          f"{ {k or 'torch': v for k, v in got.items()} }; under the profiler "
          f"{sum(seen.values())} kernels a replay", flush=True)
    return got


def device_programs() -> dict:
    """Phase 2: {path: {entry point: launches a replay}}."""
    by_path, theta = {}, None
    for label, (lat, n, hmc, want) in PROGRAMS.items():
        prog = TrajectoryProgram(SchwingerModel(lattice=lat, hmc=hmc),
                                 hot_start(lat, 0, n, DEV), 0, 0)
        prog.run(2)
        got = by_path[label] = replayed(label, prog)
        for name, count in {"chain_noise": 1, "solve_f64_cg_fallback": 0, **want}.items():
            check(got.get(name, 0) == count, f"{label}: {name} {got.get(name, 0)} a replay, "
                  f"not {count}")
        if label in K3_KERNEL:
            k3 = {k: v for k, v in prog.kernels.items() if entry_of(k) == "solve_refined"}
            check(all(K3_KERNEL[label] in k for k in k3), f"{label}: K3's nodes {k3}")
        if label == "refined":
            theta = prog.theta.clone()
    for refine in (True, False):
        model = SchwingerModel(lattice=LATTICE, hmc=hmc_params(refine=refine))

        def measure(th, i, model=model):
            out = obs.measure_all(model, th)
            cc = obs.chiral_condensate(model, th, 1, i, 8)
            out.update(chiral_condensate=cc.value, converged=cc.converged)
            return out

        label = f"measurement {'refined' if refine else 'loose'}"
        prog = MeasurementProgram(measure, theta, 2 + N_REPLAYS)
        prog.run(2)
        got = by_path[label] = replayed(label, prog)
        check(got.get("z2_noise") == 1 and got.get("cg_solve_eo", 0) > 0
              and (got.get("residual_f64", 0) > 0) is refine
              and got.get("solve_f64_cg_fallback", 0) == int(refine),
              f"{label}: launches a replay {got}")
    lat = LatticeParams(Nx=16, Nt=16, real_dtype="float32")
    step = make_sharded_traj_fn(SchwingerModel(lattice=lat, hmc=hmc_params()),
                                lattice_mesh((2, 2)))
    theta = hot_start(lat, 0, 4, DEV)
    step(theta, 0, 0)
    got = by_entry(device_kernels(lambda: step(theta, 0, 1)), 1)
    check(got.get("halo_normal", 0) > 0 and got.get("halo_force", 0) > 0,
          f"16x16 on 2x2 shards: launches {got}")
    print(f"phase 2: one eager refined trajectory of 4 chains at 16x16 on 2x2 shards: "
          f"launches { {k or 'torch': v for k, v in got.items()} }", flush=True)
    return by_path


# ---- phase 3 ----

def cases():
    """Entry point: (kernel call, twin call, the pairs of outputs compared,
    tolerance relative to the twin's largest value, the work of the kernel's
    call (a Work), calls timed, the call timed where it is not the kernel
    call, the PyTorch call of the same function or None)."""
    g = torch.Generator(device=DEV).manual_seed(0)
    theta = (2 * torch.rand((C, 2, NX, NT), generator=g, device=DEV) - 1) * math.pi
    thE, thO = tr.pack_planes(theta)
    b, phi2 = (torch.randn((C, 2, 2, NX, NT // 2), generator=g, device=DEV) for _ in range(2))
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    B = 8
    E = C * B
    bb = torch.randn((C, B, 2, 2, NX, NT // 2), generator=g, device=DEV)
    x64 = torch.randn(bb.shape, generator=g, device=DEV, dtype=torch.float64)
    zero = torch.zeros_like(bb)
    starved = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10, max_iter=5)
    starved_p = rs.solve_refined_reference(thE, thO, b, b, m0=M0, tol=1e-10, max_iter=5)
    f1 = dict(m0=M0, beta=BETA, tol=1e-6, max_iter=10000, with_solve=False, with_gauge=True)
    k2 = dict(m0=M0, tol=1e-6, max_iter=10000)
    k5 = dict(m0=-0.19, m1=0.21, beta=BETA)
    k6 = dict(m0=M0, tol=1e-5, max_iter=10000)
    force = F_LINKS + F_DHAT + F_HOP + F_FORCE

    def solve_work(k):
        return Work(C * 64 * V2, V2 * (C * (F_LINKS + F_NORMAL) + F_CG_ITER * int(k.iters.sum())))

    # K7 and K8 on the blocks of 2x2 shards, timed as the sharded CG and force
    # call them (on the operator, its planes checked once)
    mesh = lattice_mesh((2, 2))
    geom = ShardedGeometry(mesh)
    hmodel = SchwingerModel(lattice=LATTICE, hmc=HMCParams(beta=BETA, m0=M0, even_odd=True),
                            geom=geom)
    op = halo.EOOperatorsHaloFused(
        geom, hmodel.field_fermion_links(shard(theta, mesh)), M0)
    planes = (op.ue_ext, op.uo_ext, op.off_ext)
    nxl, nthl, n_blk = NX // 2, NT // 4, C * 4
    v, r, psi = (torch.randn((C, 2, 2, 2, 2, nxl, nthl), generator=g, device=DEV)
                 for _ in range(3))
    v_ext, psi_ext = extend(geom, v), extend(geom, psi)
    V_ext, V_loc = v_ext.shape[-2] * v_ext.shape[-1], nxl * nthl
    ext_bytes = 4 * (12 * V_ext) + 4 * (nxl + 2 * W)      # links, spinor, offsets
    # the noise kernel as the trajectory draws it, and its Z2 mode as the
    # condensate of 8 vectors does
    traj = torch.full((), 123, dtype=torch.int64, device=DEV)
    pi_shape, chi_shape, n_el = (2, NX, NT), (2, NX, NT // 2), 2 * NX * NT
    n_pi, n_chi = math.prod(pi_shape), math.prod(chi_shape)
    n_values = C * (n_pi + 2 * n_chi + 1)
    n_z2 = 2 * C * B * n_el

    def flat(pi, chi, r_):
        return torch.cat([pi.flatten(), torch.view_as_real(chi).flatten(), r_])

    F_NOISE_PAIR = 12    # f64 operations of a Box-Muller pair (as counted at PR 13)
    return {
        "force_step": (lambda: tr.force_step(thE, thO, b, b, **f1),
                       lambda: tr.force_step_reference(thE, thO, b, b, **f1),
                       lambda k, p: [(k.FE, p.FE), (k.FO, p.FO)], 3e-5,
                       lambda k: Work(C * 48 * V2, C * V2 * (force + F_PLAQ)), 200, None, None),
        "solve_fused": (lambda: tr.solve_fused(thE, thO, b, b, **k2),
                        lambda: tr.solve_fused_reference(thE, thO, b, b, **k2),
                        lambda k, p: [(k.x, p.x)], 2e-4, solve_work, 20, None, None),
        # the tensor cores' products left out of its work
        "solve_fused_mxu": (lambda: tr.solve_fused_mxu(thE, thO, b, b, **k2),
                            lambda: tr.solve_fused_mxu_reference(thE, thO, b, b, **k2),
                            lambda k, p: [(k.x, p.x)], 2e-4, solve_work, 20, None, None),
        "ratio_force": (lambda: tr.ratio_force(thE, thO, b, phi2, **k5),
                        lambda: tr.ratio_force_reference(thE, thO, b, phi2, **k5),
                        lambda k, p: list(zip(k, p)), 3e-5,
                        lambda k: Work(C * 64 * V2, C * V2 * (
                            F_LINKS + F_DHAT + 2 * F_HOP + 2 * F_FORCE + F_PLAQ)),
                        200, None, None),
        "solve_refined": (lambda: rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10),
                          lambda: rs.solve_refined_reference(thE, thO, b, b, m0=M0, tol=1e-10),
                          lambda k, p: [(k.x64, p.x64)], 1e-6,
                          lambda k: refined_solves(C, V2, 1, int(k.iters.sum())), 20, None,
                          None),
        "solve_f64_cg_fallback": (
            lambda: rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0, tol=1e-10),
            lambda: rs.solve_f64_cg_fallback_reference(thE, thO, b, starved_p, m0=M0,
                                                       tol=1e-10),
            lambda k, p: [(k.x64, p.x64)], 1e-6,
            lambda k: Work(C * 112 * V2, 0.0, V2 * (C * (F_LINKS + 2 * F_NORMAL)
                                                    + F_CG_ITER * int(k.fb_iters.sum()))),
            5, None, None),
        "cg_solve_eo": (lambda: cg_eo.cg_solve_eo(ue, uo, bb, zero, **k6),
                        lambda: cg_eo.cg_solve_eo_reference(ue, uo, bb, zero, **k6),
                        lambda k, p: [(k.x, p.x)], 2e-4,
                        lambda k: condensate_inner(C, B, V2, 1, int(k.iters.sum())), 10, None,
                        None),
        "residual_f64": (lambda: rs.residual_f64(thE, thO, bb, x64, m0=M0),
                         lambda: rs.residual_f64_reference(thE, thO, bb, x64, m0=M0),
                         lambda k, p: [(k[0], p[0])], 1e-12,
                         lambda k: Work(V2 * (E * 80 + C * 16), 0.0,
                                        V2 * (E * F_RESIDUAL + C * F_LINKS)), 100, None, None),
        "halo_normal": (lambda: halo.halo_normal(*planes, v_ext, r, m0=M0, with_dots=True),
                        lambda: halo.halo_normal_reference(*planes, v_ext, r, m0=M0,
                                                           with_dots=True),
                        lambda k, p: [(k[0], p[0])], 3e-5,
                        lambda k: Work(n_blk * (ext_bytes + 4 * (8 * V_loc + 4)), n_blk * (
                            (3 * F_HOP + 8) * V_ext + (F_HOP + 8 + 32) * V_loc)),
                        200, lambda: op.normal_ext(v_ext, r), None),
        "halo_force": (lambda: halo.halo_force(*planes, psi_ext, m0=M0, beta=BETA),
                       lambda: halo.halo_force_reference(*planes, psi_ext, m0=M0, beta=BETA),
                       lambda k, p: list(zip(k, p)), 3e-5,
                       lambda k: Work(n_blk * (ext_bytes + 16 * V_loc), n_blk * (
                           (3 * F_HOP + 8 + 60) * V_ext + (F_FORCE + 16) * V_loc)),
                       200, lambda: op.force_planes(psi_ext, BETA), None),
        "chain_noise": (lambda: noise.chain_noise(5, traj, C, pi_shape, chi_shape,
                                                  torch.float32, DEV),
                        lambda: prng.trajectory_noise_reference(5, 123, C, 0, n_pi, n_chi,
                                                                torch.float32, DEV),
                        lambda k, p: [(flat(*k), flat(*p))], 1e-5,
                        lambda k: Work(4 * n_values + 8, 0.0,
                                       F_NOISE_PAIR * C * (n_pi // 2 + n_chi)),
                        200, None, lambda: torch.randn(n_values, generator=g, device=DEV)),
        "z2_noise": (lambda: noise.z2_noise(5, traj, C, B, pi_shape, DEV),
                     lambda: prng.z2_noise_reference(5, 123, C, 0, B, n_el, DEV),
                     lambda k, p: [(k.reshape(p.shape), p)], 0.0,
                     lambda k: Work(8 * C * B * n_el), 200, None,
                     lambda: torch.randint(0, 2, (n_z2,), generator=g, device=DEV)),
    }


def kernels_line(by_path) -> list:
    """Phase 3: a row a entry point."""
    rows = []
    for name, (kernel, twin, pairs, tol, work, reps, call, library) in cases().items():
        k_out, p_out = kernel(), twin()
        torch.cuda.synchronize()
        compared = pairs(k_out, p_out)
        err = max((a - b).abs().max().item() for a, b in compared)
        scale = max(b.abs().max().item() for _, b in compared)
        check(err <= tol * max(scale, 1.0), f"{name}: max |kernel - twin| {err:.3e}, "
              f"largest |twin| {scale:.3e}")
        call = call or kernel
        launches = by_entry(device_kernels(call, 3), 1).get(name, 0)
        check(launches > 0, f"{name}: no launch of its kernels in 3 calls")
        w = work(k_out)
        rows.append({
            "name": name, "route": "cuda", "source": "schwingermodel_tpu_torch/"
            + ENTRIES[name][0], "replaces": ENTRIES[name][1], "launches": launches,
            "max_abs_err": err, "ms": timed(call, reps), "device_ms": device_ms(call, reps),
            "bound_ms": 1e3 * w.seconds(),
            "bound_by": "bytes" if w.bytes / PEAK_BYTES >= w.compute_seconds() else "operations",
            "library_ms": timed(library, reps) if library else None,
            "by_path": {p: got[name] for p, got in by_path.items() if got.get(name)}})
        print(f"phase 3: {json.dumps(rows[-1])}", flush=True)
    return rows


def main() -> int:
    card = card_label(DEV)
    print(f"card: {card}", flush=True)
    rc = card_tests()
    check(rc == 0, f"the card's tests: pytest exit {rc}")
    kernels = kernels_line(device_programs())
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": not FAILED, "failed": FAILED, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(DEV),
        "count": torch.cuda.device_count()}}))
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
