"""On-card smoke test of the PyTorch port (schwingermodel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

0. the card's name and power limit; no CUDA, no run;
1. build the three CUDA kernels from csrc/ with nvcc (sm_90a);
2. each kernel against its plain PyTorch twin on the card at 64x64,
   m0=0.2, beta=4, random angles, C=32 and C=1:
   K1 force_step        forces to atol 3e-5 * max(scale, 1);
   K3 solve_refined     certify=True at 1e-10 (cold start) and
                        certify=False at 1e-8 (forecast start): f64 true
                        residual under tol ||b|| for every chain, equal
                        flags, iteration counts side by side;
   K4 solve_f64_cg_fallback  from a starved K3: reaches 1e-10;
   each kernel and its twin are timed in turns with CUDA events;
   then one 64x64 trajectory of C=4 chains through the kernels against
   the same trajectory through the plain twins on the CPU, same noise;
3. the main path, built as the CLI builds it: runner.run_hmc at 64x64,
   beta=4, m0=0.2, 10 MD steps, tau=0.1, the refined 1e-10 contract,
   C=32, 10 thermalization + 20 measured trajectories, with the kernels'
   launch counters set to 0 just before and read just after;
4. the last line: {"ok": true, "device": {...}}.

Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

M0, BETA, NX, NT = 0.2, 4.0, 64, 64
C_MAIN = 32


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps):
    """Mean milliseconds per call over `reps` calls, with CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def in_turns(plain, kernel, reps_plain, reps_kernel):
    """Times in the order plain, kernel, kernel, plain; means of each."""
    p1 = timed(plain, reps_plain)
    k1 = timed(kernel, reps_kernel)
    k2 = timed(kernel, reps_kernel)
    p2 = timed(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    from schwingermodel_tpu_torch.config import (CGParams, HMCParams,
                                                 LatticeParams, RunParams)
    from schwingermodel_tpu_torch.hmc import packed as hp
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.ops import _cuda, eo, gauge
    from schwingermodel_tpu_torch.ops import refined as rs
    from schwingermodel_tpu_torch.ops import traj as tr
    from schwingermodel_tpu_torch.runner import run_hmc

    # the package under test is the checkout's own, beside this script
    check(Path(_cuda.__file__).resolve().parents[2] == Path(__file__).resolve().parent,
          f"schwingermodel_tpu_torch imported from {_cuda.__file__}, not from "
          "this script's checkout")

    # ---- phase 0: the card ----
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase 0: device {name}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- phase 1: build ----
    _cuda.KERNELS.build()
    print(f"phase 1: built {_cuda.KERNELS.path.name} in "
          f"{_cuda.KERNELS.build_seconds:.1f} s", flush=True)

    # ---- phase 2: kernels against their plain twins ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def inputs(C, nx=NX, nt=NT):
        th = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev)
              - 1.0) * math.pi
        b = torch.randn((C, 2, 2, nx, nt // 2), generator=gen, device=dev)
        return (*tr.pack_planes(th), b)

    def rel_residual(thE, thO, b, x64):
        """Per-chain f64 ||b - A x|| / ||b|| from the plain operator."""
        ue, uo = gauge.links(thE, thO, torch.complex128)
        bc = tr.to_complex(b).to(torch.complex128)
        r = bc - eo.normal(ue, uo, tr.to_complex(x64), M0)
        return ((r.abs() ** 2).sum(dim=(1, 2, 3)).sqrt()
                / (bc.abs() ** 2).sum(dim=(1, 2, 3)).sqrt())

    errs = {"force_step": 0.0, "solve_refined": 0.0, "solve_f64_cg_fallback": 0.0}
    # the main path's shapes, and a small non-square lattice
    for nx, nt, C in ((NX, NT, C_MAIN), (NX, NT, 1), (8, 12, 3)):
        thE, thO, b = inputs(C, nx, nt)
        C = f"{C} at {nx}x{nt}"
        FE, FO = tr.force_step(thE, thO, b, M0, BETA)
        RE, RO = tr.force_step_reference(thE, thO, b, M0, BETA)
        torch.cuda.synchronize()
        scale = max(RE.abs().max().item(), RO.abs().max().item())
        err = max((FE - RE).abs().max().item(), (FO - RO).abs().max().item())
        check(err <= 3e-5 * max(scale, 1.0), f"K1 C={C}: err {err} scale {scale}")
        errs["force_step"] = max(errs["force_step"], err)
        print(f"phase 2: K1 C={C}: max |F - F_plain| = {err:.3e} "
              f"(scale {scale:.3f}, atol {3e-5 * max(scale, 1.0):.3e})", flush=True)

        exact = None
        for certify, tol in ((True, 1e-10), (False, 1e-8)):
            # the force contract is exercised from a forecast start, as on
            # the main path: the certified solution, perturbed by 1e-3
            x0 = b if certify else (
                exact.x + 1e-3 * exact.x.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
                * torch.randn(b.shape, generator=gen, device=dev))
            k = rs.solve_refined(thE, thO, b, x0, m0=M0, tol=tol, certify=certify)
            p = rs.solve_refined_reference(thE, thO, b, x0, m0=M0, tol=tol,
                                           certify=certify)
            rk = rel_residual(thE, thO, b, k.x64)
            rp = rel_residual(thE, thO, b, p.x64)
            check(bool((rk < tol).all()), f"K3 certify={certify} C={C}: "
                  f"kernel residual {rk.max().item()}")
            check(bool((rp < tol).all()), f"K3 plain certify={certify} C={C}: "
                  f"residual {rp.max().item()}")
            check(torch.equal(k.converged, p.converged),
                  f"K3 certify={certify} C={C}: flags differ")
            check(bool(k.converged.all()), f"K3 certify={certify} C={C}: "
                  "unconverged")
            dx = (k.x64 - p.x64).abs().max().item()
            if certify:
                exact = k
                errs["solve_refined"] = max(errs["solve_refined"], dx)
            print(f"phase 2: K3 certify={certify} tol={tol:g} C={C}: residual "
                  f"kernel {rk.max().item():.3e} plain {rp.max().item():.3e}; "
                  f"max |x - x_plain| {dx:.3e}; iterations kernel "
                  f"{k.iters[:8].tolist()} plain {p.iters[:8].tolist()}",
                  flush=True)

        starved = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10, max_iter=5)
        check(not bool(starved.converged.any()), "starved K3 converged")
        before = rs.solve_f64_cg_fallback.launches
        fk = rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0, tol=1e-10)
        check(rs.solve_f64_cg_fallback.launches == before + 1, "K4 not launched")
        fp = rs.solve_f64_cg_fallback_reference(thE, thO, b, starved, m0=M0,
                                                tol=1e-10)
        rk = rel_residual(thE, thO, b, fk.x64)
        check(bool((rk < 1e-10).all()) and bool(fk.converged.all()),
              f"K4 C={C}: residual {rk.max().item()}")
        check(torch.equal(fk.converged, fp.converged), f"K4 C={C}: flags differ")
        dx = (fk.x64 - fp.x64).abs().max().item()
        errs["solve_f64_cg_fallback"] = max(errs["solve_f64_cg_fallback"], dx)
        print(f"phase 2: K4 C={C} from K3 starved at 5 iterations: residual "
              f"{rk.max().item():.3e}; max |x - x_plain| {dx:.3e}; iterations "
              f"kernel {fk.iters[:8].tolist()} plain {fp.iters[:8].tolist()}",
              flush=True)

    # timings at C=32, kernel and plain twin in turns
    thE, thO, b = inputs(C_MAIN)
    starved = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10, max_iter=20)
    times = {
        "force_step": in_turns(
            lambda: tr.force_step_reference(thE, thO, b, M0, BETA),
            lambda: tr.force_step(thE, thO, b, M0, BETA), 20, 200),
        "solve_refined": in_turns(
            lambda: rs.solve_refined_reference(thE, thO, b, b, m0=M0, tol=1e-10),
            lambda: rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10), 1, 20),
        "solve_f64_cg_fallback": in_turns(
            lambda: rs.solve_f64_cg_fallback_reference(thE, thO, b, starved,
                                                       m0=M0, tol=1e-10),
            lambda: rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0,
                                             tol=1e-10), 1, 20),
    }
    for k_name, (ms, plain_ms) in times.items():
        print(f"phase 2: time at {NX}x{NT} C={C_MAIN} ({card}): {k_name} kernel "
              f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms", flush=True)

    # one trajectory through the kernels against the plain twins on the CPU
    lattice = LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")
    hmc = HMCParams(beta=BETA, m0=M0, md_steps=10, trajectory_length=0.1,
                    even_odd=True,
                    cg=CGParams(tol=1e-10, max_iter=10000, refine=True,
                                inner_tol=1e-5))
    model = SchwingerModel(lattice=lattice, hmc=hmc)
    theta = (2.0 * torch.rand((4, 2, NX, NT), generator=gen, device=dev)
             - 1.0) * math.pi
    pi, chi, r = hp.draw_chain_noise(model, 99, 0, 4, dev)
    th_k, st_k = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    th_p, st_p = hp.trajectory_packed_given_noise(
        model, theta.cpu(), pi.cpu(), chi.cpu(), r.cpu())
    ddH = (st_k.delta_H.cpu() - st_p.delta_H).abs().max().item()
    dth = (th_k.cpu() - th_p).abs().max().item()
    check(bool(st_k.cg_converged.all()) and bool(st_p.cg_converged.all()),
          "trajectory: unconverged solve")
    check(ddH < 5e-3 and dth < 2e-4, f"trajectory: |ddH| {ddH}, |dtheta| {dth}")
    check(torch.equal(st_k.accepted.cpu(), st_p.accepted),
          "trajectory: accept decisions differ")
    print(f"phase 2: trajectory {NX}x{NT} C=4, kernels vs plain twins on the CPU: "
          f"max |ddH| {ddH:.3e}, max |dtheta'| {dth:.3e}, dH kernels "
          f"{st_k.delta_H.tolist()}", flush=True)

    # ---- phase 3: the main path ----
    run = RunParams(n_therm=10, n_meas=20, n_steps=0, n_chains=C_MAIN, seed=0)
    counters = (tr.force_step, rs.solve_refined, rs.solve_f64_cg_fallback)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_hmc(lattice, hmc, run, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"phase 3: launches {launches}", flush=True)
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    check(res.all_converged and res.n_ill == 0, "a solve did not converge")
    check(0.3 < res.acceptance_rate <= 1.0, f"acceptance {res.acceptance_rate}")
    check(0.0 < res.Ep < 1.0, f"<P> = {res.Ep}")
    check(bool(torch.isfinite(torch.as_tensor(res.theta)).all())
          and res.theta.shape == (C_MAIN, 2, NX, NT), "final configuration")
    check(abs(res.exp_mdH_mean - 1.0) < 0.1, f"<exp(-dH)> {res.exp_mdH_mean}")
    meas = res.perf["measure"]
    n_traj = (run.n_therm + run.n_meas)
    print(f"phase 3: {NX}x{NT} beta=4 m0=0.2 md=10 tau=0.1 C={C_MAIN}, "
          f"{run.n_therm}+{run.n_meas} trajectories in {wall:.2f} s: "
          f"<P> = {res.Ep:.6f} +- {res.dEp:.6f}, acceptance "
          f"{res.acceptance_rate:.4f}, <exp(-dH)> {res.exp_mdH_mean:.6f}, "
          f"measure phase {meas['traj_per_s']:.2f} chain-traj/s "
          f"({meas['traj_per_s'] / C_MAIN:.3f} traj/s of {C_MAIN} chains), "
          f"{meas['cg_iters_per_traj']:.1f} CG iterations per chain-trajectory, "
          f"{n_traj * C_MAIN / wall:.2f} chain-traj/s over the whole run; "
          f"card {card}", flush=True)

    # ---- phase 4: report ----
    replaces = {
        "force_step": ("csrc/force_step.cu", "schwingermodel_tpu/ops/pallas_traj.py:339"),
        "solve_refined": ("csrc/solve_ru.cu", "schwingermodel_tpu/ops/pallas_df.py:402"),
        "solve_f64_cg_fallback": ("csrc/cg_fallback.cu",
                                  "schwingermodel_tpu/ops/pallas_df.py:674"),
    }
    kernels = [{"name": k, "route": "cuda",
                "source": "schwingermodel_tpu_torch/" + src, "replaces": rep,
                "launches": launches[k], "max_abs_err": errs[k],
                "ms": times[k][0], "plain_ms": times[k][1]}
               for k, (src, rep) in replaces.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
