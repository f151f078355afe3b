"""On-card smoke test of the PyTorch port (schwingermodel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

0. the card's name and power limit; no CUDA, no run;
1. build the five CUDA kernels from csrc/ with nvcc (sm_90a), one nvcc per
   source, all started together;
2. each kernel against its plain PyTorch twin on the card at m0=0.2,
   beta=4, random angles, on the main path's shape 64x64 C=32, on 64x64
   C=1 and on 8x12 C=3:
   K1 force_step        all four variants: forces to atol
                        3e-5 * max(scale, 1), psi to 2e-4 (with_solve);
   K2 solve_fused       tol 1e-6 from x0 = b: equal flags, x to 2e-4, every
                        f64 true residual under 2e-6 ||b||, iteration
                        counts side by side;
   K5 ratio_force       m0=-0.19, m1=0.21: forces to 3e-5 * max(scale, 1);
   K3 solve_refined     certify=True at 1e-10 (cold start) and
                        certify=False at 1e-8 (forecast start): f64 true
                        residual under tol ||b|| for every chain, equal
                        flags, iteration counts side by side;
   K4 solve_f64_cg_fallback  from a starved K3: reaches 1e-10;
   each kernel and its twin are timed in turns with CUDA events at 64x64
   C=32; then four 64x64 trajectories of C=4 chains through the kernels
   against the same trajectories through the plain twins on the CPU, same
   noise (refined leapfrog, loose leapfrog, refined Hasenbusch Omelyan,
   loose Hasenbusch leapfrog): |ddH| < 5e-3, |dtheta'| < 2e-4, equal
   accept decisions;
3. the main paths, built as the CLI builds them: runner.run_hmc at 64x64,
   beta=4, m0=0.2, tau=0.1, C=32, 10 thermalization + 20 measured
   trajectories: the refined demo (md=10), the loose contract (md=10),
   Hasenbusch dm=0.4 (refined, md=10) and Omelyan (refined, md=5); then the
   near-critical Hasenbusch row (32x32, beta=2, m0=-0.19, dm=0.4, md=26,
   tau=1, C=32, refined, max_iter 20000, cold start, 4 + 8 trajectories).
   Every run has the kernels' launch counters set to 0 just before it and
   read just after it, and fails if a kernel of its path was not launched;
4. the kernels line, the card line, and the last line
   {"ok": true, "device": {...}}.

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
    t_start = time.perf_counter()

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
    M0_HB, M1_HB = -0.19, 0.21
    LOOSE_TOL, MAX_ITER = 1e-6, 10000

    def inputs(C, nx=NX, nt=NT):
        th = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev)
              - 1.0) * math.pi
        b = torch.randn((C, 2, 2, nx, nt // 2), generator=gen, device=dev)
        return (*tr.pack_planes(th), b)

    def rel_residual(thE, thO, b, x, m0=M0):
        """Per-chain f64 ||b - A x|| / ||b|| from the plain operator."""
        ue, uo = gauge.links(thE, thO, torch.complex128)
        bc = tr.to_complex(b).to(torch.complex128)
        r = bc - eo.normal(ue, uo, tr.to_complex(x).to(torch.complex128), m0)
        return ((r.abs() ** 2).sum(dim=(1, 2, 3)).sqrt()
                / (bc.abs() ** 2).sum(dim=(1, 2, 3)).sqrt())

    def force_err(FE, FO, RE, RO, label, rel=3e-5):
        torch.cuda.synchronize()
        scale = max(RE.abs().max().item(), RO.abs().max().item())
        err = max((FE - RE).abs().max().item(), (FO - RO).abs().max().item())
        check(err <= rel * max(scale, 1.0), f"{label}: err {err} scale {scale}")
        print(f"phase 2: {label}: max |F - F_plain| = {err:.3e} (scale "
              f"{scale:.3f}, atol {rel * max(scale, 1.0):.3e})", flush=True)
        return err

    errs = dict.fromkeys(("force_step", "solve_fused", "ratio_force",
                          "solve_refined", "solve_f64_cg_fallback"), 0.0)
    # the main path's shapes, and a small non-square lattice
    for nx, nt, C in ((NX, NT, C_MAIN), (NX, NT, 1), (8, 12, 3)):
        thE, thO, b = inputs(C, nx, nt)
        C = f"{C} at {nx}x{nt}"

        # K1, every variant; with_solve from x0 = phi = b at the loose tol
        for with_solve in (False, True):
            for with_gauge in (True, False):
                kw = dict(m0=M0, beta=BETA, tol=LOOSE_TOL, max_iter=MAX_ITER,
                          with_solve=with_solve, with_gauge=with_gauge)
                k = tr.force_step(thE, thO, b, b, **kw)
                p = tr.force_step_reference(thE, thO, b, b, **kw)
                label = (f"K1 with_solve={with_solve} with_gauge={with_gauge} "
                         f"C={C}")
                err = force_err(k.FE, k.FO, p.FE, p.FO, label)
                errs["force_step"] = max(errs["force_step"], err)
                if with_solve:
                    dpsi = (k.psi - p.psi).abs().max().item()
                    check(dpsi <= 2e-4, f"{label}: psi differs by {dpsi}")
                    check(torch.equal(k.converged, p.converged)
                          and bool(k.converged.all()), f"{label}: flags")
                    print(f"phase 2: {label}: max |psi - psi_plain| {dpsi:.3e}; "
                          f"iterations kernel {k.iters[:8].tolist()} plain "
                          f"{p.iters[:8].tolist()}", flush=True)

        # K2 at the loose tolerance, cold start
        k = tr.solve_fused(thE, thO, b, b, m0=M0, tol=LOOSE_TOL, max_iter=MAX_ITER)
        p = tr.solve_fused_reference(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
                                     max_iter=MAX_ITER)
        rk, rp = rel_residual(thE, thO, b, k.x), rel_residual(thE, thO, b, p.x)
        dx = (k.x - p.x).abs().max().item()
        check(torch.equal(k.converged, p.converged) and bool(k.converged.all()),
              f"K2 C={C}: flags")
        check(dx <= 2e-4, f"K2 C={C}: x differs by {dx}")
        check(bool((rk < 2 * LOOSE_TOL).all()) and bool((rp < 2 * LOOSE_TOL).all()),
              f"K2 C={C}: true residual kernel {rk.max().item()} plain "
              f"{rp.max().item()}")
        errs["solve_fused"] = max(errs["solve_fused"], dx)
        print(f"phase 2: K2 tol={LOOSE_TOL:g} C={C}: f64 true residual kernel "
              f"{rk.max().item():.3e} plain {rp.max().item():.3e}; max |x - x_plain| "
              f"{dx:.3e}; iterations kernel {k.iters[:8].tolist()} plain "
              f"{p.iters[:8].tolist()}", flush=True)

        # K5 near the critical mass
        phi2 = torch.randn(b.shape, generator=gen, device=dev)
        FE, FO = tr.ratio_force(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB, beta=BETA)
        RE, RO = tr.ratio_force_reference(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB,
                                          beta=BETA)
        errs["ratio_force"] = max(errs["ratio_force"], force_err(
            FE, FO, RE, RO, f"K5 m0={M0_HB} m1={M1_HB} C={C}"))

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
    phi2 = torch.randn(b.shape, generator=gen, device=dev)
    starved = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10, max_iter=20)

    def k1(fn, with_solve, with_gauge):
        return lambda: fn(thE, thO, b, b, m0=M0, beta=BETA, tol=LOOSE_TOL,
                          max_iter=MAX_ITER, with_solve=with_solve,
                          with_gauge=with_gauge)

    k1_times = {
        f"with_solve={s},with_gauge={g}": in_turns(
            k1(tr.force_step_reference, s, g), k1(tr.force_step, s, g),
            2 if s else 20, 20 if s else 200)
        for s in (False, True) for g in (True, False)}
    times = {
        # the refined main path's variant
        "force_step": k1_times["with_solve=False,with_gauge=True"],
        "solve_fused": in_turns(
            lambda: tr.solve_fused_reference(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
                                             max_iter=MAX_ITER),
            lambda: tr.solve_fused(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
                                   max_iter=MAX_ITER), 2, 20),
        "ratio_force": in_turns(
            lambda: tr.ratio_force_reference(thE, thO, b, phi2, m0=M0_HB,
                                             m1=M1_HB, beta=BETA),
            lambda: tr.ratio_force(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB,
                                   beta=BETA), 20, 200),
        "solve_refined": in_turns(
            lambda: rs.solve_refined_reference(thE, thO, b, b, m0=M0, tol=1e-10),
            lambda: rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10), 1, 20),
        "solve_f64_cg_fallback": in_turns(
            lambda: rs.solve_f64_cg_fallback_reference(thE, thO, b, starved,
                                                       m0=M0, tol=1e-10),
            lambda: rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0,
                                             tol=1e-10), 1, 20),
    }
    for k_name, (ms, plain_ms) in [*times.items(),
                                   *(("force_step " + v, t) for v, t in k1_times.items())]:
        print(f"phase 2: time at {NX}x{NT} C={C_MAIN} ({card}): {k_name} kernel "
              f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms", flush=True)

    # trajectories through the kernels against the plain twins on the CPU
    lattice = LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")

    def hmc_params(md_steps=10, refine=True, **kw):
        return HMCParams(
            beta=BETA, m0=M0, md_steps=md_steps, trajectory_length=0.1,
            even_odd=True, **kw,
            cg=CGParams(tol=1e-10 if refine else LOOSE_TOL, max_iter=MAX_ITER,
                        refine=refine, inner_tol=1e-5))

    for label, hmc in (
            ("refined leapfrog", hmc_params()),
            ("loose leapfrog", hmc_params(refine=False)),
            ("refined Hasenbusch dm=0.4 omelyan", hmc_params(
                md_steps=3, hasenbusch_dm=0.4, integrator="omelyan")),
            ("loose Hasenbusch dm=0.4 leapfrog", hmc_params(
                md_steps=6, refine=False, hasenbusch_dm=0.4))):
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
              f"trajectory {label}: unconverged solve")
        check(ddH < 5e-3 and dth < 2e-4,
              f"trajectory {label}: |ddH| {ddH}, |dtheta| {dth}")
        check(torch.equal(st_k.accepted.cpu(), st_p.accepted),
              f"trajectory {label}: accept decisions differ")
        print(f"phase 2: trajectory {label} {NX}x{NT} C=4, md={hmc.md_steps}, "
              f"kernels vs plain twins on the CPU: max |ddH| {ddH:.3e}, max "
              f"|dtheta'| {dth:.3e}, dH kernels {st_k.delta_H.tolist()}, CG "
              f"iterations kernels {st_k.cg_iters.tolist()} plain "
              f"{st_p.cg_iters.tolist()}", flush=True)

    # ---- phase 3: the main paths ----
    counters = {"force_step": tr.force_step, "solve_fused": tr.solve_fused,
                "ratio_force": tr.ratio_force, "solve_refined": rs.solve_refined,
                "solve_f64_cg_fallback": rs.solve_f64_cg_fallback}
    launches = dict.fromkeys(counters, 0)
    variants = {}

    def counted(label, uses, drive):
        """Run drive() with every launch counter set to 0 just before and
        read just after; fail unless each kernel in `uses` (an entry point,
        or force_step's variant) was launched."""
        for fn in counters.values():
            fn.launches = 0
        tr.force_step.variants.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        by_variant = dict(tr.force_step.variants)
        print(f"phase 3: {label}: launches {got}, force_step by variant "
              f"{by_variant}", flush=True)
        for k in uses:
            n = by_variant.get(k, 0) if k.startswith("with_solve") else got[k]
            check(n > 0, f"{label}: {k} was not launched")
        for k, n in got.items():
            launches[k] += n
        for k, n in by_variant.items():
            variants[k] = variants.get(k, 0) + n
        return out, wall

    run = RunParams(n_therm=10, n_meas=20, n_steps=0, n_chains=C_MAIN, seed=0)
    refined_k = ("solve_refined", "solve_f64_cg_fallback")
    for label, hmc, uses in (
            ("refined demo md=10", hmc_params(),
             ("with_solve=False,with_gauge=True", *refined_k)),
            ("(a) --no-cg-refine md=10", hmc_params(refine=False),
             ("with_solve=True,with_gauge=True", "solve_fused")),
            ("(b) --hasenbusch-dm 0.4 md=10", hmc_params(hasenbusch_dm=0.4),
             ("with_solve=False,with_gauge=False", "ratio_force", *refined_k)),
            ("(c) --integrator omelyan md=5", hmc_params(
                md_steps=5, integrator="omelyan"),
             ("with_solve=False,with_gauge=True", *refined_k))):
        res, wall = counted(label, uses,
                            lambda: run_hmc(lattice, hmc, run, device=dev))
        check(res.all_converged and res.n_ill == 0, f"{label}: a solve did not converge")
        check(0.3 < res.acceptance_rate <= 1.0,
              f"{label}: acceptance {res.acceptance_rate}")
        check(0.0 < res.Ep < 1.0, f"{label}: <P> = {res.Ep}")
        check(bool(torch.isfinite(torch.as_tensor(res.theta)).all())
              and res.theta.shape == (C_MAIN, 2, NX, NT), f"{label}: final configuration")
        check(abs(res.exp_mdH_mean - 1.0) < 0.1,
              f"{label}: <exp(-dH)> {res.exp_mdH_mean}")
        meas = res.perf["measure"]
        n_traj = run.n_therm + run.n_meas
        print(f"phase 3: {label}: {NX}x{NT} beta=4 m0=0.2 tau=0.1 C={C_MAIN}, "
              f"{run.n_therm}+{run.n_meas} trajectories in {wall:.2f} s: "
              f"<P> = {res.Ep:.6f} +- {res.dEp:.6f}, acceptance "
              f"{res.acceptance_rate:.4f}, <exp(-dH)> {res.exp_mdH_mean:.6f}, "
              f"measure phase {meas['traj_per_s']:.2f} chain-traj/s "
              f"({meas['traj_per_s'] / C_MAIN:.3f} traj/s of {C_MAIN} chains), "
              f"{meas['cg_iters_per_traj']:.1f} CG iterations per chain-trajectory, "
              f"{n_traj * C_MAIN / wall:.2f} chain-traj/s over the whole run; "
              f"card {card}", flush=True)

    # the near-critical Hasenbusch row (tools/bench_points.py:60-61)
    nc_lat = LatticeParams(Nx=32, Nt=32, real_dtype="float32")
    nc = SchwingerModel(lattice=nc_lat, hmc=HMCParams(
        beta=2.0, m0=-0.19, md_steps=26, trajectory_length=1.0, even_odd=True,
        hasenbusch_dm=0.4,
        cg=CGParams(tol=1e-10, max_iter=20000, refine=True, inner_tol=1e-5)))
    n_therm, n_meas = 4, 8

    def near_critical():
        theta = torch.zeros((C_MAIN, 2, 32, 32), device=dev)
        stats = []
        for i in range(n_therm + n_meas):
            theta, st = hp.hmc_trajectory_packed(nc, theta, 0, i)
            stats.append(st)
        return stats

    stats, wall = counted(
        "near-critical 32x32 beta=2 m0=-0.19 dm=0.4 md=26 tau=1", (
            "with_solve=False,with_gauge=False", "ratio_force", *refined_k),
        near_critical)
    dH = torch.stack([st.delta_H for st in stats])
    check(bool(torch.isfinite(dH).all()), "near-critical: non-finite dH")
    measured = stats[n_therm:]
    acc = torch.stack([st.accepted for st in measured]).double().mean().item()
    iters = torch.stack([st.cg_iters for st in measured]).double().mean().item()
    conv = bool(torch.stack([st.cg_converged for st in stats]).all())
    em = torch.stack([st.exp_mdH for st in measured]).mean().item()
    print(f"phase 3: near-critical Hasenbusch row, 32x32 beta=2 m0=-0.19 dm=0.4 "
          f"md=26 tau=1 C={C_MAIN} refined max_iter 20000, cold start, "
          f"{n_therm}+{n_meas} trajectories in {wall:.2f} s: all_converged {conv}, "
          f"acceptance {acc:.4f} and <exp(-dH)> {em:.4f} over the {n_meas} "
          f"measured, {iters:.1f} CG iterations per chain-trajectory, max |dH| "
          f"{dH[:n_therm].abs().max().item():.4g} over the thermalization and "
          f"{dH[n_therm:].abs().max().item():.4g} over the measured, "
          f"{(n_therm + n_meas) * C_MAIN / wall:.2f} chain-traj/s; card {card}",
          flush=True)

    # ---- phase 4: report ----
    replaces = {
        "force_step": ("csrc/force_step.cu", "schwingermodel_tpu/ops/pallas_traj.py:339"),
        "solve_fused": ("csrc/solve_fused.cu", "schwingermodel_tpu/ops/pallas_traj.py:532"),
        "ratio_force": ("csrc/ratio_force.cu", "schwingermodel_tpu/ops/pallas_traj.py:465"),
        "solve_refined": ("csrc/solve_ru.cu", "schwingermodel_tpu/ops/pallas_df.py:402"),
        "solve_f64_cg_fallback": ("csrc/cg_fallback.cu",
                                  "schwingermodel_tpu/ops/pallas_df.py:674"),
    }
    kernels = [{"name": k, "route": "cuda",
                "source": "schwingermodel_tpu_torch/" + src, "replaces": rep,
                "launches": launches[k], "max_abs_err": errs[k],
                "ms": times[k][0], "plain_ms": times[k][1]}
               for k, (src, rep) in replaces.items()]
    kernels[0]["launches_by_variant"] = variants
    kernels[0]["ms_by_variant"] = {v: t[0] for v, t in k1_times.items()}
    kernels[0]["plain_ms_by_variant"] = {v: t[1] for v, t in k1_times.items()}
    check(all(e["launches"] > 0 for e in kernels), "a kernel was never launched")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
