"""On-card smoke test of the PyTorch port (schwingermodel_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--profile]

Phases (any failure raises, and the script exits non-zero):

0. the card's name and power limit; no CUDA, no run;
1. build the eleven CUDA kernels (the noise kernel with its Z2 mode) from
   csrc/ with nvcc (sm_90a), one nvcc
   per source, all started together;
2. each kernel against its plain PyTorch twin on the card at m0=0.2,
   beta=4, random angles, on the main path's shape 64x64 C=32, on 64x64
   C=1 and on 8x12 C=3:
   noise chain_noise    (Philox4x32-10, csrc/noise.cu) the three
                        known-answer vectors of Random123 out of the
                        kernel's bijection; at 64x64 C=32 with the
                        trajectory counter on the card, under every chi
                        shape (even-odd, Hasenbusch, full-D) and in f32 and
                        f64: the Philox words equal the twin's, the values
                        equal but for counted ties; chains 2-3 of C=4 equal
                        C=2 at chain_offset 2, the int index equals the
                        counter; timed in turns with its twin and with
                        torch.randn of as many values (library_ms);
   K1 force_step        all four variants: forces to atol
                        3e-5 * max(scale, 1), psi to 2e-4 and equal flags
                        (with_solve); also at K3's other shapes below, so
                        on every path K1 and K2 have (one block's shared
                        memory, several blocks a chain, the global scratch);
   K2 solve_fused       tol 1e-6 from x0 = b: equal flags, x to 2e-4, every
                        f64 true residual under 2e-6 ||b||, iteration
                        counts side by side;
   K10 solve_fused_mxu  (K2 with its x-shifts as one-hot products on the
                        tensor cores, banded, on K2's path) against its twin
                        and against K2, tol 1e-6 from x0 = b: equal flags and
                        iterations, x bit for bit K2's and to 2e-4 of the
                        twin's, every f64 true residual under 2e-6 ||b||;
                        against K2 bit for bit at K3's other shapes below
                        too (the global path at 128x128 and 126x128); and
                        its shifts alone, P+ a and P- a
                        of random f32 planes across 30 binades, equal to
                        torch.roll bit for bit (allow_tf32 is set False and
                        asserted first: the twin's matmul must be exact);
   K5 ratio_force       m0=-0.19, m1=0.21: forces to 3e-5 * max(scale, 1),
                        on every path its size takes (K1's no-solve body
                        with the bilinears folded: 4 blocks a chain at
                        64x64 C=32 and 32x32 C=32, 1 at C=128, 8 at 64x64
                        C=1 and 128x128 C=2 and C=8; the global scratch at
                        126x128), the path printed;
   K3 solve_refined     certify=True at 1e-10 (cold start) and
                        certify=False at 1e-8 (forecast start), also at
                        32x32 C=32 (everything in shared memory), 20x34 C=2
                        (odd extents), 128x128 C=2 (too large for one
                        block's shared memory: a cluster of 8 blocks a
                        chain) and 126x128 C=2 (no cluster divides it: the
                        global scratch), the path each shape takes printed: f64 true residual under
                        tol ||b|| for every chain, equal flags, iteration
                        counts side by side, and every chain alone equal to
                        its chain of the batch bit for bit;
   K4 the f64 fallback  from a K3 starved at 5 iterations, inside K3's launch
                        (solve_refined(fallback=True)) and as a launch of
                        its own (solve_f64_cg_fallback), at the same shapes:
                        both reach 1e-10 with the flags and non-zero
                        fallback iterations of the composed twins and equal
                        each other bit for bit; a mixed batch under
                        max_iter=5 at 1e-6 (half the chains from the
                        certified solution, which K3 accepts at once, half
                        from x0 = b) where only the second half falls back
                        and the first half keeps K3's x bit for bit;
   K6 cg_solve_eo       on given links, B right-hand sides per
                        configuration (B=8 at C=32, 1 at C=1, 2 at C=3, and
                        at K3's other shapes below: B=8 at 32x32, 2 else):
                        tol 1e-5 from x0 = 0 (the refinement's inner solve)
                        and 1e-6 from x0 = b (the loose solve): equal flags,
                        x to 2e-4, every f64 true residual under
                        2 tol ||b||, iteration counts side by side; a
                        starved max_iter=3 solve unconverged in both, finite;
                        the path (one block's shared memory up to 64x64,
                        the global scratch beyond) and the blocks an SM
                        runs at once printed; on the shared path where V2 is
                        a multiple of 512 (64x64, 32x32) x, iterations and
                        flags equal to the global path's (through the C
                        entry) bit for bit; a batch with one zero
                        right-hand side (no guards): iterations, flags and
                        the non-finite pattern of the twin (1 iteration,
                        unconverged, NaN x), the other entries bit for bit
                        the global path's;
   K9 residual_f64      on random f64 x, on the route ops/refined.residual_path
                        takes and on every other (each slab count with each
                        count of right-hand sides a block, and the global
                        scratch), also at K3's other shapes below:
                        |r - r_plain| <= 1e-12 (max|b| + max|A x|), ||r||^2
                        to 1e-12 relative, r bit for bit across the routes,
                        two launches equal;
   K3's MRE branch      (a history of K = 4 earlier solutions; the forecast a
                        prologue of K3's launch) at 32x32 C=32 (all shared),
                        64x64 C=32 (shared), 128x128 C=2 (a cluster) and
                        126x128 C=2 (the global scratch), on the history of
                        tests_tpu/test_tpu_resident.py:444-478 and on the last
                        four force solutions of a refined MRE trajectory
                        (md=40, tau=1, its action solve's inputs): the
                        forecast alone (max_iter=0) to 1e-4 of ||x0||
                        against mre_forecast_reference, the solve at 1e-10
                        under 1e-10 ||b|| on the f64 oracle with the twin's
                        flags, chains 0 and 1 alone bit for bit their chains
                        of the batch, iterations beside K = 1's; at 64x64
                        C=32 K3's ms at K = 4 against K = 1 in turns;
   the refined dirac_inverse (K6 + K9 + K4) at 64x64 C=2 B=4 against the
   plain twins on the CPU, same noise: every flag true, each estimate
   Re(z^+ w) to rtol 1e-6;
   K7 halo_normal       (with and without the dot partials) and
   K8 halo_force        on the blocks of a mesh of shards: 64x64 over 2x2
                        (the demo mesh), 4x1 and 1x4 at C=32, 16x16 over 2x2
                        at C=3, and 128x128 over 2x2 at C=2 (a block too
                        large for one block's shared memory: 8 blocks a
                        shard), each shape's path and blocks a shard
                        (ops/halo.halo_path) printed: out and forces to atol
                        3e-5 * max(scale, 1), partials to 1e-5 of the
                        block's largest, two launches of K7 on the same
                        inputs equal bit for bit; at 64x64 and 128x128
                        over 2x2 the global-scratch kernels (taken only
                        where no split holds a block) as well, launched by
                        route, to the same tolerances, two launches of each
                        equal bit for bit; the sharded
                        K7 CG against the unsharded K2 on the same theta and b
                        (tol 1e-6:
                        flags, f64 true residuals under 2e-6 ||b||, x to
                        2e-4, iterations side by side); K8's force,
                        unsharded again, against K1's (with_solve=False) to
                        3e-5 * max(scale, 1);
   each kernel and its twin are timed in turns with CUDA events at 64x64
   C=32 (K6 and K9 with B=8; K7 and K8 on the 2x2 mesh, through the sharded
   CG's operator and the force's call, and through the public wrappers) as
   the main path issues them, each kernel also with its calls queued behind a spin of the
   card, which leaves the host-side launch out (device_ms), beside the kernel's
   bound: the larger of its bytes (inputs read once, outputs written once)
   over 3.35 TB/s and its operations (at the iteration counts these inputs
   needed) over the card's f32 or f64 peak (K10's banded products, as it
   issues them, over the f64 tensor-core peak; the dense count's bound
   beside), and K10 and K2 in turns; K9's route; K1's and K2's path (one
   block's shared memory, several blocks a chain, or the global scratch:
   ops/traj.cg_path) and microseconds per CG iteration, K6's path, blocks an
   SM, waves and microseconds per iteration of a wave's slowest entry, and
   K5's blocks a chain; then four 64x64 trajectories of C=4
   chains through the kernels against the same trajectories through the plain twins on the CPU, same
   noise (refined leapfrog, loose leapfrog, refined Hasenbusch Omelyan,
   loose Hasenbusch leapfrog): |ddH| < 5e-3, |dtheta'| < 2e-4, equal
   accept decisions; the same for one trajectory on the 2x2 mesh under each
   contract, which is also held against the packed path on the same noise
   (dH to 5e-3, theta' to 2e-4: the forecast differs, the trajectory does
   not) and against the unpacked sampler without a mesh, whose f32 solves
   must launch K6;
3. the main paths, built as the CLI builds them: runner.run_hmc at 64x64,
   beta=4, m0=0.2, tau=0.1, C=32, 10 thermalization + 20 measured
   trajectories, each packed path on its device program (one CUDA graph
   replay a trajectory, hmc/program.py): the refined demo (md=10), the
   loose contract (md=10), Hasenbusch dm=0.4 (refined, md=10) and Omelyan
   (refined, md=5), each launching the noise kernel; (t) the device
   program: the refined demo, loose, Hasenbusch, Omelyan md=5, MRE K=4 and
   128x128 C=8 (K3 on a cluster), 10 replays after the capture against 11
   eager calls at the same indices: theta, every block accumulator and the
   counter bit for bit, the launch counts equal (the demo: K3 10, K1 9,
   K4's entry 0, noise 1 a trajectory), a replay and an eager call timed in
   turns; the CLI at the demo point on the graph (10 + 20, the main gates,
   one capture and 29 replays); the demo graphed and eager in turns
   through run_hmc (chain-traj/s) and under torch.profiler (busy share,
   launches a batch trajectory, K1, K3 and the noise kernel by name); then the
   near-critical Hasenbusch row (32x32, beta=2, m0=-0.19, dm=0.4, md=26,
   tau=1, C=32, refined, max_iter 20000, cold start, 4 + 8 trajectories);
   then the measurement path: (d) the refined demo with --condensate
   --n-noise 8 (K6, K9, K4; on its final configurations the condensate
   through the kernels equals the plain twins' on the card, same noise, to
   rtol 1e-6, and one measurement is timed with its K6 and K9 launches'
   shares), (e) the loose demo with --condensate (K6 from x0 = b, no
   K9), and the meson correlators at 64x64 C=2 on (d)'s final
   configurations (kernels against the twins on the card to rtol 1e-6; the
   PCAC plateau printed); then the lattice mesh, 4 + 8 trajectories: (f)
   the refined demo on 2x2 shards (K7 in every f32 solve, K8 in every
   force; the f64 true residual is plain PyTorch) and (g) the same loose,
   with no K1, K2 or K3 launch; then K10's path and the rest of the sampler: the tool
   tools/bench_mxu_stencil at full width (K2 against K10 on 50 right-hand
   sides), and at 64x64 C=32 (h) the refined demo with --autotune (8 + 20
   trajectories, n_tune 8: the warm-up on the packed path), (i) a quenched
   run held to 0 < <P> < I1(4)/I0(4) + 0.05 with no solver launch at all,
   (j) the refined demo on full-D pseudofermions, (k) the demo in f64
   working precision (no K6 launch), (l) Hasenbusch dm=0.4 on 2x2 shards
   (K7 launched, K8 not), 4 + 8 trajectories each, and (m) the refined
   demo of 4 + 4 trajectories, a checkpoint, and 4 more from it against
   the unbroken 4 + 8: equal bit for bit (before (m), the plain CG of (j)
   and (k), which replays one iteration as a CUDA graph, against its eager
   loop on a 16x16 f64 full-D solve of C=4: x and iterations bit for bit);
   then the physics tools at the
   goldens' small lattices: (n) tools/crossvalidate.compare_point at 8x8
   beta=2 m0=0.2 (Nt/2 = 4), packed refined, C=8, 50 + 100 x 2
   trajectories in a temporary working directory, held to n_ill == 0, a
   finite row and |n_sigma_Ep| <= 4 against the C++ golden (a gross-fault
   gate, not the physics gate), K1's and K3's paths printed; (o)
   tools/critical_mass at 16x16 beta=2 --m0-list=-0.10 --n-blocks 4 (K1,
   K3, and K6 and K9 in the correlators), held to a finite positive m_PCAC
   with every solve converged; (p) the main path in chain groups across
   processes (parallel/multihost.py): one refined trajectory of C=32 chains
   against its two halves, each on the noise of its global chains, and K1
   and K3 on the batch against its halves (bits equal, or the kernel whose
   bits move named), then the CLI at the demo config with --chains 32 --condensate,
   10 + 20 trajectories and a checkpoint, in one process and under torchrun
   in two processes with --ranks-chain 2 on this one card (gloo; two
   processes time-slicing one card, not multi-GPU), each on its device
   program (one capture, 29 replays): every chain's theta bit for bit, the
   printed averages equal, one SimData and one checkpoint each, the results printed by
   process 0 only, and each process's K1 and K3 launches on cuda:0 (its
   own stderr line), both runs' chain-traj/s printed; (q) the MRE path,
   tools/bench_points.py:51-52's point through the CLI in this process
   (64x64 beta=4 m0=0.2 md=40 tau=1 C=32, refined, 60 + 40 trajectories)
   with --mre-history 4 and with 0: every solve converged, K3 at 40
   launches a batch trajectory, K4's entry never, CG iterations per
   chain-trajectory, acceptance and chain-traj/s of both; (r) the lattice
   mesh across processes: the demo's CLI on 2x2 shards, 2 + 4 trajectories,
   in one process (every shard on the card) and under torchrun in 4
   processes of one shard each (parallel/mesh.DistLatticeMesh; on one card
   gloo through the host, not multi-GPU; one process a card with NCCL on a
   machine of 4 or more): every chain's theta and the printed results bit
   for bit, or theta within 2e-4 with the difference printed, one SimData
   and one checkpoint each, the banner, and each process's K7 and K8
   launches; (s) the bench tools (tools/bench_sharded_kernel.py,
   bench_kernels.py, bench_points.py, bench_scaling.py) through their
   module-level functions at a short length: K7 and K8 on the shard tool's
   32x32 block against their plain twins (1e-5 max|y|, 3e-5 max(scale, 1)),
   then each tool's rows (the shard tool's five; bench_kernels' seven at
   64x64; bench_points' run_packed at the 128x128 C=8 point under both
   contracts and at the 32x32 near-critical Hasenbusch point refined, 2 + 4
   trajectories; bench_scaling's measure on 1x1 and 2x2 at 64x64, 2 + 2),
   each finite and positive with every solve converged but on the
   near-critical row (flags and acceptance printed), K1, K3, K5, K6, K7 and
   K8 launched by the phase; (u), after the mesons, the measurement phase as
   a device program: the noise kernel's Z2 mode against its twin at 64x64
   C=32, 8 vectors (words and values exact, the counter on the card),
   timed with its twin and torch.randint in turns (and torch.randn's device
   time for the trajectory row); K6 and K9 with a mask against the unmasked
   kernels (bit for bit on the active entries, the others untouched) and
   their twins, and timed with no entry active; the refined and the loose
   measurement on (d)'s final configurations as a MeasurementProgram, 10
   replays against 10 eager calls bit for bit (values, flags, iterations,
   launch counts), timed in turns; the refined (in turns) and loose demos
   with --condensate on the graph, their measurement phase under
   torch.cuda.set_sync_debug_mode("error") but the block read, the final
   gathers and the captures, against graph=False bit for bit; and
   tools/critical_mass.run_point at 8x8 C=8 on its device programs against
   its eager run. Every run has the kernels' launch counters set
   to 0 just before it and read just after it, and fails if a kernel of its
   path was not launched; the packed refined runs must launch K3 once per
   solve and K4's own entry never (the fallback runs inside K3's launch; each
   run prints how many chain solves took it), (d) and the mesons launch K4's
   entry through the restart refinement. With --profile, three batch trajectories of the
   packed demo and of the packed loose (a), graphed and eager in turns
   (graph, eager, eager, graph), and of (f) and (g) then run under
   torch.profiler (launches, device-busy share, the top kernels by device
   time, and K1's, K2's and the noise kernel's device time), then one K6 launch (C=32, B=8) and
   one K5 launch at 64x64, whose shared kernels must appear by name, and a
   refined condensate measurement graphed and eager in turns (launches,
   busy share; the Z2 mode by name);
4. the kernels line (eleven entry points and the noise kernel's Z2 mode,
   z2_noise, a row of its own; K3's with ms_mre4, its time at K = 4 in
   turns with K = 1, and launches_mre_path, its launches in (q); the noise
   kernel's with its ties, torch.randn's device time and (t)'s
   device-program details; K6's and K9's with their masked times; the Z2
   row with (u)'s measurement and demo times),
   the card line, and the last line {"ok": true, "device": {...}}.

Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
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
    """Times by `timed` in the order plain, kernel, kernel, plain: the means
    of each; then the kernel's time with its launches queued behind a spin of
    the card (utils.metrics.device_ms), which leaves the host's launch cost
    out."""
    from schwingermodel_tpu_torch.utils.metrics import device_ms

    p1 = timed(plain, reps_plain)
    k1 = timed(kernel, reps_kernel)
    k2 = timed(kernel, reps_kernel)
    p2 = timed(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel, reps_kernel)


# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, f32 and f64 outside the tensor cores.
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 34e12
# f64 on the tensor cores (mma.m8n8k4.f64, the shape K10 uses): "FP64 Tensor
# Core 67 teraFLOPS" on the same data sheet.
PEAK_F64_TC = 67e12
# Flops per site of the even-odd stencil, counted from csrc/stencil.cuh: one
# hop to one target site is 7 complex products and 12 complex sums (66); a
# Dhat or Dhat^+ on one even site is two hops and the a*v + b*h (140); a
# CG iteration is a normal apply, two dots and three axpys on 4 reals (320).
F_HOP, F_DHAT, F_NORMAL, F_CG_ITER = 66, 140, 280, 320
F_FORCE = 2 * 60          # the force stencil at one even and one odd site
F_PLAQ = 2 * 30 + 2 * 8   # both plaquette angles and the staple differences
F_LINKS = 4 * 20          # sincos of the four angles of an even/odd site pair


def roofline(bytes_, f32_ops=0.0, f64_ops=0.0, f64_tc_ops=0.0):
    """(bound_ms, bound_by): the least time the card could take: the larger
    of the bytes over its memory rate and the operations over its peak. The
    tensor cores run beside the other units, so their time is not added to
    the others' but taken as a maximum with it."""
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = max(f32_ops / PEAK_F32 + f64_ops / PEAK_F64, f64_tc_ops / PEAK_F64_TC)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def halo_kernel_checks(dev, gen, card):
    """Phase 2 for K7 and K8: kernels against twins on the blocks of a mesh,
    the sharded solve and force against the unsharded kernels, times and
    bounds. Returns (errs, times, bounds)."""
    from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.ops import _cuda, eo, gauge, halo
    from schwingermodel_tpu_torch.ops import traj as tr
    from schwingermodel_tpu_torch.ops.eo_halo import W, extend
    from schwingermodel_tpu_torch.ops.geometry import ShardedGeometry
    from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard, unshard

    errs = {"halo_normal": 0.0, "halo_force": 0.0}
    times, bounds = {}, {}
    sms = _cuda.sm_count(dev)

    def setup(nx, nt, shape, C):
        mesh = lattice_mesh(shape)
        geom = ShardedGeometry(mesh)
        model = SchwingerModel(
            lattice=LatticeParams(Nx=nx, Nt=nt, real_dtype="float32"),
            hmc=HMCParams(beta=BETA, m0=M0, even_odd=True), geom=geom)
        theta = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev)
                 - 1.0) * math.pi
        Uf = model.field_fermion_links(shard(theta, mesh))
        return mesh, geom, theta, Uf, halo.EOOperatorsHaloFused(geom, Uf, M0)

    def close(a, b, label, rel=3e-5):
        torch.cuda.synchronize()
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= rel * max(scale, 1.0), f"{label}: err {err} scale {scale}")
        return err, scale

    for (nx, nt), shape, C in (((NX, NT), (2, 2), C_MAIN), ((NX, NT), (4, 1), C_MAIN),
                               ((NX, NT), (1, 4), C_MAIN), ((16, 16), (2, 2), 3),
                               ((128, 128), (2, 2), 2)):
        mesh, geom, theta, Uf, op = setup(nx, nt, shape, C)
        lead = (C, *shape)
        nxl, nthl = nx // shape[0], nt // shape[1] // 2
        label = f"{nx}x{nt} over {shape[0]}x{shape[1]} C={C}"
        v, r, psi = (torch.randn((*lead, 2, 2, nxl, nthl), generator=gen, device=dev)
                     for _ in range(3))
        v_ext, psi_ext = extend(geom, v), extend(geom, psi)
        planes = (op.ue_ext, op.uo_ext, op.off_ext)
        ext, n_ent = v_ext.shape[-2:], C * shape[0] * shape[1]
        paths = {k: halo.halo_path_name(*ext, n_ent, sms, b) for k, b in
                 (("K7", halo._NORMAL_BYTES), ("K8", halo._FORCE_BYTES))}
        out_k, dots_k = halo.halo_normal(*planes, v_ext, r, m0=M0, with_dots=True)
        out_2, dots_2 = halo.halo_normal(*planes, v_ext, r, m0=M0, with_dots=True)
        out_p, dots_p = halo.halo_normal_reference(*planes, v_ext, r, m0=M0,
                                                   with_dots=True)
        out_n = halo.halo_normal(*planes, v_ext, m0=M0)
        err, scale = close(out_k, out_p, f"K7 {label}")
        check(torch.equal(out_k, out_n), f"K7 {label}: out differs without the dots")
        # no atomics: the same launch twice gives the same bits
        check(torch.equal(out_k, out_2) and torch.equal(dots_k, dots_2),
              f"K7 {label}: two launches on the same inputs differ")
        # relative to the block's largest partial: <r,Ad> of a random r is a
        # cancelling sum
        drel = ((dots_k - dots_p).abs()
                / dots_p.abs().amax(dim=-1, keepdim=True)).max().item()
        check(drel <= 1e-5, f"K7 {label}: partials differ by {drel} relative")
        errs["halo_normal"] = max(errs["halo_normal"], err)
        print(f"phase 2: K7 {label} (path: {paths['K7']}): max |out - out_plain| = "
              f"{err:.3e} (scale {scale:.3f}, atol {3e-5 * max(scale, 1.0):.3e}); partials "
              f"max rel. difference {drel:.3e}; equal with and without the dots; two "
              f"launches equal bit for bit", flush=True)
        FE, FO = halo.halo_force(*planes, psi_ext, m0=M0, beta=BETA)
        RE, RO = halo.halo_force_reference(*planes, psi_ext, m0=M0, beta=BETA)
        err = max(close(FE, RE, f"K8 {label} even")[0],
                  close(FO, RO, f"K8 {label} odd")[0])
        errs["halo_force"] = max(errs["halo_force"], err)
        print(f"phase 2: K8 {label} (path: {paths['K8']}): max |F - F_plain| = {err:.3e} "
              f"(scale {RE.abs().max().item():.3f})", flush=True)
        if shape == (2, 2) and nx in (NX, 128):
            # the global-scratch kernels, which the rule keeps for blocks no
            # split holds, held against the twins where they fit as well
            k7g = halo._NormalLaunch(*planes, M0, route=(tr.CG_GLOBAL, 1))
            out_g, dots_g = k7g(v_ext, r)
            out_g2, dots_g2 = k7g(v_ext, r)
            err_g, _ = close(out_g, out_p, f"K7 global {label}")
            check(torch.equal(k7g(v_ext), out_g), f"K7 global {label}: out differs without "
                  "the dots")
            check(torch.equal(out_g, out_g2) and torch.equal(dots_g, dots_g2),
                  f"K7 global {label}: two launches on the same inputs differ")
            drel_g = ((dots_g - dots_p).abs()
                      / dots_p.abs().amax(dim=-1, keepdim=True)).max().item()
            check(drel_g <= 1e-5, f"K7 global {label}: partials differ by {drel_g} relative")
            k8g = halo._ForceLaunch(*planes, route=(tr.CG_GLOBAL, 1))
            GE, GO = k8g(psi_ext, M0, BETA)
            GE2, GO2 = k8g(psi_ext, M0, BETA)
            err8_g = max(close(GE, RE, f"K8 global {label} even")[0],
                         close(GO, RO, f"K8 global {label} odd")[0])
            check(torch.equal(GE, GE2) and torch.equal(GO, GO2),
                  f"K8 global {label}: two launches on the same inputs differ")
            errs["halo_normal"] = max(errs["halo_normal"], err_g)
            errs["halo_force"] = max(errs["halo_force"], err8_g)
            print(f"phase 2: K7 {label} (path: global, by route): max |out - out_plain| = "
                  f"{err_g:.3e}; partials max rel. difference {drel_g:.3e}; K8 (path: "
                  f"global, by route): max |F - F_plain| = {err8_g:.3e}; each equal with and "
                  f"without the dots, two launches equal bit for bit", flush=True)
        if (nx, nt) == (128, 128):
            continue

        # the sharded K7 solve against the unsharded K2, same theta and b
        thE, thO = tr.pack_planes(theta)
        b = torch.randn((C, 2, 2, nx, nt // 2), generator=gen, device=dev)
        tol = 1e-6
        sh = halo.cg_solve_sharded_fused(
            geom, Uf, M0, shard(tr.to_complex(b), mesh), tol=tol, max_iter=10000)
        k2 = tr.solve_fused(thE, thO, b, b, m0=M0, tol=tol, max_iter=10000)
        x_sh = tr.to_planar(unshard(sh.x, mesh))
        ue, uo = gauge.links(thE, thO, torch.complex128)
        bc = tr.to_complex(b).to(torch.complex128)

        def true_res(x):
            rr = bc - eo.normal(ue, uo, tr.to_complex(x).to(torch.complex128), M0)
            return ((rr.abs() ** 2).sum(dim=(1, 2, 3)).sqrt()
                    / (bc.abs() ** 2).sum(dim=(1, 2, 3)).sqrt()).max().item()

        r_sh, r_k2 = true_res(x_sh), true_res(k2.x)
        dx = (x_sh - k2.x).abs().max().item()
        check(bool(sh.converged.all()) and bool(k2.converged.all()),
              f"sharded CG {label}: flags")
        check(r_sh < 2 * tol and r_k2 < 2 * tol and dx <= 2e-4,
              f"sharded CG {label}: residual {r_sh} vs {r_k2}, |dx| {dx}")
        print(f"phase 2: sharded K7 CG vs unsharded K2 {label} tol={tol:g}: f64 true "
              f"residual {r_sh:.3e} vs {r_k2:.3e}; max |x - x_K2| {dx:.3e}; iterations "
              f"sharded {sh.iters.flatten()[:8].tolist()} K2 {k2.iters[:8].tolist()}",
              flush=True)

        # K8's force, unsharded again, against K1's
        psi_g = torch.randn((C, 2, 2, nx, nt // 2), generator=gen, device=dev)
        F8 = unshard(halo.force_halo_fused(
            geom, Uf, M0, shard(tr.to_complex(psi_g), mesh), BETA), mesh)
        k1 = tr.force_step(thE, thO, psi_g, psi_g, m0=M0, beta=BETA, tol=tol,
                           max_iter=10, with_solve=False, with_gauge=True)
        err, scale = close(F8, eo.unpack(k1.FE, k1.FO), f"K8 vs K1 {label}")
        print(f"phase 2: K8 (sharded, unsharded again) vs K1 {label}: max |F8 - F1| = "
              f"{err:.3e} (scale {scale:.3f})", flush=True)

    # times and bounds at the demo mesh block
    mesh, geom, theta, Uf, op = setup(NX, NT, (2, 2), C_MAIN)
    n_blk, nxl, nthl = C_MAIN * 4, NX // 2, NT // 4
    v, r, psi = (torch.randn((C_MAIN, 2, 2, 2, 2, nxl, nthl), generator=gen, device=dev)
                 for _ in range(3))
    v_ext, psi_ext = extend(geom, v), extend(geom, psi)
    planes = (op.ue_ext, op.uo_ext, op.off_ext)
    V_ext, V_loc = v_ext.shape[-2] * v_ext.shape[-1], nxl * nthl
    ext_bytes = 4 * (12 * V_ext) + 4 * (nxl + 2 * W)      # links, spinor, offsets
    # as the main path issues them: the sharded CG's apply on its operator
    # (constant planes checked once), and the force's call
    times["halo_normal"] = in_turns(
        lambda: halo.halo_normal_reference(*planes, v_ext, r, m0=M0, with_dots=True),
        lambda: op.normal_ext(v_ext, r), 20, 200)
    bounds["halo_normal"] = roofline(
        n_blk * (ext_bytes + 4 * (8 * V_loc + 4)),          # + r in, out and dots
        n_blk * ((3 * F_HOP + 8) * V_ext + (F_HOP + 8 + 32) * V_loc))
    times["halo_force"] = in_turns(
        lambda: halo.halo_force_reference(*planes, psi_ext, m0=M0, beta=BETA),
        lambda: op.force_planes(psi_ext, BETA), 20, 200)
    bounds["halo_force"] = roofline(
        n_blk * (ext_bytes + 4 * 4 * V_loc),
        n_blk * ((3 * F_HOP + 8 + 60) * V_ext + (F_FORCE + 16) * V_loc))
    t_nodots = timed(lambda: op.normal_ext(v_ext), 200)
    # the public wrappers check every plane and work out the path at each call
    t_public = {"halo_normal": timed(lambda: halo.halo_normal(
        *planes, v_ext, r, m0=M0, with_dots=True), 200), "halo_force": timed(
        lambda: halo.halo_force(*planes, psi_ext, m0=M0, beta=BETA), 200)}
    detail = {k: {"path": halo.halo_path_name(*v_ext.shape[-2:], n_blk, sms, b),
                  "blocks_a_shard": halo.halo_path(*v_ext.shape[-2:], n_blk, sms, b)[1],
                  "ms_public_wrapper": t_public[k]}
              for k, b in (("halo_normal", halo._NORMAL_BYTES),
                           ("halo_force", halo._FORCE_BYTES))}
    detail["halo_normal"]["ms_without_dots"] = t_nodots
    t_ext = timed(lambda: extend(geom, v), 200)
    # one sharded solve: 4 ppermutes, one K7 launch, one psum and one host
    # read per iteration
    b_s = shard(tr.to_complex(torch.randn((C_MAIN, 2, 2, NX, NT // 2), generator=gen,
                                          device=dev)), mesh)

    def solve():
        return halo.cg_solve_sharded_fused(geom, Uf, M0, b_s, tol=1e-6, max_iter=10000)

    before = halo.halo_normal.launches
    solve()
    n_k7 = halo.halo_normal.launches - before
    print(f"phase 2: one sharded K7 solve at {NX}x{NT} over 2x2 C={C_MAIN}, tol 1e-6 from "
          f"x0 = b: {timed(solve, 10):.3f} ms with {n_k7} K7 launches; card {card}",
          flush=True)
    for k in times:
        print(f"phase 2: time at {NX}x{NT} over 2x2 C={C_MAIN} ({n_blk} shards, path "
              f"{detail[k]['path']}; {card}): {k} kernel {times[k][0]:.4f} ms "
              f"({times[k][2]:.4f} ms queued behind a spin; through the public wrapper "
              f"{t_public[k]:.4f} ms), plain twin {times[k][1]:.4f} ms, bound "
              f"{bounds[k][0]:.5f} ms by {bounds[k][1]}", flush=True)
    print(f"phase 2: time at the same shape: halo_normal without the dots "
          f"{t_nodots:.4f} ms; eo_halo.extend of one spinor (4 ppermutes as rolls, 2 "
          f"cats) {t_ext:.4f} ms", flush=True)
    return errs, times, bounds, detail


MP_FLAGS = ["--device", "cuda", "--nx", str(NX), "--nt", str(NT), "--beta", str(BETA),
            "--m0", str(M0), "--md-steps", "10", "--tau", "0.1", "--ntherm", "10",
            "--nmeas", "20", "--nsteps", "0", "--ranks-x", "1", "--ranks-t", "1",
            "--chains", str(C_MAIN), "--seed", "0"]
MP_RESULTS = ("Average plaquette", "Average gauge action", "Acceptance rate",
              "<exp(-dH)>")


def chain_groups(hp, rs, tr, sms, card, lattice, hmc, dev):
    """Phase 3 (p): the chain-parallel main path (parallel/multihost.py).

    In this process: one refined trajectory of C_MAIN chains against the
    same trajectory of its two halves, each half on the noise of its global
    chains (hmc_trajectory_packed's chain_offset), and K1 and K3 on the
    batch against its halves, bit for bit where the bits agree and named
    where they do not. Then the CLI twice from this checkout, at the demo
    config with C_MAIN chains, 10 + 20 trajectories and a checkpoint each:
    in one process, and under torchrun in nproc processes with
    --ranks-chain nproc, process i on cuda:{i % cards}: with one card two
    processes (gloo between them) time-slice it, which is not multi-GPU;
    with several cards, one process a card (NCCL). Held: every chain's theta bit
    for bit (else within 2e-4, with the kernel whose bits move named), the
    printed averages equal (where theta is), one SimData and one checkpoint
    each, the results printed by process 0 only, the banner's layout, and
    each process's K1 and K3 launches on its card. Returns the processes'
    launches summed."""
    import ast
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.runner import hot_start

    cards = torch.cuda.device_count()
    nproc = cards if cards > 1 else 2
    model = SchwingerModel(lattice=lattice, hmc=hmc)
    theta = hot_start(lattice, 0, C_MAIN, dev)
    h = C_MAIN // 2
    halves = (slice(0, h), slice(h, C_MAIN))
    whole, st = hp.hmc_trajectory_packed(model, theta, 0, 0)
    parts = [hp.hmc_trajectory_packed(model, theta[s].contiguous(), 0, 0,
                                      chain_offset=s.start) for s in halves]
    split_bits = (torch.equal(whole, torch.cat([t for t, _ in parts]))
                  and torch.equal(st.delta_H, torch.cat([p.delta_H for _, p in parts])))
    # the kernels of the path on the batch and on its halves
    thE, thO = tr.pack_planes(theta)
    b = torch.randn((C_MAIN, 2, 2, NX, NT // 2), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    k1 = lambda s: tr.force_step(thE[s], thO[s], b[s], b[s], m0=M0, beta=BETA, tol=1e-8,
                                 max_iter=10000, with_solve=False, with_gauge=True)
    k3 = lambda s: rs.solve_refined(thE[s], thO[s], b[s], b[s], m0=M0, tol=1e-10,
                                    certify=True, fallback=True)
    moved = []
    for kname, fn, fields in (("K1 force_step", k1, ("FE", "FO")),
                              ("K3 solve_refined", k3, ("x64", "iters"))):
        full = fn(slice(None))
        cut = [fn(s) for s in halves]
        for f in fields:
            if not torch.equal(getattr(full, f),
                               torch.cat([getattr(c, f) for c in cut])):
                moved.append(f"{kname}.{f}")
    paths = (f"K1 path {tr.cg_path_name(NX, NT // 2, C_MAIN, sms, False, True)} at "
             f"C={C_MAIN}, {tr.cg_path_name(NX, NT // 2, h, sms, False, True)} at C={h}; "
             f"K3 path {rs.ru_path_name(NX, NT // 2, C_MAIN, sms)} at C={C_MAIN}, "
             f"{rs.ru_path_name(NX, NT // 2, h, sms)} at C={h}")
    print(f"phase 3: (p) one refined trajectory of {C_MAIN} chains against its two "
          f"halves: theta' and dH bit for bit {split_bits}; kernels whose bits move "
          f"between the batch and its halves: {moved or 'none'} ({paths})", flush=True)

    repo = Path(__file__).resolve().parent
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, n in (("1 process", 1), ("processes", nproc)):
            out_dir = Path(tmp) / f"p{n}"
            out_dir.mkdir()
            # with the condensate: each process draws its chains' Z2 noise
            # at their global indices on its measurement program
            argv = [*MP_FLAGS, "--condensate", "--n-noise", "8", "--out-dir",
                    str(out_dir), "--checkpoint", str(out_dir / "ck.npz")]
            if n > 1:
                cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", str(n), "-m", "schwingermodel_tpu_torch",
                       *argv, "--ranks-chain", str(n)]
            else:
                cmd = [sys.executable, "-m", "schwingermodel_tpu_torch", *argv]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                                  timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"(p) {label}: exit {proc.returncode}\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
            rate = re.search(r"perf: hmc\.measure: \S+ s \([^)]*\)\s+(\S+) traj/s", proc.stdout)
            check(rate is not None, f"(p) {label}: no measure-phase rate")
            outs[label] = {
                "stdout": proc.stdout, "stderr": proc.stderr, "wall": wall,
                "rate": float(rate.group(1)),
                "theta": np.load(out_dir / "ck.npz")["theta"],
                "condensate": np.load(out_dir / "ck.npz")["chain_chiral_condensate"],
                "simdata": len(list(out_dir.glob("*SimData*"))),
                "checkpoints": len(list(out_dir.glob("*.npz"))),
                "results": [ln for ln in proc.stdout.splitlines()
                            if ln.startswith((*MP_RESULTS, "Chiral condensate"))]}
    one, two = outs["1 process"], outs["processes"]
    layout = (f"{nproc} processes on {cards} device{'s' if cards > 1 else ''} "
              f"({'nccl' if cards > 1 else 'gloo'})")
    what = "multi-GPU" if cards > 1 else "not multi-GPU"
    for label, o in outs.items():
        check(o["simdata"] == 1 and o["checkpoints"] == 1,
              f"(p) {label}: {o['simdata']} SimData and {o['checkpoints']} checkpoints")
        check(o["stdout"].count("Average plaquette value") == 1,
              f"(p) {label}: the plaquette line printed "
              f"{o['stdout'].count('Average plaquette value')} times")
        check("all solves converged: True" in o["stdout"], f"(p) {label}: a solve failed")
        check(o["theta"].shape == (C_MAIN, 2, NX, NT)
              and np.isfinite(o["theta"]).all(), f"(p) {label}: final configuration")
    check(f"* Chain groups = {layout}" in two["stdout"],
          f"(p) the banner does not read {layout}")
    per_proc = {}
    for m in re.finditer(rf"process (\d+) of {nproc} on (\S+): kernel launches (\{{.*?\}})",
                         two["stderr"]):
        per_proc[int(m.group(1))] = (m.group(2), ast.literal_eval(m.group(3)))
    check(sorted(per_proc) == list(range(nproc)), f"(p) per-process lines: {per_proc}")
    for rank, (where, got) in sorted(per_proc.items()):
        check(where == f"cuda:{rank % cards}" and got["force_step"] > 0
              and got["solve_refined"] > 0 and got["z2_noise"] > 0
              and got["solve_f64_cg_fallback"] == 20,
              f"(p) process {rank} on {where}: launches {got}")
        print(f"phase 3: (p) process {rank} of {nproc} on {where}: launches {got}",
              flush=True)
    # both runs on the device programs: one capture, 29 trajectory and 19
    # measurement replays a process
    for label, o in outs.items():
        check(re.search(r"perf: graph: 1 capture\(s\), 29 replays", o["stdout"])
              and re.search(r"perf: measurement graph: 1 capture\(s\), 19 replays",
                            o["stdout"]),
              f"(p) {label}: no graph lines of one capture and 29 and 19 replays")
    bits = (np.array_equal(one["theta"], two["theta"])
            and np.array_equal(one["condensate"], two["condensate"]))
    d = np.remainder(one["theta"] - two["theta"] + np.pi, 2 * np.pi) - np.pi
    dmax = float(np.abs(d).max())
    check(bits and one["results"] == two["results"] and len(one["results"]) == 5,
          f"(p) theta differs by {dmax:.3e} (kernels whose bits move: "
          f"{moved or 'none'}), or the printed averages: {one['results']} against "
          f"{two['results']}")
    print(f"phase 3: (p) the CLI at {NX}x{NT} C={C_MAIN} with --condensate --n-noise 8, "
          f"10 + 20 trajectories, one process against {nproc} (--ranks-chain {nproc}, "
          f"torchrun), each on its device programs (a trajectory and a measurement "
          f"graph a process): every chain's theta and condensate bit for bit {bits} "
          f"(max |dtheta| {dmax:.3e}), printed averages "
          f"{'equal' if one['results'] == two['results'] else 'differ'}: "
          f"{two['results']}; one SimData and one checkpoint each, the results "
          f"printed by process 0 only", flush=True)
    for label, o in (("1 process", one), (f"{layout}, {what}", two)):
        print(f"phase 3: (p) {label}: measure phase {o['rate']:.2f} chain-traj/s, "
              f"{o['wall']:.1f} s wall (process start-up included); card {card}",
              flush=True)
    total = dict.fromkeys(per_proc[0][1], 0)
    for _, got in per_proc.values():
        for k, n in got.items():
            total[k] += n
    return {"launches": total, "bits": bits, "rates": {k: o["rate"] for k, o in outs.items()}}


def mre_kernel_checks(rs, hp, model_of, dev, gen, card, sms, inputs, rel_residual):
    """Phase 2: K3's MRE branch (a history of K = 4 earlier solutions, the
    forecast a prologue of K3's own launch) against its plain twin on every
    path K3 takes: 32x32 C=32 (all shared), 64x64 C=32 (shared), 128x128
    C=2 (a cluster of blocks) and 126x128 C=2 (the global scratch), on two
    histories: tests_tpu/test_tpu_resident.py's (the certified solution, a
    copy scaled by 1.001, b and zeros) and the last four force solutions of
    a refined MRE trajectory (md=40, tau=1) with the inputs of its action
    solve. Held: the forecast alone (max_iter=0 returns it) to 1e-4 of
    ||x0|| against mre_forecast_reference; the solve from it at 1e-10 under
    1e-10 ||b|| on the f64 oracle with the twin's flags; chains 0 and 1
    alone equal to their chains of the batch bit for bit. Iterations beside
    K = 1's (from hist[0]; for the first history also from b). Returns
    K3's ms at 64x64 C=32 on the trajectory's history at K = 4 and at
    K = 1, timed in turns (K = 1, 4, 4, 1)."""
    turns = None
    for nx, nt, C in ((32, 32, C_MAIN), (NX, NT, C_MAIN), (128, 128, 2), (126, 128, 2)):
        path = rs.ru_path_name(nx, nt // 2, C, sms)
        thE, thO, b = inputs(C, nx, nt)
        exact = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10)
        tpu_hist = torch.stack([exact.x, 1.001 * exact.x, b, torch.zeros_like(b)])
        # a refined MRE trajectory's solves, recorded; its last is the
        # action solve over the history of the last four force solutions
        model = model_of(nx, nt)
        calls = []
        solve = rs.solve_refined

        def recorded(thE_, thO_, b_, x0_, **kw):
            calls.append((thE_, thO_, b_, x0_))
            return solve(thE_, thO_, b_, x0_, **kw)
        # the wrapper counts its launches under the module's name
        recorded.launches = 0
        theta = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev)
                 - 1.0) * math.pi
        pi, chi, r = hp.draw_chain_noise(model, 5, 0, C, dev)
        rs.solve_refined = recorded
        try:
            hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
        finally:
            rs.solve_refined = solve
        check(len(calls) == 40 and calls[-1][3].shape[0] == 4,
              f"MRE trajectory at {nx}x{nt}: {len(calls)} solves")
        tE, tO, tb, traj_hist = calls[-1]
        for label, (E, O, bb, hist) in (("TPU test's history", (thE, thO, b, tpu_hist)),
                                        ("a trajectory's history", (tE, tO, tb, traj_hist))):
            kw = dict(m0=M0, tol=1e-10)
            x0k = rs.solve_refined(E, O, bb, hist, max_iter=0, **kw).x
            x0p = rs.mre_forecast_reference(E, O, bb, hist, m0=M0)
            dx0 = ((x0k - x0p).flatten(1).norm(dim=1)
                   / x0p.flatten(1).norm(dim=1)).max().item()
            check(dx0 <= 1e-4, f"K3 MRE {label} at {nx}x{nt}: forecast differs by "
                  f"{dx0} of ||x0||")
            k = rs.solve_refined(E, O, bb, hist, **kw)
            p = rs.solve_refined_reference(E, O, bb, hist, **kw)
            one = rs.solve_refined(E, O, bb, hist[0], **kw)
            rk = rel_residual(E, O, bb, k.x64)
            rp = rel_residual(E, O, bb, p.x64)
            check(bool((rk < 1e-10).all()) and bool((rp < 1e-10).all()),
                  f"K3 MRE {label} at {nx}x{nt}: residual kernel {rk.max().item()} "
                  f"plain {rp.max().item()}")
            check(torch.equal(k.converged, p.converged) and bool(k.converged.all()),
                  f"K3 MRE {label} at {nx}x{nt}: flags {k.converged.tolist()} plain "
                  f"{p.converged.tolist()}")
            for i in range(2):
                alone = rs.solve_refined(E[i:i + 1], O[i:i + 1], bb[i:i + 1],
                                         hist[:, i:i + 1].contiguous(), **kw)
                check(torch.equal(alone.x64[0], k.x64[i])
                      and int(alone.iters[0]) == int(k.iters[i]),
                      f"K3 MRE {label} at {nx}x{nt}: chain {i} alone differs")
            extra = ""
            if label.startswith("TPU"):
                extra = f", from b {exact.iters[:4].tolist()}"
            print(f"phase 2: K3 MRE K=4, {label}, {nx}x{nt} C={C} (path: {path}): "
                  f"forecast max |x0 - x0_plain| / |x0| {dx0:.3e}; residual kernel "
                  f"{rk.max().item():.3e} plain {rp.max().item():.3e}, flags equal; "
                  f"iterations K=4 kernel {k.iters[:4].tolist()} plain "
                  f"{p.iters[:4].tolist()}, K=1 from hist[0] {one.iters[:4].tolist()}"
                  f"{extra} (summed over the chains: K=4 {k.iters.sum().item()}, K=1 "
                  f"{one.iters.sum().item()}); chains 0, 1 alone equal their chains of "
                  f"the batch bit for bit", flush=True)
        if (nx, nt) == (NX, NT):
            h0 = traj_hist[0].contiguous()
            k1 = lambda: rs.solve_refined(tE, tO, tb, h0, m0=M0, tol=1e-10)
            k4 = lambda: rs.solve_refined(tE, tO, tb, traj_hist, m0=M0, tol=1e-10)
            a1, a4, b4, b1 = (timed(f, 20) for f in (k1, k4, k4, k1))
            turns = ((a4 + b4) / 2, (a1 + b1) / 2)
            print(f"phase 2: K3 at {nx}x{nt} C={C} on the trajectory's action solve, in "
                  f"turns ({card}): K=4 {turns[0]:.4f} ms, K=1 from hist[0] "
                  f"{turns[1]:.4f} ms; iterations K=4 {k4().iters.sum().item()}, K=1 "
                  f"{k1().iters.sum().item()} summed over the chains", flush=True)
    return turns


Q_FLAGS = ["--device", "cuda", "--nx", str(NX), "--nt", str(NT), "--beta", str(BETA),
           "--m0", str(M0), "--md-steps", "40", "--tau", "1", "--ntherm", "60",
           "--nmeas", "40", "--nsteps", "0", "--ranks-x", "1", "--ranks-t", "1",
           "--chains", str(C_MAIN), "--seed", "0", "--no-simdata"]


def mre_path(cli, counted, card):
    """Phase 3 (q): tools/bench_points.py:51-52's point through the CLI in
    this process, 64x64 beta=4 m0=0.2 md=40 tau=1 C=32 refined, 60 + 40
    trajectories from a hot start (the JAX tool's --n-therm 60 and 40
    timed), with --mre-history 4 and with 0: exit 0, every
    solve converged, K3 at 40 launches a batch trajectory (39 force solves
    and the action solve) with the fallback inside, K4's own entry never.
    Returns {K: (measure-phase chain-traj/s, CG iterations per
    chain-trajectory, acceptance, K3 launches)}."""
    import contextlib
    import io

    out = {}
    n_traj = 100
    for K in (4, 0):
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
            rc, wall, got = counted(
                f"(q) --mre-history {K}", ("with_solve=False,with_gauge=True",
                                           "solve_refined"),
                lambda: cli.main([*Q_FLAGS, "--mre-history", str(K), "--out-dir", tmp]),
                ("solve_f64_cg_fallback",))
        text = buf.getvalue()
        print("\n".join(ln for ln in text.splitlines() if ln.startswith("phase 3")),
              flush=True)
        check(rc == 0 and "all solves converged: True" in text,
              f"(q) --mre-history {K}: exit {rc}\n{text[-3000:]}")
        check(got["solve_refined"] == 40 * n_traj,
              f"(q) --mre-history {K}: {got['solve_refined']} K3 launches")
        rate = re.search(r"perf: hmc\.measure: \S+ s \([^)]*\)\s+(\S+) traj/s\s+(\S+) CG iters/traj", text)
        acc = re.search(r"Acceptance rate: (\S+)", text)
        em = re.search(r"<exp\(-dH\)> = (\S+),", text)
        check(rate and acc and em, f"(q) --mre-history {K}: no result lines")
        acc, em = float(acc.group(1)), float(em.group(1))
        check(0.3 < acc <= 1.0 and abs(em - 1.0) < 0.1,
              f"(q) --mre-history {K}: acceptance {acc}, <exp(-dH)> {em}")
        out[K] = (float(rate.group(1)), float(rate.group(2)), acc, got["solve_refined"])
        print(f"phase 3: (q) 64x64 beta=4 m0=0.2 md=40 tau=1 C={C_MAIN} refined "
              f"--mre-history {K}, 60 + 40 trajectories in {wall:.2f} s: measure phase "
              f"{out[K][0]:.2f} chain-traj/s, {out[K][1]:.1f} CG iterations per "
              f"chain-trajectory, acceptance {acc:.4f}, <exp(-dH)> {em:.6f}; per batch "
              f"trajectory {got['solve_refined'] / n_traj:g} K3, "
              f"{got['force_step'] / n_traj:g} K1 and {got['solve_f64_cg_fallback']} K4 "
              f"launches; card {card}", flush=True)
    return out


def bench_tools(counted, card, dev):
    """Phase 3 (s): the four bench tools' module-level functions on the
    card at a short length. K7 and K8 on the shard tool's 32x32 block
    against their plain twins (K7 within 1e-5 max|y| of halo_normal_reference
    and of the plain hops, K8 within 3e-5 max(scale, 1) of the plain force);
    then each tool's rows under the launch counters: bench_sharded_kernel
    (the interpret-mode windows; K7, K8), bench_kernels at 64x64 (its CPU
    windows: 10 thermalization trajectories, 20/120 applies, 2/12 solves,
    1/3 trajectories; K6), bench_points' run_packed at the 128x128 C=8 point
    under both contracts (K1 with its CG and K2; K1 and K3) and at the
    32x32 near-critical Hasenbusch point, refined (K1, K3, K5), 2 + 4
    trajectories each, and bench_scaling's measure on 1x1 (K6) and 2x2 (K7,
    K8) at 64x64, 2 + 2. Every row finite and positive, every solve
    converged but on the near-critical row, whose flags and acceptance are
    printed, not gated. Returns the launches of the counted runs."""
    from schwingermodel_tpu_torch.ops import halo
    from schwingermodel_tpu_torch.ops.traj import to_complex, to_planar
    from schwingermodel_tpu_torch.parallel.mesh import shard
    from schwingermodel_tpu_torch.tools import bench_kernels as bk
    from schwingermodel_tpu_torch.tools import bench_points as bp
    from schwingermodel_tpu_torch.tools import bench_scaling as bsc
    from schwingermodel_tpu_torch.tools import bench_sharded_kernel as bsk

    totals = {}

    def rows_ok(label, rows):
        for r in rows:
            check(math.isfinite(r["value"]) and r["value"] > 0, f"(s) {label}: {r}")
        print(f"phase 3: (s) {label}: " + "; ".join(
            f"{r['metric']} {r.get('contract', '')} {r['value']} {r['unit']}".replace("  ", " ")
            for r in rows) + f"; card {card}", flush=True)

    def add(got):
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n

    # K7 and K8 against their twins on the shard tool's own block
    theta, v, _, psi = bsk.draw_inputs(32, 16, 1)
    model, inner = bsk.block_model(32, 32, M0)
    blk = bsk.block_links(model, inner, torch.from_numpy(theta).to(dev))
    vt = torch.from_numpy(v).to(dev)[None]
    vp = to_planar(vt).contiguous()
    y = bsk.local_apply_fused(inner, blk, vp, M0)
    y_twin = halo.halo_normal_reference(blk.ue_ext, blk.uo_ext, blk.off_ext,
                                        bsk.self_extend(inner, vp), m0=M0)
    y_plain = bsk.local_apply_plain(inner, blk, vt, M0)
    scale = y_twin.abs().max().item()
    e7 = max((y - y_twin).abs().max().item(),
             (to_complex(y) - y_plain).abs().max().item())
    check(e7 <= 1e-5 * scale, f"(s) K7 on the 32x32 block: {e7:.3e} of {scale:.3e}")
    th_s = shard(torch.from_numpy(theta).to(dev)[None], inner.geom.mesh)
    psi_s = shard(torch.from_numpy(psi).to(dev)[None], inner.geom.mesh)
    F = bsk.force_fused(inner, th_s, psi_s, M0)
    F_plain = bsk.force_plain(inner, th_s, psi_s, M0)
    fscale = max(F_plain.abs().max().item(), 1.0)
    e8 = (F - F_plain).abs().max().item()
    check(e8 <= 3e-5 * fscale, f"(s) K8 on the 32x32 block: {e8:.3e} of {fscale:.3e}")
    print(f"phase 3: (s) bench_sharded_kernel 32x32 block: K7 max |y - y_twin| and "
          f"|y - y_plain hops| {e7:.3e} (max|y| {scale:.3e}), K8 max |F - F_plain| "
          f"{e8:.3e} (scale {fscale:.3e})", flush=True)

    rows, wall, got = counted(
        "(s) bench_sharded_kernel.measure 32x32", ("halo_normal", "halo_force"),
        lambda: bsk.measure(32, 32, M0, dev, bsk.WINDOWS["cpu"], reps=3))
    rows_ok(f"bench_sharded_kernel ({wall:.2f} s)", rows)
    add(got)

    rows, wall, got = counted(
        "(s) bench_kernels.measure 64x64", ("cg_solve_eo",),
        lambda: bk.measure(64, 64, BETA, M0, "float32", dev, bk.WINDOWS["cpu"], reps=3))
    rows_ok(f"bench_kernels ({wall:.2f} s)", rows)
    check("converged=True" in rows[5]["unit"], f"(s) bench_kernels: {rows[5]}")
    add(got)

    points = {p[0]: p for p in bp.POINTS}
    for name, contracts, uses in (
            ("128x128_b4_tau0.1", bp.contracts({}, 10000),
             ("with_solve=True,with_gauge=True", "solve_fused",
              "with_solve=False,with_gauge=True", "solve_refined")),
            ("32x32_b2_m-0.19_tau1_hb", bp.contracts({"refined_only": True}, 20000),
             ("with_solve=False,with_gauge=False", "ratio_force", "solve_refined"))):
        point = points[name]
        C, m0 = point[7], point[4]

        def drive(point=point, contracts=contracts, C=C, m0=m0):
            return [bp.make_row(point, label, bp.run_packed(
                bp.point_model(point, cg), C, 2, 4, anneal=bp.anneal_schedule(m0),
                device=dev), dev, card) for label, cg in contracts]

        rows, wall, got = counted(f"(s) bench_points.run_packed {name}, 2 + 4", uses,
                                  drive, ("solve_f64_cg_fallback",))
        rows_ok(f"bench_points ({wall:.2f} s)", rows)
        for r in rows:
            if m0 < 0:
                print(f"phase 3: (s) near-critical {name} {r['contract']}: "
                      f"all_converged {r['all_converged']}, acceptance "
                      f"{r['acceptance']} (recorded, not gated)", flush=True)
            else:
                check(r["all_converged"], f"(s) {name}: a solve did not converge: {r}")
        add(got)

    sargs = bsc.build_parser().parse_args(["--device", "cuda"])
    smodel = bsc.make_model(sargs)
    for mesh_shape, uses in (((1, 1), ("cg_solve_eo",)),
                             ((2, 2), ("halo_normal", "halo_force"))):
        (tps, iters), wall, got = counted(
            f"(s) bench_scaling.measure {mesh_shape[0]}x{mesh_shape[1]}, 2 + 2", uses,
            lambda mesh_shape=mesh_shape: bsc.measure(smodel, mesh_shape, 2, 2, dev))
        check(math.isfinite(tps) and tps > 0 and iters > 0,
              f"(s) bench_scaling {mesh_shape}: {tps} traj/s, {iters} iterations")
        print(f"phase 3: (s) bench_scaling {mesh_shape[0]}x{mesh_shape[1]} at "
              f"{NX}x{NT} in {wall:.2f} s: {tps:.3f} traj/s, {iters} CG iterations "
              f"(timed pass; all shards on one device); card {card}", flush=True)
        add(got)
    return totals


R_FLAGS = ["--device", "cuda", "--nx", str(NX), "--nt", str(NT), "--beta", str(BETA),
           "--m0", str(M0), "--md-steps", "10", "--tau", "0.1", "--ntherm", "2",
           "--nmeas", "4", "--nsteps", "0", "--ranks-x", "2", "--ranks-t", "2",
           "--chains", str(C_MAIN), "--seed", "0"]


def dist_mesh(card):
    """Phase 3 (r): the demo's CLI on a 2x2 lattice mesh, 2 + 4
    trajectories, in one process (every shard on the card) against 4
    processes of one shard each under torchrun (parallel/mesh.DistLatticeMesh):
    on one card the 4 processes time-slice it and gloo moves the halos and
    the psums through the host, which is not multi-GPU; on a machine of 4
    or more cards one process a card with NCCL. Held: exit 0, every solve
    converged, one SimData and one checkpoint each, the banner, each
    process's K7 and K8 launches; every chain's theta and the printed
    results bit for bit, or else theta within the f32 gate 2e-4 with the
    difference reported. Returns the processes' launches summed."""
    import ast

    cards = torch.cuda.device_count()
    repo = Path(__file__).resolve().parent
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, n in (("1 process", 1), ("4 processes", 4)):
            out_dir = Path(tmp) / f"r{n}"
            out_dir.mkdir()
            argv = [*R_FLAGS, "--out-dir", str(out_dir), "--checkpoint",
                    str(out_dir / "ck.npz")]
            cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(n), "-m", "schwingermodel_tpu_torch", *argv]
                   if n > 1 else [sys.executable, "-m", "schwingermodel_tpu_torch", *argv])
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                                  timeout=900)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"(r) {label}: exit {proc.returncode}\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
            check("all solves converged: True" in proc.stdout, f"(r) {label}: a solve failed")
            rate = re.search(r"perf: hmc\.measure: \S+ s \([^)]*\)\s+(\S+) traj/s\s+(\S+) CG", proc.stdout)
            check(rate is not None, f"(r) {label}: no measure-phase rate")
            outs[label] = {
                "stdout": proc.stdout, "stderr": proc.stderr, "wall": wall,
                "rate": float(rate.group(1)), "iters": float(rate.group(2)),
                "theta": np.load(out_dir / "ck.npz")["theta"],
                "files": (len(list(out_dir.glob("*SimData*"))),
                          len(list(out_dir.glob("*.npz")))),
                "results": [ln for ln in proc.stdout.splitlines()
                            if ln.startswith(MP_RESULTS)]}
    one, four = outs["1 process"], outs["4 processes"]
    nccl, m = cards >= 4, min(cards, 4)
    layout = (f"4 processes on {m} device{'s' if m > 1 else ''} "
              f"({'nccl' if nccl else 'gloo'})")
    what = "multi-GPU" if nccl else "not multi-GPU"
    for label, o in outs.items():
        check(o["files"] == (1, 1), f"(r) {label}: SimData and checkpoints {o['files']}")
        check(o["theta"].shape == (C_MAIN, 2, NX, NT) and np.isfinite(o["theta"]).all(),
              f"(r) {label}: final configuration")
    banner = f"* Device mesh = 2x2 shards, one a process: {layout}"
    check(banner in four["stdout"], f"(r) the banner does not read {banner}")
    per_proc = {}
    for m in re.finditer(r"process (\d+) of 4 on (\S+): kernel launches (\{.*?\})",
                         four["stderr"]):
        per_proc[int(m.group(1))] = (m.group(2), ast.literal_eval(m.group(3)))
    check(sorted(per_proc) == [0, 1, 2, 3], f"(r) per-process lines: {per_proc}")
    for rank, (where, got) in sorted(per_proc.items()):
        check(got["halo_normal"] > 0 and got["halo_force"] > 0
              and got["solve_refined"] == 0 and got["force_step"] == 0,
              f"(r) process {rank} on {where}: launches {got}")
        print(f"phase 3: (r) process {rank} of 4 on {where}: per batch trajectory "
              f"{got['halo_normal'] / 6:.1f} K7 and {got['halo_force'] / 6:.1f} K8 "
              f"launches; all {got}", flush=True)
    bits = np.array_equal(one["theta"], four["theta"])
    d = np.remainder(one["theta"] - four["theta"] + np.pi, 2 * np.pi) - np.pi
    dmax = float(np.abs(d).max())
    same = one["results"] == four["results"] and len(one["results"]) == 4
    check(bits and same or dmax <= 2e-4,
          f"(r) theta differs by {dmax:.3e} from the one-process mesh's")
    print(f"phase 3: (r) the demo's CLI at {NX}x{NT} C={C_MAIN} on 2x2 shards, 2 + 4 "
          f"trajectories, one process against 4 ({layout}, {what}): every chain's theta "
          f"bit for bit {bits} (max |dtheta| {dmax:.3e}), printed results "
          f"{'equal' if same else 'differ'}: {four['results']} against "
          f"{one['results']}", flush=True)
    for label, o in (("1 process, every shard on the card", one),
                     (f"{layout}, {what}", four)):
        print(f"phase 3: (r) {label}: measure phase {o['rate']:.2f} chain-traj/s, "
              f"{o['iters']:.1f} CG iterations per chain-trajectory, {o['wall']:.1f} s "
              f"wall (process start-up included); card {card}", flush=True)
    total = dict.fromkeys(per_proc[0][1], 0)
    for _, got in per_proc.values():
        for k, n in got.items():
            total[k] += n
    return total


# Random123's known-answer vectors of philox4x32_10: (counter, key, words)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
# f64 operations of a Box-Muller pair counted for the noise kernel's bound:
# its 8 products and its log, sqrt, sin and cos counted as one each (a
# lower bound; Philox's integer operations are not counted: the table of
# peaks has no integer rate)
F_NOISE_PAIR = 12


def noise_kernel_checks(dev, card):
    """Phase 2 for the noise kernel (ops/noise.chain_noise, csrc/noise.cu)
    against its plain twin (utils/prng.trajectory_noise_reference) on the
    card: the three known-answer vectors of Philox4x32-10 out of the
    kernel's own bijection; at the demo shape (64x64 C=32, the counter on
    the card at 123) under every chi shape (even-odd, Hasenbusch, full-D)
    and both dtypes, the Philox words equal and the values equal but for
    counted ties (at most 1e-5 of them, within 1e-5 (f32) or 1e-13 (f64) of
    each other), r in [0, 1); the invariants (chains 2-3 of C=4 equal C=2
    at chain_offset 2; the int index equals the counter); then the kernel,
    its twin and torch.randn of as many values from one CUDA generator
    timed in turns at the main path's draw (f32, even-odd, C=32). Returns
    (max_abs_err, (ms, plain_ms, device_ms), (bound_ms, bound_by),
    library_ms, detail)."""
    from schwingermodel_tpu_torch.ops import noise
    from schwingermodel_tpu_torch.utils import prng

    for ctr, key, want in PHILOX_KAT:
        got = noise.philox(torch.tensor([ctr], dtype=torch.int64, device=dev), key)
        check(got[0].tolist() == list(want),
              f"noise: Philox of {ctr} under {key}: {[hex(w) for w in got[0].tolist()]}")
    seed, C, pi_shape = 5, C_MAIN, (2, NX, NT)
    traj = torch.full((), 123, dtype=torch.int64, device=dev)
    chi_shapes = {"even-odd": (2, NX, NT // 2), "Hasenbusch": (2, 2, NX, NT // 2),
                  "full-D": (2, NX, NT)}
    worst, ties = 0.0, {}
    for label, chi_shape in chi_shapes.items():
        for rdtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
            pi, chi, r, w = noise.chain_noise(seed, traj, C, pi_shape, chi_shape, rdtype,
                                              dev, words=True)
            pp, cp, rp, wp = prng.trajectory_noise_reference(
                seed, 123, C, 0, math.prod(pi_shape), math.prod(chi_shape), rdtype, dev,
                words=True)
            torch.cuda.synchronize()
            name = f"{label} {str(rdtype)[6:]}"
            check(torch.equal(w, wp), f"noise {name}: Philox words differ from the twin's")
            a = torch.cat([pi.flatten(), torch.view_as_real(chi).flatten(), r])
            b = torch.cat([pp.flatten(), torch.view_as_real(cp).flatten(), rp])
            check(bool(torch.isfinite(a).all()) and bool(((r >= 0) & (r < 1)).all()),
                  f"noise {name}: non-finite values or r outside [0, 1)")
            n_ties = int((a != b).sum())
            err = float((a - b).abs().max())
            check(n_ties <= 1e-5 * a.numel() and err <= tol,
                  f"noise {name}: {n_ties} values differ from the twin's, by up to {err:.3e}")
            ties[name] = n_ties
            if rdtype == torch.float32:
                worst = max(worst, err)
    whole = noise.chain_noise(seed, traj, 4, pi_shape, chi_shapes["even-odd"],
                              torch.float32, dev)
    part = noise.chain_noise(seed, 123, 2, pi_shape, chi_shapes["even-odd"],
                             torch.float32, dev, chain_offset=2)
    check(all(torch.equal(x[2:], y) for x, y in zip(whole, part)),
          "noise: chains 2-3 of C=4 differ from C=2 at chain_offset 2, or the counter "
          "from the int index")
    print(f"phase 2: noise kernel: the three Philox4x32-10 known-answer vectors out of "
          f"the kernel; at {NX}x{NT} C={C} the words of every chi shape and dtype equal "
          f"the twin's, values differing (ties) {ties}, max |v - v_plain| (f32) "
          f"{worst:.3e}; chains 2-3 of C=4 equal C=2 at offset 2 and the int index "
          f"equals the counter on the card", flush=True)

    eo = chi_shapes["even-odd"]
    n_pi, n_chi = math.prod(pi_shape), math.prod(eo)
    kernel = lambda: noise.chain_noise(seed, traj, C, pi_shape, eo, torch.float32, dev)
    plain = lambda: prng.trajectory_noise_reference(seed, traj, C, 0, n_pi, n_chi,
                                                    torch.float32, dev)
    times = in_turns(plain, kernel, 20, 200)
    g = torch.Generator(device=dev).manual_seed(0)
    n_values = C * (n_pi + 2 * n_chi + 1)
    library = lambda: torch.randn(n_values, generator=g, device=dev)
    l1, k1 = timed(library, 200), timed(kernel, 200)
    k2, l2 = timed(kernel, 200), timed(library, 200)
    library_ms = (l1 + l2) / 2
    n_pairs = C * (n_pi // 2 + n_chi)
    bound = roofline(4 * n_values + 8, f64_ops=F_NOISE_PAIR * n_pairs)
    print(f"phase 2: noise kernel at {NX}x{NT} C={C} (f32, even-odd chi; {card}): kernel "
          f"{times[0]:.4f} ms ({times[2]:.4f} ms queued behind a spin), plain twin "
          f"{times[1]:.4f} ms, torch.randn of its {n_values} values {library_ms:.4f} ms "
          f"(kernel {(k1 + k2) / 2:.4f} ms in turns with it), bound {bound[0]:.5f} ms by "
          f"{bound[1]}", flush=True)
    detail = {"ties": ties, "ms_in_turns_with_library": (k1 + k2) / 2}
    return worst, times, bound, library_ms, detail


def profile_window(step, n, reps_label=""):
    """torch.profiler over n calls of step(): (wall ms per call, device
    launches per call, device-busy share, [(kernel, count, device us)]
    by device time)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace may miss the first kernels of its window: a spin of the
        # card and a pause of the host before the calls timed
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the program's hmc.* spans are host ranges, to which the profiler also
    # credits the device time of a graph replay's kernels: left out, so that
    # no kernel is counted twice
    ev = [(e.key, e.count, getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0)))
          for e in prof.key_averages()
          if "spin_kernel" not in e.key and not e.key.startswith("hmc.")]
    dev_ev = sorted((e for e in ev if e[2] > 0), key=lambda e: -e[2])
    busy = sum(e[2] for e in dev_ev) * 1e-6
    check(dev_ev, f"profile {reps_label}: no device time in the trace")
    return 1e3 * wall / n, sum(e[1] for e in dev_ev) / n, busy / wall, dev_ev


# the demo point through the CLI on the device program
T_FLAGS = [*MP_FLAGS, "--no-simdata"]


def device_program(counters, hmc_params, lattice, dev, card, cli, counted):
    """Phase 3 (t): the packed trajectory as a device program
    (hmc/program.TrajectoryProgram: one CUDA graph replay a trajectory).

    For the refined demo (64x64 C=32 md=10), loose, Hasenbusch dm=0.4,
    Omelyan md=5, MRE K=4 and 128x128 C=8 (K3 on a cluster): one step (the
    warm-up and the capture), then 10 replays, against 11 eager
    hmc_trajectory_packed calls at the same indices into a Block: theta and
    every accumulator bit for bit, the counter, and the launch counts of the
    replays equal those of the 10 eager calls (the demo: K3 10, K1 9, K4's
    entry 0, noise 1 a trajectory); each replay and eager call timed in
    turns. Then the CLI at the demo point on the graph, 10 + 20 trajectories,
    the main gates and the graph's line (one capture, 29 replays); the
    demo through runner.run_hmc graphed and eager in turns (graph, eager,
    eager, graph) for the measure phase's chain-traj/s; and three batch
    trajectories of each under torch.profiler (busy share, launches a batch
    trajectory, K1, K3 and the noise kernel by name). Returns the details
    for the kernels line."""
    import contextlib
    import io

    from schwingermodel_tpu_torch.config import LatticeParams, RunParams
    from schwingermodel_tpu_torch.hmc import packed as hp
    from schwingermodel_tpu_torch.hmc.program import Block, TrajectoryProgram
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.ops import traj as tr
    from schwingermodel_tpu_torch.runner import hot_start, run_hmc

    def zero():
        for fn in counters.values():
            fn.launches = 0
        tr.force_step.variants.clear()

    def read():
        return ({k: fn.launches for k, fn in counters.items()},
                dict(tr.force_step.variants))

    accumulators = ("accepted", "cg_iters", "converged", "exp_mdH", "fallbacks",
                    "action_iters", "unconverged",
                    "fail_theta", "fail_seen", "fail_index")
    big = LatticeParams(Nx=128, Nt=128, real_dtype="float32")
    out = {"ms_per_trajectory": {}}
    n = 10
    for label, lat, C, hmc in (
            ("refined demo md=10", lattice, C_MAIN, hmc_params()),
            ("loose md=10", lattice, C_MAIN, hmc_params(refine=False)),
            ("Hasenbusch dm=0.4 md=10", lattice, C_MAIN, hmc_params(hasenbusch_dm=0.4)),
            ("Omelyan md=5", lattice, C_MAIN, hmc_params(md_steps=5, integrator="omelyan")),
            ("MRE K=4 md=10", lattice, C_MAIN, hmc_params(mre_history=4)),
            ("128x128 C=8 refined md=10", big, 8, hmc_params())):
        model = SchwingerModel(lattice=lat, hmc=hmc)
        theta0 = hot_start(lat, 0, C, dev)
        prog = TrajectoryProgram(model, theta0, 0, 0)
        prog.step()
        zero()
        prog.run(n)
        torch.cuda.synchronize()
        graph_counts = read()
        theta, blk = theta0.clone(), Block(theta0)
        for i in range(n + 1):
            if i == 1:
                zero()
            theta_next, st = hp.hmc_trajectory_packed(model, theta, 0, i)
            blk.add(theta, st, i)
            theta = theta_next
        torch.cuda.synchronize()
        eager_counts = read()
        same = [a for a in accumulators
                if not torch.equal(getattr(prog.block, a), getattr(blk, a))]
        check(torch.equal(prog.theta, theta) and not same and int(prog.index) == n + 1
              and prog.block.updates == blk.updates,
              f"(t) {label}: replays against eager calls: theta bit for bit "
              f"{torch.equal(prog.theta, theta)}, accumulators that differ {same}, "
              f"counter {int(prog.index)}")
        check(graph_counts == eager_counts, f"(t) {label}: launches of {n} replays "
              f"{graph_counts} against {n} eager calls {eager_counts}")
        got = graph_counts[0]
        check(got["chain_noise"] == n and got["solve_f64_cg_fallback"] == 0,
              f"(t) {label}: launches {got}")
        # K3's clocks, added into the block by the eager step and every replay
        if hmc.cg.refine:
            cyc = prog.block.clocks
            check(bool((cyc[:, 0] > cyc[:, 1]).all() and (cyc[:, 1] > 0).all()),
                  f"(t) {label}: K3's clocks in the block {cyc[:2].tolist()}")
        if label.startswith("refined demo"):
            check(got["solve_refined"] == 10 * n and got["force_step"] == 9 * n,
                  f"(t) {label}: K3 {got['solve_refined']} and K1 {got['force_step']} "
                  f"launches in {n} replays")
        # replays and eager calls in turns
        eager_theta = [theta]

        def eager():
            eager_theta[0], _ = hp.hmc_trajectory_packed(model, eager_theta[0], 0, 99)

        g1, e1 = timed(prog.step, 5), timed(eager, 5)
        e2, g2 = timed(eager, 5), timed(prog.step, 5)
        out["ms_per_trajectory"][label] = {"graph": (g1 + g2) / 2, "eager": (e1 + e2) / 2}
        per = {k: v / n for k, v in got.items() if v}
        print(f"phase 3: (t) {label} at {lat.Nx}x{lat.Nt} C={C}: captured once "
              f"({prog.kernel_nodes} kernel nodes), {n} replays against {n + 1} eager "
              f"calls: theta, every accumulator and the counter bit for bit, launches "
              f"equal, per batch trajectory {per}; {(g1 + g2) / 2:.3f} ms a replay "
              f"against {(e1 + e2) / 2:.3f} ms an eager call (in turns; {card})",
              flush=True)
        if label.startswith("refined demo"):
            # a new step size is captured anew
            prog.dt = 0.5 * hmc.step_size
            prog.step()
            torch.cuda.synchronize()
            check(prog.captures == 2, f"(t) {label}: {prog.captures} captures after "
                  f"a change of dt")

    # the CLI at the demo point on the graph
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        rc, wall, got = counted(
            "(t) the CLI on the graph", ("with_solve=False,with_gauge=True",
                                         "solve_refined", "chain_noise"),
            lambda: cli.main([*T_FLAGS, "--out-dir", tmp]), ("solve_f64_cg_fallback",))
    text = buf.getvalue()
    print("\n".join(ln for ln in text.splitlines() if ln.startswith("phase 3")), flush=True)
    check(rc == 0 and "all solves converged: True" in text,
          f"(t) the CLI: exit {rc}\n{text[-3000:]}")
    rate = re.search(r"perf: hmc\.measure: \S+ s \([^)]*\)\s+(\S+) traj/s", text)
    acc = re.search(r"Acceptance rate: (\S+)", text)
    em = re.search(r"<exp\(-dH\)> = (\S+),", text)
    ep = re.search(r"Ep = (\S+)", text)
    graph_line = re.search(r"perf: graph: 1 capture\(s\), 29 replays, (\d+) kernel nodes, "
                           r"(\S+) us of host per replay", text)
    check(rate and acc and em and ep and graph_line, f"(t) the CLI: no result or graph "
          f"line\n{text[-3000:]}")
    acc, em, ep = float(acc.group(1)), float(em.group(1)), float(ep.group(1))
    check(0.3 < acc <= 1.0 and abs(em - 1.0) < 0.1 and 0.0 < ep < 1.0,
          f"(t) the CLI: acceptance {acc}, <exp(-dH)> {em}, <P> {ep}")
    check(got["solve_refined"] == 300 and got["chain_noise"] == 30,
          f"(t) the CLI: launches {got}")
    print(f"phase 3: (t) the CLI at {NX}x{NT} C={C_MAIN} md=10 on the graph, 10 + 20 "
          f"trajectories in {wall:.2f} s: <P> {ep:.6f}, acceptance {acc:.4f}, "
          f"<exp(-dH)> {em:.6f}, measure phase {float(rate.group(1)):.2f} chain-traj/s; "
          f"graph of {graph_line.group(1)} kernel nodes, {graph_line.group(2)} us of host "
          f"a replay; card {card}", flush=True)

    # graphed and eager in turns, and under the profiler
    run = RunParams(n_therm=10, n_meas=20, n_steps=0, n_chains=C_MAIN, seed=0)
    rates = {True: [], False: []}
    for graph in (True, False, False, True):
        res = run_hmc(lattice, hmc_params(), run, device=dev, graph=graph)
        check(res.all_converged and 0.3 < res.acceptance_rate <= 1.0,
              f"(t) run_hmc graph={graph}: converged {res.all_converged}, acceptance "
              f"{res.acceptance_rate}")
        rates[graph].append(res.perf["spans"]["hmc.measure"]["traj_per_s"])
    model = SchwingerModel(lattice=lattice, hmc=hmc_params())
    prog = TrajectoryProgram(model, hot_start(lattice, 0, C_MAIN, dev), 0, 0)
    prog.step()
    eager_theta = [prog.theta.clone()]

    def eager():
        eager_theta[0], _ = hp.hmc_trajectory_packed(model, eager_theta[0], 0, 1)

    eager()
    prof = {}
    for label, step in (("graph", prog.step), ("eager", eager), ("eager ", eager),
                        ("graph ", prog.step)):
        ms, launches, busy, dev_ev = profile_window(step, 3, label)
        names = {k for k, _, _ in dev_ev}
        for kname, marks in (("K1", ("force_shared_kernel", "force_step_kernel")),
                             ("K3", ("solve_ru",)), ("noise", ("noise_kernel",))):
            check(any(m in k for k in names for m in marks),
                  f"(t) profile {label.strip()}: {kname} missing from {sorted(names)[:20]}")
        prof.setdefault(label.strip(), []).append((ms, launches, busy))
    summary = {}
    for label, rows in prof.items():
        summary[label] = {
            "chain_traj_per_s": float(np.mean(rates[label == "graph"])),
            "ms_per_batch_trajectory_profiled": float(np.mean([r[0] for r in rows])),
            "launches_per_batch_trajectory": float(np.mean([r[1] for r in rows])),
            "busy_share": float(np.mean([r[2] for r in rows]))}
    for label, s in summary.items():
        print(f"phase 3: (t) the demo at {NX}x{NT} C={C_MAIN} {label}: measure phase "
              f"{s['chain_traj_per_s']:.2f} chain-traj/s (run_hmc, two runs in turns); "
              f"under torch.profiler {s['ms_per_batch_trajectory_profiled']:.3f} ms a "
              f"batch trajectory, {s['launches_per_batch_trajectory']:.0f} device launches "
              f"a batch trajectory, device busy {100 * s['busy_share']:.1f}% (K1, K3 and "
              f"the noise kernel by name); card {card}", flush=True)
    out["demo"] = summary
    return out


# bytes of one Z2xZ2 entry (complex64) that the Z2 mode writes
Z2_ENTRY_BYTES = 8


@dataclasses.dataclass
class _SyncGuard:
    """Turns torch.cuda.set_sync_debug_mode("error") on for the runner's
    measurement phase, off for its block reads, its final gathers and the
    programs' one-time captures (a host read inside a capture fails the
    capture itself)."""
    phases: int = 0

    def install(self, stack):
        import contextlib

        from schwingermodel_tpu_torch.hmc import program
        from schwingermodel_tpu_torch.parallel import multihost as mh
        from schwingermodel_tpu_torch.utils import metrics

        guard = self
        orig_span = metrics.PerfMonitor.span

        @contextlib.contextmanager
        def span(mon, name):
            with orig_span(mon, name) as st:
                if name != "hmc.measure":
                    yield st
                    return
                guard.phases += 1
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

        for owner, name, wrap in (
                (metrics.PerfMonitor, "span", span),
                (program.Block, "read", allowed(program.Block.read)),
                (program._GraphedStep, "_capture", allowed(program._GraphedStep._capture)),
                (mh, "gather_chains", allowed(mh.gather_chains))):
            old = getattr(owner, name)
            setattr(owner, name, wrap)
            stack.callback(setattr, owner, name, old)


def condensate_measurement(model, n_noise):
    """The runner's measurement with the condensate as a function of
    (theta, measurement index): plaquette, action density, charge, the
    condensate's value, flags and iterations per solve."""
    from schwingermodel_tpu_torch import observables as obs

    def measure(th, i):
        o = obs.measure_all(model, th)
        cc = obs.chiral_condensate(model, th, 1, i, n_noise)
        o.update(chiral_condensate=cc.value, converged=cc.converged, iters=cc.iters)
        return o
    return measure


def measurement_program(counted, hmc_params, lattice, dev, card, theta_d):
    """Phase 3 (u): the measurement phase as a device program.

    The noise kernel's Z2 mode against its twin at 64x64 C=32, 8 vectors
    (words and values exact, the counter on the card, chains at an offset),
    timed with the twin and torch.randint of as many values in turns; K6
    and K9 with a mask (half the 256 entries active) against the unmasked
    kernels (bit for bit on the active entries, the inactive ones left:
    x = x0 and 0 iterations, r and ||r||^2 as given) and their twins (K6
    x to 2e-4 and equal flags, K9 r to 1e-12 (max|b| + max|A x|)), and
    each timed with every entry inactive (a trailing pass) against all
    active; on (d)'s final configurations the refined and the loose
    measurement (plaquette, action, charge, the condensate of 8 vectors
    with its flags and iterations) as a MeasurementProgram: 10 replays
    against 10 eager calls at the same indices, bit for bit, the launch
    counts equal, a replay and an eager call timed in turns; the demo with
    --condensate on the graph with torch.cuda.set_sync_debug_mode("error")
    over its measurement phase but the block read, the final gathers and
    the captures, against graph=False: theta and every observable bit for
    bit, the refined demo's measure-phase chain-traj/s graphed and eager in
    turns; tools/critical_mass.run_point at 8x8 C=8 on the programs against
    its eager run: the row equal. Returns the details for the kernels
    line."""
    import contextlib

    from schwingermodel_tpu_torch.config import LatticeParams, RunParams
    from schwingermodel_tpu_torch.hmc.program import MeasurementProgram
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.ops import cg_eo, noise
    from schwingermodel_tpu_torch.ops import refined as rs
    from schwingermodel_tpu_torch.ops import traj as tr
    from schwingermodel_tpu_torch.runner import run_hmc
    from schwingermodel_tpu_torch.tools import critical_mass
    from schwingermodel_tpu_torch.utils import prng
    from schwingermodel_tpu_torch.utils.metrics import device_ms, kernel_launches

    out = {}
    C, n_noise, sites = C_MAIN, 8, (2, NX, NT)
    n_el = math.prod(sites)
    # the Z2 mode against its twin: words and values exact
    meas = torch.full((), 123, dtype=torch.int64, device=dev)
    z, w = noise.z2_noise(5, meas, C, n_noise, sites, dev, words=True)
    zp, wp = prng.z2_noise_reference(5, 123, C, 0, n_noise, n_el, dev, words=True)
    torch.cuda.synchronize()
    check(torch.equal(w, wp), "(u) Z2 mode: Philox words differ from the twin's")
    check(torch.equal(z.reshape(C, n_noise, n_el), zp), "(u) Z2 mode: values differ")
    part = noise.z2_noise(5, 123, C - 1, n_noise, sites, dev, chain_offset=1)
    check(torch.equal(z[1:], part), f"(u) Z2 mode: chains 1.. of C={C} differ from "
          f"C={C - 1} at chain_offset 1, or the counter from the int index")
    kernel = lambda: noise.z2_noise(5, meas, C, n_noise, sites, dev)
    plain = lambda: prng.z2_noise_reference(5, meas, C, 0, n_noise, n_el, dev)
    times = in_turns(plain, kernel, 20, 200)
    n_values = 2 * C * n_noise * n_el
    g = torch.Generator(device=dev).manual_seed(0)
    library = lambda: torch.randint(0, 2, (n_values,), generator=g, device=dev)
    l1, k1 = timed(library, 200), timed(kernel, 200)
    k2, l2 = timed(kernel, 200), timed(library, 200)
    bound = roofline(Z2_ENTRY_BYTES * C * n_noise * n_el)
    out["z2"] = dict(max_abs_err=0.0, times=times, bound=bound,
                     library_ms=(l1 + l2) / 2,
                     library_device_ms=device_ms(library, 200),
                     ms_in_turns_with_library=(k1 + k2) / 2)
    print(f"phase 3: (u) Z2 mode at {NX}x{NT} C={C}, {n_noise} vectors ({card}): words "
          f"and values equal the twin's (exact), chains at an offset equal; kernel "
          f"{times[0]:.4f} ms ({times[2]:.4f} ms queued behind a spin), twin "
          f"{times[1]:.4f} ms, torch.randint of its {n_values} values "
          f"{out['z2']['library_ms']:.4f} ms [{out['z2']['library_device_ms']:.4f}] "
          f"(kernel {(k1 + k2) / 2:.4f} ms in turns with it), bound {bound[0]:.5f} ms "
          f"by {bound[1]}", flush=True)
    # torch.randn of the trajectory noise's values, its device time in the
    # same harness as the noise kernel's
    n_traj_values = C * (NX * NT * 2 + 2 * 2 * NX * NT // 2 + 1)
    out["randn_device_ms"] = device_ms(
        lambda: torch.randn(n_traj_values, generator=g, device=dev), 200)

    # K6 and K9 with a mask
    model = SchwingerModel(lattice=lattice, hmc=hmc_params())
    thE, thO = tr.pack_planes(theta_d)
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    gen = torch.Generator(device=dev).manual_seed(77)
    B = n_noise
    bb = torch.randn((C, B, 2, 2, NX, NT // 2), generator=gen, device=dev)
    x0 = torch.randn(bb.shape, generator=gen, device=dev)
    active = torch.rand((C, B), generator=gen, device=dev) < 0.5
    none = torch.zeros_like(active)
    kw = dict(m0=M0, tol=1e-5, max_iter=10000)
    full = cg_eo.cg_solve_eo(ue, uo, bb, x0, **kw)
    masked = cg_eo.cg_solve_eo(ue, uo, bb, x0, active=active, **kw)
    twin = cg_eo.cg_solve_eo_reference(ue, uo, bb, x0, active=active, **kw)
    torch.cuda.synchronize()
    a6 = active[:, :, None, None, None, None].expand_as(bb)
    check(torch.equal(masked.x[a6], full.x[a6])
          and torch.equal(masked.iters[active], full.iters[active])
          and torch.equal(masked.converged[active], full.converged[active]),
          "(u) K6 with a mask: the active entries differ from the unmasked launch")
    check(torch.equal(masked.x[~a6], x0[~a6]) and not bool(masked.iters[~active].any())
          and not bool(masked.converged[~active].any()),
          "(u) K6 with a mask: an inactive entry was touched")
    scale = twin.x.abs().max().item()
    dx6 = (masked.x - twin.x).abs().max().item()
    check(dx6 <= 2e-4 * scale and torch.equal(masked.converged, twin.converged),
          f"(u) K6 with a mask against its twin: max |dx| {dx6:.3e} (scale {scale:.3f})")
    x64 = torch.randn(bb.shape, generator=gen, device=dev, dtype=torch.float64)
    r_full, n_full = rs.residual_f64(thE, thO, bb, x64, m0=M0)
    buf = (torch.full_like(r_full, 7.0), torch.full_like(n_full, -1.0))
    r_m, n_m = rs.residual_f64(thE, thO, bb, x64, m0=M0, active=active, out=buf)
    buf_p = (torch.full_like(r_full, 7.0), torch.full_like(n_full, -1.0))
    r_p, n_p = rs.residual_f64_reference(thE, thO, bb, x64, m0=M0, active=active, out=buf_p)
    torch.cuda.synchronize()
    check(torch.equal(r_m[a6], r_full[a6]) and torch.equal(n_m[active], n_full[active]),
          "(u) K9 with a mask: the active entries differ from the unmasked launch")
    check(bool((r_m[~a6] == 7.0).all()) and bool((n_m[~active] == -1.0).all()),
          "(u) K9 with a mask: an inactive entry was written")
    scale9 = bb.abs().max().item() + (bb.double() - r_p).abs().max().item()
    dr9 = (r_m - r_p).abs().max().item()
    dn9 = ((n_m - n_p).abs() / n_p.abs()).max().item()
    check(dr9 <= 1e-12 * scale9 and dn9 <= 1e-12,
          f"(u) K9 with a mask against its twin: max |dr| {dr9:.3e}, ||r||^2 rel {dn9:.3e}")
    zero = torch.zeros_like(bb)
    calls = {
        "K6 all active": (lambda: cg_eo.cg_solve_eo(ue, uo, bb, zero, **kw), 10),
        "K6 none active": (lambda: cg_eo.cg_solve_eo(ue, uo, bb, zero, active=none,
                                                     **kw), 200),
        "K9 all active": (lambda: rs.residual_f64(thE, thO, bb, x64, m0=M0), 100),
        "K9 none active": (lambda: rs.residual_f64(thE, thO, bb, x64, m0=M0,
                                                   active=none, out=buf), 200)}
    # CUDA events around the launches as the host issues them, and the same
    # queued behind a spin of the card ([device])
    mask_ms = {k: timed(fn, reps) for k, (fn, reps) in calls.items()}
    mask_dev = {k: device_ms(fn, reps) for k, (fn, reps) in calls.items()}
    out["mask_ms"], out["mask_device_ms"] = mask_ms, mask_dev
    print(f"phase 3: (u) K6 and K9 with a mask of {int(active.sum())} of {C * B} entries "
          f"at {NX}x{NT} C={C} B={B}: the active entries bit for bit the unmasked "
          f"launches', the others untouched; against the twins K6 max |dx| {dx6:.3e} "
          f"(scale {scale:.3f}), flags equal, K9 max |dr| {dr9:.3e}, ||r||^2 rel "
          f"{dn9:.3e}; ms [device] " + ", ".join(
              f"{k} {v:.4f} [{mask_dev[k]:.4f}]" for k, v in mask_ms.items())
          + f" ({card})", flush=True)

    # the measurement as a captured graph against eager calls
    n = 10
    out["ms_per_measurement"] = {}
    for label, hmc in (("refined", hmc_params()), ("loose", hmc_params(refine=False))):
        model = SchwingerModel(lattice=lattice, hmc=hmc)
        measure = condensate_measurement(model, n_noise)
        static = theta_d.clone()
        # rows: the warm-up, n replays, and two timings of 1 + 5 replays
        prog = MeasurementProgram(measure, static, n + 13)
        prog.step()                                    # warm-up and capture
        before = kernel_launches()
        prog.run(n)
        torch.cuda.synchronize()
        after = kernel_launches()
        graph_counts = {k: after[k] - before[k] for k in after}
        rows = [measure(static, i) for i in range(1, n + 1)]
        torch.cuda.synchronize()
        eager_counts = {k: kernel_launches()[k] - after[k] for k in after}
        same = all(torch.equal(prog.out[k][i + 1], row[k])
                   for i, row in enumerate(rows) for k in row)
        check(same, f"(u) {label}: {n} measurement replays differ from {n} eager calls")
        check(graph_counts == eager_counts and graph_counts["z2_noise"] == n,
              f"(u) {label}: launches of the replays {graph_counts} against the eager "
              f"calls {eager_counts}")
        check(bool(prog.out["converged"][:n + 1].all()), f"(u) {label}: a condensate solve did "
              "not converge")
        eager = lambda: measure(static, 99)
        g1, e1 = timed(prog.step, 5), timed(eager, 5)
        e2, g2 = timed(eager, 5), timed(prog.step, 5)
        out["ms_per_measurement"][label] = {"graph": (g1 + g2) / 2, "eager": (e1 + e2) / 2,
                                            "kernel_nodes": prog.kernel_nodes}
        per = {k: v / n for k, v in graph_counts.items() if v}
        print(f"phase 3: (u) the {label} measurement at {NX}x{NT} C={C}, {n_noise} "
              f"vectors, on (d)'s final configurations: captured once "
              f"({prog.kernel_nodes} kernel nodes), {n} replays against {n} eager calls "
              f"bit for bit (values, flags, iterations), launches equal, per "
              f"measurement {per}; {(g1 + g2) / 2:.3f} ms a replay against "
              f"{(e1 + e2) / 2:.3f} ms an eager call (in turns; {card})", flush=True)

    # the runner: the measurement phase reads the host only in the block read
    run = RunParams(n_therm=10, n_meas=20, n_steps=0, n_chains=C_MAIN, seed=0)
    rates = {True: [], False: []}
    for label, hmc, graphs in (("refined", hmc_params(), (True, False, False, True)),
                               ("loose", hmc_params(refine=False), (True, False))):
        res = {}
        for graph in graphs:
            guard = _SyncGuard()
            with contextlib.ExitStack() as stack:
                if graph:
                    guard.install(stack)
                r, _, _ = counted(
                    f"(u) {label} demo --condensate --n-noise {n_noise}, graph={graph}",
                    ("cg_solve_eo", "z2_noise", "chain_noise")
                    + (("residual_f64",) if hmc.cg.refine else ()),
                    lambda: run_hmc(lattice, hmc, run, device=dev, measure_condensate=True,
                                    n_noise=n_noise, graph=graph))
            check(guard.phases == int(graph), f"(u) {label}: the sync guard saw "
                  f"{guard.phases} measurement phases")
            check(r.all_converged and r.condensate_converged,
                  f"(u) {label} graph={graph}: a solve did not converge")
            if graph:
                mg = r.perf.get("measurement_graph", {})
                check(mg.get("captures") == 1 and mg.get("replays") == run.n_meas - 1,
                      f"(u) {label}: measurement graph {mg}")
            res.setdefault(graph, r)
            if label == "refined":
                rates[graph].append(r.perf["spans"]["hmc.measure"]["traj_per_s"])
        a, b = res[True], res[False]
        check(np.array_equal(a.theta, b.theta)
              and all(np.array_equal(a.chains[k], b.chains[k]) for k in a.chains)
              and a.condensate_iters == b.condensate_iters,
              f"(u) {label}: the graphed run differs from graph=False")
        print(f"phase 3: (u) the {label} demo --condensate on the graph, its measurement "
              f"phase under set_sync_debug_mode('error') but the block read: theta, "
              f"{sorted(a.chains)} and the condensate's {a.condensate_iters} iterations "
              f"bit for bit graph=False's; measurement graph "
              f"{a.perf['measurement_graph']['kernel_nodes']} kernel nodes, "
              f"{a.perf['measurement_graph']['host_us_per_replay'] or math.nan:.1f} us "
              f"of host a replay", flush=True)
    out["demo_condensate_chain_traj_per_s"] = {
        "graph": float(np.mean(rates[True])), "eager": float(np.mean(rates[False]))}
    print(f"phase 3: (u) the refined demo --condensate --n-noise {n_noise}: measure phase "
          f"{out['demo_condensate_chain_traj_per_s']['graph']:.2f} chain-traj/s graphed "
          f"against {out['demo_condensate_chain_traj_per_s']['eager']:.2f} eager (two "
          f"runs each, in turns; {card})", flush=True)

    # the critical-mass tool on its device programs against its eager run
    args = argparse.Namespace(beta=2.0, md_steps=20, tau=1.0, chains=8, n_therm=20,
                              n_blocks=4, n_skip=2, seed=3)
    lat8 = LatticeParams(Nx=8, Nt=8, real_dtype="float32")
    rows = {g: critical_mass.run_point(args, -0.1, dev, lat8, graph=g) for g in (True, False)}
    check(rows[True] == rows[False], f"(u) critical_mass 8x8: on the programs {rows[True]} "
          f"against eager {rows[False]}")
    print(f"phase 3: (u) critical_mass.run_point 8x8 beta=2 m0=-0.1 C=8 (2 x 10 annealing "
          f"+ 20 + 4 x 2 trajectories, 4 correlator sets) on its device programs equals "
          f"its eager run: {rows[True]}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    from schwingermodel_tpu_torch import cli
    from schwingermodel_tpu_torch import observables as obs
    from schwingermodel_tpu_torch.config import (CGParams, HMCParams,
                                                 LatticeParams, RunParams)
    from schwingermodel_tpu_torch.hmc import packed as hp
    from schwingermodel_tpu_torch.hmc import sampler
    from schwingermodel_tpu_torch.io import checkpoint
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.ops import _cuda, cg_eo, eo, gauge, halo, noise
    from schwingermodel_tpu_torch.ops import refined as rs
    from schwingermodel_tpu_torch.ops import traj as tr
    from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh
    from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn
    from schwingermodel_tpu_torch.runner import run_hmc
    from schwingermodel_tpu_torch.scan import exact_quenched_plaquette
    from schwingermodel_tpu_torch.solvers import cg as cg_mod
    from schwingermodel_tpu_torch.solvers import refine
    from schwingermodel_tpu_torch.tools import bench_mxu_stencil, critical_mass, crossvalidate

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
    sms = _cuda.sm_count(dev)

    # ---- phase 2: kernels against their plain twins ----
    noise_err, noise_times, noise_bound, noise_library_ms, noise_detail = (
        noise_kernel_checks(dev, card))
    # K10's twin shifts by a plain f32 matmul with a one-hot matrix, exact
    # on the card only in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matmul is not in full precision")
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

    def eo_rel_residual(thE, thO, b, x):
        """Per-entry f64 ||b - A x|| / ||b|| of [C, B] systems (K9's twin)."""
        _, rn = rs.residual_f64_reference(thE, thO, b, x.double(), m0=M0)
        return (rn / (b.double() ** 2).sum(dim=(2, 3, 4, 5))).sqrt()

    def k3_checks(thE, thO, b, C):
        """K3 against its twin on one system (C: the label of its shape):
        both contracts, per-chain semantics bit for bit, the fallback in
        K3's launch against the composition of the twins and of the
        kernels, the mixed batch, and the stand-alone K4."""
        nx, nth = thE.shape[-2:]
        n_ch = thE.shape[0]
        path = rs.ru_path_name(nx, nth, n_ch, _cuda.sm_count(dev))
        exact = None
        for certify, tol in ((True, 1e-10), (False, 1e-8)):
            # the force contract is exercised from a forecast start, as on
            # the main path: the certified solution, perturbed by 1e-3
            x0 = b if certify else (
                exact.x + 1e-3 * exact.x.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
                * torch.randn(b.shape, generator=gen, device=dev))
            kw = dict(m0=M0, tol=tol, certify=certify)
            k = rs.solve_refined(thE, thO, b, x0, **kw)
            p = rs.solve_refined_reference(thE, thO, b, x0, **kw)
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
            check(not bool(k.fb_iters.any()), f"K3 certify={certify} C={C}: fallback "
                  "iterations without the fallback")
            # per-chain semantics on the card: chain i alone is chain i of
            # the batch, bit for bit
            for i in range(n_ch):
                one = rs.solve_refined(thE[i:i + 1], thO[i:i + 1], b[i:i + 1],
                                       x0[i:i + 1], **kw)
                check(torch.equal(one.x64[0], k.x64[i]) and int(one.iters[0]) == int(
                    k.iters[i]), f"K3 certify={certify} C={C}: chain {i} alone differs "
                    f"from chain {i} of the batch")
            dx = (k.x64 - p.x64).abs().max().item()
            if certify:
                exact = k
                errs["solve_refined"] = max(errs["solve_refined"], dx)
            print(f"phase 2: K3 certify={certify} tol={tol:g} C={C} (path: {path}): "
                  f"residual kernel {rk.max().item():.3e} plain {rp.max().item():.3e}; "
                  f"max |x - x_plain| {dx:.3e}; iterations kernel "
                  f"{k.iters[:8].tolist()} plain {p.iters[:8].tolist()}; each of the "
                  f"{n_ch} chains alone equals its chain of the batch bit for bit",
                  flush=True)

        # the fallback in K3's launch: a K3 starved at 5 iterations
        kw = dict(m0=M0, tol=1e-10, max_iter=5)
        starved = rs.solve_refined(thE, thO, b, b, **kw)
        check(not bool(starved.converged.any()), "starved K3 converged")
        before = (rs.solve_refined.launches, rs.solve_f64_cg_fallback.launches)
        folded = rs.solve_refined(thE, thO, b, b, fallback=True, fb_max_iter=MAX_ITER,
                                  **kw)
        check((rs.solve_refined.launches, rs.solve_f64_cg_fallback.launches)
              == (before[0] + 1, before[1]), "the folded fallback is not one K3 launch")
        fp = rs.solve_f64_cg_fallback_reference(
            thE, thO, b, rs.solve_refined_reference(thE, thO, b, b, **kw), m0=M0,
            tol=1e-10)
        before = rs.solve_f64_cg_fallback.launches
        fk = rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0, tol=1e-10)
        check(rs.solve_f64_cg_fallback.launches == before + 1, "K4 not launched")
        for label, res in (("K3 with the fallback", folded), ("K4", fk)):
            rk = rel_residual(thE, thO, b, res.x64)
            check(bool((rk < 1e-10).all()) and bool(res.converged.all()),
                  f"{label} C={C}: residual {rk.max().item()}")
            check(torch.equal(res.converged, fp.converged), f"{label} C={C}: flags differ")
            check(bool((res.fb_iters > 0).all()) and torch.equal(
                res.iters, starved.iters + res.fb_iters),
                f"{label} C={C}: fallback iterations {res.fb_iters.tolist()}")
        same = all(torch.equal(a, b_) for a, b_ in zip(folded, fk))
        check(same, f"K3 with the fallback C={C}: differs from K4 after K3")
        dx = (fk.x64 - fp.x64).abs().max().item()
        errs["solve_f64_cg_fallback"] = max(errs["solve_f64_cg_fallback"], dx)
        print(f"phase 2: K4 C={C} from K3 starved at 5 iterations, in K3's launch and "
              f"as a launch of its own (equal bit for bit): residual "
              f"{rk.max().item():.3e}; max |x - x_plain| {dx:.3e}; fallback iterations "
              f"kernel {fk.fb_iters[:8].tolist()} plain {fp.fb_iters[:8].tolist()}",
              flush=True)

        # a mixed batch under max_iter=5: the first half starts from the
        # certified solution, whose f32 round has a residual near 1e-7 ||b||
        # and which K3 accepts at once at 1e-6; the second half from x0 = b,
        # which K3 cannot finish
        half = n_ch // 2
        if half:
            x0 = b.clone()
            x0[:half] = exact.x[:half]
            kw = dict(m0=M0, tol=LOOSE_TOL, max_iter=5)
            alone = rs.solve_refined(thE, thO, b, x0, **kw)
            mixed = rs.solve_refined(thE, thO, b, x0, fallback=True,
                                     fb_max_iter=MAX_ITER, **kw)
            mp = rs.solve_refined_reference(thE, thO, b, x0, fallback=True,
                                            fb_max_iter=MAX_ITER, **kw)
            rk = rel_residual(thE, thO, b, mixed.x64)
            check(alone.converged.tolist() == [True] * half + [False] * (n_ch - half),
                  f"mixed batch C={C}: K3's flags {alone.converged.tolist()}")
            check((mixed.fb_iters > 0).tolist() == (~alone.converged).tolist()
                  and (mp.fb_iters > 0).tolist() == (~alone.converged).tolist(),
                  f"mixed batch C={C}: fallback iterations {mixed.fb_iters.tolist()}")
            check(torch.equal(mixed.x64[:half], alone.x64[:half])
                  and torch.equal(mixed.iters[:half], alone.iters[:half]),
                  f"mixed batch C={C}: a chain K3 converged was changed")
            check(bool(mixed.converged.all()) and bool(mp.converged.all())
                  and bool((rk < LOOSE_TOL).all()),
                  f"mixed batch C={C}: residual {rk.max().item()}")
            print(f"phase 2: K3 with the fallback, mixed batch C={C} under max_iter=5 at "
                  f"tol {LOOSE_TOL:g}: the {half} chains started from the certified "
                  f"solution keep K3's x bit for bit (fallback iterations 0), the other "
                  f"{n_ch - half} fall back ({mixed.fb_iters[half:half + 4].tolist()}, "
                  f"plain {mp.fb_iters[half:half + 4].tolist()}); residual "
                  f"{rk.max().item():.3e}", flush=True)

    def k9_checks(thE, thO, bb, C):
        """K9 on a random f64 x against its twin, on the route residual_path
        takes (through the wrapper) and on every other route that holds the
        shape (each slab count with each count of right-hand sides a block,
        and the global scratch): r to the bound, ||r||^2 to 1e-12 relative,
        r on every route bit for bit the taken one's, two launches of the
        taken route equal bit for bit."""
        x64 = torch.randn(bb.shape, generator=gen, device=dev, dtype=torch.float64)
        nC, B, _, _, nx, nth = bb.shape
        rp, np_ = rs.residual_f64_reference(thE, thO, bb, x64, m0=M0)
        bound = 1e-12 * (bb.abs().max().item() + (bb.double() - rp).abs().max().item())
        taken = rs.residual_path(nx, nth, nC, B, sms)
        r0, n0 = rs.residual_f64(thE, thO, bb, x64, m0=M0)
        r1, n1 = rs.residual_f64(thE, thO, bb, x64, m0=M0)
        torch.cuda.synchronize()
        check(torch.equal(r0, r1) and torch.equal(n0, n1), f"K9 C={C}: two launches differ")
        worst = (0.0, 0.0)
        for route in [taken, (tr.CG_GLOBAL, 1, 1)] + [
                q for q in rs.residual_routes(nx, nth, B) if q != taken]:
            rk, nk = (r0, n0) if route == taken else rs._launch_residual(
                thE, thO, bb, x64, M0, sms, route)
            torch.cuda.synchronize()
            dr = (rk - rp).abs().max().item()
            dn = ((nk - np_).abs() / np_).max().item()
            check(dr <= bound and dn <= 1e-12, f"K9 C={C} route {route}: |r - r_plain| "
                  f"{dr} (bound {bound}), ||r||^2 rel {dn}")
            check(torch.equal(rk, r0), f"K9 C={C}: route {route} differs from {taken}")
            worst = max(worst[0], dr), max(worst[1], dn)
        errs["residual_f64"] = max(errs["residual_f64"], worst[0])
        print(f"phase 2: K9 C={C} B={B} (route: {rs.residual_path_name(nx, nth, nC, B, sms)}; "
              f"{len(rs.residual_routes(nx, nth, B))} shared routes and the global one, r "
              f"bit for bit on all): max |r - r_plain| {worst[0]:.3e} (bound {bound:.3e}); "
              f"max rel. difference of ||r||^2 {worst[1]:.3e}; two launches equal", flush=True)

    def k10_vs_k2(thE, thO, b, k, C):
        """K10 against K2's result k on the same system: equal flags and
        iterations, x bit for bit."""
        k10 = tr.solve_fused_mxu(thE, thO, b, b, m0=M0, tol=LOOSE_TOL, max_iter=MAX_ITER)
        torch.cuda.synchronize()
        check(torch.equal(k10.converged, k.converged) and torch.equal(k10.iters, k.iters),
              f"K10 C={C}: flags or iterations differ from K2's: {k10.iters.tolist()} "
              f"{k.iters.tolist()}")
        check(torch.equal(k10.x, k.x), f"K10 C={C}: x is not K2's bit for bit")
        return k10

    def k1_k2_checks(thE, thO, b, C):
        """K1 in its four variants and K2 against their twins on one system
        (C: the label of its shape), on the path its size takes; returns K2's
        result and its twin's."""
        def path(*a):
            return tr.cg_path_name(*thE.shape[-2:], thE.shape[0], _cuda.sm_count(dev), *a)

        # K1, every variant; with_solve from x0 = phi = b at the loose tol
        for with_solve in (False, True):
            for with_gauge in (True, False):
                kw = dict(m0=M0, beta=BETA, tol=LOOSE_TOL, max_iter=MAX_ITER,
                          with_solve=with_solve, with_gauge=with_gauge)
                k = tr.force_step(thE, thO, b, b, **kw)
                p = tr.force_step_reference(thE, thO, b, b, **kw)
                label = (f"K1 with_solve={with_solve} with_gauge={with_gauge} "
                         f"C={C} (path: {path(with_solve, with_gauge)})")
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
        print(f"phase 2: K2 tol={LOOSE_TOL:g} C={C} (path: {path()}): f64 true residual kernel "
              f"{rk.max().item():.3e} plain {rp.max().item():.3e}; max |x - x_plain| "
              f"{dx:.3e}; iterations kernel {k.iters[:8].tolist()} plain "
              f"{p.iters[:8].tolist()}", flush=True)
        return k, p

    def k6_global(ue, uo, bb, x0, tol):
        """K6's launch on the global path: (x, iters, rho, bnorm2)."""
        return cg_eo._launch(ue, uo, bb, x0, M0, tol, MAX_ITER, _cuda.sm_count(dev),
                             tr.CG_GLOBAL)

    def k6_path(nx, nth, entries):
        """K6's path name and its blocks a multiprocessor runs at once."""
        path, _ = tr.cg_path(nx, nth, entries, _cuda.sm_count(dev))
        per_sm = _cuda.KERNELS.query("cg_eo_blocks_per_sm", nx, nth, path)
        return tr.cg_path_name(nx, nth, entries, _cuda.sm_count(dev)), per_sm

    def k6_checks(thE, thO, ue, uo, bb, C):
        """K6 against its twin on [C, B] systems (C: the label of its shape),
        from x0 = 0 at 1e-5 (the refinement's inner solve) and from x0 = b at
        the loose tol, and starved; on the shared path where V2 is a multiple
        of 512, against the global path through the C entry: x, iterations,
        rho and ||b||^2 (so the flags) bit for bit."""
        n_c, B, _, _, nx, nth = bb.shape
        path, per_sm = k6_path(nx, nth, n_c * B)
        against_global = path == "shared" and (nx * nth) % 512 == 0
        for tol, cold in ((1e-5, True), (LOOSE_TOL, False)):
            x0 = torch.zeros_like(bb) if cold else bb
            label = (f"K6 tol={tol:g} from x0={'0' if cold else 'b'} C={C} B={B} (path: "
                     f"{path}, {per_sm} block(s) an SM)")
            k = cg_eo.cg_solve_eo(ue, uo, bb, x0, m0=M0, tol=tol, max_iter=MAX_ITER)
            p = cg_eo.cg_solve_eo_reference(ue, uo, bb, x0, m0=M0, tol=tol,
                                            max_iter=MAX_ITER)
            rk = eo_rel_residual(thE, thO, bb, k.x)
            rp = eo_rel_residual(thE, thO, bb, p.x)
            dx = (k.x - p.x).abs().max().item()
            check(torch.equal(k.converged, p.converged) and bool(k.converged.all()),
                  f"{label}: flags")
            check(dx <= 2e-4, f"{label}: x differs by {dx}")
            check(bool((rk < 2 * tol).all()) and bool((rp < 2 * tol).all()),
                  f"{label}: true residual kernel {rk.max().item()} plain "
                  f"{rp.max().item()}")
            errs["cg_solve_eo"] = max(errs["cg_solve_eo"], dx)
            same = ""
            if against_global:
                gx, gi, grho, gbn = k6_global(ue, uo, bb, x0, tol)
                check(torch.equal(k.x, gx) and torch.equal(k.iters, gi)
                      and torch.equal(k.converged, tr._converged(grho, gbn, tol)),
                      f"{label}: the shared path differs from the global path")
                same = "; x, iterations and flags equal the global path's bit for bit"
            print(f"phase 2: {label}: f64 true residual kernel {rk.max().item():.3e} "
                  f"plain {rp.max().item():.3e}; max |x - x_plain| {dx:.3e}; "
                  f"iterations kernel {k.iters.flatten()[:8].tolist()} plain "
                  f"{p.iters.flatten()[:8].tolist()}{same}", flush=True)
        k = cg_eo.cg_solve_eo(ue, uo, bb, bb, m0=M0, tol=LOOSE_TOL, max_iter=3)
        p = cg_eo.cg_solve_eo_reference(ue, uo, bb, bb, m0=M0, tol=LOOSE_TOL,
                                        max_iter=3)
        check(not bool(k.converged.any()) and not bool(p.converged.any())
              and bool(torch.isfinite(k.x).all()) and bool(torch.isfinite(p.x).all()),
              f"K6 starved C={C}: converged or non-finite")
        print(f"phase 2: K6 starved max_iter=3 C={C} B={B}: unconverged and "
              f"finite in both; iterations kernel {k.iters.flatten()[:4].tolist()}",
              flush=True)

    def k5_check(thE, thO, b, C):
        """K5 near the critical mass against its twin (C: the label of its
        shape), on the path and blocks a chain its size takes."""
        nx, nth = thE.shape[-2:]
        phi2 = torch.randn(b.shape, generator=gen, device=dev)
        FE, FO = tr.ratio_force(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB, beta=BETA)
        RE, RO = tr.ratio_force_reference(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB,
                                          beta=BETA)
        path = tr.cg_path_name(nx, nth, thE.shape[0], _cuda.sm_count(dev), False, True)
        errs["ratio_force"] = max(errs["ratio_force"], force_err(
            FE, FO, RE, RO, f"K5 m0={M0_HB} m1={M1_HB} C={C} (path: {path})"))

    errs = dict.fromkeys(("force_step", "solve_fused", "solve_fused_mxu", "ratio_force",
                          "solve_refined", "solve_f64_cg_fallback",
                          "cg_solve_eo", "residual_f64"), 0.0)
    RHS = {C_MAIN: 8, 1: 1, 3: 2}      # right-hand sides per configuration
    # the main path's shapes, and a small non-square lattice
    for nx, nt, C in ((NX, NT, C_MAIN), (NX, NT, 1), (8, 12, 3)):
        thE, thO, b = inputs(C, nx, nt)
        B = RHS[C]
        ue, uo = SchwingerModel.fermion_links(thE, thO)
        bb = torch.randn((C, B, 2, 2, nx, nt // 2), generator=gen, device=dev)
        C = f"{C} at {nx}x{nt}"

        k6_checks(thE, thO, ue, uo, bb, C)

        k9_checks(thE, thO, bb, C)

        k, p = k1_k2_checks(thE, thO, b, C)

        # K10 against its twin and against K2 (k, p: K2 and its twin above)
        k10 = tr.solve_fused_mxu(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
                                 max_iter=MAX_ITER)
        p10 = tr.solve_fused_mxu_reference(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
                                           max_iter=MAX_ITER)
        r10 = rel_residual(thE, thO, b, k10.x)
        dx_twin = (k10.x - p10.x).abs().max().item()
        dx_k2 = (k10.x - k.x).abs().max().item()
        check(torch.equal(k10.converged, p10.converged)
              and torch.equal(k10.converged, k.converged) and bool(k10.converged.all()),
              f"K10 C={C}: flags")
        check(torch.equal(k10.iters, k.iters) and torch.equal(k10.iters, p10.iters),
              f"K10 C={C}: iterations K10 {k10.iters.tolist()} K2 {k.iters.tolist()} "
              f"twin {p10.iters.tolist()}")
        check(dx_twin <= 2e-4 and torch.equal(k10.x, k.x),
              f"K10 C={C}: x differs by {dx_twin} from its twin, {dx_k2} from K2")
        check(bool((r10 < 2 * LOOSE_TOL).all()),
              f"K10 C={C}: true residual {r10.max().item()}")
        errs["solve_fused_mxu"] = max(errs["solve_fused_mxu"], dx_twin)
        print(f"phase 2: K10 tol={LOOSE_TOL:g} C={C}: flags and iterations equal to "
              f"K2's and the twin's ({k10.iters[:8].tolist()}); f64 true residual "
              f"{r10.max().item():.3e}; max |x - x_twin| {dx_twin:.3e}; max |x - x_K2| "
              f"{dx_k2:.3e} (bit for bit: {torch.equal(k10.x, k.x)})", flush=True)
        # the shifts alone: 16 planes of this shape across 30 binades
        planes = (torch.randn((16, nx, nt // 2), generator=gen, device=dev)
                  * torch.exp2(torch.randint(-15, 16, (16, nx, nt // 2), generator=gen,
                                             device=dev).float()))
        sp, sm_ = tr.shift_x_mxu(planes)
        tp, tm = tr.shift_x_mxu_reference(planes)
        torch.cuda.synchronize()
        for got, want, twin, which in ((sp, torch.roll(planes, -1, dims=1), tp, "P+"),
                                      (sm_, torch.roll(planes, 1, dims=1), tm, "P-")):
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"K10 shift {which} C={C}: not torch.roll bit for bit")
            check(torch.equal(twin.view(torch.int32), want.view(torch.int32)),
                  f"K10 twin shift {which} C={C}: the f32 matmul is not exact")
        print(f"phase 2: K10 shifts at {nx}x{nt // 2}, 16 planes across 30 binades: "
              f"P+ a and P- a equal torch.roll bit for bit (tensor cores and twin)",
              flush=True)

        k5_check(thE, thO, b, C)

        k3_checks(thE, thO, b, C)

    # K3 at the sizes that take its other paths: all resident, odd extents,
    # a lattice too large for one block's shared memory (a cluster of
    # blocks), and one that no cluster divides (the global scratch); K1 and
    # K2 there too (one block a chain, 2 blocks a chain for the force alone,
    # and the global scratch with the CG)
    # K6 and K5 there too (K6 with B=8 at C=32, else 2; its shared path, with
    # odd extents, and its global path; K5 on 4 and 8 blocks a chain, and
    # the global path)
    for nx, nt, C in ((32, 32, C_MAIN), (20, 34, 2), (128, 128, 2), (126, 128, 2)):
        thE, thO, b = inputs(C, nx, nt)
        k3_checks(thE, thO, b, f"{C} at {nx}x{nt}")
        k, _ = k1_k2_checks(thE, thO, b, f"{C} at {nx}x{nt}")
        k10_vs_k2(thE, thO, b, k, f"{C} at {nx}x{nt}")
        print(f"phase 2: K10 C={C} at {nx}x{nt} (path: {tr.cg_path_name(nx, nt // 2, C, sms)}): "
              f"flags, iterations and x bit for bit K2's", flush=True)
        ue, uo = SchwingerModel.fermion_links(thE, thO)
        bb = torch.randn((C, 8 if C == C_MAIN else 2, 2, 2, nx, nt // 2), generator=gen,
                         device=dev)
        k6_checks(thE, thO, ue, uo, bb, f"{C} at {nx}x{nt}")
        k9_checks(thE, thO, bb, f"{C} at {nx}x{nt}")
        k5_check(thE, thO, b, f"{C} at {nx}x{nt}")
    # K5 on one block a chain (C=128) and on 8 (128x128 C=8)
    for nx, nt, C in ((NX, NT, 4 * C_MAIN), (128, 128, 8)):
        k5_check(*inputs(C, nx, nt), f"{C} at {nx}x{nt}")
    # K6 without guards: a zero right-hand side among random ones runs one
    # iteration to a NaN x, unconverged, as its twin (and the Pallas loop)
    # does; every other entry as if alone
    thE, thO, _ = inputs(2)
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    bb = torch.randn((2, 4, 2, 2, NX, NT // 2), generator=gen, device=dev)
    bb[1, 2] = 0
    zero = torch.zeros_like(bb)
    k = cg_eo.cg_solve_eo(ue, uo, bb, zero, m0=M0, tol=1e-5, max_iter=MAX_ITER)
    p = cg_eo.cg_solve_eo_reference(ue, uo, bb, zero, m0=M0, tol=1e-5, max_iter=MAX_ITER)
    g = k6_global(ue, uo, bb, zero, 1e-5)

    def finite(x):
        return torch.isfinite(x).flatten(2).all(dim=2)

    want = torch.ones((2, 4), dtype=torch.bool, device=dev)
    want[1, 2] = False
    check(torch.equal(k.iters, p.iters) and torch.equal(k.iters, g[1])
          and int(k.iters[1, 2]) == 1, f"K6 zero entry: iterations kernel "
          f"{k.iters.tolist()} plain {p.iters.tolist()} global {g[1].tolist()}")
    check(torch.equal(k.converged, want) and torch.equal(p.converged, want),
          f"K6 zero entry: flags kernel {k.converged.tolist()} plain {p.converged.tolist()}")
    check(torch.equal(finite(k.x), want) and torch.equal(finite(p.x), want)
          and torch.equal(finite(g[0]), want), "K6 zero entry: the non-finite pattern")
    check(torch.equal(k.x[want], g[0][want]), "K6 zero entry: the finite entries differ "
          "from the global path")
    print(f"phase 2: K6 zero entry at {NX}x{NT} C=2 B=4 (path: {k6_path(NX, NT // 2, 8)[0]}): "
          f"iterations {k.iters.tolist()} equal the twin's and the global path's, flags "
          f"{k.converged.tolist()} the twin's, x non-finite only in the zero entry (all "
          f"three), the other entries bit for bit the global path's", flush=True)

    # K7 and K8 on the blocks of a mesh of shards
    halo_errs, halo_times, halo_bounds, halo_detail = halo_kernel_checks(dev, gen, card)
    errs.update(halo_errs)

    # the refined dirac_inverse (K6 + K9 + K4) against the plain twins on
    # the CPU, one configuration, same noise
    lattice = LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")
    refined_model = SchwingerModel(lattice=lattice, hmc=HMCParams(
        beta=BETA, m0=M0, even_odd=True,
        cg=CGParams(tol=1e-10, max_iter=MAX_ITER, refine=True, inner_tol=1e-5)))
    theta = (2.0 * torch.rand((2, 2, NX, NT), generator=gen, device=dev) - 1.0) * math.pi
    zs = obs.condensate_noise(0, 0, 2, theta.shape, 4, dev)

    def estimates(theta, zs):
        w, res = refined_model.dirac_inverse(theta, zs)
        est = (zs.to(torch.complex128).conj() * w.to(torch.complex128)).real
        return est.sum(dim=(2, 3, 4)).cpu(), res.converged.cpu(), res.iters.cpu()

    ek, ck, ik = estimates(theta, zs)
    ep, cp, ip = estimates(theta.cpu(), zs.cpu())
    rel = ((ek - ep).abs() / ep.abs()).max().item()
    check(bool(ck.all()) and bool(cp.all()), "refined dirac_inverse: a flag is false")
    check(rel <= 1e-6, f"refined dirac_inverse: estimates differ by {rel} relative")
    print(f"phase 2: refined dirac_inverse {NX}x{NT} C=2 B=4, kernels vs plain "
          f"twins on the CPU: every flag true, max rel. difference of Re(z^+ w) "
          f"{rel:.3e}; iterations kernels {ik.tolist()} plain {ip.tolist()}",
          flush=True)

    # timings at C=32, kernel and plain twin in turns
    thE, thO, b = inputs(C_MAIN)
    phi2 = torch.randn(b.shape, generator=gen, device=dev)
    ue, uo = SchwingerModel.fermion_links(thE, thO)
    bb = torch.randn((C_MAIN, RHS[C_MAIN], 2, 2, NX, NT // 2), generator=gen,
                     device=dev)
    zero, x64 = torch.zeros_like(bb), torch.randn(bb.shape, generator=gen,
                                                  device=dev, dtype=torch.float64)
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
        "solve_fused_mxu": in_turns(
            lambda: tr.solve_fused_mxu_reference(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
                                                 max_iter=MAX_ITER),
            lambda: tr.solve_fused_mxu(thE, thO, b, b, m0=M0, tol=LOOSE_TOL,
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
        # the refinement's inner solve: tol 1e-5 from 0, B=8
        "cg_solve_eo": in_turns(
            lambda: cg_eo.cg_solve_eo_reference(ue, uo, bb, zero, m0=M0, tol=1e-5,
                                                max_iter=MAX_ITER),
            lambda: cg_eo.cg_solve_eo(ue, uo, bb, zero, m0=M0, tol=1e-5,
                                      max_iter=MAX_ITER), 2, 20),
        "residual_f64": in_turns(
            lambda: rs.residual_f64_reference(thE, thO, bb, x64, m0=M0),
            lambda: rs.residual_f64(thE, thO, bb, x64, m0=M0), 20, 200),
    }
    # Bounds at the timed shape. Bytes: every input read once and every
    # output written once, per chain (or entry) in units of V2 = Nx Nt/2
    # sites: the angles of both parities 16 V2 bytes, an f32 spinor or the
    # forces of both parities 16 V2, an f64 spinor 32 V2, one
    # configuration's planar links 32 V2. Operations: the F_* counts above,
    # with the CG iterations these inputs needed, summed over the chains;
    # K3's and K4's f64 part is counted as the two true residuals no solve
    # can do without (entry and exit), a lower estimate.
    V2 = NX * NT // 2
    E = C_MAIN * RHS[C_MAIN]
    kw = dict(m0=M0, tol=LOOSE_TOL, max_iter=MAX_ITER)
    k1_solved = {g: tr.force_step(thE, thO, b, b, beta=BETA, with_gauge=g, **kw).iters
                 for g in (True, False)}
    k2_iters = tr.solve_fused(thE, thO, b, b, **kw).iters
    it_k1 = k1_solved[True].sum().item()
    it_k2 = k2_iters.sum().item()
    it_k3 = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10).iters.sum().item()
    it_k4 = (rs.solve_f64_cg_fallback(thE, thO, b, starved, m0=M0, tol=1e-10).iters
             - starved.iters).sum().item()
    k6_iters = cg_eo.cg_solve_eo(ue, uo, bb, zero, m0=M0, tol=1e-5, max_iter=MAX_ITER).iters
    it_k6 = k6_iters.sum().item()
    it_k10 = tr.solve_fused_mxu(thE, thO, b, b, **kw).iters.sum().item()
    check(it_k10 == it_k2, f"K10 ran {it_k10} iterations on the timed inputs, K2 {it_k2}")
    # K10's products, one normal apply per iteration and one for the first
    # residual: as the kernel issues them, 4 stages of (Nx/8)(Nth/4) items
    # of 12 m8n8k4 (2 products, 2 plane pairs, the band's 3 k-steps; 512
    # flops each); the dense product's count beside it, 32 shifted planes of
    # 2 Nx Nx Nth flops (a dense product's, all Nx/4 k-steps)
    mxu_items = -(-NX // 8) * -(-(NT // 2) // 4)
    mxu_k_steps = len(tr.mxu_band_tiles(+1, 0, NX))
    mxu_ops = 4 * mxu_items * 2 * 2 * mxu_k_steps * 512 * (it_k2 + C_MAIN)
    mxu_ops_dense = 32 * 2 * NX * NX * (NT // 2) * (it_k2 + C_MAIN)
    k2_vs_k10 = in_turns(
        lambda: tr.solve_fused(thE, thO, b, b, **kw),
        lambda: tr.solve_fused_mxu(thE, thO, b, b, **kw), 20, 20)
    print(f"phase 2: K10 against K2 in turns at {NX}x{NT} C={C_MAIN} ({card}): K10 "
          f"{k2_vs_k10[0]:.4f} ms, K2 {k2_vs_k10[1]:.4f} ms, K2 / K10 = "
          f"{k2_vs_k10[1] / k2_vs_k10[0]:.3f}; {it_k2} iterations summed over the chains",
          flush=True)
    force_ops = F_LINKS + F_DHAT + F_HOP + F_FORCE
    k1_bounds = {
        "with_solve=False,with_gauge=True": roofline(
            C_MAIN * 48 * V2, C_MAIN * V2 * (force_ops + F_PLAQ)),
        "with_solve=False,with_gauge=False": roofline(
            C_MAIN * 48 * V2, C_MAIN * V2 * force_ops),
        "with_solve=True,with_gauge=True": roofline(
            C_MAIN * 80 * V2, V2 * (C_MAIN * (force_ops + F_PLAQ + F_NORMAL)
                                    + F_CG_ITER * it_k1)),
        "with_solve=True,with_gauge=False": roofline(
            C_MAIN * 80 * V2, V2 * (C_MAIN * (force_ops + F_NORMAL)
                                    + F_CG_ITER * it_k1)),
    }
    bounds = {
        "force_step": k1_bounds["with_solve=False,with_gauge=True"],
        "solve_fused": roofline(C_MAIN * 64 * V2, V2 * (
            C_MAIN * (F_LINKS + F_NORMAL) + F_CG_ITER * it_k2)),
        "solve_fused_mxu": roofline(C_MAIN * 64 * V2, V2 * (
            C_MAIN * (F_LINKS + F_NORMAL) + F_CG_ITER * it_k2), 0.0, mxu_ops),
        "solve_fused_mxu dense": roofline(C_MAIN * 64 * V2, V2 * (
            C_MAIN * (F_LINKS + F_NORMAL) + F_CG_ITER * it_k2), 0.0, mxu_ops_dense),
        "ratio_force": roofline(C_MAIN * 64 * V2, C_MAIN * V2 * (
            F_LINKS + F_DHAT + 2 * F_HOP + 2 * F_FORCE + F_PLAQ)),
        "solve_refined": roofline(C_MAIN * 96 * V2, V2 * F_CG_ITER * it_k3,
                               C_MAIN * V2 * (F_LINKS + 2 * F_NORMAL)),
        "solve_f64_cg_fallback": roofline(C_MAIN * 112 * V2, 0.0, V2 * (
            C_MAIN * (F_LINKS + 2 * F_NORMAL) + F_CG_ITER * it_k4)),
        "cg_solve_eo": roofline(V2 * (E * 48 + C_MAIN * 32), V2 * (
            E * F_NORMAL + F_CG_ITER * it_k6)),
        "residual_f64": roofline(V2 * (E * 80 + C_MAIN * 16), 0.0, V2 * (
            E * (F_NORMAL + 8) + C_MAIN * F_LINKS)),
    }
    its = {"force_step with_solve=True": it_k1, "solve_fused": it_k2,
           "solve_fused_mxu": it_k10,
           "solve_refined": it_k3, "solve_f64_cg_fallback": it_k4,
           "cg_solve_eo": it_k6}
    print(f"phase 2: CG iterations of the timed inputs, summed over the chains or "
          f"entries: {its}", flush=True)
    print(f"phase 2: K10's tensor-core products at {NX}x{NT} C={C_MAIN}: {mxu_k_steps} k-steps "
          f"of {(NX + 3) // 4} a row tile, {mxu_ops:.4g} flops issued ({mxu_ops_dense:.4g} "
          f"dense); bound with the dense count {bounds['solve_fused_mxu dense'][0]:.5f} ms",
          flush=True)
    for k_name, (ms, plain_ms, dev_ms), (b_ms, b_by) in [
            *((k, times[k], bounds[k]) for k in times),
            *(("force_step " + v, k1_times[v], k1_bounds[v]) for v in k1_times)]:
        print(f"phase 2: time at {NX}x{NT} C={C_MAIN} ({card}): {k_name} kernel "
              f"{ms:.4f} ms ({dev_ms:.4f} ms queued behind a spin), plain twin "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
              f"({100 * b_ms / ms:.2f}% of the roofline)", flush=True)
    # K1 and K2 in detail: the path the lattice size and chain count take
    # (ops/traj.cg_path) and, with a CG, microseconds per iteration of the
    # slowest chain
    k12_detail = {"solve_fused": dict(
        path=tr.cg_path_name(NX, NT // 2, C_MAIN, sms),
        us_per_iteration=1e3 * times["solve_fused"][0] / k2_iters.max().item())}
    for v in k1_times:
        s_, g_ = (part.endswith("True") for part in v.split(","))
        k12_detail["force_step " + v] = dict(path=tr.cg_path_name(NX, NT // 2, C_MAIN, sms,
                                                                  s_, g_))
        if s_:
            k12_detail["force_step " + v]["us_per_iteration"] = (
                1e3 * k1_times[v][0] / k1_solved[g_].max().item())
    # K6 on its path: the entries run in waves of the card's multiprocessors
    # times the blocks each runs at once, so per iteration of the slowest
    # entry of a wave; K5's blocks a chain
    k6_path_name, k6_per_sm = k6_path(NX, NT // 2, E)
    k6_waves = -(-E // (sms * k6_per_sm))
    k12_detail["cg_solve_eo"] = dict(
        path=k6_path_name, blocks_per_sm=k6_per_sm, waves=k6_waves,
        us_per_iteration=1e3 * times["cg_solve_eo"][0] / (k6_waves * k6_iters.max().item()))
    k12_detail["ratio_force"] = dict(
        path=tr.cg_path_name(NX, NT // 2, C_MAIN, sms, False, True),
        blocks_a_chain=tr.ratio_force_path(NX, NT // 2, C_MAIN, sms)[1])
    # K9's route (slabs a configuration, right-hand sides a block) and K10's
    # path, microseconds per iteration of the slowest chain and k-steps
    k9_route = rs.residual_path(NX, NT // 2, C_MAIN, RHS[C_MAIN], sms)
    k12_detail["residual_f64"] = dict(
        path=rs.residual_path_name(NX, NT // 2, C_MAIN, RHS[C_MAIN], sms),
        slabs_a_configuration=k9_route[1], right_hand_sides_a_block=k9_route[2])
    k12_detail["solve_fused_mxu"] = dict(
        path=tr.cg_path_name(NX, NT // 2, C_MAIN, sms),
        us_per_iteration=1e3 * times["solve_fused_mxu"][0] / k2_iters.max().item(),
        k_steps_per_row_tile=mxu_k_steps, k_steps_per_row_tile_dense=(NX + 3) // 4,
        bound_ms_dense_products=bounds["solve_fused_mxu dense"][0])
    for k_name, d in k12_detail.items():
        us = (f", {d['us_per_iteration']:.3f} us per iteration of the slowest chain"
              if "us_per_iteration" in d else "")
        if "waves" in d:
            us += (f" (entry) of a wave; B={RHS[C_MAIN]}, {d['blocks_per_sm']} block(s) an "
                   f"SM, {d['waves']} waves")
        print(f"phase 2: {k_name} at {NX}x{NT} C={C_MAIN} ({card}): path {d['path']}{us}",
              flush=True)
    # K4's entry after a solve that converged every chain, as the restart
    # refinement meets it: it reads the flags and copies the solution through
    clocks = torch.zeros((C_MAIN, 4), dtype=torch.int64, device=dev)
    done = rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10, clocks=clocks)
    check(bool(done.converged.all()), "K3 left a chain of the timed inputs unconverged")
    k4_pass_ms = timed(lambda: rs.solve_f64_cg_fallback(thE, thO, b, done, m0=M0,
                                                        tol=1e-10), 200)
    print(f"phase 2: time at {NX}x{NT} C={C_MAIN} ({card}): solve_f64_cg_fallback after a "
          f"converged solve (the pass-through of the restart refinement) "
          f"{k4_pass_ms:.4f} ms", flush=True)
    # K3 in detail: per iteration of its slowest chain, the share of its
    # clock cycles in the f64 true residuals (the kernel's own counters),
    # with the fallback on (as the main path calls it), and at C=128
    k3_ms = times["solve_refined"][0]
    k3_path = rs.ru_path_name(NX, NT // 2, C_MAIN, _cuda.sm_count(dev))
    k3_us_iter = 1e3 * k3_ms / done.iters.max().item()
    k3_f64_share = (clocks[:, 1].double() / clocks[:, 0].double()).mean().item()
    k3_fb_ms = timed(lambda: rs.solve_refined(thE, thO, b, b, m0=M0, tol=1e-10,
                                              fallback=True), 20)
    thE4, thO4, b4 = inputs(4 * C_MAIN)
    k3_c128_ms = timed(lambda: rs.solve_refined(thE4, thO4, b4, b4, m0=M0, tol=1e-10), 20)
    it_c128 = rs.solve_refined(thE4, thO4, b4, b4, m0=M0, tol=1e-10).iters
    print(f"phase 2: K3 at {NX}x{NT} (path: {k3_path}; "
          f"{card}): C={C_MAIN} {k3_ms:.4f} ms, {k3_us_iter:.3f} us per iteration of the "
          f"slowest chain ({done.iters.max().item()} iterations), "
          f"{100 * k3_f64_share:.1f}% of its cycles in the f64 true residuals; with the "
          f"fallback on and every chain converged {k3_fb_ms:.4f} ms; C={4 * C_MAIN} "
          f"{k3_c128_ms:.4f} ms ({it_c128.sum().item()} iterations summed, "
          f"{it_c128.max().item()} in the slowest chain)", flush=True)
    times.update(halo_times)
    bounds.update(halo_bounds)

    # K3's MRE branch on every path, against its twin, and timed at K = 4
    # against K = 1 in turns
    def mre_model(nx, nt):
        return SchwingerModel(
            lattice=LatticeParams(Nx=nx, Nt=nt, real_dtype="float32"),
            hmc=HMCParams(beta=BETA, m0=M0, md_steps=40, trajectory_length=1.0,
                          even_odd=True, mre_history=4,
                          cg=CGParams(tol=1e-10, max_iter=MAX_ITER, refine=True,
                                      inner_tol=1e-5)))
    mre_ms = mre_kernel_checks(rs, hp, mre_model, dev, gen, card, sms, inputs,
                               rel_residual)

    # trajectories through the kernels against the plain twins on the CPU

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

    # one trajectory on the 2x2 mesh under each contract: the halo kernels
    # against their twins on the CPU, and against the packed path
    mesh22 = lattice_mesh((2, 2))
    for label, hmc in (("refined", hmc_params()), ("loose", hmc_params(refine=False))):
        model = SchwingerModel(lattice=lattice, hmc=hmc)
        theta = (2.0 * torch.rand((4, 2, NX, NT), generator=gen, device=dev)
                 - 1.0) * math.pi
        pi, chi, r = hp.draw_chain_noise(model, 98, 0, 4, dev)
        step = make_sharded_traj_fn(model, mesh22)
        th_k, st_k = step.given_noise(theta, pi, chi, r)
        th_p, st_p = step.given_noise(theta.cpu(), pi.cpu(), chi.cpu(), r.cpu())
        th_m, st_m = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
        # the unpacked sampler without a mesh: its f32 solves are K6
        k6_before = cg_eo.cg_solve_eo.launches
        th_u, st_u = sampler.trajectory_given_noise(model, theta, pi, chi, r)
        n_k6 = cg_eo.cg_solve_eo.launches - k6_before
        ddH_u = (st_k.delta_H - st_u.delta_H).abs().max().item()
        dth_u = (torch.remainder(th_k - th_u + math.pi, 2 * math.pi)
                 - math.pi).abs().max().item()
        check(n_k6 >= hmc.md_steps and bool(st_u.cg_converged.all()),
              f"unpacked trajectory {label}: {n_k6} K6 launches")
        check(ddH_u < 5e-3 and dth_u < 2e-4 and torch.equal(st_k.accepted, st_u.accepted),
              f"mesh trajectory {label}: vs unpacked |ddH| {ddH_u}, |dtheta| {dth_u}")
        ddH = (st_k.delta_H.cpu() - st_p.delta_H).abs().max().item()
        dth = (th_k.cpu() - th_p).abs().max().item()
        ddH_m = (st_k.delta_H - st_m.delta_H).abs().max().item()
        # the packed path folds to [-pi, pi], the sampler wraps to [-pi, pi)
        dth_m = (torch.remainder(th_k - th_m + math.pi, 2 * math.pi)
                 - math.pi).abs().max().item()
        check(bool(st_k.cg_converged.all()) and bool(st_p.cg_converged.all())
              and bool(st_m.cg_converged.all()), f"mesh trajectory {label}: unconverged")
        check(ddH < 5e-3 and dth < 2e-4,
              f"mesh trajectory {label}: kernels vs twins |ddH| {ddH}, |dtheta| {dth}")
        check(ddH_m < 5e-3 and dth_m < 2e-4,
              f"mesh trajectory {label}: vs packed |ddH| {ddH_m}, |dtheta| {dth_m}")
        check(torch.equal(st_k.accepted.cpu(), st_p.accepted)
              and torch.equal(st_k.accepted, st_m.accepted),
              f"mesh trajectory {label}: accept decisions differ")
        print(f"phase 2: trajectory {label} {NX}x{NT} C=4 on 2x2 shards: kernels vs "
              f"twins on the CPU max |ddH| {ddH:.3e}, max |dtheta'| {dth:.3e}; vs the "
              f"packed path on the same noise max |ddH| {ddH_m:.3e}, max |dtheta'| "
              f"{dth_m:.3e}; vs the unpacked sampler without a mesh ({n_k6} K6 launches) "
              f"max |ddH| {ddH_u:.3e}, max |dtheta'| {dth_u:.3e}; dH "
              f"{st_k.delta_H.tolist()}; CG iterations mesh kernels "
              f"{st_k.cg_iters.tolist()} mesh twins {st_p.cg_iters.tolist()} packed "
              f"{st_m.cg_iters.tolist()}", flush=True)

    # ---- phase 3: the main paths ----
    counters = {"force_step": tr.force_step, "solve_fused": tr.solve_fused,
                "solve_fused_mxu": tr.solve_fused_mxu, "ratio_force": tr.ratio_force, "solve_refined": rs.solve_refined,
                "solve_f64_cg_fallback": rs.solve_f64_cg_fallback,
                "cg_solve_eo": cg_eo.cg_solve_eo, "residual_f64": rs.residual_f64,
                "halo_normal": halo.halo_normal, "halo_force": halo.halo_force,
                "chain_noise": noise.chain_noise, "z2_noise": noise.z2_noise}
    launches = dict.fromkeys(counters, 0)
    variants = {}

    def counted(label, uses, drive, unused=()):
        """Run drive() with every launch counter set to 0 just before and
        read just after; fail unless each kernel in `uses` (an entry point,
        or force_step's variant) was launched and none in `unused` was."""
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
        for k in unused:
            check(got[k] == 0, f"{label}: {k} launched {got[k]} times")
        for k, n in got.items():
            launches[k] += n
        for k, n in by_variant.items():
            variants[k] = variants.get(k, 0) + n
        return out, wall, got

    run = RunParams(n_therm=10, n_meas=20, n_steps=0, n_chains=C_MAIN, seed=0)
    # the packed refined paths: one K3 launch per solve, the fallback inside
    # it, and no launch of K4's own entry
    refined_k = ("solve_refined",)
    no_k4 = ("solve_f64_cg_fallback",)
    rates = {}

    def main_gates(label, res, wall, run=run):
        """The gates every main-path run passes; returns the measure phase's
        chain-trajectories per second."""
        check(res.all_converged and res.n_ill == 0, f"{label}: a solve did not converge")
        check(0.3 < res.acceptance_rate <= 1.0,
              f"{label}: acceptance {res.acceptance_rate}")
        check(0.0 < res.Ep < 1.0, f"{label}: <P> = {res.Ep}")
        check(bool(torch.isfinite(torch.as_tensor(res.theta)).all())
              and res.theta.shape == (C_MAIN, 2, NX, NT), f"{label}: final configuration")
        check(abs(res.exp_mdH_mean - 1.0) < 0.1,
              f"{label}: <exp(-dH)> {res.exp_mdH_mean}")
        meas = res.perf["spans"]["hmc.measure"]
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
        return meas["traj_per_s"]

    for label, hmc, uses in (
            ("refined demo md=10", hmc_params(),
             ("with_solve=False,with_gauge=True", "chain_noise", *refined_k)),
            ("(a) --no-cg-refine md=10", hmc_params(refine=False),
             ("with_solve=True,with_gauge=True", "solve_fused", "chain_noise")),
            ("(b) --hasenbusch-dm 0.4 md=10", hmc_params(hasenbusch_dm=0.4),
             ("with_solve=False,with_gauge=False", "ratio_force", "chain_noise",
              *refined_k)),
            ("(c) --integrator omelyan md=5", hmc_params(
                md_steps=5, integrator="omelyan"),
             ("with_solve=False,with_gauge=True", "chain_noise", *refined_k))):
        res, wall, got = counted(
            label, uses, lambda: run_hmc(lattice, hmc, run, device=dev),
            no_k4 if hmc.cg.refine else ())
        rates[label] = main_gates(label, res, wall)
        if hmc.cg.refine:
            n_traj = run.n_therm + run.n_meas
            print(f"phase 3: {label}: per batch trajectory "
                  f"{got['solve_refined'] / n_traj:g} K3 and "
                  f"{got['solve_f64_cg_fallback'] / n_traj:g} K4 launches; "
                  f"{res.cg_fallback_solves} of {got['solve_refined'] * C_MAIN} chain "
                  f"solves ran the fallback inside K3's launch", flush=True)

    # (t) the device program: replays against eager calls, the CLI on the
    # graph, graphed and eager in turns
    t_detail = device_program(counters, hmc_params, lattice, dev, card, cli, counted)

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

    stats, wall, _ = counted(
        "near-critical 32x32 beta=2 m0=-0.19 dm=0.4 md=26 tau=1", (
            "with_solve=False,with_gauge=False", "ratio_force", *refined_k),
        near_critical, no_k4)
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
          f"{(n_therm + n_meas) * C_MAIN / wall:.2f} chain-traj/s, "
          f"{wall / (n_therm + n_meas):.4f} s per batch trajectory, "
          f"{int(torch.stack([st.cg_fallbacks for st in stats]).sum())} chain solves "
          f"ran the fallback; card {card}", flush=True)

    # the measurement path: the condensate on the refined and loose demos
    N_NOISE = 8
    final_d = None

    def refined_measurement(model, theta, zs, reps=5):
        """One refined condensate measurement on given configurations, timed:
        ms per measurement by the host clock (with the noise given, and with
        its draw), and the ms of its K6 and K9 launches, each between CUDA
        events recorded around its call as the measurement issues it."""
        spans = {"cg": [], "residual": []}

        def evented(fn, key):
            def call(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                spans[key].append((e0, e1))
                return out
            return call
        timed_model = dataclasses.replace(model, eo_kernels=refine.EOKernels(
            evented(cg_eo.cg_solve_eo, "cg"), evented(rs.residual_f64, "residual"),
            rs.solve_f64_cg_fallback))
        obs.chiral_condensate_given_noise(timed_model, theta, zs)      # warm-up
        for v in spans.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            obs.chiral_condensate_given_noise(timed_model, theta, zs)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for i in range(reps):
            obs.chiral_condensate(model, theta, 1, i, N_NOISE)
        torch.cuda.synchronize()
        ms_noise = 1e3 * (time.perf_counter() - t0) / reps
        out = dict(ms=ms, ms_with_noise_draw=ms_noise)
        for key, name in (("cg", "K6"), ("residual", "K9")):
            out[name + "_ms"] = sum(a.elapsed_time(b) for a, b in spans[key]) / reps
            out[name + "_launches"] = len(spans[key]) / reps
            out[name + "_share"] = out[name + "_ms"] / ms
        print(f"phase 3: one refined condensate measurement at {NX}x{NT} C={C_MAIN} "
              f"B={N_NOISE} on (d)'s final configurations ({card}): {ms:.3f} ms with the "
              f"noise given, {ms_noise:.3f} ms with its draw; K6 {out['K6_ms']:.4f} ms in "
              f"{out['K6_launches']:g} launches ({100 * out['K6_share']:.1f}%), K9 "
              f"{out['K9_ms']:.4f} ms in {out['K9_launches']:g} launches "
              f"({100 * out['K9_share']:.1f}%)", flush=True)
        return out
    for label, hmc, uses, no_k9 in (
            ("(d) refined demo --condensate --n-noise 8", hmc_params(),
             ("with_solve=False,with_gauge=True", *refined_k, "cg_solve_eo",
              "residual_f64", "solve_f64_cg_fallback"), False),
            ("(e) --no-cg-refine --condensate --n-noise 8", hmc_params(refine=False),
             ("with_solve=True,with_gauge=True", "solve_fused", "cg_solve_eo"),
             True)):
        res, wall, got = counted(label, uses, lambda: run_hmc(
            lattice, hmc, run, device=dev, measure_condensate=True, n_noise=N_NOISE))
        rate = main_gates(label, res, wall)
        check(res.condensate_converged, f"{label}: a condensate solve did not converge")
        cc = res.chains["chiral_condensate"]
        check(cc.shape == (run.n_meas, C_MAIN) and bool(torch.isfinite(
            torch.as_tensor(cc)).all()), f"{label}: condensate chain {cc.shape}")
        if no_k9:
            check(got["residual_f64"] == 0, f"{label}: K9 launched {got['residual_f64']}"
                  " times on the loose contract")
        s = res.summary("chiral_condensate")
        n_solves = run.n_meas * C_MAIN * N_NOISE
        print(f"phase 3: {label}: chiral condensate {s['mean']:.10g} +- "
              f"{s['error']:.3g} (tau_int {s['tau_int']:.2f}); "
              f"{res.condensate_iters / run.n_meas:.1f} CG iterations per "
              f"measurement ({C_MAIN}x{N_NOISE} solves), "
              f"{res.condensate_iters / n_solves:.2f} per solve; measure phase "
              f"{rate:.2f} chain-traj/s with the condensate against "
              f"{rates['refined demo md=10' if not no_k9 else '(a) --no-cg-refine md=10']:.2f}"
              f" without it; card {card}", flush=True)
        if not no_k9:
            final_d = torch.as_tensor(res.theta, device=dev)
            twin_model = dataclasses.replace(
                SchwingerModel(lattice=lattice, hmc=hmc), eo_kernels=refine.PLAIN)
            zs = obs.condensate_noise(1, 0, C_MAIN, final_d.shape, N_NOISE, dev)
            vk = obs.chiral_condensate_given_noise(
                SchwingerModel(lattice=lattice, hmc=hmc), final_d, zs)
            vp = obs.chiral_condensate_given_noise(twin_model, final_d, zs)
            rel = ((vk.value - vp.value).abs() / vp.value.abs()).max().item()
            check(bool(vk.converged.all()) and bool(vp.converged.all()),
                  f"{label}: final-configuration condensate flags")
            check(rel <= 1e-6, f"{label}: kernels vs twins condensate rel {rel}")
            print(f"phase 3: {label}: final configurations, kernels vs plain twins "
                  f"on the card, same noise: max rel. difference of the condensate "
                  f"{rel:.3e}; chain 0: {vk.value[0].item():.10g} against "
                  f"{vp.value[0].item():.10g}", flush=True)
            meas_detail = refined_measurement(SchwingerModel(lattice=lattice, hmc=hmc),
                                              final_d, zs)

    # the meson correlators on (d)'s final configurations
    meson_model = SchwingerModel(lattice=lattice, hmc=hmc_params())
    mk, wall, _ = counted(f"mesons {NX}x{NT} C=2", ("cg_solve_eo", "residual_f64"),
                          lambda: obs.meson_correlators(meson_model, final_d[:2]))
    mp = obs.meson_correlators(dataclasses.replace(meson_model, eo_kernels=refine.PLAIN),
                               final_d[:2])
    check(bool(mk.converged.all()) and bool(mp.converged.all()), "mesons: flags")
    # rtol 1e-6 of each chain's correlator scale: the far-t values are
    # below the solves' 1e-10 absolute accuracy, where two solutions that
    # both meet the contract may differ relatively
    merr = {}
    for corr, k, p in (("C_PP", mk.C_PP, mp.C_PP), ("C_A0P", mk.C_A0P, mp.C_A0P)):
        scale = p.abs().amax(dim=1, keepdim=True)
        merr[corr] = ((k - p).abs() / scale).max().item()
        check(merr[corr] <= 1e-6, f"mesons: {corr} differs by {merr[corr]} of its scale")
    m_t = obs.pcac_mass(mk.C_PP, mk.C_A0P)
    t0, t1 = NT // 5, NT // 3
    plateau = [float(np.nanmean(m_t[c, t0:t1 + 1])) for c in range(2)]
    print(f"phase 3: mesons {NX}x{NT} C=2 on (d)'s final configurations in "
          f"{wall:.2f} s: kernels vs plain twins on the card, max |difference| / "
          f"scale {merr}; iterations {mk.iters.tolist()}; C_PP(t=0..3) "
          f"{mk.C_PP[0, :4].tolist()}; PCAC mass plateau (mean over t = {t0}..{t1}) "
          f"{plateau}; card {card}", flush=True)

    # (u) the measurement phase as a device program
    u_detail = measurement_program(counted, hmc_params, lattice, dev, card, final_d)

    # the lattice mesh: the demo on 2x2 shards under each contract
    packed_of = {"(f)": "refined demo md=10", "(g)": "(a) --no-cg-refine md=10"}
    run_mesh = dataclasses.replace(run, n_therm=4, n_meas=8)
    for label, hmc in (("(f) refined demo on 2x2 shards", hmc_params()),
                       ("(g) --no-cg-refine on 2x2 shards", hmc_params(refine=False))):
        res, wall, got = counted(label, ("halo_normal", "halo_force"), lambda: run_hmc(
            lattice, hmc, run_mesh, device=dev, mesh=mesh22))
        rate = main_gates(label, res, wall, run_mesh)
        for k in ("force_step", "solve_fused", "solve_refined", "solve_f64_cg_fallback",
                  "ratio_force"):
            check(got[k] == 0, f"{label}: {k} launched {got[k]} times on the mesh path")
        n_traj = run_mesh.n_therm + run_mesh.n_meas
        print(f"phase 3: {label}: per batch trajectory {got['halo_normal'] / n_traj:.1f} "
              f"K7 and {got['halo_force'] / n_traj:.1f} K8 launches; measure phase "
              f"{rate:.2f} chain-traj/s against {rates[packed_of[label[:3]]]:.2f} for the "
              f"packed path; card {card}", flush=True)

    # ---- K10's path, and the rest of the sampler ----
    # the tool, as a user calls it: K2 against K10 at 64x64 C=32 on 50
    # right-hand sides (it prints its two variant rows and the verdict row)
    rc, wall, got = counted("tools/bench_mxu_stencil", ("solve_fused", "solve_fused_mxu"),
                            lambda: bench_mxu_stencil.main(["--seed", "0"]))
    check(rc == 0, f"bench_mxu_stencil exited {rc}")
    print(f"phase 3: tools/bench_mxu_stencil at {NX}x{NT} C={C_MAIN}: exit 0 in "
          f"{wall:.2f} s, {got['solve_fused_mxu']} K10 and {got['solve_fused']} K2 "
          f"launches; card {card}", flush=True)

    solver_kernels = ("force_step", "solve_fused", "solve_fused_mxu", "ratio_force",
                      "solve_refined", "solve_f64_cg_fallback", "cg_solve_eo",
                      "residual_f64", "halo_normal", "halo_force")
    lattice64 = LatticeParams(Nx=NX, Nt=NT, real_dtype="float64")
    f64_cg = CGParams(tol=1e-10, max_iter=MAX_ITER, refine=False)
    p_exact = float(exact_quenched_plaquette(BETA))
    for label, lat, hmc, run_, mesh, uses, unused in (
            ("(h) refined demo --autotune --n-tune 8", lattice, hmc_params(),
             dataclasses.replace(run, n_therm=8, n_meas=20, autotune=True, n_tune=8), None,
             ("with_solve=False,with_gauge=True", *refined_k),
             ("cg_solve_eo", *no_k4)),
            ("(i) --quenched", lattice, hmc_params(quenched=True), run_mesh, None, (),
             solver_kernels),
            ("(j) refined demo --no-even-odd", lattice,
             dataclasses.replace(hmc_params(), even_odd=False), run_mesh, None, (),
             solver_kernels),
            ("(k) demo --dtype float64", lattice64,
             dataclasses.replace(hmc_params(), cg=f64_cg), run_mesh, None, (),
             solver_kernels),
            ("(l) --hasenbusch-dm 0.4 on 2x2 shards", lattice, hmc_params(hasenbusch_dm=0.4),
             run_mesh, mesh22, ("halo_normal",),
             ("halo_force", "force_step", "solve_fused", "solve_refined", "ratio_force",
              "cg_solve_eo"))):
        msgs = []
        res, wall, got = counted(label, uses, lambda: run_hmc(
            lat, hmc, run_, device=dev, mesh=mesh, progress=msgs.append))
        rate = main_gates(label, res, wall, run_)
        for k in unused:
            check(got[k] == 0, f"{label}: {k} launched {got[k]} times")
        extra = ""
        if run_.autotune:
            tune_lines = [m for m in msgs if m.startswith("autotune")]
            check(len(tune_lines) == 1 and res.hmc.md_steps >= 2 and res.tuned_eps > 0,
                  f"{label}: warm-up {tune_lines}, md_steps {res.hmc.md_steps}")
            extra = f"; {tune_lines[0]}"
        if hmc.quenched:
            check(res.cg_iters_total == 0, f"{label}: {res.cg_iters_total} CG iterations")
            check(res.Ep < p_exact + 0.05, f"{label}: <P> {res.Ep} above I1/I0 {p_exact}")
            extra = (f"; no solver launch; <P> {res.Ep:.6f} on its way to I1(4)/I0(4) = "
                     f"{p_exact:.6f} from a hot start")
        print(f"phase 3: {label}: measure phase {rate:.2f} chain-traj/s against "
              f"{rates['refined demo md=10']:.2f} for the packed refined demo{extra}; "
              f"card {card}", flush=True)

    # the plain CG of the unpacked sampler (runs (j) and (k)) replays one
    # iteration as a CUDA graph: the same bits as the eager loop
    g_model = SchwingerModel(
        lattice=LatticeParams(Nx=16, Nt=16, real_dtype="float64"),
        hmc=HMCParams(beta=2.0, m0=0.2, cg=CGParams(tol=1e-10, max_iter=MAX_ITER)))
    g_theta = (2.0 * torch.rand((4, 2, 16, 16), generator=gen, device=dev,
                                dtype=torch.float64) - 1.0) * math.pi
    g_b = torch.randn((4, 2, 16, 16), generator=gen, device=dev, dtype=torch.complex128)
    g_ms = {}
    replay = cg_mod._loop_graphed
    for loop_name, loop in (("graph", replay), ("eager", cg_mod._loop)):
        cg_mod._loop_graphed = loop
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g_res = g_model.solve_normal(g_theta, g_b)
            torch.cuda.synchronize()
            g_ms[loop_name] = (1e3 * (time.perf_counter() - t0), g_res)
        finally:
            cg_mod._loop_graphed = replay
    (t_g, res_g), (t_e, res_e) = g_ms["graph"], g_ms["eager"]
    check(torch.equal(res_g.x, res_e.x) and torch.equal(res_g.iters, res_e.iters)
          and bool(res_g.converged.all()), "the graph-replayed CG differs from the eager loop")
    print(f"phase 3: plain CG, full-D f64 16x16 C=4 tol 1e-10: graph replay equal to the "
          f"eager loop bit for bit (x, iterations {res_g.iters.tolist()}); {t_g:.2f} ms "
          f"against {t_e:.2f} ms eager (capture included); card {card}", flush=True)

    # (m) checkpoint and resume: 4 + 4, a checkpoint, 4 more, against 4 + 8
    def resumed():
        first = run_hmc(lattice, hmc_params(), dataclasses.replace(run_mesh, n_meas=4),
                        device=dev)
        path = Path(_cuda.BUILD_DIR) / "chip_smoke_resume.npz"
        checkpoint.save_checkpoint(
            str(path), theta=first.theta, key=first.key, traj_index=first.traj_index,
            lattice=lattice, hmc=first.hmc, run=run_mesh)
        state = checkpoint.load_checkpoint(str(path))
        path.unlink()
        rest = run_hmc(state["lattice"], state["hmc"],
                       dataclasses.replace(state["run"], n_therm=0, n_meas=4), device=dev,
                       initial_theta=state["theta"], start_traj_index=state["traj_index"])
        whole = run_hmc(lattice, hmc_params(), run_mesh, device=dev)
        return first, rest, whole

    (first, rest, whole), wall, _ = counted(
        "(m) refined demo, checkpoint and resume",
        ("with_solve=False,with_gauge=True", *refined_k), resumed, no_k4)
    check(rest.traj_index == whole.traj_index == 12, f"(m): counters {rest.traj_index}")
    check(np.array_equal(rest.theta, whole.theta)
          and np.array_equal(rest.chains["plaquette"], whole.chains["plaquette"][4:])
          and np.array_equal(first.chains["plaquette"], whole.chains["plaquette"][:4]),
          "(m): the resumed run differs from the unbroken one")
    main_gates("(m) the unbroken run", whole, wall, run_mesh)
    print(f"phase 3: (m) 4 + 4 trajectories, a checkpoint, 4 more from it: final "
          f"configuration and plaquette chain equal the unbroken 4 + 8 run's bit for "
          f"bit; card {card}", flush=True)

    # ---- the physics tools, at the small lattices of the goldens ----
    # (n) the crossvalidation's compare_point at 8x8 beta=2 m0=0.2 (Nt/2 = 4,
    # 32 even sites a chain), packed refined, C=8, from the golden point with
    # 50 thermalization trajectories; in a temporary working directory,
    # where the runner would dump an ill configuration
    golden = json.loads(Path(crossvalidate.GOLDEN_DEFAULT).read_text())
    ref = dict(next(r for r in golden if (r["Nx"], r["beta"], r["m0"]) == (8, 2.0, 0.2)),
               ntherm=50)
    cv_args = argparse.Namespace(
        device="cuda", dtype="float32", refine=True, even_odd=True, plaquette_only=True,
        nmeas=100, chains=8, seed=11, md_steps=None, integrator="leapfrog",
        hasenbusch_dm=None, n_sigma=2.0, n_sigma_acc=3.0)
    cwd = Path.cwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            row, wall, _ = counted(
                "(n) crossvalidate.compare_point 8x8 beta=2 m0=0.2 C=8",
                ("with_solve=False,with_gauge=True", *refined_k),
                lambda: crossvalidate.compare_point(ref, cv_args), no_k4)
        finally:
            os.chdir(cwd)
    check(row["n_ill"] == 0, f"(n): {row['n_ill']} ill configurations")
    check(all(math.isfinite(v) for v in row.values()
              if isinstance(v, float)), f"(n): a number of the row is not finite: {row}")
    check(abs(row["n_sigma_Ep"]) <= 4.0, f"(n): <P> {row['Ep']} is "
          f"{row['n_sigma_Ep']:.2f} sigma from the golden {row['ref_Ep']}")
    print(f"phase 3: (n) compare_point 8x8 beta=2 m0=0.2 C=8, 50 + 100 x 2 trajectories "
          f"in {wall:.2f} s (K1 path {tr.cg_path_name(8, 4, 8, sms, False, True)}, "
          f"K3 path {rs.ru_path_name(8, 4, 8, sms)}): <P> {row['Ep']:.6f} +- "
          f"{row['dEp']:.6f} against the golden {row['ref_Ep']:.6f} +- "
          f"{row['ref_dEp']:.6f} ({row['n_sigma_Ep']:.2f} sigma), acceptance "
          f"{row['acceptance']:.4f}, device {row['device']}", flush=True)

    # (o) the critical-mass tool at 16x16 beta=2, one mass, 4 measurement
    # blocks: the meson correlators of C=8 chains through K6 and K9
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "critical_mass.json"
        with np.errstate(all="ignore"):      # one mass: the fit is undefined
            rc, wall, _ = counted(
                "(o) critical_mass 16x16 beta=2 m0=-0.10",
                ("with_solve=False,with_gauge=True", *refined_k, "cg_solve_eo",
                 "residual_f64"),
                lambda: critical_mass.main(["--beta", "2", "--m0-list=-0.10",
                                            "--n-blocks", "4", "--json", str(out)]))
        summary = json.loads(out.read_text())
    check(rc == 0, f"(o): critical_mass exited {rc}")
    cm_row = summary["rows"][0]
    check(math.isfinite(cm_row["m_pcac"]) and cm_row["m_pcac"] > 0.0
          and cm_row["all_converged"], f"(o): {cm_row}")
    print(f"phase 3: (o) critical_mass 16x16 beta=2 m0=-0.10, C=8, 2 x 100 annealing + "
          f"200 + 4 x 5 trajectories and 4 correlator sets in {wall:.2f} s: m_PCAC "
          f"{cm_row['m_pcac']:.5f} +- {cm_row['err']:.5f}, acceptance "
          f"{cm_row['acceptance']}, all converged; card {card}", flush=True)

    # (p) the main path in two processes on this card, one chain group a
    # process: first in this process, the batch of C chains against its two
    # halves (each on the noise of its global chains), kernel by kernel;
    # then the CLI under torchrun against the CLI in one process
    p_res = chain_groups(hp, rs, tr, sms, card, lattice, hmc_params(), dev)
    for k, n in p_res["launches"].items():
        launches[k] += n

    # (q) the MRE path through the CLI, against the second-order forecast
    q_res = mre_path(cli, counted, card)
    # (r) the lattice mesh across processes against the one-process mesh
    for k, n in dist_mesh(card).items():
        launches[k] += n
    # (s) the bench tools at a short length (the counted runs add to the
    # kernels line's launches through `counted`)
    s_launches = bench_tools(counted, card, dev)
    check(all(s_launches.get(k, 0) > 0 for k in (
        "force_step", "solve_refined", "ratio_force", "cg_solve_eo", "halo_normal",
        "halo_force")), f"(s): a kernel of the tools was not launched: {s_launches}")
    print(f"phase 3: (s) the bench tools' launches: {s_launches}", flush=True)

    # where the time goes (--profile): three batch trajectories of each path
    # under torch.profiler
    def profile(label, model, mesh, graph=False):
        from schwingermodel_tpu_torch.hmc.program import TrajectoryProgram

        n = 3
        theta0 = torch.as_tensor(final_d)
        if graph:
            prog = TrajectoryProgram(model, theta0, 7, 0)
            prog.step()                                    # warm-up and capture
            prog.block.reset()
            step = prog.step
            iters = lambda: prog.block.cg_iters.double().mean().item() / n
        else:
            fn = (make_sharded_traj_fn(model, mesh) if mesh is not None else
                  lambda th, seed, i: hp.hmc_trajectory_packed(model, th, seed, i))
            state = {"theta": fn(theta0, 7, 0)[0], "i": 1}   # warm-up

            def step():
                state["theta"], state["st"] = fn(state["theta"], 7, state["i"])
                state["i"] += 1

            iters = lambda: state["st"].cg_iters.double().mean().item()
        ms, launches, busy, dev_ev = profile_window(step, n, label)
        top = ", ".join(f"{k[:48]} {1e-3 * t / n:.3f} ms ({c / n:g} launches)"
                        for k, c, t in dev_ev[:5])
        # K1, K2 and the noise kernel by their kernels' names, on every path
        for kname, names in (("K1", ("force_step_kernel", "force_shared_kernel")),
                             ("K2", ("solve_fused_kernel", "solve_shared_kernel")),
                             ("noise", ("noise_kernel",))):
            mine = [(c, t) for k, c, t in dev_ev if any(m in k for m in names)]
            top += (f"; {kname} {1e-3 * sum(t for _, t in mine) / n:.3f} ms "
                    f"({sum(c for c, _ in mine) / n:g} launches)")
        print(f"phase 3: profile {label}: {ms:.2f} ms per batch trajectory "
              f"of {C_MAIN} chains, {launches:.0f} device launches, "
              f"device busy {100 * busy:.1f}%, CG iterations per chain "
              f"{iters():.1f}; top by device time per "
              f"trajectory: {top}; card {card}", flush=True)

    if "--profile" in sys.argv[1:]:
        # the packed paths graphed (hmc/program.py) and eager in turns
        for label, hmc in (("packed refined demo", hmc_params()),
                           ("(a) packed loose", hmc_params(refine=False))):
            model = SchwingerModel(lattice=lattice, hmc=hmc)
            for graph in (True, False, False, True):
                profile(f"{label}, {'graphed' if graph else 'eager'}", model, None,
                        graph)
        for label, hmc, mesh in (
                ("(f) refined on 2x2 shards", hmc_params(), mesh22),
                ("(g) loose on 2x2 shards", hmc_params(refine=False), mesh22)):
            profile(label, SchwingerModel(lattice=lattice, hmc=hmc), mesh)
        # a refined condensate measurement, graphed (the measurement
        # program) and eager in turns
        from schwingermodel_tpu_torch.hmc.program import MeasurementProgram

        measure = condensate_measurement(SchwingerModel(lattice=lattice, hmc=hmc_params()),
                                         N_NOISE)
        static = torch.as_tensor(final_d).clone()
        mprog = MeasurementProgram(measure, static, 8)
        mprog.step()                                       # warm-up and capture
        eager_m = lambda: measure(static, 99)
        eager_m()
        m_prof = {}
        for label, step in (("graph", mprog.step), ("eager", eager_m), ("eager ", eager_m),
                            ("graph ", mprog.step)):
            ms, n_launch, busy, dev_ev = profile_window(step, 3, f"measurement {label}")
            check(any("z2_kernel" in k for k, _, _ in dev_ev),
                  f"profile measurement {label}: the Z2 mode missing")
            m_prof.setdefault(label.strip(), []).append((ms, n_launch, busy))
            top = ", ".join(f"{k[:40]} {1e-3 * t / 3:.3f} ms ({c / 3:g})"
                            for k, c, t in dev_ev[:4])
            print(f"phase 3: profile a refined condensate measurement at {NX}x{NT} "
                  f"C={C_MAIN}, {N_NOISE} vectors, {label.strip()}: {ms:.3f} ms, "
                  f"{n_launch:.0f} device launches, device busy {100 * busy:.1f}%; top "
                  f"by device time: {top}; card {card}", flush=True)
        u_detail["profile"] = {k: {"ms": float(np.mean([r[0] for r in v])),
                                   "launches": float(np.mean([r[1] for r in v])),
                                   "busy_share": float(np.mean([r[2] for r in v]))}
                               for k, v in m_prof.items()}
        # K6 as the condensate calls it (B=8) and K5 as the Hasenbusch
        # force does, at 64x64 C=32: their kernels by name
        thE, thO, b = inputs(C_MAIN)
        ue, uo = SchwingerModel.fermion_links(thE, thO)
        bb = torch.randn((C_MAIN, RHS[C_MAIN], 2, 2, NX, NT // 2), generator=gen,
                         device=dev)
        phi2 = torch.randn(b.shape, generator=gen, device=dev)
        zero = torch.zeros_like(bb)

        def k6_k5():
            cg_eo.cg_solve_eo(ue, uo, bb, zero, m0=M0, tol=1e-5, max_iter=MAX_ITER)
            tr.ratio_force(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB, beta=BETA)

        k6_k5()
        _, _, _, dev_ev = profile_window(k6_k5, 5, "K6 and K5")
        names = {k: c for k, c, _ in dev_ev
                 if "cg_eo" in k or "force_shared_kernel" in k}
        check(any("cg_eo_shared_kernel" in k for k in names)
              and any("force_shared_kernel" in k for k in names),
              f"profile: K6's or K5's shared kernel missing from {names}")
        print(f"phase 3: profile K6 (C={C_MAIN} B={RHS[C_MAIN]}) and K5 (C={C_MAIN}, "
              f"{tr.ratio_force_path(NX, NT // 2, C_MAIN, sms)[1]} blocks a chain) at "
              f"{NX}x{NT}: device kernels {names}", flush=True)

    # ---- phase 4: report ----
    replaces = {
        "force_step": ("csrc/force_step.cu", "schwingermodel_tpu/ops/pallas_traj.py:339"),
        "solve_fused": ("csrc/solve_fused.cu", "schwingermodel_tpu/ops/pallas_traj.py:532"),
        "solve_fused_mxu": ("csrc/solve_mxu.cu",
                            "schwingermodel_tpu/tools/bench_mxu_stencil.py:54"),
        "ratio_force": ("csrc/ratio_force.cu", "schwingermodel_tpu/ops/pallas_traj.py:465"),
        "solve_refined": ("csrc/solve_ru.cu", "schwingermodel_tpu/ops/pallas_df.py:402"),
        "solve_f64_cg_fallback": ("csrc/cg_fallback.cu",
                                  "schwingermodel_tpu/ops/pallas_df.py:674"),
        "cg_solve_eo": ("csrc/cg_eo.cu", "schwingermodel_tpu/ops/pallas_eo.py:208"),
        "residual_f64": ("csrc/residual.cu", "schwingermodel_tpu/ops/pallas_df.py:145"),
        "halo_normal": ("csrc/halo_normal.cu", "schwingermodel_tpu/ops/pallas_halo.py:48"),
        "halo_force": ("csrc/halo_force.cu", "schwingermodel_tpu/ops/pallas_halo.py:178"),
        # jax.random inside the jitted trajectory (not a Pallas kernel)
        "chain_noise": ("csrc/noise.cu", "schwingermodel_tpu/hmc/packed.py:485"),
        # the noise kernel's Z2 mode: jax.random inside the jitted
        # measurement's condensate (not a Pallas kernel)
        "z2_noise": ("csrc/noise.cu", "schwingermodel_tpu/observables.py:53"),
    }
    errs["chain_noise"] = noise_err
    times["chain_noise"] = noise_times
    bounds["chain_noise"] = noise_bound
    errs["z2_noise"] = u_detail["z2"]["max_abs_err"]
    times["z2_noise"] = u_detail["z2"]["times"]
    bounds["z2_noise"] = u_detail["z2"]["bound"]
    library = {"chain_noise": noise_library_ms, "z2_noise": u_detail["z2"]["library_ms"]}
    kernels = [{"name": k, "route": "cuda",
                "source": "schwingermodel_tpu_torch/" + src, "replaces": rep,
                "launches": launches[k], "max_abs_err": errs[k],
                "ms": times[k][0], "plain_ms": times[k][1],
                # the kernel's calls queued behind a spin of the card, so
                # that the host's launch cost is left out
                "device_ms": times[k][2],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                # no single PyTorch call computes a CG solve to a stop rule
                # (with or without its shifts as products), a fused force
                # step, an f64 true residual or a halo stencil; the noise
                # kernel's is torch.randn of as many values, its Z2 mode's
                # torch.randint
                "library_ms": library.get(k)}
               for k, (src, rep) in replaces.items()]
    kernels[0]["launches_by_variant"] = variants
    kernels[0]["ms_by_variant"] = {v: t[0] for v, t in k1_times.items()}
    kernels[0]["plain_ms_by_variant"] = {v: t[1] for v, t in k1_times.items()}
    kernels[0]["device_ms_by_variant"] = {v: t[2] for v, t in k1_times.items()}
    kernels[0]["bound_ms_by_variant"] = {v: t[0] for v, t in k1_bounds.items()}
    kernels[0]["path_by_variant"] = {v: k12_detail["force_step " + v]["path"]
                                     for v in k1_times}
    kernels[0]["us_per_iteration_by_variant"] = {
        v: k12_detail["force_step " + v]["us_per_iteration"] for v in k1_times
        if "us_per_iteration" in k12_detail["force_step " + v]}
    # K6a and K6b are one kernel
    by_name = {e["name"]: e for e in kernels}
    by_name["cg_solve_eo"]["also_replaces"] = "schwingermodel_tpu/ops/pallas_eo.py:328"
    by_name["solve_f64_cg_fallback"]["ms_pass_through"] = k4_pass_ms
    by_name["solve_refined"].update(
        path=k3_path, us_per_iteration=k3_us_iter,
        f64_residual_share=k3_f64_share, ms_with_fallback_on=k3_fb_ms,
        ms_at_4x_chains=k3_c128_ms,
        # the MRE branch (K = 4) on a trajectory's action solve, in turns with
        # K = 1, and its launches on the MRE path (q)
        ms_mre4=mre_ms[0], ms_k1_in_turns_with_mre4=mre_ms[1],
        launches_mre_path=q_res[4][3])
    by_name["solve_fused"].update(k12_detail["solve_fused"])
    by_name["cg_solve_eo"].update(k12_detail["cg_solve_eo"])
    by_name["ratio_force"].update(k12_detail["ratio_force"])
    by_name["residual_f64"].update(k12_detail["residual_f64"])
    by_name["residual_f64"]["refined_condensate_measurement"] = meas_detail
    by_name["solve_fused_mxu"].update(k12_detail["solve_fused_mxu"])
    by_name["halo_normal"].update(halo_detail["halo_normal"])
    by_name["halo_force"].update(halo_detail["halo_force"])
    by_name["chain_noise"].update(noise_detail)
    by_name["chain_noise"]["library_device_ms"] = u_detail["randn_device_ms"]
    by_name["chain_noise"]["modes"] = ["trajectory", "z2 (z2_noise)"]
    by_name["z2_noise"].update(
        mode_of="chain_noise", library_device_ms=u_detail["z2"]["library_device_ms"],
        ms_in_turns_with_library=u_detail["z2"]["ms_in_turns_with_library"],
        ms_per_measurement=u_detail["ms_per_measurement"],
        demo_condensate_chain_traj_per_s=u_detail["demo_condensate_chain_traj_per_s"],
        measurement_profile=u_detail.get("profile"))
    for k_name, tag in (("cg_solve_eo", "K6"), ("residual_f64", "K9")):
        for key in ("mask_ms", "mask_device_ms"):
            by_name[k_name][key] = {k: v for k, v in u_detail[key].items()
                                    if k.startswith(tag)}
    # the device program (t): a replay's and an eager call's ms a batch
    # trajectory, and the demo graphed and eager under the profiler
    by_name["chain_noise"]["device_program"] = t_detail
    by_name["solve_fused_mxu"]["ms_k2_in_turns"] = k2_vs_k10[1]
    by_name["solve_fused_mxu"]["ms_in_turns_with_k2"] = k2_vs_k10[0]
    check(all(e["launches"] > 0 for e in kernels), "a kernel was never launched")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
