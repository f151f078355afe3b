"""Times of the force step (K1, all four variants), the loose solve (K2),
the Hasenbusch ratio force (K5), the f32 CG on given links (K6), the
per-shard kernels of the lattice mesh (K7, K8) and the f64 true residual
(K9) on the card.

    python -m schwingermodel_tpu_torch.tools.bench_force_solve \\
        [--shapes 64x64:32,64x64:128,32x32:32,128x128:8] \\
        [--k6-shapes 64x64:32:8,64x64:32:1,64x64:128:8,32x32:32:8,128x128:2:8] \\
        [--halo-shapes 64x64:2x2:32,64x64:4x1:32,16x16:2x2:3,128x128:2x2:2] \\
        [--residual-shapes 64x64:32:8,64x64:2:8,64x64:2:2,32x32:32:8,128x128:8:8] \\
        [--out PATH]

For each lattice and chain count of ``--shapes`` it makes random angles and
a right-hand side from ``--seed`` at m0 = 0.2, beta = 4, and runs K2 (tol
1e-6 from x0 = b, as the loose action solve), K1 in its four variants of
``with_solve`` and ``with_gauge`` (tol 1e-6 from x0 = phi = b where it
solves) and K5 (psi = b, a random phi2, m0 = -0.19, m1 = 0.21, as the
near-critical Hasenbusch row); for each ``NXxNT:C:B`` of ``--k6-shapes``
random angles' folded links and B right-hand sides per configuration, and
K6 at tol 1e-5 from x0 = 0 (the refinement's inner solve). It prints one
JSON row per (kernel, variant, shape) with the kernel's milliseconds by
CUDA events in two turns of ``--reps`` launches, ``ms`` as the launches are
issued (the yardstick of ``chip_smoke.py``'s kernels line) and
``device_ms`` with them queued behind a spin of the card, which leaves the
host's launch cost out (``utils.metrics.device_ms``); for the solves the CG
iterations summed and of the slowest chain or entry, microseconds per
iteration of the slowest (for K6 per wave of entries: the card runs
``blocks_per_sm`` of its blocks on each multiprocessor at once, read from
the CUDA occupancy calculator), whether everything converged, and the path
the lattice size and chain count take on this card (``ops/traj.cg_path``).
For K1 without the solve and for K5 it also times every other number of
blocks a chain that holds the lattice (and the global path) in turns with
the one ``cg_path`` takes, through the kernel's C entry, in queued device
time (the host's cost is the same for every block count): the measurement
behind that choice. For K6 on the shared path it times the global path in
turns with it the same way, and says whether the two agree bit for bit.
For each ``NXxNT:RXxRT:C`` of ``--halo-shapes`` (C chains on an RX x RT
mesh of shards) it makes random angles and extended fields and times K7
with and without its CG partials and K8 as the sharded CG and the sharded
force call them (``ops/halo.EOOperatorsHaloFused``), both timers, with the
path ``ops/halo.halo_path`` takes; then every other number of blocks a
shard that holds the block, and the global path, in turns with the one
taken in queued device time, with their largest difference from it. For
each ``NXxNT:C:B`` of ``--residual-shapes`` it makes random angles, an f32
b and an f64 x, and times K9 as the restart refinement calls it
(``ops/refined.residual_f64``), both timers, with the route
``ops/refined.residual_path`` takes (slabs a configuration, right-hand
sides a block); then every other route (each slab count that holds the
lattice with each right-hand-side count dividing B, and the global
scratch) in turns with the one taken in queued device time, with whether
r is the taken route's bit for bit and ||r||^2's largest relative
difference from it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import _cuda, cg_eo, halo
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.eo_halo import W, extend
from schwingermodel_tpu_torch.ops.geometry import ShardedGeometry
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard
from schwingermodel_tpu_torch.tools.bench_refined_solve import _timed
from schwingermodel_tpu_torch.utils.metrics import card_label, device_ms

M0, BETA, TOL, MAX_ITER = 0.2, 4.0, 1e-6, 10000
M0_HB, M1_HB, K6_TOL = -0.19, 0.21, 1e-5
VARIANTS = [(s, g) for s in (False, True) for g in (True, False)]


def _shapes(text: str, fields: int = 1):
    """'64x64:32,32x32:32' -> [(64, 64, 32), (32, 32, 32)]; with fields=2,
    '64x64:32:8' -> [(64, 64, 32, 8)]."""
    out = []
    for item in text.split(","):
        lat, *counts = item.split(":")
        nx, nt = lat.split("x")
        if len(counts) != fields:
            raise ValueError(f"{item!r}: expected NXxNT and {fields} count(s)")
        out.append((int(nx), int(nt), *(int(n) for n in counts)))
    return out


def _halo_shapes(text: str):
    """'64x64:2x2:32,16x16:2x2:3' -> [(64, 64, 2, 2, 32), (16, 16, 2, 2, 3)]."""
    out = []
    for item in text.split(","):
        parts = item.split(":")
        if len(parts) != 3:
            raise ValueError(f"{item!r}: expected NXxNT:RXxRT:C")
        (nx, nt), (rx, rt) = (p.split("x") for p in parts[:2])
        out.append((int(nx), int(nt), int(rx), int(rt), int(parts[2])))
    return out


def _halo_rows(gen, dev, nx, nt, rx, rt, C, card, sms, reps):
    """K7 and K8 at one shape: the rows of the main path's calls and of every
    other route."""
    mesh = lattice_mesh((rx, rt))
    geom = ShardedGeometry(mesh)
    model = SchwingerModel(lattice=LatticeParams(Nx=nx, Nt=nt, real_dtype="float32"),
                           hmc=HMCParams(beta=BETA, m0=M0, even_odd=True), geom=geom)
    th = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev) - 1.0) * math.pi
    op = halo.EOOperatorsHaloFused(geom, model.field_fermion_links(shard(th, mesh)), M0)
    loc = (C, rx, rt, 2, 2, nx // rx, nt // 2 // rt)
    v_ext, psi_ext = (extend(geom, torch.randn(loc, generator=gen, device=dev))
                      for _ in range(2))
    r = torch.randn(loc, generator=gen, device=dev)
    planes = (op.ue_ext, op.uo_ext, op.off_ext)
    Nxe, Nthe = v_ext.shape[-2:]
    n_ent, shape = C * rx * rt, f"{nx}x{nt} over {rx}x{rt} C={C}"
    rows = []
    for kernel, per_site, run, launch in (
            ("K7", halo._NORMAL_BYTES, lambda: op.normal_ext(v_ext, r),
             lambda rt_: halo._NormalLaunch(*planes, M0, route=rt_)),
            ("K7 without the dots", halo._NORMAL_BYTES, lambda: op.normal_ext(v_ext),
             lambda rt_: halo._NormalLaunch(*planes, M0, route=rt_)),
            ("K8", halo._FORCE_BYTES, lambda: op.force_planes(psi_ext, BETA),
             lambda rt_: halo._ForceLaunch(*planes, route=rt_))):
        taken = halo.halo_path(Nxe, Nthe, n_ent, sms, per_site)
        rows.append({"metric": "ms", "kernel": kernel, "shape": shape, "card": card,
                     "path": halo.halo_path_name(Nxe, Nthe, n_ent, sms, per_site),
                     "blocks_a_shard": taken[1] if taken[0] == tr.CG_SHARED else "global",
                     **_both_timers(run, reps)})

        def call(route):
            k = launch(route)
            if kernel == "K8":
                return lambda: k(psi_ext, M0, BETA)
            return (lambda: k(v_ext, r)) if kernel == "K7" else (lambda: k(v_ext))
        ref = call(taken)()
        ref = ref if isinstance(ref, tuple) else (ref,)
        for n in (0, 1, 2, 4, 8):
            route = (tr.CG_GLOBAL, 1) if n == 0 else (tr.CG_SHARED, n)
            if route == taken or (n and not tr._rows_fit(Nxe - 2 * W, Nthe, n, per_site,
                                                         skirt=True)):
                continue
            fn = call(route)
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            diff = max((x - y).abs().max().item() for x, y in zip(out, ref))
            taken_ms, n_ms = _turns(call(taken), fn, reps)
            rows.append({"metric": "device_ms", "kernel": kernel, "shape": shape, "card": card,
                         "blocks_a_shard": n or "global",
                         "taken": taken[1] if taken[0] == tr.CG_SHARED else "global",
                         "taken_device_ms": taken_ms, "device_ms": n_ms,
                         "over_taken": n_ms / taken_ms, "max_abs_diff_from_taken": diff,
                         "bit_for_bit_with_taken": diff == 0.0})
    return rows


def _residual_rows(gen, dev, nx, nt, C, B, card, sms, reps):
    """K9 at one shape: the row of the refinement's call, and one row for
    every other route against the one taken."""
    nth = nt // 2
    th = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev) - 1.0) * math.pi
    thE, thO = tr.pack_planes(th)
    b = torch.randn((C, B, 2, 2, nx, nth), generator=gen, device=dev)
    x = torch.randn(b.shape, generator=gen, device=dev, dtype=torch.float64)
    taken = rs.residual_path(nx, nth, C, B, sms)
    shape = f"{nx}x{nt} C={C} B={B}"
    rows = [{"metric": "ms", "kernel": "K9", "shape": shape, "card": card,
             "path": rs.residual_path_name(nx, nth, C, B, sms), "route": list(taken),
             **_both_timers(lambda: rs.residual_f64(thE, thO, b, x, m0=M0), reps)}]

    def call(route):
        return lambda: rs._launch_residual(thE, thO, b, x, M0, sms, route)
    r_ref, n_ref = call(taken)()
    for route in [(tr.CG_GLOBAL, 1, 1)] + rs.residual_routes(nx, nth, B):
        if route == taken:
            continue
        r, n2 = call(route)()
        taken_ms, r_ms = _turns(call(taken), call(route), reps)
        rows.append({"metric": "device_ms", "kernel": "K9", "shape": shape, "card": card,
                     "route": list(route), "taken": list(taken), "taken_device_ms": taken_ms,
                     "device_ms": r_ms, "over_taken": r_ms / taken_ms,
                     "r_bit_for_bit_with_taken": torch.equal(r, r_ref),
                     "rnorm2_max_rel_diff": ((n2 - n_ref).abs() / n_ref).max().item()})
    return rows


def _k1_blocks(thE, thO, b, g, blocks):
    """K1 without the solve through its C entry: `blocks` blocks a chain on
    the shared path, or the global path where blocks is 0."""
    C, _, Nx, Nth = thE.shape
    FE, FO = torch.empty_like(thE), torch.empty_like(thO)
    iters = torch.empty(C, dtype=torch.int32, device=b.device)
    conv = torch.empty(C, dtype=torch.bool, device=b.device)
    scratch = torch.empty(C * tr._FORCE_SCRATCH * Nx * Nth if blocks == 0 else 0,
                          device=b.device)
    p = _cuda.ptr
    _cuda.KERNELS.call("force_step_launch", p(thE), p(thO), None, p(b), None, p(FE), p(FO),
                       p(iters), p(conv), p(scratch) if blocks == 0 else None, C, Nx, Nth,
                       M0, BETA, TOL, MAX_ITER, 0,
                       int(g), tr.CG_GLOBAL if blocks == 0 else tr.CG_SHARED,
                       max(blocks, 1))
    return FE, FO


def _k5_blocks(thE, thO, psi, phi2, blocks):
    """K5's launch on `blocks` blocks a chain of the shared path, or on the
    global path where blocks is 0."""
    return tr._launch_ratio(thE, thO, psi, phi2, M0_HB, M1_HB, BETA,
                            _cuda.sm_count(psi.device),
                            tr.CG_GLOBAL if blocks == 0 else tr.CG_SHARED, max(blocks, 1))


def _k6_path(ue, uo, b, x0, path):
    """K6's launch on `path`: (x, iters, rho, bnorm2)."""
    return cg_eo._launch(ue, uo, b, x0, M0, K6_TOL, MAX_ITER, _cuda.sm_count(b.device), path)


def _both_timers(run, reps):
    """`ms` as the launches are issued and `device_ms` queued behind a spin,
    two turns each: their means and the turns."""
    ms = [_timed(run, reps) for _ in range(2)]
    dev_ms = [device_ms(run, reps) for _ in range(2)]
    return {"ms": sum(ms) / 2, "turns_ms": ms, "device_ms": sum(dev_ms) / 2,
            "turns_device_ms": dev_ms}


def _turns(first, second, reps):
    """first, second, second, first in queued device time: the means of
    each."""
    f1, s1, s2, f2 = (device_ms(f, reps) for f in (first, second, second, first))
    return (f1 + f2) / 2, (s1 + s2) / 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_force_solve",
        description="K1, K2, K5, K6, K7, K8 and K9 on the card: times, iterations, the path")
    p.add_argument("--shapes", type=_shapes, default="64x64:32,64x64:128,32x32:32,128x128:8",
                   help="NXxNT:C items for K1, K2 and K5, comma-separated")
    p.add_argument("--k6-shapes", type=lambda t: _shapes(t, 2),
                   default="64x64:32:8,64x64:32:1,64x64:128:8,32x32:32:8,128x128:2:8",
                   help="NXxNT:C:B items for K6 (B right-hand sides per configuration)")
    p.add_argument("--halo-shapes", type=_halo_shapes,
                   default="64x64:2x2:32,64x64:2x2:128,64x64:4x1:32,64x64:1x4:32,"
                           "16x16:2x2:3,128x128:2x2:2",
                   help="NXxNT:RXxRT:C items for K7 and K8 (C chains on an RX x RT mesh)")
    p.add_argument("--residual-shapes", type=lambda t: _shapes(t, 2),
                   default="64x64:32:8,64x64:2:8,64x64:2:2,64x64:128:8,32x32:32:8,"
                           "128x128:8:8",
                   help="NXxNT:C:B items for K9 (B right-hand sides per configuration)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20, help="launches per timing")
    p.add_argument("--out", default=None, metavar="PATH", help="also write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label(dev)
    sms = _cuda.sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for nx, nt, C in args.shapes:
        th = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev) - 1.0) * math.pi
        thE, thO = tr.pack_planes(th)
        b = torch.randn((C, 2, 2, nx, nt // 2), generator=gen, device=dev)
        phi2 = torch.randn(b.shape, generator=gen, device=dev)
        shape = f"{nx}x{nt} C={C}"
        kw = dict(m0=M0, tol=TOL, max_iter=MAX_ITER)
        for kernel, s, g in [("K2", True, False)] + [("K1", s, g) for s, g in VARIANTS]:
            if kernel == "K2":
                def run():
                    return tr.solve_fused(thE, thO, b, b, **kw)
                variant, path = None, tr.cg_path_name(nx, nt // 2, C, sms)
            else:
                def run(s=s, g=g):
                    return tr.force_step(thE, thO, b, b, beta=BETA, with_solve=s,
                                         with_gauge=g, **kw)
                variant = f"with_solve={s},with_gauge={g}"
                path = tr.cg_path_name(nx, nt // 2, C, sms, s, g)
            reps = args.reps if s else 10 * args.reps
            res = run()
            row = {"metric": "ms", "kernel": kernel, "variant": variant, "shape": shape,
                   "path": path, "card": card, **_both_timers(run, reps)}
            if s:
                it_max = int(res.iters.max())
                row.update(iters_sum=int(res.iters.sum()), iters_max=it_max,
                           us_per_iter=1e3 * row["ms"] / max(it_max, 1),
                           all_converged=bool(res.converged.all()))
            emit(row)
            if kernel == "K1" and not s:
                # every other number of blocks a chain, against cg_path's
                per_site = tr._CG_SHARED_BYTES + (tr._PLAQ_BYTES if g else 0)
                k1_path, taken = tr.cg_path(nx, nt // 2, C, sms, False, g)
                taken = taken if k1_path == tr.CG_SHARED else 0
                ref = _k1_blocks(thE, thO, b, g, taken)
                for n in (0, 1, 2, 4, 8):
                    if n == taken or (n and not tr._rows_fit(nx, nt // 2, n, per_site)):
                        continue
                    same = all(torch.equal(x, y)
                               for x, y in zip(_k1_blocks(thE, thO, b, g, n), ref))
                    taken_ms, n_ms = _turns(lambda: _k1_blocks(thE, thO, b, g, taken),
                                            lambda: _k1_blocks(thE, thO, b, g, n), reps)
                    emit({"metric": "device_ms", "kernel": "K1", "variant": variant,
                          "shape": shape, "card": card, "blocks_a_chain": n or "global",
                          "taken": taken or "global", "taken_device_ms": taken_ms,
                          "device_ms": n_ms, "over_taken": n_ms / taken_ms,
                          "bit_for_bit_with_taken": same})
        k5_path, taken = tr.ratio_force_path(nx, nt // 2, C, sms)
        taken = taken if k5_path == tr.CG_SHARED else 0

        def run():
            return tr.ratio_force(thE, thO, b, phi2, m0=M0_HB, m1=M1_HB, beta=BETA)
        reps = 10 * args.reps
        emit({"metric": "ms", "kernel": "K5", "variant": None, "shape": shape,
              "path": tr.cg_path_name(nx, nt // 2, C, sms, False, True), "card": card,
              **_both_timers(run, reps)})
        # every other number of blocks a chain, and the global path (the
        # two bilinears unfolded: not bit for bit)
        ref = _k5_blocks(thE, thO, b, phi2, taken)
        for n in (0, 1, 2, 4, 8):
            if n == taken or (n and not tr._rows_fit(
                    nx, nt // 2, n, tr._CG_SHARED_BYTES + tr._PLAQ_BYTES)):
                continue
            out = _k5_blocks(thE, thO, b, phi2, n)
            diff = max((x - y).abs().max().item() for x, y in zip(out, ref))
            taken_ms, n_ms = _turns(lambda: _k5_blocks(thE, thO, b, phi2, taken),
                                    lambda: _k5_blocks(thE, thO, b, phi2, n), reps)
            emit({"metric": "device_ms", "kernel": "K5", "shape": shape, "card": card,
                  "blocks_a_chain": n or "global", "taken": taken or "global",
                  "taken_device_ms": taken_ms, "device_ms": n_ms,
                  "over_taken": n_ms / taken_ms, "max_abs_diff_from_taken": diff,
                  "bit_for_bit_with_taken": diff == 0.0})

    for nx, nt, C, B in args.k6_shapes:
        th = (2.0 * torch.rand((C, 2, nx, nt), generator=gen, device=dev) - 1.0) * math.pi
        ue, uo = SchwingerModel.fermion_links(*tr.pack_planes(th))
        bb = torch.randn((C, B, 2, 2, nx, nt // 2), generator=gen, device=dev)
        zero = torch.zeros_like(bb)
        path, _ = tr.cg_path(nx, nt // 2, C * B, sms)
        per_sm = _cuda.KERNELS.query("cg_eo_blocks_per_sm", nx, nt // 2, path)
        waves = -(-C * B // (sms * per_sm))

        def run():
            return cg_eo.cg_solve_eo(ue, uo, bb, zero, m0=M0, tol=K6_TOL, max_iter=MAX_ITER)
        res = run()
        it_max = int(res.iters.max())
        row = {"metric": "ms", "kernel": "K6", "variant": None,
               "shape": f"{nx}x{nt} C={C} B={B}", "card": card,
               "path": tr.cg_path_name(nx, nt // 2, C * B, sms), "blocks_per_sm": per_sm,
               "waves": waves, **_both_timers(run, args.reps)}
        row.update(iters_sum=int(res.iters.sum()), iters_max=it_max,
                   us_per_iter=1e3 * row["device_ms"] / (waves * max(it_max, 1)),
                   all_converged=bool(res.converged.all()))
        emit(row)
        if path == tr.CG_SHARED:
            same = all(torch.equal(x, y) for x, y in zip(
                _k6_path(ue, uo, bb, zero, tr.CG_GLOBAL), _k6_path(ue, uo, bb, zero, path)))
            taken_ms, g_ms = _turns(lambda: _k6_path(ue, uo, bb, zero, path),
                                    lambda: _k6_path(ue, uo, bb, zero, tr.CG_GLOBAL),
                                    args.reps)
            emit({"metric": "device_ms", "kernel": "K6", "shape": row["shape"], "card": card,
                  "path": "global", "taken": row["path"], "taken_device_ms": taken_ms,
                  "device_ms": g_ms, "over_taken": g_ms / taken_ms,
                  "bit_for_bit_with_taken": same})

    for nx, nt, rx, rt, C in args.halo_shapes:
        for row in _halo_rows(gen, dev, nx, nt, rx, rt, C, card, sms, 10 * args.reps):
            emit(row)

    for nx, nt, C, B in args.residual_shapes:
        for row in _residual_rows(gen, dev, nx, nt, C, B, card, sms, 10 * args.reps):
            emit(row)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
