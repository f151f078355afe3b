"""Per-shard sharded-solve kernel bench: the local compute of one shard.

Counterpart of ``schwingermodel_tpu/tools/bench_sharded_kernel.py``: the
same flags, defaults, draws, metric names and row keys, on the port's
kernels. On one card it measures the local work a shard of an rx x rt mesh
does between two collectives, at the per-shard block size
(``--local-nx`` x ``--local-nt``; 32 x 32 is the 64x64 lattice over 2x2):

  - sharded_local_jnp_us   : the wide-halo D^ D^+ apply as plain PyTorch
                             (``ops/eo.hop``/``hop_dag`` on the block
                             extended by W = 4, cropped): the jnp composite
                             of the JAX tool
  - sharded_local_fused_us : the same apply as one K7 launch
                             (``ops/halo.halo_normal``, csrc/halo_normal.cu)
  - sharded_cg_iter_us     : one iteration of the sharded CG
                             (``ops/halo.cg_solve_sharded_fused``: extend,
                             K7 with its four dot partials, the psum) on a
                             1x1 lattice mesh
  - sharded_force_jnp_us   : one MD force (chi' = D^+ psi, the fermion
                             force, the staples) as plain PyTorch on the 1x1
                             mesh, chained as th += 1e-6 F
  - sharded_force_fused_us : the same force as one K8 launch
                             (``ops/halo.force_halo_fused``,
                             csrc/halo_force.cu)

The block is extended by wrapping it on itself (``eo_halo.extend`` on a 1x1
mesh, numpy's ``mode="wrap"``): the halo a 1x1 mesh has, the same data
movement and the same kernel as a shard of a larger mesh, without the
collectives. The row offsets of the extended rows are (j % 2) for j in
[-W, Nx + W), the block at the origin.

Each time is a slope between two chain lengths (``tools/_bench.py``: the
host clock fenced by ``torch.cuda.synchronize()``, the least of 7 reps,
the first call of each length a warm-up), over the JAX tool's windows on
the card and its interpret-mode windows on ``--device cpu``; the CG's time
per iteration is (t2 - t1) / (it2 - it1) over two counts of pre-drawn
right-hand sides, the iterations counted on the device.

Differences from the JAX tool: ``--device {cuda,cpu}`` replaces
``--platform`` (exit 2 names it), ``backend`` is "cuda" or "cpu", and each
row adds ``device`` (the card's name and power limit, ``utils/metrics.
card_label``) and, on the kernels' rows, ``path`` (K7's or K8's route for
this block, ``ops/halo.halo_path_name``). The notes say what the port's
rows leave out: the collectives of a mesh across cards.

    python -m schwingermodel_tpu_torch.tools.bench_sharded_kernel \
        --local-nx 32 --local-nt 32 [--json BENCH_SHARDED_KERNEL.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from schwingermodel_tpu_torch.tools import _bench

BETA, TOL, MAX_ITER = 4.0, 1e-6, 2000
EPS = 1e-6                 # the MD-like step of the force chains
REPS = 7
# slope windows (n1, n2): local applies, right-hand sides, force steps; the
# JAX tool's on its chip and under interpret=True
WINDOWS = {"cuda": {"apply": (2000, 42000), "rhs": (5, 45), "force": (200, 3200)},
           "cpu": {"apply": (20, 120), "rhs": (2, 5), "force": (3, 10)}}


def draw_inputs(Nx: int, Nth: int, n_rhs: int, seed: int = 0):
    """The JAX tool's draws from ``np.random.default_rng(seed)``, in its
    order: theta f32 [2, Nx, 2 Nth], v complex64 [2, Nx, Nth], the
    right-hand sides complex64 [n_rhs, 2, Nx, Nth] (real parts drawn
    first, then imaginary), psi complex64 [2, Nx, Nth]."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, (2, Nx, 2 * Nth)).astype(np.float32)
    v_re = rng.normal(size=(2, Nx, Nth))
    v = (v_re + 1j * rng.normal(size=(2, Nx, Nth))).astype(np.complex64)
    rhs_re = rng.normal(size=(n_rhs, 2, Nx, Nth)).astype(np.float32)
    rhs_im = rng.normal(size=(n_rhs, 2, Nx, Nth)).astype(np.float32)
    psi_re = rng.normal(size=(2, Nx, Nth)).astype(np.float32)
    psi = psi_re + 1j * rng.normal(size=(2, Nx, Nth)).astype(np.float32)
    return theta, v, (rhs_re + 1j * rhs_im).astype(np.complex64), psi.astype(np.complex64)


def block_model(Nx: int, Nt: int, m0: float, beta: float = BETA):
    """The block as a lattice of its own (f32, even-odd, tol 1e-6,
    max_iter 2000) and the same model on a 1x1 lattice mesh."""
    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
    from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh
    from schwingermodel_tpu_torch.parallel.sharded import sharded_model

    model = SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32"),
        hmc=HMCParams(beta=beta, m0=m0, even_odd=True,
                      cg=CGParams(tol=TOL, max_iter=MAX_ITER)))
    return model, sharded_model(model, lattice_mesh((1, 1)))


def self_extend(inner, a: torch.Tensor) -> torch.Tensor:
    """[..., Nx, K] -> [..., Nx + 2W, K + 2W], the block wrapped on itself:
    ``eo_halo.extend`` on the 1x1 mesh of `inner`."""
    from schwingermodel_tpu_torch.ops.eo_halo import extend

    return extend(inner.geom, a)


class Block(NamedTuple):
    """The extended links of one block: K7's and K8's f32 planes
    [1, 2(dir), 2(re/im), Nxe, Nthe] and int32 row offsets [1, Nxe], and
    the composite's complex links [1, 2, Nxe, Nthe] and bool offsets
    [Nxe, 1] of the even and the odd rows."""

    ue_ext: torch.Tensor
    uo_ext: torch.Tensor
    off_ext: torch.Tensor
    ue: torch.Tensor
    uo: torch.Tensor
    off_e: torch.Tensor
    off_o: torch.Tensor


def block_links(model, inner, theta: torch.Tensor) -> Block:
    """The antiperiodic-folded f32 links of the block theta [2, Nx, Nt],
    packed by parity and extended by W (the JAX tool's ``prep``)."""
    from schwingermodel_tpu_torch.ops import eo
    from schwingermodel_tpu_torch.ops.eo_halo import W
    from schwingermodel_tpu_torch.ops.traj import to_complex, to_planar

    Uf = model.field_fermion_links(theta[None])
    both = self_extend(inner, to_planar(torch.cat(
        [eo.pack(Uf, eo.EVEN), eo.pack(Uf, eo.ODD)], dim=-3)))
    ue_ext, uo_ext = both[:, :2].contiguous(), both[:, 2:].contiguous()
    j = torch.arange(-W, theta.shape[-2] + W, device=theta.device)
    off_ext = (j % 2).to(torch.int32)[None]
    off_e = (off_ext[0] == 1)[:, None]
    return Block(ue_ext, uo_ext, off_ext, to_complex(ue_ext), to_complex(uo_ext),
                 off_e, ~off_e)


def local_apply_plain(inner, blk: Block, v: torch.Tensor, m0: float) -> torch.Tensor:
    """crop((D^ D^+) v_ext) by the plain hops on the extended block, v
    complex [1, 2, Nx, Nth]: the JAX tool's ``jnp_local``."""
    from schwingermodel_tpu_torch.ops import eo
    from schwingermodel_tpu_torch.ops.eo_halo import W
    from schwingermodel_tpu_torch.ops.geometry import LOCAL

    m, c = eo.mass_terms(m0)
    ve = self_extend(inner, v)
    w1 = eo.hop_dag(blk.uo, blk.ue, ve, blk.off_o, LOCAL)
    u = m * ve - c * eo.hop_dag(blk.ue, blk.uo, w1, blk.off_e, LOCAL)
    w2 = eo.hop(blk.uo, blk.ue, u, blk.off_o, LOCAL)
    out = m * u - c * eo.hop(blk.ue, blk.uo, w2, blk.off_e, LOCAL)
    return out[..., W:-W, W:-W]


def local_apply_fused(inner, blk: Block, v: torch.Tensor, m0: float) -> torch.Tensor:
    """The same apply as one K7 launch on f32 planes v [1, 2, 2, Nx, Nth]
    (its plain twin on a CPU tensor)."""
    from schwingermodel_tpu_torch.ops import halo

    return halo.halo_normal(blk.ue_ext, blk.uo_ext, blk.off_ext, self_extend(inner, v),
                            m0=m0)


def local_steps(inner, blk: Block, v: torch.Tensor, n: int, m0: float,
                fused: bool) -> torch.Tensor:
    """n chained normalized applies from v (complex for the composite,
    planar for K7); their result's sum, as the JAX tool returns it."""
    apply = local_apply_fused if fused else local_apply_plain
    x = v
    for _ in range(n):
        x = _bench.normalized(apply(inner, blk, x, m0))
    return x.real.sum() if x.is_complex() else x[..., 0, :, :].sum()


def sharded_cg(inner, theta_s: torch.Tensor, rhs: torch.Tensor, n: int, m0: float):
    """The first n right-hand sides rhs [n_rhs, 1, rx, rt, 2, Nx, Nth]
    solved one after another (the JAX tool's ``make_solves(n)``): (the sum
    of Re x over the solves, the iterations summed), both on the device."""
    from schwingermodel_tpu_torch.ops import halo

    Uf = inner.field_fermion_links(theta_s)
    tot = torch.zeros((), dtype=torch.float32, device=rhs.device)
    its = torch.zeros((), dtype=torch.int64, device=rhs.device)
    for i in range(n):
        res = halo.cg_solve_sharded_fused(inner.geom, Uf, m0, rhs[i], tol=TOL,
                                          max_iter=MAX_ITER)
        tot = tot + res.x.real.sum()
        its = its + res.iters.sum()
    return tot, its


def force_plain(inner, th: torch.Tensor, psi: torch.Tensor, m0: float,
                beta: float = BETA) -> torch.Tensor:
    """The MD force on the mesh of `inner` as plain PyTorch: the fermion
    force at chi' = D^+ psi plus the staple force (th [1, rx, rt, 2, Nx,
    Nt], psi [1, rx, rt, 2, Nx, Nth])."""
    from schwingermodel_tpu_torch.ops import eo, gauge

    ops = inner.eo_ops(th)
    F = eo.eo_fermion_force(ops, psi, ops.dhat_dag(psi))
    return F + gauge.gauge_force(inner.geom, inner.links(th), beta)


def force_fused(inner, th: torch.Tensor, psi: torch.Tensor, m0: float,
                beta: float = BETA) -> torch.Tensor:
    """The same force as one K8 launch (its plain twin on CPU tensors)."""
    from schwingermodel_tpu_torch.ops import halo

    ops = inner.eo_ops(th)
    return halo.force_halo_fused(inner.geom, ops.Uf, m0, psi, beta)


def force_steps(inner, th: torch.Tensor, psi: torch.Tensor, n: int, m0: float,
                fused: bool, beta: float = BETA) -> torch.Tensor:
    """n chained MD-like steps th += 1e-6 F; the sum of the final th."""
    force = force_fused if fused else force_plain
    for _ in range(n):
        th = th + EPS * force(inner, th, psi, m0, beta)
    return th.sum()


def measure(local_nx: int, local_nt: int, m0: float, device, windows: dict,
            reps: int = REPS) -> list:
    """The five rows at this block size, each printed as it is measured."""
    from schwingermodel_tpu_torch.ops import halo
    from schwingermodel_tpu_torch.ops.eo_halo import W
    from schwingermodel_tpu_torch.ops.traj import to_planar
    from schwingermodel_tpu_torch.parallel.mesh import shard
    from schwingermodel_tpu_torch.utils.metrics import card_label

    Nx, Nth = local_nx, local_nt // 2
    card = card_label(device)
    r1, r2 = windows["rhs"]
    theta_np, v_np, rhs_np, psi_np = draw_inputs(Nx, Nth, r2)
    model, inner = block_model(Nx, 2 * Nth, m0)
    mesh = inner.geom.mesh
    theta = torch.from_numpy(theta_np).to(device)
    blk = block_links(model, inner, theta)
    v = torch.from_numpy(v_np).to(device)[None]
    v_planar = to_planar(v).contiguous()
    k7 = halo.halo_path_name(Nx + 2 * W, Nth + 2 * W, 1)
    k8 = halo.halo_path_name(Nx + 2 * W, Nth + 2 * W, 1, per_site=halo._FORCE_BYTES)
    rows = []

    def emit(metric, value, unit, **extra):
        row = {"metric": metric, "value": round(value, 4), "unit": unit,
               "local_block": f"{Nx}x{2 * Nth}", "backend": device.type,
               "device": card}
        row.update(extra)
        rows.append(row)
        print(json.dumps(row), flush=True)

    n1, n2 = windows["apply"]
    s_plain = _bench.slope(lambda n: local_steps(inner, blk, v, n, m0, False),
                           n1, n2, reps, device)
    emit("sharded_local_jnp_us", s_plain * 1e6, "us/apply",
         note="plain PyTorch hops on the block extended by W=4 (the JAX "
              "tool's jnp composite)")
    s_fused = _bench.slope(lambda n: local_steps(inner, blk, v_planar, n, m0, True),
                           n1, n2, reps, device)
    emit("sharded_local_fused_us", s_fused * 1e6, "us/apply",
         speedup_vs_jnp=round(s_plain / s_fused, 2), path=k7)

    # the sharded CG on a 1x1 mesh: extend, K7 with its partials, the psum;
    # fresh pre-drawn right-hand sides, iterations counted on the device
    theta_s = shard(theta[None], mesh)
    rhs = shard(torch.from_numpy(rhs_np).to(device)[:, None], mesh)
    t2, (_, it2) = _bench.timed(lambda: sharded_cg(inner, theta_s, rhs, r2, m0),
                                reps, device)
    t1, (_, it1) = _bench.timed(lambda: sharded_cg(inner, theta_s, rhs, r1, m0),
                                reps, device)
    it1, it2 = int(it1), int(it2)
    emit("sharded_cg_iter_us", (t2 - t1) / max(it2 - it1, 1) * 1e6, "us/iter",
         iters_per_solve=round((it2 - it1) / (r2 - r1), 1), path=k7,
         note="cg_solve_sharded_fused on a 1x1 mesh (K7 with its dot "
              "partials); a mesh across cards adds its halo exchanges and "
              "psum")

    psi = shard(torch.from_numpy(psi_np).to(device)[None], mesh)
    f1, f2 = windows["force"]
    s_fplain = _bench.slope(lambda n: force_steps(inner, theta_s, psi, n, m0, False),
                            f1, f2, reps, device)
    emit("sharded_force_jnp_us", s_fplain * 1e6, "us/step",
         note="per-shard MD force (chi' + fermion + staple), plain PyTorch "
              "on a 1x1 mesh")
    s_ffused = _bench.slope(lambda n: force_steps(inner, theta_s, psi, n, m0, True),
                            f1, f2, reps, device)
    emit("sharded_force_fused_us", s_ffused * 1e6, "us/step",
         speedup_vs_jnp=round(s_fplain / s_ffused, 2), path=k8,
         note="force_halo_fused: one K8 launch a shard; a mesh across cards "
              "adds its halo exchanges")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_sharded_kernel")
    p.add_argument("--local-nx", type=int, default=32,
                   help="per-shard lattice rows (64x64 over 2x2 -> 32)")
    p.add_argument("--local-nt", type=int, default=32)
    p.add_argument("--m0", type=float, default=0.2)
    p.add_argument("--json", default=None)
    _bench.add_device_flags(p)
    args = p.parse_args(argv)
    rc = _bench.check_flags(args)
    if rc:
        return rc
    device = torch.device(args.device)
    rows = measure(args.local_nx, args.local_nt, args.m0, device,
                   WINDOWS[device.type])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
