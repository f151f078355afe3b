"""Kernel-level benchmark: the Dirac applies, the even-odd CG and the
single-chain trajectory rate.

Counterpart of ``schwingermodel_tpu/tools/bench_kernels.py``: the same
flags, defaults, metric names and row keys. One JSON line per metric:

  - dirac_apply_us / dirac_apply_gflops : the full Wilson-Dirac apply
                                          (``ops/dirac.dirac``)
  - eo_normal_apply_us / eo_normal_gflops : the D^ D^+ apply
                                          (``model.eo_ops(theta).normal``)
  - cg_us_per_iter   : one iteration of the model's even-odd solve
                       (``model._solve_eo``: K6, csrc/cg_eo.cu, in f32 on
                       the card, as the JAX model reaches its Pallas CG on
                       the TPU; the plain CG in f64 on the CPU)
  - cg_iters_to_tol  : iterations of one solve of D^ v to tolerance
  - hmc_traj_per_s   : single-chain trajectories of the unpacked sampler
                       (``hmc/sampler.hmc_trajectory``)

The two applies are plain PyTorch, as they are jnp (not Pallas) in the JAX
tool: there is no kernel of them to port, and their rows say so in a
``note``. The working precision is f32 on the card and f64 on the CPU (the
JAX tool's TPU/CPU rule), the CG tolerance 1e-6 in f32 and 1e-10 in f64.
The configuration is thermalized first by 100 trajectories (10 on the CPU).
The inputs are drawn from ``np.random.default_rng(0)``.

Each time is a slope between two chain lengths (``tools/_bench.py``: the
host clock fenced by ``torch.cuda.synchronize()``, the least of 5 reps,
the first call of each length a warm-up) over the JAX tool's windows on the
card and shorter ones on the CPU; the CG's time per iteration is
(t2 - t1) / (it2 - it1) over two counts of chained solves (each from the
previous normalized solution), the iterations summed on the device.

Differences from the JAX tool: ``--device {cuda,cpu}`` replaces
``--platform`` (exit 2 names it), ``backend`` is "cuda" or "cpu", and each
row adds ``device``, the card's name and power limit
(``utils/metrics.card_label``).

    python -m schwingermodel_tpu_torch.tools.bench_kernels [--nx 64 --nt 64]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from schwingermodel_tpu_torch.tools import _bench

REPS = 5
# thermalization trajectories, and the (n1, n2) slope windows of each
# measurement: the JAX tool's on the card, shorter on the CPU
WINDOWS = {"cuda": {"therm": 100, "dirac": (1000, 21000), "eo": (1000, 11000),
                    "cg": (20, 320), "traj": (5, 105)},
           "cpu": {"therm": 10, "dirac": (20, 120), "eo": (20, 120),
                   "cg": (2, 12), "traj": (1, 3)}}
PLAIN_NOTE = ("plain PyTorch, as the JAX tool's jnp apply: no kernel "
              "(ops/dirac.py, ops/eo.py)")


def make_model(Nx: int, Nt: int, beta: float, m0: float, dtype: str):
    """The JAX tool's model: even-odd, md=10, tau=0.1, CG tol 1e-6 in f32
    (1e-10 in f64), max_iter 2000, no refinement."""
    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel

    tol = 1e-6 if dtype == "float32" else 1e-10
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=dtype),
        hmc=HMCParams(beta=beta, m0=m0, md_steps=10, trajectory_length=0.1,
                      even_odd=True, cg=CGParams(tol=tol, max_iter=2000)))


def draw_inputs(Nx: int, Nt: int, dtype: str, seed: int = 0):
    """theta [1, 2, Nx, Nt] uniform in [-pi, pi), v_full complex
    [1, 2, Nx, Nt] and v_eo complex [1, 2, Nx, Nt/2], each part
    N(0, 1/2), from ``np.random.default_rng(seed)``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, (1, 2, Nx, Nt))

    def cnormal(shape):
        re, im = rng.normal(size=shape), rng.normal(size=shape)
        return (re + 1j * im) * 2 ** -0.5

    cdtype = np.complex64 if dtype == "float32" else np.complex128
    return (theta.astype(dtype), cnormal((1, 2, Nx, Nt)).astype(cdtype),
            cnormal((1, 2, Nx, Nt // 2)).astype(cdtype))


def run_n(model, theta: torch.Tensor, seed: int, n: int):
    """n trajectories of the unpacked sampler from theta [1, 2, Nx, Nt],
    noise (seed, i) for i < n (the JAX tool's ``run_n``): (theta', the CG
    iterations summed, on the device)."""
    from schwingermodel_tpu_torch.hmc.sampler import hmc_trajectory

    its = torch.zeros((), dtype=torch.int64, device=theta.device)
    for i in range(n):
        theta, st = hmc_trajectory(model, theta, seed, i)
        its = its + st.cg_iters.sum()
    return theta, its


def dirac_steps(model, theta: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """n chained normalized D applies from v (one link computation a call);
    the final field."""
    from schwingermodel_tpu_torch.ops import dirac as dops

    Uf = model.field_fermion_links(theta)
    for _ in range(n):
        v = _bench.normalized(dops.dirac(model.geom, Uf, v, model.hmc.m0))
    return v


def eo_normal_steps(model, theta: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """n chained normalized D^ D^+ applies from the even field v."""
    ops = model.eo_ops(theta)
    for _ in range(n):
        v = _bench.normalized(ops.normal(v))
    return v


def cg_solves(model, theta: torch.Tensor, v: torch.Tensor, n: int):
    """n chained solves through ``model._solve_eo``, each from x0 = b and
    of the previous normalized solution: (the final field, the iterations
    summed, on the device)."""
    ops = model.eo_ops(theta)
    its = torch.zeros((), dtype=torch.int64, device=v.device)
    for _ in range(n):
        res = model._solve_eo(theta, ops, v)
        v = _bench.normalized(res.x)
        its = its + res.iters.sum()
    return v, its


def iters_to_tol(model, theta: torch.Tensor, v: torch.Tensor):
    """One solve of b = D^ v to tolerance: (iterations, converged, x)."""
    ops = model.eo_ops(theta)
    res = model._solve_eo(theta, ops, ops.dhat(v))
    return int(res.iters.sum()), bool(res.converged.all()), res.x


def measure(Nx: int, Nt: int, beta: float, m0: float, dtype: str, device,
            windows: dict, reps: int = REPS) -> list:
    """Every row at this lattice, each printed as it is measured."""
    from schwingermodel_tpu_torch.utils.metrics import (
        DIRAC_FLOPS_PER_SITE, EO_NORMAL_FLOPS_PER_SITE, card_label)

    card = card_label(device)
    model = make_model(Nx, Nt, beta, m0, dtype)
    tol = model.hmc.cg.tol
    theta_np, v_full_np, v_eo_np = draw_inputs(Nx, Nt, dtype)
    theta = torch.from_numpy(theta_np).to(device)
    v_full = torch.from_numpy(v_full_np).to(device)
    v_eo = torch.from_numpy(v_eo_np).to(device)
    rows = []

    def emit(metric, value, unit, **extra):
        row = {"metric": metric, "value": round(value, 4), "unit": unit,
               "lattice": f"{Nx}x{Nt}", "dtype": dtype, "backend": device.type,
               "device": card}
        row.update(extra)
        rows.append(row)
        print(json.dumps(row), flush=True)

    # thermalize so that the solver's iteration counts are typical
    theta, _ = run_n(model, theta, 0, windows["therm"])
    _bench.fence(device)

    s = _bench.slope(lambda n: dirac_steps(model, theta, v_full, n), *windows["dirac"],
                     reps, device)
    emit("dirac_apply_us", s * 1e6, "us/apply", note=PLAIN_NOTE)
    emit("dirac_apply_gflops", Nx * Nt * DIRAC_FLOPS_PER_SITE / s / 1e9, "GFLOP/s",
         note=PLAIN_NOTE)

    s = _bench.slope(lambda n: eo_normal_steps(model, theta, v_eo, n), *windows["eo"],
                     reps, device)
    emit("eo_normal_apply_us", s * 1e6, "us/apply", note=PLAIN_NOTE)
    emit("eo_normal_gflops", Nx * Nt * EO_NORMAL_FLOPS_PER_SITE / s / 1e9, "GFLOP/s",
         note=PLAIN_NOTE)

    n1, n2 = windows["cg"]
    t2, (_, it2) = _bench.timed(lambda: cg_solves(model, theta, v_eo, n2), reps, device)
    t1, (_, it1) = _bench.timed(lambda: cg_solves(model, theta, v_eo, n1), reps, device)
    emit("cg_us_per_iter", (t2 - t1) / max(int(it2) - int(it1), 1) * 1e6, "us/iter")

    it, conv, _ = iters_to_tol(model, theta, v_eo)
    emit("cg_iters_to_tol", float(it), f"iters to {tol:g} (converged={conv})")

    n1, n2 = windows["traj"]
    t2, _ = _bench.timed(lambda: run_n(model, theta, 0, n2), reps, device)
    t1, _ = _bench.timed(lambda: run_n(model, theta, 0, n1), reps, device)
    emit("hmc_traj_per_s", (n2 - n1) / (t2 - t1), "traj/s")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.bench_kernels")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--m0", type=float, default=0.2)
    p.add_argument("--dtype", choices=["float32", "float64"], default=None)
    _bench.add_device_flags(p)
    args = p.parse_args(argv)
    rc = _bench.check_flags(args)
    if rc:
        return rc
    device = torch.device(args.device)
    dtype = args.dtype or ("float32" if device.type == "cuda" else "float64")
    measure(args.nx, args.nt, args.beta, args.m0, dtype, device,
            WINDOWS[device.type])
    return 0


if __name__ == "__main__":
    sys.exit(main())
