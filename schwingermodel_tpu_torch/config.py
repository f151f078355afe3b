"""Declarative run configuration (PyTorch port).

Counterpart of ``schwingermodel_tpu/config.py``: the same dataclasses, field
names and defaults, so that a configuration means the same thing in both
packages. Two differences:

- ``CGParams.refine_impl`` is gone. It chose between x64 and double-float
  arithmetic for the TPU; the port's high-precision half is native f64.
- ``CGParams.cert_k`` names the certification depth of the MD force solves,
  which the JAX package hard-codes (``hmc/packed.py:146``,
  ``ops/pallas_df.py:406,883``).

``from_jax_config`` builds these dataclasses from the JAX ones by field name.
It is duck-typed, so this module never imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class LatticeParams:
    """Lattice geometry and working precision.

    Site n = (x, t); mu=0 is the time direction (t -> t+1), mu=1 the space
    direction (x -> x+1). Full-lattice fields are [..., 2, Nx, Nt].
    """

    Nx: int = 64
    Nt: int = 64
    real_dtype: str = "float32"

    @property
    def volume(self) -> int:
        return self.Nx * self.Nt

    @property
    def rdtype(self) -> torch.dtype:
        return _DTYPES[self.real_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.rdtype == torch.float64 else torch.complex64


@dataclasses.dataclass(frozen=True)
class CGParams:
    """Solver knobs. Reference contract: ||r|| < tol ||b||, tol 1e-10,
    max_iter 10000 (src/main.cpp:26-27, src/conjugate_gradient.cpp:45)."""

    tol: float = 1e-10
    max_iter: int = 10000
    # The refined contract: f32 Krylov recursion, solution and true residual
    # in f64 (ops/refined.py, K3 + K4). False is the loose contract: f32 CG
    # throughout (K2, and the CG inside K1), converged on the recursive f32
    # residual; the CLI then defaults tol to 1e-6.
    refine: bool = False
    # Contraction of the recursive residual between true-residual
    # replacements.
    inner_tol: float = 1e-5
    max_outer: int = 8
    # MD force-solve tolerance; None = 1e-8 under refine, else tol. The
    # action solves always run at tol. An inexact force solve that starts
    # from the chronological forecast depends on the trajectory's history, so
    # it perturbs reversibility at the force-tolerance level; the
    # accept/reject keeps dH exact.
    force_tol: Optional[float] = None
    # f64 CG continuation for chains the refined solve left unconverged.
    fallback: bool = True
    # Depth-gated certification of the force solves: the f32 recursive exit
    # is trusted only for recursion segments shorter than cert_k iterations.
    certify_forces: bool = True
    cert_k: int = 192

    def resolved_force_tol(self) -> float:
        if self.force_tol is not None:
            return self.force_tol
        return max(self.tol, 1e-8) if self.refine else self.tol


@dataclasses.dataclass(frozen=True)
class HMCParams:
    """Physics and molecular-dynamics parameters (src/main.cpp:30-58)."""

    beta: float = 4.0
    m0: float = 0.2
    md_steps: int = 10
    trajectory_length: float = 0.1
    cg: CGParams = dataclasses.field(default_factory=CGParams)
    quenched: bool = False
    exact_initial_fermion_action: bool = True
    even_odd: bool = False
    hasenbusch_dm: Optional[float] = None
    cg_forecast: bool = True
    fused_cg: Optional[bool] = None
    packed: Optional[bool] = None
    mre_history: int = 0
    integrator: str = "leapfrog"

    @property
    def kappa(self) -> float:
        return 1.0 / (2.0 * (self.m0 + 2.0))

    @property
    def step_size(self) -> float:
        return self.trajectory_length / float(self.md_steps)


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Outer Monte-Carlo loop parameters (src/main.cpp:49-58)."""

    n_therm: int = 100
    n_meas: int = 100
    n_steps: int = 0
    save_conf: bool = False
    n_chains: int = 1
    seed: int = 0
    out_dir: str = "."
    mesh_shape: Optional[Tuple[int, ...]] = None
    autotune: bool = False
    tune_target: float = 0.7
    n_tune: int = 100


def _copy_fields(cls, src, **override):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {n: getattr(src, n) for n in names if hasattr(src, n)}
    kw.update(override)
    return cls(**kw)


def from_jax_config(lattice, hmc, run=None):
    """The port's (LatticeParams, HMCParams, RunParams) from the JAX
    package's dataclasses, copied by field name: every field the two share,
    among them ``real_dtype``, ``quenched``, ``even_odd``, ``hasenbusch_dm``,
    ``mesh_shape`` and the autotune fields. Fields the port does not have
    (``refine_impl``) are dropped; the port's own (``cert_k``) keep their
    defaults."""
    lat = _copy_fields(LatticeParams, lattice,
                       real_dtype=str(getattr(lattice, "real_dtype")))
    cg = _copy_fields(CGParams, hmc.cg)
    h = _copy_fields(HMCParams, hmc, cg=cg)
    r = _copy_fields(RunParams, run) if run is not None else RunParams()
    return lat, h, r
