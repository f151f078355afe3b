"""Step-size auto-tuning by dual averaging on the pooled acceptance.

Counterpart of ``schwingermodel_tpu/hmc/autotune.py``. The reference leaves
the integrator's tuning to the user (README.md:87-94: aim for an acceptance
of 0.6-0.8 by hand). Here a short warm-up tunes the step size with Nesterov
dual averaging (Hoffman & Gelman 2014, Algorithm 5), driving the expected
Metropolis acceptance min(1, exp(-dH)), pooled over the chains, to a target
(default 0.7). Afterwards ``finalize`` re-quantizes the tuned step into the
reference's (md_steps, trajectory_length) convention at fixed trajectory
length.

The dual-averaging state is five host floats. The JAX package keeps it on
the device inside one compiled scan; here each warm-up trajectory ends with
one host read of the pooled acceptance, because the next trajectory's step
size is a Python float that scales host-side updates (no kernel argument
bakes ``hmc.step_size``). It is the only host read inside the warm-up;
in a multi-process run it is a gather of every process's chains
(parallel/multihost.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from schwingermodel_tpu_torch.config import HMCParams
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.parallel import multihost as mh

# the warm-up's trajectories draw from their own stream of indices, apart
# from the run's (which count from 0), as JAX folds 0x7E0E into the run key
TUNE_STREAM = 0x7E0E0000


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging (Hoffman & Gelman 2014, Algorithm 5)."""

    log_eps: float      # current (exploring) log step size
    log_eps_bar: float  # averaged iterate: the tuned result
    h_bar: float        # running average of (target - accept_prob)
    t: float            # iteration count
    mu: float           # shrinkage point log(10 * eps0)


def da_init(eps0: float) -> DualAveragingState:
    log_eps0 = math.log(eps0)
    return DualAveragingState(log_eps0, log_eps0, 0.0, 0.0,
                              math.log(10.0 * eps0))


def da_update(state: DualAveragingState, accept_prob: float,
              target: float = 0.7, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    w = 1.0 / (t + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_eps = state.mu - math.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, t, state.mu)


class TuneResult(NamedTuple):
    theta: torch.Tensor      # configuration after the warm-up trajectories
    eps: float               # tuned step size (averaged iterate)
    accept_prob_last: float  # pooled accept probability of the last iteration


def tune_step_size(
    model: SchwingerModel,
    theta: torch.Tensor,
    seed: int,
    n_tune: int = 100,
    target: float = 0.7,
    eps0: Optional[float] = None,
    traj_fn: Optional[Callable] = None,
) -> TuneResult:
    """Dual-averaging warm-up over n_tune trajectories of theta
    [C, 2, Nx, Nt]; the acceptance probabilities are pooled by their mean
    over the chains (over every process's chains, in global order). ``traj_fn(theta, seed, traj_index, dt)`` defaults to
    the unpacked sampler; pass the packed or the sharded step for those
    paths."""
    eps0 = float(model.hmc.step_size) if eps0 is None else eps0
    if traj_fn is None:
        def traj_fn(th, seed_, i, dt):
            return sampler.hmc_trajectory(model, th, seed_, i, dt=dt)

    da = da_init(eps0)
    p = float("nan")
    for i in range(n_tune):
        theta, st = traj_fn(theta, seed, TUNE_STREAM + i, math.exp(da.log_eps))
        # the warm-up's one host read per trajectory: every process's
        # chains, the mean taken in global chain order on the host, so that
        # every process tunes the step of one process holding every chain
        p = float(torch.clamp(mh.gather_chains(st.exp_mdH), max=1.0).mean())
        da = da_update(da, p, target=target)
    return TuneResult(theta=theta, eps=math.exp(da.log_eps_bar),
                      accept_prob_last=p)


def finalize(hmc: HMCParams, eps: float, max_md_steps: int = 1000) -> HMCParams:
    """Re-quantize a tuned step into the reference's fixed-length
    convention: keep trajectory_length, set md_steps = clip(round(tau/eps)).
    ``max_md_steps`` caps the force evaluations: an Omelyan step costs two,
    so its step count is capped at half; Omelyan is defined at one step,
    leapfrog needs two."""
    tau = hmc.trajectory_length
    if hmc.integrator == "omelyan":
        lo, hi = 1, max(1, max_md_steps // 2)
    else:
        lo, hi = 2, max_md_steps
    md = int(max(lo, min(hi, round(tau / float(eps)))))
    return dataclasses.replace(hmc, md_steps=md)


def autotune(model: SchwingerModel, theta, seed: int, n_tune: int = 100,
             target: float = 0.7, traj_fn: Optional[Callable] = None,
             ) -> Tuple[torch.Tensor, HMCParams, float]:
    """Tune, then return (theta, finalized HMCParams, eps)."""
    res = tune_step_size(model, theta, seed, n_tune=n_tune, target=target,
                         traj_fn=traj_fn)
    return res.theta, finalize(model.hmc, res.eps), res.eps
