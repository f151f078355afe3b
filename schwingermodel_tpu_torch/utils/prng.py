"""Random-number discipline: explicit torch.Generators from one root seed.

Counterpart of ``schwingermodel_tpu/utils/prng.py``. The JAX package folds
a threefry key per trajectory and splits it per chain; here the root seed,
the trajectory index and the chain index are mixed by NumPy's
``SeedSequence`` into the seed of one ``torch.Generator`` (Philox on CUDA),
so a chain's noise depends on (seed, trajectory, chain) only, not on the
number of chains or on the device's other work. The streams differ from
threefry's: tests feed both packages the same noise instead.

Distributions (reference src/hmc.cpp:5-28, include/statistics.h:20-24):
pi ~ N(0, 1); chi has real and imaginary parts each ~ N(0, 1/sqrt(2)), so
E|chi|^2 = 1 per component; r ~ U[0, 1). The condensate's noise is Z2xZ2,
(+-1 +- i)/sqrt(2) per component, from one generator per (measurement,
chain) of its own stream, as JAX keys the measurement apart from the
trajectories (``fold_in(k_run, 10_000_000 + i)``, runner.py:253-258).
"""

from __future__ import annotations

import numpy as np
import torch

# stream tags, so that the hot start, the trajectories and the measurements
# never share seeds
_INIT, _TRAJ, _MEAS = 0, 1, 2


def _generator(entropy, device) -> torch.Generator:
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_generator(seed: int, device) -> torch.Generator:
    """Generator of the hot-start configuration."""
    return _generator([seed, _INIT], device)


def chain_generator(seed: int, traj_index: int, chain: int, device) -> torch.Generator:
    """Generator of one chain's noise for one trajectory."""
    return _generator([seed, _TRAJ, traj_index, chain], device)


def measurement_generator(seed: int, meas_index: int, chain: int,
                          device) -> torch.Generator:
    """Generator of one chain's condensate noise for one measurement."""
    return _generator([seed, _MEAS, meas_index, chain], device)


def normal_real(gen, shape, dtype, device) -> torch.Tensor:
    """pi ~ N(0, 1) per component."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def normal_complex(gen, shape, rdtype, device) -> torch.Tensor:
    """Complex field with real and imaginary parts each ~ N(0, 1/sqrt(2))."""
    z = torch.randn((2,) + tuple(shape), generator=gen, dtype=rdtype,
                    device=device) * (2.0 ** -0.5)
    return torch.complex(z[0], z[1])


def uniform_scalar(gen, dtype, device) -> torch.Tensor:
    """Metropolis draw r in [0, 1)."""
    return torch.rand((), generator=gen, dtype=dtype, device=device)


def z2_complex(gen, shape, rdtype, device) -> torch.Tensor:
    """Complex Z2xZ2 noise: entries (+-1 +- i)/sqrt(2), so E[z z^+] = I."""
    bits = torch.randint(0, 2, (2,) + tuple(shape), generator=gen,
                         device=device)
    s = (2 * bits - 1).to(rdtype) * (2.0 ** -0.5)
    return torch.complex(s[0], s[1])
