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
E|chi|^2 = 1 per component; r ~ U[0, 1).
"""

from __future__ import annotations

import numpy as np
import torch

# stream tags, so that the hot start and the trajectories never share seeds
_INIT, _TRAJ = 0, 1


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
