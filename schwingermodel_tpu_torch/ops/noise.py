"""The trajectory noise kernel: (pi, chi, r) of every chain in one launch.

``chain_noise`` draws one trajectory's noise for the chains chain_offset ..
chain_offset + C - 1 from the counter-based Philox4x32-10 stream of
``utils/prng.py``, whose docstring gives the key and counter layout. On a
CUDA device it launches ``csrc/noise.cu`` (what the JAX package draws with
jax.random inside its jitted trajectory, schwingermodel_tpu/hmc/packed.py:
478-488), reading the trajectory index from a 0-d int64 counter on the
card where it is given one, so that a CUDA graph of the trajectory draws
the noise of the trajectory it is at; on the CPU it runs the plain twin
``prng.trajectory_noise_reference``. ``z2_noise`` is the kernel's Z2 mode:
the condensate's Z2xZ2 noise of one measurement (the key of the _MEAS
stream tag, counted by element group, noise vector, global chain and the
measurement index, an int or a counter on the card; twin
``prng.z2_noise_reference``). ``philox`` is the bijection alone, for the
known-answer vectors.
"""

from __future__ import annotations

import math

import torch

from schwingermodel_tpu_torch.ops import _cuda
from schwingermodel_tpu_torch.utils import prng


def _traj_arg(traj_index, device, name="traj_index"):
    """(pointer, value) of the kernel's trajectory (or measurement) argument:
    the counter on the card, or a Python int passed by value."""
    if isinstance(traj_index, torch.Tensor):
        if traj_index.device != device or traj_index.dtype != torch.int64 \
                or traj_index.ndim != 0:
            raise ValueError(f"{name}: expected a 0-d int64 tensor on "
                             f"{device}, got {traj_index.dtype} "
                             f"{tuple(traj_index.shape)} on {traj_index.device}")
        return _cuda.ptr(traj_index), 0
    return None, int(traj_index)


def chain_noise(seed: int, traj_index, n_chains: int, pi_shape, chi_shape,
                rdtype, device, chain_offset: int = 0, words: bool = False):
    """One trajectory's noise of C = n_chains chains at the global indices
    chain_offset .. chain_offset + C - 1: pi ~ N(0, 1) of [C, *pi_shape],
    chi complex of [C, *chi_shape] with each part ~ N(0, 1/2), r ~ U[0, 1)
    of [C], in the real dtype `rdtype` (f32 or f64; chi in its complex
    type). traj_index: a Python int, or a 0-d int64 tensor on `device`,
    read there. With `words`, also the Philox words int64 [C, n_pi / 2 +
    n_chi + 1, 4] (the check against the twin). CUDA devices run
    csrc/noise.cu, CPU devices the twin."""
    device = torch.device(device)
    n_pi, n_chi = math.prod(pi_shape), math.prod(chi_shape)
    if n_pi % 2:
        raise ValueError(f"pi of {n_pi} elements a chain: expected an even count")
    if device.type != "cuda":
        out = prng.trajectory_noise_reference(
            seed, traj_index, n_chains, chain_offset, n_pi, n_chi, rdtype,
            device, words)
        pi, chi = out[0].reshape(n_chains, *pi_shape), out[1].reshape(n_chains, *chi_shape)
        return (pi, chi) + tuple(out[2:])
    if rdtype not in (torch.float32, torch.float64):
        raise ValueError(f"rdtype: expected float32 or float64, got {rdtype}")
    key0, key1 = prng.philox_key(seed)
    pi = torch.empty((n_chains, *pi_shape), dtype=rdtype, device=device)
    tptr, tval = _traj_arg(traj_index, pi.device)
    chi = torch.empty((n_chains, *chi_shape), dtype=rdtype.to_complex(),
                      device=device)
    r = torch.empty(n_chains, dtype=rdtype, device=device)
    w = (torch.empty((n_chains, n_pi // 2 + n_chi + 1, 4), dtype=torch.int32,
                     device=device) if words else None)
    p = _cuda.ptr
    _cuda.KERNELS.call("noise_launch", tptr, tval, key0, key1, int(chain_offset),
                       p(pi), p(chi), p(r), None if w is None else p(w),
                       n_chains, n_pi // 2, n_chi, int(rdtype == torch.float64))
    if words:
        return pi, chi, r, w.to(torch.int64) & 0xFFFFFFFF
    return pi, chi, r


def z2_noise(seed: int, meas_index, n_chains: int, n_noise: int, site_shape,
             device, chain_offset: int = 0, words: bool = False):
    """One measurement's Z2xZ2 noise of C = n_chains chains at the global
    indices chain_offset .. chain_offset + C - 1: complex64 [C, n_noise,
    *site_shape], each entry (+-1 +- i)/sqrt(2). meas_index: a Python int,
    or a 0-d int64 tensor on `device`, read there. With `words`, also the
    Philox words int64 [C, n_noise, ceil(n_el / 4), 4], n_el the entries of
    one vector. CUDA devices run the kernel's Z2 mode (one launch), CPU
    devices the twin ``prng.z2_noise_reference``."""
    device = torch.device(device)
    n_el = math.prod(site_shape)
    if device.type != "cuda":
        out = prng.z2_noise_reference(seed, meas_index, n_chains, chain_offset,
                                      n_noise, n_el, device, words)
        z = (out[0] if words else out).reshape(n_chains, n_noise, *site_shape)
        return (z, out[1]) if words else z
    prng.check_z2_range(meas_index, n_noise)
    key0, key1 = prng.philox_key(seed, prng._MEAS)
    z = torch.empty((n_chains, n_noise, *site_shape), dtype=torch.complex64,
                    device=device)
    mptr, mval = _traj_arg(meas_index, z.device, "meas_index")
    w = (torch.empty((n_chains, n_noise, -(-n_el // 4), 4), dtype=torch.int32,
                     device=device) if words else None)
    _cuda.KERNELS.call("z2_launch", mptr, mval, key0, key1, int(chain_offset),
                       _cuda.ptr(z), None if w is None else _cuda.ptr(w),
                       n_chains, n_noise, n_el)
    if words:
        return z, w.to(torch.int64) & 0xFFFFFFFF
    return z


def philox(ctr: torch.Tensor, key) -> torch.Tensor:
    """Philox4x32-10 of counters int64 [n, 4] (32-bit words) under the key
    (k0, k1): the words int64 [n, 4]. CUDA tensors run the kernel's
    bijection (csrc/noise.cu philox_launch), CPU tensors the twin."""
    if not ctr.is_cuda:
        return prng.philox4x32_10(ctr, key)
    n = ctr.shape[0]
    _cuda.check(ctr, "ctr", torch.int64, (n, 4))
    c32 = torch.where(ctr >= 2 ** 31, ctr - 2 ** 32, ctr).to(torch.int32)
    out = torch.empty_like(c32)
    _cuda.KERNELS.call("philox_launch", _cuda.ptr(c32), int(key[0]),
                       int(key[1]), _cuda.ptr(out), n)
    return out.to(torch.int64) & 0xFFFFFFFF
