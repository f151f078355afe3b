"""Random-number discipline: one root seed, a counter-based trajectory stream.

Counterpart of ``schwingermodel_tpu/utils/prng.py``. The JAX package folds
a threefry key per trajectory and splits it per chain, all inside its
jitted program. Here the trajectory noise comes from Philox4x32-10 (Salmon
et al., SC'11; the Random123 constants), keyed by the seed and a stream tag
and counted by (element, field, chain, trajectory), so a chain's noise
depends on (seed, trajectory, global chain index) only: not on the number
of chains, the chain offset, the process or the device's other work. On
the card one kernel draws every chain's noise of a trajectory
(``ops/noise.py``, ``csrc/noise.cu``), reading the trajectory index from a
counter on the card; ``trajectory_noise_reference`` below is its plain
twin, the same Philox rounds in torch integer ops on any device. The
streams differ from threefry's: tests feed both packages the same noise.

Layout (``csrc/noise.cu`` says the same):

- key: k0 = seed mod 2^32, k1 = (seed >> 32) mod 2^24 | tag << 24, for
  seeds in [0, 2^56) (``philox_key``);
- counter: c0 = q, the pair or element index within its field; c1 = field
  | (trajectory >> 32) << 8, the field 0 for pi, 1 for chi, 2 for r;
  c2 = the chain's global index; c3 = trajectory mod 2^32. Distinct
  (seed, stream, trajectory < 2^56, chain < 2^32, field, q < 2^32) never
  share a (key, counter).
- one counter's words (w0, w1, w2, w3) give m1 = the 53 high bits of
  (w1 w0) and m2 those of (w3 w2); u1 = (m1 + 1) 2^-53 in (0, 1],
  u2 = m2 2^-53 in [0, 1); Box-Muller in f64, z0 = sqrt(-2 log u1)
  cos(2 pi u2), z1 = ... sin(2 pi u2), rounded once to the working dtype.
  pi ~ N(0, 1): elements 2q and 2q + 1 of a chain from pair q; chi, each
  part ~ N(0, 1/2): element q = (z0 + i z1) / sqrt(2); r ~ U[0, 1):
  m1 2^-53 in f64, (m1 >> 29) 2^-24 in f32 (exact in both).

Distributions (reference src/hmc.cpp:5-28, include/statistics.h:20-24):
pi ~ N(0, 1); chi has real and imaginary parts each of variance 1/2, so
E|chi|^2 = 1 per component; r ~ U[0, 1).

The condensate's Z2xZ2 noise, (+-1 +- i)/sqrt(2) per component, comes from
the same bijection under the key of its own stream tag (_MEAS, as JAX keys
the measurement apart from the trajectories, ``fold_in(k_run, 10_000_000 +
i)``, runner.py:253-258), so it never shares a (key, counter) with the
trajectory stream; on the card one kernel draws every chain's vectors of a
measurement (``ops/noise.z2_noise``), ``z2_noise_reference`` below is its
twin. Layout (``csrc/noise.cu`` says the same):

- key: ``philox_key(seed, _MEAS)``;
- counter: c0 = q, the group of 4 elements of one noise vector (elements
  4q .. 4q + 3 of its 2 Nx Nt, spin-major); c1 = the noise vector j |
  (measurement >> 32) << 16; c2 = the chain's global index; c3 =
  measurement mod 2^32. Distinct (seed, measurement < 2^48, chain < 2^32,
  vector < 2^16, q < 2^32) never share a (key, counter).
- element 4q + k takes word w_k: its real part is -f32(2^-1/2) where bit
  31 of w_k is set, else +f32(2^-1/2); its imaginary part the same by bit
  30 (exact: no rounding). A vector whose element count is not a multiple
  of 4 drops the last group's spare words.

The hot start (one draw a run) keeps a ``torch.Generator``, seeded through
NumPy's ``SeedSequence`` (``init_generator``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# stream tags, so that the hot start, the trajectories and the measurements
# never share seeds
_INIT, _TRAJ, _MEAS = 0, 1, 2

# Philox4x32-10 (Random123): the round multipliers and the key increments
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
# fields of the trajectory stream's counter
FIELD_PI, FIELD_CHI, FIELD_R = 0, 1, 2
_SEED_LIMIT = 1 << 56


def _generator(entropy, device) -> torch.Generator:
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_generator(seed: int, device) -> torch.Generator:
    """Generator of the hot-start configuration."""
    return _generator([seed, _INIT], device)


# ---------- the trajectory stream: Philox4x32-10 ----------

def philox_key(seed: int, tag: int = _TRAJ) -> tuple:
    """(k0, k1) of the stream `tag` under `seed` (module docstring)."""
    seed = int(seed)
    if not 0 <= seed < _SEED_LIMIT:
        raise ValueError(f"seed {seed} outside [0, 2^56)")
    return seed & _MASK32, ((seed >> 32) & 0xFFFFFF) | (int(tag) << 24)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for a 32-bit constant m and int64 x
    holding 32-bit values, in int64 arithmetic that never overflows."""
    a = (x & 0xFFFF) * m                 # < 2^48
    b = (x >> 16) * m                    # < 2^48
    lo = (((b & 0xFFFF) << 16) + a) & _MASK32
    hi = (b + (a >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr: torch.Tensor, key) -> torch.Tensor:
    """Plain twin of the Philox4x32-10 bijection: counters int64 [..., 4]
    holding 32-bit words, key (k0, k1) ints or int64 tensors broadcasting
    against ctr[..., 0]; the words int64 [..., 4]."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def trajectory_counters(traj_index, n_chains: int, chain_offset: int,
                        n_pairs: int, n_chi: int, device) -> torch.Tensor:
    """The counters of one trajectory's noise, int64 [C, n_pairs + n_chi + 1,
    4]: the n_pairs pairs of pi, the n_chi elements of chi, then r, each
    chain at its global index. traj_index: a Python int or a 0-d int64
    tensor (read on its device, never on the host)."""
    traj = torch.as_tensor(traj_index, dtype=torch.int64, device=device)
    q = torch.cat([torch.arange(n_pairs, device=device),
                   torch.arange(n_chi, device=device),
                   torch.zeros(1, dtype=torch.int64, device=device)])
    field = torch.cat([
        torch.full((n_pairs,), FIELD_PI, dtype=torch.int64, device=device),
        torch.full((n_chi,), FIELD_CHI, dtype=torch.int64, device=device),
        torch.full((1,), FIELD_R, dtype=torch.int64, device=device)])
    chain = (torch.arange(n_chains, dtype=torch.int64, device=device)
             + int(chain_offset)).reshape(-1, 1)
    n = q.numel()
    return torch.stack([
        q.expand(n_chains, n),
        (field | ((traj >> 32) << 8)).expand(n_chains, n),
        (chain & _MASK32).expand(n_chains, n),
        (traj & _MASK32).expand(n_chains, n)], dim=-1)


def _bits53(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (hi << 21) | (lo >> 11)


def trajectory_noise_reference(seed: int, traj_index, n_chains: int,
                               chain_offset: int, n_pi: int, n_chi: int,
                               rdtype, device, words: bool = False):
    """Plain twin of the noise kernel (ops/noise.py): for the chains
    chain_offset .. chain_offset + n_chains - 1 of one trajectory, pi
    [C, n_pi] (n_pi even), chi complex [C, n_chi] and r [C] in the real
    dtype `rdtype` (f32 or f64) on `device`; with `words`, also the Philox
    words int64 [C, n_pi / 2 + n_chi + 1, 4]."""
    n_pairs = n_pi // 2
    ctr = trajectory_counters(traj_index, n_chains, chain_offset, n_pairs,
                              n_chi, device)
    w = philox4x32_10(ctr, philox_key(seed))
    m1 = _bits53(w[..., 0], w[..., 1])
    m2 = _bits53(w[..., 2], w[..., 3])
    u1 = (m1[:, :-1] + 1).double() * 2.0 ** -53
    u2 = m2[:, :-1].double() * 2.0 ** -53
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * u2
    z0, z1 = rad * torch.cos(ang), rad * torch.sin(ang)
    pi = torch.stack([z0[:, :n_pairs], z1[:, :n_pairs]], dim=-1)
    pi = pi.reshape(n_chains, n_pi).to(rdtype)
    s = 2.0 ** -0.5
    chi = torch.complex((z0[:, n_pairs:] * s).to(rdtype),
                        (z1[:, n_pairs:] * s).to(rdtype))
    if rdtype == torch.float64:
        r = m1[:, -1].double() * 2.0 ** -53
    else:
        r = (m1[:, -1] >> 29).float() * 2.0 ** -24
    return (pi, chi, r, w) if words else (pi, chi, r)


# ---------- the condensate's Z2xZ2 stream: the same bijection, tag _MEAS ----------

# f32(2^-1/2): the magnitude of each part of a Z2xZ2 entry
Z2_SCALE = 0.70710677
_MEAS_LIMIT, _NOISE_LIMIT = 1 << 48, 1 << 16


def z2_counters(meas_index, n_chains: int, chain_offset: int, n_noise: int,
                n_groups: int, device) -> torch.Tensor:
    """The counters of one measurement's Z2 noise, int64 [C, n_noise,
    n_groups, 4] (module docstring), each chain at its global index.
    meas_index: a Python int or a 0-d int64 tensor (read on its device,
    never on the host)."""
    meas = torch.as_tensor(meas_index, dtype=torch.int64, device=device)
    shape = (n_chains, n_noise, n_groups)
    q = torch.arange(n_groups, dtype=torch.int64, device=device)
    j = torch.arange(n_noise, dtype=torch.int64, device=device).reshape(-1, 1)
    chain = (torch.arange(n_chains, dtype=torch.int64, device=device)
             + int(chain_offset)).reshape(-1, 1, 1)
    return torch.stack([
        q.expand(shape), (j | ((meas >> 32) << 16)).expand(shape),
        (chain & _MASK32).expand(shape), (meas & _MASK32).expand(shape)], dim=-1)


def check_z2_range(meas_index, n_noise: int) -> None:
    """Raise where a Python-int measurement index or the vector count lies
    outside the counter layout (a tensor index is read only on its
    device)."""
    if not isinstance(meas_index, torch.Tensor) and not 0 <= int(meas_index) < _MEAS_LIMIT:
        raise ValueError(f"measurement index {meas_index} outside [0, 2^48)")
    if not 0 < n_noise < _NOISE_LIMIT:
        raise ValueError(f"{n_noise} noise vectors: expected 1 .. 2^16 - 1")


def z2_noise_reference(seed: int, meas_index, n_chains: int, chain_offset: int,
                       n_noise: int, n_el: int, device, words: bool = False):
    """Plain twin of the Z2 noise kernel (ops/noise.z2_noise): for the chains
    chain_offset .. chain_offset + n_chains - 1 of one measurement, n_noise
    vectors of n_el complex64 entries (+-1 +- i)/sqrt(2), [C, n_noise, n_el];
    with `words`, also the Philox words int64 [C, n_noise, ceil(n_el / 4),
    4]."""
    check_z2_range(meas_index, n_noise)
    n_groups = -(-n_el // 4)
    ctr = z2_counters(meas_index, n_chains, chain_offset, n_noise, n_groups, device)
    w = philox4x32_10(ctr, philox_key(seed, _MEAS))
    bits = w.reshape(n_chains, n_noise, 4 * n_groups)[..., :n_el]
    s = torch.tensor(Z2_SCALE, dtype=torch.float32, device=device)
    z = torch.complex(torch.where((bits >> 31) & 1 == 1, -s, s),
                      torch.where((bits >> 30) & 1 == 1, -s, s))
    return (z, w) if words else z
