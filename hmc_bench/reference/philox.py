"""Philox4x32-10 and the two noise streams the program keys with it.

A frozen, self-contained copy of the stream layout: the trajectory noise
(pi, chi, r) keyed by (seed, trajectory, chain) and the condensate's Z2xZ2
noise keyed by (seed, measurement, chain, vector). The bijection is
Random123's (Salmon et al., SC'11) with its published constants.

Trajectory stream (tag 1):
  key   k0 = seed mod 2^32, k1 = ((seed >> 32) mod 2^24) | tag << 24
  ctr   (q, field | (traj >> 32) << 8, chain, traj mod 2^32); field 0 for
        the pairs of pi, 1 for the elements of chi, 2 for r
  words (w0, w1, w2, w3): m1 = the 53 high bits of (w1 w0), m2 of (w3 w2);
        u1 = (m1 + 1) 2^-53, u2 = m2 2^-53; Box-Muller in f64,
        z0 = sqrt(-2 ln u1) cos(2 pi u2), z1 = ... sin(2 pi u2), rounded
        once to f32. pi: elements 2q, 2q + 1 of a chain from pair q; chi:
        element q = (z0 + i z1) / sqrt(2); r = (m1 >> 29) 2^-24 (f32).
Measurement stream (tag 2):
  ctr   (q, vector | (meas >> 32) << 16, chain, meas mod 2^32), q the
        group of four entries 4q .. 4q + 3 of one vector (spin-major)
  entry 4q + k from word w_k: real part -f32(2^-1/2) where bit 31 is set,
        else +f32(2^-1/2); imaginary part the same by bit 30.
"""

from __future__ import annotations

import math

import torch

_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_MASK = 0xFFFFFFFF
TRAJ, MEAS = 1, 2
Z2_SCALE = 0.70710677          # f32(2^-1/2)


def key(seed: int, tag: int) -> tuple:
    seed = int(seed)
    if not 0 <= seed < 1 << 56:
        raise ValueError(f"seed {seed} outside [0, 2^56)")
    return seed & _MASK, ((seed >> 32) & 0xFFFFFF) | (tag << 24)


def _mul(m: int, x: torch.Tensor):
    """(hi, lo) of the 64-bit product m * x, x a 32-bit value in int64."""
    a = (x & 0xFFFF) * m
    b = (x >> 16) * m
    return (b + (a >> 16)) >> 16, (((b & 0xFFFF) << 16) + a) & _MASK


def philox(ctr: torch.Tensor, k) -> torch.Tensor:
    """Philox4x32-10 of int64 counters [..., 4] under the key k = (k0, k1)."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = k
    for i in range(10):
        if i:
            k0, k1 = (k0 + _W[0]) & _MASK, (k1 + _W[1]) & _MASK
        hi0, lo0 = _mul(_M[0], c0)
        hi1, lo1 = _mul(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def trajectory_noise(seed: int, traj: int, n_chains: int, n_pi: int,
                     n_chi: int, device):
    """(pi [C, n_pi] f32, chi [C, n_chi] complex64, r [C] f32) of one
    trajectory, chains 0 .. C - 1."""
    n_pairs = n_pi // 2
    dev = torch.device(device)
    q = torch.cat([torch.arange(n_pairs), torch.arange(n_chi),
                   torch.zeros(1, dtype=torch.int64)]).to(dev)
    field = torch.cat([torch.zeros(n_pairs, dtype=torch.int64),
                       torch.ones(n_chi, dtype=torch.int64),
                       torch.full((1,), 2, dtype=torch.int64)]).to(dev)
    chain = torch.arange(n_chains, dtype=torch.int64, device=dev).reshape(-1, 1)
    n = q.numel()
    ctr = torch.stack([q.expand(n_chains, n),
                       (field | ((traj >> 32) << 8)).expand(n_chains, n),
                       chain.expand(n_chains, n),
                       torch.full((n_chains, n), traj & _MASK, dtype=torch.int64,
                                  device=dev)], dim=-1)
    w = philox(ctr, key(seed, TRAJ))
    m1 = (w[..., 1] << 21) | (w[..., 0] >> 11)
    m2 = (w[..., 3] << 21) | (w[..., 2] >> 11)
    u1 = (m1[:, :-1] + 1).double() * 2.0 ** -53
    u2 = m2[:, :-1].double() * 2.0 ** -53
    rad = torch.sqrt(-2.0 * torch.log(u1))
    z0 = rad * torch.cos(2.0 * math.pi * u2)
    z1 = rad * torch.sin(2.0 * math.pi * u2)
    pi = torch.stack([z0[:, :n_pairs], z1[:, :n_pairs]], dim=-1)
    pi = pi.reshape(n_chains, n_pi).float()
    s = 2.0 ** -0.5
    chi = torch.complex((z0[:, n_pairs:] * s).float(),
                        (z1[:, n_pairs:] * s).float())
    r = (m1[:, -1] >> 29).float() * 2.0 ** -24
    return pi, chi, r


def z2_noise(seed: int, meas: int, n_chains: int, n_noise: int, n_el: int,
             device) -> torch.Tensor:
    """[C, n_noise, n_el] complex64 entries (+-1 +- i) f32(2^-1/2) of one
    measurement, chains 0 .. C - 1."""
    dev = torch.device(device)
    n_groups = -(-n_el // 4)
    shape = (n_chains, n_noise, n_groups)
    q = torch.arange(n_groups, dtype=torch.int64, device=dev)
    j = torch.arange(n_noise, dtype=torch.int64, device=dev).reshape(-1, 1)
    chain = torch.arange(n_chains, dtype=torch.int64, device=dev).reshape(-1, 1, 1)
    ctr = torch.stack([q.expand(shape), (j | ((meas >> 32) << 16)).expand(shape),
                       chain.expand(shape),
                       torch.full(shape, meas & _MASK, dtype=torch.int64,
                                  device=dev)], dim=-1)
    bits = philox(ctr, key(seed, MEAS)).reshape(n_chains, n_noise, -1)[..., :n_el]
    s = torch.tensor(Z2_SCALE, dtype=torch.float32, device=dev)
    return torch.complex(torch.where((bits >> 31) & 1 == 1, -s, s),
                         torch.where((bits >> 30) & 1 == 1, -s, s))
