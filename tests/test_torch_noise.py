"""The port's trajectory noise: the counter-based Philox4x32-10 stream.

``utils/prng.py`` holds the plain twin of the noise kernel (csrc/noise.cu,
ops/noise.py), which the CPU runs: here the bijection against the three
known-answer vectors of Random123, the stream's invariants (a chain's draw
depends only on (seed, trajectory, global chain index); no two
(seed, stream, trajectory, chain, field, element) share a counter; an int
trajectory index and the counter as a tensor draw the same), the moments
and a Kolmogorov-Smirnov test of every field in f32 and f64 for every
shape of the pseudofermion noise, the shapes ``draw_chain_noise`` gives
each mode, and the committed 64x64 physics row run on this stream. The
kernel itself is held against the twin on the card by
tests/test_torch_card_kernels.py.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats

from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import noise
from schwingermodel_tpu_torch.utils import prng

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
# Random123's known-answer vectors of philox4x32_10: (counter, key, words)
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
PI_SHAPE = (2, 8, 8)
CHI_SHAPES = {"even-odd": (2, 8, 4), "hasenbusch": (2, 2, 8, 4), "full-D": (2, 8, 8)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _draw(seed, traj, C, offset, chi_shape=CHI_SHAPES["even-odd"],
          rdtype=torch.float32, words=False):
    return noise.chain_noise(seed, traj, C, PI_SHAPE, chi_shape, rdtype, "cpu",
                             chain_offset=offset, words=words)


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    got = noise.philox(torch.tensor([ctr], dtype=torch.int64), key)
    assert got[0].tolist() == list(want)


@pytest.mark.parametrize("rdtype", DTYPES.values(), ids=DTYPES.keys())
def test_chain_draw_independent_of_batch(rdtype):
    """Chains 2-3 of a C=4 draw equal a C=2 draw at chain_offset=2, words
    and values, in every field."""
    whole = _draw(11, 7, 4, 0, rdtype=rdtype, words=True)
    part = _draw(11, 7, 2, 2, rdtype=rdtype, words=True)
    for a, b in zip(whole, part):
        assert torch.equal(a[2:], b)


@pytest.mark.parametrize("rdtype", DTYPES.values(), ids=DTYPES.keys())
def test_int_and_tensor_index_draw_the_same(rdtype):
    for traj in (0, 5, 2 ** 33 + 3):
        a = _draw(4, traj, 3, 1, rdtype=rdtype, words=True)
        b = _draw(4, torch.tensor(traj, dtype=torch.int64), 3, 1, rdtype=rdtype,
                  words=True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_no_two_draws_share_a_counter():
    """Distinct (trajectory, chain, field, element) give distinct counters,
    the trajectory's high word included, and distinct (seed, stream) give
    distinct keys; draws at neighbouring trajectories and chains differ."""
    n_pairs, n_chi = 64, 64
    ctrs = [prng.trajectory_counters(t, 3, off, n_pairs, n_chi, "cpu")
            for t in (0, 1, 2 ** 32, 2 ** 32 + 1) for off in (0, 3)]
    flat = torch.cat([c.reshape(-1, 4) for c in ctrs])
    assert (flat >= 0).all() and (flat <= M32).all()
    assert torch.unique(flat, dim=0).shape[0] == flat.shape[0]
    keys = {prng.philox_key(s, tag) for s in (0, 1, 2 ** 32, 2 ** 55)
            for tag in (prng._INIT, prng._TRAJ, prng._MEAS)}
    assert len(keys) == 12
    a, b = _draw(3, 0, 2, 0), _draw(3, 1, 2, 0)
    assert not torch.equal(a[0], b[0])
    assert not torch.equal(a[0][0], a[0][1])


@pytest.mark.parametrize("seed", [-1, 2 ** 56])
def test_seed_outside_the_key_range_raises(seed):
    with pytest.raises(ValueError, match="seed"):
        prng.philox_key(seed)


@pytest.mark.parametrize("chi_name", CHI_SHAPES)
@pytest.mark.parametrize("rdtype", DTYPES.values(), ids=DTYPES.keys())
def test_moments_and_ks(rdtype, chi_name):
    """pi ~ N(0, 1), each part of chi ~ N(0, 1/2), r ~ U[0, 1): means,
    variances and a Kolmogorov-Smirnov test of each (p > 1e-3) over 512
    chains of one trajectory; every value in the working dtype, finite,
    and r in [0, 1)."""
    C = 512
    pi, chi, r = noise.chain_noise(2, 9, C, PI_SHAPE, CHI_SHAPES[chi_name],
                                   rdtype, "cpu")
    assert pi.dtype == rdtype and r.dtype == rdtype
    assert chi.dtype == rdtype.to_complex()
    assert pi.shape == (C, *PI_SHAPE) and chi.shape == (C, *CHI_SHAPES[chi_name])
    samples = {"pi": pi.double().flatten().numpy(),
               "chi.re": math.sqrt(2) * chi.real.double().flatten().numpy(),
               "chi.im": math.sqrt(2) * chi.imag.double().flatten().numpy()}
    for name, x in samples.items():
        assert np.isfinite(x).all()
        n = x.size
        assert abs(x.mean()) < 5 / math.sqrt(n), name
        assert abs(x.var() - 1.0) < 5 * math.sqrt(2 / n), name
        assert stats.kstest(x, "norm").pvalue > 1e-3, name
    u = r.double().numpy()
    assert (u >= 0).all() and (u < 1).all()
    assert abs(u.mean() - 0.5) < 5 * math.sqrt(1 / 12 / C)
    assert stats.kstest(u, "uniform").pvalue > 1e-3


def test_f32_draw_is_the_f64_draw_rounded():
    """One Box-Muller in f64 a pair, rounded once: the f32 pi and chi are
    the f64 ones rounded, and the f32 r is the f64 r cut to 24 bits."""
    a = _draw(8, 3, 2, 0, rdtype=torch.float32)
    b = _draw(8, 3, 2, 0, rdtype=torch.float64)
    assert torch.equal(a[0], b[0].float())
    assert torch.equal(a[1], b[1].to(torch.complex64))
    assert torch.equal(a[2].double(), torch.floor(b[2] * 2 ** 24) / 2 ** 24)


@pytest.mark.parametrize("mode", ["even-odd", "hasenbusch", "full-D", "quenched", "f64"])
def test_draw_chain_noise_shapes(mode):
    """One call for all chains: pi [C, 2, Nx, Nt], chi of model.chi_shape
    (drawn in quenched mode too), r [C], in the working precision; chains
    of a group are those chains of the whole draw."""
    dtype = "float64" if mode == "f64" else "float32"
    model = SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=6, real_dtype=dtype),
        hmc=HMCParams(beta=2.0, m0=0.1, even_odd=mode != "full-D",
                      quenched=mode == "quenched",
                      hasenbusch_dm=0.4 if mode == "hasenbusch" else None,
                      cg=CGParams(tol=1e-8)))
    pi, chi, r = sampler.draw_chain_noise(model, 5, 2, 3, "cpu")
    rd = model.lattice.rdtype
    assert pi.shape == (3, 2, 8, 6) and pi.dtype == rd
    assert chi.shape == model.chi_shape((3, 2, 8, 6)) and chi.dtype == rd.to_complex()
    assert r.shape == (3,) and r.dtype == rd
    pi2, chi2, r2 = sampler.draw_chain_noise(model, 5, 2, 1, "cpu", chain_offset=2)
    assert torch.equal(pi2, pi[2:]) and torch.equal(chi2, chi[2:]) and torch.equal(r2, r[2:])


def test_new_modules_import_no_jax():
    """The noise kernel's module, the stream and the device program import
    neither jax nor the JAX package."""
    code = ("import sys\n"
            "import schwingermodel_tpu_torch.ops.noise\n"
            "import schwingermodel_tpu_torch.utils.prng\n"
            "import schwingermodel_tpu_torch.hmc.program\n"
            "import schwingermodel_tpu_torch.runner\n"
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'schwingermodel_tpu' or k.startswith('schwingermodel_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_committed_graphed_row_meets_the_table_rule():
    """The 64x64 beta=4 m0=0.2 row of the packed refined table, run on the
    card on the device program and this stream (C=1, 2000 measurements):
    |n_sigma| <= 3.5, the acceptance within JAX's 3 sigma, no ill
    configuration."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "docs", "crosscheck_torch_f32_packed_64_graph.json")
    with open(path) as f:
        (row,) = json.load(f)
    assert row["backend"] == "cuda" and "H100" in row["device"]
    assert (row["Nx"], row["Nt"], row["beta"], row["m0"]) == (64, 64, 4.0, 0.2)
    assert (row["chains"], row["nmeas"], row["refine"], row["even_odd"]) == (1, 2000, True, True)
    assert abs(row["n_sigma_Ep"]) <= 3.5 and abs(row["n_sigma_acc"]) <= 3.0
    assert row["n_ill"] == 0
