"""Jackknife statistics for Monte-Carlo observable chains.

A copy of ``schwingermodel_tpu/utils/statistics.py`` (NumPy only; the port
cannot import it because that package's ``__init__`` imports jax).

Re-implements the estimator set of the reference (src/statistics.cpp,
include/statistics.h) as vectorized NumPy on the host -- these run once per
simulation on O(Nmeas) scalars, so they are deliberately *not* jitted:

  - mean                      (statistics.h:9-14)
  - jackknife_samples         leave-one-bin-out means (statistics.cpp:5-22)
  - jackknife_error           binned error at fixed bin count; the reference
                              calls it with 20 bins (src/hmc.cpp:213-214)
  - jackknife_max_error       max error over a range of bin sizes
                              (statistics.cpp:36-44), a plateau heuristic for
                              autocorrelated chains

plus an integrated autocorrelation time estimate (new; the reference has no
autocorrelation diagnostic at all).
"""

from __future__ import annotations

import numpy as np


def mean(x) -> float:
    return float(np.mean(np.asarray(x, dtype=np.float64)))


def jackknife_samples(x, n_bins: int) -> np.ndarray:
    """Leave-one-bin-out means (reference samples_mean, statistics.cpp:5-22).

    The chain is truncated to n_bins * bin_size entries like the reference
    (integer division at statistics.cpp:10).
    """
    x = np.asarray(x, dtype=np.float64)
    bin_size = len(x) // n_bins
    if bin_size == 0:
        raise ValueError(f"chain of length {len(x)} too short for {n_bins} bins")
    x = x[: n_bins * bin_size]
    total = x.sum()
    bins = x.reshape(n_bins, bin_size).sum(axis=1)
    return (total - bins) / (len(x) - bin_size)


def jackknife_error(x, n_bins: int = 20) -> float:
    """Binned jackknife standard error (reference Jackknife_error,
    statistics.cpp:24-33; called with 20 bins at hmc.cpp:213-214)."""
    s = jackknife_samples(x, n_bins)
    m = s.mean()
    return float(np.sqrt((len(s) - 1) / len(s) * np.sum((s - m) ** 2)))


def jackknife_max_error(x, bin_sizes=None) -> float:
    """Max jackknife error over bin sizes (reference Jackknife,
    statistics.cpp:36-44): a conservative plateau estimate."""
    x = np.asarray(x, dtype=np.float64)
    if bin_sizes is None:
        # powers of two up to len/10, like scanning for the plateau
        bin_sizes = [b for b in (1, 2, 4, 8, 16, 32, 64) if b <= len(x) // 10]
        if not bin_sizes:
            bin_sizes = [1]
    errs = []
    for bs in bin_sizes:
        n_bins = len(x) // bs
        if n_bins >= 2:
            errs.append(jackknife_error(x, n_bins))
    return float(max(errs)) if errs else 0.0


def autocorrelation_time(x, c: float = 6.0) -> float:
    """Integrated autocorrelation time with the Madras-Sokal self-consistent
    window W >= c * tau_int. Returns 0.5 for an uncorrelated chain."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 8:
        return 0.5
    xc = x - x.mean()
    # FFT autocovariance
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n].real
    if acov[0] <= 0:
        return 0.5
    rho = acov / acov[0]
    tau = 0.5
    for w in range(1, n // 2):
        tau += rho[w]
        if w >= c * tau:
            break
    return float(max(tau, 0.5))


def binned_summary(x, n_bins: int = 20) -> dict:
    """Mean, jackknife error, and tau_int for one observable chain."""
    return {
        "mean": mean(x),
        "error": jackknife_error(x, n_bins=min(n_bins, max(2, len(np.atleast_1d(x)) // 2))),
        "tau_int": autocorrelation_time(x),
        "n": int(len(np.atleast_1d(x))),
    }
