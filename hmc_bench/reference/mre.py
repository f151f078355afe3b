"""Plain reference of the minimal-residual extrapolation (MRE) of a solve's
start: chronological inversion, Brower, Ivanenko, Levi and Orginos,
hep-lat/9509012.

Given the last K solutions h_0 (the newest), ..., h_{K-1} of A x = b for a
slowly changing hermitian positive A, the start is h_0 plus the correction
in span{h_i - h_0} that minimises the residual: with w0 = A h0 and
r1 = b - w0, the pairs v_i = h_i - h0, w_i = A h_i - w0 (so w_i = A v_i)
are taken in turn, w_i orthogonalised against the earlier w by modified
Gram-Schmidt (v_i following it, so that the pair stays w = A v), scaled
to a unit w, and x0 = h0 + sum_i <r1, w_i> v_i. A pair whose |w|^2 falls
below 1e-8 of the largest |w|^2 so far is dropped: it lies in the span of
the earlier ones to rounding, and a history of K copies of one vector
gives x0 = h0 exactly.

Everything is float64 (complex128 for complex fields); the operator is
the caller's, so that the forecast is independent of any lattice layout.
"""

from __future__ import annotations

from typing import Callable

import torch

DROP = 1e-8     # a pair's |w|^2 below this share of the largest is dropped


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Re <u, v> per system (the leading axis), shaped to broadcast."""
    p = torch.conj(u) * v if u.is_complex() else u * v
    return p.real.flatten(1).sum(dim=1).reshape(-1, *(1,) * (u.ndim - 1))


def forecast(A: Callable, b: torch.Tensor, hist) -> torch.Tensor:
    """x0 [C, ...] for C systems A x = b: A maps a [C, ...] float64 (or
    complex128) tensor to A of it, system by system; b [C, ...]; hist the K
    earlier solutions, newest first, as a sequence or a [K, C, ...] tensor.
    Every value is taken in float64."""
    wide = torch.complex128 if b.is_complex() else torch.float64
    h = [x.to(wide) for x in hist]
    b = b.to(wide)
    base = h[0]
    w0 = A(base)
    r1 = b - w0
    x0 = base.clone()
    vs, ws, largest = [], [], None
    for hi in h[1:]:
        v = hi - base
        w = A(hi) - w0
        for vj, wj in zip(vs, ws):
            c = _dot(wj, w)
            w = w - c * wj
            v = v - c * vj
        nrm = _dot(w, w)
        largest = nrm if largest is None else torch.maximum(largest, nrm)
        tiny = torch.finfo(torch.float64).tiny
        scale = torch.where(nrm > DROP * largest, torch.rsqrt(nrm.clamp(min=tiny)),
                            torch.zeros_like(nrm))
        w, v = scale * w, scale * v
        x0 = x0 + _dot(w, r1) * v
        vs.append(v)
        ws.append(w)
    return x0
