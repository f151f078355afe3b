"""The port's critical-mass tool, tools/critical_mass.py, against the JAX
tool and the literature.

The reference's README quotes m_crit(beta=2) = -0.1968(9) and
m_crit(beta=1) = -0.3204(7) from Christian/Jansen/Nagai/Pollakowski (Nucl.
Phys. B 739 (2006)), from the PCAC quark mass's zero crossing, the method
the tool implements. Here: the JAX tests' three quick checks on the port's
functions, the functions against JAX's on seeded inputs, one tiny scan on
the CPU, and the committed scans run on the card held to JAX's gates
(tests/test_critical_mass.py).
"""

import json
import math
import os

import numpy as np
import pytest

from schwingermodel_tpu.tools import critical_mass as jcm
from schwingermodel_tpu_torch.observables import pcac_mass
from schwingermodel_tpu_torch.tools import critical_mass as cm

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "docs")


def test_fit_zero_crossing_exact():
    """Linear data with a known crossing is recovered exactly."""
    m0s = [-0.18, -0.15, -0.12]
    ms = [1.3 * (m + 0.20) for m in m0s]
    m_crit, err, slope = cm.fit_zero_crossing(m0s, ms, [1e-3] * 3)
    np.testing.assert_allclose(m_crit, -0.20, atol=1e-10)
    np.testing.assert_allclose(slope, 1.3, atol=1e-10)


def test_jackknife_bins_shapes():
    s = np.arange(40.0).reshape(40, 1)
    total, jk = cm.jackknife_bins(s, 8)
    assert jk.shape == (8, 1)
    np.testing.assert_allclose(total, s.mean(axis=0))


def test_pcac_plateau_flat_signal():
    """A cosh/sinh pair of mass m: the symmetric lattice derivative gives
    m_pcac = sinh(m) at every t."""
    Nt, m = 16, 0.12
    t = np.arange(Nt)
    C_PP = np.cosh(m * (Nt / 2 - t))
    C_A0P = 2.0 * np.sinh(m * (Nt / 2 - t))
    plateau = pcac_mass(C_PP, C_A0P)[3:7]
    np.testing.assert_allclose(plateau, np.sinh(m), rtol=1e-6)


@pytest.mark.parametrize("shape", [(40,), (40, 3), (63, 16), (100, 2, 8)])
@pytest.mark.parametrize("n_bins", [4, 7, 20])
def test_jackknife_bins_equals_jax(shape, n_bins):
    x = np.random.default_rng(sum(shape) + n_bins).normal(size=shape)
    total, jk = cm.jackknife_bins(x, n_bins)
    total_j, jk_j = jcm.jackknife_bins(x, n_bins)
    np.testing.assert_allclose(total, total_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(jk, jk_j, rtol=0, atol=1e-12)


def _correlators(rng, n, Nt, m=0.1, noise=0.05):
    """Per-measurement cosh/sinh correlators with multiplicative noise."""
    t = np.arange(Nt)
    pp = np.cosh(m * (Nt / 2 - t)) * (1 + noise * rng.normal(size=(n, Nt)))
    ap = 2.0 * np.sinh(m * (Nt / 2 - t)) * (1 + noise * rng.normal(size=(n, Nt)))
    return pp, ap


@pytest.mark.parametrize("n,Nt,window", [
    (16, 8, (3, 5)), (40, 16, (3, 7)), (160, 16, (3, 7)), (37, 12, (2, 6))])
def test_pcac_plateau_equals_jax(n, Nt, window):
    pp, ap = _correlators(np.random.default_rng(n * Nt), n, Nt)
    m, err = cm.pcac_plateau(pp, ap, window)
    m_j, err_j = jcm.pcac_plateau(pp, ap, window)
    assert abs(m - m_j) <= 1e-12 and abs(err - err_j) <= 1e-12
    assert math.isfinite(m) and err > 0


@pytest.mark.parametrize("n_points", [2, 3, 5, 8])
def test_fit_zero_crossing_equals_jax(n_points):
    rng = np.random.default_rng(n_points)
    m0s = np.sort(rng.uniform(-0.3, -0.05, n_points))
    errs = rng.uniform(1e-3, 5e-3, n_points)
    ms = 1.1 * (m0s + 0.19) + errs * rng.normal(size=n_points)
    got = cm.fit_zero_crossing(list(m0s), list(ms), list(errs))
    want = jcm.fit_zero_crossing(list(m0s), list(ms), list(errs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_main_runs_on_cpu(tmp_path, capsys):
    """One tiny scan at 8x8 on the unpacked f64 sampler: the summary has
    the keys of JAX's (the committed JAX artifact's) plus device, and every
    value is finite."""
    out = tmp_path / "cm.json"
    md = tmp_path / "cm.md"
    assert cm.main(["--nx", "8", "--nt", "8", "--m0-list=-0.1,0.0",
                    "--n-therm", "4", "--n-blocks", "4", "--n-skip", "1",
                    "--chains", "2", "--device", "cpu",
                    "--json", str(out), "--markdown", str(md)]) == 0
    capsys.readouterr()
    summary = json.loads(out.read_text())
    with open(os.path.join(DOCS, "critical_mass_b2.json")) as f:
        jax_art = json.load(f)
    assert set(summary) == set(jax_art) | {"device"}
    assert summary["device"] == "cpu" and summary["lattice"] == "8x8"
    assert [r["m0"] for r in summary["rows"]] == [-0.1, 0.0]
    for r in summary["rows"]:
        assert set(r) == set(jax_art["rows"][0])
        assert all(math.isfinite(r[k]) for k in ("m_pcac", "err", "acceptance"))
        assert r["all_converged"] is True
    assert all(math.isfinite(summary[k]) for k in ("m_crit", "err", "slope"))
    assert "f64, unpacked sampler" in md.read_text()


# ---------- the committed scans (run on the card) ----------

def _artifact(beta):
    with open(os.path.join(DOCS, f"critical_mass_torch_b{beta}.json")) as f:
        art = json.load(f)
    assert "H100" in art["device"] and art["device"].endswith(" W")
    return art


def test_committed_port_scan_beta2():
    """JAX's beta=2 gate: |m_crit + 0.1968| < 0.025 (16x16 against the
    infinite volume), an O(1) positive slope, at least 4 fit points,
    monotonic, all converged."""
    art = _artifact(2)
    assert art["beta"] == 2.0 and art["lattice"] == "16x16"
    assert abs(art["m_crit"] + 0.1968) < 0.025, art["m_crit"]
    assert 0.8 < art["slope"] < 2.0
    fit_rows = [r for r in art["rows"] if r["acceptance"] >= 0.5]
    assert len(fit_rows) >= 4
    ms = [r["m_pcac"] for r in sorted(fit_rows, key=lambda r: r["m0"])]
    assert all(a < b for a, b in zip(ms, ms[1:])), ms
    assert all(r["all_converged"] for r in fit_rows)


def test_committed_port_scan_beta1():
    """JAX's beta=1 gate: |m_crit + 0.3204| < 0.03, slope in (0.3, 2), at
    least 3 fit points, all converged."""
    art = _artifact(1)
    assert art["beta"] == 1.0 and art["lattice"] == "16x16"
    assert abs(art["m_crit"] + 0.3204) < 0.03, art["m_crit"]
    assert 0.3 < art["slope"] < 2.0
    fit_rows = [r for r in art["rows"] if r["acceptance"] >= 0.5]
    assert len(fit_rows) >= 3
    assert all(r["all_converged"] for r in fit_rows)
