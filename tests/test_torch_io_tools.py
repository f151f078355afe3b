"""The port's library leftovers against the JAX package and the reference's
goldens: the native configuration codec (its own copy, built into the
port's build directory) against the NumPy path, the lattice-shape sniffer,
the binary-to-text converter and the readbinconf tool (byte for byte
against the reference converter's output), the Metropolis tool's quick
checks, the cold start, and the reference's two-reduction CG
(counterparts of tests/test_io.py:47,92,155-182 and
tests/test_metropolis.py:23-29).
"""

import io as _io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu import runner as jrunner
from schwingermodel_tpu.config import LatticeParams as JLattice
from schwingermodel_tpu.io import ctxt as jctxt
from schwingermodel_tpu.solvers import cg as jcg
from schwingermodel_tpu_torch import native
from schwingermodel_tpu_torch import runner
from schwingermodel_tpu_torch.config import LatticeParams as Lattice
from schwingermodel_tpu_torch.io import ctxt
from schwingermodel_tpu_torch.solvers import cg
from schwingermodel_tpu_torch.tools import metropolis as mp
from schwingermodel_tpu_torch.tools import readbinconf

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
G0 = os.path.join(GOLDEN, "2D_U1_Ns8_Nt8_b20000_m01000_0.ctxt")
TEXT0 = os.path.join(GOLDEN, "golden_text_0.txt")


def test_codec_is_the_ports_own_build():
    """The codec loads from the port's build directory, built from the
    port's copy of the source, never the JAX package's library."""
    lib = native.load_codec()
    if lib is None:
        pytest.skip("no C++ compiler: the NumPy path runs")
    path = os.path.realpath(lib._name)
    assert path == str(native.library_path())
    assert os.path.dirname(path) == str(native.BUILD_DIR)
    assert "schwingermodel_tpu_torch" in path and "libctxt_codec_" in path


def test_native_and_numpy_paths_identical(tmp_path, monkeypatch):
    """Both write the reference's bytes (binary and text), and both
    readers parse them to the same links."""
    if native.load_codec() is None:
        pytest.skip("native codec unavailable (no compiler)")
    U = ctxt.read_conf(G0, 8, 8, binary=True)
    for binary in (True, False):
        p_native = str(tmp_path / f"native_{binary}.ctxt")
        p_numpy = str(tmp_path / f"numpy_{binary}.ctxt")
        ctxt.write_conf(p_native, U, binary=binary)
        monkeypatch.setattr(ctxt, "load_codec", lambda: None)
        ctxt.write_conf(p_numpy, U, binary=binary)
        U_numpy = ctxt.read_conf(p_native, 8, 8, binary=binary)
        monkeypatch.undo()
        with open(p_native, "rb") as a, open(p_numpy, "rb") as b:
            assert a.read() == b.read()
        np.testing.assert_array_equal(ctxt.read_conf(p_native, 8, 8,
                                                     binary=binary), U_numpy)
    with open(G0, "rb") as a, open(str(tmp_path / "native_True.ctxt"), "rb") as b:
        assert a.read() == b.read()


def test_missing_file_and_wrong_shape(tmp_path):
    with pytest.raises(FileNotFoundError):
        ctxt.read_conf(str(tmp_path / "none.ctxt"), 8, 8, binary=True)
    with pytest.raises(ValueError):
        ctxt.read_conf(G0, 4, 4, binary=True)


def test_sniff_lattice_shape(tmp_path):
    assert ctxt.sniff_lattice_shape(G0) == jctxt.sniff_lattice_shape(G0) == (8, 8)
    p = str(tmp_path / "6x10.ctxt")
    U = ctxt.links_from_theta(np.random.default_rng(3).uniform(
        -np.pi, np.pi, (2, 6, 10)))
    ctxt.write_conf(p, U)
    assert ctxt.sniff_lattice_shape(p) == (6, 10)
    with pytest.raises(ValueError):
        ctxt.sniff_lattice_shape(TEXT0)


def test_convert_binary_to_text_matches_jax_bytes(tmp_path):
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "jax.txt")
    ctxt.convert_binary_to_text(G0, ours, 8, 8)
    jctxt.convert_binary_to_text(G0, theirs, 8, 8)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(ctxt.read_conf(ours, 8, 8),
                                  ctxt.read_conf(G0, 8, 8))


def test_readbinconf_tool_matches_reference_converter_bytes(tmp_path):
    """The converter reproduces readBinConf.cpp's text output byte for
    byte (golden_text_0.txt was written by the reference converter)."""
    out = str(tmp_path / "conv.txt")
    assert readbinconf.convert(G0, out) == (8, 8)
    with open(TEXT0) as a, open(out) as b:
        assert a.read() == b.read()


def test_readbinconf_tool_stdin_pipe(tmp_path, monkeypatch, capsys):
    """File names on stdin, as the reference's `./readBinConf < filenames`
    (readBin.sh:13-14)."""
    out = str(tmp_path / "conv.txt")
    monkeypatch.setattr("sys.stdin", _io.StringIO(f"{G0}\n{out}"))
    assert readbinconf.main([]) == 0
    assert "Nx 8  Nt 8" in capsys.readouterr().out
    np.testing.assert_array_equal(ctxt.read_conf(out, 8, 8, binary=False),
                                  ctxt.read_conf(G0, 8, 8))


def test_readbinconf_tool_missing_file(tmp_path, capsys):
    assert readbinconf.main([str(tmp_path / "none.ctxt"),
                             str(tmp_path / "x.txt")]) == 1
    assert "not found" in capsys.readouterr().err


def test_exact_plaquette_quadrature():
    """The quadrature Bessel ratio matches known I1/I0 values."""
    assert abs(mp.exact_plaquette(2.0) - 0.697775) < 1e-5
    assert abs(mp.exact_plaquette(1.0) - 0.446390) < 1e-5


def test_metropolis_sweep_preserves_shapes():
    theta = np.random.default_rng(0).uniform(-np.pi, np.pi, size=(2, 8, 8))
    acc = mp.sweep(theta, 2.0, np.random.default_rng(0))
    assert theta.shape == (2, 8, 8)
    assert 0.0 < acc <= 1.0


@pytest.mark.parametrize("n_chains", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cold_start_matches_jax(n_chains, dtype):
    jlat = JLattice(Nx=6, Nt=8, real_dtype=dtype)
    lat = Lattice(Nx=6, Nt=8, real_dtype=dtype)
    want = np.asarray(jrunner.cold_start(jlat, n_chains))
    got = runner.cold_start(lat, n_chains)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == want.shape


def _spd_systems(rng, C, n, cond):
    """C hermitian positive-definite [n, n] complex matrices of condition
    number about `cond`, and right-hand sides [C, n]."""
    A = []
    for _ in range(C):
        q, _ = np.linalg.qr(rng.standard_normal((n, n))
                            + 1j * rng.standard_normal((n, n)))
        lam = np.geomspace(1.0, cond, n)
        A.append((q * lam) @ q.conj().T)
    b = rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n))
    return np.stack(A), b


@pytest.mark.parametrize("max_iter", [500, 5], ids=["converges", "starved"])
def test_cg_solve_matches_jax_x64(max_iter):
    """The port's two-reduction CG against JAX's x64 ``cg_solve`` (vmapped
    over the chains) on small hermitian positive-definite systems (n = 24,
    condition 10), every chain of the batch as its own solve: equal
    convergence flags, iteration counts side by side (equal here), x to
    1e-12 of its scale. The stop is 1e-12, where both loops run the
    dimension's iterations: at 1e-10 each x meets the contract and they
    part at 3e-12, the level at which each stops short of the exact
    solution."""
    rng = np.random.default_rng(7)
    A, b = _spd_systems(rng, 3, 24, 10.0)
    tol = 1e-12

    def jsolve(Ac, bc):
        return jcg.cg_solve(lambda x: Ac @ x, bc,
                            lambda x, y: jnp.real(jnp.vdot(x, y)),
                            tol=tol, max_iter=max_iter)

    ref = jax.vmap(jsolve)(jnp.asarray(A), jnp.asarray(b))
    At = torch.from_numpy(A)
    got = cg.cg_solve(lambda x: torch.einsum("cij,cj->ci", At, x),
                      torch.from_numpy(b),
                      lambda x, y: (x.conj() * y).real.sum(dim=-1),
                      tol=tol, max_iter=max_iter)
    iters = (got.iters.tolist(), np.asarray(ref.iters).tolist())
    assert iters[0] == iters[1], iters
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert got.converged.all().item() == (max_iter == 500)
    scale = np.abs(np.asarray(ref.x)).max()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-12 * scale)
    # the recursion's residual, which at this stop is rounding in both
    conv = got.converged.numpy()
    assert (got.rel_residual.numpy()[conv] < tol).all()
    assert (np.asarray(ref.rel_residual)[conv] < tol).all()
