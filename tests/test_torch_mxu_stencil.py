"""K10 of the PyTorch port, the K2 solve with its x-shifts as products with
one-hot matrices, and its tool, against what the TPU kernel is made of.

The JAX tool ``schwingermodel_tpu/tools/bench_mxu_stencil.py`` does not
import (``IndentationError``, line 85: a comment block and an assignment are
dedented out of their ``if``), which ``test_jax_tool_does_not_import``
records: the day it is repaired that test fails, and the comparison can go
direct. Until then the twin is held against the pieces the JAX kernel is
made of and which do import: the x-shifts ``pallas_eo._shift_p_x`` /
``_shift_m_x`` that it replaces by ``dot_general`` with a one-hot matrix,
and K2, ``pallas_traj.solve_fused`` in interpret mode, the body of its "vpu"
variant. Gates: the one-hot products equal the shifts exactly; the twin
equals K2's twin in flags and iterations, and x bit for bit (on the CPU a
product with a one-hot matrix is exact); against the Pallas K2 on the
contract (x to 2e-4, equal flags, iterations within one). On the card
csrc/solve_mxu.cu is held against the twin, K2 and torch.roll by
tests/test_torch_card_kernels.py; here a plain model of its tile schedule (the banded k-tiles,
A built from the lane's indices, the columns ordered [t][plane pair]) is
held against torch.roll bit for bit, and shows where a NaN goes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.ops import pallas_eo
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu.ops.geometry import Geometry
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.tools import bench_mxu_stencil

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, MAX_ITER = 1e-6, 300


def _inputs(rng, C, Nx, Nt):
    theta = rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt)).astype(np.float32)
    b = (rng.standard_normal((C, 2, Nx, Nt // 2))
         + 1j * rng.standard_normal((C, 2, Nx, Nt // 2))).astype(np.complex64)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    return theta, b, thE, thO, tr.to_planar(torch.from_numpy(b))


@pytest.mark.parametrize("Nx", [8, 12, 64])
def test_one_hot_products_equal_the_shifts(rng, Nx):
    """P+ a and P- a equal pallas_eo's x-shifts and torch.roll exactly, on
    values across 30 binades."""
    Nth = 6
    a = (rng.standard_normal((3, Nx, Nth))
         * np.exp2(rng.integers(-15, 16, (3, Nx, Nth)))).astype(np.float32)
    Pp, Pm = tr.one_hot_shift_matrices(Nx)
    assert Pp.shape == (Nx, Nx) and bool((Pp.sum(dim=1) == 1).all())
    assert torch.equal(Pm, Pp.T)
    got_p, got_m = tr.shift_x_mxu(torch.from_numpy(a))
    for i in range(3):
        np.testing.assert_array_equal(
            got_p[i].numpy(), np.asarray(pallas_eo._shift_p_x(jnp.asarray(a[i]))))
        np.testing.assert_array_equal(
            got_m[i].numpy(), np.asarray(pallas_eo._shift_m_x(jnp.asarray(a[i]))))
    assert torch.equal(got_p, torch.roll(torch.from_numpy(a), -1, dims=1))
    assert torch.equal(got_m, torch.roll(torch.from_numpy(a), 1, dims=1))


# ---------- the kernel's tile schedule, lane by lane ----------

LANE = np.arange(32)
ROW, COL = LANE >> 2, LANE & 3            # A and C: row; A: column, C: column pair
BT, BP = LANE >> 3, (LANE >> 2) & 1       # B: column's t, plane within the pair


def _banded_shift_model(planes, delta, tiles=tr.mxu_band_tiles):
    """The shift entry of csrc/solve_mxu.cu (banded_products) lane by lane,
    for one spinor's four f32 planes [4, Nx, Nth]: per row tile m0 and group
    of 4 columns t0, per k-tile of the band, each lane's A entry (1 where k
    is its row's neighbour), each lane's B entries (plane (lane/4) & 1 of
    each pair at row k, column t0 + lane/8; zero beyond the lattice) and
    the m8n8k4 product D = A B added in f64 to each lane's C entries (row
    lane/4, columns 2 (lane%4) + 0, 1: the columns ordered [t][plane
    pair]). Returns (P+ or P-) planes in f32, and the k-tiles each row tile
    ran."""
    _, Nx, Nth = planes.shape
    out = np.zeros(planes.shape, np.float32)
    ran = {}
    for m0 in range(0, Nx, 8):
        row = m0 + ROW
        nbr = np.where(row + 1 == Nx, 0, row + 1) if delta > 0 else np.where(
            row == 0, Nx - 1, row - 1)
        ran[m0] = tiles(delta, m0, Nx)
        for t0 in range(0, Nth, 4):
            acc = np.zeros((2, 32, 2))             # [pair][lane][C entry], from +0
            tb = t0 + BT
            for k0 in ran[m0]:
                k = k0 + COL
                A = np.where((row < Nx) & (k == nbr), 1.0, 0.0).reshape(8, 4)
                ok = (k < Nx) & (tb < Nth)
                for p in range(2):
                    b = np.where(ok, planes[2 * p + BP, np.minimum(k, Nx - 1),
                                            np.minimum(tb, Nth - 1)].astype(np.float64), 0.0)
                    B = b.reshape(8, 4).T              # lane 4 c + j holds B[j][c]
                    with np.errstate(invalid="ignore"):
                        D = (A[:, :, None] * B[None, :, :]).sum(axis=1)
                    acc[p, :, 0] += D[ROW, 2 * COL]
                    acc[p, :, 1] += D[ROW, 2 * COL + 1]
            keep = (row < Nx) & (t0 + COL < Nth)
            for p in range(2):
                for i in range(2):
                    out[2 * p + i, row[keep], (t0 + COL)[keep]] = acc[p, keep, i]
    return out, ran


def _planes(rng, Nx, Nth):
    a = (rng.standard_normal((4, Nx, Nth))
         * np.exp2(rng.integers(-15, 16, (4, Nx, Nth)))).astype(np.float32)
    a[0, 0, :3] = 0.0
    a[1, Nx - 1, :3] = -0.0
    a[3, Nx // 2, 1] = -0.0
    return a


@pytest.mark.parametrize("Nx", [8, 12, 16, 24, 64, 128])
def test_banded_schedule_equals_roll_bit_for_bit(rng, Nx):
    """The products the kernel sums, A from the lane's indices over only the
    band's k-tiles (at most 3 of Nx/4, the wrap tile included), equal
    torch.roll bit for bit over 30 binades, on a ragged column group
    (Nth = 6), except that a -0 comes out +0 (the f64 accumulator starts at
    +0 and adds the zero products)."""
    Nth = 6
    a = _planes(rng, Nx, Nth)
    neg0 = (a == 0) & np.signbit(a)
    K4 = (Nx + 3) & ~3
    for delta, shift in ((+1, -1), (-1, 1)):
        got, ran = _banded_shift_model(a, delta)
        want = np.roll(a, shift, axis=1)
        moved = np.roll(neg0, shift, axis=1)
        np.testing.assert_array_equal(got[~moved].view(np.int32), want[~moved].view(np.int32))
        assert (got[moved] == 0).all() and not np.signbit(got[moved]).any()
        assert all(len(t) == min(3, K4 // 4) == len(set(t)) for t in ran.values())
        dense, _ = _banded_shift_model(a, delta, lambda d, m0, n: list(range(0, K4, 4)))
        np.testing.assert_array_equal(dense.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("Nx,k", [(64, 12), (64, 8), (64, 0), (64, 63), (24, 20), (8, 5)])
def test_banded_schedule_carries_a_nan_to_its_band_only(rng, Nx, k):
    """A NaN at row k of one plane reaches, in its own column and plane
    only, the rows of each row tile whose band holds k's tile: 8 or 16 rows
    (all of them at Nx = 8), its shifted position among them; the dense
    product carries it to the whole column."""
    Nth, t = 6, 3
    a = _planes(rng, Nx, Nth)
    a[1, k, t] = np.nan
    K4 = (Nx + 3) & ~3
    for delta, target in ((+1, (k - 1) % Nx), (-1, (k + 1) % Nx)):
        got, ran = _banded_shift_model(a, delta)
        nan = np.isnan(got)
        rows = {m0 + r for m0, tl in ran.items() if (k // 4) * 4 in tl
                for r in range(8) if m0 + r < Nx}
        assert set(np.nonzero(nan[1, :, t])[0]) == rows
        assert target in rows and len(rows) in ((8, 16) if Nx > 8 else (Nx,))
        assert nan.sum() == len(rows)                     # no other plane or column
        dense, _ = _banded_shift_model(a, delta, lambda d, m0, n: list(range(0, K4, 4)))
        assert np.isnan(dense[1, :, t]).all() and np.isnan(dense).sum() == Nx


def test_one_hot_geometry_shifts_complex_fields_and_keeps_t(rng):
    z = torch.from_numpy((rng.standard_normal((2, 2, 8, 4))
                          + 1j * rng.standard_normal((2, 2, 8, 4))).astype(np.complex64))
    g = tr.ONE_HOT
    assert torch.equal(g.shift(z, -2, +1), torch.roll(z, -1, dims=-2))
    assert torch.equal(g.shift(z, -2, -1), torch.roll(z, 1, dims=-2))
    assert torch.equal(g.shift(z, -1, +1), torch.roll(z, -1, dims=-1))


@pytest.mark.parametrize("C,Nx,Nt,m0", [(2, 8, 8, 0.2), (3, 8, 12, 0.1),
                                        (2, 12, 8, -0.1)])
def test_mxu_twin_equals_k2_twin_bit_for_bit(rng, C, Nx, Nt, m0):
    _, _, thE, thO, b = _inputs(rng, C, Nx, Nt)
    kw = dict(m0=m0, tol=TOL, max_iter=MAX_ITER)
    k2 = tr.solve_fused_reference(thE, thO, b, b, **kw)
    k10 = tr.solve_fused_mxu(thE, thO, b, b, **kw)
    assert bool(k10.converged.all())
    assert torch.equal(k10.converged, k2.converged)
    assert torch.equal(k10.iters, k2.iters)
    assert torch.equal(k10.x, k2.x)
    assert torch.equal(k10.rel_residual, k2.rel_residual)


@pytest.mark.parametrize("m0,cold", [(0.2, True), (-0.19, False)])
def test_mxu_twin_matches_pallas_k2_on_the_contract(rng, m0, cold):
    """Against the "vpu" body of the TPU experiment, K2 in interpret mode."""
    C, Nx, Nt = 2, 8, 8
    theta, b, thE, thO, b_t = _inputs(rng, C, Nx, Nt)
    x0 = b if cold else (b + 0.1 * rng.standard_normal(b.shape)).astype(np.complex64)
    E, O = pt.pack_chains(Geometry(), jnp.asarray(theta))
    ref = pt.solve_fused(E, O, pt.pack_even(jnp.asarray(b)),
                         pt.pack_even(jnp.asarray(x0)), m0=m0, tol=TOL,
                         max_iter=MAX_ITER, Nth=Nt // 2, interpret=True)
    got = tr.solve_fused_mxu(thE, thO, b_t, tr.to_planar(torch.from_numpy(x0)),
                             m0=m0, tol=TOL, max_iter=MAX_ITER)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all())
    np.testing.assert_allclose(got.x.numpy(),
                               tr.from_jax_packed(np.asarray(ref.x), C).numpy(),
                               rtol=0, atol=2e-4)
    assert np.abs(got.iters.numpy() - np.asarray(ref.iters)).max() <= 1


def test_mxu_twin_nan_chain_is_isolated(rng):
    """A NaN in one chain's right-hand side stops that chain at 0
    iterations with x = x0; the other chains are solved as if alone."""
    _, _, thE, thO, b = _inputs(rng, 3, 8, 8)
    b[1, 0, 0, 2, 1] = float("nan")
    x0 = torch.zeros_like(b)
    got = tr.solve_fused_mxu(thE, thO, b, x0, m0=0.1, tol=TOL, max_iter=MAX_ITER)
    np.testing.assert_array_equal(got.converged.numpy(), [True, False, True])
    assert int(got.iters[1]) == 0 and bool(torch.isfinite(got.x).all())
    keep = [0, 2]
    alone = tr.solve_fused_mxu(thE[keep], thO[keep], b[keep], x0[keep], m0=0.1,
                               tol=TOL, max_iter=MAX_ITER)
    assert torch.equal(got.iters[keep], alone.iters)
    assert torch.equal(got.x[keep], alone.x)


def test_mxu_wrapper_refuses_what_the_kernel_does_not_take():
    """On the card's path the wrapper checks its arguments and raises; it
    never runs K2 or a twin in the kernel's place."""
    thE = torch.zeros((1, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tr._launch_solve("solve_mxu_launch", 44, thE, thE,
                         torch.zeros((1, 2, 2, 8, 4)), torch.zeros((1, 2, 2, 8, 4)),
                         0.2, TOL, 10)


def test_tool_prints_its_three_rows_on_the_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out_file = tmp_path / "verdict.json"
    rc = bench_mxu_stencil.main(["--device", "cpu", "--nx", "8", "--nt", "8",
                                 "--chains", "2", "--rep", "3", "--seed", "1",
                                 "--out", str(out_file)])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r.get("variant") for r in rows] == ["cuda_shift", "mma_xshift", None]
    for r in rows[:2]:
        assert r["metric"] == "cg_us_per_lockstep_iter" and r["unit"] == "us/iter"
        assert r["value"] > 0 and r["lockstep_iters"] > 0
        assert r["value"] == round(r["us_per_iteration"], 3)
        assert r["shape"] == "8x8 C=2" and "CPU" in r["backend"] and r["card"] == "cpu"
    assert rows[1]["k_steps_per_row_tile"] == rows[1]["k_steps_per_row_tile_dense"] == 2
    verdict = rows[2]
    assert verdict["metric"] == "mxu_stencil_experiment"
    assert verdict["speedup_mxu_over_vpu"] > 0 and verdict["bit_for_bit"]
    assert verdict["all_converged"] and verdict["max_abs_dx"] == 0.0
    assert json.loads(out_file.read_text()) == verdict
    assert os.listdir(tmp_path) == ["verdict.json"]    # it writes only to --out


def test_jax_tool_does_not_import():
    """The reference-side fault, recorded: the TPU tool is not valid Python
    (IndentationError at line 85), so K10's TPU kernel cannot be run here."""
    path = os.path.join(REPO, "schwingermodel_tpu", "tools", "bench_mxu_stencil.py")
    with open(path) as f:
        source = f.read()
    with pytest.raises(IndentationError, match="unexpected indent") as err:
        compile(source, path, "exec")
    assert err.value.lineno == 85
