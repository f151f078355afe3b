"""Where kernel K9 (the f64 true residual of the restart refinement) keeps
its fields, and the argument that lets it split a lattice into slabs of
rows: the four hops of Dhat Dhat^+ consume exactly four rows on either side
of a slab, so a slab of rows computed alone, with four rows of its
neighbours on either side (wrapping modulo Nx), gives the whole lattice's
rows of r. A slab whose first row is odd sees the checkerboard's t-offset
of every row flipped.

On the CPU the wrapper runs its plain twin; the launch path is read through
a recorder standing in for the kernel's C entry. The kernel itself is held
against the twin on the card by tests/test_torch_card_kernels.py.
"""

import numpy as np
import pytest
import torch

from schwingermodel_tpu_torch.ops import _cuda, eo, gauge
from schwingermodel_tpu_torch.ops import refined as rs
from schwingermodel_tpu_torch.ops import traj as tr

torch.set_num_threads(1)

M0, HALO = 0.2, 4


def _inputs(rng, C, B, Nx, Nt):
    theta = rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt)).astype(np.float32)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    b = torch.from_numpy(rng.standard_normal((C, B, 2, 2, Nx, Nt // 2)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((C, B, 2, 2, Nx, Nt // 2)))
    return thE, thO, b, x


def _slab_residual(thE, thO, b, x, first, n_rows):
    """What one block of K9's shared route computes, by the plain operator in
    f64: the rows first .. first + n_rows - 1 (mod Nx) of the links, b and x,
    the four hops on them alone with the row offsets of the slab's first
    row, and r = b - (Dhat Dhat^+) x on them. Returns r planar f64."""
    Nx = b.shape[-2]
    idx = torch.arange(first, first + n_rows) % Nx
    ue, uo = (u.index_select(-2, idx) for u in gauge.links(thE, thO, torch.complex128))
    ue, uo = ue[:, None], uo[:, None]
    v = tr.to_complex(x.index_select(-2, idx))
    m, c = eo.mass_terms(M0)
    par = first & 1
    off_e, off_o = eo.row_offset(n_rows, par), eo.row_offset(n_rows, 1 ^ par)
    w = eo.hop_dag(uo, ue, v, off_o)
    t2 = m * v - c * eo.hop_dag(ue, uo, w, off_e)
    w = eo.hop(uo, ue, t2, off_o)
    out = m * t2 - c * eo.hop(ue, uo, w, off_e)
    return tr.to_planar(tr.to_complex(b.index_select(-2, idx)).to(torch.complex128) - out)


# ---------- the ring argument on the twin ----------

@pytest.mark.parametrize("Nx,Nt", [(16, 16), (8, 12), (32, 8)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_slabs_of_rows_give_the_whole_lattices_rows(rng, Nx, Nt, n):
    """Each of n slabs of Nx/n rows, with 4 wrapped rows of its neighbours on
    either side (none for one slab), computed alone in f64, gives the whole
    lattice's rows of r bit for bit (8x12 over 8 slabs: one row a slab,
    every odd slab starting on an odd row); their squares, summed a slab at
    a time and added in rank order as the kernel's last block adds them,
    equal the twin's ||r||^2 to 1e-14."""
    C, B = 2, 2
    thE, thO, b, x = _inputs(rng, C, B, Nx, Nt)
    r, rnorm2 = rs.residual_f64_reference(thE, thO, b, x, m0=M0)
    rows, halo = Nx // n, HALO if n > 1 else 0
    firsts = [rank * rows - halo for rank in range(n)]
    if n == 8 and Nx == 8:
        assert any(f & 1 for f in firsts)
    parts = []
    for rank, first in enumerate(firsts):
        rs_ = _slab_residual(thE, thO, b, x, first, rows + 2 * halo)
        own = rs_[..., halo:halo + rows, :]
        assert torch.equal(own, r[..., rank * rows:(rank + 1) * rows, :]), (n, rank)
        parts.append((own * own).sum(dim=(2, 3, 4, 5)))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    assert bool(((total - rnorm2).abs() <= 1e-14 * rnorm2).all())


def test_slab_without_its_halo_rows_is_wrong_at_its_edges(rng):
    """The four rows either side are needed: with three, the slab's edge
    rows differ from the whole lattice's."""
    thE, thO, b, x = _inputs(rng, 1, 1, 16, 8)
    r, _ = rs.residual_f64_reference(thE, thO, b, x, m0=M0)
    rs_ = _slab_residual(thE, thO, b, x, 4 - 3, 4 + 6)
    own = rs_[..., 3:7, :]
    assert not torch.equal(own[..., 0, :], r[..., 4, :])
    assert torch.equal(own[..., 1:3, :], r[..., 5:7, :])


# ---------- the route by lattice size ----------

class _Recorder:
    """Stands in for _cuda.KERNELS.call: keeps each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_cuda.KERNELS, "call", rec)
    return rec


# lattice, C, B -> (path, slabs a configuration, right-hand sides a block)
SHAPES = [
    (64, 64, 32, 8, (tr.CG_SHARED, 2, 4)),    # run (d)'s refined condensate: 128 blocks
    (64, 64, 2, 8, (tr.CG_SHARED, 8, 1)),
    (64, 64, 2, 2, (tr.CG_SHARED, 8, 1)),     # the mesons' two sources
    (64, 64, 32, 1, (tr.CG_SHARED, 4, 1)),    # the unpacked sampler's solves
    (64, 64, 128, 8, (tr.CG_SHARED, 2, 8)),   # none at once: the fewest blocks
    (32, 32, 32, 8, (tr.CG_SHARED, 1, 2)),    # 128 blocks on 1, 2 or 4 slabs: 1
    (128, 128, 8, 8, (tr.CG_SHARED, 8, 4)),   # 24 rows of 64: one block holds no more
    (126, 128, 2, 8, (tr.CG_GLOBAL, 1, 1)),   # no split of at most 8 divides 126 rows
    (20, 34, 2, 2, (tr.CG_SHARED, 2, 1)),     # 10 rows a slab
    (8, 12, 3, 2, (tr.CG_SHARED, 1, 1))]


@pytest.mark.parametrize("Nx,Nt,C,B,want", SHAPES)
def test_residual_launches_on_the_rules_route(recorder, Nx, Nt, C, B, want):
    """K9 launches on residual_path's route with its slabs and right-hand
    sides a block; the global scratch (20 f64 a site and entry) only on the
    global route, none on one slab, and on a split only the slabs' f64
    partials and a ticket a block group (the launch zeroes them)."""
    Nth = Nt // 2
    assert rs.residual_path(Nx, Nth, C, B, 132) == want
    th = torch.zeros((C, 2, Nx, Nth))
    b = torch.zeros((C, B, 2, 2, Nx, Nth))
    r, rn = rs._launch_residual(th, th, b, b.double(), M0, 132)
    assert r.shape == b.shape and r.dtype == torch.float64 and rn.shape == (C, B)
    (name, args), = recorder.calls
    assert name == "residual_launch"
    assert args[8:12] == (C, B, Nx, Nth) and args[-3:] == want
    path, blocks, rhs = want
    scratch, tickets = rs._residual_scratch(C, B, Nx, Nth, want, b.device)
    assert (args[6] is None) == (scratch is None) and (args[7] is None) == (tickets is None)
    if path == tr.CG_GLOBAL:
        assert scratch.numel() == C * B * 20 * Nx * Nth and tickets is None
    elif blocks == 1:
        assert scratch is None and tickets is None
    else:
        assert scratch.dtype == torch.float64 and scratch.numel() == C * B * blocks
        assert tickets.dtype == torch.int32 and tickets.numel() == C * B // rhs
    assert rs.residual_path_name(Nx, Nth, C, B, 132) == (
        "global" if path == tr.CG_GLOBAL else
        f"shared, {blocks} slab{'s' if blocks > 1 else ''} a configuration, "
        f"{rhs} right-hand side{'s' if rhs > 1 else ''} a block")


@pytest.mark.parametrize("sms,C,B,want", [
    (132, 32, 8, (2, 4)), (66, 32, 8, (2, 8)), (264, 32, 8, (2, 2)), (132, 16, 8, (2, 2)),
    (132, 64, 8, (2, 8)), (132, 1024, 8, (2, 8))])
def test_residual_route_follows_the_cards_multiprocessors(sms, C, B, want):
    """At 64x64 the route is the one with the most blocks that run at once
    on the card, ties to the fewer slabs, else the fewest blocks; one slab
    never holds 64x64 (2048 sites at 128 bytes: 256 KB)."""
    assert rs.residual_path(64, 32, C, B, sms) == (tr.CG_SHARED, *want)


def test_residual_odd_rows_are_not_split():
    """An odd Nx has no split (the rows' offsets would not wrap): one slab
    where one block holds it, else the global route."""
    assert rs.residual_path(21, 16, 32, 8, 132) == (tr.CG_SHARED, 1, 2)
    assert rs.residual_path(63, 32, 32, 8, 132) == (tr.CG_GLOBAL, 1, 1)


def test_residual_wrapper_runs_the_twin_on_cpu_tensors(rng):
    """CPU tensors run the plain twin with no launch; the twin's ||r||^2 is
    the sum of its r's squares."""
    thE, thO, b, x = _inputs(rng, 2, 3, 8, 8)
    r, rn = rs.residual_f64(thE, thO, b, x, m0=M0)
    assert torch.equal(rn, (r * r).sum(dim=(2, 3, 4, 5)))
