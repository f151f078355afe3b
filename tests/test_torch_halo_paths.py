"""Where kernels K7 (per-shard Dhat Dhat^+ with the CG partials) and K8
(per-shard force) keep a shard's extended block, and the argument that lets
them split it: the four hops consume exactly the four extended rows on
either side of a slab of interior rows, so a slab computed alone gives the
whole block's interior rows.

On the CPU the wrappers run their plain twins; the launch paths are read
through a recorder standing in for the kernel's C entry. The kernels
themselves are held against the twins on the card by
tests/test_torch_card_kernels.py.
"""

import types

import numpy as np
import pytest
import torch

from schwingermodel_tpu_torch.config import HMCParams, LatticeParams
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import _cuda, eo_halo, halo
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.eo_halo import W, extend
from schwingermodel_tpu_torch.ops.geometry import ShardedGeometry
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard

torch.set_num_threads(1)

M0, BETA, L = 0.2, 4.0, 16


def _operator(rng, mesh_shape, C, dtype=None):
    """A shard's fused operator on random angles of an L x L lattice (its
    links cast to `dtype`)."""
    mesh = lattice_mesh(mesh_shape)
    geom = ShardedGeometry(mesh)
    model = SchwingerModel(lattice=LatticeParams(Nx=L, Nt=L, real_dtype="float32"),
                           hmc=HMCParams(beta=BETA, m0=M0, even_odd=True), geom=geom)
    theta = rng.uniform(-np.pi, np.pi, (C, 2, L, L)).astype(np.float32)
    Uf = model.field_fermion_links(shard(theta, mesh))
    return geom, halo.EOOperatorsHaloFused(geom, Uf if dtype is None else Uf.to(dtype), M0)


# ---------- the ring argument on the twins ----------

@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 1), (1, 2)])
def test_twins_on_row_slabs_equal_the_whole_block(rng, mesh_shape):
    """K7's and K8's twins applied to slabs of interior rows, each with the
    W extended rows on either side and its rows' offsets, and stitched: out
    and the forces equal the whole block's bit for bit in f64, at every
    count of blocks a shard of the rule that divides the rows. The slabs'
    partials add up to the whole block's to 1e-6 of its largest (each slab
    rounds its own to f32)."""
    C = 2
    geom, op = _operator(rng, mesh_shape, C)
    ue, uo, off = op.ue_ext.double(), op.uo_ext.double(), op.off_ext
    rx, rt = mesh_shape
    loc = (C, rx, rt, 2, 2, L // rx, L // 2 // rt)
    v, psi = (extend(geom, torch.from_numpy(rng.standard_normal(loc))) for _ in range(2))
    r = torch.from_numpy(rng.standard_normal(loc))
    out, dots = halo.halo_normal_reference(ue, uo, off, v, r, m0=M0, with_dots=True)
    FE, FO = halo.halo_force_reference(ue, uo, off, psi, m0=M0, beta=BETA)
    rows = L // rx
    for n in (1, 2, 4, 8):
        if rows % n:
            continue
        k = rows // n
        outs, parts, fes, fos = [], [], [], []
        for b in range(n):
            def slab(t, first=b * k):
                return t.narrow(-2, first, k + 2 * W)
            o, d = halo.halo_normal_reference(slab(ue), slab(uo), off.narrow(-1, b * k, k + 2 * W),
                                              slab(v), r.narrow(-2, b * k, k), m0=M0,
                                              with_dots=True)
            fe, fo = halo.halo_force_reference(slab(ue), slab(uo),
                                               off.narrow(-1, b * k, k + 2 * W), slab(psi),
                                               m0=M0, beta=BETA)
            outs.append(o)
            parts.append(d.double())
            fes.append(fe)
            fos.append(fo)
        assert torch.equal(torch.cat(outs, dim=-2), out), n
        assert torch.equal(torch.cat(fes, dim=-2), FE), n
        assert torch.equal(torch.cat(fos, dim=-2), FO), n
        scale = dots.double().abs().amax(dim=-1, keepdim=True)
        assert bool(((sum(parts) - dots.double()).abs() <= 1e-6 * scale).all()), n


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 1), (1, 4), (2, 1), (1, 2),
                                        (4, 2)])
@pytest.mark.parametrize("Nx", [8, 12, 16])
def test_ext_offsets_alternate_by_row(mesh_shape, Nx):
    """The extended rows' even-parity offsets alternate by row on every
    mesh and local row count (odd ones too), so a block's first row gives
    all of them: what K7 and K8 read."""
    geom = ShardedGeometry(lattice_mesh(mesh_shape))
    off_e, off_o = eo_halo._ext_offsets(geom, Nx // mesh_shape[0], W)
    off_e = off_e[0, :, 0, :, 0]
    assert torch.equal(off_e[:, 1:], 1 - off_e[:, :-1])
    assert torch.equal(off_o[0, :, 0, :, 0], 1 - off_e)


# ---------- the path by block size ----------

class _Recorder:
    """Stands in for a kernel's C entry: keeps each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_cuda.KERNELS, "entry", lambda name: rec)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return rec


# lattice, mesh, chains -> (path, blocks a shard) of K7 and of K8
SHAPES = [
    (64, (2, 2), 32, (tr.CG_SHARED, 1)),     # run (f)'s block: 128 shards
    (64, (2, 2), 128, (tr.CG_SHARED, 1)),
    (64, (4, 1), 32, (tr.CG_SHARED, 1)),
    (64, (1, 4), 32, (tr.CG_SHARED, 1)),
    (16, (2, 2), 3, (tr.CG_SHARED, 1)),      # 8 interior rows: no split of 8-row blocks
    (128, (2, 2), 2, (tr.CG_SHARED, 8)),     # 72x40 sites: one block cannot hold it
    (512, (2, 2), 1, (tr.CG_GLOBAL, 1))]     # 264x136: no split of at most 8 holds it


@pytest.mark.parametrize("L_,mesh_shape,C,want", SHAPES)
def test_halo_kernels_launch_on_the_rules_path(recorder, L_, mesh_shape, C, want):
    """K7 (with and without the partials) and K8 launch with the rule's
    path and blocks a shard, with a global scratch only where no split
    holds; on a split K7's scratch is the blocks' f64 partials and a zero
    ticket a shard, so its partials come back f32 [*lead, 4] from the one
    launch on every path."""
    rx, rt = mesh_shape
    lead = (C, rx, rt)
    Nxe, Nthe = L_ // rx + 2 * W, L_ // 2 // rt + 2 * W
    for per_site in (halo._NORMAL_BYTES, halo._FORCE_BYTES):
        assert halo.halo_path(Nxe, Nthe, C * rx * rt, 132, per_site) == want
    planes = torch.zeros((*lead, 2, 2, Nxe, Nthe))
    off = torch.zeros((*lead, Nxe), dtype=torch.int32)
    r = torch.zeros((*lead, 2, 2, Nxe - 2 * W, Nthe - 2 * W))
    k7 = halo._NormalLaunch(planes, planes, off, M0, sms=132)
    out = k7(planes)
    out_d, dots = k7(planes, r)
    FE, FO = halo._ForceLaunch(planes, planes, off, sms=132)(planes, M0, BETA)
    assert out.shape == out_d.shape == r.shape
    assert dots.shape == (*lead, 4) and dots.dtype == torch.float32
    assert FE.shape == FO.shape == (*lead, 2, Nxe - 2 * W, Nthe - 2 * W)
    (a, b, c) = recorder.calls
    n = C * rx * rt
    split = want[0] == tr.CG_SHARED and want[1] > 1
    for args, dots_arg in ((a, 0), (b, 1)):
        assert args[8:11] == (n, Nxe, Nthe) and args[12] == dots_arg
        assert args[13:15] == want
        assert (args[7] is None) == (want[0] == tr.CG_SHARED and not split)
    if split:
        assert k7.scratch.dtype == torch.float64 and not k7.scratch.any()
        assert k7.scratch.numel() == n * want[1] * 4 + (n + 1) // 2
    assert c[7:10] == (C * rx * rt, Nxe, Nthe)
    assert c[12:14] == want and (c[6] is None) == (want[0] == tr.CG_SHARED)
    # a call checks the fields it is given, and launches nothing it refuses
    with pytest.raises(ValueError, match="v_ext: expected shape"):
        k7(planes[..., :-1])
    with pytest.raises(ValueError, match="r_loc: expected torch.float32"):
        k7(planes, r.double())
    assert len(recorder.calls) == 3
    assert halo.halo_path_name(Nxe, Nthe, C * rx * rt, 132) == (
        "global" if want[0] == tr.CG_GLOBAL else
        "shared" if want[1] == 1 else f"shared, {want[1]} blocks a shard")


def test_fused_operator_checks_its_planes_when_built(rng):
    """EOOperatorsHaloFused refuses planes the kernels cannot take when it is
    built (f64 links: the fused path is f32), and the plane check refuses
    a bad offset shape, a non-contiguous plane, a block without the 2x2
    plane axes or without interior; good planes build on the CPU without a
    launch path."""
    with pytest.raises(ValueError, match="ue_ext: expected torch.float32"):
        _operator(rng, (2, 2), 1, torch.complex128)
    _, op = _operator(rng, (2, 2), 1)
    assert op._k7 is None
    ue, uo, off = op.ue_ext, op.uo_ext, op.off_ext
    with pytest.raises(ValueError, match="off_ext: expected shape"):
        halo._check_planes(ue, uo, off[..., 1:])
    with pytest.raises(ValueError, match="uo_ext: expected a contiguous"):
        halo._check_planes(ue, uo.transpose(-1, -2).contiguous().transpose(-1, -2), off)
    with pytest.raises(ValueError, match="uo_ext: expected shape"):
        halo._check_planes(ue, uo[..., :-1], off)
    with pytest.raises(ValueError, match=r"ue_ext: expected \[\*lead, 2, 2"):
        halo._check_planes(ue.reshape(-1, 4, *ue.shape[-2:]), uo, off)
    with pytest.raises(ValueError, match="no interior"):
        halo._check_planes(ue[..., :8, :], uo[..., :8, :], off[..., :8])
    halo._check_planes(ue, uo, off)
