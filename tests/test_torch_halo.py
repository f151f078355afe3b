"""The lattice-sharded layer of the PyTorch port: the geometry on a mesh of
shards, the mesh's collectives, the wide-halo extension, kernels K7
(per-shard Dhat Dhat^+ with the CG dot partials) and K8 (per-shard force),
the sharded operators and the sharded K7 CG.

On the CPU each wrapper runs its plain twin. The JAX side runs under
``shard_map`` on the 8 virtual CPU devices of tests/conftest.py, its Pallas
kernels in interpret mode, x64 on; inputs come from a numpy seed and go to
both packages through ``parallel.mesh.shard``. The CUDA kernels are held
against the same twins on the card by tests/test_torch_card_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu.ops import eo_halo as jeo_halo
from schwingermodel_tpu.ops import gauge as jgauge
from schwingermodel_tpu.ops import pallas_halo
from schwingermodel_tpu.ops.geometry import ShardedGeometry as JaxShardedGeometry
from schwingermodel_tpu.parallel.mesh import lattice_mesh as jax_lattice_mesh
from schwingermodel_tpu.parallel.sharded import sharded_model as jax_sharded_model
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import eo, eo_halo, gauge, halo
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.ops.geometry import (
    LOCAL, ShardedGeometry, bcast, site,
)
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh, shard, unshard
from schwingermodel_tpu_torch.parallel.sharded import sharded_model
from tests import reference_impl as ref

torch.set_num_threads(1)

M0, BETA = 0.1, 2.0
MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (4, 2)]
SPEC = P(None, "x", "t")
JGEOM = JaxShardedGeometry()


def _jax_model(Nx=16, Nt=16, dtype="float32", fused=None, tol=1e-5):
    return JaxModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=dtype),
        hmc=HMCParams(beta=BETA, m0=M0, even_odd=True, fused_cg=fused,
                      cg=CGParams(tol=tol, max_iter=2000)))


def _port(jmodel, mesh=None):
    lat, hmc, _ = from_jax_config(jmodel.lattice, jmodel.hmc)
    model = SchwingerModel(lattice=lat, hmc=hmc)
    return model if mesh is None else sharded_model(model, mesh)


def _theta(rng, C, Nx=16, Nt=16, dtype=np.float32):
    return rng.uniform(-np.pi, np.pi, (C, 2, Nx, Nt)).astype(dtype)


def _cspinor(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _shard_map(fn, mesh_shape, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=jax_lattice_mesh(mesh_shape),
                                 in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


# ---------- the geometry and the mesh ----------

@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_geometry_matches_unsharded(rng, mesh_shape):
    """shift, gsum, gsum_all and global_coords on a mesh equal the
    one-lattice geometry's, bit for bit in f64 (the sums on integer-valued
    data, where no order of addition rounds)."""
    mesh = lattice_mesh(mesh_shape)
    geom = ShardedGeometry(mesh)
    a = torch.from_numpy(rng.standard_normal((3, 2, 16, 16)))
    for axis in (-2, -1):
        for delta in (+1, -1):
            got = unshard(geom.shift(shard(a, mesh), axis, delta), mesh)
            assert torch.equal(got, LOCAL.shift(a, axis, delta))
    n = torch.from_numpy(rng.integers(-1000, 1000, (3, 2, 16, 16)).astype(np.float64))
    assert torch.equal(geom.gsum(shard(n, mesh)).reshape(3, 2), LOCAL.gsum(n))
    assert torch.equal(geom.gsum_all(shard(n, mesh)).reshape(3), LOCAL.gsum_all(n))
    stacked = geom.gsum_stack([shard(n, mesh).sum(dim=(-3, -2, -1)),
                               shard(2 * n, mesh).sum(dim=(-3, -2, -1))])
    assert stacked.shape == (3, 1, 1, 2)
    assert torch.equal(stacked.reshape(3, 2)[:, 1], 2 * LOCAL.gsum_all(n))
    x, t = geom.global_coords(16 // mesh_shape[0], 16 // mesh_shape[1])
    gx, gt = LOCAL.global_coords(16, 16)
    assert torch.equal(unshard(x.unsqueeze(3), mesh)[0, 0], gx)
    assert torch.equal(unshard(t.unsqueeze(3), mesh)[0, 0], gt)
    if mesh_shape[0] > 1:
        with pytest.raises(NotImplementedError):
            geom.shift(shard(a, mesh), -2, 2)


def test_mesh_collectives_and_layout(rng):
    """shard/unshard are inverse and cut as P(None, 'x', 't'); ppermute is
    a ring, psum keeps the axes at size 1, axis_index counts the ring; site and bcast broadcast as documented."""
    mesh = lattice_mesh((4, 2))
    a = torch.from_numpy(rng.standard_normal((3, 2, 16, 16)))
    s = shard(a.numpy(), mesh)
    assert s.shape == (3, 4, 2, 2, 4, 8) and s.is_contiguous()
    assert torch.equal(s[:, 1, 1], a[..., 4:8, 8:16])
    assert torch.equal(unshard(s, mesh), a)
    assert mesh.axis_size("x") == 4 and mesh.axis_size("t") == 2
    assert mesh.axis_index("x").flatten().tolist() == [0, 1, 2, 3]
    assert mesh.axis_index("t").shape == (1, 1, 2)
    moved = mesh.ppermute(s, "x", +1)           # shard i's block goes to i+1
    assert torch.equal(moved[:, 2], s[:, 1]) and torch.equal(moved[:, 0], s[:, 3])
    assert torch.equal(mesh.psum(s)[:, 0, 0], s.sum(dim=(1, 2)))
    assert torch.equal(mesh.psum(s, ("t",))[:, :, 0], s.sum(dim=2))
    back = mesh.ppermute(moved, "x", -1)
    assert torch.equal(back, s)
    assert torch.equal(mesh.ppermute(s, "t", +1)[:, :, 0], s[:, :, 1])
    off = eo.row_offset(4, eo.EVEN, None, ShardedGeometry(mesh))
    assert off.shape == (1, 4, 2, 4, 1)
    assert site(off, s).shape == (1, 4, 2, 1, 4, 1)
    assert bcast(torch.zeros(3, 1, 1), s).shape == (3, 1, 1, 1, 1, 1)
    assert lattice_mesh().shape == (1, 1)
    with pytest.raises(ValueError):
        lattice_mesh((0, 2))
    with pytest.raises(ValueError):
        shard(a, lattice_mesh((3, 1)))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (4, 2), (1, 2)])
def test_pack_and_operators_on_a_mesh_equal_unsharded(rng, mesh_shape):
    """pack/unpack from global coordinates (the odd local Nx on four x-shards makes
    neighbouring shards' offsets differ), the per-hop EOOperators and the
    wide-halo EOOperatorsHalo in f64: equal to the unsharded operator to
    1e-12, and to each other."""
    Nx, Nt = 12, 16                              # local Nx = 3 on 4 x-shards
    jm = _jax_model(Nx, Nt, "float64")
    mesh = lattice_mesh(mesh_shape)
    model, inner = _port(jm), _port(jm, mesh)
    theta = torch.from_numpy(_theta(rng, 2, Nx, Nt, np.float64))
    v = torch.from_numpy(_cspinor(rng, (2, 2, Nx, Nt // 2), np.complex128))
    a = torch.from_numpy(rng.standard_normal((2, 2, Nx, Nt)))
    for parity in (eo.EVEN, eo.ODD):
        got = unshard(eo.pack(shard(a, mesh), parity, inner.geom), mesh)
        assert torch.equal(got, eo.pack(a, parity))
    E, O = shard(eo.pack(a, eo.EVEN), mesh), shard(eo.pack(a, eo.ODD), mesh)
    assert torch.equal(unshard(eo.unpack(E, O, inner.geom), mesh), a)

    want = model.eo_ops(theta).normal(v)
    ops = inner.eo_ops(shard(theta, mesh))
    perhop = unshard(ops.normal(shard(v, mesh)), mesh)
    np.testing.assert_allclose(perhop.numpy(), want.numpy(), rtol=0, atol=1e-12)
    Nx_l, Nth_l = ops.Ue.shape[-2:]
    if eo_halo.supported(inner.geom, Nx_l, Nth_l):
        wide = eo_halo.EOOperatorsHalo(inner.geom, ops.Uf, M0).normal(shard(v, mesh))
        np.testing.assert_allclose(unshard(wide, mesh).numpy(), want.numpy(),
                                   rtol=0, atol=1e-12)
    else:
        assert mesh_shape == (4, 2) or mesh_shape == (4, 1)   # local Nx = 3 < W
    # and the unsharded operator is the JAX one
    jwant = jax.vmap(lambda th, vv: jm.eo_ops(th).normal(vv))(
        jnp.asarray(theta.numpy()), jnp.asarray(v.numpy()))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 2)])
def test_extend_and_offsets_match_jax(rng, mesh_shape):
    """eo_halo.extend (t first, then x of the t-extended array: corners)
    and the extended rows' offsets equal JAX's under shard_map, exactly."""
    Nx, Nt = 16, 16
    mesh = lattice_mesh(mesh_shape)
    geom = ShardedGeometry(mesh)
    a = rng.standard_normal((2, Nx, Nt // 2)).astype(np.float32)
    jext = _shard_map(lambda x: jeo_halo.extend(JGEOM, x), mesh_shape,
                      (SPEC,), SPEC)(jnp.asarray(a))
    got = unshard(eo_halo.extend(geom, shard(a[None], mesh)), mesh)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jext))

    Nx_l, Nth_l = Nx // mesh_shape[0], Nt // 2 // mesh_shape[1]
    joff = _shard_map(
        lambda x: jeo_halo._ext_offsets(JGEOM, Nx_l, Nth_l, jeo_halo.W),
        mesh_shape, (SPEC,), (P("x", None), P("x", None)))(jnp.asarray(a))
    off_e, off_o = eo_halo._ext_offsets(geom, Nx_l, eo_halo.W)
    assert off_e.shape == (1, mesh_shape[0], 1, Nx_l + 8, 1)
    np.testing.assert_array_equal(off_e.reshape(-1, 1).numpy(), np.asarray(joff[0]))
    np.testing.assert_array_equal(off_o.reshape(-1, 1).numpy(), np.asarray(joff[1]))


def test_fused_supported_gates():
    """dtype and mesh gating, as JAX's test_fused_supported_gates: f64 never
    fuses, tiny local blocks never fuse, a 1x1 mesh and no mesh never do."""
    geom = ShardedGeometry(lattice_mesh((2, 2)))
    assert not halo.fused_supported(geom, 8, 4, torch.float64)
    assert halo.fused_supported(geom, 8, 4, torch.float32)
    assert not halo.fused_supported(geom, 2, 2, torch.float32)
    assert not halo.fused_supported(ShardedGeometry(lattice_mesh((1, 1))), 8, 4,
                                    torch.float32)
    assert not halo.fused_supported(LOCAL, 8, 4, torch.float32)
    jm = _jax_model(fused=False)
    inner = _port(jm, lattice_mesh((2, 2)))
    assert not inner._use_fused_sharded()
    assert _port(_jax_model(fused=None), lattice_mesh((2, 2)))._use_fused_sharded()


# ---------- K7 and K8 ----------

def _jax_extended_blocks(jm, mesh_shape, theta, fields):
    """JAX's width-4-extended planar links, offsets and extended planar
    fields of every shard, laid side by side (what out_specs P(.., 'x',
    't') concatenates)."""
    inner = jax_sharded_model(jm)

    def run(th, *fs):
        op = pallas_halo.EOOperatorsHaloFused(inner.geom, inner.fermion_links(th),
                                              M0, interpret=True)
        exts = [jeo_halo.extend(inner.geom, pallas_halo._to_planes(f)) for f in fs]
        return (op.ue_ext, op.uo_ext, op.off_ext, *exts)

    spec4 = P(None, None, "x", "t")
    return _shard_map(run, mesh_shape, (SPEC,) * (1 + len(fields)),
                      (spec4, spec4, P("x", None)) + (spec4,) * len(fields))(
        jnp.asarray(theta), *(jnp.asarray(f) for f in fields))


def _port_blocks(mesh, ue, uo, off, *exts):
    """Those side-by-side blocks in the port's [1, rx, rt, ...] layout."""
    rx, rt = mesh.shape
    off = torch.from_numpy(np.array(off)).reshape(1, rx, 1, -1)
    off = off.expand(1, rx, rt, off.shape[-1]).contiguous()
    return (shard(np.asarray(ue)[None], mesh), shard(np.asarray(uo)[None], mesh),
            off, *(shard(np.asarray(e)[None], mesh) for e in exts))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_halo_normal_twin_matches_pallas(rng, mesh_shape):
    """K7's twin against halo_normal_fused(interpret=True) on the same
    extended blocks: out to atol 2e-5 at every site, the four partials to
    1e-5 of the block's largest (the twin accumulates them in f64, Pallas
    in f32, and <r,Ad> of a random r is a cancelling sum)."""
    jm = _jax_model()
    mesh = lattice_mesh(mesh_shape)
    theta = _theta(rng, 1)[0]
    v = _cspinor(rng, (2, 16, 8))
    r = _cspinor(rng, (2, 16, 8))
    ue, uo, off, v_ext = _jax_extended_blocks(jm, mesh_shape, theta, [v])

    def kernel(ue_, uo_, off_, v_, r_):
        out, dots = pallas_halo.halo_normal_fused(
            ue_, uo_, off_, v_, pallas_halo._to_planes(r_), m0=M0, with_dots=True,
            interpret=True)
        return out, dots[None, None, :]

    spec4 = P(None, None, "x", "t")
    jout, jdots = _shard_map(
        kernel, mesh_shape, (spec4, spec4, P("x", None), spec4, SPEC),
        (spec4, P("x", "t", None)))(ue, uo, off, v_ext, jnp.asarray(r))

    pue, puo, poff, pv = _port_blocks(mesh, ue, uo, off, v_ext)
    pres = shard(tr.to_planar(torch.from_numpy(r))[None], mesh)
    out, dots = halo.halo_normal(pue, puo, poff, pv, pres, m0=M0, with_dots=True)
    assert dots.shape == (1, *mesh_shape, 4) and dots.dtype == torch.float32
    np.testing.assert_allclose(unshard(out, mesh)[0].numpy(), np.asarray(jout),
                               rtol=0, atol=2e-5)
    jdots = np.asarray(jdots)
    scale = np.abs(jdots).max(axis=-1, keepdims=True)
    assert np.all(np.abs(dots[0].numpy() - jdots) <= 1e-5 * scale)
    plain = halo.halo_normal(pue, puo, poff, pv, m0=M0)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_halo_force_twin_matches_pallas(rng, mesh_shape):
    """K8's twin through force_halo_fused against JAX's (interpret) and
    against JAX's jnp force (autodiff fermion force + staples): atol 2e-5
    at every site, the shard skirts included."""
    jm = _jax_model()
    mesh = lattice_mesh(mesh_shape)
    jinner = jax_sharded_model(jm)
    theta = _theta(rng, 1)[0]
    psi = _cspinor(rng, (2, 16, 8))

    def fused(th, ps):
        return pallas_halo.force_halo_fused(
            jinner.geom, jinner.fermion_links(th), M0, ps, BETA, interpret=True)

    def jnp_force(th, ps):
        ops = jinner.eo_ops(th)
        F = jeo.eo_fermion_force(jinner.fermion_links, jinner.geom, M0, th, ps,
                                 ops.dhat_dag(ps))
        return F + jgauge.gauge_force(jinner.geom, jinner.links(th), BETA)

    args = (jnp.asarray(theta), jnp.asarray(psi))
    want = _shard_map(fused, mesh_shape, (SPEC, SPEC), SPEC)(*args)
    want_jnp = _shard_map(jnp_force, mesh_shape, (SPEC, SPEC), SPEC)(*args)

    inner = _port(jm, mesh)
    Uf = inner.field_fermion_links(shard(theta[None], mesh))
    F = halo.force_halo_fused(inner.geom, Uf, M0, shard(psi[None], mesh), BETA)
    got = unshard(F, mesh)[0].numpy()
    assert got.shape == (2, 16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_jnp), rtol=0, atol=2e-5)
    # the model's force dispatch takes this branch on the mesh
    ops = inner.eo_ops(shard(theta[None], mesh))
    assert inner._fused_sharded(ops)


def test_halo_wrappers_refuse_bad_blocks():
    """An extended block without interior is refused on any device, and
    the choice between shared memory and the global scratch follows the
    block's size: one block a shard where it fits, its rows split over
    several where it does not, the global scratch where no split holds
    it."""
    z = torch.zeros((1, 2, 2, 8, 12))
    off = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no interior"):
        halo.halo_normal(z, z, off, z, m0=M0)          # Nxe = 2W: empty crop
    with pytest.raises(ValueError, match="no interior"):
        halo.halo_force(z, z, off, z, m0=M0, beta=BETA)
    assert halo.halo_path(40, 24, 128, 132) == (tr.CG_SHARED, 1)  # 77 KB: one block
    assert halo.halo_path(72, 40, 2, 132) == (tr.CG_SHARED, 8)    # 230 KB: 8 blocks
    assert halo.halo_path(264, 136, 4, 132) == (tr.CG_GLOBAL, 1)  # no split holds it


# ---------- the closed-form force ----------

@pytest.mark.parametrize("mesh_shape", [None, (2, 2), (4, 2)])
def test_closed_form_fermion_force_matches_jax_autodiff(rng, mesh_shape):
    """eo.eo_fermion_force (the checkerboard stencil through a geometry)
    against JAX's autodiff eo_fermion_force in f64, and the staple force
    against JAX's gauge_force: 1e-12, with and without a mesh."""
    Nx, Nt = 8, 16
    jm = _jax_model(Nx, Nt, "float64")
    theta = _theta(rng, 1, Nx, Nt, np.float64)
    psi = _cspinor(rng, (1, 2, Nx, Nt // 2), np.complex128)
    jops = jm.eo_ops(jnp.asarray(theta[0]))
    want = jeo.eo_fermion_force(jm.fermion_links, jm.geom, M0, jnp.asarray(theta[0]),
                                jnp.asarray(psi[0]), jops.dhat_dag(jnp.asarray(psi[0])))
    want_g = jgauge.gauge_force(jm.geom, jm.links(jnp.asarray(theta[0])), BETA)
    if mesh_shape is None:
        model, put, get = _port(jm), torch.from_numpy, lambda a: a
    else:
        mesh = lattice_mesh(mesh_shape)
        model = _port(jm, mesh)
        put, get = (lambda a: shard(a, mesh)), (lambda a: unshard(a, mesh))
    ops = model.eo_ops(put(theta))
    p = put(psi)
    F = get(eo.eo_fermion_force(ops, p, ops.dhat_dag(p)))[0]
    np.testing.assert_allclose(F.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    Fg = get(gauge.gauge_force(model.geom, model.links(put(theta)), BETA))[0]
    np.testing.assert_allclose(Fg.numpy(), np.asarray(want_g), rtol=0, atol=1e-12)
    Sg = model.gauge_action(put(theta)).reshape(1)
    np.testing.assert_allclose(Sg.numpy(), float(jm.gauge_action(jnp.asarray(theta[0]))),
                               rtol=1e-13)


# ---------- the sharded solves ----------

def _oracle_residual(theta, b, x, m0):
    """f64 ||b - (Dhat Dhat^+) x|| / ||b|| of one configuration from the
    full-lattice NumPy oracle D."""
    U = np.exp(1j * theta.astype(np.float64))
    m = m0 + 2.0

    def schur(v_e, D):
        z = np.zeros_like(v_e)
        full = eo.unpack(torch.from_numpy(v_e), torch.from_numpy(z)).numpy()
        y_o = eo.pack(torch.from_numpy(D(U, full, m0)), eo.ODD).numpy()
        w = eo.unpack(torch.from_numpy(z), torch.from_numpy(-y_o / m)).numpy()
        return m * v_e + eo.pack(torch.from_numpy(D(U, w, m0)), eo.EVEN).numpy()

    x = x.astype(np.complex128)
    r = b.astype(np.complex128) - schur(schur(x, ref.dirac_dagger_ref), ref.dirac_ref)
    return np.linalg.norm(r) / np.linalg.norm(b)


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_cg_matches_jax(rng, fused):
    """The model's f32 solve dispatch on a 2x2 mesh against JAX's
    _solve_eo_lo under shard_map: fused_cg=True is the sharded K7 CG
    against cg_solve_sharded_fused (interpret), False the wide-halo
    composite with the plain CG against JAX's. Both converged, iterations
    within 1, x to atol 2e-4, the f64 true residual of the port's solution
    from the NumPy oracle under 2 tol."""
    tol = 1e-5
    jm = _jax_model(fused=fused, tol=tol)
    jinner = jax_sharded_model(jm)
    theta = _theta(rng, 2)
    b = _cspinor(rng, (2, 2, 16, 8))

    def run(th, bb):
        res = jinner._solve_eo_lo(jinner.eo_ops(th), bb)
        return res.x, res.iters, res.converged

    jsolve = _shard_map(run, (2, 2), (SPEC, SPEC), (SPEC, P(), P()))
    mesh = lattice_mesh((2, 2))
    inner = _port(jm, mesh)
    res = inner._solve_eo_lo(inner.eo_ops(shard(theta, mesh)), shard(b, mesh))
    assert res.iters.shape == (2, 1, 1) and res.converged.shape == (2, 1, 1)
    x = unshard(res.x, mesh).numpy()
    for c in range(2):
        jx, jit_, jconv = jsolve(jnp.asarray(theta[c]), jnp.asarray(b[c]))
        print("sharded CG iterations: port", int(res.iters[c]), "jax", int(jit_))
        assert bool(res.converged[c]) and bool(jconv)
        assert abs(int(res.iters[c]) - int(jit_)) <= 1
        np.testing.assert_allclose(x[c], np.asarray(jx), rtol=0, atol=2e-4)
        assert _oracle_residual(theta[c], b[c], x[c], M0) < 2 * tol


def test_sharded_cg_equals_unsharded_k2_and_is_per_chain(rng):
    """The sharded K7 solve against the unsharded K2 twin on the same theta
    and b (a wrong antiperiodic fold in the extended links would still
    converge, to another solution): x to 2e-4, iterations within 1. Chain c
    of a batch equals chain c solved alone, bit for bit, and a starved
    solve reports unconverged with its iterations at the cap."""
    tol = 1e-6
    jm = _jax_model(tol=tol)
    mesh = lattice_mesh((2, 2))
    inner = _port(jm, mesh)
    theta = _theta(rng, 3)
    theta[2] *= 0.05                       # a smoother field: another count
    b = _cspinor(rng, (3, 2, 16, 8))
    Uf = inner.field_fermion_links(shard(theta, mesh))
    res = halo.cg_solve_sharded_fused(inner.geom, Uf, M0, shard(b, mesh), tol=tol,
                                      max_iter=2000)
    thE, thO = tr.pack_planes(torch.from_numpy(theta))
    bp = tr.to_planar(torch.from_numpy(b))
    k2 = tr.solve_fused(thE, thO, bp, bp, m0=M0, tol=tol, max_iter=2000)
    assert bool(res.converged.all()) and bool(k2.converged.all())
    its = res.iters.reshape(3)
    print("iterations: sharded", its.tolist(), "K2", k2.iters.tolist())
    assert int((its - k2.iters).abs().max()) <= 1
    assert len(set(its.tolist())) > 1      # some chain ran on frozen
    np.testing.assert_allclose(tr.to_planar(unshard(res.x, mesh)).numpy(),
                               k2.x.numpy(), rtol=0, atol=2e-4)
    for c in range(3):
        alone = halo.cg_solve_sharded_fused(
            inner.geom, Uf[c:c + 1], M0, shard(b[c:c + 1], mesh), tol=tol,
            max_iter=2000)
        assert torch.equal(alone.x[0], res.x[c])
        assert int(alone.iters) == int(its[c])
    starved = halo.cg_solve_sharded_fused(inner.geom, Uf, M0, shard(b, mesh),
                                          tol=tol, max_iter=3)
    assert not bool(starved.converged.any())
    assert starved.iters.reshape(3).tolist() == [3, 3, 3]
    assert bool(torch.isfinite(starved.x.real).all())
