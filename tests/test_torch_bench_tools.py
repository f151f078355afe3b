"""The port's four bench tools against the JAX package's, on the CPU.

``schwingermodel_tpu_torch/tools/{bench_sharded_kernel,bench_kernels,
bench_points,bench_scaling}.py`` keep the JAX tools' flags, metric names
and row keys; their measured functions are module level. Here the same
numpy-seeded inputs go through the port's functions (the kernels' plain
twins, since the tensors lie on the CPU) and through the JAX package
(Pallas in interpret mode, x64 on as tests/conftest.py sets it), and each
tool produces its rows at 8x8. Tolerances: the f32 local applies within
1e-5 max|y| (a few f32 ulps of the largest entry, as the K7 twin tests
hold); the f32 forces within 3e-5 max(scale, 1) (the force tolerance of
the K1/K8 checks); the sharded CG on the contract (equal flags, true
residual under 2 tol ||b||, iterations within 2: the f32 recursions differ
in summation order); the f64 steps within 1e-12 relative and the f64 solve
within 1e-10 relative, iterations within 1.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.ops import dirac as jdops
from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu.ops import gauge as jgauge
from schwingermodel_tpu.ops import pallas_halo as ph
from schwingermodel_tpu.ops.eo_halo import W as JW
from schwingermodel_tpu.ops.geometry import Geometry as JaxGeometry
from schwingermodel_tpu.ops.geometry import ShardedGeometry as JaxShardedGeometry
from schwingermodel_tpu.parallel.mesh import lattice_mesh as jax_lattice_mesh
from schwingermodel_tpu.parallel.sharded import sharded_model as jax_sharded_model
from schwingermodel_tpu.tools import bench_points as jax_bench_points
from schwingermodel_tpu.tools import bench_scaling as jax_bench_scaling
from schwingermodel_tpu.utils import metrics as jax_metrics
from schwingermodel_tpu_torch.ops import halo
from schwingermodel_tpu_torch.ops.traj import to_complex, to_planar
from schwingermodel_tpu_torch.parallel.mesh import shard, unshard
from schwingermodel_tpu_torch.tools import bench_kernels as bk
from schwingermodel_tpu_torch.tools import bench_points as bp
from schwingermodel_tpu_torch.tools import bench_scaling as bsc
from schwingermodel_tpu_torch.tools import bench_sharded_kernel as bsk
from schwingermodel_tpu_torch.utils import metrics

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
M0, BETA = 0.2, 4.0
NX, NTH = 8, 4                      # the local block of the shard tool
SPEC = P(None, "x", "t")


# ---------- bench_sharded_kernel ----------

@pytest.fixture(scope="module")
def block():
    """The shard tool's draws and block at 8x8, in both packages."""
    theta, v, rhs, psi = bsk.draw_inputs(NX, NTH, 2)
    model, inner = bsk.block_model(NX, 2 * NTH, M0)
    blk = bsk.block_links(model, inner, torch.from_numpy(theta))
    return theta, v, rhs, psi, inner, blk


def _jax_extended_links(theta):
    """The JAX tool's ``prep``: folded, packed, planar, wrapped by W."""
    geom = JaxGeometry()

    def wrap(a):
        return jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(JW, JW), (JW, JW)], mode="wrap")

    U = jgauge.links(jnp.asarray(theta), jnp.complex64)
    sign = jdops.make_sign_mask(geom, NX, 2 * NTH, 2 * NTH, jnp.float32)
    Uf = jdops.fermion_links(U, sign)
    both = wrap(ph._to_planes(jnp.concatenate(
        [jeo.pack(geom, Uf, jeo.EVEN), jeo.pack(geom, Uf, jeo.ODD)], axis=-3)))
    off_e = jnp.asarray((np.arange(-JW, NX + JW) % 2).astype(np.int32)[:, None])
    return geom, wrap, both[:2], both[2:], off_e


def test_local_applies_match_jax_composite_and_pallas(block):
    """The port's plain local apply and its K7 route (the twin here) against
    the JAX tool's jnp composite and halo_normal_fused(interpret=True) on
    the same wrapped block: all four within 1e-5 max|y| of each other."""
    theta, v, _, _, inner, blk = block
    geom, wrap, ue, uo, off_e = _jax_extended_links(theta)
    m = M0 + 2.0
    c = 1.0 / (4.0 * m)
    Ue, Uo = ph._to_complex(ue), ph._to_complex(uo)
    off_o = 1 - off_e
    ve = wrap(jnp.asarray(v))
    w1 = jeo.hop_dag(geom, Uo, Ue, ve, off_o)
    u = m * ve - c * jeo.hop_dag(geom, Ue, Uo, w1, off_e)
    w2 = jeo.hop(geom, Uo, Ue, u, off_o)
    want = np.asarray((m * u - c * jeo.hop(geom, Ue, Uo, w2, off_e))[..., JW:-JW, JW:-JW])
    want_k = np.asarray(ph._to_complex(ph.halo_normal_fused(
        ue, uo, off_e, wrap(ph._to_planes(jnp.asarray(v))), m0=M0, interpret=True)))

    vt = torch.from_numpy(v)[None]
    plain = bsk.local_apply_plain(inner, blk, vt, M0)[0].numpy()
    fused = to_complex(bsk.local_apply_fused(inner, blk, to_planar(vt).contiguous(), M0))
    fused = fused[0].numpy()
    scale = np.abs(want).max()
    for a, b in ((plain, want), (fused, want_k), (plain, fused), (fused, want)):
        assert a.shape == (2, NX, NTH)
        assert np.abs(a - b).max() <= 1e-5 * scale
    # the chained steps normalize: one step is the apply over its norm
    step = bsk.local_steps(inner, blk, vt, 1, M0, fused=False)
    np.testing.assert_allclose(float(step), (plain / np.linalg.norm(plain)).real.sum(),
                               rtol=1e-5)


def _jax_shard_map(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=jax_lattice_mesh((1, 1)), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _jax_block_model():
    return jax_sharded_model(JaxModel(
        lattice=LatticeParams(Nx=NX, Nt=2 * NTH, real_dtype="float32"),
        hmc=HMCParams(beta=BETA, m0=M0, even_odd=True,
                      cg=CGParams(tol=bsk.TOL, max_iter=bsk.MAX_ITER))))


def test_forces_match_jax_composite_and_pallas(block):
    """The port's plain force and its K8 route on the 1x1 mesh against the
    JAX tool's jnp composite and force_halo_fused(interpret=True) under
    shard_map on a 1x1 mesh, within 3e-5 max(scale, 1)."""
    theta, _, _, psi, inner, _ = block
    jinner = _jax_block_model()

    def run(th, ps, fused):
        ops = jinner.eo_ops(th)
        if fused:
            return ph.force_halo_fused(jinner.geom, ops.Uf, M0, ps, BETA, interpret=True)
        F = jeo.eo_fermion_force(jinner.fermion_links, jinner.geom, M0, th, ps,
                                 ops.dhat_dag(ps))
        return F + jgauge.gauge_force(jinner.geom, jinner.links(th), BETA)

    args = (jnp.asarray(theta), jnp.asarray(psi))
    want = {f: np.asarray(_jax_shard_map(lambda th, ps, f=f: run(th, ps, f),
                                         (SPEC, SPEC), SPEC)(*args))
            for f in (False, True)}
    mesh = inner.geom.mesh
    th_s = shard(torch.from_numpy(theta)[None], mesh)
    psi_s = shard(torch.from_numpy(psi)[None], mesh)
    got = {False: bsk.force_plain(inner, th_s, psi_s, M0),
           True: bsk.force_fused(inner, th_s, psi_s, M0)}
    scale = max(np.abs(want[False]).max(), 1.0)
    for f in (False, True):
        g = unshard(got[f], mesh)[0].numpy()
        assert g.shape == (2, NX, 2 * NTH) and g.dtype == np.float32
        for w in want.values():
            assert np.abs(g - w).max() <= 3e-5 * scale
    stepped = bsk.force_steps(inner, th_s, psi_s, 1, M0, fused=True)
    np.testing.assert_allclose(float(stepped), float((th_s + bsk.EPS * got[True]).sum()),
                               rtol=1e-6)


def _true_residual(theta, b, x):
    """f64 ||b - (D^ D^+) x|| / ||b|| of one block through the port's f64
    operator on one lattice."""
    from schwingermodel_tpu_torch.ops import eo
    from schwingermodel_tpu_torch.ops import gauge as tgauge
    from schwingermodel_tpu_torch.ops import dirac as tdops
    from schwingermodel_tpu_torch.ops.geometry import LOCAL

    th = torch.from_numpy(theta).double()[None]
    Uf = tdops.fermion_links(tgauge.field_links(th, torch.complex128),
                             tdops.make_sign_mask(LOCAL, NX, 2 * NTH, 2 * NTH,
                                                  torch.float64, None))
    ops = eo.EOOperators(LOCAL, Uf, M0)
    bb = torch.from_numpy(b).to(torch.complex128)[None]
    r = bb - ops.normal(torch.as_tensor(x).to(torch.complex128)[None])
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bb))


def test_sharded_cg_on_the_contract(block):
    """The 1x1-mesh K7 CG (its twin here) against JAX's
    cg_solve_sharded_fused (interpret) under shard_map on each right-hand
    side: equal flags, both true residuals under 2 tol ||b||, iterations
    within 2 (side by side); the tool's chained solves count the same
    iterations."""
    theta, _, rhs, _, inner, _ = block
    sgeom = JaxShardedGeometry()

    def jsolve(th, bb):
        U = jgauge.links(th, jnp.complex64)
        sign = jdops.make_sign_mask(sgeom, NX, 2 * NTH, 2 * NTH, jnp.float32)
        res = ph.cg_solve_sharded_fused(sgeom, jdops.fermion_links(U, sign), M0, bb,
                                        tol=bsk.TOL, max_iter=bsk.MAX_ITER,
                                        interpret=True)
        return res.x, res.iters, res.converged

    run = _jax_shard_map(jsolve, (SPEC, SPEC), (SPEC, P(), P()))
    mesh = inner.geom.mesh
    th_s = shard(torch.from_numpy(theta)[None], mesh)
    total = 0
    for i in range(rhs.shape[0]):
        jx, jit_, jconv = run(jnp.asarray(theta), jnp.asarray(rhs[i]))
        res = halo.cg_solve_sharded_fused(
            inner.geom, inner.field_fermion_links(th_s), M0,
            shard(torch.from_numpy(rhs[i])[None], mesh), tol=bsk.TOL, max_iter=bsk.MAX_ITER)
        its = int(res.iters.sum())
        total += its
        print(f"right-hand side {i}: iterations port {its}, jax {int(jit_)}")
        assert bool(res.converged.all()) == bool(jconv)
        assert abs(its - int(jit_)) <= 2
        x = unshard(res.x, mesh)[0].numpy()
        assert _true_residual(theta, rhs[i], x) < 2 * bsk.TOL
        assert _true_residual(theta, rhs[i], np.array(jx)) < 2 * bsk.TOL
    rhs_s = shard(torch.from_numpy(rhs)[:, None], mesh)
    _, its = bsk.sharded_cg(inner, th_s, rhs_s, rhs.shape[0], M0)
    assert int(its) == total


def test_sharded_kernel_rows_at_8x8(capsys):
    """The tool's five rows at an 8x8 block with the JAX keys and device."""
    rows = bsk.measure(8, 8, M0, CPU, {"apply": (1, 2), "rhs": (1, 2), "force": (1, 2)},
                       reps=1)
    assert [r["metric"] for r in rows] == [
        "sharded_local_jnp_us", "sharded_local_fused_us", "sharded_cg_iter_us",
        "sharded_force_jnp_us", "sharded_force_fused_us"]
    for r in rows:
        assert {"metric", "value", "unit", "local_block", "backend", "device"} <= set(r)
        assert r["local_block"] == "8x8" and r["backend"] == "cpu" and r["device"] == "cpu"
        assert np.isfinite(r["value"])
    assert "speedup_vs_jnp" in rows[1] and "iters_per_solve" in rows[2]
    assert len(capsys.readouterr().out.splitlines()) == 5


# ---------- bench_kernels ----------

@pytest.fixture(scope="module")
def f64_lattice():
    theta, v_full, v_eo = bk.draw_inputs(8, 8, "float64")
    jm = JaxModel(lattice=LatticeParams(Nx=8, Nt=8, real_dtype="float64"),
                  hmc=HMCParams(beta=BETA, m0=M0, md_steps=10, trajectory_length=0.1,
                                even_odd=True, cg=CGParams(tol=1e-10, max_iter=2000)))
    return bk.make_model(8, 8, BETA, M0, "float64"), jm, theta, v_full, v_eo


def _jnorm(y):
    return y * jax.lax.rsqrt(jnp.real(jnp.sum(jnp.conj(y) * y)))


def test_dirac_and_normal_steps_match_jax(f64_lattice):
    """One normalized D step and one D^ D^+ step against JAX's dops.dirac and
    eo_ops(theta).normal on the same f64 inputs, within 1e-12 relative."""
    model, jm, theta, v_full, v_eo = f64_lattice
    th = torch.from_numpy(theta)
    jth = jnp.asarray(theta[0])
    want = np.asarray(_jnorm(jdops.dirac(jm.geom, jm.fermion_links(jth),
                                         jnp.asarray(v_full[0]), M0)))
    got = bk.dirac_steps(model, th, torch.from_numpy(v_full), 1)[0].numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    want = np.asarray(_jnorm(jm.eo_ops(jth).normal(jnp.asarray(v_eo[0]))))
    got = bk.eo_normal_steps(model, th, torch.from_numpy(v_eo), 1)[0].numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_iters_to_tol_matches_jax(f64_lattice):
    """The solve of D^ v: iterations within 1 of JAX's _solve_eo, the same
    flag, x within 1e-10 relative; and the FLOP constants are JAX's."""
    model, jm, theta, _, v_eo = f64_lattice
    jth = jnp.asarray(theta[0])
    ops = jm.eo_ops(jth)
    res = jm._solve_eo(jth, ops, ops.dhat(jnp.asarray(v_eo[0])))
    it, conv, x = bk.iters_to_tol(model, torch.from_numpy(theta), torch.from_numpy(v_eo))
    print(f"iterations to 1e-10: port {it}, jax {int(res.iters)}")
    assert conv and bool(res.converged)
    assert abs(it - int(res.iters)) <= 1
    jx = np.asarray(res.x)
    assert np.abs(x[0].numpy() - jx).max() <= 1e-10 * np.abs(jx).max()
    assert metrics.DIRAC_FLOPS_PER_SITE == jax_metrics.DIRAC_FLOPS_PER_SITE
    assert metrics.EO_NORMAL_FLOPS_PER_SITE == jax_metrics.EO_NORMAL_FLOPS_PER_SITE


def test_kernels_rows_at_8x8():
    """The tool's seven rows at 8x8 f64 with the JAX keys, device and, on
    the plain applies, the note."""
    win = {"therm": 1, "dirac": (1, 2), "eo": (1, 2), "cg": (1, 2), "traj": (1, 2)}
    rows = bk.measure(8, 8, BETA, M0, "float64", CPU, win, reps=1)
    assert [r["metric"] for r in rows] == [
        "dirac_apply_us", "dirac_apply_gflops", "eo_normal_apply_us",
        "eo_normal_gflops", "cg_us_per_iter", "cg_iters_to_tol", "hmc_traj_per_s"]
    for r in rows:
        assert {"metric", "value", "unit", "lattice", "dtype", "backend",
                "device"} <= set(r)
        assert r["dtype"] == "float64" and r["lattice"] == "8x8"
    assert all("note" in r for r in rows[:4])
    assert rows[5]["unit"] == "iters to 1e-10 (converged=True)"


# ---------- bench_points ----------

JAX_ROW_KEYS = {"metric", "value", "unit", "contract", "lattice", "beta", "m0",
                "md_steps", "tau", "integrator", "chains", "acceptance",
                "cg_iters_per_traj", "all_converged", "backend"}


def test_points_contracts_and_anneal_follow_jax():
    """POINTS is the JAX tool's table; the contracts (refined_only: one);
    the anneal through (0, m0/2) for m0 < 0 only."""
    assert bp.POINTS == jax_bench_points.POINTS
    both = bp.contracts({}, 10000)
    assert [c for c, _ in both] == ["loose_f32_tol1e-6", "refined_1e-10_f64"]
    assert [(cg.tol, cg.refine, cg.max_iter) for _, cg in both] == [
        (1e-6, False, 10000), (1e-10, True, 10000)]
    only = bp.contracts({"mre_history": 4, "refined_only": True}, 20000)
    assert [c for c, _ in only] == ["refined_1e-10_f64"] and only[0][1].max_iter == 20000
    assert bp.anneal_schedule(-0.19) == (0.0, -0.095)
    assert bp.anneal_schedule(0.2) == ()
    model = bp.point_model(bp.POINTS[-1], only[0][1])
    assert (model.lattice.Nx, model.hmc.md_steps, model.hmc.hasenbusch_dm,
            model.hmc.trajectory_length) == (64, 36, 0.4, 1.0)


@pytest.mark.parametrize("extras,m0,keys", [
    ({}, 0.1, set()),
    ({"hasenbusch_dm": 0.4}, -0.19, {"hasenbusch_dm"}),
    ({"tune": True}, 0.1, {"tuned", "tuned_eps", "md_steps_tuned"}),
    ({"mre_history": 4, "refined_only": True}, 0.1, {"mre_history"}),
], ids=["plain", "hasenbusch", "tuned", "mre4"])
def test_points_rows_at_8x8(extras, m0, keys):
    """run_packed at 8x8, C=2, 1 + 1 trajectories (n_tune 2) under each
    contract of the point: rows with the JAX row's keys and device."""
    point = ("8x8_test", 8, 8, 2.0, m0, 4, 0.2, 2, 1, "leapfrog", 2000, extras)
    rows = bp.run_point(point, 1, CPU, n_tune=2)
    assert len(rows) == len(bp.contracts(extras, 2000))
    for r in rows:
        assert JAX_ROW_KEYS | keys | {"device"} <= set(r)
        assert r["metric"] == "hmc_traj_per_s_8x8_test" and r["chains"] == 2
        assert r["value"] > 0 and 0.0 <= r["acceptance"] <= 1.0
        assert r["cg_iters_per_traj"] > 0 and isinstance(r["all_converged"], bool)


def test_points_main_filters_and_writes(tmp_path):
    out = tmp_path / "rows.json"
    assert bp.main(["--device", "cpu", "--only", "no such point", "--json", str(out)]) == 0
    assert json.loads(out.read_text()) == []


# ---------- bench_scaling ----------

def test_parse_meshes_follows_jax():
    spec = "1x1,1x2,2x2,1x4,2x1x2"
    assert bsc._parse_meshes(spec) == jax_bench_scaling._parse_meshes(spec)
    for parse in (bsc._parse_meshes, jax_bench_scaling._parse_meshes):
        with pytest.raises(ValueError):
            parse("2")
    assert bsc.mesh_fits((2, 2), 8, 8) is None
    assert bsc.mesh_fits((3, 1), 8, 8) and bsc.mesh_fits((1, 8), 8, 8)


def test_scaling_meshes_at_8x8(capsys):
    """measure on 1x1 (the unpacked sampler) and 2x2 (the sharded step),
    1 + 1 trajectories, and a shape that does not divide the lattice."""
    rc = bsc.main(["--device", "cpu", "--nx", "8", "--nt", "8", "--meshes",
                   "1x1,2x2,3x1", "--n-therm", "1", "--n-timed", "1"])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    rows = [r for r in lines if "metric" in r]
    assert [r["mesh"] for r in rows] == ["1x1", "2x2"]
    assert lines[-1] == {"mesh": "3x1", "skipped": "3x1 does not divide 8x8"}
    for r in rows:
        assert {"metric", "mesh", "lattice", "dtype", "backend", "value", "unit",
                "cg_iters", "vs_single_device", "device"} <= set(r)
        assert r["shards_on"] == "one device" and r["value"] > 0 and r["cg_iters"] > 0
    assert rows[0]["vs_single_device"] == 1.0


def test_chain_scaling_in_gloo_processes(tmp_path):
    """--chain-scaling 1,2 through real processes (gloo, the three
    multi-host flags) at 8x8, 1 + 1 trajectories: both efficiency keys."""
    out = tmp_path / "scaling.json"
    rc = bsc.main(["--device", "cpu", "--nx", "8", "--nt", "8", "--n-therm", "1",
                   "--n-timed", "1", "--chain-scaling", "1,2", "--json", str(out)])
    assert rc == 0
    summary = json.loads(out.read_text())
    assert summary["metric"] == "chain_axis_scaling_efficiency"
    assert [r["processes"] for r in summary["rows"]] == [1, 2]
    assert [r["chains_total"] for r in summary["rows"]] == [2, 4]
    assert "2 processes" in summary["rows"][1]["layout"]
    for key in ("efficiency", "efficiency_core_saturated"):
        assert np.isfinite(summary[key])
    for r in summary["rows"]:
        assert {"efficiency_vs_linear", "efficiency_vs_core_saturated"} <= set(r)


# ---------- every tool ----------

TOOLS = {"bench_sharded_kernel": bsk, "bench_kernels": bk, "bench_points": bp,
         "bench_scaling": bsc}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_dropped_flags_and_missing_card(name, capsys):
    """--platform and --devices exit 2 naming what replaces them; --device
    cuda without a card exits 1."""
    main = TOOLS[name].main
    assert main(["--platform", "cpu"]) == 2
    assert "--device {cuda,cpu}" in capsys.readouterr().err
    assert main(["--devices", "4"]) == 2
    assert "one-device mesh holds every shard" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    assert main(["--device", "cuda"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_tools_import_no_jax():
    """Importing the four tools pulls in neither jax nor the JAX package."""
    code = ("import sys\n"
            "from schwingermodel_tpu_torch.tools import (bench_kernels, bench_points,"
            " bench_scaling, bench_sharded_kernel)\n"
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'schwingermodel_tpu' or k.startswith('schwingermodel_tpu.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
