"""The rest of the unpacked sampler of the PyTorch port against the JAX
sampler: the full-lattice operators, the Hasenbusch ratio force in closed
form, and same-noise trajectories of every mode added here -- full-D
pseudofermions in f64 and in f32 under the refined contract, an odd
lattice, quenched, f64 even-odd, Hasenbusch on the unpacked sampler
(even-odd and full-D) and on a 2x2 mesh, and the ``dt=``/``beta=``
overrides.

Inputs and noise are made with numpy from a seed (or drawn by JAX's
``sampler.draw_noise``) and handed to both packages; the JAX side runs with
x64 on (tests/conftest.py), its refinement in the x64 implementation.
Tolerances: f64 paths 1e-12 relative on operators and forces, and on
trajectories 1e-9 on dH and theta' (two CG solutions that both meet 1e-12
may differ by that); f32 paths dH to atol 5e-3, theta' to atol 2e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc import sampler as jsampler
from schwingermodel_tpu.models.schwinger import SchwingerModel as JaxModel
from schwingermodel_tpu.ops import dirac as jdirac
from schwingermodel_tpu.ops import eo as jeo
from schwingermodel_tpu.ops.geometry import Geometry as JaxGeometry
from schwingermodel_tpu.parallel.mesh import lattice_mesh as jax_lattice_mesh
from schwingermodel_tpu.parallel.sharded import make_sharded_step as jax_sharded_step
from schwingermodel_tpu.utils import prng as jprng
from schwingermodel_tpu_torch.config import from_jax_config
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel, SolveStats
from schwingermodel_tpu_torch.ops import cg_eo, dirac, eo, halo
from schwingermodel_tpu_torch.ops.geometry import LOCAL
from schwingermodel_tpu_torch.parallel.mesh import lattice_mesh
from schwingermodel_tpu_torch.parallel.sharded import make_sharded_traj_fn
from tests import reference_impl as ref

torch.set_num_threads(1)


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _jax_model(Nx, Nt, *, dtype="float64", even_odd=False, refine=False, dm=None,
               quenched=False, m0=0.1, beta=2.0, md_steps=4, tau=0.4,
               integrator="leapfrog", fused=False, tol=None):
    tol = tol if tol is not None else (1e-12 if dtype == "float64" else
                                      (1e-10 if refine else 1e-6))
    return JaxModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=dtype),
        hmc=HMCParams(beta=beta, m0=m0, md_steps=md_steps, trajectory_length=tau,
                      even_odd=even_odd, quenched=quenched, hasenbusch_dm=dm,
                      integrator=integrator, fused_cg=fused,
                      cg=CGParams(tol=tol, max_iter=4000, refine=refine,
                                  refine_impl="x64", inner_tol=1e-5)))


def _port(jm):
    lat, hmc, _ = from_jax_config(jm.lattice, jm.hmc)
    return SchwingerModel(lattice=lat, hmc=hmc)


def _noise(jm, theta, seed):
    keys = [jprng.trajectory_key(jprng.root_key(seed), c)
            for c in range(theta.shape[0])]
    draws = [jsampler.draw_noise(jm, theta.shape[1:], k) for k in keys]
    return keys, tuple(np.stack([np.asarray(d[i]) for d in draws]) for i in range(3))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------- the full-lattice operators ----------

@pytest.mark.parametrize("Nx,Nt", [(6, 8), (7, 8)])
def test_dirac_operators_match_jax_and_the_oracle(rng, Nx, Nt):
    m0 = 0.13
    theta = rng.uniform(-np.pi, np.pi, (2, Nx, Nt))
    phi, psi = _cplx(rng, (2, Nx, Nt)), _cplx(rng, (2, Nx, Nt))
    jm = _jax_model(Nx, Nt)
    model = _port(jm)
    Uf_j = jm.fermion_links(jnp.asarray(theta))
    th_t, phi_t, psi_t = _t(theta[None], phi[None], psi[None])
    Uf = model.field_fermion_links(th_t)
    np.testing.assert_allclose(Uf[0].numpy(), np.asarray(Uf_j), rtol=1e-14, atol=0)
    U = np.exp(1j * theta)
    g = JaxGeometry()
    for port_fn, jax_fn, oracle in (
            (dirac.dirac, jdirac.dirac, ref.dirac_ref),
            (dirac.dirac_dagger, jdirac.dirac_dagger, ref.dirac_dagger_ref)):
        got = port_fn(LOCAL, Uf, phi_t, m0)[0].numpy()
        np.testing.assert_allclose(got, np.asarray(jax_fn(g, Uf_j, jnp.asarray(phi), m0)),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(got, oracle(U, phi, m0), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(
        dirac.dirac_normal(LOCAL, Uf, phi_t, m0)[0].numpy(),
        np.asarray(jdirac.dirac_normal(g, Uf_j, jnp.asarray(phi), m0)),
        rtol=1e-12, atol=1e-12)
    F = dirac.fermion_force(LOCAL, Uf, psi_t, phi_t)[0].numpy()
    np.testing.assert_allclose(
        F, np.asarray(jdirac.fermion_force(g, Uf_j, jnp.asarray(psi), jnp.asarray(phi))),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(F, ref.fermion_force_ref(U, psi, phi), rtol=1e-12,
                               atol=1e-12)
    # the model's operators, and D^+ as the adjoint of D
    np.testing.assert_allclose(model.D(th_t, phi_t)[0].numpy(),
                               np.asarray(jm.D(jnp.asarray(theta), jnp.asarray(phi))),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(model.DDdag(th_t, phi_t)[0].numpy(),
                               np.asarray(jm.DDdag(jnp.asarray(theta), jnp.asarray(phi))),
                               rtol=1e-12, atol=1e-12)
    lhs = dirac.spinor_dot(LOCAL, psi_t, model.D(th_t, phi_t))
    rhs = dirac.spinor_dot(LOCAL, model.Ddag(th_t, psi_t), phi_t)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-12)


def test_spinor_reductions_match_jax(rng):
    x, y = _cplx(rng, (3, 2, 6, 4)), _cplx(rng, (3, 2, 6, 4))
    xt, yt = _t(x, y)
    g = JaxGeometry()
    for c in range(3):
        np.testing.assert_allclose(
            complex(dirac.spinor_dot(LOCAL, xt, yt)[c]),
            complex(jdirac.spinor_dot(g, jnp.asarray(x[c]), jnp.asarray(y[c]))),
            rtol=1e-13)
        np.testing.assert_allclose(
            float(dirac.spinor_norm2(LOCAL, xt)[c]),
            float(jdirac.spinor_norm2(g, jnp.asarray(x[c]))), rtol=1e-13)
        want = jdirac.spinor_dot_re_batch(
            g, [(jnp.asarray(x[c]), jnp.asarray(y[c])), (jnp.asarray(y[c]),) * 2])
        got = dirac.spinor_dot_re_batch(LOCAL, [(xt, yt), (yt, yt)])[c]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_eo_ratio_force_matches_jax_gradient(rng):
    """The closed form against JAX's autodiff gradient, 1e-12 in f64."""
    Nx, Nt, m0, m1 = 6, 8, -0.1, 0.3
    jm = _jax_model(Nx, Nt, even_odd=True, m0=m0, dm=m1 - m0)
    model = _port(jm)
    theta = rng.uniform(-np.pi, np.pi, (2, Nx, Nt))
    psi, chi_p, phi2 = (_cplx(rng, (2, Nx, Nt // 2)) for _ in range(3))
    want = jeo.eo_ratio_force(jm.fermion_links, jm.geom, m0, m1, jnp.asarray(theta),
                              jnp.asarray(psi), jnp.asarray(chi_p), jnp.asarray(phi2))
    th_t, psi_t, chi_t, phi2_t = _t(theta[None], psi[None], chi_p[None], phi2[None])
    got = eo.eo_ratio_force(model.eo_ops(th_t), model.heavy_model().eo_ops(th_t),
                            psi_t, chi_t, phi2_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("even_odd", [True, False])
def test_hasenbusch_heat_bath_and_force_match_jax(rng, even_odd):
    """pseudofermion_fields and the two-term force, f64, against JAX."""
    Nx, Nt = 6, 8
    jm = _jax_model(Nx, Nt, even_odd=even_odd, m0=-0.1, dm=0.4)
    model = _port(jm)
    assert model.chi_shape((2, Nx, Nt)) == jm.chi_shape((2, Nx, Nt))
    theta = rng.uniform(-np.pi, np.pi, (2, Nx, Nt))
    chi = _cplx(rng, jm.chi_shape(theta.shape)) / np.sqrt(2)
    from schwingermodel_tpu.models.schwinger import SolveStats as JStats

    (jphi1, jphi2), _ = jm.pseudofermion_fields(jnp.asarray(theta), jnp.asarray(chi),
                                                JStats.zero())
    th_t, chi_t = _t(theta[None], chi[None])
    stats = SolveStats.zero(torch.zeros(1))
    (phi1, phi2), stats = model.pseudofermion_fields(th_t, chi_t, stats)
    assert stats.n_solves == 1 and bool(stats.all_converged.all())
    np.testing.assert_allclose(phi1[0].numpy(), np.asarray(jphi1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(phi2[0].numpy(), np.asarray(jphi2), rtol=0, atol=1e-10)
    jF, _, _ = jm.force(jnp.asarray(theta), (jphi1, jphi2), JStats.zero())
    F, stats, psi = model.force(th_t, (phi1, phi2), stats)
    assert stats.n_solves == 3 and isinstance(psi, tuple)
    np.testing.assert_allclose(F[0].numpy(), np.asarray(jF), rtol=0,
                               atol=1e-9 * float(np.abs(np.asarray(jF)).max()))
    # the heat-bath identity: S1 + S2 at the old theta is |chi1|^2 + |chi2|^2
    sf, _ = model.fermion_action(th_t, (phi1, phi2), stats)
    np.testing.assert_allclose(float(sf[0]), float((np.abs(chi) ** 2).sum()), rtol=1e-9)


# ---------- same-noise trajectories against the JAX sampler ----------

TRAJ_CASES = {
    "fulld_f64": dict(Nx=8, Nt=8),
    "fulld_f64_omelyan": dict(Nx=6, Nt=8, integrator="omelyan", md_steps=3),
    "fulld_f32_refined": dict(Nx=8, Nt=8, dtype="float32", refine=True),
    "odd_lattice_f64": dict(Nx=7, Nt=8),
    "odd_lattice_f32_refined": dict(Nx=7, Nt=8, dtype="float32", refine=True),
    "quenched_f64": dict(Nx=8, Nt=8, quenched=True),
    "quenched_f32": dict(Nx=8, Nt=8, quenched=True, dtype="float32"),
    "eo_f64": dict(Nx=8, Nt=8, even_odd=True),
    "hasenbusch_eo_f64": dict(Nx=8, Nt=8, even_odd=True, dm=0.4, m0=-0.1),
    "hasenbusch_fulld_f64": dict(Nx=8, Nt=8, dm=0.4, m0=-0.1),
    "hasenbusch_eo_f32_refined": dict(Nx=8, Nt=8, even_odd=True, dm=0.4, m0=-0.1,
                                      dtype="float32", refine=True),
    "hasenbusch_eo_f32_loose": dict(Nx=8, Nt=8, even_odd=True, dm=0.4, m0=-0.1,
                                    dtype="float32"),
}


@pytest.mark.parametrize("case", sorted(TRAJ_CASES))
def test_trajectory_matches_jax(rng, case):
    kw = TRAJ_CASES[case]
    jm = _jax_model(**kw)
    f64 = jm.lattice.real_dtype == "float64"
    Nx, Nt = kw["Nx"], kw["Nt"]
    theta = rng.uniform(-np.pi, np.pi, (2, 2, Nx, Nt)).astype(jm.lattice.real_dtype)
    _, (pi, chi, r) = _noise(jm, theta, 21)
    model = _port(jm)
    th, st = sampler.trajectory_given_noise(model, *_t(theta, pi, chi, r))
    assert st.delta_H.dtype == torch.float64 and bool(st.cg_converged.all())
    assert th.dtype == (torch.float64 if f64 else torch.float32)
    if kw.get("quenched"):
        assert int(st.cg_iters.sum()) == 0            # no solve at all
    else:
        assert int(st.cg_iters.min()) > 0
    atol_dH, atol_th = (1e-9, 1e-9) if f64 else (5e-3, 2e-4)
    for c in range(2):
        jth, jst = jsampler.trajectory_given_noise(
            jm, jnp.asarray(theta[c]), jnp.asarray(pi[c]), jnp.asarray(chi[c]),
            jnp.asarray(r[c]))
        assert bool(jst.cg_converged)
        print(case, "dH port", float(st.delta_H[c]), "jax", float(jst.delta_H))
        np.testing.assert_allclose(float(st.delta_H[c]), float(jst.delta_H),
                                   rtol=0, atol=atol_dH)
        np.testing.assert_allclose(th[c].numpy(), np.asarray(jth), rtol=0, atol=atol_th)
        if abs(float(r[c]) - np.exp(-float(jst.delta_H))) > 2e-2:
            assert bool(st.accepted[c]) == bool(jst.accepted)


@pytest.mark.parametrize("quenched", [True, False])
def test_dt_and_beta_overrides_match_jax(rng, quenched):
    """A trajectory at overridden dt and beta equals JAX's at the same
    overrides, and the model built with those values."""
    Nx = Nt = 8
    jm = _jax_model(Nx, Nt, even_odd=not quenched, quenched=quenched)
    theta = rng.uniform(-np.pi, np.pi, (1, 2, Nx, Nt))
    _, (pi, chi, r) = _noise(jm, theta, 5)
    model = _port(jm)
    dt, beta = 0.07, 3.3
    th, st = sampler.trajectory_given_noise(model, *_t(theta, pi, chi, r), dt=dt,
                                            beta=beta)
    jth, jst = jsampler.trajectory_given_noise(
        jm, jnp.asarray(theta[0]), jnp.asarray(pi[0]), jnp.asarray(chi[0]),
        jnp.asarray(r[0]), dt, beta)
    np.testing.assert_allclose(float(st.delta_H[0]), float(jst.delta_H), rtol=0, atol=1e-9)
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jth), rtol=0, atol=1e-9)
    static = dataclasses.replace(model, hmc=dataclasses.replace(
        model.hmc, beta=beta, trajectory_length=dt * model.hmc.md_steps))
    th_s, st_s = sampler.trajectory_given_noise(static, *_t(theta, pi, chi, r))
    np.testing.assert_allclose(st.delta_H.numpy(), st_s.delta_H.numpy(), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(th.numpy(), th_s.numpy(), rtol=0, atol=1e-12)


def test_f64_never_reaches_the_f32_kernel(rng):
    """Under f64 working precision fused_cg=True does not route the solves
    to K6 (an f32 kernel): the twin's call counter stays where it was."""
    jm = _jax_model(8, 8, even_odd=True)
    model = _port(jm)
    model = dataclasses.replace(model, hmc=dataclasses.replace(model.hmc, fused_cg=True))
    assert not model._refine_active()
    calls = []
    orig = cg_eo.cg_solve_eo_reference
    cg_eo.cg_solve_eo_reference = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        theta = rng.uniform(-np.pi, np.pi, (1, 2, 8, 8))
        _, (pi, chi, r) = _noise(jm, theta, 2)
        _, st = sampler.trajectory_given_noise(model, *_t(theta, pi, chi, r))
    finally:
        cg_eo.cg_solve_eo_reference = orig
    assert not calls and bool(st.cg_converged.all())


# ---------- Hasenbusch on a mesh ----------

@pytest.mark.parametrize("refine", [False, True])
def test_hasenbusch_on_a_mesh_matches_jax(rng, refine):
    """Hasenbusch dm=0.4 at 16x16 on 2x2 shards (local blocks that take the
    fused path) against JAX's 2D-mesh step on the same noise: the solves go
    through K7's sharded CG (its twin here: halo_normal's counter stays),
    the forces through the plain geometry, so K8's twin is never called."""
    Nx = Nt = 16
    jm = _jax_model(Nx, Nt, dtype="float32", even_odd=True, refine=refine, dm=0.4,
                    m0=0.0, fused=True, md_steps=3, tau=0.3)
    theta = rng.uniform(-np.pi, np.pi, (1, 2, Nx, Nt)).astype(np.float32)
    keys, (pi, chi, r) = _noise(jm, theta, 9)
    assert chi.shape == (1, 2, 2, Nx, Nt // 2)
    jth, jst = jax_sharded_step(jm, jax_lattice_mesh((2, 2)))(jnp.asarray(theta[0]),
                                                              keys[0])
    model = _port(jm)
    used = {"k7": 0, "k8": 0}
    orig7, orig8 = halo.halo_normal_reference, halo.halo_force_reference

    def count(name, fn):
        def wrapped(*a, **k):
            used[name] += 1
            return fn(*a, **k)
        return wrapped

    halo.halo_normal_reference = count("k7", orig7)
    halo.halo_force_reference = count("k8", orig8)
    try:
        th, st = make_sharded_traj_fn(model, lattice_mesh((2, 2))).given_noise(
            *_t(theta, pi, chi, r))
    finally:
        halo.halo_normal_reference, halo.halo_force_reference = orig7, orig8
    assert used["k7"] > 0 and used["k8"] == 0
    assert bool(st.cg_converged.all()) and bool(jst.cg_converged)
    print("refine", refine, "dH port", st.delta_H.tolist(), "jax", float(jst.delta_H))
    np.testing.assert_allclose(st.delta_H.numpy(), [float(jst.delta_H)], rtol=0, atol=5e-3)
    print("max |dtheta'| vs jax", float(np.abs(th[0].numpy() - np.asarray(jth)).max()))
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jth), rtol=0, atol=2e-4)
    # and against the port's own unsharded sampler, same noise
    th_u, st_u = sampler.trajectory_given_noise(model, *_t(theta, pi, chi, r))
    np.testing.assert_allclose(st.delta_H.numpy(), st_u.delta_H.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(th.numpy(), th_u.numpy(), rtol=0, atol=2e-4)


def test_full_d_on_a_mesh_equals_unsharded(rng):
    """Full-D f64 pseudofermions on a 2x2 mesh: the geometry alone."""
    jm = _jax_model(8, 8)
    model = _port(jm)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, 8, 8))
    _, (pi, chi, r) = _noise(jm, theta, 4)
    th_s, st_s = make_sharded_traj_fn(model, lattice_mesh((2, 2))).given_noise(
        *_t(theta, pi, chi, r))
    th_u, st_u = sampler.trajectory_given_noise(model, *_t(theta, pi, chi, r))
    np.testing.assert_allclose(st_s.delta_H.numpy(), st_u.delta_H.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(th_s.numpy(), th_u.numpy(), rtol=0, atol=1e-10)


# ---------- the measurement solve off the packed kernels ----------

@pytest.mark.parametrize("even_odd,dtype,refine", [(False, "float64", False),
                                                   (True, "float64", False),
                                                   (False, "float32", True)])
def test_dirac_inverse_off_the_kernel_path_matches_jax(rng, even_odd, dtype, refine):
    Nx, Nt = 6, 8
    jm = _jax_model(Nx, Nt, dtype=dtype, even_odd=even_odd, refine=refine, tol=1e-10)
    model = _port(jm)
    theta = rng.uniform(-np.pi, np.pi, (2, 2, Nx, Nt)).astype(dtype)
    z = _cplx(rng, (2, 3, 2, Nx, Nt), np.complex128 if dtype == "float64" else np.complex64)
    w, res = model.dirac_inverse(*_t(theta, z))
    assert w.shape == z.shape and res.converged.shape == (2, 3)
    assert bool(res.converged.all())
    for c in range(2):
        for k in range(3):
            jw, jres = jm.dirac_inverse(jnp.asarray(theta[c]), jnp.asarray(z[c, k]))
            assert bool(jres.converged)
            np.testing.assert_allclose(
                w[c, k].numpy(), np.asarray(jw), rtol=0,
                atol=(1e-8 if dtype == "float64" else 2e-5) * np.abs(np.asarray(jw)).max())
    # D w = z
    back = model.D(torch.from_numpy(theta)[:, None], w.to(model.lattice.cdtype))
    np.testing.assert_allclose(back.numpy(), z, rtol=0,
                               atol=1e-8 if dtype == "float64" else 1e-4)
    normal = model.solve_normal(torch.from_numpy(theta),
                                torch.from_numpy(z[:, 0]).to(model.lattice.cdtype))
    assert bool(normal.converged.all())
