"""Where K1 and K2 keep their fields, and the integrator gates of the JAX
suite on the port's trajectories.

``ops/traj.cg_path`` chooses, from the lattice size and the chain count
alone, one block's shared memory, several blocks a chain (K1 without the
solve) or the global scratch; its byte reckoning is held against the
kernels' (csrc/shared_stencil.cuh, force_step.cu): 96 bytes a site for the
CG store, 8 more for K1's plaquette angles, 4 sites a thread of 512, 220
KiB a block, 4 halo rows on either side of a block's own rows. The
timing tool ``tools/bench_force_solve.py`` (K1, K2, K5, K6 on the card)
has its arguments checked here.

The port's counterparts of ``tests/test_balance.py:96,121,203`` and
``tests/test_hasenbusch.py:133`` (|dH| falls as dt^2; leapfrog, Omelyan and
Hasenbusch trajectories are reversible) run the port's unpacked sampler on
the CPU in float64 at 8x8, against the same bounds as JAX.
"""

import math

import numpy as np
import pytest
import torch

from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.hmc.integrators import leapfrog, omelyan
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel, SolveStats
from schwingermodel_tpu_torch.ops import traj as tr
from schwingermodel_tpu_torch.tools import bench_force_solve

torch.set_num_threads(1)

SHARED_MAX, SITES, HALO = 220 * 1024, 4 * 512, 4


# ---------- the path by lattice size ----------

@pytest.mark.parametrize("Nx,Nt,C,solve,gauge,path", [
    (8, 8, 3, True, False, "shared"),             # K2
    (8, 8, 3, True, True, "shared"),              # K1 with its CG
    (8, 8, 3, False, True, "shared"),             # too few rows to split
    (16, 16, 2, False, True, "shared, 2 blocks a chain"),
    (20, 34, 2, True, False, "shared"),           # odd extents
    (20, 34, 2, False, False, "shared, 2 blocks a chain"),
    (32, 32, 32, True, False, "shared"),
    (32, 32, 32, False, True, "shared, 4 blocks a chain"),
    (64, 64, 1, False, True, "shared, 8 blocks a chain"),
    (64, 64, 32, True, False, "shared"),
    (64, 64, 32, True, True, "shared"),
    (64, 64, 32, False, True, "shared, 4 blocks a chain"),
    (64, 64, 32, False, False, "shared, 4 blocks a chain"),
    (64, 64, 128, True, True, "shared"),
    (64, 64, 128, False, True, "shared"),          # 128 blocks fill the card
    (66, 64, 4, False, True, "shared, 2 blocks a chain"),
    (128, 128, 8, True, False, "global"),
    (128, 128, 8, True, True, "global"),
    (128, 128, 8, False, True, "shared, 8 blocks a chain"),
    (128, 128, 32, False, False, "shared, 8 blocks a chain"),
    (126, 128, 2, False, True, "global"),          # no 2, 4, 8 divides it
    (256, 256, 2, False, True, "global")])
def test_cg_path_by_lattice_size(Nx, Nt, C, solve, gauge, path):
    """The path follows from the lattice size and the chain count, within
    what a block's threads and shared memory hold."""
    Nth = Nt // 2
    assert tr.cg_path_name(Nx, Nth, C, 132, solve, gauge) == path
    idx, n = tr.cg_path(Nx, Nth, C, 132, solve, gauge)
    per_site = 96 + (8 if gauge else 0)

    def fits(n):
        rows = Nx // n
        sites = (rows + (2 * HALO if n > 1 else 0)) * Nth
        return (Nx % n == 0 and (n == 1 or rows >= 2 * HALO) and sites <= SITES
                and per_site * sites <= SHARED_MAX)

    if idx == tr.CG_GLOBAL:
        assert not any(fits(m) for m in ((1,) if solve else (1, 2, 4, 8)))
        return
    # the most blocks a chain whose C chains all run at once, else the
    # fewest that hold the lattice; the solves never split a chain
    held = [m for m in ((1,) if solve else (1, 2, 4, 8)) if fits(m)]
    at_once = [m for m in held if m * C <= 132]
    assert n == (max(at_once) if at_once else min(held))


@pytest.mark.parametrize("sms,C,n", [
    (132, 32, 4), (132, 16, 8), (132, 33, 4), (132, 34, 2), (132, 66, 2),
    (132, 67, 1), (114, 28, 4), (114, 29, 2), (60, 32, 1)])
def test_k1_blocks_follow_the_cards_multiprocessors(sms, C, n):
    """K1 without the solve at 64x64: the most blocks a chain (at most 8,
    with at least 8 rows each) whose C chains all run at once."""
    assert tr.cg_path(64, 32, C, sms, False, True) == (tr.CG_SHARED, n)


def test_the_solves_never_split_a_chain():
    """K2 and K1 with its CG run one block a chain or the global scratch:
    their sums need the whole lattice in one block."""
    for Nx, Nth in ((16, 8), (64, 32), (128, 64)):
        for C in (1, 8, 128):
            for gauge in (False, True):
                assert tr.cg_path(Nx, Nth, C, 132, True, gauge)[1] == 1


# ---------- the tool's arguments ----------

def test_bench_tool_parses_its_shapes():
    """--shapes takes NXxNT:C items (K1, K2, K5), --k6-shapes and
    --residual-shapes NXxNT:C:B (K6, K9: B right-hand sides per
    configuration), --halo-shapes NXxNT:RXxRT:C (K7, K8: C chains on an
    RX x RT mesh of shards)."""
    assert bench_force_solve._shapes("64x64:32,128x128:8") == [(64, 64, 32), (128, 128, 8)]
    assert bench_force_solve._shapes("64x64:32:8,20x34:2:1", 2) == [(64, 64, 32, 8),
                                                                   (20, 34, 2, 1)]
    assert bench_force_solve._halo_shapes("64x64:2x2:32,16x16:1x4:3") == [
        (64, 64, 2, 2, 32), (16, 16, 1, 4, 3)]


@pytest.mark.parametrize("argv", [
    ["--k6-shapes", "64x64:32"], ["--shapes", "64x64:32:8"],
    ["--k6-shapes", "64x64:32:8:1"], ["--shapes", "64:32"], ["--halo-shapes", "64x64:32"],
    ["--halo-shapes", "64x64:2x2"], ["--halo-shapes", "64x64:2:32"],
    ["--residual-shapes", "64x64:32"], ["--residual-shapes", "64x64:32:8:1"]])
def test_bench_tool_refuses_malformed_arguments(argv):
    with pytest.raises(SystemExit) as exc:
        bench_force_solve.main(argv)
    assert exc.value.code == 2


def test_bench_tool_refuses_to_time_without_a_card(capsys):
    """Parsed arguments, no card: exit 1 and no row, never a CPU time."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    assert bench_force_solve.main(["--shapes", "16x16:2", "--k6-shapes", "32x32:4:2",
                                   "--halo-shapes", "16x16:2x2:1",
                                   "--residual-shapes", "16x16:2:2"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


# ---------- the integrator gates of the JAX suite, f64 on the CPU ----------

def _model(*, md_steps=8, tau=1.0, m0=0.1, beta=2.0, even_odd=True, tol=1e-12,
           dm=None, integrator="leapfrog"):
    return SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=8, real_dtype="float64"),
        hmc=HMCParams(beta=beta, m0=m0, md_steps=md_steps, trajectory_length=tau,
                      even_odd=even_odd, hasenbusch_dm=dm, integrator=integrator,
                      cg=CGParams(tol=tol, refine=False)))


def _start(model, seed):
    """theta [1, 2, 8, 8] uniform from a numpy seed, and (pi, phi) of the
    heat bath from the port's noise draw."""
    rng = np.random.default_rng(seed)
    theta = torch.from_numpy(rng.uniform(-math.pi, math.pi, (1, 2, 8, 8)))
    pi, chi, _ = sampler.draw_chain_noise(model, seed, 0, 1, "cpu")
    phi, stats = model.pseudofermion_fields(theta, chi, SolveStats.zero(theta[:, 0, 0, 0]))
    return theta, pi, chi, phi, stats


def test_dH_scales_as_dt_squared():
    """Leapfrog is O(dt^2): at a fixed trajectory length, md_steps
    8 -> 16 -> 32 contracts |dH| ~4x per doubling (the JAX gate's bounds,
    2.5 to 6.5: the reference leapfrog integrates (md-1)/md of tau)."""
    dHs = []
    for md in (8, 16, 32):
        model = _model(md_steps=md)
        theta, pi, chi, phi, stats = _start(model, 11)
        th1, pi1, stats, psi = leapfrog(model, theta, pi, phi, stats)
        sf_new, _ = model.fermion_action(th1, phi, stats, x0=psi)
        sf_old = (chi.abs() ** 2).sum()
        H_old = model.kinetic(pi) + model.gauge_action(theta) + sf_old
        H_new = model.kinetic(pi1) + model.gauge_action(th1) + sf_new
        dHs.append(abs(float(H_new - H_old)))
    r1, r2 = dHs[0] / dHs[1], dHs[1] / dHs[2]
    assert 2.5 < r1 < 6.5, (dHs, r1)
    assert 2.5 < r2 < 6.5, (dHs, r2)


@pytest.mark.parametrize("case", ["leapfrog_full_d", "omelyan", "hasenbusch"])
def test_trajectory_reversibility(case):
    """Integrate, negate the momenta, integrate back: the identity to
    roundoff. Leapfrog on full-D pseudofermions (md 12, tau 0.6, 1e-9), the
    Omelyan 2MN scheme (md 6, solves to 1e-13, 5e-9) and the Hasenbusch
    pair near the critical mass (md 8, tau 0.8, 1e-9), as the JAX gates."""
    model, integrate, atol = {
        "leapfrog_full_d": (_model(even_odd=False, md_steps=12, tau=0.6), leapfrog, 1e-9),
        "omelyan": (_model(md_steps=6, tol=1e-13, integrator="omelyan"), omelyan, 5e-9),
        "hasenbusch": (_model(md_steps=8, tau=0.8, m0=-0.19, dm=0.3), leapfrog, 1e-9),
    }[case]
    theta, pi, _, phi, stats = _start(model, 3)
    th1, pi1, stats, _ = integrate(model, theta, pi, phi, stats)
    th0, pi0, stats, _ = integrate(model, th1, -pi1, phi, stats)
    assert bool(stats.all_converged.all())
    np.testing.assert_allclose(th0.numpy(), theta.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose((-pi0).numpy(), pi.numpy(), rtol=0, atol=atol)
    # the trajectory moved the field: the gate is not met by standing still
    assert float((th1 - theta).abs().max()) > 1e-2
