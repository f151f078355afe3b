"""The frozen counts of the algorithm's work against hand counts at 8x8."""

import pytest

from hmc_bench import yardstick as y


def test_per_site_counts():
    # a hop: 7 complex products (6 flops) and 12 complex sums (2 flops)
    assert y.F_HOP == 7 * 6 + 12 * 2
    # Dhat on an even site: two hops and m v - c h on 4 reals (2 a real)
    assert y.F_DHAT == 2 * y.F_HOP + 4 * 2
    assert y.F_NORMAL == 2 * y.F_DHAT
    # a CG iteration: the normal apply, two dots and three axpys on 4 reals
    assert y.F_CG_ITER == y.F_NORMAL + 2 * 4 * 2 + 3 * 4 * 2
    # 160 a lattice site: the stencil's count, not the 172 of plain ops
    assert y.F_CG_ITER / 2 == 160


def test_work_at_8x8():
    C, V2 = 2, 32
    w = y.refined_solves(C, V2, n_solves=10, iters=500)
    assert w.bytes == 10 * C * 96 * V2 == 61440
    assert w.f32 == 320 * V2 * 500 == 5_120_000
    assert w.f64 == 10 * C * V2 * (80 + 2 * 280) == 409_600
    f = y.force_steps(C, V2, 9)
    assert f.bytes == 9 * C * 48 * V2
    assert f.f32 == 9 * C * V2 * (80 + 140 + 66 + 120 + 76)
    inner = y.condensate_inner(C, 8, V2, n_meas=3, iters=4000)
    assert inner.bytes == 3 * V2 * (16 * 48 + C * 32)
    assert inner.f32 == 3 * V2 * 16 * 280 + V2 * 320 * 4000
    res = y.condensate_residuals(C, 8, V2, n_meas=3)
    assert res.f64 == 6 * V2 * (16 * 288 + C * 80)


def test_roofline_takes_the_larger_bound():
    by_bytes = y.Work(3.35e12, 1.0, 0.0)
    assert by_bytes.seconds() == pytest.approx(1.0)
    by_ops = y.Work(1.0, 67e12, 34e12)
    assert by_ops.seconds() == pytest.approx(2.0)
    assert by_ops.compute_seconds() == pytest.approx(2.0)


def _physics(name):
    import json
    from pathlib import Path

    conf = Path(y.__file__).resolve().parent / "configs" / f"{name}.json"
    return json.loads(conf.read_text())["physics"]


@pytest.mark.parametrize("name", ["demo64", "vol128"])
def test_counts_of_the_one_pseudofermion_cells_are_as_before(name):
    """md_steps refined solves and md_steps - 1 force steps a trajectory,
    the force step's work unchanged: the readings of mfu_pct and
    roofline_pct.K3 in these cells do not move."""
    p = _physics(name)
    md = p["md_steps"]
    assert y.solves_per_traj(p) == md
    assert y.force_steps_per_traj(p) == md - 1
    assert not y.hasenbusch(p)
    f = y.force_steps(32, 2048, 3, y.hasenbusch(p))
    assert (f.bytes, f.f32, f.f64) == (3 * 32 * 48 * 2048,
                                       3 * 32 * 2048 * (80 + 140 + 66 + 120 + 76), 0.0)


def test_counts_under_hasenbusch():
    """nearcrit32: 2 (md - 1) force solves, the heat bath's and two action
    solves (2 md + 1 = 53); each force step K1 without the staples, K5 with
    them, and a Dhat."""
    p = _physics("nearcrit32")
    assert y.hasenbusch(p)
    assert y.solves_per_traj(p) == 2 * 26 + 1 == 53
    assert y.force_steps_per_traj(p) == 25
    f = y.force_steps(2, 32, 1, split=True)
    assert f.bytes == 3 * 2 * 48 * 32
    assert f.f32 == 2 * 32 * ((80 + 140 + 66 + 120) * 2 + 76 + 140)
    # Omelyan's 2MN: 2 md_steps force evaluations
    om = dict(p, integrator="omelyan")
    assert y.force_steps_per_traj(om) == 52
    assert y.solves_per_traj(om) == 2 * 52 + 3
