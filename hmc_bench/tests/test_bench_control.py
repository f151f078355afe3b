"""On the card: the program's compared numbers stay under a cell's limits
and each control's (the reference one precision lower in the program's
place) do not, at a size a test run holds (32x32, 8 chains, three seeds;
nearcrit32's Hasenbusch physics at 16x16, 8 chains)."""

import json

import pytest

from hmc_bench import harness, registry
from hmc_bench.reference import lattice as ref


@pytest.mark.card
@pytest.mark.parametrize("seed", [101, 2**31 + 3, 7_000_001])
def test_control_fails_where_the_program_passes(seed, card, tmp_path):
    from conftest import make_checkout

    root = make_checkout(tmp_path, name="card32", n=32, chains=8, n_steps=0,
                         limits=registry.cell(registry.HERE.parent,
                                              "demo64.condensate").limits)
    cell = registry.cell(root, "card32.gen")
    s = harness.Session(cell, seed, card)
    s.call(50, 2)
    s.release()        # as setup(): no earlier graph collected in a capture
    w = harness.window(s, 6)
    gaps = harness.compare(s, w, cell.limits["dH_gap"], ref.CONTROLS)
    prog = gaps.pop("program")
    assert all(prog[k] <= harness.limits(cell)[k] for k in prog), prog
    for name, low in gaps.items():
        assert any(low[k] > cell.limits[k] for k in low), (name, low)


@pytest.mark.card
@pytest.mark.parametrize("seed", [103, 2**31 + 5, 7_000_003])
def test_hasenbusch_control_fails_where_the_program_passes(seed, card, tmp_path):
    """nearcrit32's physics at 16x16, 8 chains: the program under the
    limits calibrated for nearcrit32.gen, each control above one of them."""
    from conftest import make_checkout

    conf = json.loads((registry.HERE / "configs" / "nearcrit32.json").read_text())
    limits = json.loads((registry.HERE / "limits" / "nearcrit32.gen.json")
                        .read_text())["limits"]
    root = make_checkout(tmp_path, name="card16", n=16, chains=8, n_steps=0,
                         condensate=False, limits=limits, solver=conf["solver"],
                         physics=conf["physics"],
                         config={"setup": {"anneal_m0": [0.0, -0.095],
                                           "anneal_traj": 20}})
    cell = registry.cell(root, "card16.gen")
    s = harness.Session(cell, seed, card)
    harness.thermalize(s)
    s.release()
    w = harness.window(s, 4)
    gaps = harness.compare(s, w, cell.limits["dH_gap"], ref.CONTROLS)
    prog = gaps.pop("program")
    assert all(prog[k] <= harness.limits(cell)[k] for k in prog), prog
    for name, low in gaps.items():
        assert low["act_res"] > cell.limits["act_res"], (name, low)
