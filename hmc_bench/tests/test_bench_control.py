"""On the card: the program's compared numbers stay under a cell's limits
and each control's (the reference one precision lower in the program's
place) do not, at a size a test run holds (32x32, 8 chains, three seeds)."""

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
    w = harness.window(s, 6)
    gaps = harness.compare(s, w, cell.limits["dH_gap"], ref.CONTROLS)
    prog = gaps.pop("program")
    assert all(prog[k] <= cell.limits[k] for k in prog), prog
    for name, low in gaps.items():
        assert any(low[k] > cell.limits[k] for k in low), (name, low)
