"""Cells, configurations, mixes, limits and metrics are found by name: a
throwaway cell and a throwaway metric added as files and entries alone."""

import json
import time

import pytest

from hmc_bench import harness, registry
from hmc_bench.reference import lattice as ref


def test_the_repository_cells_resolve():
    root = registry.HERE.parent
    bench = registry.load_benchmark(root)
    for w in bench["workloads"]:
        cell = registry.cell(root, w["name"])
        assert cell.traffic["chains"] >= 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer, w["name"]
        assert "meas_gap" in cell.limits
        assert ("cond_gap" in cell.limits) == bool(cell.traffic["condensate"])
        # the residual's limit is the configuration's, with 0.1% for the
        # float64 rounding of a residual ten orders below its terms
        tol = cell.config["solver"]["tol"]
        assert tol < cell.limits["act_res"] <= 1.001 * tol
        assert ("n_noise" in cell.traffic) == bool(cell.traffic["condensate"])
        # every per-layer metric moves an end-to-end metric the cell reports
        reported = {m["name"] for m in cell.end_to_end}
        assert len(reported) == 2, reported
        assert all(m["moves"] in reported for m, _ in cell.per_layer), w["name"]


def test_a_cell_and_a_metric_added_as_files(tiny_checkout):
    data = tiny_checkout / "hmc_bench"
    (data / "metrics" / "chains_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.C)\n")
    bench = json.loads((tiny_checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "chains_seen", "unit": "chains", "better": "higher",
        "source": "program_counter", "layer": "device program",
        "moves": "chain_traj_per_s", "workloads": ["tiny8.gen"]})
    (tiny_checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell(tiny_checkout, "tiny8.gen")
    assert cell.config["lattice"]["Nx"] == 8
    assert cell.traffic["chains"] == 2
    assert [m["name"] for m, _ in cell.per_layer] == ["chains_seen"]
    line, _ = harness.run_cell(cell, 11, 0.2, True, "cpu", time.perf_counter())
    assert line["metrics"] == {"chains_seen": {"value": 2.0, "unit": "chains"}}
    assert line["correct"] is True


def test_a_hasenbusch_cell_anneals_and_reads_correct(hasenbusch_checkout,
                                                     monkeypatch):
    """A configuration's "setup" anneal runs one call a mass before the
    thermalization at its m0, and a Hasenbusch cell's run is correct with
    its two pseudofermions drawn and compared."""
    calls = []
    real = harness.Session.call

    def call(self, n_therm, n_meas, m0=None):
        calls.append((n_therm, n_meas, m0))
        return real(self, n_therm, n_meas, m0)
    monkeypatch.setattr(harness.Session, "call", call)
    cell = registry.cell(hasenbusch_checkout, "tiny8.gen")
    assert cell.config["physics"]["hasenbusch_dm"] == 0.4
    line, checks = harness.run_cell(cell, 2**31 + 12, 0.2, False, "cpu",
                                    time.perf_counter())
    assert calls[:2] == [(1, 1, 0.0), (2, 2, None)]
    assert all(m0 is None for *_, m0 in calls[1:])
    assert line["correct"] is True, checks
    assert line["failed"] == 0


@pytest.mark.parametrize("hasenbusch", [False, True])
def test_the_check_takes_its_physics_from_the_configuration(hasenbusch, tmp_path):
    """The reference's mass split and noise shape follow the configuration's
    hasenbusch_dm, not the program's model, and agree with the shape the
    program draws; the dense direct solve is taken where a chain's Dhat has
    at most DIRECT_MAX_N unknowns."""
    from conftest import HASENBUSCH, make_checkout
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel

    root = make_checkout(tmp_path, condensate=False,
                         **(HASENBUSCH if hasenbusch else {}))
    s = harness.Session(registry.cell(root, "tiny8.gen"), 1, "cpu")
    assert s.dm == (0.4 if hasenbusch else None)
    assert s.chi_shape == ((2,) if hasenbusch else ()) + (2, 8, 4)
    model = SchwingerModel(lattice=s.lattice, hmc=s.hmc)
    assert tuple(model.chi_shape((2, 8, 8))) == s.chi_shape
    kw = harness._reference(s, ref.F64)
    assert kw["dm"] == s.dm and kw["direct"]
    assert kw["prec"].max_iter == s.cell.config["solver"]["max_iter"]
    for w in registry.load_benchmark(registry.HERE.parent)["workloads"]:
        big = harness.Session(registry.cell(registry.HERE.parent, w["name"]), 1, "cpu")
        assert 2 * big.V2 > harness.DIRECT_MAX_N      # 64x64 and 128x128: CG
