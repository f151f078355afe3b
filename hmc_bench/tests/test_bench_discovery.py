"""Cells, configurations, mixes, limits and metrics are found by name: a
throwaway cell and a throwaway metric added as files and entries alone."""

import json
import time

from hmc_bench import harness, registry


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
