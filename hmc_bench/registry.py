"""Find a cell's configuration, traffic mix, limits and metrics by name.

Under the root of a checkout, ``BENCHMARK.json`` names each cell's
configuration (its ``file``) and traffic mix, read from
``hmc_bench/traffic/<traffic>.json``; the cell's limits on the compared
numbers are ``hmc_bench/limits/<cell>.json``; each per-layer metric is
read by ``hmc_bench/metrics/<name>.py``, whose ``read(ctx)`` returns the
value or None where the run has nothing to read. A cell, a configuration,
a mix or a metric is added by adding its files and its entries, never by
editing code.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    config: dict           # the configuration file's contents
    traffic: dict          # the traffic file's contents
    limits: dict           # compared number -> its limit
    end_to_end: list       # the BENCHMARK.json entries the cell reports
    per_layer: list        # (entry, read) pairs


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(path: Path) -> Callable:
    """``read(ctx)`` of a metric's file."""
    name = path.name[:-len(".py")]
    spec = importlib.util.spec_from_file_location(
        "hmc_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(root: Path, name: str) -> Cell:
    """The cell `name` of the checkout at `root`, with its files."""
    root = Path(root)
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    data = root / "hmc_bench"
    per_layer = [(m, metric_reader(data / "metrics" / f"{m['name']}.py"))
                 for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, _json(root / conf["file"]),
                _json(data / "traffic" / f"{w['traffic']}.json"),
                _json(data / "limits" / f"{name}.json")["limits"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer)


def chips(root: Path, name: str) -> int:
    return {w["name"]: w["chips"]
            for w in load_benchmark(root)["workloads"]}[name]
