"""Fixtures of the benchmark's tests: a throwaway checkout made of files
alone, and the card's presence, decided inside a fixture."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run these "
        "on the card: python -m pytest hmc_bench/tests -m card)")


TINY_LIMITS = {"act_res": 1.001e-10, "dH_gap": 1e-3, "theta_gap": 1e-5, "accept_mismatch": 0,
               "meas_gap": 1e-10, "cond_gap": 1e-6}


def make_checkout(dest: Path, name="tiny8", n=8, chains=2, n_steps=1,
                  condensate=True, limits=None, solver=None) -> Path:
    """A checkout's data under dest: BENCHMARK.json and hmc_bench/ as they
    are, plus a cell `<name>.gen` of an n x n configuration (its solver
    keys updated by `solver`) and its traffic and limits, added as files
    and entries only."""
    shutil.copytree(REPO / "hmc_bench", dest / "hmc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    data = dest / "hmc_bench"
    conf = json.loads((data / "configs" / "demo64.json").read_text())
    conf["name"] = name
    conf["lattice"].update(Nx=n, Nt=n)
    conf["solver"].update(solver or {})
    (data / "configs" / f"{name}.json").write_text(json.dumps(conf))
    (data / "traffic" / f"{name}_mix.json").write_text(json.dumps({
        "chains": chains, "n_steps": n_steps, "condensate": condensate,
        "n_noise": 2, "n_therm": 2, "probe_meas": 2, "trace_meas": 3}))
    (data / "limits" / f"{name}.gen.json").write_text(
        json.dumps({"limits": limits or TINY_LIMITS}))
    bench["configs"].append({"name": name, "source": "a test lattice",
                             "file": f"hmc_bench/configs/{name}.json",
                             "reduced": ["lattice"], "why": "a test"})
    bench["workloads"].append({"name": f"{name}.gen", "config": name,
                               "traffic": f"{name}_mix", "chips": 1,
                               "why": "a test"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_checkout(tmp_path):
    return make_checkout(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs and its control need one")
    return torch.device("cuda")
