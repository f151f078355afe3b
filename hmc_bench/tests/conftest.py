"""Fixtures of the benchmark's tests: a throwaway checkout made of files
alone, and the card's presence, decided inside a fixture."""

import gc
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


# a Hasenbusch configuration near the critical mass at a size the CPU runs
# (nearcrit32's keys: the mass split, an anneal)
HASENBUSCH = dict(physics={"beta": 2.0, "m0": -0.1, "md_steps": 4,
                           "trajectory_length": 0.25, "hasenbusch_dm": 0.4},
                  config={"setup": {"anneal_m0": [0.0], "anneal_traj": 2}})


def make_checkout(dest: Path, name="tiny8", n=8, chains=2, n_steps=1,
                  condensate=True, limits=None, solver=None, physics=None,
                  config=None) -> Path:
    """A checkout's data under dest: BENCHMARK.json and hmc_bench/ as they
    are, plus a cell `<name>.gen` of an n x n configuration (demo64's with
    its solver and physics keys updated by `solver` and `physics`, and the
    top-level keys of `config` set) and its traffic and limits, added as
    files and entries only."""
    shutil.copytree(REPO / "hmc_bench", dest / "hmc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    data = dest / "hmc_bench"
    conf = json.loads((data / "configs" / "demo64.json").read_text())
    conf["name"] = name
    conf["lattice"].update(Nx=n, Nt=n)
    conf["solver"].update(solver or {})
    conf["physics"].update(physics or {})
    conf.update(config or {})
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
def hasenbusch_checkout(tmp_path):
    return make_checkout(tmp_path, condensate=False, **HASENBUSCH)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs and its control need one")
    # an earlier test's graphs are collected here, never inside a capture
    # of this one (which that invalidates)
    gc.collect()
    torch.cuda.synchronize()
    return torch.device("cuda")
