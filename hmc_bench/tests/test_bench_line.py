"""The result line: its keys, the checks last; no result without a card;
the check for modules of JAX and of the JAX package."""

import json
import subprocess
import sys
import time

import pytest

from hmc_bench import harness, registry
from hmc_bench.run import forbidden_modules


def test_result_line_keys(tiny_checkout):
    cell = registry.cell(tiny_checkout, "tiny8.gen")
    line, checks = harness.run_cell(cell, 2**31 + 5, 0.2, False, "cpu",
                                    time.perf_counter())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    n_meas = harness.MIN_MEAS    # a CPU run is slower than the window
    assert line["attempted"] >= 2 * (1 + (n_meas - 1) * 2) + 2 * n_meas
    assert set(line["metrics"]) == {"chain_traj_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(checks) == set(harness.limits(cell))
    assert checks["ref_unconverged"] == {"value": 0, "limit": 0}
    json.dumps(line)


def test_no_result_without_a_card(tiny_checkout):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "hmc_bench/run.py", "--workload",
                        "tiny8.gen", "--seed", "1", "--seconds", "1"],
                       cwd=tiny_checkout, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2
    assert r.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program: a run there fails and prints no result."""
    from conftest import make_checkout

    root = make_checkout(tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from hmc_bench import harness, registry\n"
            "c = registry.cell('.', 'tiny8.gen')\n"
            "print(harness.run_cell(c, 3, 0.2, False, 'cpu', time.perf_counter()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "schwingermodel_tpu_torch" in r.stderr


@pytest.mark.parametrize("names,found", [
    (["torch", "schwingermodel_tpu_torch", "schwingermodel_tpu_torch.runner",
      "jaxtyping", "flaxen", "numpy"], []),
    (["jax", "torch"], ["jax"]),
    (["jax._src.core", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax._src.core", "jaxlib.xla_client"]),
    (["schwingermodel_tpu", "schwingermodel_tpu.ops.eo"],
     ["schwingermodel_tpu", "schwingermodel_tpu.ops.eo"]),
])
def test_forbidden_modules_compare_top_level_names_whole(names, found):
    assert forbidden_modules(names) == found


def test_a_run_loads_no_module_of_jax_or_the_jax_package(tiny_checkout):
    """Every module a run loads, in a fresh process, by top-level name."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from hmc_bench import harness, registry\n"
        "from hmc_bench.run import forbidden_modules\n"
        "c = registry.cell(%r, 'tiny8.gen')\n"
        "harness.run_cell(c, 3, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(forbidden_modules(sys.modules))\n"
    ) % (str(registry.HERE.parent), str(tiny_checkout))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_probe_leaves_the_programs_results_as_they_are(tiny_checkout):
    """A call under the probe, which holds the block's exp(-dH) sum aside
    across its kept steps, returns bit for bit what the same call returns
    without it; each kept step's exp(-dH) is the step's own."""
    import numpy as np

    cell = registry.cell(tiny_checkout, "tiny8.gen")
    out = []
    for kept in ({0, 2}, None):
        s = harness.Session(cell, 2**31 + 21, "cpu")
        s.call(2, 2)
        if kept is None:
            res = s.call(0, 3)
        else:
            probe = harness.Probe(kept)
            with probe:
                res = s.call(0, 3)
            for before, after in probe.snaps.values():
                assert bool(((after.exp_mdH > 0) & (after.exp_mdH < 50)).all())
        out.append(res)
    a, b = out
    assert a.exp_mdH_mean == b.exp_mdH_mean
    assert a.acceptance_rate == b.acceptance_rate
    assert np.array_equal(a.theta, b.theta)


def test_dH_gap_is_absolute_but_where_both_sides_certainly_reject():
    """dH_gap: |dH - dH_ref| on every chain, 0 only where both sides reject
    whatever r (dH >= DH_REJECT; an underflowed exp(-dH) reads dH = inf),
    not where only one side does."""
    import math

    import torch

    em = torch.tensor([0.0, 0.0, 0.5, 1e-300, 0.5, 0.5], dtype=torch.float64)
    dH = -torch.log(em)
    ref_dH = torch.tensor([800.0, 10.0, 0.7, 565.8, 4.0, 25.0], dtype=torch.float64)
    assert harness.certain_reject(dH).tolist() == [True, True, False, True,
                                                   False, False]
    gap = harness.dH_gap(dH, ref_dH).tolist()
    assert gap[0] == 0.0 and gap[3] == 0.0
    assert gap[1] == math.inf
    assert gap[2] == pytest.approx(0.7 - math.log(2))
    assert gap[4] == pytest.approx(4.0 - math.log(2))
    assert gap[5] == pytest.approx(25.0 - math.log(2))
