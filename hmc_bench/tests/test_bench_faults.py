"""A run with the timed path broken underneath reads correct = false, once
for each fault a cell can have on one card: a trajectory that returns its
state unchanged, half of the chains left out, an answer altered where it is
produced (a measurement, the condensate). The cells run on one card, so no
exchange between cards can be left out. The program's own loose contract
(f32 solves to 1e-6) reads correct = false too, and a window whose
programs do not run one step a trajectory raises."""

import time

import pytest
import torch

from hmc_bench import harness, registry


def _broken_trajectory(keep_from):
    from schwingermodel_tpu_torch.hmc import packed as hp

    real = hp.hmc_trajectory_packed

    def step(model, theta, *a, **k):
        new, st = real(model, theta, *a, **k)
        return torch.cat([new[:keep_from], theta[keep_from:]]), st
    return step


def _altered(name, factor):
    from schwingermodel_tpu_torch import observables as obs

    real = getattr(obs, name)

    def f(*a, **k):
        out = real(*a, **k)
        if name == "measure_all":
            return {**out, "plaquette": out["plaquette"] * factor}
        return out._replace(value=out.value * factor)
    return f


FAULTS = {
    "state_unchanged": ("schwingermodel_tpu_torch.hmc.packed",
                        "hmc_trajectory_packed", lambda: _broken_trajectory(0)),
    "half_the_chains": ("schwingermodel_tpu_torch.hmc.packed",
                        "hmc_trajectory_packed", lambda: _broken_trajectory(1)),
    "measurement_altered": ("schwingermodel_tpu_torch.observables",
                            "measure_all", lambda: _altered("measure_all", 1 + 1e-6)),
    "condensate_altered": ("schwingermodel_tpu_torch.observables",
                           "chiral_condensate",
                           lambda: _altered("chiral_condensate", 1 + 1e-5)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, tiny_checkout, monkeypatch):
    import importlib

    module, attr, make = FAULTS[fault]
    monkeypatch.setattr(importlib.import_module(module), attr, make())
    cell = registry.cell(tiny_checkout, "tiny8.gen")
    line, checks = harness.run_cell(cell, 2**31 + 77, 0.2, False, "cpu",
                                    time.perf_counter())
    assert line["correct"] is False, checks


def test_the_loose_contract_is_not_correct(tmp_path):
    from conftest import make_checkout

    root = make_checkout(tmp_path, solver={"refine": False, "tol": 1e-6})
    cell = registry.cell(root, "tiny8.gen")
    line, checks = harness.run_cell(cell, 2**31 + 78, 0.2, False, "cpu",
                                    time.perf_counter())
    assert line["correct"] is False
    assert checks["act_res"]["value"] > 1e3 * checks["act_res"]["limit"], checks


def test_a_window_of_other_steps_raises(tiny_checkout, monkeypatch):
    real = harness.Session.trajectories
    monkeypatch.setattr(harness.Session, "trajectories",
                        lambda self, n: real(self, n) + 1)
    cell = registry.cell(tiny_checkout, "tiny8.gen")
    with pytest.raises(RuntimeError, match="trajectory steps"):
        harness.run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter())
