"""A run with the timed path broken underneath reads correct = false, once
for each fault a cell can have on one card: a trajectory that returns its
state unchanged, half of the chains left out, an answer altered where it is
produced (a measurement, the condensate). The cells run on one card, so no
exchange between cards can be left out. The program's own loose contract
(f32 solves to 1e-6) reads correct = false too, and a window whose
programs do not run one step a trajectory raises. Under Hasenbusch: a
Hamiltonian without its second pseudofermion's action, a heat bath solved
to 1e-6, action solves to 1e-6 that flag no chain; a chain the program
flags is counted failed and left out, one it reports converged never is."""

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


class _View:
    """A module seen through, with some attributes replaced (as the probe
    sees the solves)."""

    def __init__(self, module, **replaced):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _without_S2():
    """The packed trajectory's view of ops/traj with the second
    pseudofermion's action left out of H: the old |chi2|^2 is read where
    the new S2 is summed, so dH carries S1, the gauge and the momenta
    alone (the MD keeps the ratio force)."""
    from schwingermodel_tpu_torch.hmc import packed as hp

    tr = hp.tr
    seen = {"calls": 0}

    def to_planar(x):
        out = tr.to_planar(x)
        if x.is_complex() and x.dim() == 5:        # the Hasenbusch pair
            seen["S2_old"] = (out[:, 1].double() ** 2).flatten(1).sum(dim=1)
        return out

    def dot_re(a, b):
        seen["calls"] += 1
        if seen["calls"] % 2 == 0:                 # (Dhat1 phi2, x2): S2
            return seen["S2_old"]
        return tr.dot_re(a, b)
    return _View(tr, to_planar=to_planar, dot_re=dot_re)


def _loose_certified(which):
    """The packed trajectory's view of ops/refined with its certified
    `which` solves ("heat_bath": the one that starts from its own
    right-hand side; "action": the others) stopped at 1e-6, reported
    converged."""
    from schwingermodel_tpu_torch.hmc import packed as hp

    rs = hp.rs

    def solve_refined(thE, thO, b, x0, **kw):
        if kw.get("certify", True) and (x0 is b) == (which == "heat_bath"):
            kw["tol"] = 1e-6
        return rs.solve_refined(thE, thO, b, x0, **kw)
    return _View(rs, solve_refined=solve_refined)


HASENBUSCH_FAULTS = {
    "S2_left_out_of_H": ("tr", _without_S2),
    "heat_bath_at_1e-6": ("rs", lambda: _loose_certified("heat_bath")),
    "action_at_1e-6_unflagged": ("rs", lambda: _loose_certified("action")),
}


@pytest.mark.parametrize("fault", sorted(HASENBUSCH_FAULTS))
def test_a_broken_hasenbusch_path_is_not_correct(fault, hasenbusch_checkout,
                                                 monkeypatch):
    from schwingermodel_tpu_torch.hmc import packed as hp

    attr, make = HASENBUSCH_FAULTS[fault]
    monkeypatch.setattr(hp, attr, make())
    cell = registry.cell(hasenbusch_checkout, "tiny8.gen")
    line, checks = harness.run_cell(cell, 2**31 + 79, 0.2, False, "cpu",
                                    time.perf_counter())
    assert line["correct"] is False, checks
    if fault != "S2_left_out_of_H":
        assert checks["act_res"]["value"] > 1e3 * checks["act_res"]["limit"], checks


def _flagging(chain, corrupt):
    """hmc_trajectory_packed that flags `chain` unconverged in every
    trajectory and, with `corrupt`, keeps that chain's state unchanged."""
    from schwingermodel_tpu_torch.hmc import packed as hp

    real = hp.hmc_trajectory_packed

    def step(model, theta, *a, **k):
        new, st = real(model, theta, *a, **k)
        hit = torch.arange(theta.shape[0], device=theta.device) == chain
        if corrupt:
            new = torch.where(hit.reshape(-1, 1, 1, 1), theta, new)
        return new, st._replace(cg_converged=st.cg_converged & ~hit)
    return step


@pytest.mark.parametrize("corrupt", [False, True])
def test_a_flagged_chain_is_failed_and_left_out(corrupt, hasenbusch_checkout,
                                                monkeypatch):
    """Every chain-trajectory the program flags counts in failed, and its
    gaps are not compared: the run stays correct, whatever the flagged
    chain holds."""
    from schwingermodel_tpu_torch.hmc import packed as hp

    monkeypatch.setattr(hp, "hmc_trajectory_packed", _flagging(1, corrupt))
    cell = registry.cell(hasenbusch_checkout, "tiny8.gen")
    line, checks = harness.run_cell(cell, 2**31 + 80, 0.2, False, "cpu",
                                    time.perf_counter())
    n_meas = harness.MIN_MEAS
    traj = 1 + (n_meas - 1) * 2
    assert line["failed"] == traj, line
    assert line["correct"] is True, checks


def test_a_chain_the_reference_cannot_solve_is_not_correct(hasenbusch_checkout,
                                                           monkeypatch):
    """Where the program reports a chain converged and the reference does
    not converge on it, the run is not correct (ref_unconverged, limit 0)."""
    from hmc_bench.reference import lattice as ref

    real = ref.direct_solve

    def unconverged(op, b, prec):
        x, conv = real(op, b, prec)
        return x, torch.zeros_like(conv)
    monkeypatch.setattr(ref, "direct_solve", unconverged)
    cell = registry.cell(hasenbusch_checkout, "tiny8.gen")
    line, checks = harness.run_cell(cell, 2**31 + 81, 0.2, False, "cpu",
                                    time.perf_counter())
    assert line["failed"] == 0
    assert checks["ref_unconverged"] == {"value": 2, "limit": 0}, checks
    assert line["correct"] is False
