"""The device program of the packed main path (hmc/program.py) on the CPU.

On the card a ``TrajectoryProgram`` replays one CUDA graph a trajectory
(tests/test_torch_card_program.py holds the replays against eager calls
bit for bit there); on the
CPU it runs the same step eagerly. Here: three steps from the counter
equal three eager ``hmc_trajectory_packed`` calls at the same indices, theta
and every block accumulator bit for bit, under the refined and loose
contracts, Hasenbusch and MRE; the runner on the program equals the runner
on the eager loop (results, configurations and the first-failure dump); and
the slice against the JAX package: the port's noise (the twin of the noise
kernel) at 8x8 C=3, handed to JAX's ``trajectory_packed_given_noise``
(Pallas kernels in interpret mode, the loose contract) and to the port's,
to the same-noise gates (theta' 2e-4, dH 5e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwingermodel_tpu.config import CGParams as JCGParams
from schwingermodel_tpu.config import HMCParams as JHMCParams
from schwingermodel_tpu.config import LatticeParams as JLatticeParams
from schwingermodel_tpu.hmc import packed as jhp
from schwingermodel_tpu.models.schwinger import SchwingerModel as JModel
from schwingermodel_tpu.ops import pallas_traj as pt
from schwingermodel_tpu_torch.config import (CGParams, HMCParams, LatticeParams,
                                             RunParams, from_jax_config)
from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.hmc import sampler
from schwingermodel_tpu_torch.hmc.program import Block, TrajectoryProgram
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.runner import hot_start, run_hmc

torch.set_num_threads(1)

NX = NT = 8
ACCUMULATORS = ("accepted", "cg_iters", "converged", "exp_mdH", "fallbacks",
                "action_iters", "unconverged",
                "fail_theta", "fail_seen", "fail_index")
BRANCHES = {
    "refined": dict(),
    "loose": dict(refine=False),
    "hasenbusch": dict(hasenbusch_dm=0.4, m0=-0.1),
    "mre": dict(mre_history=4),
}


def _model(refine=True, m0=0.1, **kw):
    return SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=HMCParams(beta=2.0, m0=m0, md_steps=4, trajectory_length=0.5,
                      even_odd=True, **kw,
                      cg=CGParams(tol=1e-10 if refine else 1e-6, max_iter=5000,
                                  refine=refine, inner_tol=1e-5)))


@pytest.mark.parametrize("branch", BRANCHES)
def test_program_steps_equal_eager_calls(branch):
    """n=3 steps of the program from start index 4 against three eager calls
    at indices 4, 5, 6 into a Block: theta, every accumulator, the counter
    and the updates, bit for bit."""
    model = _model(**BRANCHES[branch])
    theta0 = hot_start(model.lattice, 1, 2, "cpu")
    prog = TrajectoryProgram(model, theta0, 7, 4)
    prog.run(3)

    theta, blk = theta0.clone(), Block(theta0)
    for i in (4, 5, 6):
        theta_next, st = hp.hmc_trajectory_packed(model, theta, 7, i)
        blk.add(theta, st, i)
        theta = theta_next
    assert torch.equal(prog.theta, theta)
    for name in ACCUMULATORS:
        assert torch.equal(getattr(prog.block, name), getattr(blk, name)), name
    assert int(prog.index) == 7 and prog.block.updates == blk.updates == 6
    assert not prog.graphed and prog.stats()["replays"] == 0
    # the static theta is the program's own copy
    assert not torch.equal(theta0, prog.theta)


def test_program_refuses_a_model_off_the_packed_path():
    model = SchwingerModel(
        lattice=LatticeParams(Nx=NX, Nt=NT, real_dtype="float64"),
        hmc=HMCParams(beta=2.0, m0=0.1, even_odd=True, cg=CGParams(tol=1e-8)))
    with pytest.raises(NotImplementedError, match="f64"):
        TrajectoryProgram(model, hot_start(model.lattice, 0, 1, "cpu"), 0, 0)


def test_block_reset_and_tensor_index():
    """Block.reset zeroes in place (the captured storage stays), and a 0-d
    tensor index lands in fail_index as an int does."""
    theta = hot_start(LatticeParams(Nx=4, Nt=4), 0, 3, "cpu")
    st = sampler.TrajectoryStats(
        accepted=torch.tensor([True, False, True]),
        delta_H=torch.zeros(3, dtype=torch.float64),
        exp_mdH=torch.ones(3, dtype=torch.float64),
        cg_iters=torch.tensor([3, 4, 5], dtype=torch.int32),
        cg_converged=torch.tensor([True, False, True]),
        cg_fallbacks=torch.tensor([0, 1, 0], dtype=torch.int32))
    a, b = Block(theta), Block(theta)
    a.add(theta, st, 9)
    b.add(theta, st, torch.tensor(9))
    for name in ACCUMULATORS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.fail_index.tolist() == [-1, 9, -1]
    storage = a.accepted.data_ptr()
    a.reset()
    fresh = Block(theta)
    for name in ACCUMULATORS:
        assert torch.equal(getattr(a, name), getattr(fresh, name)), name
    assert a.updates == 0 and a.accepted.data_ptr() == storage


@pytest.mark.parametrize("starved", [False, True], ids=["converged", "starved"])
def test_runner_on_the_program_equals_the_eager_loop(tmp_path, starved):
    """run_hmc with the device program (graph=True, eager on the CPU)
    against the eager loop (graph=False): theta, the observables, the
    acceptance, the iterations and, with a starved solve, the dumped
    first-failure configurations, equal."""
    lattice = LatticeParams(Nx=NX, Nt=NT, real_dtype="float32")
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=3, trajectory_length=0.5,
                    even_odd=True,
                    cg=CGParams(tol=1e-6, max_iter=4 if starved else 2000))
    out = {}
    for graph in (True, False):
        d = tmp_path / str(graph)
        d.mkdir()
        run = RunParams(n_therm=3, n_meas=3, n_steps=1, n_chains=2, seed=3,
                        out_dir=str(d))
        out[graph] = (run_hmc(lattice, hmc, run, device="cpu", graph=graph), d)
    (a, da), (b, db) = out[True], out[False]
    np.testing.assert_array_equal(a.theta, b.theta)
    for k in a.chains:
        np.testing.assert_array_equal(a.chains[k], b.chains[k])
    assert (a.acceptance_rate, a.cg_iters_total, a.all_converged, a.exp_mdH_mean) == \
        (b.acceptance_rate, b.cg_iters_total, b.all_converged, b.exp_mdH_mean)
    assert a.all_converged is not starved
    assert a.ill_records == b.ill_records and (a.n_ill > 0) is starved
    for rec in a.ill_records:
        assert (da / rec["file"]).read_bytes() == (db / rec["file"]).read_bytes()


def test_port_noise_through_jax_and_port_trajectories():
    """The slice against the JAX package: the port's noise for 3 chains at
    8x8 (the twin of the noise kernel) through JAX's packed trajectory
    (loose contract, Pallas kernels in interpret mode) and the port's,
    converted at the boundary: theta' to 2e-4, dH to 5e-3, equal accept
    decisions, every solve converged."""
    C = 3
    jmodel = JModel(
        lattice=JLatticeParams(Nx=NX, Nt=NT, real_dtype="float32"),
        hmc=JHMCParams(beta=2.0, m0=0.1, even_odd=True, md_steps=5,
                       trajectory_length=0.5, packed=True,
                       cg=JCGParams(tol=1e-6, max_iter=2000)))
    lat, hmc, _ = from_jax_config(jmodel.lattice, jmodel.hmc)
    model = SchwingerModel(lattice=lat, hmc=hmc)
    theta = hot_start(lat, 5, C, "cpu")
    pi, chi, r = sampler.draw_chain_noise(model, 5, 2, C, "cpu")

    th0 = jhp.pack_theta(jmodel, jnp.asarray(theta.numpy()))
    piE, piO = pt.pack_chains(jmodel.geom, jnp.asarray(pi.numpy()))
    th1, st_ref = jhp.trajectory_packed_given_noise(
        jmodel, th0, piE, piO, jnp.asarray(chi.numpy()), jnp.asarray(r.numpy()))
    th_ref = np.asarray(jhp.unpack_theta(jmodel, th1, C))

    th_got, st = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    assert bool(st.cg_converged.all()) and bool(np.all(np.asarray(st_ref.cg_converged)))
    np.testing.assert_allclose(st.delta_H.numpy(), np.asarray(st_ref.delta_H),
                               rtol=0, atol=5e-3)
    np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(st_ref.accepted))
    np.testing.assert_allclose(th_got.numpy(), th_ref, rtol=0, atol=2e-4)


def test_program_counts_its_updates_on_the_cpu():
    """On the CPU, n steps of a program of C chains add n * C
    chain-trajectories to the block's updates with no capture, no replay
    and no graph; reset() zeroes the updates."""
    C, n = 3, 2
    prog = TrajectoryProgram(_model(), hot_start(LatticeParams(Nx=NX, Nt=NT), 0, C,
                                                 "cpu"), 0, 0)
    prog.run(n)
    assert prog.block.updates == n * C
    assert prog.stats() == {"captures": 0, "replays": 0, "kernel_nodes": None,
                            "host_us_per_replay": None}
    prog.block.reset()
    assert prog.block.updates == 0
