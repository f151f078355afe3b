"""On the card: the port's CLI, its runs across processes and the physics
tools.

The CLI at the demo point on its device programs; the demo's CLI with the
condensate in one process and in two chain groups under torchrun, and on
2x2 shards in one process and in four under torchrun (on one card the
processes time-slice it and gloo moves their sums through the host: not
multi-GPU), every chain's theta bit for bit; unit-length trajectories with
and without the MRE forecast through the CLI; tools/crossvalidate at the
golden 8x8 point and tools/critical_mass at 16x16.

Run on a machine with a CUDA card:

    python -m pytest --noconftest tests/test_torch_card_runs.py -m card

Without a card every test skips before it builds a kernel. The module
imports neither JAX nor the JAX package.
"""

import argparse
import ast
import contextlib
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from schwingermodel_tpu_torch import cli
from schwingermodel_tpu_torch.tools import critical_mass, crossvalidate

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")


REPO = Path(__file__).resolve().parents[1]
# the demo point: 64x64 beta=4 m0=0.2 md=10 tau=0.1, 10 + 20 trajectories of
# 32 chains
FLAGS = ["--device", "cuda", "--nx", "64", "--nt", "64", "--beta", "4.0", "--m0", "0.2",
         "--md-steps", "10", "--tau", "0.1", "--ntherm", "10", "--nmeas", "20",
         "--nsteps", "0", "--ranks-x", "1", "--ranks-t", "1", "--chains", "32",
         "--seed", "0"]
RESULTS = ("Average plaquette", "Average gauge action", "Acceptance rate", "<exp(-dH)>",
           "Chiral condensate")


def _flags(**values):
    """FLAGS with the values of some flags replaced (ntherm="2": --ntherm 2)."""
    argv = list(FLAGS)
    for flag, value in values.items():
        argv[argv.index("--" + flag.replace("_", "-")) + 1] = value
    return argv


def _in_process(argv):
    """cli.main(argv) in this process: (exit code, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _gates(text):
    """The printed acceptance in (0.3, 1], <exp(-dH)> within 0.1 of 1 and
    every solve converged."""
    acc = float(re.search(r"Acceptance rate: (\S+)", text).group(1))
    em = float(re.search(r"<exp\(-dH\)> = (\S+),", text).group(1))
    assert "all solves converged: True" in text
    assert 0.3 < acc <= 1.0 and abs(em - 1.0) < 0.1, (acc, em)


def _launch(argv, n, out_dir):
    """The CLI from this checkout in one process, or in n under torchrun:
    (stdout, stderr, the checkpoint's arrays, SimData files, checkpoints)."""
    argv = [*argv, "--out-dir", str(out_dir), "--checkpoint", str(out_dir / "ck.npz")]
    run = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n)] if n > 1 else [sys.executable])
    proc = subprocess.run([*run, "-m", "schwingermodel_tpu_torch", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-4000:])
    assert "all solves converged: True" in proc.stdout
    with np.load(out_dir / "ck.npz") as z:
        arrays = dict(z)
    return (proc.stdout, proc.stderr, arrays, len(list(out_dir.glob("*SimData*"))),
            len(list(out_dir.glob("*.npz"))))


def _per_process(stderr, n):
    """Each process's own stderr line: rank -> (device, device programs)."""
    lines = {int(m.group(1)): (m.group(2), ast.literal_eval(m.group(3)))
             for m in re.finditer(rf"process (\d+) of {n} on (\S+): graphs (\{{.*\}})",
                                  stderr)}
    assert sorted(lines) == list(range(n)), stderr[-3000:]
    return lines


def test_cli_on_the_graph(tmp_path):
    """The CLI at the demo point (64x64 C=32 md=10 tau=0.1, 10 + 20
    trajectories) on its device program: the gates, <P> in (0, 1), one
    capture and 29 replays."""
    rc, text = _in_process([*FLAGS, "--no-simdata", "--out-dir", str(tmp_path)])
    assert rc == 0, text[-3000:]
    _gates(text)
    assert 0.0 < float(re.search(r"Ep = (\S+)", text).group(1)) < 1.0
    assert re.search(r"perf: graph: 1 capture\(s\), 29 replays, \d+ kernel nodes", text)


def test_chain_groups_equal_one_process(tmp_path):
    """The demo's CLI with --condensate --n-noise 8 and a checkpoint, in one
    process and in chain groups under torchrun (--ranks-chain, one process
    a card, two on one card), each on its device programs (one capture, 29
    trajectory and 19 measurement replays a process, named on each
    process's stderr line with its card, each graph with as many kernel
    nodes as the one process's): every chain's theta and condensate bit for
    bit, the printed results equal and printed once, one SimData and one
    checkpoint each."""
    cards = torch.cuda.device_count()
    n = cards if cards > 1 else 2
    argv = [*FLAGS, "--condensate", "--n-noise", "8"]
    outs = []
    for procs, extra in ((1, []), (n, ["--ranks-chain", str(n)])):
        d = tmp_path / f"p{procs}"
        d.mkdir()
        outs.append(_launch([*argv, *extra], procs, d))
    for out, _, arrays, simdata, cks in outs:
        assert (simdata, cks) == (1, 1)
        assert out.count("Average plaquette value") == 1
        assert re.search(r"perf: graph: 1 capture\(s\), 29 replays", out)
        assert re.search(r"perf: measurement graph: 1 capture\(s\), 19 replays", out)
        assert arrays["theta"].shape == (32, 2, 64, 64)
    (one, _, a1, _, _), (many, err, an, _, _) = outs
    layout = f"{n} processes on {cards} device{'s' if cards > 1 else ''} " \
             f"({'nccl' if cards > 1 else 'gloo'})"
    assert f"* Chain groups = {layout}" in many
    nodes = {k: int(re.search(rf"perf: {k.replace('_', ' ')}: .* (\d+) kernel nodes",
                              one).group(1)) for k in ("graph", "measurement_graph")}
    assert min(nodes.values()) > 0, nodes
    for rank, (where, graphs) in _per_process(err, n).items():
        assert where == f"cuda:{rank % cards}"
        assert graphs["graph"]["captures"] == 1 and graphs["graph"]["replays"] == 29
        assert graphs["measurement_graph"]["replays"] == 19
        assert {k: graphs[k]["kernel_nodes"] for k in nodes} == nodes, (rank, graphs)
    np.testing.assert_array_equal(a1["theta"], an["theta"])
    np.testing.assert_array_equal(a1["chain_chiral_condensate"],
                                  an["chain_chiral_condensate"])
    res = [[ln for ln in o.splitlines() if ln.startswith(RESULTS)] for o in (one, many)]
    assert res[0] == res[1] and len(res[0]) == 5


def test_lattice_mesh_across_processes(tmp_path):
    """The demo's CLI on 2x2 shards, 2 + 4 trajectories, in one process
    (every shard on the card) and in 4 processes of one shard each under
    torchrun: the banner, each process's stderr line (its card, and no
    device program: the mesh runs the unpacked sampler), one SimData and
    one checkpoint each, and every chain's theta and the printed results
    bit for bit, or theta within the f32 gate 2e-4."""
    argv = _flags(ntherm="2", nmeas="4", ranks_x="2", ranks_t="2")
    outs = []
    for procs in (1, 4):
        d = tmp_path / f"r{procs}"
        d.mkdir()
        outs.append(_launch(argv, procs, d))
    (one, _, a1, s1, c1), (four, err, a4, s4, c4) = outs
    assert (s1, c1, s4, c4) == (1, 1, 1, 1)
    cards = torch.cuda.device_count()
    m = min(cards, 4)
    assert (f"* Device mesh = 2x2 shards, one a process: 4 processes on {m} "
            f"device{'s' if m > 1 else ''} ({'nccl' if cards >= 4 else 'gloo'})") in four
    for rank, (where, graphs) in _per_process(err, 4).items():
        assert where == f"cuda:{rank % cards}" and graphs == {}, (rank, where, graphs)
    res = [[ln for ln in o.splitlines() if ln.startswith(RESULTS)] for o in (one, four)]
    d = np.remainder(a1["theta"] - a4["theta"] + np.pi, 2 * np.pi) - np.pi
    same = np.array_equal(a1["theta"], a4["theta"]) and res[0] == res[1] and len(res[0]) == 4
    assert same or float(np.abs(d).max()) <= 2e-4


@pytest.mark.parametrize("K", [4, 0])
def test_mre_path_through_the_cli(tmp_path, K):
    """tools/bench_points' unit-length point through the CLI in this
    process (64x64 beta=4 m0=0.2 md=40 tau=1 C=32, refined, 60 + 40
    trajectories from a hot start) with --mre-history 4 and with 0: exit 0
    and the gates."""
    rc, text = _in_process([*_flags(md_steps="40", tau="1", ntherm="60", nmeas="40"),
                            "--no-simdata", "--out-dir", str(tmp_path),
                            "--mre-history", str(K)])
    assert rc == 0, text[-3000:]
    _gates(text)


def test_crossvalidate_point(tmp_path, monkeypatch):
    """tools/crossvalidate.compare_point at the golden 8x8 beta=2 m0=0.2
    point, packed refined, C=8, 50 + 100 x 2 trajectories, in a temporary
    working directory (where the runner would dump an ill configuration):
    no ill configuration, every number finite, <P> within 4 sigma of the
    C++ golden (a gate for gross faults, not the physics gate)."""
    golden = json.loads(Path(crossvalidate.GOLDEN_DEFAULT).read_text())
    ref = dict(next(r for r in golden if (r["Nx"], r["beta"], r["m0"]) == (8, 2.0, 0.2)),
               ntherm=50)
    args = argparse.Namespace(
        device="cuda", dtype="float32", refine=True, even_odd=True, plaquette_only=True,
        nmeas=100, chains=8, seed=11, md_steps=None, integrator="leapfrog",
        hasenbusch_dm=None, n_sigma=2.0, n_sigma_acc=3.0)
    monkeypatch.chdir(tmp_path)
    row = crossvalidate.compare_point(ref, args)
    assert row["n_ill"] == 0
    assert all(math.isfinite(v) for v in row.values() if isinstance(v, float)), row
    assert abs(row["n_sigma_Ep"]) <= 4.0, row


def test_critical_mass_tool(tmp_path):
    """tools/critical_mass at 16x16 beta=2, one mass (m0 = -0.10), 4
    correlator blocks of C=8 chains: exit 0, a finite positive m_PCAC,
    every solve converged."""
    out = tmp_path / "critical_mass.json"
    with np.errstate(all="ignore"):      # one mass: the fit is undefined
        rc = critical_mass.main(["--beta", "2", "--m0-list=-0.10", "--n-blocks", "4",
                                 "--json", str(out)])
    assert rc == 0
    row = json.loads(out.read_text())["rows"][0]
    assert math.isfinite(row["m_pcac"]) and row["m_pcac"] > 0.0 and row["all_converged"]
