"""The device program of the packed main path: one trajectory, and one
measurement, a CUDA graph replay.

Counterpart of the JAX runner's jitted ``block`` (schwingermodel_tpu/
runner.py:290-305, and the measurement phase's ``lax.scan`` at :426-445,
which runs ``block`` and then ``measure_v``), which runs a block of
trajectories and the measurements as one compiled program with the noise
drawn inside it. Here a ``TrajectoryProgram`` holds the static state of C
chains on the card: theta, a 0-d int64 trajectory counter and the block's
accumulators (``Block``). One step draws the noise at the counter
(ops/noise.py), runs the packed trajectory (hmc/packed.py: K1, K3 with K4
inside its launch, K2 and K5 on their branches), adds the statistics to the
block with the counter as the failure index, advances the counter and
copies theta' into theta. On the card the first step runs eagerly on a side
stream (the capture's warm-up) and the step is then captured once into a
``torch.cuda.CUDAGraph``; every later step is one replay, with no host read
and one launch from the host. On the CPU the same step runs eagerly (the
caller asked for the CPU). A capture or replay that fails raises: there is
no fallback to the eager loop. A change of dt or md_steps is captured anew.

A replay runs no Python, so the trajectory program keeps the block's
host-side count of chain-trajectories (``Block.updates``) itself: C a
step.

A ``MeasurementProgram`` runs a measurement of a static theta (the
trajectory program's, which its replays rewrite in place) the same way:
a function of (theta, measurement counter) -> per-chain tensors, its
values written into row `counter` of [n, ...] buffers on the card and the
counter advanced, the first call eager on a side stream and then captured
once. The runner's measurement (plaquette, action density, charge, and the
chiral condensate with its noise drawn at the counter and the read-free
restart refinement) and the critical-mass tool's meson correlators run on
it.

The runner reads ``theta`` only through a clone (the graph writes the same
storage on every replay), the block once per block, then resets it in
place, and the measurement buffers once at the end of the phase. The
block's counters are kept where the work happens and read with it: the
unconverged chain-trajectories, the action solves' iterations and, on the
card, K3's clock cycles, which K3 adds into the block's buffer (every
refined solve of the trajectory, no node of its own).

Each program's capture (with its eager warm-up) and each replay is a span
of a ``utils.metrics.PerfMonitor`` (the runner's, or one of the program's
own): ``hmc.traj.capture`` and ``hmc.traj.replay``, ``hmc.meas.capture``
and ``hmc.meas.replay``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from schwingermodel_tpu_torch.hmc import packed as hp
from schwingermodel_tpu_torch.models.schwinger import SchwingerModel
from schwingermodel_tpu_torch.ops import _cuda
from schwingermodel_tpu_torch.parallel import multihost as mh
from schwingermodel_tpu_torch.utils.metrics import PerfMonitor


class BlockSums(NamedTuple):
    """A block's sums over every chain (``Block.read``)."""
    accepted: int
    cg_iters: int
    all_converged: bool
    exp_mdH: float
    fallbacks: int
    action_iters: int
    unconverged: int                # chain-trajectories with an unconverged solve
    k3_cycles: Optional[int]        # K3's clock cycles; None without clocks
    k3_res_cycles: Optional[int]    # of those, in its f64 true residuals
    k3_wait_cycles: Optional[int]   # of those, waiting on the cluster's other blocks
    k3_mre_cycles: Optional[int]    # of those, in the MRE forecast (0 without it)


class Block:
    """Device-side accumulators of one host-visible block, per chain:
    accepted trajectories, CG iterations, all-converged flag, the sum of
    exp(-dH), fallback solves, the action solves' CG iterations, the
    trajectories with an unconverged solve, and the pre-trajectory
    configuration and index of the first trajectory whose solve failed;
    with ``clocks``, K3's clock cycles [C, 4] (its total, its f64 true
    residuals', its cluster waits' and its MRE forecast's,
    ``ops/refined.solve_refined``),
    which the trajectory's refined solves add into. Every
    update is in place, so that a CUDA graph of ``add`` accumulates into
    the same storage on every replay; ``updates`` counts chain-trajectories
    on the host."""

    def __init__(self, theta, clocks: bool = False):
        C = theta.shape[0]
        dev = theta.device
        self.accepted = torch.zeros(C, dtype=torch.int64, device=dev)
        self.cg_iters = torch.zeros(C, dtype=torch.int64, device=dev)
        self.converged = torch.ones(C, dtype=torch.bool, device=dev)
        self.exp_mdH = torch.zeros(C, dtype=torch.float64, device=dev)
        self.fallbacks = torch.zeros(C, dtype=torch.int64, device=dev)
        self.action_iters = torch.zeros(C, dtype=torch.int64, device=dev)
        self.unconverged = torch.zeros(C, dtype=torch.int64, device=dev)
        self.clocks = (torch.zeros((C, 4), dtype=torch.int64, device=dev)
                       if clocks else None)
        self.fail_theta = torch.zeros_like(theta)
        self.fail_seen = torch.zeros(C, dtype=torch.bool, device=dev)
        self.fail_index = torch.full((C,), -1, dtype=torch.int64, device=dev)
        self.updates = 0

    def reset(self):
        """Zero the block in place (the next block's start)."""
        for t in (self.accepted, self.cg_iters, self.exp_mdH, self.fallbacks,
                  self.action_iters, self.unconverged, self.fail_theta,
                  self.fail_seen):
            t.zero_()
        if self.clocks is not None:
            self.clocks.zero_()
        self.converged.fill_(True)
        self.fail_index.fill_(-1)
        self.updates = 0

    def add(self, theta_before, st, index):
        """Add one trajectory's statistics; index: the trajectory's index, a
        Python int or a 0-d int64 tensor on the block's device."""
        self.accepted += st.accepted
        self.cg_iters += st.cg_iters
        self.converged &= st.cg_converged
        self.exp_mdH += st.exp_mdH
        if st.cg_fallbacks is not None:
            self.fallbacks += st.cg_fallbacks
        if st.action_iters is not None:
            self.action_iters += st.action_iters
        failed = ~st.cg_converged
        self.unconverged += failed
        bad = failed & ~self.fail_seen
        self.fail_theta.copy_(torch.where(bad.reshape(-1, 1, 1, 1), theta_before,
                                          self.fail_theta))
        self.fail_index.copy_(torch.where(bad, index, self.fail_index))
        self.fail_seen |= bad
        self.updates += st.accepted.numel()

    def read(self) -> BlockSums:
        """One host read (one gather of every process's chains): the sums
        over all chains, in global chain order (float64, exact for the
        counts)."""
        rows = [self.accepted, self.cg_iters, self.converged, self.exp_mdH,
                self.fallbacks, self.action_iters, self.unconverged]
        if self.clocks is not None:
            rows += list(self.clocks.T)
        per_chain = mh.gather_chains(torch.stack([r.double() for r in rows]),
                                     dim=1)
        acc, it, _, em, fb, act, bad, *cycles = per_chain.sum(dim=1).tolist()
        cycles = [int(c) for c in cycles] or [None] * 4
        return BlockSums(int(acc), int(it), bool(per_chain[2].all()), em,
                         int(fb), int(act), int(bad), *cycles)


class _GraphedStep:
    """A step on static state: on the card the first call eager on a side
    stream, then one capture into a CUDA graph and a replay every call
    (captured anew when ``_key()`` changes); eager on the CPU. Subclasses
    give ``_body`` and the prefix of their spans (``SPAN``). tracer: the
    PerfMonitor that takes the capture and replay spans (a new one by
    default)."""

    SPAN: str

    def __init__(self, device, tracer: Optional[PerfMonitor] = None):
        self.graphed = torch.device(device).type == "cuda"
        self.tracer = PerfMonitor() if tracer is None else tracer
        self._graph = None
        self._graph_key = None
        self.captures = 0
        self.replays = 0
        self.kernels = None              # the captured graph's kernel nodes by name
        self.kernel_nodes = None         # and their number

    def _body(self):
        raise NotImplementedError

    def _key(self):
        return None

    def _capture(self):
        """The warm-up step on a side stream (a real step), then the capture
        of the step, in one span."""
        _cuda.KERNELS.build()              # nvcc and dlopen outside the capture
        with self.tracer.span(self.SPAN + ".capture"):
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._body()
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._body()
                kernels = _cuda.captured_kernels(torch.cuda.current_stream().cuda_stream)
        self._graph = graph
        self._graph_key = self._key()
        self.kernels, self.kernel_nodes = kernels, sum(kernels.values())
        self.captures += 1

    def step(self):
        """One step: eager on the CPU; on the card a replay of the captured
        step (the first step, and the first after a change of ``_key()``,
        warms up and captures)."""
        if not self.graphed:
            self._body()
            return
        if self._graph is None or self._graph_key != self._key():
            self._capture()
            return
        with self.tracer.span(self.SPAN + ".replay"):
            self._graph.replay()
        self.replays += 1

    def run(self, n: int):
        for _ in range(n):
            self.step()

    def stats(self) -> dict:
        """Captures, replays, kernel nodes of the graph and host microseconds
        per replay, from the replay spans (None without a replay)."""
        st = self.tracer.spans.get(self.SPAN + ".replay")
        return {"captures": self.captures, "replays": self.replays,
                "kernel_nodes": self.kernel_nodes,
                "host_us_per_replay": (1e6 * st.seconds / st.count
                                       if st is not None and st.count else None)}


class TrajectoryProgram(_GraphedStep):
    """The packed trajectory of C chains as a device program (module
    docstring). model: on the packed path (hp.packed_supported); theta
    [C, 2, Nx, Nt] f32, copied into the program's static theta; the noise of
    trajectory i is that of (seed, i, chain_offset + chain), i from
    start_index on; dt overrides the model's step size. ``step()`` runs one
    trajectory, ``run(n)`` n of them; ``theta``, ``index`` and ``block`` are
    the static state (read ``theta`` through a clone); on the card the
    block keeps K3's clock cycles."""

    SPAN = "hmc.traj"

    def __init__(self, model: SchwingerModel, theta, seed: int,
                 start_index: int, chain_offset: int = 0, dt=None,
                 tracer: Optional[PerfMonitor] = None):
        hp.packed_supported(model)
        super().__init__(theta.device, tracer)
        self.model, self.seed, self.chain_offset, self.dt = (
            model, int(seed), int(chain_offset), dt)
        self.theta = theta.detach().clone()
        self.index = torch.full((), int(start_index), dtype=torch.int64,
                                device=theta.device)
        self.block = Block(self.theta, clocks=theta.is_cuda)

    def _body(self):
        """One trajectory from the static state into it (the captured step)."""
        theta_next, st = hp.hmc_trajectory_packed(
            self.model, self.theta, self.seed, self.index, dt=self.dt,
            chain_offset=self.chain_offset, clocks=self.block.clocks)
        self.block.add(self.theta, st, self.index)
        self.index.add_(1)
        self.theta.copy_(theta_next)

    def step(self):
        updates = self.block.updates
        super().step()
        # C chain-trajectories a step, whichever ran: a replay runs no
        # Python, and a capture's body (after its eager warm-up) no trajectory
        self.block.updates = updates + self.theta.shape[0]

    def _key(self):
        # C is fixed by the static buffers
        return (self.dt, self.model.hmc.md_steps)


class MeasurementProgram(_GraphedStep):
    """A measurement of a static theta as a device program (module
    docstring). measure(theta, index) -> {name: per-chain tensor}: reads
    only the device (no host read, so that it can be captured), index a
    0-d int64 counter on theta's device. Each ``step()`` measures `theta`
    as it then is and writes row `index` of ``out[name]``, [n, *shape] on
    theta's device, then advances the counter; n steps fill the rows
    0 .. n - 1, and a step beyond them raises (on the card a row out of
    range would be a device-side fault)."""

    SPAN = "hmc.meas"

    def __init__(self, measure, theta, n: int,
                 tracer: Optional[PerfMonitor] = None):
        super().__init__(theta.device, tracer)
        self.measure, self.theta, self.n = measure, theta, int(n)
        self.index = torch.zeros((), dtype=torch.int64, device=theta.device)
        self.out = None
        self.steps = 0

    def step(self):
        if self.steps >= self.n:
            raise IndexError(f"measurement program: its {self.n} rows are written")
        super().step()
        self.steps += 1

    def _body(self):
        vals = self.measure(self.theta, self.index)
        if self.out is None:
            self.out = {k: torch.zeros((self.n, *v.shape), dtype=v.dtype,
                                       device=v.device)
                        for k, v in vals.items()}
        row = self.index.reshape(1)
        for k, v in vals.items():
            self.out[k].index_copy_(0, row, v.unsqueeze(0))
        self.index.add_(1)


def packed_step(model: SchwingerModel, group: int = 0):
    """The packed trajectory as the runner calls it, ``step(theta, seed,
    traj_index, dt=None) -> (theta', stats)``, eager, on the C chains
    group x C .. group x C + C - 1 of the global index (a chain group of
    several, parallel/sharded.py; 0 for all chains);
    ``step.program(theta, seed, start_index, tracer=None)`` is its
    TrajectoryProgram."""

    def step(theta, seed, traj_index, dt=None):
        return hp.hmc_trajectory_packed(model, theta, seed, traj_index, dt=dt,
                                        chain_offset=group * theta.shape[0])

    def program(theta, seed, start_index, tracer=None):
        return TrajectoryProgram(model, theta, seed, start_index,
                                 group * theta.shape[0], tracer=tracer)

    step.program = program
    return step
