"""Performance metrics.

The reference's only performance instrumentation is end-to-end MPI_Wtime
(src/main.cpp:152-171) plus a commented-out -g flag "#For profiling"
(CMakeLists.txt:32). Here per-phase timing, CG-iteration throughput, and
Dirac-apply GFLOP/s are first-class (SURVEY.md section 5).

Counterpart of ``schwingermodel_tpu/utils/metrics.py``: ``PerfMonitor``,
the FLOP accounting and ``profiler_trace`` (the CLI's ``--profile``) as a
``torch.profiler`` trace.

FLOP accounting (documented so the GFLOP/s metric is well-defined):

  Full Wilson-Dirac apply (ops/dirac.py::dirac), per lattice site:
    3 shared backward products bt/bx0/bx1   = 3 * (2 add + 6 cmul) = 24
    per spin: 2 link cmuls on projected sums = 2 * (2 + 6)         = 16
              3 complex adds + mass/half axpb = 6 + 6              = 12
    two spins                                                      = 56
    total ~ 80 real flops / site (i-multiplications are sign swaps, conj
    is free, and the antiperiodic sign is folded into the links).

  Even-odd normal apply (Dhat Dhat^+, ops/eo.py), per *even* site: 4 hop
  stencils on half-size fields + 2 mass axpbs; a hop costs ~72 flops per
  target site (same structure minus the mass term), so
    ~ 4*72 + 2*8 = 304 flops per even site = 152 flops per lattice site.

  One CG iteration on the normal system adds 2 dots (4 flops/complex
  component) and 3 axpys (4): ~ (2+3) * 4 * 2 spins / 2 (half lattice)
  = 20 flops per lattice site.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time
from typing import Dict, Optional

DIRAC_FLOPS_PER_SITE = 80.0        # full-lattice D apply
EO_NORMAL_FLOPS_PER_SITE = 152.0   # Dhat Dhat^+ apply, per lattice site
CG_VECTOR_FLOPS_PER_SITE = 20.0    # dots + axpys per CG iteration


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, "cpu" off the card."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        import torch

        return torch.cuda.get_device_name(device)


def counted_kernels() -> tuple:
    """Every CUDA kernel wrapper with a launch counter (each adds one to
    ``.launches`` where it launches its kernel; a CPU tensor runs the plain
    twin and counts nothing)."""
    from schwingermodel_tpu_torch.ops import cg_eo, halo, noise
    from schwingermodel_tpu_torch.ops import refined as rs
    from schwingermodel_tpu_torch.ops import traj as tr

    return (tr.force_step, tr.solve_fused, tr.solve_fused_mxu, tr.ratio_force,
            rs.solve_refined, rs.solve_f64_cg_fallback, cg_eo.cg_solve_eo,
            rs.residual_f64, halo.halo_normal, halo.halo_force,
            noise.chain_noise, noise.z2_noise)


def kernel_launches() -> dict:
    """Entry point -> launches since its counter was last set, of every
    wrapper of ``counted_kernels`` (a graph replay counts as the launches
    its capture recorded, hmc/program.py)."""
    return {fn.__name__: fn.launches for fn in counted_kernels()}


def cg_iteration_flops(volume: int, even_odd: bool) -> float:
    """Real flops of one CG iteration on the (even-odd) normal system."""
    if even_odd:
        return volume * (EO_NORMAL_FLOPS_PER_SITE + CG_VECTOR_FLOPS_PER_SITE)
    return volume * (2 * DIRAC_FLOPS_PER_SITE + 2 * CG_VECTOR_FLOPS_PER_SITE)


@dataclasses.dataclass
class PhaseStats:
    seconds: float = 0.0
    trajectories: int = 0
    cg_iters: int = 0
    replays: int = 0          # CUDA graph replays (hmc/program.py)


class PerfMonitor:
    """Per-phase wall time + throughput counters for a simulation run.

    Usage:
        perf = PerfMonitor(volume=Nx*Nt, even_odd=True)
        with perf.phase("thermalize"):
            ... ; perf.add(trajectories=n, cg_iters=it)
        print(perf.report_lines())
    """

    def __init__(self, volume: int, even_odd: bool = False):
        self.volume = volume
        self.even_odd = even_odd
        self.phases: Dict[str, PhaseStats] = {}
        self._current: Optional[str] = None
        # the device programs' stats() (hmc/program.py), where they ran:
        # "graph" the trajectory's, "measurement_graph" the measurement's
        self.graphs: Dict[str, dict] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        st = self.phases.setdefault(name, PhaseStats())
        prev = self._current
        self._current = name
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            st.seconds += time.perf_counter() - t0
            self._current = prev

    def add(self, trajectories: int = 0, cg_iters: int = 0,
            phase: Optional[str] = None, replays: int = 0):
        name = phase or self._current
        if name is None:
            return
        st = self.phases.setdefault(name, PhaseStats())
        st.trajectories += trajectories
        st.cg_iters += cg_iters
        st.replays += replays

    # ---- derived metrics ----

    def summary(self) -> dict:
        out = {}
        for name, st in self.phases.items():
            d = {"seconds": st.seconds}
            if st.trajectories and st.seconds > 0:
                d["traj_per_s"] = st.trajectories / st.seconds
            if st.cg_iters and st.seconds > 0:
                d["cg_iters_per_s"] = st.cg_iters / st.seconds
                d["cg_gflops"] = (
                    st.cg_iters * cg_iteration_flops(self.volume, self.even_odd)
                    / st.seconds / 1e9)
            if st.trajectories:
                d["cg_iters_per_traj"] = st.cg_iters / max(st.trajectories, 1)
            if st.replays:
                d["replays"] = st.replays
            out[name] = d
        out.update({k: dict(v) for k, v in self.graphs.items()})
        return out

    def report_lines(self) -> list[str]:
        lines = []
        summary = self.summary()
        graphs = {k: summary.pop(k) for k in self.graphs}
        for name, d in summary.items():
            parts = [f"{name}: {d['seconds']:.2f} s"]
            if "traj_per_s" in d:
                parts.append(f"{d['traj_per_s']:.1f} traj/s")
            if "cg_iters_per_traj" in d:
                parts.append(f"{d['cg_iters_per_traj']:.0f} CG iters/traj")
            if "cg_gflops" in d:
                parts.append(f"{d['cg_gflops']:.2f} GFLOP/s (CG)")
            if "replays" in d:
                parts.append(f"{d['replays']} graph replays")
            lines.append("  ".join(parts))
        for name, graph in graphs.items():
            if not graph["captures"]:
                continue
            us = graph["host_us_per_replay"]
            lines.append(
                f"{name.replace('_', ' ')}: {graph['captures']} capture(s), "
                f"{graph['replays']} replays, {graph['kernel_nodes']} kernel "
                "nodes, " + (f"{us:.1f} us of host per replay" if us is not None
                             else "no replay"))
        return lines


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """Wrap a block in a torch.profiler trace when trace_dir is set (CLI
    --profile); no-op otherwise. The trace of the host and, where there is
    one, of the card is written to ``trace_dir/trace.json`` in Chrome's
    format (view in chrome://tracing or Perfetto)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


# Cycles a second the card's spin (torch.cuda._sleep) is reckoned at: at
# least the H100's highest SM clock, 1.98 GHz, so the spin lasts at least the
# time asked of it.
_SPIN_HZ = 2.0e9
_SPIN_MAX_S = 0.1


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of the card per call of fn over `reps` calls, by
    CUDA events, after a warm-up call. The calls are queued behind a spin of
    the card as long as the host takes to issue them (at most 0.1 s), so
    that a kernel shorter than its host-side launch is timed by its own
    length and not by the host's; a call the host cannot issue that fast
    (a plain twin of thousands of small launches) is timed as the host
    issues it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_SPIN_HZ * min(1.5 * reps * issue_s, _SPIN_MAX_S)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
