"""Performance metrics: the run's spans, the profiler.

The reference's only performance instrumentation is end-to-end MPI_Wtime
(src/main.cpp:152-171) plus a commented-out -g flag "#For profiling"
(CMakeLists.txt:32). Here the run is traced by ``PerfMonitor``, a tree of
named spans on the host's clock (runner.py: ``hmc.run`` and the spans
inside it); while a ``torch.profiler`` records, each span is also a range
of the same name in its trace, on the device trace's clock.
``profiler_trace`` is the CLI's ``--profile``; ``idle_split`` parts the
card's idle time by whether the host had issued the work that ended it;
``device_kernels`` names the kernels a call ran on the card.

Counterpart of ``schwingermodel_tpu/utils/metrics.py`` (its per-phase
``PerfMonitor`` and ``profiler_trace``).

FLOP counts of the operators (the bench tools' GFLOP/s, tools/bench_kernels.py):

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
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import subprocess
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

DIRAC_FLOPS_PER_SITE = 80.0        # full-lattice D apply
EO_NORMAL_FLOPS_PER_SITE = 152.0   # Dhat Dhat^+ apply, per lattice site


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
        return torch.cuda.get_device_name(device)


@dataclasses.dataclass
class SpanStats:
    """What the spans of one name add up to: how many closed, their seconds,
    their seconds outside any span opened inside them, the names of the
    spans they opened inside, and the trajectories and CG iterations the
    run added while one was the innermost."""
    count: int = 0
    seconds: float = 0.0
    self_seconds: float = 0.0
    parents: set = dataclasses.field(default_factory=set)
    trajectories: int = 0
    cg_iters: int = 0


class Span:
    """One span of a PerfMonitor, a context manager: its name, start and end
    (``time.perf_counter_ns``) and its parent, the span it opened inside
    (None at the top). While a torch.profiler records, it is also a range
    of its name in the trace's host events; else it costs the two clock
    reads and one check of the profiler's flag, and reads neither the
    device nor the host.

    The range is the profiler's fast operator range, not
    ``record_function``: the profiler mirrors a ``record_function`` range
    around device work onto the device's timeline, where it would read as a
    device operation as long as the work it launched (a graph replay's
    range would span all of its nodes and their gaps)."""

    __slots__ = ("name", "parent", "start", "end", "stats", "_monitor",
                 "_range", "_child_ns")

    def __init__(self, monitor: "PerfMonitor", name: str):
        self._monitor, self.name = monitor, name
        self.parent = self.start = self.end = self._range = None

    def __enter__(self) -> "Span":
        mon = self._monitor
        self.parent = mon.current
        self.stats = mon.spans.setdefault(self.name, SpanStats())
        mon.current = self
        self._child_ns = 0
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._monitor.current = self.parent
        ns = self.end - self.start
        st = self.stats
        st.count += 1
        st.seconds += ns * 1e-9
        st.self_seconds += (ns - self._child_ns) * 1e-9
        if self.parent is not None:
            self.parent._child_ns += ns
            st.parents.add(self.parent.name)
        return False


class PerfMonitor:
    """The spans of a run, nested, with per-name totals (``spans``), and
    the device programs' stats.

    Usage:
        perf = PerfMonitor()
        with perf.span("hmc.run"):
            with perf.span("hmc.thermalize"):
                ... ; perf.add(trajectories=n, cg_iters=it)
        print(perf.summary()["spans"], perf.report_lines())
    """

    def __init__(self):
        self.spans: Dict[str, SpanStats] = {}   # by name, in order first opened
        self.current: Optional[Span] = None     # the innermost open span
        # the device programs' stats() (hmc/program.py), where they ran:
        # "graph" the trajectory's, "measurement_graph" the measurement's
        self.graphs: Dict[str, dict] = {}

    def span(self, name: str) -> Span:
        return Span(self, name)

    def add(self, trajectories: int = 0, cg_iters: int = 0):
        """Count work done under the innermost open span."""
        if self.current is None:
            return
        st = self.current.stats
        st.trajectories += trajectories
        st.cg_iters += cg_iters

    def summary(self) -> dict:
        """{"spans": {name: {count, seconds, self_seconds, parents, and
        where counted trajectories, traj_per_s, cg_iters, cg_iters_per_traj}},
        and each device program's stats}."""
        spans = {}
        for name, st in self.spans.items():
            d = {"count": st.count, "seconds": st.seconds,
                 "self_seconds": st.self_seconds,
                 "parents": sorted(st.parents)}
            if st.trajectories:
                d["trajectories"] = st.trajectories
                d["cg_iters"] = st.cg_iters
                d["cg_iters_per_traj"] = st.cg_iters / st.trajectories
                if st.seconds > 0:
                    d["traj_per_s"] = st.trajectories / st.seconds
            spans[name] = d
        return {"spans": spans, **{k: dict(v) for k, v in self.graphs.items()}}

    def report_lines(self) -> list[str]:
        lines = []
        for name, st in self.spans.items():
            if not st.count:
                continue
            each = (f" {1e6 * st.seconds / st.count:.1f} us" if st.count > 1
                    else "")
            parts = [f"{name}: {st.seconds:.4f} s ({st.count} x{each}, self "
                     f"{st.self_seconds:.4f} s)"]
            if st.trajectories and st.seconds > 0:
                parts.append(f"{st.trajectories / st.seconds:.1f} traj/s")
                parts.append(f"{st.cg_iters / st.trajectories:.0f} CG iters/traj")
            lines.append("  ".join(parts))
        for name, graph in self.graphs.items():
            if not graph["captures"]:
                continue
            us = graph["host_us_per_replay"]
            lines.append(
                f"{name.replace('_', ' ')}: {graph['captures']} capture(s), "
                f"{graph['replays']} replays, {graph['kernel_nodes']} kernel "
                "nodes, " + (f"{us:.1f} us of host per replay" if us is not None
                             else "no replay"))
        return lines


def idle_split(ops, window) -> tuple:
    """(starved, queued) seconds of the card's idle time in window = (a, b),
    both in ns on the device trace's clock. ops: [(start, end, issued)] of
    the device operations, issued the start of the host call that launched
    each (a kernel launch, a copy, or the cudaGraphLaunch of a graph's
    nodes), None where unknown. A gap in which no operation runs ends at
    an operation: it is queued where that operation's launch began at or
    before the gap opened (the card idled with the work issued, as between
    a graph's nodes), else starved (the host had not issued it yet); the
    gap after the last operation is starved. starved + queued is the window
    less the union of the operations."""
    a, b = window
    ops = sorted((max(s, a), min(e, b), i) for s, e, i in ops if e > a and s < b)
    starved = queued = 0
    edge = a
    for s, e, issued in ops:
        if s > edge:
            if issued is not None and issued <= edge:
                queued += s - edge
            else:
                starved += s - edge
        edge = max(edge, e)
    if b > edge:
        starved += b - edge
    return starved * 1e-9, queued * 1e-9


def device_kernels(fn, n: int = 1) -> collections.Counter:
    """The kernels the card ran in n calls of fn, by name and count, from
    the device events of a torch.profiler window around them (no copy or
    fill of memory, and not the spin that opens the window: a spin of the
    card and a pause of the host come before the calls). The trace may
    miss launches, most after many windows in one process: a captured
    graph's own count is its program's ``kernels``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.name().startswith(("Memcpy", "Memset")) and "spin_kernel" not in e.name())


def trace_idle(prof, span: str = "hmc.run") -> Optional[dict]:
    """The card's idle time over the first `span` range of a torch.profiler
    trace, from its first device operation to the range's end: {"window_s",
    "idle_s", "starved_s", "queued_s"} (``idle_split``, each operation
    matched to its launch call by the trace's correlation id); None where
    the range ran no device operation."""
    host, launch, dev = None, {}, []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.name() == span:        # the range, and its mirror on the card
            if host is None and not on_card:
                host = (start, end)
        elif on_card:
            dev.append((start, end, e.correlation_id()))
        elif e.name().startswith("cu"):     # a CUDA API call: cuda*, cu*
            launch[e.correlation_id()] = start
    if host is None:
        return None
    dev = [(s, e, launch.get(c)) for s, e, c in dev if host[0] <= s < host[1]]
    if not dev:
        return None
    window = (min(s for s, _, _ in dev), host[1])
    starved, queued = idle_split(dev, window)
    return {"window_s": (window[1] - window[0]) * 1e-9,
            "idle_s": starved + queued, "starved_s": starved,
            "queued_s": queued}


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """Wrap a block in a torch.profiler trace when trace_dir is set (CLI
    --profile); no-op otherwise. The trace of the host and, where there is
    one, of the card is written to ``trace_dir/trace.json`` in Chrome's
    format (view in chrome://tracing or Perfetto). Yields a dict whose
    ``idle``, once the block has ended, is ``trace_idle`` of the trace
    (None without a trace or a device operation under ``hmc.run``)."""
    out = {"idle": None}
    if not trace_dir:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    out["idle"] = trace_idle(prof)


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
