"""One run of one cell: set-up, the timed window, the check, the result.

The system under test is ``schwingermodel_tpu_torch.runner.run_hmc`` on
its graphed packed path. Set-up thermalizes the cell's chains from
``run_hmc``'s own hot start (a call at each of the configuration's anneal
masses, then one at its m0, each of which builds or loads the kernel
library and captures both device programs) and times one more call of the
window's shape to size the window. The window is one ``run_hmc`` call that
resumes from that state: ``n_meas`` measurements at the mix's cadence,
every trajectory and measurement a CUDA-graph replay.

The check follows the program step by step from its own state: a probe
keeps the program's theta, block accumulators and certified action solves
(their angles, right-hand side and float64 solution) around two of the
window's trajectories (the first, which warms up the capture, and one
replay drawn from the seed, the last before measurement row j). The plain
reference (``reference/``, float64) recomputes each trajectory from the
program's theta with the noise of its trajectory index, works out the true
residual of each kept solve, and measures rows 0 and j from the program's
theta after it. A chain the program flags as unconverged in a kept
trajectory is counted failed and left out of that trajectory's gaps; a
chain it reports converged on which the reference does not converge reads
not correct. With ``trace`` a second, shorter call follows the window
under ``torch.profiler``; its stretch from the first trajectory step after
both programs' captures and first replays to the call's return gives the
device metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import re
import subprocess
import warnings
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from hmc_bench import registry
from hmc_bench.reference import lattice as ref
from hmc_bench.reference import philox

OBSERVABLES = ("plaquette", "gauge_action_density", "top_charge")
MIN_MEAS = 3        # the least window, for a card or CPU slower than the probe


# numbers every cell compares with a limit fixed by the check itself: the
# chains the program reports converged on which the reference does not
FIXED_LIMITS = {"ref_unconverged": 0}


def limits(cell: registry.Cell) -> dict:
    """Every compared number's limit: the cell's, and the fixed ones."""
    return {**cell.limits, **FIXED_LIMITS}


@dataclasses.dataclass
class Snapshot:
    theta: torch.Tensor
    exp_mdH: torch.Tensor       # after a kept step: that step's exp(-dH)
    accepted: torch.Tensor
    unconverged: torch.Tensor   # the block's chain-trajectories flagged so far
    solves: list            # [(thE, thO, b, x, m0)] of the certified solves


def _clone_solves(solves):
    return [tuple(t.clone() if torch.is_tensor(t) else t for t in sv)
            for sv in solves]


class _Through:
    """A module seen through: the attributes given replaced, every other
    one the module's own."""

    def __init__(self, module, **replaced):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


class Probe:
    """While entered, the runner's trajectory and measurement programs are
    the program's own classes with a hook that keeps the static state
    before and after the trajectories of ``steps`` (their indices within the
    call), and the packed trajectory's certified solves (the refined solves
    with ``certify``, the loose path's action solves) are recorded as they
    are issued. Across a kept step the hook holds the block's exp(-dH) sum
    aside, so that the step adds its own exp(-dH) to zero (exactly), and
    adds the sum back after it: the block ends bit for bit as it would
    have, and the step's exp(-dH) is kept unrounded by the sum (from a sum
    of hundreds a difference loses an exp(-dH) under ~1e-14, dH over ~30).
    The hook adds a few clones and additions a kept step and reads nothing
    on the host. A trajectory step that runs Python (the eager warm-up, the
    capture, every step off the card) records its solves; a replay rewrites
    the captured ones in place, which the probe keeps a handle on.

    With ``stretch``, a ``bench.window`` profiler span opens at the first
    trajectory step after both programs have been captured and replayed
    once, and the steps, measurements and block iterations done by then
    are kept; ``close_stretch()`` closes it."""

    def __init__(self, steps, stretch=False):
        self.steps = set(steps)
        self.stretch = stretch
        self.opened = None          # (trajectory steps, measurements) done
        self.snaps = {}
        self.traj = None
        self.meas = None
        self.bodies = None          # the solves of each body run of a step
        self.iters_before = None    # block iterations where the stretch opens
        self._span = None

    def _record(self, thE, thO, b, x, m0):
        if self.bodies is not None:
            self.bodies[-1].append((thE, thO, b, x, float(m0)))

    def __enter__(self):
        from schwingermodel_tpu_torch.hmc import packed, program

        probe = self
        self._saved = (program.TrajectoryProgram, program.MeasurementProgram,
                       packed.rs, packed.tr)
        refined, traj = packed.rs, packed.tr

        def solve_refined(thE, thO, b, x0, **kw):
            res = refined.solve_refined(thE, thO, b, x0, **kw)
            if kw.get("certify", True):
                probe._record(thE, thO, b, res.x64, kw["m0"])
            return res

        def solve_fused(thE, thO, b, x0, **kw):
            res = traj.solve_fused(thE, thO, b, x0, **kw)
            probe._record(thE, thO, b, res.x, kw["m0"])
            return res

        def keep(p, solves):
            b = p.block
            return Snapshot(p.theta.clone(), b.exp_mdH.clone(),
                            b.accepted.clone(), b.unconverged.clone(),
                            _clone_solves(solves))

        class Trajectory(self._saved[0]):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.calls = 0
                self.action = None     # the solves a replay rewrites
                probe.traj = self

            def _body(self):
                probe.bodies.append([])
                super()._body()

            def step(self):
                k = self.calls
                if (probe.stretch and probe.opened is None and k >= 2
                        and probe.meas is not None and probe.meas.steps >= 2):
                    probe.open_stretch(self)
                before = held = None
                if k in probe.steps:
                    before = keep(self, [])
                    held = self.block.exp_mdH.clone()
                    self.block.exp_mdH.zero_()
                probe.bodies = []
                try:
                    super().step()
                    bodies = probe.bodies
                finally:
                    probe.bodies = None
                if bodies:
                    # the first body ran (eager), the last is the one a
                    # replay reruns (the capture's, or the eager one)
                    ran, self.action = bodies[0], bodies[-1]
                else:
                    ran = self.action
                if not ran:
                    raise RuntimeError("the trajectory issued no certified solve")
                if before is not None:
                    probe.snaps[k] = (before, keep(self, ran))
                    self.block.exp_mdH.add_(held)
                self.calls += 1

        class Measurement(self._saved[1]):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                probe.meas = self

        program.TrajectoryProgram, program.MeasurementProgram = Trajectory, Measurement
        # the packed trajectory reaches the solves through its module names
        # `rs` and `tr`: it sees them through a view with the two recorded
        packed.rs = _Through(refined, solve_refined=solve_refined)
        packed.tr = _Through(traj, solve_fused=solve_fused)
        return self

    def open_stretch(self, traj):
        # the host runs replays ahead of the card: let the card reach this
        # step, so that the stretch's device work and its counts start
        # together
        if traj.theta.is_cuda:
            torch.cuda.synchronize(traj.theta.device)
        self.opened = (traj.calls, self.meas.steps)
        self.iters_before = traj.block.cg_iters.sum()
        self._span = torch.profiler.record_function("bench.window")
        self._span.__enter__()

    def close_stretch(self):
        if self._span is None:
            raise RuntimeError("the traced stretch never opened")
        self._span.__exit__(None, None, None)
        self._span = None

    def __exit__(self, *exc):
        from schwingermodel_tpu_torch.hmc import packed, program

        (program.TrajectoryProgram, program.MeasurementProgram,
         packed.rs, packed.tr) = self._saved
        return False


class Session:
    """The program's parameters and state for one cell and seed."""

    def __init__(self, cell: registry.Cell, seed: int, device, refine=None):
        from schwingermodel_tpu_torch.config import (
            CGParams, HMCParams, LatticeParams,
        )

        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        c, t = cell.config, cell.traffic
        self.lattice = LatticeParams(**c["lattice"])
        solver = dict(c["solver"])
        if refine is not None:        # the program's own lower-precision path
            solver.update(refine=refine, tol=1e-6 if not refine else solver["tol"])
        self.hmc = HMCParams(**c["physics"], cg=CGParams(**solver))
        # the configuration's mass split, and the pseudofermion noise it
        # draws: [pf, spin, Nx, Nt/2] on the even sites, pf = 2 under
        # Hasenbusch (chi1, chi2), no pf axis without
        self.dm = c["physics"].get("hasenbusch_dm") or None
        Nx, Nt = self.lattice.Nx, self.lattice.Nt
        self.chi_shape = (2,) * (self.dm is not None) + (2, Nx, Nt // 2)
        self.C, self.n_steps = int(t["chains"]), int(t["n_steps"])
        self.condensate = bool(t["condensate"])
        self.n_noise = int(t["n_noise"]) if self.condensate else 0
        self.out_dir = tempfile.mkdtemp(prefix="hmc_bench_")
        self.theta, self.start = None, 0      # None: run_hmc's hot start

    @property
    def V2(self) -> int:
        return self.lattice.volume // 2

    def call(self, n_therm: int, n_meas: int, m0=None):
        """One run_hmc call from the session's state, which it advances; the
        first starts from run_hmc's own hot start, drawn on the device from
        the seed. m0: a mass other than the configuration's (the anneal)."""
        from schwingermodel_tpu_torch import runner
        from schwingermodel_tpu_torch.config import RunParams

        hmc = self.hmc if m0 is None else dataclasses.replace(self.hmc, m0=m0)
        run = RunParams(n_therm=n_therm, n_meas=n_meas, n_steps=self.n_steps,
                        n_chains=self.C, seed=self.seed, out_dir=self.out_dir)
        cond = (dict(measure_condensate=True, n_noise=self.n_noise)
                if self.condensate else {})
        with warnings.catch_warnings():
            # the summary's jackknife of a call with few measurements
            warnings.simplefilter("ignore", RuntimeWarning)
            res = runner.run_hmc(self.lattice, hmc, run, device=self.device,
                                 initial_theta=self.theta,
                                 start_traj_index=self.start, graph=True, **cond)
        self.theta, self.start = res.theta, res.traj_index
        return res

    def trajectories(self, n_meas: int) -> int:
        """Trajectories a chain makes in a call of n_meas measurements."""
        return 1 + (n_meas - 1) * (1 + self.n_steps)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        """Return what earlier calls left (their programs, graphs and cached
        blocks) to the card, so that a capture's own emptying of the cache
        frees only what its call allocated, and no collection of an earlier
        call's graph falls inside a later capture (which invalidates it)."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def thermalize(s: Session):
    """From the hot start: the configuration's anneal (``"setup":
    {"anneal_m0": [...], "anneal_traj": n}``, n trajectories at each mass in
    turn, one call a mass), then the mix's n_therm trajectories at the
    configuration's m0 (the last call also warms up and captures both
    programs)."""
    anneal = s.cell.config.get("setup") or {}
    for m0 in anneal.get("anneal_m0", ()):
        s.call(int(anneal["anneal_traj"]) - 1, 1, m0=float(m0))
        s.release()
    s.call(int(s.cell.traffic["n_therm"]), 2)


def setup(s: Session, seconds: float) -> int:
    """Thermalization, and one call of the window's shape, timed; returns
    the window's n_meas."""
    t = s.cell.traffic
    thermalize(s)
    s.release()
    t0 = time.perf_counter()
    s.call(0, int(t["probe_meas"]))
    probe_s = time.perf_counter() - t0
    return max(MIN_MEAS, round(seconds * int(t["probe_meas"]) / probe_s))


def checked_row(seed: int, n_meas: int) -> int:
    """The replayed measurement row the check follows, drawn from the seed."""
    u = np.random.default_rng([int(seed), 17]).random()
    return 1 + int(u * (n_meas - 1))


@dataclasses.dataclass
class Window:
    result: object
    start: float            # time.perf_counter() at the call's entry
    seconds: float
    n_meas: int
    first: int              # the trajectory index the call starts from
    row: int
    probe: Probe


def _checked_call(s: Session, n_meas: int, probe: Probe):
    """s.call(0, n_meas) under the probe, timed from entry to return (the
    return follows the call's own host reads); raises where the programs
    did not run as the probe counts them: one step a trajectory, every
    kept step kept."""
    first = s.start
    with probe:
        s.sync()
        t0 = time.perf_counter()
        res = s.call(0, n_meas)
        dt = time.perf_counter() - t0
        if probe.stretch:
            probe.close_stretch()
    traj = s.trajectories(n_meas)
    if probe.traj is None or probe.traj.calls != traj:
        raise RuntimeError(f"the window ran {getattr(probe.traj, 'calls', 0)} "
                           f"trajectory steps a chain, not {traj}")
    if probe.meas is None or probe.meas.steps != n_meas:
        raise RuntimeError("the window's measurements did not run as steps")
    if set(probe.snaps) != probe.steps:
        raise RuntimeError(f"kept steps {sorted(probe.snaps)}, not "
                           f"{sorted(probe.steps)}")
    return res, t0, dt, first


def window(s: Session, n_meas: int) -> Window:
    """The timed window: one run_hmc call of n_meas measurements under the
    probe, which keeps its first trajectory and the last before row j."""
    row = checked_row(s.seed, n_meas)
    s.release()
    probe = Probe({0, row * (1 + s.n_steps)})
    res, t0, dt, first = _checked_call(s, n_meas, probe)
    return Window(res, t0, dt, n_meas, first, row, probe)


# ---------- the check ----------

# the most unknowns (2 V2, a spinor on the even sites) of a chain whose Dhat
# the reference solves by its dense LU factors, whose time does not grow
# with the conditioning (32x32: 1024); larger lattices take its CG
DIRECT_MAX_N = 2048


def _reference(s: Session, prec):
    """The reference's keywords for this cell: its physics, its solver's
    max_iter, and the dense direct solve where a chain's Dhat is small
    enough (``DIRECT_MAX_N``)."""
    c = s.cell.config
    return dict(beta=c["physics"]["beta"], m0=c["physics"]["m0"],
                md_steps=c["physics"]["md_steps"],
                tau=c["physics"]["trajectory_length"], dm=s.dm,
                prec=prec._replace(max_iter=int(c["solver"]["max_iter"])),
                direct=2 * s.V2 <= DIRECT_MAX_N)


def _largest(v: torch.Tensor) -> float:
    """The largest entry, 0 where there is none."""
    return float(v.max()) if v.numel() else 0.0


# Metropolis rejects a dH above -ln r for every r the noise draws but 0
# (r >= 2^-24, so -ln r <= 16.6): the check compares dH up to this
DH_REJECT = 20.0


def certain_reject(dH: torch.Tensor) -> torch.Tensor:
    """The chains whose dH rejects them whatever its digits (an MD spike
    or blow-up; an exp(-dH) that underflows to 0 reads dH = inf)."""
    return dH >= DH_REJECT


def dH_gap(dH: torch.Tensor, dH_ref: torch.Tensor) -> torch.Tensor:
    """Per chain |dH - dH_ref|, and 0 on a chain that both sides reject
    whatever r (``certain_reject``): near the critical mass a trajectory
    that ends in a spike (dH in the hundreds to 1e25) carries the float32
    MD's error in proportion to its dH, and no digit of it decides."""
    both = certain_reject(dH) & certain_reject(dH_ref)
    return torch.where(both, torch.zeros_like(dH), (dH - dH_ref).abs())


def _compare_step(s: Session, k: int, before: Snapshot, after: Snapshot,
                  band: float, controls: dict) -> dict:
    """The gaps of trajectory k of the window against the float64
    reference, under "program" and under the name of each control (the
    reference at that precision put in the program's place).

    dH_gap: the largest ``dH_gap`` over the chains. theta_gap: the largest
    angle between theta after the trajectory and what the reference keeps:
    its proposal where it accepts, the start where it rejects; where dH_ref
    lies within `band` of the Metropolis threshold -ln r either outcome is
    right, and the candidate's own decision picks.
    act_res: the largest true relative residual, worked out in float64, of
    the candidate's certified solves (the control's: its action solves).
    The program's chains flagged unconverged in this trajectory are left
    out of these three (the run counts them failed); ref_unconverged counts
    the other chains on which the reference did not converge, but for a
    spike both sides reject (``certain_reject``), whose reference solves on
    its numerically singular configuration the outcome does not depend on
    (a blow-up's dH reads up to 1e25). The program's accept_mismatch counts
    the chains, all of them, whose decision does not follow its own
    exp(-dH) (an exact comparison)."""
    Nx, Nt = s.lattice.Nx, s.lattice.Nt
    pi, chi, r = philox.trajectory_noise(s.seed, k, s.C, 2 * Nx * Nt,
                                         math.prod(s.chi_shape), s.device)
    pi = pi.reshape(s.C, 2, Nx, Nt)
    chi = ref.even_from_packed(chi.reshape(s.C, *s.chi_shape), Nt)
    th0 = before.theta.double()
    rd = r.double()
    exact = ref.trajectory(before.theta, pi, chi, r, **_reference(s, ref.F64))
    near = (exact.dH + torch.log(rd)).abs() <= band
    ok = (after.unconverged - before.unconverged) == 0    # not flagged

    def gaps(dH, acc, theta_after, residuals):
        keep = torch.where(near, acc, exact.accept).reshape(-1, 1, 1, 1)
        cand = torch.where(keep, exact.theta, th0)
        return {"dH_gap": _largest(dH_gap(dH, exact.dH)[ok]),
                "theta_gap": _largest(ref.wrap(theta_after - cand).abs()[ok]),
                "act_res": max(_largest(v[ok]) for v in residuals)}

    em = after.exp_mdH
    dH = -torch.log(em)
    acc = (after.accepted - before.accepted) == 1
    res = [ref.residual(ref.packed_solve(*sv)) for sv in after.solves]
    out = {"program": gaps(dH, acc, after.theta.double(), res)}
    clear = (rd - em).abs() > 1e-12
    out["program"]["accept_mismatch"] = int((clear & (acc != (rd <= em))).sum())
    spike = certain_reject(dH) & certain_reject(exact.dH)
    out["program"]["ref_unconverged"] = int((ok & ~exact.converged & ~spike).sum())
    for name, prec in controls.items():
        low = ref.trajectory(before.theta, pi, chi, r, **_reference(s, prec))
        kept = torch.where(low.accept.reshape(-1, 1, 1, 1), low.theta.double(), th0)
        out[name] = gaps(low.dH, low.accept, kept,
                         [ref.residual(sv) for sv in low.action_solves])
    return out


def _compare_row(s: Session, res, row: int, theta: torch.Tensor,
                 controls: dict) -> dict:
    """The gaps of measurement `row` of theta against the float64
    reference, under "program" and under the name of each control:
    meas_gap, the largest absolute gap of the plaquette, the action density
    and the charge; cond_gap, the largest relative gap of the condensate."""
    beta = s.cell.config["physics"]["beta"]
    exact = ref.observables(theta.double(), beta)

    def meas_gap(got):
        return {"meas_gap": max(float((got[k].reshape(-1) - exact[k]).abs().max())
                                for k in OBSERVABLES)}

    out = {"program": meas_gap({k: torch.as_tensor(res.chains[k][row], device=s.device)
                                for k in OBSERVABLES})}
    for name, prec in controls.items():
        out[name] = meas_gap({k: v.double() for k, v in
                              ref.observables(theta.to(prec.real), beta).items()})
    if s.condensate:
        Nx, Nt = s.lattice.Nx, s.lattice.Nt
        z = philox.z2_noise(s.seed, row, s.C, s.n_noise, 2 * Nx * Nt,
                            s.device).reshape(s.C, s.n_noise, 2, Nx, Nt)
        m0 = s.cell.config["physics"]["m0"]
        cc = ref.condensate(theta.double(), z, m0)
        got = {"program": torch.as_tensor(res.chains["chiral_condensate"][row],
                                          device=s.device).reshape(-1)}
        for name, prec in controls.items():
            got[name] = ref.condensate(theta.to(prec.real), z, m0, prec)
        for name, v in got.items():
            out[name]["cond_gap"] = float(((v - cc) / cc).abs().max())
    return out


def compare(s: Session, w: Window, band: float, controls: dict = None) -> dict:
    """Every number the check compares, the largest over the two kept
    trajectories and their measurement rows: {"program": {number: gap},
    and for each control of `controls` (name -> reference.Precision) its
    own, the reference at that precision in the program's place}."""
    controls = controls or {}
    gaps = {name: {} for name in ("program", *controls)}
    rows = {0: 0, w.row * (1 + s.n_steps): w.row}
    for k, (before, after) in sorted(w.probe.snaps.items()):
        with torch.no_grad():
            step = _compare_step(s, w.first + k, before, after, band, controls)
            row = _compare_row(s, w.result, rows[k], after.theta, controls)
        for name in gaps:
            for number, v in {**step[name], **row[name]}.items():
                old = gaps[name].get(number)
                gaps[name][number] = v if old is None else max(old, v)
    return gaps


# ---------- the trace ----------

def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_seconds: dict        # device operation name -> seconds
    gaps: list                  # [(host activity, seconds)], longest first

    def seconds_of(self, *parts) -> Optional[float]:
        """Device seconds of the operations whose name holds one of `parts`,
        None where none ran."""
        hits = [v for k, v in self.kernel_seconds.items()
                if any(p in k for p in parts)]
        return sum(hits) if hits else None


def short_name(name: str) -> str:
    """A device operation's name without its return type, template and
    argument lists, with the functor of a PyTorch elementwise kernel."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = base.split("<", 1)[0].split("(", 1)[0]
    functor = re.search(r"(CUDAFunctor_\w+|\w+Functor\w*|\w+_kernel_cuda"
                        r"|\w+_kernel_impl|\w+_cuda_out|\w+_functor)", name)
    return f"{base} [{functor.group(1)}]" if functor else base


def reduce_trace(prof) -> Trace:
    """The traced window's busy time (the union of device operations),
    device seconds by operation, and the idle gaps, each named by the
    innermost host event under way at its middle."""
    events = prof.profiler.kineto_results.events()
    host, dev, win = [], [], None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.name() == "bench.window":
            if not on_card:
                win = (start, end)
        elif on_card:
            dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
    if win is None:
        raise RuntimeError("the trace has no window span")
    dev = sorted((max(a, win[0]), min(b, win[1]), n) for a, b, n in dev
                 if b > win[0] and a < win[1])
    per_op = {}
    for a, b, n in dev:
        per_op[n] = per_op.get(n, 0.0) + (b - a) * 1e-9
    busy, gaps, edge = 0, [], win[0]
    for a, b, _ in dev:
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if win[1] > edge:
        gaps.append((edge, win[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        under = [(e - s_, n) for s_, e, n in host if s_ <= mid < e]
        named.append((min(under)[1] if under else "host: outside any op",
                      (b - a) * 1e-9))
    return Trace((win[1] - win[0]) * 1e-9, busy * 1e-9, per_op, named)


@dataclasses.dataclass
class Counts:
    """The work of a stretch of a call: trajectories and measurements a
    chain, and their solver iterations summed over the chains."""
    trajectories: int
    n_meas: int
    cg_iters: int
    condensate_iters: int


def traced_stretch(s: Session, n_meas: int) -> tuple:
    """A call of n_meas measurements under torch.profiler, after the window;
    (its Trace, its Counts), both of the stretch from the trajectory step
    after both programs' captures and first replays to the call's return:
    the steps before it and their iterations are left out."""
    s.release()
    probe = Probe((), stretch=True)
    with _profiler() as prof:
        res, *_ = _checked_call(s, n_meas, probe)
    steps, rows = probe.opened
    counts = Counts(s.trajectories(n_meas) - steps, n_meas - rows,
                    int(res.cg_iters_total) - int(probe.iters_before), 0)
    if s.condensate:
        before = probe.meas.out["condensate_iters"][:rows]
        counts.condensate_iters = int(res.condensate_iters) - int(before.sum())
    return reduce_trace(prof), counts


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reads: the timed window's RunResult, its
    shape, the configuration's physics, the window's counts and wall
    seconds; with a card, the traced stretch's trace and counts."""
    result: object
    C: int
    V2: int
    physics: dict          # the configuration's physics
    n_noise: int
    condensate: bool
    window: Counts
    wall_s: float
    trace: Optional[Trace]
    traced: Optional[Counts]


# ---------- one run ----------

def card_label(dev: torch.device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (a card set below its
    700 W runs slower under load), None where the query fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def _device(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "card": card_label(dev)}


def count_failed(s: Session, w: Window) -> int:
    """The window's chain-trajectories with an unconverged solve (every one
    the program flags, RunResult.unconverged_chain_trajs: a rejected MD
    blow-up whose solves did not converge counts too) and, in a cell with
    the condensate, chain measurements whose condensate solve did not
    converge."""
    n = int(w.result.unconverged_chain_trajs)
    if s.condensate:
        n += int((~w.probe.meas.out["condensate_converged"]).sum())
    return n


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> tuple:
    """One run: (the result line's object, the compared numbers with their
    limits)."""
    s = Session(cell, seed, device)
    n_meas = setup(s, seconds)
    w = window(s, n_meas)
    traj = s.trajectories(n_meas)
    failed = count_failed(s, w)
    counts = Counts(traj, n_meas, int(w.result.cg_iters_total),
                    int(w.result.condensate_iters))
    w.probe.traj = w.probe.meas = None     # free the programs' memory
    tr = traced = None
    if trace and s.device.type == "cuda":
        tr, traced = traced_stretch(s, int(cell.traffic["trace_meas"]))
    dev = _device(s.device)
    metrics = {}
    if trace:
        ctx = MetricContext(w.result, s.C, s.V2, cell.config["physics"], s.n_noise,
                            s.condensate, counts, w.seconds, tr, traced)
        for m, read in cell.per_layer:
            v = read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    else:
        values = {"chain_traj_per_s": s.C * traj / w.seconds,
                  "setup_s": w.start - t_start}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    s.release()
    gaps = compare(s, w, cell.limits["dH_gap"])["program"]
    lim = limits(cell)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    line = {"correct": correct, "attempted": s.C * (traj + n_meas),
            "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        ops = {}
        for n, v in tr.kernel_seconds.items():
            ops[short_name(n)] = ops.get(short_name(n), 0.0) + v
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n, v] for n, v in top],
                             "idle_gaps": [[n, v] for n, v in tr.gaps]}
    line["checks"] = checks
    return line, checks
