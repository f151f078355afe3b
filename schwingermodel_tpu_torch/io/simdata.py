"""Run-metadata summary file (_SimData.txt), format-compatible with the
reference's writer (src/main.cpp:97-126 header, :163-172 results append).

A copy of ``schwingermodel_tpu/io/simdata.py`` (standard library only).

The reference writes this file in two stages: header before the run, results
appended after. SimData mirrors that with write_header()/append_results().
Field widths and 17-digit precision match the C++ iostream formatting so a
diff against reference output is whitespace-identical for identical values.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket


def _g17(v: float) -> str:
    """C++ `std::setprecision(17) << v` (general format, 17 sig digits)."""
    return f"{float(v):.17g}"


def simdata_filename(Nx: int, Nt: int, m0: float) -> str:
    """`2D_U1_{Nx}x{Nt}_m0{m0:.17g}_SimData.txt` (src/main.cpp:97-105)."""
    return f"2D_U1_{Nx}x{Nt}_m0{_g17(m0)}_SimData.txt"


@dataclasses.dataclass
class SimData:
    path: str

    def write_header(
        self, *, Nx, Nt, ranks_x, ranks_t, beta, n_therm, n_meas, n_steps,
        trajectory_length, md_steps, cg_max_iter, cg_tol, m0,
        start_time: str | None = None, host: str | None = None,
        cg_force_tol: float | None = None,
    ) -> None:
        if start_time is None:
            start_time = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        if host is None:
            host = os.environ.get("HOSTNAME") or socket.gethostname() or "unknown"
        w = []
        w.append("#Date and time\n")
        w.append(f"{start_time}\n")
        w.append("#Host\n")
        w.append(f"{host}\n")
        w.append("#Nx      #Nt\n")
        w.append(f"{Nx:>10}{Nt:>10}\n")
        w.append("#ranks_x     #ranks_t     #ranks\n")
        w.append(f"{ranks_x:>15}{ranks_t:>15}{ranks_x * ranks_t:>15}\n")
        w.append("#beta                        #Ntherm     #Nmeas     #Nsteps\n")
        w.append(f"{_g17(beta):>30}{n_therm:>11}{n_meas:>11}{n_steps:>11}\n")
        w.append("#trajectory_length     #MD_steps\n")
        w.append(f"{_g17(trajectory_length):>30}{md_steps:>30}\n")
        w.append("#CG max iterations     #CG relative tolerance\n")
        w.append(f"{cg_max_iter:>30}{_g17(cg_tol):>30}\n")
        w.append("#m0\n")
        w.append(f"{_g17(m0):>30}\n")
        if cg_force_tol is not None and cg_force_tol != cg_tol:
            # framework-only: the split-residual contract's resolved MD
            # force tolerance (config.CGParams.force_tol; action solves run
            # at cg_tol). Appended past the reference layout so runs are
            # self-describing; omitted when there is no split, keeping the
            # file byte-identical to the reference writer.
            w.append("#CG force tolerance (MD solves)\n")
            w.append(f"{_g17(cg_force_tol):>30}\n")
        with open(self.path, "w") as f:
            f.write("".join(w))

    def append_results(
        self, *, Ep, dEp, gS, dgS, acceptance_rate, elapsed_seconds,
        extra: dict | None = None,
    ) -> None:
        w = []
        w.append("#Ep                           #dEp\n")
        w.append(f"{_g17(Ep):>30}{_g17(dEp):>30}\n")
        w.append("#gS                           #dgS\n")
        w.append(f"{_g17(gS):>30}{_g17(dgS):>30}\n")
        w.append("#Acceptance rate\n")
        w.append(f"{_g17(acceptance_rate):>30}\n")
        w.append("#Execution time\n")
        w.append(f"{_g17(elapsed_seconds):>30}")
        if extra:
            # framework-only observables, appended past the reference layout
            for k, (v, dv) in extra.items():
                w.append(f"\n#{k}                        #d{k}\n")
                w.append(f"{_g17(v):>30}{_g17(dv):>30}")
        with open(self.path, "a") as f:
            f.write("".join(w))
