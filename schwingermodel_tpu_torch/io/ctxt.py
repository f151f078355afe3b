"""Byte-compatible gauge-configuration files (.ctxt).

Counterpart of ``schwingermodel_tpu/io/ctxt.py:36-176``: the file names and
the NumPy write/read path, which produces the same bytes as the native
codec there. The native codec is not ported yet.

  binary  2*Nx*Nt packed 28-byte records `int32 x, int32 t, int32 mu,
          float64 re, float64 im`, ordered x-major, then t, then mu
          (reference SaveConf / readBinary, src/gauge_conf.cpp:404-419,
          :495-546).
  text    whitespace-separated `x t mu re im` lines (read_conf,
          src/gauge_conf.cpp:453-492).
  name    2D_U1_Ns{Nx}_Nt{Nt}_b{beta:.4f minus dot}_m{m0:.4f minus dot}_{i}.ctxt
"""

from __future__ import annotations

import numpy as np

RECORD_DTYPE = np.dtype(
    [("x", "<i4"), ("t", "<i4"), ("mu", "<i4"), ("re", "<f8"), ("im", "<f8")]
)


def _fmt(v: float) -> str:
    """Reference format(): fixed 4 decimals, decimal dot removed."""
    return f"{v:.4f}".replace(".", "", 1)


def conf_filename(Nx: int, Nt: int, beta: float, m0: float, index: int) -> str:
    """Measurement-configuration file name (src/hmc.cpp:202-206)."""
    return f"2D_U1_Ns{Nx}_Nt{Nt}_b{_fmt(beta)}_m{_fmt(m0)}_{index}.ctxt"


def ill_conf_filename(Nx: int, Nt: int, beta: float, m0: float, index: int) -> str:
    """Unconverged-solve dump file name (src/hmc.cpp:50-55)."""
    return f"2D_U1_Ns{Nx}_Nt{Nt}_b{_fmt(beta)}_m{_fmt(m0)}_illConf{index}.ctxt"


def links_from_theta(theta) -> np.ndarray:
    """complex128 links U = exp(i theta), [2, Nx, Nt]."""
    th = np.asarray(theta, dtype=np.float64)
    return np.cos(th) + 1j * np.sin(th)


def theta_from_links(U) -> np.ndarray:
    """Angles from complex links (principal branch)."""
    return np.angle(np.asarray(U, dtype=np.complex128)).astype(np.float64)


def _records_from_links(U: np.ndarray) -> np.ndarray:
    _, Nx, Nt = U.shape
    rec = np.empty(Nx * Nt * 2, dtype=RECORD_DTYPE)
    Uxt = np.transpose(U, (1, 2, 0)).reshape(-1)
    gx, gt, gmu = np.meshgrid(np.arange(Nx, dtype=np.int32),
                              np.arange(Nt, dtype=np.int32),
                              np.arange(2, dtype=np.int32), indexing="ij")
    rec["x"] = gx.reshape(-1)
    rec["t"] = gt.reshape(-1)
    rec["mu"] = gmu.reshape(-1)
    rec["re"] = Uxt.real
    rec["im"] = Uxt.imag
    return rec


def _links_from_records(rec: np.ndarray, Nx: int, Nt: int) -> np.ndarray:
    if rec.size != Nx * Nt * 2:
        raise ValueError(
            f"expected {Nx * Nt * 2} records for {Nx}x{Nt}, got {rec.size}")
    if (rec["x"].min() < 0 or rec["x"].max() >= Nx
            or rec["t"].min() < 0 or rec["t"].max() >= Nt
            or rec["mu"].min() < 0 or rec["mu"].max() > 1):
        raise ValueError("corrupt .ctxt: site indices out of range")
    U = np.empty((2, Nx, Nt), dtype=np.complex128)
    U[rec["mu"], rec["x"], rec["t"]] = rec["re"] + 1j * rec["im"]
    return U


def write_conf(path: str, U, *, binary: bool = True) -> None:
    """Write links U [2, Nx, Nt] to a .ctxt file (always float64 complex)."""
    rec = _records_from_links(np.ascontiguousarray(U, dtype=np.complex128))
    if binary:
        rec.tofile(path)
        return
    with open(path, "w") as f:
        for r in rec:
            f.write(f"{r['x']} {r['t']} {r['mu']} {r['re']:.17g} {r['im']:.17g}\n")


def read_conf(path: str, Nx: int, Nt: int, *, binary: bool | None = None) -> np.ndarray:
    """Read a .ctxt file -> complex128 links [2, Nx, Nt]; binary=None sniffs
    the format."""
    if binary is None:
        with open(path, "rb") as f:
            head = f.read(64)
        try:
            head.decode("ascii")
            binary = False
        except UnicodeDecodeError:
            binary = True
    if binary:
        rec = np.fromfile(path, dtype=RECORD_DTYPE)
    else:
        flat = np.loadtxt(path, dtype=np.float64).reshape(-1, 5)
        rec = np.empty(len(flat), dtype=RECORD_DTYPE)
        rec["x"] = flat[:, 0].astype(np.int32)
        rec["t"] = flat[:, 1].astype(np.int32)
        rec["mu"] = flat[:, 2].astype(np.int32)
        rec["re"], rec["im"] = flat[:, 3], flat[:, 4]
    return _links_from_records(rec, Nx, Nt)
