"""Byte-compatible gauge-configuration files (.ctxt).

Counterpart of ``schwingermodel_tpu/io/ctxt.py``: the file names, the
readers and writers, the binary-to-text converter and the lattice shape
read from a binary file's own records. Encoding and decoding run through
the port's native codec (native/ctxt_codec.cpp, built on first use) where
it loads, else through a vectorized NumPy path that writes the same bytes.
Links are written as float64 complex whatever the working precision, as the
reference does.

  binary  2*Nx*Nt packed 28-byte records `int32 x, int32 t, int32 mu,
          float64 re, float64 im`, ordered x-major, then t, then mu
          (reference SaveConf / readBinary, src/gauge_conf.cpp:404-419,
          :495-546).
  text    whitespace-separated `x t mu re im` lines (read_conf,
          src/gauge_conf.cpp:453-492).
  name    2D_U1_Ns{Nx}_Nt{Nt}_b{beta:.4f minus dot}_m{m0:.4f minus dot}_{i}.ctxt
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from schwingermodel_tpu_torch.native import load_codec

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


def _interleaved(U: np.ndarray) -> np.ndarray:
    """[2, Nx, Nt] complex128 -> C-contiguous interleaved re/im doubles,
    the native codec's layout."""
    U = np.ascontiguousarray(U, dtype=np.complex128)
    return U.view(np.float64)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


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
    U = np.ascontiguousarray(U, dtype=np.complex128)
    _, Nx, Nt = U.shape
    lib = load_codec()
    if lib is not None:
        buf = _interleaved(U)              # a view of U, alive for the call
        fn = lib.ctxt_write_binary if binary else lib.ctxt_write_text
        rc = fn(path.encode(), _dptr(buf), Nx, Nt)
        if rc != 0:
            raise OSError(f"native ctxt write failed ({rc}): {path}")
        return
    # the NumPy path: the same bytes
    rec = _records_from_links(U)
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
    lib = load_codec()
    if lib is not None:
        buf = np.empty((2, Nx, Nt, 2), dtype=np.float64)
        fn = lib.ctxt_read_binary if binary else lib.ctxt_read_text
        rc = fn(path.encode(), _dptr(buf), Nx, Nt)
        if rc == -1:
            raise FileNotFoundError(path)
        if rc != 0:
            raise ValueError(f"corrupt or wrong-shape .ctxt ({rc}): {path}")
        return (buf[..., 0] + 1j * buf[..., 1]).astype(np.complex128)
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


def convert_binary_to_text(src: str, dst: str, Nx: int, Nt: int) -> None:
    """Binary .ctxt -> its whitespace text form (reference readBinConf.cpp /
    readBin.sh)."""
    write_conf(dst, read_conf(src, Nx, Nt, binary=True), binary=False)


def sniff_lattice_shape(path: str) -> tuple[int, int]:
    """(Nx, Nt) of a binary .ctxt file, from its own index records."""
    rec = np.fromfile(path, dtype=RECORD_DTYPE)
    if rec.size == 0 or os.path.getsize(path) % RECORD_DTYPE.itemsize:
        raise ValueError(f"not a binary .ctxt file: {path}")
    return int(rec["x"].max()) + 1, int(rec["t"].max()) + 1
