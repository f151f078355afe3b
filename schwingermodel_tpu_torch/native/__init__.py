"""The native (C++) configuration codec, loaded with ctypes.

Counterpart of ``schwingermodel_tpu/native/__init__.py``: the port's own
copy of ``ctxt_codec.cpp`` is compiled on first use by g++ into the
git-ignored ``schwingermodel_tpu_torch/_build/``, named by a hash of the
source (an edited source rebuilds, an unchanged one is reused; the library
is written under a temporary name and moved into place, so processes that
build at once do not see each other's half-written file). Every entry
point has a NumPy path in io/ctxt.py that writes the same bytes, taken
where no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "ctxt_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
ENTRIES = ("ctxt_write_binary", "ctxt_read_binary", "ctxt_write_text",
           "ctxt_read_text")

_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def library_path() -> Path:
    """Where the library for this source lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libctxt_codec_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run([gxx, *FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_codec():
    """The ctypes library with the ctxt_* entry points, or None where it
    cannot be built or loaded."""
    with _lock:
        if _state["lib"] is not None or _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        dptr = ctypes.POINTER(ctypes.c_double)
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, dptr, ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        return lib
