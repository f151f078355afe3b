"""Build and load the port's hand-written CUDA kernels.

On first use, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
for ``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, under
``schwingermodel_tpu_torch/_build/``, named by a hash of the sources (so an
edited source rebuilds and an unchanged one is reused). The library is
loaded with ``ctypes``; every pointer and the stream are passed as
``c_void_p``. Nothing here runs at import time.

No ``--use_fast_math``: the 1e-10 solver contract needs accurate
``sincos``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
L, U = ctypes.c_longlong, ctypes.c_uint

# Dynamic shared memory a kernel may ask for (csrc/stencil.cuh kSharedMax):
# the wrappers of K1, K2, K3, K7, K8, K9 and K10 choose a kernel's path by
# it before the launch.
SHARED_MAX = 220 * 1024
# Sites one block holds on a shared path: its 512 threads own 4 each
# (csrc/shared_stencil.cuh kOwnSites).
BLOCK_SITES = 4 * 512
# Multiprocessors of an H100 SXM, for callers that name a path without a card
# at hand.
H100_SMS = 132

# C entry points: name -> argument types. Each launch returns
# cudaGetLastError(); each query (QUERIES) returns its answer.
SIGNATURES = {
    # thE, thO, phi, x0, psi, FE, FO, iters, conv, scratch, C, Nx, Nth,
    # m0, beta, tol, max_iter, with_solve, with_gauge, path, blocks, stream
    "force_step_launch": [P, P, P, P, P, P, P, P, P, P,
                          I, I, I, D, D, D, I, I, I, I, I, P],
    # thE, thO, b, x0, x, iters, rho, bnorm2, scratch,
    # C, Nx, Nth, m0, tol, max_iter, path, stream
    "solve_fused_launch": [P, P, P, P, P, P, P, P, P, I, I, I, D, D, I, I, P],
    # the arguments of solve_fused_launch
    "solve_mxu_launch": [P, P, P, P, P, P, P, P, P, I, I, I, D, D, I, I, P],
    # in, out_p, out_m, n_planes, Nx, Nth, stream
    "shift_mxu_launch": [P, P, P, I, I, I, P],
    # thE, thO, psi, phi2, FE, FO, scratch, C, Nx, Nth, m0, m1, beta, path,
    # blocks, stream
    "ratio_force_launch": [P, P, P, P, P, P, P, I, I, I, D, D, D, I, I, P],
    # thE, thO, b, hist, K, x, x64, iters, fb_iters, conv, scratch32,
    # scratch64, clocks, xch, C, Nx, Nth, m0, tol, tau, max_iter, max_outer,
    # certify, cert_k, fallback, fb_max_iter, fb_max_rounds, path, cluster,
    # stream
    "solve_ru_launch": [P, P, P, P, I, P, P, P, P, P, P, P, P, P,
                        I, I, I, D, D, D, I, I, I, I, I, I, I, I, I, P],
    # thE, thO, b, x64_in, conv_in, iters_in, x, x64, iters, fb_iters, conv,
    # scratch64, C, Nx, Nth, m0, tol, tau, max_iter, max_rounds, stream
    "cg_fallback_launch": [P, P, P, P, P, P, P, P, P, P, P, P,
                           I, I, I, D, D, D, I, I, P],
    # ue, uo, b, x0, x, iters, rho, bnorm2, scratch,
    # C, B, Nx, Nth, m0, tol, max_iter, active, path, stream
    "cg_eo_launch": [P, P, P, P, P, P, P, P, P, I, I, I, I, D, D, I, P, I, P],
    # thE, thO, b, x, r, rnorm2, scratch, tickets, C, B, Nx, Nth, m0,
    # active, path, blocks, rhs, stream
    "residual_launch": [P, P, P, P, P, P, P, P, I, I, I, I, D, P, I, I, I, P],
    # ue, uo, off, v, r, out, dots, scratch, n_blocks, Nxe, Nthe, m0,
    # with_dots, path, blocks, stream
    "halo_normal_launch": [P, P, P, P, P, P, P, P, I, I, I, D, I, I, I, P],
    # ue, uo, off, psi, FE, FO, scratch, n_blocks, Nxe, Nthe, m0, beta, path,
    # blocks, stream
    "halo_force_launch": [P, P, P, P, P, P, P, I, I, I, D, D, I, I, P],
    # traj, traj_value, key0, key1, chain_offset, pi, chi, r, words, C,
    # n_pairs, n_chi, f64, stream
    "noise_launch": [P, L, U, U, L, P, P, P, P, I, I, I, I, P],
    # meas, meas_value, key0, key1, chain_offset, z, words, C, n_noise,
    # n_el, stream
    "z2_launch": [P, L, U, U, L, P, P, I, I, I, P],
    # ctr, key0, key1, out, n, stream
    "philox_launch": [P, U, U, P, I, P],
    # Nx, Nth, path -> K6's blocks a multiprocessor runs at once (no stream)
    "cg_eo_blocks_per_sm": [I, I, I],
    # Nx, Nth, path, blocks a chain -> K3's clusters (cluster path) or
    # blocks (the others) the card runs at once (no stream)
    "solve_ru_at_once": [I, I, I, I],
    # blocks a chain, Nth -> the 8-byte words of the L2 path's exchange
    # area a chain (no stream)
    "solve_ru_l2_words": [I, I],
}
QUERIES = ("cg_eo_blocks_per_sm", "solve_ru_at_once", "solve_ru_l2_words")


class KernelLibrary:
    """The compiled kernels: ``build()`` once, then ``call(name, *args)``.
    csrc and build_dir: where the sources lie and the library goes (another
    checkout's, for a tool that times its kernels against these)."""

    def __init__(self, csrc: Path = CSRC, build_dir: Path = BUILD_DIR):
        self._lib = None
        self.build_seconds = None
        self.build_log = ""
        self.path = None
        self.csrc, self.build_dir = Path(csrc), Path(build_dir)

    def sources(self):
        return sorted(self.csrc.glob("*.cu")) + sorted(self.csrc.glob("*.cuh"))

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in self.sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]

    def build(self):
        """Compile (unless a library for these sources exists) and load."""
        if self._lib is not None:
            return self._lib
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        out = self.build_dir / f"libschwinger_{self._digest()}.so"
        t0 = time.perf_counter()
        if not out.exists():
            self._compile(nvcc, out)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib, self.path = lib, out
        return lib

    def _compile(self, nvcc: str, out: Path) -> None:
        """One nvcc per source, all running at once, then one link."""
        tmp = Path(tempfile.mkdtemp(dir=self.build_dir))
        try:
            jobs = []
            for src in sorted(self.csrc.glob("*.cu")):
                obj = tmp / (src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(self.csrc), "-c", "-o", str(obj),
                       str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            errs = [proc.communicate()[1] for _, _, proc in jobs]
            for (cmd, _, proc), err in zip(jobs, errs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{err}")
            link = [nvcc, "-shared", "-o", str(tmp / out.name),
                    *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{' '.join(link)}\n{proc.stderr}")
            self.build_log = "".join(errs)
            os.replace(tmp / out.name, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def call(self, name: str, *args):
        """Launch on the current stream; raise on a launch error."""
        lib = self.build()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def entry(self, name: str):
        """The C entry point itself, for a caller that launches it often and
        passes the stream and checks the returned error itself."""
        return getattr(self.build(), name)

    def query(self, name: str, *args) -> int:
        """A query's answer; raise where it returns minus a CUDA error."""
        if name not in QUERIES:
            raise ValueError(f"{name} is not a query of the kernel library")
        out = getattr(self.build(), name)(*args)
        if out < 0:
            raise RuntimeError(f"{name}: CUDA error {-out}")
        return out


KERNELS = KernelLibrary()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Multiprocessors of the card `device` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype, shape, cuda: bool = True) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape, on a
    CUDA device where `cuda`."""
    if cuda and not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=None)
def _driver():
    """The CUDA driver library, for the graph queries below."""
    return ctypes.CDLL("libcuda.so.1")


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver's API."""
    _fields_ = [("func", P), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_bytes", ctypes.c_uint), ("params", P), ("extra", P),
                ("kern", P), ("ctx", P)]


def _kernel_name(drv, node) -> str:
    """The device function a kernel node launches, as the driver names it
    (mangled), or "?" where the driver cannot say."""
    params, name = _KernelNodeParams(), ctypes.c_char_p()
    if drv.cuGraphKernelNodeGetParams_v2(P(node), ctypes.byref(params)) != 0:
        return "?"
    func = P(params.func)
    if not func.value and params.kern:
        drv.cuKernelGetFunction(ctypes.byref(func), P(params.kern))
    if not func.value or drv.cuFuncGetName(ctypes.byref(name), func) != 0:
        return "?"
    return name.value.decode()


def captured_kernels(stream: int) -> collections.Counter:
    """The kernel nodes of the graph that `stream` (a raw cudaStream_t, as
    ``torch.cuda.current_stream().cuda_stream``) is capturing, counted by
    the name of the device function each launches, by the CUDA driver's
    stream-capture and graph queries; raise where the stream is not
    capturing or a query of the nodes fails."""
    drv = _driver()
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    if hasattr(drv, "cuStreamGetCaptureInfo_v2"):
        err = drv.cuStreamGetCaptureInfo_v2(
            P(stream), ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n_deps))
    else:                                  # drivers that export only v3
        edges = ctypes.c_void_p()
        err = drv.cuStreamGetCaptureInfo_v3(
            P(stream), ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(edges),
            ctypes.byref(n_deps))
    if err != 0 or status.value != 1 or not graph.value:  # 1: ACTIVE
        raise RuntimeError(f"stream capture query: CUDA error {err}, status "
                           f"{status.value}")
    n = ctypes.c_size_t(0)
    err = drv.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if err == 0 and n.value:
        err = drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    kind, kernels = ctypes.c_int(), collections.Counter()
    for node in nodes:
        if err != 0:
            break
        err = drv.cuGraphNodeGetType(P(node), ctypes.byref(kind))
        if kind.value == 0:                # CU_GRAPH_NODE_TYPE_KERNEL
            kernels[_kernel_name(drv, node)] += 1
    if err != 0:
        raise RuntimeError(f"graph node query: CUDA error {err}")
    return kernels
