"""Build and load the package's hand-written CUDA kernels.

JAX twin: none (Pallas kernels compile inside jax; the pattern here is
that of mpmcxx_tpu/runtime/native.py).  At first use ``nvcc`` compiles
every ``csrc/*.cu`` source for Hopper (``sm_90a``, ``-O3``, no fast math)
into one shared library with a plain C interface, written to
``mpmcxx_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, and loaded with ctypes.  Nothing is built or imported when
this module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's output (ptxas register/spill report) of the build


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels if this source set has no library yet; return
    the library's path.  Raises RuntimeError with nvcc's output on
    failure."""
    global build_log
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    lib = os.path.join(_BUILD, f"libmpmcxx_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *srcs],
                       capture_output=True, text=True)
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mpmcxx_contract_planes.argtypes = [
                ctypes.POINTER(vp), ci, vp, ctypes.c_float, vp, ci, vp]
            lib.mpmcxx_contract_planes.restype = ci
            lib.mpmcxx_contract_planes_tri.argtypes = [
                ctypes.POINTER(vp), ci, vp, ctypes.c_float, vp, vp, ci, vp]
            lib.mpmcxx_contract_planes_tri.restype = ci
            lib.mpmcxx_write_plane_strips.argtypes = [
                ctypes.POINTER(vp), ci, vp, vp, vp, ci, ci, vp]
            lib.mpmcxx_write_plane_strips.restype = ci
            lib.mpmcxx_occupancy.argtypes = [
                vp, vp, vp, ctypes.c_double, ci, ci, vp, vp]
            lib.mpmcxx_occupancy.restype = ci
            _lib = lib
        return _lib
