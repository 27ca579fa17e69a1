"""Build and load the package's hand-written CUDA kernels.

JAX twin: none (Pallas kernels compile inside jax; the pattern here is
that of mpmcxx_tpu/runtime/native.py).  At first use ``nvcc`` compiles
every ``csrc/*.cu`` source for Hopper (``sm_90a``, ``-O3``, no fast math),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, written to
``mpmcxx_tpu_torch/_build/`` under a name keyed by a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags, and loaded with
ctypes.  Nothing is built or imported when this module is imported.
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
              "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's output (ptxas register/spill report) of the build


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


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
    for s in srcs + _headers():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    lib = os.path.join(_BUILD, f"libmpmcxx_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    tmp = f"{lib}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    os.makedirs(_BUILD, exist_ok=True)
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        build_log = "".join(outs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        build_log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, lib)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mpmcxx_contract_planes.argtypes = [
                ctypes.POINTER(vp), ci, vp, ctypes.c_float, vp, ci, vp, ci,
                ci, vp]
            lib.mpmcxx_contract_planes.restype = ci
            lib.mpmcxx_contract_planes_slots.argtypes = [
                ctypes.POINTER(vp), ci, vp, ci, ci]
            lib.mpmcxx_contract_planes_slots.restype = ci
            lib.mpmcxx_contract_planes_tri.argtypes = [
                ctypes.POINTER(vp), ci, vp, ctypes.c_float, vp, vp, ci, vp]
            lib.mpmcxx_contract_planes_tri.restype = ci
            lib.mpmcxx_contract_planes_sym.argtypes = [
                ctypes.POINTER(vp), ci, vp, ctypes.c_float, vp, ci, vp, ci,
                vp]
            lib.mpmcxx_contract_planes_sym.restype = ci
            lib.mpmcxx_contract_planes_sym_slots.argtypes = [ci, ci]
            lib.mpmcxx_contract_planes_sym_slots.restype = ci
            lib.mpmcxx_write_plane_strips.argtypes = [
                ctypes.POINTER(vp), ci, vp, vp, vp, ci, ci, ci, ci, ci, vp]
            lib.mpmcxx_write_plane_strips.restype = ci
            lib.mpmcxx_occupancy.argtypes = [
                vp, vp, vp, ctypes.c_double, ci, ci, vp, vp]
            lib.mpmcxx_occupancy.restype = ci
            _lib = lib
        return _lib
