"""ctypes bindings for the native runtime (mpmcio.cpp, the port's copy).

JAX twin: mpmcxx_tpu/runtime/native.py.  At first use ``g++ -O2 -shared
-fPIC -std=c++17 -pthread`` builds this package's ``runtime/mpmcio.cpp``
into ``mpmcxx_tpu_torch/_build/`` under a name keyed by a hash of the
source and the flags (the pattern of ops/kernels.py), and loads it with
ctypes.  Nothing is built when this module is imported.

- No ``g++`` on the machine: every entry point takes the pure-Python path
  of its caller, and one line on stderr says so (the JAX package's
  loader does the same without a compiler).
- ``g++`` present but the compile fails: ``get_lib`` raises RuntimeError
  with the compiler's output, rather than fall back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mpmcio.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """The library's path for this source and these flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libmpmcio_{h.hexdigest()[:16]}.so")


def _build(lib: str, cxx: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC} "
                               f"({r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded native library, built on first call; None where the
    machine has no g++ (the callers then take their Python paths)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        lib = lib_path()
        if not os.path.exists(lib):
            cxx = shutil.which("g++")
            if cxx is None:
                _tried = True
                sys.stderr.write("mpmcxx_tpu_torch: no g++ found; the PQR "
                                 "codec and restart writer run in Python\n")
                return None
            _build(lib, cxx)
        _tried = True
        cdll = ctypes.CDLL(lib)
        cp, ci, cll = ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong
        pi, pd = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
        cdll.pqr_format.restype = cll
        cdll.pqr_format.argtypes = [ci, cp, cp, cp, pi, pd, pd, ci, cp, cll]
        cdll.pqr_parse.restype = cll
        cdll.pqr_parse.argtypes = [cp, cll, ci, cp, cp, cp, pi, pd, pd]
        cdll.async_write.restype = None
        cdll.async_write.argtypes = [cp, cp, cll, ci]
        cdll.async_drain.restype = None
        cdll.async_drain.argtypes = []
        cdll.async_errors.restype = cll
        cdll.async_errors.argtypes = []
        _lib = cdll
        return _lib


def _pack_str8(strings) -> np.ndarray:
    out = np.zeros((len(strings), 8), dtype=np.uint8)
    for i, s in enumerate(strings):
        b = s.encode()[:7]
        out[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def pqr_format_native(data: dict, ext_output: bool) -> str | None:
    """Bulk-serialise ATOM lines via the native codec; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data["atomtype"])
    at = _pack_str8(data["atomtype"])
    mt = _pack_str8(data["moleculetype"])
    fl = np.frombuffer("".join(data["flag"]).encode(), dtype=np.uint8)
    mid = np.asarray(data["molecule_id"], dtype=np.int32)
    pos = np.ascontiguousarray(data["pos"], dtype=np.float64)
    params = np.stack([np.asarray(data[k], dtype=np.float64)
                       for k in ("mass", "charge_e", "polarizability",
                                 "epsilon", "sigma", "omega", "gwp_alpha",
                                 "c6", "c8", "c10", "c9")], axis=1)
    params = np.ascontiguousarray(params)
    cap = 512 * max(n, 1)
    buf = ctypes.create_string_buffer(cap)
    w = lib.pqr_format(
        ctypes.c_int(n),
        at.ctypes.data_as(ctypes.c_char_p),
        mt.ctypes.data_as(ctypes.c_char_p),
        fl.ctypes.data_as(ctypes.c_char_p),
        mid.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int(1 if ext_output else 0),
        buf, ctypes.c_longlong(cap))
    if w < 0:
        return None
    return buf.raw[:w].decode()


def pqr_parse_native(text: str, max_atoms: int = 1 << 20):
    """Bulk-parse ATOM records; returns dict of arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode()
    at = np.zeros((max_atoms, 8), dtype=np.uint8)
    mt = np.zeros((max_atoms, 8), dtype=np.uint8)
    fl = np.zeros(max_atoms, dtype=np.uint8)
    mid = np.zeros(max_atoms, dtype=np.int32)
    pos = np.zeros((max_atoms, 3), dtype=np.float64)
    params = np.zeros((max_atoms, 11), dtype=np.float64)
    n = lib.pqr_parse(
        ctypes.c_char_p(raw), ctypes.c_longlong(len(raw)),
        ctypes.c_int(max_atoms),
        at.ctypes.data_as(ctypes.c_char_p),
        mt.ctypes.data_as(ctypes.c_char_p),
        fl.ctypes.data_as(ctypes.c_char_p),
        mid.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n < 0:
        raise ValueError(f"malformed PQR line {-int(n)}")
    n = int(n)

    def unpack(arr):
        return [bytes(arr[i]).rstrip(b"\0").decode() for i in range(n)]

    return {
        "atomtype": unpack(at), "moleculetype": unpack(mt),
        "flag": [chr(c) for c in fl[:n]],
        "molecule_id": mid[:n], "pos": pos[:n], "params": params[:n],
    }


def async_write(path: str, text: str, rotate_last: bool) -> bool:
    """Queue a file write on the native writer thread; False -> caller
    should write synchronously."""
    lib = get_lib()
    if lib is None:
        return False
    raw = text.encode()
    lib.async_write(path.encode(), raw, len(raw),
                    1 if rotate_last else 0)
    return True


def async_drain() -> None:
    """Block until every queued write is on disk (no-op without the
    library)."""
    lib = get_lib()
    if lib is not None:
        lib.async_drain()


def async_errors() -> int:
    """Failed writes of the native writer since the process started."""
    lib = get_lib()
    return int(lib.async_errors()) if lib is not None else 0
