"""ctypes binding of the native Clos router (``csrc/routing.cc``).

The library is host C++: g++ builds it at first use into the git-ignored
``build/routing-<hash>.so`` (the hash covers the source and the flags).
There is no NumPy fallback: the pure-NumPy router (``ops/benes.py``, the
tests' oracle) is about a thousand times slower, far too slow for the 2M
edges of a real graph, so without g++, or when the build fails, ``load``
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ihgnn_torch.ops._build import BUILD, CSRC

SOURCE = CSRC / "routing.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path():
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD / f"routing-{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The routing library, built with g++ first if needed; raises when it
    cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found on PATH; the routed pack "
                                   "needs it to build csrc/routing.cc")
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on {SOURCE} (rc "
                                   f"{proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ihgnn_benes_route.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                          ctypes.c_int64, ctypes.c_int32,
                                          ctypes.c_int32, i32p, i32p, i32p]
        lib.ihgnn_benes_route.restype = ctypes.c_int
        _LIB = lib
        return lib


def benes_route(perm: np.ndarray, rows: int, cols: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(p0 [R, C], p1 [C, R], p2 [R, C])`` int32 stage tables of
    ``out[j] = in[perm[j]]`` over E = rows·cols elements (the stage
    semantics of ``ops/benes.py``); cols a power of two. The call releases
    the interpreter lock, so two routes run in parallel threads."""
    lib = load()
    perm = np.ascontiguousarray(perm, np.int64)
    if perm.shape != (rows * cols,):
        raise ValueError(f"perm has shape {perm.shape}, not "
                         f"({rows * cols},)")
    p0 = np.empty((rows, cols), np.int32)
    p1 = np.empty((cols, rows), np.int32)
    p2 = np.empty((rows, cols), np.int32)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    rc = lib.ihgnn_benes_route(ptr(perm, ctypes.c_int64), perm.size, rows,
                               cols, ptr(p0, ctypes.c_int32),
                               ptr(p1, ctypes.c_int32),
                               ptr(p2, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"ihgnn_benes_route failed with code {rc}")
    return p0, p1, p2
