"""ctypes bridge to the port's host-side C++ tier
(``agp_tpu_torch/csrc/host/agp_native.cpp``): the counterpart of
``agp_tpu/utils/native.py``, with the port's own copy of the source.

The library is compiled with g++ at first use into
``agp_tpu_torch/_build/host-<hash>/`` (gitignored; the hash of the source,
the flags and the host's name, since ``-march=native`` ties a build to its
machine), written to
a temporary name and renamed into place, so that processes building at
once never load a half-written file.  Without a compiler ``available()``
is false and the callers in ``inducing/algorithms.py`` take their numpy
versions.  ``oips.calls`` counts the OIPS calls, so that a caller can tell
which version ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "host" / "agp_native.cpp"
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


def _out_path() -> Path:
    h = hashlib.sha256(" ".join((*_FLAGS, platform.node())).encode())
    h.update(_SRC.read_bytes())
    return _PKG / "_build" / f"host-{h.hexdigest()[:16]}" / "libagp_native.so"


@lru_cache(maxsize=1)
def _lib():
    if not _SRC.exists():
        return None
    out = _out_path()
    try:
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
                part = Path(tmp) / out.name
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(part)], check=True, capture_output=True)
                os.replace(part, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.kmeans_lloyd.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.kmeans_lloyd.restype = None
    lib.oips_select.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.oips_select.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _lib() is not None


def library_path() -> str:
    """Where the library is (or would be) built."""
    return str(_out_path())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def kmeans(X: np.ndarray, k: int, n_iters: int = 20, seed: int = 0) -> np.ndarray:
    """Lloyd's k-means from ``k`` rows of X chosen by
    ``RandomState(seed)``: the centres [k, D], float64."""
    lib = _lib()
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
    n, d = X.shape
    rng = np.random.RandomState(seed)
    C = np.ascontiguousarray(X[rng.choice(n, size=min(k, n), replace=False)].copy())
    assign = np.zeros(n, dtype=np.int32)
    lib.kmeans_lloyd(_ptr(X, ctypes.c_double), n, d, _ptr(C, ctypes.c_double), C.shape[0], n_iters,
                     _ptr(assign, ctypes.c_int32))
    return C



def oips(X: np.ndarray, rho: float, lengthscale: float, capacity: int) -> np.ndarray:
    """The sequential OIPS pass with a unit-variance RBF correlation: the
    accepted rows [m, D], float64, m <= capacity."""
    oips.calls += 1
    lib = _lib()
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
    n, d = X.shape
    Z = np.zeros((capacity, d), dtype=np.float64)
    m = lib.oips_select(_ptr(X, ctypes.c_double), n, d, float(rho), float(lengthscale), capacity,
                        _ptr(Z, ctypes.c_double))
    return Z[:m]


oips.calls = 0
