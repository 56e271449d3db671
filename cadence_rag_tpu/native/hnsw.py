"""ctypes binding for the native HNSW graph index (hnsw.cpp).

Literal counterpart of pgvector's HNSW (build m/ef_construction, query
ef_search). The device serving path prefers the scan / IVF (ops/ivf.py);
this backend serves CPU-only deployments and recall cross-checks.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "hnsw.cpp"
_LIB = _HERE / "_hnsw.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", str(_LIB), str(_SRC)],
                    check=True, capture_output=True, timeout=180,
                )
            except (subprocess.SubprocessError, OSError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            _build_failed = True
            return None
        lib.hnsw_build.restype = ctypes.c_void_p
        lib.hnsw_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
        ]
        lib.hnsw_search.restype = None
        lib.hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.hnsw_max_level.restype = ctypes.c_int32
        lib.hnsw_max_level.argtypes = [ctypes.c_void_p]
        lib.hnsw_free.restype = None
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class HnswIndex:
    """Build once over (N, dim) unit vectors; search with ef_search."""

    def __init__(self, vectors: np.ndarray, m: int = 16,
                 ef_construction: int = 64, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native hnsw unavailable (no toolchain)")
        self._lib = lib
        self._vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = self._vectors.shape
        self.n, self.dim = n, dim
        self._handle = lib.hnsw_build(
            self._vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, dim, m, ef_construction, seed, 0,
        )

    @property
    def max_level(self) -> int:
        return int(self._lib.hnsw_max_level(self._handle))

    def search(self, query: np.ndarray, k: int = 10,
               ef_search: int = 80) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(query, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        out_idx = np.full((q.shape[0], k), -1, dtype=np.int32)
        out_sim = np.full((q.shape[0], k), -np.inf, dtype=np.float32)
        for row in range(q.shape[0]):
            self._lib.hnsw_search(
                self._handle,
                q[row].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ef_search, k,
                out_idx[row].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_sim[row].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        return out_sim, out_idx

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.hnsw_free(handle)
            except Exception:
                pass
            self._handle = None
