"""ctypes binding to the native symbolic-analysis library.

The port's own binding of the committed `native/libclarabel_symbolic.so`
(plain C entry points, built from `native/symbolic.cpp`), which it loads
read-only: it never builds or rebuilds the library.  Where the library is
absent or does not load, `available()` is false and the callers do what
the reference does without it (`structure.py` races only its Python
bisectors; `chordal/symbolic.py` keeps its Python ordering).  It exposes:

* `min_degree_ordering_native(adj)` — fill-reducing ordering
* `multilevel_bisect_native(adj, weights)` — METIS-style bisection
* `symbolic_cholesky_native(adj, perm)` — L pattern of the permuted graph
"""

import ctypes
import os
from typing import List, Optional, Set

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_PATH = os.path.join(_REPO_ROOT, "native", "libclarabel_symbolic.so")

_lib = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        _load_failed = True
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.cl_min_degree_order.restype = ctypes.c_int
    lib.cl_min_degree_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.cl_symbolic_cholesky.restype = ctypes.c_int64
    lib.cl_symbolic_cholesky.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, ctypes.c_int64,
    ]
    try:
        lib.cl_multilevel_bisect.restype = ctypes.c_int
        lib.cl_multilevel_bisect.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p, i64p, ctypes.c_uint64,
        ]
    except AttributeError:  # pragma: no cover - a library without the sym
        pass
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _adj_to_csr(adj: List[Set[int]]):
    n = len(adj)
    ptr = np.zeros(n + 1, dtype=np.int64)
    for v in range(n):
        ptr[v + 1] = ptr[v] + len(adj[v])
    idx = np.empty(ptr[-1], dtype=np.int64)
    for v in range(n):
        idx[ptr[v]:ptr[v + 1]] = sorted(adj[v])
    return ptr, idx


def _p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def min_degree_ordering_native(adj: List[Set[int]]) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n = len(adj)
    ptr, idx = _adj_to_csr(adj)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.cl_min_degree_order(n, _p(ptr), _p(idx), _p(perm))
    return perm if rc == 0 else None


def multilevel_bisect_native(adj: List[Set[int]], weights,
                             seed: int = 1) -> Optional[np.ndarray]:
    """METIS-style multilevel bisection with vertex separator (heavy-edge
    matching coarsening + FM refinement + greedy weighted vertex cover).
    Returns side[v] in {0 left, 1 right, 2 separator}, or None when the
    native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "cl_multilevel_bisect"):
        return None
    n = len(adj)
    ptr, idx = _adj_to_csr(adj)
    wt = np.ascontiguousarray(weights, dtype=np.int64)
    side = np.empty(n, dtype=np.int64)
    rc = lib.cl_multilevel_bisect(
        n, _p(ptr), _p(idx), _p(wt), _p(side), ctypes.c_uint64(seed)
    )
    return side if rc == 0 else None


def symbolic_cholesky_native(adj: List[Set[int]], perm: np.ndarray):
    """Returns Lcols (list of sorted below-diag patterns) or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(adj)
    ptr, idx = _adj_to_csr(adj)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    cap = max(16, 4 * len(idx) + 8 * n)
    for _ in range(8):
        lp = np.zeros(n + 1, dtype=np.int64)
        li = np.zeros(cap, dtype=np.int64)
        nnz = lib.cl_symbolic_cholesky(
            n, _p(ptr), _p(idx), _p(perm), _p(lp), _p(li), cap
        )
        if nnz >= 0:
            return [
                li[lp[j]:lp[j + 1]].tolist() for j in range(n)
            ]
        cap *= 4
    return None
