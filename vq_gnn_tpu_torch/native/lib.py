"""ctypes bindings for the native host graph kernels (graph_ops.cpp).

A copy of ``vq_gnn_tpu/native/lib.py``.  Builds lazily via ``make`` on first
use into this directory (``libvqgnn_graph.so``, git-ignored); every entry
point has a numpy fallback in ``vq_gnn_tpu_torch/sampler`` and
``vq_gnn_tpu_torch/graph``, so the port runs without a host toolchain too.
This is host code: the device path never calls it.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libvqgnn_graph.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _SubgraphResult(ctypes.Structure):
    _fields_ = [
        ("n_fo", ctypes.c_int64),
        ("n_e", ctypes.c_int64),
        ("fo", ctypes.POINTER(ctypes.c_int64)),
        ("er", ctypes.POINTER(ctypes.c_int64)),
        ("ec", ctypes.POINTER(ctypes.c_int64)),
        ("ev", ctypes.POINTER(ctypes.c_float)),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # one build at a time: parallel test workers share this directory, and
    # a worker must not load a library another is still writing
    with open(os.path.join(_HERE, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(_SO):
                subprocess.run(
                    ["make", "-C", _HERE],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.vq_khop.restype = ctypes.POINTER(_SubgraphResult)
    lib.vq_khop.argtypes = [
        i64p, i64p, f32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int
    ]
    lib.vq_free_subgraph.argtypes = [ctypes.POINTER(_SubgraphResult)]
    lib.vq_random_walk.argtypes = [
        i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, i64p,
    ]
    lib.vq_partition.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vq_partition_ml.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vq_build_ell.argtypes = [
        i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p, i32p, f32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def khop(rowptr, col, val, num_N, batch, train_flag: bool):
    lib = _load()
    rowptr, col, batch = _i64(rowptr), _i64(col), _i64(batch)
    val = np.ascontiguousarray(val, dtype=np.float32)
    res = lib.vq_khop(
        _ptr(rowptr, ctypes.c_int64),
        _ptr(col, ctypes.c_int64),
        _ptr(val, ctypes.c_float),
        num_N,
        _ptr(batch, ctypes.c_int64),
        len(batch),
        1 if train_flag else 0,
    )
    r = res.contents
    fo = np.ctypeslib.as_array(r.fo, (r.n_fo,)).copy() if r.n_fo else np.empty(0, np.int64)
    er = np.ctypeslib.as_array(r.er, (r.n_e,)).copy() if r.n_e else np.empty(0, np.int64)
    ec = np.ctypeslib.as_array(r.ec, (r.n_e,)).copy() if r.n_e else np.empty(0, np.int64)
    ev = np.ctypeslib.as_array(r.ev, (r.n_e,)).copy() if r.n_e else np.empty(0, np.float32)
    lib.vq_free_subgraph(res)
    return fo, er, ec, ev


def random_walk(rowptr, col, starts, length, seed) -> np.ndarray:
    lib = _load()
    rowptr, col, starts = _i64(rowptr), _i64(col), _i64(starts)
    out = np.empty((len(starts), length + 1), dtype=np.int64)
    lib.vq_random_walk(
        _ptr(rowptr, ctypes.c_int64),
        _ptr(col, ctypes.c_int64),
        len(rowptr) - 1,
        _ptr(starts, ctypes.c_int64),
        len(starts),
        length,
        seed,
        _ptr(out, ctypes.c_int64),
    )
    return out


def build_ell(row, col, val, num_rows, K, S_pad):
    lib = _load()
    row, col = _i64(row), _i64(col)
    val = np.ascontiguousarray(val, dtype=np.float32)
    ell_row = np.empty(S_pad, np.int32)
    ell_col = np.empty((S_pad, K), np.int32)
    ell_val = np.empty((S_pad, K), np.float32)
    lib.vq_build_ell(
        _ptr(row, ctypes.c_int64),
        _ptr(col, ctypes.c_int64),
        _ptr(val, ctypes.c_float),
        len(row),
        num_rows,
        K,
        S_pad,
        _ptr(ell_row, ctypes.c_int32),
        _ptr(ell_col, ctypes.c_int32),
        _ptr(ell_val, ctypes.c_float),
    )
    return ell_row, ell_col, ell_val


def partition(adj, num_parts: int, method: str = "ml", seed: int = 0) -> np.ndarray:
    """cluster id per node. ``ml`` = multilevel HEM + BFS-grow + boundary
    refinement (METIS-style, the default); ``bfs`` = plain greedy BFS-grow.
    The input pattern should be symmetric (partition_graph symmetrizes)."""
    lib = _load()
    csr = adj.tocsr()
    rowptr, col = _i64(csr.indptr), _i64(csr.indices)
    out = np.empty(csr.shape[0], dtype=np.int32)
    if method == "ml":
        lib.vq_partition_ml(
            _ptr(rowptr, ctypes.c_int64),
            _ptr(col, ctypes.c_int64),
            csr.shape[0],
            num_parts,
            seed,
            _ptr(out, ctypes.c_int32),
        )
    else:
        lib.vq_partition(
            _ptr(rowptr, ctypes.c_int64),
            _ptr(col, ctypes.c_int64),
            csr.shape[0],
            num_parts,
            _ptr(out, ctypes.c_int32),
        )
    return out
