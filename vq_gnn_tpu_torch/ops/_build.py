"""Build and load the hand-written CUDA kernels (``vq_gnn_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``vq_gnn_tpu_torch/_build/lib<name>-<hash>.so`` (git-ignored), loaded with
``ctypes``.  The hash covers the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited kernel is rebuilt and a built one is reused.  All missing libraries build at once,
one ``nvcc`` process per source, at the first call of any kernel wrapper.
Nothing builds at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ell_aggregate", "vq_assign", "vq_lookup", "gat_aggregate", "gat_backward",
           "segment_sum", "rev_recovery")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where CUDA is installed")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is missing, all in parallel.
    Returns {name: ptxas report} for the ones built now; raises with the
    compiler's output when one fails."""
    todo = [n for n in SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = nvcc()
    procs: List = []
    for name in todo:
        out = _lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    t0 = time.time()
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} (exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    reports["_seconds"] = f"{time.time() - t0:.1f}"
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of library ``name``, returning an int status
    (``cudaGetLastError()`` after the launch); set up once, then cached (a
    wrapper asks for it on every launch)."""
    f = _functions.get((name, symbol))
    if f is None:
        f = getattr(library(name), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _functions[name, symbol] = f
    return f


def check(rc: int, kernel: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code {rc}")
