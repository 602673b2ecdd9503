"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C launch interface and compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``csrc/_build/`` (named by the source's content hash, so an edited
source rebuilds), loaded with ``ctypes``.  Nothing is compiled or loaded at
import time: the first launch of a kernel builds it, and
:func:`build_all` builds every source at once, one ``nvcc`` per source, all
running in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
KERNEL_SOURCES = ("tree_hist", "tree_hist_deep", "tree_split",
                  "tree_split_gini", "tree_route", "tree_walk", "fista_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = KERNEL_SOURCES,
              verbose: bool = False) -> Dict[str, str]:
    """Compile every missing library in parallel; returns name → path.
    Raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if verbose and out:
            print(f"[nvcc {n}]\n{out}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``<name>_launch`` typed by ``argtypes`` and returning a CUDA error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(name: str, err: int, detail: Optional[str] = None) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}"
                           + (f" ({detail})" if detail else ""))
