"""The port's loader of the host-side C++ helpers (``native/*.cpp`` at the
repository root, shared with the JAX package and built here on their own).

``textprof`` (one pass over a text column: nulls, lengths, crc32, tokens and
their FNV-1a hashes, value interning), ``fasttok`` (tokenize + hash + modulo),
``mapprof`` (columnar expansion of numeric maps) and ``locofmt`` (record
explanation payload strings) compile with ``g++``
against Python's and numpy's headers into ``native/_build/`` beside this
file, each library named by its source's content hash, and load on first use.

Unlike the JAX package's loader this one never falls back in silence: a
failed build raises, so a run that needs the helpers never turns into a
pure-Python scan without a word.  The pure-Python scans stay in the modules
that use the helpers, taken only where a caller asks for them
(``native=False``), as the tests do to hold the two against each other.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from types import ModuleType
from typing import Dict, Iterable

NATIVE_SOURCES = ("textprof", "fasttok", "mapprof", "locofmt")
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_mods: Dict[str, ModuleType] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_builds = 0      # libraries this process compiled or first loaded


def build_count() -> int:
    """How many libraries this process has compiled or loaded for the first
    time (``compiled.build_count`` sums it with its twin)."""
    return _builds


def _flags():
    import numpy as np
    return ("-O2", "-std=c++17", "-shared", "-fPIC",
            f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}")


def _lib_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f"{name}.cpp"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_flags()).encode())
    return os.path.join(BUILD_DIR, f"_{name}-{digest.hexdigest()[:16]}.so")


def _count_build() -> None:
    global _builds
    with _count_lock:
        _builds += 1


def build_all(names: Iterable[str] = NATIVE_SOURCES) -> Dict[str, str]:
    """Compile every missing helper, one ``g++`` per source, all at once;
    returns name → library path.  Raises with the compiler's output when a
    build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), *_flags(),
               os.path.join(SRC_DIR, f"{n}.cpp"), "-o", tmp]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: g++ exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
        _count_build()
    if failed:
        raise RuntimeError("native helper build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ModuleType:
    """The helper module ``_<name>`` (built on first use); raises when it
    cannot be built or loaded."""
    with _lock:
        mod = _mods.get(name)
        if mod is None:
            path = build_all([name])[name]
            spec = importlib.util.spec_from_file_location(f"_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mods[name] = mod
            _count_build()
    return mod
