"""Model bundles on disk — the port's copy of the bundle half of
``transmogrifai_tpu/checkpoint.py`` (:50-380).

A bundle is a directory of files (``op-model.json``, ``params.npz`` and any
files another build put there) plus a ``MANIFEST.json`` holding the format
version and a SHA-256 digest of every file.  ``atomic_bundle_write`` stages
the files in a temp sibling directory, digests and fsyncs them and renames
the directory into place, so a crash mid-save never leaves a torn bundle;
``verify_bundle`` checks the version and digests on load and names the
offending file; ``find_latest_valid`` lets a loader pointed at a checkpoint
root take its newest bundle that verifies.

The format is the JAX package's, so bundles move both ways between the two
packages.  ``SweepCheckpoint`` (JAX :383-510) is the resumable record of a
selector sweep: one such bundle holding ``sweep.json`` (each completed
candidate family's grid scores under a content signature that is equal in
both packages) and ``sweep.npz`` (its fitted arrays), so a sweep written by
either package resumes in the other.  ``Workflow.train(resume_from=)``
makes one and hands it down to the validator; the JAX package's ambient
stack (``use_sweep_checkpoint``, JAX :518-540) is not ported.
``preemption_guard`` and ``shutdown_requested`` (JAX :545-639) turn
SIGTERM / SIGINT into a cooperative stop flag, which the validator polls at
each candidate family's boundary (``TrainingPreempted``) and the server's
``serve_main`` polls to drain before it exits.  The flag is the one global
here, as signals are per process.  A ``checkpoint.save`` fault injected at
the commit of a bundle (key: the bundle's directory name) leaves the old
bundle in place, as in the JAX package.  Not ported: the telemetry spans
around save and load.  Failures the JAX package records into its ambient
log go into the ``FailureLog`` the caller passes (``log``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .resilience import (FailureLog, InjectedFault, maybe_inject,
                         record_failure)

MANIFEST_NAME = "MANIFEST.json"
# version 2: the manifest digests the whole tree recursively (relative POSIX
# paths as keys); version-1 bundles stay readable
BUNDLE_FORMAT_VERSION = 2
_VERSION_DIR_PREFIX = "ckpt-"


class CheckpointError(RuntimeError):
    """Base of all bundle integrity errors."""


class CorruptModelError(CheckpointError):
    """A bundle failed verification: ``file`` names the offending file ("" for
    the whole bundle), ``reason`` the failure."""

    def __init__(self, path: str, file: str = "", reason: str = ""):
        self.path = str(path)
        self.file = str(file)
        self.reason = str(reason)
        at = f"{self.path}/{self.file}" if self.file else self.path
        super().__init__(f"corrupt model bundle: {at}: "
                         f"{self.reason or 'integrity check failed'}")


class ModelVersionError(CheckpointError):
    """A bundle's format version is outside what this build reads."""

    def __init__(self, path: str, found: Any,
                 supported: int = BUNDLE_FORMAT_VERSION):
        self.path = str(path)
        self.found = found
        self.supported = supported
        super().__init__(
            f"model bundle {self.path}: format version {found!r} is not "
            f"readable by this build (supports 1..{supported}); "
            f"re-save the model with a matching version")


class TrainingPreempted(RuntimeError):
    """``train()`` stopped at a candidate family's boundary after a
    preemption signal or an injected preemption (≙ JAX :97-110).
    ``resume_from`` names the sweep checkpoint to pass back to
    ``train(resume_from=...)``; ``failure_log`` is the train's log and
    ``sweep_checkpoint`` its ``SweepCheckpoint`` (with its ``flushes``)."""

    def __init__(self, message: str, resume_from: Optional[str] = None):
        self.resume_from = resume_from
        # set by Workflow.train on the way out
        self.failure_log = None
        self.sweep_checkpoint = None
        if resume_from:
            message = f"{message} (resume with resume_from={resume_from!r})"
        super().__init__(message)


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            b = fh.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fsync_path(path: str) -> None:
    """fsync a file or directory; a platform that refuses directory fds is
    passed over."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_json_atomic(path: str, payload: Dict[str, Any]) -> None:
    """Durable small-file write: temp sibling, fsync, rename."""
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=2, default=str)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_path(os.path.dirname(os.path.abspath(path)))


def write_manifest(dirpath: str, extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Digest every file under ``dirpath`` (recursively) into its
    ``MANIFEST.json``, keyed by POSIX-style relative path."""
    files: Dict[str, Dict[str, Any]] = {}
    for root, dirs, names in os.walk(dirpath):
        dirs.sort()
        rel_root = os.path.relpath(root, dirpath)
        for name in sorted(names):
            rel = name if rel_root == "." else f"{rel_root}/{name}"
            rel = rel.replace(os.sep, "/")
            p = os.path.join(root, name)
            if rel == MANIFEST_NAME or not os.path.isfile(p):
                continue
            files[rel] = {"sha256": _sha256_file(p),
                          "bytes": os.path.getsize(p)}
    manifest: Dict[str, Any] = {"formatVersion": BUNDLE_FORMAT_VERSION,
                                "createdAt": time.time(), "files": files}
    if extra:
        manifest.update(extra)
    with open(os.path.join(dirpath, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh, indent=2)
        fh.flush()
        os.fsync(fh.fileno())
    return manifest


@contextmanager
def atomic_bundle_write(path: str, overwrite: bool = True,
                        manifest_extra: Optional[Dict[str, Any]] = None):
    """Yield a temp sibling directory for the caller to fill; on a clean
    exit write the manifest, fsync everything and rename the directory over
    ``path`` (an old bundle there is swapped out and removed only after the
    new one is in place).  On any failure the temp directory is removed and
    ``path`` is left as it was.  ``overwrite=False`` raises
    ``FileExistsError`` on a non-empty ``path``."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    if not overwrite and os.path.isdir(path) and os.listdir(path):
        raise FileExistsError(
            f"model directory {path!r} is not empty; pass overwrite=True "
            "to replace it")
    tmp = os.path.join(
        parent,
        f".{os.path.basename(path)}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        yield tmp
        maybe_inject("checkpoint.save", key=os.path.basename(path))
        write_manifest(tmp, extra=manifest_extra)
        for root, _dirs, names in os.walk(tmp, topdown=False):
            for name in names:
                _fsync_path(os.path.join(root, name))
            _fsync_path(root)
        if os.path.lexists(path):
            old = f"{tmp}.old"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
        _fsync_path(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The bundle's manifest, or None for a legacy bundle without one."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as fh:
            return json.load(fh)
    except (OSError, ValueError) as e:
        raise CorruptModelError(path, MANIFEST_NAME,
                                f"unreadable manifest ({e})") from e


def verify_bundle(path: str) -> Optional[Dict[str, Any]]:
    """Check a bundle's format version and every listed file's digest.

    Returns the manifest (None for a legacy bundle); raises
    ``ModelVersionError`` on version skew and ``CorruptModelError`` naming
    the first missing or mismatched file.  Files the manifest does not list
    are not read."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"model bundle directory {path!r} does not exist")
    manifest = read_manifest(path)
    if manifest is None:
        return None
    version = manifest.get("formatVersion")
    if not isinstance(version, int) \
            or not 1 <= version <= BUNDLE_FORMAT_VERSION:
        raise ModelVersionError(path, version)
    for name, info in (manifest.get("files") or {}).items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise CorruptModelError(
                path, name, "listed in MANIFEST but missing on disk")
        digest = _sha256_file(fpath)
        if digest != info.get("sha256"):
            raise CorruptModelError(
                path, name, f"SHA-256 mismatch (manifest "
                f"{str(info.get('sha256'))[:12]}…, disk {digest[:12]}…)")
    return manifest


def is_bundle_dir(path: str) -> bool:
    """Does ``path`` look like one bundle (rather than a checkpoint root)?"""
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, MANIFEST_NAME))
        or os.path.exists(os.path.join(path, "op-model.json")))


def _bundle_sort_key(path: str) -> float:
    try:
        m = read_manifest(path)
        if m and isinstance(m.get("createdAt"), (int, float)):
            return float(m["createdAt"])
    except CheckpointError:
        pass
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def find_latest_valid(root: str, log: Optional[FailureLog] = None) -> str:
    """The newest bundle under ``root`` that verifies.  Each candidate that
    fails is recorded in ``log`` (action "skipped") and passed over; raises
    ``CorruptModelError`` when none verifies."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"checkpoint root {root!r} does not exist")
    candidates = [os.path.join(root, n) for n in os.listdir(root)
                  if is_bundle_dir(os.path.join(root, n))]
    if not candidates:
        raise FileNotFoundError(
            f"model directory {root!r} contains neither a model bundle "
            f"(no op-model.json / {MANIFEST_NAME}) nor any checkpoint "
            "sub-directories")
    for cand in sorted(candidates, key=_bundle_sort_key, reverse=True):
        try:
            verify_bundle(cand)
            return cand
        except (CheckpointError, FileNotFoundError) as e:
            record_failure(log, "checkpoint", "skipped", e,
                           point="checkpoint.load", bundle=cand)
    raise CorruptModelError(
        root, "", f"no valid checkpoint under root (tried "
        f"{len(candidates)} candidate(s); see failure log for causes)")


def bundle_version(path: str) -> str:
    """A bundle's identity: its directory name and the manifest's createdAt
    when there is one (``ckpt-000002@1722800000``)."""
    base = os.path.basename(os.path.normpath(path))
    try:
        m = read_manifest(path)
    except CheckpointError:
        m = None
    created = (m or {}).get("createdAt")
    if isinstance(created, (int, float)):
        return f"{base}@{int(created)}"
    return base


def next_version_dir(root: str) -> str:
    """The next ``ckpt-NNNNNN`` directory under a checkpoint root."""
    os.makedirs(root, exist_ok=True)
    ids = []
    for n in os.listdir(root):
        if n.startswith(_VERSION_DIR_PREFIX):
            try:
                ids.append(int(n[len(_VERSION_DIR_PREFIX):]))
            except ValueError:
                pass
    return os.path.join(root,
                        f"{_VERSION_DIR_PREFIX}{max(ids, default=0) + 1:06d}")


def prune_versions(root: str, keep: int) -> List[str]:
    """Remove the oldest version directories beyond ``keep``; returns the
    removed paths."""
    if keep < 1:
        raise ValueError("keep must be >= 1")
    versions = sorted(
        (os.path.join(root, n) for n in os.listdir(root)
         if n.startswith(_VERSION_DIR_PREFIX)
         and os.path.isdir(os.path.join(root, n))),
        key=_bundle_sort_key, reverse=True)
    removed = []
    for path in versions[keep:]:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


# --------------------------------------------------------------------------
# resumable selector sweeps
# --------------------------------------------------------------------------

SWEEP_JSON = "sweep.json"
SWEEP_NPZ = "sweep.npz"


def _host_copies(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """``tensors`` as numpy arrays, with one device-to-host copy for each
    (device, dtype) group: the group is flattened into one tensor on its
    device, copied back and split."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        host = flat.cpu().numpy()
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = host[at:at + n].reshape(tuple(tensors[i].shape))
            at += n
    return out


class SweepCheckpoint:
    """Durable record of the completed candidate families of a selector
    sweep (≙ ``SweepCheckpoint``, JAX :383-515).

    One bundle directory (atomic and digested like a model bundle) holding
    ``sweep.json``, each family's grid scores keyed by its content signature
    (model name, candidate index, grid, racing configuration), and
    ``sweep.npz``, the fitted arrays of an unraced family's (fold x grid)
    block under ``{sig}/f{f}/g{g}/{key}``.  A family whose signature is
    present is complete: a resumed sweep replays its scores instead of
    fitting it again."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._candidates: Dict[str, Dict[str, Any]] = {}
        self._arrays: Dict[str, np.ndarray] = {}
        self.winner: Optional[Dict[str, Any]] = None
        # wall seconds and sweep.npz bytes of each flush, in order
        self.flushes: List[Dict[str, float]] = []
        if os.path.isdir(self.path) and \
                os.path.exists(os.path.join(self.path, SWEEP_JSON)):
            self._load()

    @staticmethod
    def candidate_signature(model_name: str, candidate_index: int,
                            grid: Sequence[Dict[str, Any]],
                            racing: Optional[Dict[str, Any]] = None) -> str:
        """The JAX package's content hash (JAX :409-424), so a signature is
        the same string in both packages: a result replays only when the
        model, its position, its whole grid and the sweep's racing
        configuration are unchanged."""
        payload = json.dumps(
            {"model": model_name, "index": int(candidate_index),
             "grid": [dict(sorted(g.items())) for g in grid],
             "racing": dict(sorted((racing or {}).items()))},
            sort_keys=True, default=str)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def _load(self) -> None:
        verify_bundle(self.path)
        with open(os.path.join(self.path, SWEEP_JSON)) as fh:
            data = json.load(fh)
        self._candidates = dict(data.get("candidates") or {})
        self.winner = data.get("winner")
        npz = os.path.join(self.path, SWEEP_NPZ)
        if os.path.exists(npz):
            with np.load(npz, allow_pickle=False) as z:
                self._arrays = dict(z)

    def flush(self) -> None:
        """Atomically rewrite the whole sweep bundle."""
        t0 = time.perf_counter()
        with atomic_bundle_write(self.path, overwrite=True,
                                 manifest_extra={"kind": "selector-sweep"}
                                 ) as tmp:
            with open(os.path.join(tmp, SWEEP_JSON), "w") as fh:
                json.dump({"formatVersion": BUNDLE_FORMAT_VERSION,
                           "candidates": self._candidates,
                           "winner": self.winner}, fh, indent=2, default=str)
            np.savez_compressed(os.path.join(tmp, SWEEP_NPZ), **self._arrays)
            npz_bytes = os.path.getsize(os.path.join(tmp, SWEEP_NPZ))
        self.flushes.append({"seconds": time.perf_counter() - t0,
                             "npzBytes": npz_bytes})

    def __contains__(self, sig: str) -> bool:
        return sig in self._candidates

    def __len__(self) -> int:
        return len(self._candidates)

    def results_for(self, sig: str) -> Optional[List[Dict[str, Any]]]:
        entry = self._candidates.get(sig)
        return None if entry is None else list(entry.get("results") or [])

    def record_candidate(self, sig: str, model_name: str,
                         candidate_index: int,
                         results: Sequence[Dict[str, Any]],
                         fitted_grid: Optional[Sequence[Sequence[Any]]] = None
                         ) -> None:
        """Add a completed family: ``results`` is its per-grid-point score
        list ``[{"params", "metricValues", "racedOut"}]``; its (fold x grid)
        fitted state, when given, splits into JSON values and npz arrays as
        a stage's state does (JAX :452-486), the device tensors copied back
        together (``_host_copies``)."""
        from .stages.serialization import _is_array, _json_safe

        entry: Dict[str, Any] = {
            "modelName": model_name, "candidateIndex": int(candidate_index),
            "results": [dict(r) for r in results]}
        if fitted_grid is not None:
            keys: List[str] = []
            tensors: List[torch.Tensor] = []
            fitted_json: List[List[Optional[Dict[str, Any]]]] = []
            for f, row in enumerate(fitted_grid):
                jrow: List[Optional[Dict[str, Any]]] = []
                for g, fitted in enumerate(row):
                    if not isinstance(fitted, dict):
                        jrow.append(None)
                        continue
                    cell: Dict[str, Any] = {}
                    for k, v in fitted.items():
                        key = f"{sig}/f{f}/g{g}/{k}"
                        if isinstance(v, torch.Tensor):
                            keys.append(key)
                            tensors.append(v)
                        elif _is_array(v):
                            self._arrays[key] = np.asarray(v)
                        else:
                            cell[k] = _json_safe(v, None)
                    jrow.append(cell)
                fitted_json.append(jrow)
            self._arrays.update(zip(keys, _host_copies(tensors)))
            entry["fittedJson"] = fitted_json
        self._candidates[sig] = entry

    def fitted_grid(self, sig: str) -> Optional[List[List[Any]]]:
        """A completed family's (fold x grid) fitted state, arrays on the
        host."""
        entry = self._candidates.get(sig)
        if entry is None or "fittedJson" not in entry:
            return None
        out: List[List[Any]] = []
        for f, jrow in enumerate(entry["fittedJson"]):
            row: List[Any] = []
            for g, cell in enumerate(jrow):
                if cell is None:
                    row.append(None)
                    continue
                fitted = dict(cell)
                prefix = f"{sig}/f{f}/g{g}/"
                for k, v in self._arrays.items():
                    if k.startswith(prefix):
                        fitted[k[len(prefix):]] = v
                row.append(fitted)
            out.append(row)
        return out

    def set_winner(self, model_name: str, params: Dict[str, Any],
                   metric: float) -> None:
        """Seal the sweep with its winner and flush."""
        self.winner = {"modelName": model_name, "params": dict(params),
                       "metric": float(metric)}
        self.flush()


# --------------------------------------------------------------------------
# preemption-aware shutdown
# --------------------------------------------------------------------------

class PreemptionGuard:
    """Cooperative stop flag set by SIGTERM / SIGINT or an injected
    preemption; loops poll ``shutdown_requested()`` at their boundaries
    and wind down instead of dying mid-write.  The request is recorded
    "preempted" in ``log``."""

    def __init__(self, stage: str = "train",
                 log: Optional[FailureLog] = None):
        self.stage = stage
        self.log = log
        self.stop_requested = False
        self.reason = ""

    def request_stop(self, reason: Any) -> None:
        if not self.stop_requested:
            self.stop_requested = True
            self.reason = str(reason)
            record_failure(self.log, self.stage, "preempted", reason,
                           point="preemption")


_GUARD: Optional[PreemptionGuard] = None
_GUARD_DEPTH = 0
_GUARD_LOCK = threading.Lock()
_PREV_HANDLERS: Dict[int, Any] = {}


def _signal_handler(signum, frame):  # pragma: no cover — exercised via kill
    guard = _GUARD
    if guard is None:
        return
    if guard.stop_requested:
        raise KeyboardInterrupt(
            f"second signal {signum} during graceful shutdown")
    guard.request_stop(f"signal {signum}")


@contextmanager
def preemption_guard(stage: str = "train",
                     signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT),
                     log: Optional[FailureLog] = None):
    """Install the SIGTERM / SIGINT → graceful-stop handler for the dynamic
    extent (≙ checkpoint.py:584).  Re-entrant: nested guards share one flag
    and only the outermost installs and restores the handlers.  Off the
    main thread, where Python forbids ``signal.signal``, the guard still
    answers injected preemptions and records "degraded" in ``log``."""
    global _GUARD, _GUARD_DEPTH
    with _GUARD_LOCK:
        _GUARD_DEPTH += 1
        if _GUARD is None:
            _GUARD = PreemptionGuard(stage, log)
            try:
                for s in signals:
                    _PREV_HANDLERS[s] = signal.signal(s, _signal_handler)
            except ValueError as e:   # not the main thread
                record_failure(log, stage, "degraded", e,
                               point="preemption.install",
                               fallback="injection-only preemption checks")
        guard = _GUARD
    try:
        yield guard
    finally:
        with _GUARD_LOCK:
            _GUARD_DEPTH -= 1
            if _GUARD_DEPTH == 0:
                for s, h in _PREV_HANDLERS.items():
                    try:
                        signal.signal(s, h)
                    except (ValueError, OSError):
                        pass
                _PREV_HANDLERS.clear()
                _GUARD = None


def shutdown_requested(key: Any = None) -> bool:
    """Has a graceful stop been requested, by a signal or by the
    ``preemption`` injection point at ``key``?"""
    guard = _GUARD
    if guard is not None and guard.stop_requested:
        return True
    try:
        maybe_inject("preemption", key=key)
    except InjectedFault as e:
        if guard is not None:
            guard.request_stop(e)
        return True
    return False
