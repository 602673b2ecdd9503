"""Purity, serialization and NaN checks on a train (port of
``transmogrifai_tpu/sanitizer.py``; reference: ClosureUtils.checkSerializable
at OpWorkflow.scala:277-335).  All three are opt-in through
``Workflow.with_sanitizers``:

* **Purity audit** (``audit_dag_purity``): every fitted transformer is
  applied twice to the batch it sees in the DAG, and the two outputs must be
  equal bit for bit, NaN equal to NaN.  The comparison runs on the tensors'
  device (``torch.equal`` and an ``isnan`` mask) and reads back one boolean
  a column.  It catches a ``transform`` with side effects, an unseeded draw
  or a kernel that adds in a run-dependent order.
* **Serialization audit** (``audit_stage_serialization``): every stage's
  params must survive the port's ``stage_to_json``, which drops what JSON
  cannot hold.
* **NaN guard** (``nan_guard``), the port's counterpart of the JAX
  package's ``jax_debug_nans``.  PyTorch has no flag that traps the forward
  op that makes a NaN, so the guard does two things for the extent of the
  train.  (1) It hands the train ``check_stage_nans``, which each stage runs
  on the float tensors of the columns it wrote (present positions only) and
  of the fitted state it produced: one reduction a tensor and one read-back
  a stage, raising ``FloatingPointError`` (the exception ``jax_debug_nans``
  raises) that names the stage and the column or array.  The check is per
  stage, not per op: it names the stage that made the NaN, not the op.
  (2) It sets ``torch.autograd.set_detect_anomaly(True)``, which makes a NaN
  in the MLP's Adam backward raise at the op that made it, as
  ``jax_debug_nans`` does for a traced gradient, and restores the previous
  mode on exit.  NaN only, not ±inf, as ``jax_debug_nans``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .columns import ColumnBatch
from .sparse.matrix import SparseMatrix
from .stages.base import Transformer, TransformerModel


class PurityError(RuntimeError):
    """A stage's transform is not a pure function of its inputs, or its
    params do not serialize."""


# -- NaN guard ---------------------------------------------------------------

def _float_arrays(name: str, v: Any) -> Iterator[Tuple[str, Any]]:
    """(name, array) for every float tensor or numpy array in ``v`` (dicts,
    lists and sparse matrices walked)."""
    if isinstance(v, torch.Tensor):
        if v.is_floating_point():
            yield name, v
    elif isinstance(v, np.ndarray):
        if np.issubdtype(v.dtype, np.floating):
            yield name, v
    elif isinstance(v, SparseMatrix):
        yield f"{name}.values", v.values
    elif isinstance(v, dict):
        for k, x in v.items():
            yield from _float_arrays(f"{name}.{k}", x)
    elif isinstance(v, (list, tuple)):
        for i, x in enumerate(v):
            yield from _float_arrays(f"{name}[{i}]", x)


def _present(values, mask):
    """``values``' NaN cells at present positions (a column's absent cells
    hold NaN by design)."""
    if isinstance(values, torch.Tensor):
        nan = torch.isnan(values)
        if mask is not None:
            m = torch.as_tensor(mask, dtype=torch.bool, device=values.device)
            nan = nan & m.reshape(m.shape + (1,) * (nan.dim() - 1))
        return nan.any()
    nan = np.isnan(values)
    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        nan = nan & m.reshape(m.shape + (1,) * (nan.ndim - 1))
    return bool(nan.any())


def check_stage_nans(stage, batch: ColumnBatch) -> None:
    """Raise ``FloatingPointError`` when a column ``stage`` wrote into
    ``batch`` holds NaN at a present position, or a float array of its
    fitted state holds NaN.  Device reductions are read back together."""
    found: List[Tuple[str, Any]] = []
    for f in stage.output_features:
        col = batch.get(f.name)
        if col is None:
            continue
        mask = None if isinstance(col.values, dict) else col.mask
        for name, arr in _float_arrays(f"column {f.name!r}", col.values):
            found.append((name, _present(arr, mask)))
    state = dict(getattr(stage, "fitted", {}) or {})
    best = getattr(stage, "best_model", None)
    if isinstance(best, TransformerModel):
        state["best_model"] = best.fitted
    for name, arr in _float_arrays("fitted", state):
        found.append((name, _present(arr, None)))
    flags: List[Optional[bool]] = [v if isinstance(v, bool) else None
                                   for _, v in found]
    by_device = {}
    for i, (_, v) in enumerate(found):
        if not isinstance(v, bool):
            by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        read = torch.stack([found[i][1] for i in idx]).cpu().tolist()
        for i, b in zip(idx, read):
            flags[i] = bool(b)
    bad = [name for (name, _), b in zip(found, flags) if b]
    if bad:
        raise FloatingPointError(
            f"NaN made by stage {stage.operation_name} ({stage.uid}) in "
            f"{bad[0]}" + (f" and {len(bad) - 1} more" if len(bad) > 1
                           else "") + " (nan_check)")


@contextmanager
def nan_guard(enable: bool = True):
    """For the extent: autograd anomaly detection on (the previous mode is
    restored on exit), and ``check_stage_nans`` yielded for the train to
    run after each stage.  Disabled, it yields None and changes nothing."""
    if not enable:
        yield None
        return
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield check_stage_nans
    finally:
        torch.autograd.set_detect_anomaly(prev)


# -- purity ------------------------------------------------------------------

def _payload(col) -> List[Any]:
    vals = col.values
    if isinstance(vals, dict):
        out = [vals[k] for k in sorted(vals) if vals[k] is not None]
    elif isinstance(vals, SparseMatrix):
        out = [vals.values, vals.indices, vals.row_ids,
               np.asarray([vals.n_rows, vals.n_cols])]
    else:
        out = [vals]
    if getattr(col, "mask", None) is not None:
        out.append(col.mask)
    return out


def _same_host(x: np.ndarray, y: np.ndarray) -> bool:
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == object:
        def same(u, v):
            if u is v:
                return True
            if isinstance(u, float) and isinstance(v, float):
                return u == v or (u != u and v != v)
            return u == v
        return all(same(u, v) for u, v in zip(x.ravel(), y.ravel()))
    return bool(np.array_equal(x, y, equal_nan=np.issubdtype(
        x.dtype, np.floating)))


def _same_device(x: torch.Tensor, y: torch.Tensor):
    """A 0-d bool tensor on the device: equal, NaN equal to NaN."""
    if x.is_floating_point():
        return ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()
    return (x == y).all()


def _outputs_equal(a, b) -> bool:
    pa, pb = _payload(a), _payload(b)
    if len(pa) != len(pb):
        return False
    flags = []
    for x, y in zip(pa, pb):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape or x.dtype != y.dtype \
                    or x.device != y.device:
                return False
            flags.append(_same_device(x, y))
        elif not _same_host(np.asarray(x), np.asarray(y)):
            return False
    by_device = {}
    for t in flags:
        by_device.setdefault(t.device, []).append(t)
    return all(bool(torch.stack(ts).all().item())
               for ts in by_device.values())


def audit_stage_purity(stage, batch: ColumnBatch) -> None:
    """Apply ``stage.transform_batch`` twice; ``PurityError`` on any
    difference in an output column."""
    out1 = stage.transform_batch(batch)
    out2 = stage.transform_batch(batch)
    for f in stage.output_features:
        if not _outputs_equal(out1[f.name], out2[f.name]):
            raise PurityError(
                f"stage {stage.operation_name} ({stage.uid}) is impure: "
                f"output {f.name!r} differs across identical applications — "
                "a transform must be a pure function of its inputs")


def audit_dag_purity(fitted_dag, batch: ColumnBatch) -> int:
    """Audit every fitted transformer in DAG order, each on the batch it
    sees there; returns the number of stages audited."""
    n = 0
    for layer in fitted_dag:
        for st in layer:
            if isinstance(st, Transformer):
                audit_stage_purity(st, batch)
                n += 1
        for st in layer:
            if isinstance(st, Transformer):
                batch = st.transform_batch(batch)
    return n


# -- serialization -----------------------------------------------------------

def audit_stage_serialization(stages) -> None:
    """Every stage's params must survive ``stage_to_json`` (≙
    OpWorkflow.validateStages' serializability check): a param it drops is
    state a reloaded model would lack."""
    import json

    from .stages.serialization import stage_to_json

    for st in stages:
        try:
            d = stage_to_json(st)
            json.dumps(d)
        except Exception as e:  # noqa: BLE001 — re-raised as PurityError
            raise PurityError(
                f"stage {st.operation_name} ({st.uid}) does not serialize: "
                f"{e} — stage params must be JSON-encodable "
                "(≙ ClosureUtils.checkSerializable)") from e
        saved = d.get("params", {})
        for k, v in st.params.items():
            if v is not None and saved.get(k) is None:
                raise PurityError(
                    f"stage {st.operation_name} ({st.uid}) does not "
                    f"serialize: param {k!r} (= {type(v).__name__}) is not "
                    "JSON-encodable and would be lost on save/load "
                    "(≙ ClosureUtils.checkSerializable)")
