"""The data-quality schema contract: typed violations, per-record quarantine
and non-finite guards (port of ``transmogrifai_tpu/quality.py``).

* ``RawSchema`` — each raw feature's ``FieldSchema`` (kind, nullable,
  response, a numeric range hint from the training batch), saved in every
  bundle as ``schema.json`` (format version 1, the JAX package's) under the
  manifest's digests, and re-derived from the raw features for a bundle
  without one (``for_model``).
* The violation kinds (``MissingRequiredField`` / ``TypeMismatch`` /
  ``NonCoercibleValue`` / ``NonFiniteValue`` / ``UnknownField``) under a
  ``strict | coerce | quarantine | off`` policy
  (``TRANSMOGRIFAI_QUALITY_POLICY``, default ``coerce``): ``coerce``
  rejects only what an unscreened record would have crashed or poisoned a
  score with.
* ``RecordQualityError`` (HTTP 422 at the server) carries a rejected
  record's violations; ``DataQualityError`` stops ingestion past
  ``maxQuarantineFraction``.
* The non-finite guards: ``finite_row_mask`` (``torch.isfinite`` on a
  tensor, ``np.isfinite`` on a host array), ``batch_nonfinite_rows`` (the
  host columns about to be uploaded), ``result_nonfinite_fields`` and
  ``mask_nonfinite_result_arrays`` (scores on their way out).

Unlike the JAX package nothing here is ambient: ``screen_records`` and
``screen_batch`` take the ``QualityConfig`` (no config, no screening), the
``FailureLog`` and the ``MetricsRegistry`` they report into.
``Workflow.train`` runs ``screen_batch`` on its input batch, with the
config its ``parameters["quality"]`` resolves to and the train's log, as
the JAX package's train does (JAX workflow.py:271-289); the training-time
sanitizers are ``sanitizer.py`` (``Workflow.with_sanitizers``).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from .resilience import FailureLog, record_failure
from .types import (Binary, FeatureType, OPList, OPVector,
                    feature_type_from_name, is_map_kind, is_numeric_kind,
                    is_text_kind, map_value_kind)

SCHEMA_JSON = "schema.json"
SCHEMA_FORMAT_VERSION = 1

MISSING_REQUIRED_FIELD = "MissingRequiredField"
TYPE_MISMATCH = "TypeMismatch"
NON_COERCIBLE_VALUE = "NonCoercibleValue"
NON_FINITE_VALUE = "NonFiniteValue"
UNKNOWN_FIELD = "UnknownField"

VIOLATION_KINDS = (MISSING_REQUIRED_FIELD, TYPE_MISMATCH,
                   NON_COERCIBLE_VALUE, NON_FINITE_VALUE, UNKNOWN_FIELD)

# what an unscreened record would have crashed on or poisoned a score with:
# rejected under every policy
FATAL_KINDS = frozenset({NON_COERCIBLE_VALUE, NON_FINITE_VALUE})

POLICIES = ("strict", "coerce", "quarantine", "off")
DEFAULT_POLICY = "coerce"


@dataclass
class Violation:
    """One typed violation of a field (and, in a batch, of a row)."""
    kind: str
    field: str
    message: str
    row: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "field": self.field,
                             "message": self.message}
        if self.row is not None:
            d["row"] = int(self.row)
        return d


class RecordQualityError(ValueError):
    """A record (or rows of a columnar request) failed the contract; the
    server answers 422 with the violations."""

    def __init__(self, violations: Sequence[Violation],
                 policy: str = DEFAULT_POLICY):
        self.violations = list(violations)
        self.policy = policy
        head = self.violations[0] if self.violations else None
        desc = (f"{head.kind} on field {head.field!r}: {head.message}"
                if head else "schema validation failed")
        more = len(self.violations) - 1
        super().__init__(desc + (f" (+{more} more violation(s))"
                                 if more > 0 else ""))

    def to_json(self) -> List[Dict[str, Any]]:
        return [v.to_json() for v in self.violations]


class DataQualityError(RuntimeError):
    """Ingestion stopped: the quarantined fraction passed
    ``maxQuarantineFraction``."""

    def __init__(self, quarantined: int, total: int, limit: float,
                 sample: Optional[Sequence[Violation]] = None):
        self.quarantined = int(quarantined)
        self.total = int(total)
        self.fraction = (float(quarantined) / total) if total else 1.0
        self.limit = float(limit)
        self.sample = list(sample or [])
        detail = "; ".join(f"{v.kind}({v.field})" for v in self.sample[:5])
        super().__init__(
            f"{quarantined}/{total} rows ({self.fraction:.1%}) quarantined "
            f"by the data-quality firewall — exceeds maxQuarantineFraction="
            f"{limit:g}" + (f"; sample: {detail}" if detail else ""))


@dataclass
class QualityConfig:
    """The resolved quality settings of one run."""
    policy: str = DEFAULT_POLICY
    max_quarantine_fraction: float = 0.1
    enabled: bool = True

    @staticmethod
    def resolve(params: Optional[Dict[str, Any]] = None) -> "QualityConfig":
        """The environment's defaults (``TRANSMOGRIFAI_QUALITY_POLICY``,
        ``TRANSMOGRIFAI_MAX_QUARANTINE_FRACTION``,
        ``TRANSMOGRIFAI_QUALITY``) under an explicit params dict
        (camelCase keys)."""
        p = dict(params or {})
        policy = p.get("policy", os.environ.get(
            "TRANSMOGRIFAI_QUALITY_POLICY", DEFAULT_POLICY))
        if policy not in POLICIES:
            raise ValueError(f"unknown quality policy {policy!r}; expected "
                             f"one of {POLICIES}")
        frac = p.get("maxQuarantineFraction")
        if frac is None:
            frac = float(os.environ.get(
                "TRANSMOGRIFAI_MAX_QUARANTINE_FRACTION", "0.1"))
        enabled = p.get("enabled")
        if enabled is None:
            enabled = os.environ.get("TRANSMOGRIFAI_QUALITY", "1") != "0"
        return QualityConfig(policy=policy,
                             max_quarantine_fraction=float(frac),
                             enabled=bool(enabled) and policy != "off")


# -- the schema contract ----------------------------------------------------

@dataclass
class FieldSchema:
    """One raw feature's contract.  The range hint is observability, not a
    rejection rule."""
    name: str
    kind: Type[FeatureType]
    nullable: bool = True
    is_response: bool = False
    range: Optional[Tuple[float, float]] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "kind": self.kind.__name__,
                             "nullable": bool(self.nullable),
                             "isResponse": bool(self.is_response)}
        if self.range is not None:
            d["range"] = [float(self.range[0]), float(self.range[1])]
        return d


def _is_number(v: Any) -> bool:
    return (isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool))


def _finite(v: Any) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError, OverflowError):
        return False


def _numeric_range(feature, col) -> Optional[Tuple[float, float]]:
    """The finite (min, max) of a numeric column, as
    ``filters.numeric_ranges`` gives it, reduced where the column lies (a
    host array through a tensor, no float64 copy of a float column) with
    only the count and the two ends read back.  Object columns go through
    ``numeric_ranges``."""
    if not isinstance(col.values, (torch.Tensor, np.ndarray)) \
            or col.is_host_object():
        from .filters import numeric_ranges
        return numeric_ranges(feature, col).get(None)
    vals = torch.as_tensor(col.values).contiguous()  # one pass on a view
    if not vals.is_floating_point():      # as numeric_ranges: in float64
        vals = vals.to(torch.float64)
    keep = torch.isfinite(vals)
    if col.mask is not None:
        keep &= torch.as_tensor(col.mask).to(vals.device, torch.bool)
    kept = int(keep.sum())
    if not kept:
        return None
    lo, hi = torch.aminmax(vals if kept == vals.numel() else vals[keep])
    return tuple(torch.stack([lo, hi]).tolist())


class RawSchema:
    """A bundle's data contract: every raw feature's ``FieldSchema``."""

    def __init__(self, fields: Dict[str, FieldSchema]):
        self.fields = dict(fields)

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def __len__(self) -> int:
        return len(self.fields)

    @staticmethod
    def derive(raw_features: Sequence, batch=None) -> "RawSchema":
        """Features → contract; with the training ``batch``, each numeric
        field's range hint is the finite (min, max) of its column
        (``filters.numeric_ranges``), reduced where the column lies."""
        fields: Dict[str, FieldSchema] = {}
        for f in raw_features:
            rng = None
            if batch is not None and is_numeric_kind(f.kind) \
                    and f.name in batch:
                rng = _numeric_range(f, batch[f.name])
            fields[f.name] = FieldSchema(
                name=f.name, kind=f.kind, nullable=not f.kind.non_nullable,
                is_response=bool(getattr(f, "is_response", False)),
                range=rng)
        return RawSchema(fields)

    def to_json(self) -> Dict[str, Any]:
        return {"formatVersion": SCHEMA_FORMAT_VERSION,
                "fields": [fs.to_json() for fs in self.fields.values()]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "RawSchema":
        fields: Dict[str, FieldSchema] = {}
        for fd in d.get("fields") or []:
            try:
                kind = feature_type_from_name(fd["kind"])
            except (KeyError, ValueError):
                continue    # a kind this build doesn't know: skip the field
            rng = fd.get("range")
            fields[fd["name"]] = FieldSchema(
                name=fd["name"], kind=kind,
                nullable=bool(fd.get("nullable", True)),
                is_response=bool(fd.get("isResponse", False)),
                range=tuple(rng) if rng else None)
        return RawSchema(fields)

    def save(self, bundle_dir: str) -> None:
        with open(os.path.join(bundle_dir, SCHEMA_JSON), "w") as fh:
            json.dump(self.to_json(), fh, indent=2)

    @staticmethod
    def load(bundle_dir: str) -> Optional["RawSchema"]:
        path = os.path.join(bundle_dir, SCHEMA_JSON)
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            return RawSchema.from_json(json.load(fh))

    @staticmethod
    def for_model(model, bundle_path: Optional[str] = None,
                  log: Optional[FailureLog] = None,
                  raw_features: Optional[Sequence] = None) -> "RawSchema":
        """The bundle's ``schema.json`` when present and readable, else a
        contract re-derived from ``raw_features`` (default: the model's;
        an unreadable file is recorded "degraded" in ``log``)."""
        if bundle_path:
            try:
                sch = RawSchema.load(bundle_path)
                if sch is not None and len(sch):
                    return sch
            except Exception as e:  # noqa: BLE001 — a corrupt schema.json
                #                     degrades to a re-derived contract
                record_failure(log, "serving", "degraded", e,
                               point="serving.quality", bundle=bundle_path,
                               detail="unreadable schema.json; contract "
                                      "re-derived from raw features")
        return RawSchema.derive(model.raw_features if raw_features is None
                                else raw_features)

    # -- record validation ---------------------------------------------------
    def validate_record(self, record: Dict[str, Any]
                        ) -> Tuple[Dict[str, Any], List[Violation]]:
        """``(record, violations)``: the record coerced where possible — a
        NEW dict only when a coercion changed something, so a clean record
        passes through as the same object.  Never raises."""
        violations: List[Violation] = []
        out = record
        changed = False

        def coerce(name: str, value: Any) -> None:
            nonlocal out, changed
            if not changed:
                out = dict(record)
                changed = True
            out[name] = value

        for name, fs in self.fields.items():
            present = name in record
            val = record.get(name)
            if isinstance(val, FeatureType):
                val = val.value
            if val is None:
                # an explicit null in a non-nullable predictor; an absent
                # one takes the monoid zero (unlabelled scoring)
                if not fs.nullable and not fs.is_response and present:
                    violations.append(Violation(
                        MISSING_REQUIRED_FIELD, name,
                        f"null value for non-nullable {fs.kind.__name__}"))
                continue
            kind = fs.kind
            if is_numeric_kind(kind):
                self._check_numeric(name, kind, val, violations, coerce)
            elif is_text_kind(kind):
                if not isinstance(val, str):
                    violations.append(Violation(
                        TYPE_MISMATCH, name,
                        f"{type(val).__name__} where {kind.__name__} "
                        "expects a string"))
                    coerce(name, str(val))
            elif is_map_kind(kind):
                if not isinstance(val, dict):
                    violations.append(Violation(
                        NON_COERCIBLE_VALUE, name,
                        f"{type(val).__name__} where {kind.__name__} "
                        "expects an object"))
                elif is_numeric_kind(map_value_kind(kind)):
                    for k, mv in val.items():
                        if mv is None or isinstance(mv, bool):
                            continue        # BinaryMap values
                        if not _is_number(mv):
                            violations.append(Violation(
                                NON_COERCIBLE_VALUE, f"{name}.{k}",
                                f"{type(mv).__name__} where "
                                f"{kind.__name__} expects numeric values"))
                        elif not _finite(mv):
                            violations.append(Violation(
                                NON_FINITE_VALUE, f"{name}.{k}",
                                f"non-finite value {mv!r}"))
            elif issubclass(kind, (OPVector, OPList)):
                if isinstance(val, (list, tuple, np.ndarray)):
                    items = (val.tolist() if isinstance(val, np.ndarray)
                             else val)
                    if issubclass(kind, OPVector) and any(
                            _is_number(x) and not _finite(x) for x in items):
                        violations.append(Violation(
                            NON_FINITE_VALUE, name,
                            "non-finite element in vector"))
                else:
                    violations.append(Violation(
                        NON_COERCIBLE_VALUE, name,
                        f"{type(val).__name__} where {kind.__name__} "
                        "expects a list"))
        for name in record:
            if name not in self.fields and name != "key":
                violations.append(Violation(
                    UNKNOWN_FIELD, name,
                    "field is not in the model's raw schema"))
        return out, violations

    @staticmethod
    def _check_numeric(name, kind, val, violations, coerce) -> None:
        if isinstance(val, bool) or _is_number(val):
            if not _finite(val):
                violations.append(Violation(
                    NON_FINITE_VALUE, name, f"non-finite value {val!r}"))
            return
        if isinstance(val, str):
            violations.append(Violation(
                TYPE_MISMATCH, name,
                f"str where {kind.__name__} expects a number"))
            if issubclass(kind, Binary):
                # only unambiguous spellings coerce to a boolean
                low = val.strip().lower()
                if low in ("true", "1"):
                    coerce(name, True)
                elif low in ("false", "0", ""):
                    coerce(name, False)
                else:
                    violations.append(Violation(
                        NON_COERCIBLE_VALUE, name,
                        f"{val[:40]!r} is not a boolean"))
                return
            try:
                parsed = float(val)
            except (TypeError, ValueError):
                violations.append(Violation(
                    NON_COERCIBLE_VALUE, name,
                    f"{val[:40]!r} does not parse as a number"))
                return
            if not math.isfinite(parsed):
                violations.append(Violation(
                    NON_FINITE_VALUE, name,
                    f"{val!r} parses to a non-finite number"))
                return
            coerce(name, parsed)
            return
        violations.append(Violation(
            NON_COERCIBLE_VALUE, name,
            f"{type(val).__name__} where {kind.__name__} expects a number"))

    @staticmethod
    def rejects(violations: Sequence[Violation], policy: str) -> bool:
        """``strict`` rejects any violation, ``quarantine`` any but
        ``UnknownField``, ``coerce`` only the fatal kinds, ``off``
        nothing."""
        if not violations or policy == "off":
            return False
        if policy == "strict":
            return True
        if policy == "quarantine":
            return any(v.kind != UNKNOWN_FIELD for v in violations)
        return any(v.kind in FATAL_KINDS for v in violations)

    def screen_record(self, record: Dict[str, Any], policy: str
                      ) -> Tuple[Dict[str, Any], List[Violation], bool]:
        """``(record, violations, rejected)`` in one call."""
        out, violations = self.validate_record(record)
        return out, violations, self.rejects(violations, policy)


# -- the non-finite guards --------------------------------------------------

def finite_row_mask(values, mask=None):
    """Per-row all-finite reduction, absent cells counted as fine (numeric
    columns hold NaN where absent): ``torch.isfinite`` on a tensor, on its
    device; ``np.isfinite`` on a host array."""
    if isinstance(values, torch.Tensor):
        ok = torch.isfinite(values)
        if mask is not None:
            m = torch.as_tensor(mask, dtype=torch.bool, device=values.device)
            ok = ok | ~m.reshape(m.shape + (1,) * (ok.dim() - 1))
        return ok if ok.dim() == 1 else ok.reshape(ok.shape[0], -1).all(1)
    ok = np.isfinite(np.asarray(values))
    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        ok = ok | ~m.reshape(m.shape + (1,) * (ok.ndim - 1))
    return ok if ok.ndim == 1 else np.all(ok.reshape(ok.shape[0], -1), axis=1)


def batch_nonfinite_rows(batch, schema: Optional[RawSchema] = None
                         ) -> Dict[int, List[Violation]]:
    """Row → violations for non-finite values at present positions of the
    float host columns of a raw ``ColumnBatch``: what is about to be
    uploaded to the device.

    Columns that are strided views of one C-contiguous 2-D array (``X[:, j]``
    of a row-major matrix) are first checked together by one pass over that
    array: where it is all finite, none of its columns needs a pass of its
    own, each of which would read every cache line of the array again."""
    out: Dict[int, List[Violation]] = {}
    finite_base: Dict[int, bool] = {}
    for name, col in batch.items():
        vals = getattr(col, "values", None)
        if not isinstance(vals, np.ndarray) or \
                not np.issubdtype(vals.dtype, np.floating):
            continue
        if schema is not None and name in schema.fields and \
                not is_numeric_kind(schema.fields[name].kind) and \
                not issubclass(schema.fields[name].kind, OPVector):
            continue
        base = vals.base
        if vals.ndim == 1 and isinstance(base, np.ndarray) and \
                base.ndim == 2 and base.flags.c_contiguous and \
                base.dtype == vals.dtype and base.shape[0] == len(vals):
            if id(base) not in finite_base:
                finite_base[id(base)] = bool(np.isfinite(base).all())
            if finite_base[id(base)]:
                continue
        ok = finite_row_mask(vals, getattr(col, "mask", None))
        for i in np.nonzero(~np.asarray(ok))[0]:
            out.setdefault(int(i), []).append(Violation(
                NON_FINITE_VALUE, name, "non-finite value in column",
                row=int(i)))
    return out


def result_nonfinite_fields(result: Dict[str, Any]) -> List[str]:
    """Field paths of non-finite floats in one scored result row."""
    bad: List[str] = []
    for name, v in result.items():
        if isinstance(v, dict):
            bad.extend(f"{name}.{k}" for k, sub in v.items()
                       if _is_number(sub) and not _finite(sub))
        elif _is_number(v) and not _finite(v):
            bad.append(name)
    return bad


def mask_nonfinite_result_arrays(arrays: Dict[str, Any]
                                 ) -> Tuple[Dict[str, Any], np.ndarray]:
    """Mask non-finite cells of ``{name: (values, mask)}`` result arrays as
    absent (the value set to 0).  Returns ``(arrays, bad_row_mask)``; the
    arrays change only where something was non-finite."""
    bad_rows: Optional[np.ndarray] = None
    out = dict(arrays)
    n = 0
    for name, (vals, mask) in arrays.items():
        arr = np.asarray(vals)
        n = max(n, arr.shape[0] if arr.ndim else 0)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        ok = np.asarray(finite_row_mask(arr, mask))
        if ok.all():
            continue
        new_mask = (np.ones(arr.shape[0], dtype=bool) if mask is None
                    else np.asarray(mask, dtype=bool).copy())
        new_mask &= ok
        out[name] = (np.where(np.isfinite(arr), arr, 0.0)
                     if arr.ndim == 1 else arr, new_mask)
        bad_rows = ~ok if bad_rows is None else (bad_rows | ~ok)
    if bad_rows is None:
        bad_rows = np.zeros(n, dtype=bool)
    return out, bad_rows


# -- ingestion-side quarantine ----------------------------------------------

def _count(registry, violations: Sequence[Violation], quarantined: int = 0
           ) -> None:
    if registry is None:
        return
    for v in violations:
        registry.counter(f"quality.violations_{v.kind}_total").inc()
    if violations:
        registry.counter("quality.violations_total").inc(len(violations))
    if quarantined:
        registry.counter("quality.rows_quarantined_total").inc(quarantined)


def screen_records(records: List[Dict[str, Any]], raw_features: Sequence,
                   cfg: Optional[QualityConfig] = None, *,
                   stage: str = "reader",
                   schema: Optional[RawSchema] = None,
                   log: Optional[FailureLog] = None,
                   registry=None) -> List[Dict[str, Any]]:
    """Per-record quarantine of an ingestion list: survivors come back
    (coerced where the policy allows), rejected records are counted and
    recorded "quarantined", and ``DataQualityError`` is raised past
    ``max_quarantine_fraction``.  With no ``cfg`` the list comes back as
    given."""
    if cfg is None or not cfg.enabled or not records:
        return records
    sch = schema or RawSchema.derive(raw_features)
    kept: List[Dict[str, Any]] = []
    sample: List[Violation] = []
    quarantined = 0
    for rec in records:
        out, violations, rejected = sch.screen_record(rec, cfg.policy)
        _count(registry, violations)
        if rejected:
            quarantined += 1
            if len(sample) < 8:
                sample.extend(violations[:2])
            record_failure(log, stage, "quarantined",
                           RecordQualityError(violations, cfg.policy),
                           point=f"{stage}.quality",
                           violations=[v.to_json() for v in violations[:4]])
        else:
            kept.append(out)
    if quarantined:
        _count(registry, (), quarantined=quarantined)
        if quarantined / len(records) > cfg.max_quarantine_fraction:
            raise DataQualityError(quarantined, len(records),
                                   cfg.max_quarantine_fraction,
                                   sample=sample)
    return kept


def screen_batch(batch, raw_features: Sequence,
                 cfg: Optional[QualityConfig] = None, *,
                 stage: str = "train", schema: Optional[RawSchema] = None,
                 log: Optional[FailureLog] = None, registry=None):
    """Drop the rows of a raw ``ColumnBatch`` that carry NaN or ±inf at
    present positions of its numeric columns before anything is uploaded,
    with ``screen_records``' accounting and fraction guard.  With no
    ``cfg`` the batch comes back as given."""
    if cfg is None or not cfg.enabled or len(batch) == 0:
        return batch
    sch = schema or RawSchema.derive(raw_features)
    by_row = batch_nonfinite_rows(batch, sch)
    if not by_row:
        return batch
    n = len(batch)
    bad = sorted(by_row)
    if registry is not None:
        registry.counter("quality.nonfinite_inputs_total").inc(len(bad))
    sample = [v for i in bad[:4] for v in by_row[i][:2]]
    _count(registry, sample, quarantined=len(bad))
    record_failure(log, stage, "quarantined",
                   f"{len(bad)} row(s) with non-finite values excluded "
                   "before device transfer", point=f"{stage}.quality",
                   rows=bad[:16])
    if len(bad) / n > cfg.max_quarantine_fraction:
        raise DataQualityError(len(bad), n, cfg.max_quarantine_fraction,
                               sample=sample)
    return batch.take_rows(np.setdiff1d(np.arange(n), np.asarray(bad)))
