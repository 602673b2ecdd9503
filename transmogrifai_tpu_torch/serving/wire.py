"""Packed columnar wire format for the scoring endpoint (port of
``transmogrifai_tpu/serving/wire.py``, the whole module; the bytes are the
JAX package's, so either package decodes the other's bodies).

``Content-Type: application/x-transmogrifai-columnar`` — a little-endian
binary body carrying one contiguous array per feature, so the server builds
its raw ``ColumnBatch`` with one ``np.frombuffer`` view per feature instead
of decoding a JSON dict per record.  JSON remains the compatibility path;
this format is opt-in per request.

Layout (all integers little-endian)::

    header   (16 bytes)
      0   4   magic               b"TMGC"
      4   2   version    u16      1
      6   2   flags      u16      reserved, must be 0
      8   4   n_rows     u32
      12  4   n_features u32
    then n_features descriptors, each:
      0   2   name_len   u16
      2   -   name       utf-8 (name_len bytes)
      +0  1   dtype      u8       1=f32  2=f64  3=i64  4=bool(u8)  5=utf8
      +1  1   col_flags  u8       bit0: a presence bitmap follows the values
      +2  4   payload_nbytes u32  bytes of the VALUES payload
    then the payload section: per feature, in descriptor order,
      - values payload, starting at the next 8-byte boundary
        (numeric: n_rows * itemsize; utf8: (n_rows+1) u32 offsets + blob),
      - if col_flags bit0: ceil(n_rows/8) presence-bitmap bytes
        (``np.packbits(..., bitorder="little")`` — bit i set = row i present).

Decode semantics mirror ``columns.numeric_column`` / ``text_column``
exactly (NaN/0/False at absent rows, empty string → None, non-nullable
kinds reject absent rows) so the columnar and JSON paths produce
bitwise-identical scores.  ``decode_batch`` gives host numpy columns: the
score program uploads each numeric column once, and ``result_arrays``
copies each device result back with one ``.cpu()`` per array.

Every malformed input raises :class:`WireFormatError`; the HTTP layer maps
it to a structured 400.  A worker never crashes on a bad body.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..columns import Column, ColumnBatch, column_from_values, host_array
from ..stages.generator import non_nullable_empty_value
from ..types import (Binary, Date, DateTime, Integral, Prediction,
                     is_numeric_kind, is_text_kind)

CONTENT_TYPE = "application/x-transmogrifai-columnar"

MAGIC = b"TMGC"
VERSION = 1

F32, F64, I64, BOOL, UTF8 = 1, 2, 3, 4, 5
_NUMERIC_DTYPES = {F32: np.dtype("<f4"), F64: np.dtype("<f8"),
                   I64: np.dtype("<i8"), BOOL: np.dtype("u1")}
_CODE_NAMES = {F32: "f32", F64: "f64", I64: "i64", BOOL: "bool",
               UTF8: "utf8"}

_HEADER = struct.Struct("<4sHHII")
_DESC_TAIL = struct.Struct("<BBI")

# hard ceilings so a malformed header cannot make the server allocate
# unbounded memory before validation fails
MAX_ROWS = 16_000_000
MAX_FEATURES = 10_000
_MAX_NAME = 4096


class WireFormatError(ValueError):
    """The columnar body is malformed or unsupported (HTTP 400).

    ``violation_kind`` carries the data-quality taxonomy kind
    (quality.py) when the decoder could classify the problem — structural
    corruption (truncated body, bad magic) stays unclassified."""

    violation_kind: Optional[str] = None


def _typed_wire_error(message: str, kind: str) -> WireFormatError:
    err = WireFormatError(message)
    err.violation_kind = kind
    return err


def _align8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def _utf8_payload(values: Sequence) -> bytes:
    """Object array of str|None → u32 offsets (n+1) + utf-8 blob.  ``None``
    encodes as a zero-length entry; presence is the mask's job."""
    chunks: List[bytes] = []
    offsets = np.zeros(len(values) + 1, dtype="<u4")
    pos = 0
    for i, v in enumerate(values):
        b = b"" if v is None else str(v).encode("utf-8")
        chunks.append(b)
        pos += len(b)
        offsets[i + 1] = pos
    return offsets.tobytes() + b"".join(chunks)


def encode_arrays(columns: Sequence[Tuple[str, int, Any, Optional[Any]]],
                  n_rows: int) -> bytes:
    """Low-level encoder: ``columns`` is an ordered sequence of
    ``(name, dtype_code, values, mask_or_None)``.  Numeric values may be
    any array-like; they are cast to the wire dtype.  UTF8 values are a
    sequence of ``str | None``."""
    n_rows = int(n_rows)
    parts: List[bytes] = []
    descs: List[bytes] = []
    payloads: List[Tuple[bytes, Optional[bytes]]] = []
    for name, code, values, mask in columns:
        name_b = str(name).encode("utf-8")
        if code == UTF8:
            vals = list(values)
            if len(vals) != n_rows:
                raise WireFormatError(
                    f"column {name!r} has {len(vals)} rows, header says "
                    f"{n_rows}")
            payload = _utf8_payload(vals)
        elif code in _NUMERIC_DTYPES:
            arr = np.asarray(values)
            if arr.shape != (n_rows,):
                raise WireFormatError(
                    f"column {name!r} has shape {arr.shape}, want "
                    f"({n_rows},)")
            payload = np.ascontiguousarray(
                arr.astype(_NUMERIC_DTYPES[code], copy=False)).tobytes()
        else:
            raise WireFormatError(f"unknown dtype code {code} for {name!r}")
        mask_b: Optional[bytes] = None
        if mask is not None:
            m = np.asarray(mask, dtype=bool)
            if m.shape != (n_rows,):
                raise WireFormatError(
                    f"mask for {name!r} has shape {m.shape}, want "
                    f"({n_rows},)")
            mask_b = np.packbits(m, bitorder="little").tobytes()
        descs.append(struct.pack("<H", len(name_b)) + name_b
                     + _DESC_TAIL.pack(code, 1 if mask_b is not None else 0,
                                       len(payload)))
        payloads.append((payload, mask_b))
    parts.append(_HEADER.pack(MAGIC, VERSION, 0, n_rows, len(payloads)))
    parts.extend(descs)
    pos = sum(len(p) for p in parts)
    for payload, mask_b in payloads:
        pad = _align8(pos) - pos
        parts.append(b"\x00" * pad)
        pos += pad
        parts.append(payload)
        pos += len(payload)
        if mask_b is not None:
            parts.append(mask_b)
            pos += len(mask_b)
    return b"".join(parts)


def _infer_code(values: Sequence) -> int:
    present = [v for v in values if v is not None]
    if any(isinstance(v, str) for v in present):
        return UTF8
    if present and all(isinstance(v, bool) for v in present):
        return BOOL
    if present and all(isinstance(v, int) for v in present):
        return I64
    return F64


def encode_records(records: Sequence[Dict[str, Any]],
                   codes: Optional[Dict[str, int]] = None) -> bytes:
    """Client-side convenience: the JSON-records shape, packed columnar.
    Column order is first-appearance order across records; dtypes are
    inferred (str → utf8, bool → bool, int → i64, else f64) unless pinned
    via ``codes``.  Absent keys ride the presence bitmap."""
    names: List[str] = []
    for r in records:
        for k in r:
            if k not in names:
                names.append(k)
    cols = []
    for name in names:
        vals = [r.get(name) for r in records]
        code = (codes or {}).get(name) or _infer_code(vals)
        mask = np.array([v is not None for v in vals], dtype=bool)
        if code == UTF8:
            cols.append((name, UTF8, vals, mask))
        elif code == BOOL:
            arr = np.array([bool(v) if v is not None else False
                            for v in vals], dtype=np.uint8)
            cols.append((name, BOOL, arr, mask))
        elif code == I64:
            arr = np.array([int(v) if v is not None else 0 for v in vals],
                           dtype=np.int64)
            cols.append((name, I64, arr, mask))
        else:
            arr = np.array([float(v) if v is not None else 0.0
                            for v in vals], dtype=np.float64)
            cols.append((name, code, arr, mask))
    return encode_arrays(cols, len(records))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_columns(body: bytes
                   ) -> Tuple[int, "Dict[str, Tuple[int, Any, Optional[np.ndarray]]]"]:
    """Parse a columnar body → ``(n_rows, {name: (code, values, mask)})``.

    Numeric values are read-only ``np.frombuffer`` views over ``body`` (the
    zero-copy hot path); utf8 columns decode to object arrays of
    ``str | None`` (mask-aware).  Raises :class:`WireFormatError` on any
    structural problem — never anything else."""
    try:
        return _decode_columns(body)
    except WireFormatError:
        raise
    except (struct.error, ValueError, OverflowError, IndexError,
            UnicodeDecodeError) as e:
        raise WireFormatError(f"truncated or corrupt columnar body: {e}") \
            from e


def _decode_columns(body: bytes):
    if len(body) < _HEADER.size:
        raise WireFormatError(
            f"body of {len(body)} bytes is shorter than the {_HEADER.size}"
            "-byte header")
    magic, version, flags, n_rows, n_features = _HEADER.unpack_from(body, 0)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise WireFormatError(f"unsupported wire version {version} "
                              f"(this server speaks {VERSION})")
    if flags != 0:
        raise WireFormatError(f"reserved header flags set: {flags:#x}")
    if n_rows > MAX_ROWS:
        raise WireFormatError(f"n_rows {n_rows} exceeds the {MAX_ROWS} cap")
    if n_features > MAX_FEATURES:
        raise WireFormatError(
            f"n_features {n_features} exceeds the {MAX_FEATURES} cap")
    pos = _HEADER.size
    descs: List[Tuple[str, int, int, int]] = []
    for _ in range(n_features):
        if pos + 2 > len(body):
            raise WireFormatError("descriptor table runs past the body")
        (name_len,) = struct.unpack_from("<H", body, pos)
        pos += 2
        if name_len > _MAX_NAME or pos + name_len + _DESC_TAIL.size > len(body):
            raise WireFormatError("feature name runs past the body")
        name = body[pos:pos + name_len].decode("utf-8")
        pos += name_len
        code, col_flags, nbytes = _DESC_TAIL.unpack_from(body, pos)
        pos += _DESC_TAIL.size
        if code not in (F32, F64, I64, BOOL, UTF8):
            raise WireFormatError(f"unknown dtype code {code} for {name!r}")
        if col_flags & ~1:
            raise WireFormatError(
                f"reserved column flags set for {name!r}: {col_flags:#x}")
        descs.append((name, code, col_flags, nbytes))
    mask_nbytes = (n_rows + 7) // 8
    out: Dict[str, Tuple[int, Any, Optional[np.ndarray]]] = {}
    for name, code, col_flags, nbytes in descs:
        pos = _align8(pos)
        end = pos + nbytes + (mask_nbytes if col_flags & 1 else 0)
        if end > len(body):
            raise WireFormatError(
                f"payload of {name!r} runs past the body "
                f"({end} > {len(body)})")
        if code == UTF8:
            off_nbytes = (n_rows + 1) * 4
            if nbytes < off_nbytes:
                raise WireFormatError(
                    f"utf8 column {name!r}: payload {nbytes}B cannot hold "
                    f"{n_rows + 1} u32 offsets")
            offsets = np.frombuffer(body, dtype="<u4", count=n_rows + 1,
                                    offset=pos)
            blob = body[pos + off_nbytes:pos + nbytes]
            if offsets[0] != 0 or np.any(np.diff(offsets.astype(np.int64))
                                         < 0) or offsets[-1] > len(blob):
                raise WireFormatError(
                    f"utf8 column {name!r}: offsets are not monotonically "
                    "increasing within the blob")
            values: Any = np.empty(n_rows, dtype=object)
            for i in range(n_rows):
                lo, hi = int(offsets[i]), int(offsets[i + 1])
                values[i] = (blob[lo:hi].decode("utf-8")
                             if hi > lo else None)
        else:
            dt = _NUMERIC_DTYPES[code]
            if nbytes != n_rows * dt.itemsize:
                raise WireFormatError(
                    f"column {name!r}: payload {nbytes}B != n_rows "
                    f"{n_rows} * {dt.itemsize}B ({_CODE_NAMES[code]})")
            values = np.frombuffer(body, dtype=dt, count=n_rows, offset=pos)
        mask: Optional[np.ndarray] = None
        if col_flags & 1:
            mask_buf = np.frombuffer(body, dtype=np.uint8, count=mask_nbytes,
                                     offset=pos + nbytes)
            mask = np.unpackbits(mask_buf, count=n_rows,
                                 bitorder="little").astype(bool)
        pos = end
        out[name] = (code, values, mask)
    return int(n_rows), out


def _numeric_cast(name, code, values, target: np.dtype, kind) -> np.ndarray:
    """Cast a wire array to the column storage dtype with exactly python's
    ``float()``/``int()``/``bool()`` coercion semantics (the JSON path)."""
    if code == UTF8:
        raise _typed_wire_error(
            f"column {name!r} is utf8 but feature kind {kind.__name__} "
            "is numeric", "TypeMismatch")
    if code == BOOL and np.any(values > 1):
        raise _typed_wire_error(
            f"bool column {name!r} carries bytes outside {{0, 1}}",
            "NonCoercibleValue")
    if values.dtype == target:
        return values
    with np.errstate(over="ignore"):
        # hostile i64 payloads may overflow the f64 cast to ±inf; the
        # non-finite seam guard downstream owns that verdict, not a warning
        return values.astype(target)


def decode_batch(body: bytes, raw_features: Sequence) -> ColumnBatch:
    """Columnar body → the raw ``ColumnBatch`` the engine scores, with the
    stage-0 semantics of ``records_to_batch`` (NaN/0/False at absent rows,
    monoid zero for non-nullable kinds missing from the wire, empty string
    → None) so the two request paths are bitwise parity-testable.

    Wire columns are keyed by RAW FEATURE NAME and carry already-extracted
    values — custom ``extract_fn`` hooks do not run on this path (the
    client did the extraction when it built the arrays)."""
    n_rows, cols = decode_columns(body)
    out: Dict[str, Column] = {}
    for f in raw_features:
        kind = f.kind
        wire = cols.get(f.name)
        if wire is None:
            # absent from the wire = absent from every record: nullable
            # kinds are all-None, non-nullable kinds take the monoid zero
            # (exactly extract_column over empty records)
            fill = (non_nullable_empty_value(kind)
                    if kind.non_nullable else None)
            out[f.name] = column_from_values(kind, [fill] * n_rows)
            continue
        code, values, mask = wire
        if is_text_kind(kind):
            if code != UTF8:
                raise _typed_wire_error(
                    f"column {f.name!r} is {_CODE_NAMES[code]} but feature "
                    f"kind {kind.__name__} is text", "TypeMismatch")
            vals = values
            if mask is not None and not mask.all():
                vals = values.copy()
                vals[~mask] = None
            out[f.name] = Column(kind, vals)
            continue
        if not is_numeric_kind(kind):
            raise WireFormatError(
                f"feature {f.name!r} of kind {kind.__name__} is not "
                "representable in columnar v1; use the JSON path")
        if issubclass(kind, (Date, DateTime)) or issubclass(kind, Integral):
            arr = _numeric_cast(f.name, code, values, np.dtype(np.int64),
                                kind)
            absent_fill: Any = 0
        elif issubclass(kind, Binary):
            if code != BOOL:
                raise _typed_wire_error(
                    f"column {f.name!r} is {_CODE_NAMES[code]} but "
                    f"{kind.__name__} wants bool (code {BOOL})",
                    "TypeMismatch")
            arr = _numeric_cast(f.name, code, values, np.dtype(np.bool_),
                                kind)
            absent_fill = False
        else:
            arr = _numeric_cast(f.name, code, values, np.dtype(np.float32),
                                kind)
            absent_fill = np.nan
        if kind.non_nullable:
            if mask is not None and not mask.all():
                bad = int((~mask).sum())
                raise _typed_wire_error(
                    f"{kind.__name__} column {f.name!r} has {bad} empty "
                    "values", "MissingRequiredField")
            out[f.name] = Column(kind, arr, mask=None)
            continue
        if mask is None:
            mask = np.ones(n_rows, dtype=bool)
        if not mask.all():
            arr = arr.copy()
            arr[~mask] = absent_fill
        out[f.name] = Column(kind, arr, mask=mask)
    return ColumnBatch(out, n_rows)


# --------------------------------------------------------------------------
# responses
# --------------------------------------------------------------------------

def result_arrays(scored: ColumnBatch, names: Sequence[str], n: int
                  ) -> "Dict[str, Tuple[Any, Optional[np.ndarray]]]":
    """Flatten the scored result columns to wire-encodable host arrays for
    the first ``n`` (un-padded) rows, one copy from the device per array.
    Prediction columns flatten to ``<name>.prediction`` /
    ``<name>.probability_<j>`` / ``<name>.rawPrediction_<j>`` f64 columns —
    the same keys the JSON result rows carry, dot-joined."""
    out: Dict[str, Tuple[Any, Optional[np.ndarray]]] = {}
    for name in names:
        if name not in scored:
            continue
        col = scored[name]
        if col.kind is Prediction or isinstance(col.values, dict):
            out[f"{name}.prediction"] = (
                host_array(col.values["prediction"][:n]).astype(np.float64),
                None)
            for base in ("probability", "rawPrediction"):
                if base in col.values:
                    block = host_array(col.values[base][:n])
                    for j in range(block.shape[1]):
                        out[f"{name}.{base}_{j}"] = (
                            block[:, j].astype(np.float64), None)
        elif col.is_host_object():
            out[name] = (np.asarray(col.values)[:n], None)
        else:
            mask = (None if col.mask is None
                    else host_array(col.mask[:n]).astype(bool))
            out[name] = (host_array(col.values[:n]).astype(np.float64),
                         mask)
    return out


def concat_result_arrays(chunks: "List[Dict[str, Tuple[Any, Optional[np.ndarray]]]]"
                         ) -> "Dict[str, Tuple[Any, Optional[np.ndarray]]]":
    """Concatenate per-chunk result arrays (the batcher splits oversized
    columnar requests into ladder-sized device dispatches)."""
    if len(chunks) == 1:
        return chunks[0]
    out: Dict[str, Tuple[Any, Optional[np.ndarray]]] = {}
    for name in chunks[0]:
        vals = np.concatenate([c[name][0] for c in chunks])
        masks = [c[name][1] for c in chunks]
        mask = (None if any(m is None for m in masks)
                else np.concatenate(masks))
        out[name] = (vals, mask)
    return out


def encode_result_arrays(arrays: "Dict[str, Tuple[Any, Optional[np.ndarray]]]",
                         n_rows: int) -> bytes:
    """Result arrays → columnar response body (f64 for numerics, utf8 for
    host-object columns)."""
    cols = []
    for name, (vals, mask) in arrays.items():
        arr = np.asarray(vals)
        if arr.dtype == object:
            cols.append((name, UTF8, arr,
                         np.array([v is not None for v in arr], dtype=bool)))
        else:
            cols.append((name, F64, arr.astype(np.float64), mask))
    return encode_arrays(cols, n_rows)


def decode_response(body: bytes
                    ) -> "Dict[str, Tuple[Any, Optional[np.ndarray]]]":
    """Client-side: columnar response body → ``{name: (values, mask)}``."""
    _n, cols = decode_columns(body)
    return {name: (values, mask) for name, (code, values, mask)
            in cols.items()}
