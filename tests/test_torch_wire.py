"""The port's columnar wire format against the JAX package's, byte for byte.

The same columns encode to equal bytes in both packages (and to the JAX
package's golden fixture); each package decodes the other's bodies to the
same arrays; ``decode_batch`` gives the same raw columns for the same
features; malformed bodies raise ``WireFormatError`` with the same
message and the same data-quality kind in both.
"""

import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu.serving import wire as jwire  # noqa: E402
from transmogrifai_tpu_torch.serving import wire  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "columnar_golden.bin")
RECORDS = [
    {"age": 34.5, "income": 1200.0, "active": True, "visits": 7,
     "city": "lisbon"},
    {"age": None, "income": -3.25, "active": False, "visits": None,
     "city": ""},
    {"age": 0.0, "income": None, "active": None, "visits": -12,
     "city": None},
    {"age": 99.9, "income": 1e6, "active": True, "visits": 40000,
     "city": "são paulo"},
]


class _Feature:
    def __init__(self, name, kind):
        self.name = name
        self.kind = kind


def _features(types_mod, spec):
    return [_Feature(n, getattr(types_mod, k)) for n, k in spec]


SPEC = [("age", "Real"), ("income", "Real"), ("active", "Binary"),
        ("visits", "Integral"), ("city", "Text")]


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _arrays_equal(a, b):
    a, b = _np(a), _np(b)
    if a.dtype == object or b.dtype == object:
        return list(a) == list(b)
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def _seeded_columns(seed=0, n=37):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) > 0.2
    words = np.array([None if rng.random() < 0.2 else
                      "".join(rng.choice(list("abcé ü"), rng.integers(0, 9)))
                      for _ in range(n)], dtype=object)
    return [("f32", wire.F32, rng.normal(size=n).astype(np.float32), mask),
            ("f64", wire.F64, rng.normal(size=n), None),
            ("i64", wire.I64, rng.integers(-2**40, 2**40, size=n), mask),
            ("flag", wire.BOOL, (rng.random(n) > 0.5).astype(np.uint8),
             ~mask),
            ("text", wire.UTF8, list(words),
             np.array([w is not None for w in words]))], n


def test_codes_and_constants_are_the_jax_packages():
    for name in ("CONTENT_TYPE", "MAGIC", "VERSION", "F32", "F64", "I64",
                 "BOOL", "UTF8", "MAX_ROWS", "MAX_FEATURES"):
        assert getattr(wire, name) == getattr(jwire, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_columns_encode_to_equal_bytes(seed):
    cols, n = _seeded_columns(seed)
    assert wire.encode_arrays(cols, n) == jwire.encode_arrays(cols, n)


def test_records_encode_to_the_golden_bytes_in_both_packages():
    golden = open(GOLDEN, "rb").read()
    assert wire.encode_records(RECORDS) == golden
    assert jwire.encode_records(RECORDS) == golden
    pinned = {"age": wire.F32, "visits": wire.F64}
    assert wire.encode_records(RECORDS, pinned) == \
        jwire.encode_records(RECORDS, pinned)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_decodes_the_others_bodies(direction):
    cols, n = _seeded_columns(3)
    enc, dec = ((jwire, wire) if direction == "jax_to_port"
                else (wire, jwire))
    body = enc.encode_arrays(cols, n)
    got_n, got = dec.decode_columns(body)
    want_n, want = enc.decode_columns(body)
    assert got_n == want_n == n and list(got) == list(want)
    for name in want:
        gc, gv, gm = got[name]
        wc, wv, wm = want[name]
        assert gc == wc
        assert _arrays_equal(gv, wv), name
        assert (gm is None) == (wm is None)
        if gm is not None:
            np.testing.assert_array_equal(gm, wm)


def test_decode_batch_gives_the_jax_packages_raw_columns():
    import transmogrifai_tpu.types as JT
    import transmogrifai_tpu_torch.types as PT
    spec = SPEC + [("score", "RealNN"), ("when", "Date"), ("tag", "PickList"),
                   ("missing", "Real"), ("missing_nn", "RealNN")]
    records = [dict(r, score=float(i), when=1_700_000_000 + i,
                    tag=["a", None, "b", ""][i]) for i, r in
               enumerate(RECORDS)]
    body = wire.encode_records(records)
    got = wire.decode_batch(body, _features(PT, spec))
    want = jwire.decode_batch(body, _features(JT, spec))
    assert len(got) == len(want) == len(records)
    for name, _ in spec:
        g, w = got[name], want[name]
        assert g.kind.__name__ == w.kind.__name__
        assert _arrays_equal(g.values, w.values), name
        assert (g.mask is None) == (w.mask is None), name
        if g.mask is not None:
            np.testing.assert_array_equal(g.mask, w.mask)
        assert isinstance(g.values, np.ndarray)   # host columns


def test_result_arrays_and_responses_are_the_jax_packages():
    import transmogrifai_tpu.columns as JC
    import transmogrifai_tpu_torch.columns as PC
    from transmogrifai_tpu.types import Prediction
    rng = np.random.default_rng(5)
    n = 9
    prob = rng.random((n, 2)).astype(np.float32)
    raw = rng.normal(size=(n, 2)).astype(np.float32)
    pred = (prob[:, 1] > 0.5).astype(np.float32)
    port = PC.ColumnBatch({"p": PC.prediction_column(
        torch.as_tensor(pred), torch.as_tensor(prob),
        torch.as_tensor(raw))}, n, device="cpu")
    jax_b = JC.ColumnBatch({"p": JC.Column(Prediction, {
        "prediction": pred, "probability": prob, "rawPrediction": raw})}, n)
    got = wire.result_arrays(port, ["p"], 7)
    want = jwire.result_arrays(jax_b, ["p"], 7)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        assert got[k][1] is None and want[k][1] is None
    both = wire.concat_result_arrays([got, got])
    assert wire.encode_result_arrays(both, 14) == \
        jwire.encode_result_arrays(jwire.concat_result_arrays([want, want]),
                                   14)
    body = wire.encode_result_arrays(got, 7)
    dec, jdec = wire.decode_response(body), jwire.decode_response(body)
    assert list(dec) == list(jdec)
    for k in dec:
        np.testing.assert_array_equal(dec[k][0], jdec[k][0])


def _corrupt_utf8_offsets():
    body = bytearray(wire.encode_records([{"t": "ab"}, {"t": "cd"}]))
    off = len(body) - 4 - 3 * 4
    struct.pack_into("<I", body, off + 4, 3)
    struct.pack_into("<I", body, off + 8, 1)
    return bytes(body)


def _unknown_dtype():
    body = bytearray(wire.encode_records([{"x": 1.0}]))
    body[18 + len("x")] = 99
    return bytes(body)


MALFORMED = {
    "empty": b"",
    "short": b"TMGC\x01\x00",
    "bad_magic": b"XXXX" + wire.encode_records(RECORDS)[4:],
    "bad_version": wire.encode_records(RECORDS)[:4] + b"\x09\x00"
    + wire.encode_records(RECORDS)[6:],
    "flags": wire.encode_records(RECORDS)[:6] + b"\x01\x00"
    + wire.encode_records(RECORDS)[8:],
    "too_many_rows": struct.pack("<4sHHII", b"TMGC", 1, 0, 10**9, 0),
    "too_many_features": struct.pack("<4sHHII", b"TMGC", 1, 0, 1, 10**6),
    "truncated_payload": wire.encode_records(RECORDS)[:-3],
    "truncated_header": wire.encode_records(RECORDS)[:12],
    "unknown_dtype": _unknown_dtype(),
    "utf8_offsets": _corrupt_utf8_offsets(),
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_bodies_raise_the_same_wire_errors(name):
    body = MALFORMED[name]
    with pytest.raises(wire.WireFormatError) as got:
        wire.decode_columns(body)
    with pytest.raises(jwire.WireFormatError) as want:
        jwire.decode_columns(body)
    assert str(got.value) == str(want.value)
    assert got.value.violation_kind == want.value.violation_kind


TYPED = {
    "text_as_number": ([{"age": "old"}], "TypeMismatch"),
    "number_as_text": ([{"city": 3.5}], "TypeMismatch"),
    "bool_bytes": (None, "NonCoercibleValue"),
    "absent_non_nullable": ([{"score": None}, {"score": 1.0}],
                            "MissingRequiredField"),
    "binary_not_bool": ([{"active": 1.5}], "TypeMismatch"),
}


@pytest.mark.parametrize("name", list(TYPED))
def test_typed_decode_errors_carry_the_jax_violation_kinds(name):
    import transmogrifai_tpu.types as JT
    import transmogrifai_tpu_torch.types as PT
    records, kind = TYPED[name]
    spec = SPEC + [("score", "RealNN")]
    if records is None:
        body = bytearray(wire.encode_arrays(
            [("active", wire.BOOL, np.array([1, 0], np.uint8), None)], 2))
        body[-2] = 7                       # a bool byte outside {0, 1}
        body = bytes(body)
    else:
        body = wire.encode_records(records)
    with pytest.raises(wire.WireFormatError) as got:
        wire.decode_batch(body, _features(PT, spec))
    with pytest.raises(jwire.WireFormatError) as want:
        jwire.decode_batch(body, _features(JT, spec))
    assert str(got.value) == str(want.value)
    assert got.value.violation_kind == want.value.violation_kind == kind


def test_a_map_feature_is_refused_as_the_jax_package_refuses_it():
    import transmogrifai_tpu.types as JT
    import transmogrifai_tpu_torch.types as PT
    body = wire.encode_records([{"m": 1.0}])
    spec = [("m", "RealMap")]
    with pytest.raises(wire.WireFormatError) as got:
        wire.decode_batch(body, _features(PT, spec))
    with pytest.raises(jwire.WireFormatError) as want:
        jwire.decode_batch(body, _features(JT, spec))
    assert str(got.value) == str(want.value)
