"""The port's data-quality contract (``quality.py``) against the JAX
package's, on the same features, batches and records.

``RawSchema.derive`` gives equal ``schema.json``; a table of bad records
gets, under each of the four policies, the same coerced record, violations
(kind, field, message) and verdict; each package loads the other's
``schema.json`` (written directly and in trained bundles); the
non-finite guards and the ingestion screens agree; the policy resolves
from the same environment variables.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import transmogrifai_tpu.quality as JQ  # noqa: E402
import transmogrifai_tpu_torch.quality as Q  # noqa: E402
from test_torch_persistence import bundle_root, trained_bundle  # noqa: E402,F401

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
KINDS = [("age", "Real", False), ("score", "RealNN", False),
         ("label", "RealNN", True), ("active", "Binary", False),
         ("visits", "Integral", False), ("city", "Text", False),
         ("tag", "PickList", False), ("stats", "RealMap", False),
         ("flags", "BinaryMap", False), ("vec", "OPVector", False),
         ("words", "TextList", False)]


def _features(pkg):
    import importlib
    F = importlib.import_module(f"{pkg}.features").FeatureBuilder
    out = []
    for name, kind, response in KINDS:
        b = getattr(F, kind)(name)
        out.append(b.as_response() if response else b.as_predictor())
    return out


def _batch(pkg, n=40, seed=0):
    import importlib
    C = importlib.import_module(f"{pkg}.columns")
    T = importlib.import_module(f"{pkg}.types")
    rng = np.random.default_rng(seed)
    age = rng.normal(40, 12, n).astype(np.float32)
    age[3] = np.nan
    mask = rng.random(n) > 0.1
    cols = {"age": C.Column(T.Real, age, mask=mask),
            "score": C.Column(T.RealNN, rng.normal(size=n).astype(np.float32)),
            "label": C.Column(T.RealNN,
                              (rng.random(n) > 0.5).astype(np.float32)),
            "visits": C.Column(T.Integral, rng.integers(-5, 90, n),
                               mask=np.ones(n, bool)),
            "city": C.text_column(T.Text, ["lisbon", None, "porto", ""] * 10)}
    return C.ColumnBatch(cols, n)


def test_derive_gives_equal_schema_json(tmp_path):
    got = Q.RawSchema.derive(_features(PORT), _batch(PORT))
    want = JQ.RawSchema.derive(_features(JAX), _batch(JAX))
    assert got.to_json() == want.to_json()
    assert got.fields["age"].range is not None
    assert not got.fields["score"].nullable and got.fields["label"].is_response
    got.save(str(tmp_path))
    b1 = (tmp_path / "schema.json").read_bytes()
    want.save(str(tmp_path))
    assert (tmp_path / "schema.json").read_bytes() == b1
    assert Q.RawSchema.derive(_features(PORT)).to_json() == \
        JQ.RawSchema.derive(_features(JAX)).to_json()


def test_derive_reads_device_columns(tmp_path):
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.types import Real
    host = _batch(PORT)
    dev = ColumnBatch({"age": Column(Real, torch.as_tensor(
        host["age"].values), torch.as_tensor(host["age"].mask))}, len(host),
        device="cpu")
    feats = [f for f in _features(PORT) if f.name == "age"]
    assert Q.RawSchema.derive(feats, dev).to_json() == \
        Q.RawSchema.derive(feats, host).to_json()


@pytest.mark.parametrize("where", ["tensor", "host_array"])
@pytest.mark.parametrize("case", ["infinities", "nothing_finite"])
def test_device_ranges_equal_the_jax_package(case, where):
    """Ranges reduced on a tensor column or a host array (non-finite
    values and masked entries left out, an integer column, a column with
    no finite value) equal the JAX package's ranges on the same arrays."""
    import transmogrifai_tpu.columns as JC
    import transmogrifai_tpu.types as JT
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    host = _batch(PORT)
    age, mask = host["age"].values.copy(), host["age"].mask.copy()
    if case == "infinities":
        age[[0, 7]], age[9] = np.inf, -np.inf
        mask[1] = False
        age[1] = -1e9               # masked out: not in the range
    else:
        age[:] = np.nan
    arrays = {"age": (age, mask), "score": (host["score"].values, None),
              "visits": (host["visits"].values, host["visits"].mask)}
    kinds = dict((n, k) for n, k, _ in KINDS)
    jax_batch = JC.ColumnBatch({n: JC.Column(getattr(JT, kinds[n]), v, m)
                                for n, (v, m) in arrays.items()}, len(host))
    from transmogrifai_tpu_torch import types as T
    wrap = torch.as_tensor if where == "tensor" else np.asarray
    dev = ColumnBatch({n: Column(getattr(T, kinds[n]), wrap(v),
                                 None if m is None else wrap(m))
                       for n, (v, m) in arrays.items()}, len(host),
                      device="cpu")
    got = Q.RawSchema.derive(_features(PORT), dev).to_json()
    assert got == JQ.RawSchema.derive(_features(JAX), jax_batch).to_json()
    assert (got["fields"][0].get("range") is None) == (case ==
                                                       "nothing_finite")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_loads_the_others_schema_json(tmp_path, direction):
    src, dst = (JQ, Q) if direction == "jax_to_port" else (Q, JQ)
    pkg = JAX if src is JQ else PORT
    src.RawSchema.derive(_features(pkg), _batch(pkg)).save(str(tmp_path))
    loaded = dst.RawSchema.load(str(tmp_path))
    assert loaded.to_json() == json.loads(
        (tmp_path / "schema.json").read_text())
    assert [f.kind.__name__ for f in loaded.fields.values()] == \
        [k for _, k, _ in KINDS]


def test_an_unknown_kind_is_skipped_in_both(tmp_path):
    d = {"formatVersion": 1, "fields": [
        {"name": "a", "kind": "Real", "nullable": True, "isResponse": False},
        {"name": "b", "kind": "NoSuchKind", "nullable": True,
         "isResponse": False}]}
    assert Q.RawSchema.from_json(d).to_json() == \
        JQ.RawSchema.from_json(d).to_json()
    assert list(Q.RawSchema.from_json(d).fields) == ["a"]


@pytest.mark.parametrize("trainer", [JAX, PORT])
def test_trained_bundles_carry_a_contract_the_other_package_loads(
        bundle_root, trainer):  # noqa: F811
    from transmogrifai_tpu.workflow import WorkflowModel as JaxModel
    from transmogrifai_tpu_torch.checkpoint import verify_bundle
    from transmogrifai_tpu_torch.workflow import WorkflowModel as PortModel
    path, _ = trained_bundle(bundle_root, "dense_lr", trainer)
    assert "schema.json" in verify_bundle(path)["files"]
    on_disk = json.load(open(os.path.join(path, "schema.json")))
    port = PortModel.load(path, device="cpu")
    jax_model = JaxModel.load(path)
    assert port.raw_schema.to_json() == on_disk
    assert jax_model.raw_schema.to_json() == on_disk
    assert sorted(port.raw_schema.fields) == sorted(
        f.name for f in port.raw_features)
    assert not port.failure_log.by_action("degraded") or all(
        "schema" not in e.cause for e in port.failure_log.events)


def test_a_bundle_without_schema_json_gets_a_derived_contract(
        bundle_root, tmp_path):  # noqa: F811
    import shutil

    from transmogrifai_tpu.workflow import WorkflowModel as JaxModel
    from transmogrifai_tpu_torch.resilience import FailureLog
    from transmogrifai_tpu_torch.workflow import WorkflowModel as PortModel
    path, _ = trained_bundle(bundle_root, "dense_lr", PORT)
    p = str(tmp_path / "m")
    shutil.copytree(path, p)
    os.remove(os.path.join(p, "schema.json"))
    os.remove(os.path.join(p, "MANIFEST.json"))
    with pytest.warns(UserWarning, match="MANIFEST"):
        port = PortModel.load(p, device="cpu")
    jax_model = JaxModel.load(p)
    assert port.raw_schema.to_json() == jax_model.raw_schema.to_json()
    with open(os.path.join(p, "schema.json"), "w") as fh:
        fh.write("{not json")
    log = FailureLog()
    sch = Q.RawSchema.for_model(port, p, log)
    assert sorted(sch.fields) == sorted(port.raw_schema.fields)
    (ev,) = log.by_action("degraded")
    assert ev.point == "serving.quality"


# the bad-record table: (record, note); screened against the derived
# contract under every policy
RECORDS = {
    "clean": {"age": 31.0, "score": 0.5, "active": True, "city": "lisbon",
              "stats": {"a": 1.0}, "vec": [1.0, 2.0]},
    "explicit_null_non_nullable": {"score": None},
    "absent_non_nullable": {"age": 3.0},
    "null_response": {"label": None, "score": 1.0},
    "numeric_string_coerced": {"age": "2.5"},
    "non_coercible": {"age": "abc"},
    "nan_string": {"age": "nan"},
    "inf": {"score": float("inf")},
    "nan": {"age": float("nan")},
    "huge_literal": {"age": "1e999"},
    "binary_true": {"active": "TRUE"},
    "binary_zero": {"active": "0"},
    "binary_maybe": {"active": "maybe"},
    "binary_number": {"active": 1},
    "text_given_int": {"city": 42},
    "map_not_a_dict": {"stats": [1, 2]},
    "map_string_value": {"stats": {"a": "x", "b": 2.0}},
    "map_inf_value": {"stats": {"a": float("-inf")}},
    "binary_map_bools": {"flags": {"a": True, "b": None}},
    "vector_nan": {"vec": [1.0, float("nan")]},
    "vector_not_a_list": {"vec": 3.0},
    "list_not_a_list": {"words": "a b"},
    "dict_in_scalar": {"age": {"x": 1}},
    "unknown_field": {"age": 1.0, "zzz": 1},
    "key_is_not_unknown": {"key": "k1", "age": 1.0},
    "several": {"age": "abc", "score": float("nan"), "zzz": 0,
                "city": 1.5},
}


@pytest.mark.parametrize("policy", JQ.POLICIES)
@pytest.mark.parametrize("name", list(RECORDS))
def test_records_get_the_jax_verdict_under_each_policy(name, policy):
    rec = RECORDS[name]
    got_sch = Q.RawSchema.derive(_features(PORT))
    want_sch = JQ.RawSchema.derive(_features(JAX))
    got = got_sch.screen_record(rec, policy)
    want = want_sch.screen_record(rec, policy)
    assert [v.to_json() for v in got[1]] == [v.to_json() for v in want[1]]
    assert got[2] == want[2]
    assert (got[0] is rec) == (want[0] is rec)
    assert json.dumps(got[0], sort_keys=True, default=str) == \
        json.dumps(want[0], sort_keys=True, default=str)
    if got[2]:
        g = Q.RecordQualityError(got[1], policy)
        w = JQ.RecordQualityError(want[1], policy)
        assert str(g) == str(w) and g.to_json() == w.to_json()


def test_taxonomy_and_policies_are_the_jax_packages():
    assert Q.VIOLATION_KINDS == JQ.VIOLATION_KINDS
    assert Q.FATAL_KINDS == JQ.FATAL_KINDS
    assert Q.POLICIES == JQ.POLICIES and Q.DEFAULT_POLICY == JQ.DEFAULT_POLICY
    assert Q.SCHEMA_JSON == JQ.SCHEMA_JSON
    assert Q.SCHEMA_FORMAT_VERSION == JQ.SCHEMA_FORMAT_VERSION


@pytest.mark.parametrize("env,params", [
    ({}, None), ({"TRANSMOGRIFAI_QUALITY_POLICY": "strict"}, None),
    ({"TRANSMOGRIFAI_QUALITY_POLICY": "off"}, None),
    ({"TRANSMOGRIFAI_MAX_QUARANTINE_FRACTION": "0.3",
      "TRANSMOGRIFAI_QUALITY": "0"}, None),
    ({"TRANSMOGRIFAI_QUALITY_POLICY": "strict"},
     {"policy": "quarantine", "maxQuarantineFraction": 0.5})])
def test_config_resolves_as_the_jax_package(monkeypatch, env, params):
    for k in ("TRANSMOGRIFAI_QUALITY_POLICY",
              "TRANSMOGRIFAI_MAX_QUARANTINE_FRACTION",
              "TRANSMOGRIFAI_QUALITY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = Q.QualityConfig.resolve(params), JQ.QualityConfig.resolve(
        params)
    assert (got.policy, got.max_quarantine_fraction, bool(got.enabled)) == \
        (want.policy, want.max_quarantine_fraction, bool(want.enabled))
    monkeypatch.setenv("TRANSMOGRIFAI_QUALITY_POLICY", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        Q.QualityConfig.resolve()


def test_finite_row_mask_on_tensors_and_arrays_is_the_jax_packages():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(12, 3)).astype(np.float32)
    vals[2, 1] = np.nan
    vals[5, 0] = np.inf
    vals[7, 2] = -np.inf
    mask = np.ones(12, bool)
    mask[5] = False
    for v, m in ((vals, None), (vals, mask), (vals[:, 0], None),
                 (vals[:, 0], mask)):
        want = np.asarray(JQ.finite_row_mask(v, m))
        np.testing.assert_array_equal(Q.finite_row_mask(v, m), want)
        t = Q.finite_row_mask(torch.as_tensor(v),
                              None if m is None else torch.as_tensor(m))
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("poison", [(), ((3, 1, np.nan),),
                                    ((0, 0, np.inf), (9, 2, -np.inf),
                                     (9, 3, np.nan))])
def test_column_views_of_one_matrix_screen_as_in_the_jax_package(poison):
    """Columns that are ``X[:, j]`` views of one row-major matrix (checked
    first by one pass over the matrix) give the JAX package's rows and
    violations, absent cells passing, clean or not."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(12, 4)).astype(np.float32)
    for r, c, v in poison:
        X[r, c] = v
    mask = np.ones(12, bool)
    mask[9] = False
    got, want = {}, {}
    for pkg, mod, out in (("transmogrifai_tpu_torch", Q, got),
                          ("transmogrifai_tpu", JQ, want)):
        import importlib
        C = importlib.import_module(f"{pkg}.columns")
        T = importlib.import_module(f"{pkg}.types")
        cols = {f"f{j}": C.Column(T.Real, X[:, j],
                                  mask if j >= 2 else None)
                for j in range(4)}
        rows = mod.batch_nonfinite_rows(C.ColumnBatch(cols, 12))
        out.update({k: [v.to_json() for v in vs] for k, vs in rows.items()})
    assert got == want
    assert sorted(got) == sorted({r for r, c, _ in poison
                                  if not (r == 9 and c >= 2)})


def test_batch_and_result_guards_are_the_jax_packages():
    jb, pb = _batch(JAX), _batch(PORT)
    jb["score"].values[4] = np.inf
    pb["score"].values[4] = np.inf
    jsch = JQ.RawSchema.derive(_features(JAX))
    psch = Q.RawSchema.derive(_features(PORT))
    got, want = Q.batch_nonfinite_rows(pb, psch), JQ.batch_nonfinite_rows(
        jb, jsch)
    assert {k: [v.to_json() for v in vs] for k, vs in got.items()} == \
        {k: [v.to_json() for v in vs] for k, vs in want.items()}
    assert 4 in got
    result = {"p": {"prediction": 1.0, "probability_0": float("nan")},
              "x": float("inf"), "ok": 0.5, "s": "text"}
    assert Q.result_nonfinite_fields(result) == \
        JQ.result_nonfinite_fields(result)
    arrays = {"a": (np.array([1.0, np.nan, 3.0]), None),
              "b": (np.array([np.inf, 2.0, 3.0]), np.array([1, 1, 0], bool)),
              "c": (np.array(["x", "y", "z"], dtype=object), None),
              "d": (np.array([1.0, 2.0, 3.0]), None)}
    g_arr, g_bad = Q.mask_nonfinite_result_arrays(arrays)
    w_arr, w_bad = JQ.mask_nonfinite_result_arrays(arrays)
    np.testing.assert_array_equal(g_bad, w_bad)
    assert list(g_arr) == list(w_arr)
    for k in w_arr:
        np.testing.assert_array_equal(g_arr[k][0], w_arr[k][0])
        assert (g_arr[k][1] is None) == (w_arr[k][1] is None)
        if w_arr[k][1] is not None:
            np.testing.assert_array_equal(g_arr[k][1], w_arr[k][1])


def test_screen_records_keeps_and_quarantines_as_the_jax_package():
    from transmogrifai_tpu.resilience import FailureLog as JLog
    from transmogrifai_tpu.resilience import use_failure_log
    from transmogrifai_tpu_torch.resilience import FailureLog
    from transmogrifai_tpu_torch.telemetry import MetricsRegistry
    records = [RECORDS[k] for k in ("clean", "non_coercible",
                                    "numeric_string_coerced", "inf",
                                    "absent_non_nullable", "unknown_field")]
    for policy in JQ.POLICIES:
        for frac in (0.9, 0.1):
            pcfg = Q.QualityConfig(policy=policy, max_quarantine_fraction=frac,
                                   enabled=policy != "off")
            jcfg = JQ.QualityConfig(policy=policy,
                                    max_quarantine_fraction=frac,
                                    enabled=policy != "off")
            log, reg, jlog = FailureLog(), MetricsRegistry(), JLog()
            try:
                got = Q.screen_records(records, _features(PORT), pcfg,
                                       log=log, registry=reg)
            except Q.DataQualityError as e:
                got = ("abort", e.quarantined, e.total, str(e))
            with use_failure_log(jlog):
                try:
                    want = JQ.screen_records(records, _features(JAX), jcfg)
                except JQ.DataQualityError as e:
                    want = ("abort", e.quarantined, e.total, str(e))
            assert json.dumps(got, sort_keys=True, default=str) == \
                json.dumps(want, sort_keys=True, default=str), (policy, frac)
            assert [(e.action, e.point, e.cause) for e in log.events] == \
                [(e.action, e.point, e.cause) for e in jlog.events]
    assert Q.screen_records(records, _features(PORT), None) is records


@pytest.mark.parametrize("frac", [0.5, 0.01])
def test_screen_batch_drops_non_finite_rows_as_the_jax_package(frac):
    from transmogrifai_tpu.resilience import FailureLog as JLog
    from transmogrifai_tpu.resilience import use_failure_log
    from transmogrifai_tpu_torch.resilience import FailureLog
    jb, pb = _batch(JAX), _batch(PORT)
    for b in (jb, pb):
        b["score"].values[[4, 9]] = [np.inf, np.nan]
    log, jlog = FailureLog(), JLog()
    cfg = dict(policy="coerce", max_quarantine_fraction=frac)
    try:
        got = Q.screen_batch(pb, _features(PORT), Q.QualityConfig(**cfg),
                             log=log)
        got = np.asarray(got["score"].values)
    except Q.DataQualityError as e:
        got = str(e)
    with use_failure_log(jlog):
        try:
            want = JQ.screen_batch(jb, _features(JAX),
                                   JQ.QualityConfig(**cfg))
            want = np.asarray(want["score"].values)
        except JQ.DataQualityError as e:
            want = str(e)
    if isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) < 40 and all(math.isfinite(v) for v in got)
    assert [(e.action, e.point, e.cause) for e in log.events] == \
        [(e.action, e.point, e.cause) for e in jlog.events]
