"""The port's transmogrification path against the JAX package, on the CPU:
the repository's mixed raw columns (``bench.make_transmog_columns``: 3 free
texts, 2 PickLists, a RealMap, 4 Reals with nulls) through
RawFeatureFilter → transmogrify (SmartTextVectorizer hashing, one-hot
pivots, map expansion, real fill) → SanityChecker (Cramér's V) → an LR
selector, at 2,000 rows.

Tolerances: text profiles, hashed counts (``hash_counts``' twin), one-hot
and map blocks, vocabularies, metadata, RawFeatureFilter results, the
checked width and the dropped set exactly equal; the real block rtol 1e-6 /
atol 1e-7 (its mean fill is an f32 sum in another order); SanityChecker means,
variances, extremes and label correlations rtol 1e-5 / atol 1e-6 (f32 sums
in another order), Cramér's V within 1e-5 (NaN where the JAX package has
NaN); LR coefficients rtol 1e-4 / atol 1e-5 (50 FISTA iterations of f32
products summed in another order), CV AuPR and train AuROC within 1e-4,
the same winner; scores of the fresh seed-7 batch rtol 1e-5 / atol 1e-6."""

import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import transmog_reference as tr  # noqa: E402
from bench import make_transmog_columns as jax_columns  # noqa: E402
from transmogrifai_tpu.ops import text as jtext  # noqa: E402
from transmogrifai_tpu.ops import text_profile as jprof  # noqa: E402
from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.columns import Column as PColumn  # noqa: E402
from transmogrifai_tpu_torch.columns import ColumnBatch as PBatch  # noqa: E402
from transmogrifai_tpu_torch.ops import text_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.ops import text_profile as pprof  # noqa: E402
from transmogrifai_tpu_torch.synthetic import \
    make_transmog_columns as port_columns  # noqa: E402

JAX, PORT = tr.PACKAGES["jax"], tr.PACKAGES["torch"]
N = 2000
ODD_TEXT = ["Hello Wörld ÄBC déjà-vu", None, "", "plain ascii text it's",
            "ΣΑΣ greek CAPS", "emoji 😀 x_y", "a", None, "İstanbul ǅ ﬁ"]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture(scope="module")
def trained():
    """Both packages' workflows trained on the same 2,000 rows, each
    scored on the same fresh seed-7 batch."""
    out = {}
    for pkg, make in ((JAX, jax_columns), (PORT, port_columns)):
        cols, schema = make(N)
        kw = {"device": "cpu"} if pkg == PORT else {}
        wf, batch, pred = tr.build(pkg, cols, schema, N, **kw)
        model = wf.train()
        fresh_cols, _ = make(N, seed=7)
        fresh = tr._mod(pkg, "columns").ColumnBatch(fresh_cols, N)
        scores = _np(model.score(batch=fresh)[pred.name]
                     .values["probability"])
        out[pkg] = {"model": model, "batch": batch, "pred": pred,
                    "facts": tr.facts(pkg, model, batch), "scores": scores}
    return out


def _stage(model, cls_name):
    return next(s for s in model.stages if type(s).__name__ == cls_name)


# --------------------------------------------------------------------------
# data and profiles
# --------------------------------------------------------------------------

def test_generator_equals_the_bench_generator_value_by_value():
    jc, js = jax_columns(500)
    pc, ps = port_columns(500)
    assert list(jc) == list(pc)
    assert {k: v.__name__ for k, v in js.items()} == \
        {k: v.__name__ for k, v in ps.items()}
    for name in jc:
        a, b = jc[name], pc[name]
        assert a.kind.__name__ == b.kind.__name__, name
        if a.values.dtype == object:
            assert list(a.values) == list(b.values), name
        else:
            np.testing.assert_array_equal(a.values, b.values, err_msg=name)
            assert (a.mask is None) == (b.mask is None)
            if a.mask is not None:
                np.testing.assert_array_equal(a.mask, b.mask)


@pytest.mark.parametrize("native", [True, False])
def test_text_profile_equals_the_jax_package(native):
    strings = np.asarray(ODD_TEXT + list(port_columns(300)[0]["text1"].values),
                         dtype=object)
    want = jprof.scan_strings(strings)
    got = pprof.scan_strings(strings, native=native)
    for f in ("null", "empty", "lengths", "crc", "tok_lens", "tok_hash"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for cap in (-1, 3, 30):
        a, b = got.values(cap), want.values(cap)
        assert a.uniq == b.uniq and a.frozen == b.frozen
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.codes, b.codes)


@pytest.mark.parametrize("H", [512, 2048])
@pytest.mark.parametrize("which", ["odd", "text3", "all_null"])
def test_hash_counts_twin_equals_the_jax_scatter(which, H):
    if which == "odd":
        strings = ODD_TEXT
    elif which == "text3":
        strings = list(port_columns(400)[0]["text3"].values)
    else:
        strings = [None] * 50
    strings = np.asarray(strings, dtype=object)
    prof = pprof.scan_strings(strings)
    ids, off = prof.device_ids(H, torch.device("cpu"))
    null = torch.from_numpy(prof.null)
    got = _np(tk.hash_counts(ids, off, null, H, packed=H < 1024))
    lens, flat = jprof.scan_strings(strings).buckets(H)
    want = np.asarray(jtext.device_counts_from_flat(lens, flat, H))
    np.testing.assert_array_equal(got[:, :H], want)
    np.testing.assert_array_equal(got[:, :H],
                                  jtext._counts_from_flat(lens, flat, H,
                                                          False))
    np.testing.assert_array_equal(got[:, H], prof.null.astype(np.float32))
    # the fasttok pass gives the same buckets as the profile's
    from transmogrifai_tpu_torch.ops.text import strings_to_hash_flat
    for native in (True, False):
        l2, f2 = strings_to_hash_flat(strings, H, native=native)
        np.testing.assert_array_equal(l2, lens)
        np.testing.assert_array_equal(f2, flat)


def test_hash_counts_twin_offset_write_without_null_column():
    strings = np.asarray(ODD_TEXT * 3, dtype=object)
    prof = pprof.scan_strings(strings)
    ids, off = prof.device_ids(512, torch.device("cpu"))
    out = torch.full((len(strings), 520), 7.0)
    tk.hash_counts(ids, off, None, 512, out=out, col0=3)
    lens, flat = jprof.scan_strings(strings).buckets(512)
    want = jtext._counts_from_flat(lens, flat, 512, False)
    np.testing.assert_array_equal(_np(out[:, 3:515]), want)
    assert bool((out[:, :3] == 7).all() and (out[:, 515:] == 7).all())
    with pytest.raises(ValueError):
        tk.hash_counts(ids, off, None, 1024)          # packed wire < 1024


def test_hash_plan_takes_every_width_up_to_100003():
    """Every width plans: whole count rows in shared memory up to 58,112
    hashes (the launch as it was), tiles of column windows past that; the
    windows cover the columns once."""
    for H in range(1, 100_004):
        plan = tk.hash_plan(H)
        if 4 * H <= tk._SMEM_MAX:
            assert plan == {"R": min(32, tk._SMEM_MAX // (4 * H)), "WH": H,
                            "windows": 1}
        else:
            assert 4 * plan["R"] * plan["WH"] <= tk._SMEM_MAX
            assert (plan["windows"] - 1) * plan["WH"] < H \
                <= plan["windows"] * plan["WH"]
    assert tk.hash_plan(58_112)["windows"] == 1
    assert tk.hash_plan(58_113)["windows"] == 8
    with pytest.raises(ValueError):
        tk.hash_plan(0)


def _emulate_windows(ids, off, null, H, plan):
    """``csrc/hash_counts.cu``'s window form in numpy: block (row tile,
    window w) counts the ids of its rows that fall in its window and writes
    those columns; the last window writes the null column."""
    n = len(off) - 1
    out = np.full((n, H + 1), np.nan, np.float32)
    R, WH = plan["R"], plan["WH"]
    for r0 in range(0, n, R):
        for w0 in range(0, H, WH):
            wn = min(WH, H - w0)
            cnt = np.zeros((min(R, n - r0), wn), np.float32)
            for r in range(cnt.shape[0]):
                t = ids[off[r0 + r]:off[r0 + r + 1]] - w0
                t = t[(t >= 0) & (t < wn)]
                np.add.at(cnt[r], t, 1.0)
            out[r0:r0 + cnt.shape[0], w0:w0 + wn] = cnt
            if w0 + wn == H:
                out[r0:r0 + cnt.shape[0], H] = null[r0:r0 + cnt.shape[0]]
    return out


@pytest.mark.parametrize("H", [60_000, 100_003])
def test_hash_counts_past_58112_hashes_equal_the_jax_scatter(H):
    """At 60,000 and 100,003 hashes (past one row's shared-memory tile) the
    twin's counts equal the JAX package's ``_scatter_counts_device``, and
    the kernel's window form, emulated, equals the twin."""
    strings = np.asarray(ODD_TEXT + list(port_columns(60)[0]["text3"].values),
                         dtype=object)
    prof = pprof.scan_strings(strings)
    ids, off = prof.device_ids(H, torch.device("cpu"))
    null = torch.from_numpy(prof.null)
    got = _np(tk.hash_counts(ids, off, null, H, packed=False))
    lens, flat = jprof.scan_strings(strings).buckets(H)
    want = np.asarray(jtext.device_counts_from_flat(lens, flat, H))
    np.testing.assert_array_equal(got[:, :H], want)
    np.testing.assert_array_equal(got[:, H], prof.null.astype(np.float32))
    np.testing.assert_array_equal(
        _emulate_windows(_np(ids).astype(np.int64), _np(off), prof.null, H,
                         tk.hash_plan(H)), got)


def test_map_expansion_native_equals_python_and_the_jax_package():
    from transmogrifai_tpu.ops import map_profile as jmp
    from transmogrifai_tpu_torch.ops import map_profile as pmp
    maps = list(port_columns(300)[0]["rmap"].values) + [None, {}, {"z": 2}]
    want = jmp.expand_maps(maps)
    for native in (True, False):
        got = pmp.expand_maps(maps, native=native)
        assert got.keys == want.keys
        for f in ("vals", "present", "in_dict", "nonempty"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert pmp.expand_maps([{"a": True}]) is None


# --------------------------------------------------------------------------
# stages, from the two trained workflows
# --------------------------------------------------------------------------

def _block(model, batch, cls_name, pkg):
    st = _stage(model, cls_name)
    col = st.transform(batch.on("cpu") if pkg == PORT else batch)
    return st, _np(col.values)


@pytest.mark.parametrize("cls_name", ["OneHotModel",
                                      "SmartTextVectorizerModel",
                                      "MapVectorizerModel",
                                      "RealVectorizerModel"])
def test_vectorizer_blocks_and_metadata_equal_the_jax_package(trained,
                                                              cls_name):
    js, jv = _block(trained[JAX]["model"], trained[JAX]["batch"], cls_name,
                    JAX)
    ps, pv = _block(trained[PORT]["model"], trained[PORT]["batch"], cls_name,
                    PORT)
    if cls_name == "RealVectorizerModel":
        # the mean fill is an f32 sum taken in another order
        np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(pv, jv)
    assert ps.fitted["meta"].column_names() == js.fitted["meta"].column_names()
    for k in ("vocabs", "strategies", "keys", "fills"):
        if k not in js.fitted:
            continue
        if isinstance(ps.fitted[k], (dict, list)):
            assert ps.fitted[k] == js.fitted[k], k
        else:
            np.testing.assert_allclose(_np(ps.fitted[k]),
                                       np.asarray(js.fitted[k]), rtol=1e-6)
    if cls_name == "SmartTextVectorizerModel":
        assert set(ps.fitted["strategies"].values()) == {"hash"}


def test_raw_feature_filter_results_equal_the_jax_package(trained):
    a = trained[PORT]["model"].rff_results
    b = trained[JAX]["model"].rff_results
    assert a.dropped == b.dropped and a.reasons == b.reasons
    assert a.dropped_map_keys == b.dropped_map_keys
    assert len(a.train_distributions) == len(b.train_distributions)
    for x, y in zip(a.train_distributions, b.train_distributions):
        assert (x.name, x.key, x.count, x.nulls) == \
            (y.name, y.key, y.count, y.nulls)
        np.testing.assert_array_equal(x.distribution, y.distribution)


def test_sanity_checker_stats_and_cramers_v_equal_the_jax_package(trained):
    a = tr.sanity_summary(trained[PORT]["model"])
    b = tr.sanity_summary(trained[JAX]["model"])
    assert a.names == b.names and a.dropped == b.dropped
    for f in ("means", "variances", "mins", "maxs",
              "correlations_with_label"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert a.cramers_v_by_group.keys() == b.cramers_v_by_group.keys()
    for g, v in b.cramers_v_by_group.items():
        got = a.cramers_v_by_group[g]
        assert math.isnan(got) == math.isnan(v), g
        if not math.isnan(v):
            assert abs(got - v) <= 1e-5, g
    for g, st in b.contingency_stats_by_group.items():
        np.testing.assert_allclose(
            a.contingency_stats_by_group[g]["maxRuleConfidences"],
            st["maxRuleConfidences"], rtol=1e-5, atol=1e-6)


def _train_vector(pkg, schema, values, n, check=False):
    """Train ``transmogrify`` (and with ``check`` the SanityChecker) over
    raw columns of ``schema`` kinds alone; returns the fitted model."""
    C, TY = tr._mod(pkg, "columns"), tr._mod(pkg, "types")
    F = tr._mod(pkg, "features")
    kinds = {k: getattr(TY, v) for k, v in schema.items()}
    label, feats = F.features_from_schema(kinds, "label")
    out = tr._mod(pkg, "ops.transmogrify").transmogrify(feats)
    if check:
        out = label.sanity_check(out)
    batch = C.ColumnBatch({k: C.column_from_values(kinds[k], v)
                           for k, v in values.items()}, n)
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = tr._mod(pkg, "workflow").Workflow(**kw).set_input_batch(batch)
    return wf.set_result_features(out).train(), batch, out


def test_sanity_checker_drops_a_leaking_pivot_group():
    """A pick-list that equals the label has Cramér's V 1 > 0.95: its whole
    indicator group drops, in both packages alike."""
    rng = np.random.default_rng(3)
    y = (rng.random(300) > 0.5).astype(np.float32)
    vals = {"label": list(y), "leak": ["yes" if v else "no" for v in y],
            "x": list(rng.normal(size=300))}
    dropped = {}
    for pkg in (JAX, PORT):
        model, _, _ = _train_vector(
            pkg, {"label": "RealNN", "leak": "PickList", "x": "Real"}, vals,
            300, check=True)
        summ = tr.sanity_summary(model)
        dropped[pkg] = summ.dropped
        assert summ.cramers_v_by_group["leak"] == pytest.approx(1.0)
    assert dropped[PORT] == dropped[JAX]
    assert {"leak_yes_0", "leak_no_1"} <= set(dropped[PORT])


def test_integral_and_binary_vectorizers_equal_the_jax_package():
    rng = np.random.default_rng(1)
    vals = {"i": [None if rng.random() < 0.2 else int(v)
                  for v in rng.integers(0, 5, 200)],
            "b": [None if rng.random() < 0.3 else bool(v)
                  for v in rng.integers(0, 2, 200)]}
    outs = {}
    for pkg in (JAX, PORT):
        model, batch, fv = _train_vector(
            pkg, {"label": "RealNN", "i": "Integral", "b": "Binary"}, vals,
            200)
        col = model.score(batch)[fv.name] if pkg == PORT else \
            model.score(batch=batch, keep_intermediate_features=True)[fv.name]
        outs[pkg] = (_np(col.values), col.meta.column_names())
    np.testing.assert_array_equal(outs[PORT][0], outs[JAX][0])
    assert outs[PORT][1] == outs[JAX][1]


@pytest.mark.parametrize("kind", ["URL", "TextList", "Email",
                                  "Phone", "TextMap", "BinaryMap"])
def test_kinds_of_later_slices_raise_naming_the_slice(kind):
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    f = FeatureBuilder(kind, PT.feature_type_from_name(kind)).as_predictor()
    with pytest.raises(NotImplementedError, match="later slice.*item 7"):
        transmogrify([f])


# --------------------------------------------------------------------------
# the whole workflow
# --------------------------------------------------------------------------

def test_workflow_matches_the_jax_package(trained):
    a, b = trained[PORT]["facts"], trained[JAX]["facts"]
    assert a["width"] == b["width"] == 1596
    assert a["dropped"] == b["dropped"] == ["cat1_OTHER_20"]
    assert a["winner"] == b["winner"]
    assert a["cv_aupr"].keys() == b["cv_aupr"].keys()
    for c, v in b["cv_aupr"].items():
        assert abs(a["cv_aupr"][c] - v) <= 1e-4, c
    assert abs(a["train_auroc"] - b["train_auroc"]) <= 1e-4
    pa = trained[PORT]["model"].selected_model.best_model.fitted
    pb = trained[JAX]["model"].selected_model.best_model.fitted
    np.testing.assert_allclose(_np(pa["coef"]), np.asarray(pb["coef"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(pa["intercept"]).reshape(-1),
                               np.asarray(pb["intercept"]).reshape(-1),
                               rtol=1e-4, atol=1e-5)


def test_fresh_batch_scores_match_the_jax_package(trained):
    np.testing.assert_allclose(trained[PORT]["scores"],
                               trained[JAX]["scores"], rtol=1e-5, atol=1e-6)


def test_phase_seconds_cover_filter_vectorizers_checker_and_selector(trained):
    ph = trained[PORT]["model"].phase_seconds
    assert {"RawFeatureFilter", "OneHotEstimator", "SmartTextVectorizer",
            "MapVectorizer", "RealVectorizer", "VectorsCombiner",
            "SanityChecker",
            "BinaryClassificationModelSelector"} <= set(ph)
    assert all(v >= 0 for v in ph.values())


def test_raw_feature_filter_drops_an_empty_feature_everywhere():
    """A column filled below min_fill_rate drops from the DAG: the vector
    loses its block, and scoring a batch without the column still works."""
    cols, schema = port_columns(400)
    full = tr.build(PORT, cols, schema, 400, device="cpu")[0].train()
    cols["text3"] = PColumn(PT.Text, np.full(400, None, dtype=object))
    wf, batch, pred = tr.build(PORT, cols, schema, 400, device="cpu")
    model = wf.train()
    assert [f.name for f in model.blacklisted] == ["text3"]
    names = tr.sanity_summary(model).names
    assert len(names) == len(tr.sanity_summary(full).names) - 513
    assert not any(n.startswith("text3") for n in names)
    fresh = dict(port_columns(400, seed=7)[0])
    del fresh["text3"]
    p = model.score(PBatch(fresh, 400))[pred.name].values["probability"]
    assert tuple(p.shape) == (400, 2) and bool(torch.isfinite(p).all())


def test_port_entry_points_raise_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cols, schema = port_columns(50)
    wf_cls = tr._mod(PORT, "workflow").Workflow
    with pytest.raises(RuntimeError, match="CUDA"):
        wf_cls()
    prof = pprof.scan_strings(np.asarray(["a b"], dtype=object))
    with pytest.raises(RuntimeError, match="CUDA"):
        from transmogrifai_tpu_torch.device import resolve_device
        prof.device_ids(512, resolve_device(None))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A helper that does not build raises; nothing falls back to Python
    behind the caller's back."""
    from transmogrifai_tpu_torch import native
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="native helper build failed"):
        native.load("broken")
