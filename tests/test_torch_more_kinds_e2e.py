"""The port's counterpart of ``tests/test_all_kinds_e2e.py`` over the kinds
the port now takes, against the JAX package on the CPU: Dates, a
DateTime (also through ``to_time_period``), a DateList, two
MultiPickLists, a Geolocation, Reals (four through ``auto_bucketize``, one
through a fixed-split ``bucketize``) and a RealMap (also through
``DecisionTreeNumericMapBucketizer``) → transmogrify → sanity_check →
``BinaryClassificationModelSelector`` (LR x2 + GBT, 3-fold CV) → train,
score, save, load — both ways between the packages — on
``synthetic.make_kinds_columns`` rows.  The map bucketizer runs with
``track_nulls=False`` here: with null tracking the JAX package's model
writes each split key's null column twice, so its vector is wider than its
metadata and its SanityChecker raises ``IndexError``; the port's block
(one null column a key) is held to the JAX package's without the second
copy in ``tests/test_torch_bucketizers.py``.

Tolerances: the candidates and the winner exactly equal; the decision-tree
bucketizers' thresholds equal, or parted only where two splits' gini gains
tie exactly (ROADMAP queue 3: the JAX package's jitted gain and the port's
round such ties apart; ``tests/test_torch_bucketizers.py`` holds the
rule); the checked vector's column names equal but for the parted
buckets' labels; CV AuPR and train AuROC within 1e-4 (the dates' sin / cos
agree to 1e-6) where no bucketizer parted, else within 2e-3 (a bucket
boundary moved between two of its bins' values); scores of one model in
either package: ``prediction`` equal, ``probability`` within 1e-5; of the
two packages' models the same where no bucketizer parted, else
``probability`` within 2e-3; a port bundle reloaded in the port: the same
bits."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu_torch.synthetic import make_kinds_columns  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
N, FRESH = 600, 300


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def kinds_batch(pkg, n, seed):
    cols, schema = make_kinds_columns(n, seed=seed)
    C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
    pc = {k: C.Column(getattr(TY, v.kind.__name__), v.values, mask=v.mask)
          for k, v in cols.items()}
    return (C.ColumnBatch(pc, n, device="cpu") if pkg == PORT
            else C.ColumnBatch(pc, n)), schema


def build(pkg, batch, schema, **sel_kw):
    F, S, TY = (_mod(pkg, m) for m in ("features", "selector", "types"))
    bk = _mod(pkg, "ops.bucketizers")
    raw = {n: F.FeatureBuilder(n, getattr(TY, k.__name__))
           for n, k in schema.items()}
    label = raw.pop("label").as_response()
    feats = {n: b.as_predictor() for n, b in raw.items()}
    extra = [feats[f"r{j}"].auto_bucketize(label) for j in range(4)]
    mb = bk.DecisionTreeNumericMapBucketizer(track_nulls=False)
    mb.set_input(label, feats["rmap"])
    extra += [mb.get_output(),
              feats["r4"].bucketize([-np.inf, -1.0, 0.0, 1.0, np.inf]),
              feats["dt"].to_time_period("HourOfDay")]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(
        list(feats.values()) + extra)
    checked = label.sanity_check(fv, remove_bad_features=True)
    models = [S.ModelCandidate(
                  _mod(pkg, "models.linear").OpLogisticRegression(),
                  S.grid(reg_param=[0.01, 0.1], max_iter=[50]),
                  "OpLogisticRegression"),
              S.ModelCandidate(
                  _mod(pkg, "models.trees").OpGBTClassifier(),
                  S.grid(max_iter=[3], max_depth=[3],
                         min_instances_per_node=[10]),
                  "OpGBTClassifier")]
    sel = S.BinaryClassificationModelSelector(models=models, **sel_kw)
    sel.set_input(label, checked)
    pred = sel.get_output()
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(batch)
    return wf.set_result_features(pred), pred, checked


def _scores(model, batch):
    (name,) = [f.name for f in model.result_features]
    return {k: _np(v) for k, v in model.score(batch)[name].values.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for pkg in (JAX, PORT):
        batch, schema = kinds_batch(pkg, N, 17)
        wf, pred, checked = build(pkg, batch, schema)
        model = wf.train()
        ev = _mod(pkg, "evaluators").Evaluators.BinaryClassification.auROC()
        fresh, _ = kinds_batch(pkg, FRESH, 23)
        path = str(tmp_path_factory.mktemp(pkg) / "bundle")
        model.save(path, **({"aot": False} if pkg == JAX else {}))
        vec = model.score(batch, keep_intermediate_features=True)[
            checked.name]
        out[pkg] = {"model": model, "path": path,
                    "names": vec.meta.column_names(),
                    "auroc": float(model.evaluate(ev, batch=batch)["AuROC"]),
                    "scores": _scores(model, fresh)}
    return out


def _close(got, want, tol=1e-5):
    assert sorted(got) == sorted(want)
    if tol <= 1e-5:
        np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=tol)


def _bucket_splits(model):
    """Each decision-tree bucketizer's (input name, thresholds)."""
    out = {}
    for st in (s for layer in model.fitted_dag for s in layer):
        if type(st).__name__ == "DecisionTreeNumericBucketizerModel":
            out[st.input_features[1].name] = np.asarray(st.fitted["splits"])
        elif type(st).__name__ == "DecisionTreeNumericMapBucketizerModel":
            for k, v in st.fitted["splits_by_key"].items():
                out[f"rmap.{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def parted(runs):
    """The bucketizer inputs whose thresholds parted between the packages,
    each at an exact tie."""
    from test_torch_bucketizers import _assert_equal_but_at_exact_ties
    cols, _ = make_kinds_columns(N, seed=17)
    y = cols["label"].values.astype(np.float64)
    js, ps = (_bucket_splits(runs[p]["model"]) for p in (JAX, PORT))
    assert sorted(js) == sorted(ps) and len(js) == 24
    out = []
    for name in js:
        a, b = js[name], ps[name]
        if len(a) == len(b) and (a == b).all():
            continue
        if name.startswith("rmap."):
            k = name[5:]
            x = np.asarray([m.get(k, np.nan) for m in cols["rmap"].values])
        else:
            col = cols[name]
            x = np.where(col.mask, col.values, np.nan).astype(np.float64)
        p = ~np.isnan(x)
        assert _assert_equal_but_at_exact_ties(x[p], y[p]), name
        out.append(name)
    return out


def test_checked_vector_candidates_and_winner_match_jax(runs, parted):
    ref, port = runs[JAX]["model"], runs[PORT]["model"]
    rs = ref.selected_model.summary.validation_results
    ps = port.selected_model.summary.validation_results
    assert [(r.model_name, r.params) for r in ps] == \
        [(r.model_name, r.params) for r in rs]
    tol = 2e-3 if parted else 1e-4
    np.testing.assert_allclose([r.metric_values["AuPR"] for r in ps],
                               [r.metric_values["AuPR"] for r in rs],
                               rtol=0, atol=tol)
    assert port.selected_model.summary.best_model_name == \
        ref.selected_model.summary.best_model_name
    assert abs(runs[PORT]["auroc"] - runs[JAX]["auroc"]) <= tol
    assert runs[PORT]["auroc"] > 0.7
    names = [runs[p]["names"] for p in (JAX, PORT)]
    assert len(names[0]) == len(names[1]) > 100
    moved = [i for i, (a, b) in enumerate(zip(*names)) if a != b]
    assert all(any(names[0][i].startswith(n.split(".")[0] + "_")
                   for n in parted) for i in moved), [names[0][i]
                                                      for i in moved]


def test_the_two_packages_score_a_fresh_batch_alike(runs, parted):
    _close(runs[PORT]["scores"], runs[JAX]["scores"],
           2e-3 if parted else 1e-5)


def test_port_bundle_scores_the_same_in_jax(runs):
    from transmogrifai_tpu.workflow import WorkflowModel
    model = WorkflowModel.load(runs[PORT]["path"])
    fresh, _ = kinds_batch(JAX, FRESH, 23)
    _close(_scores(model, fresh), runs[PORT]["scores"])


def test_jax_bundle_scores_the_same_in_the_port(runs):
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    model = WorkflowModel.load(runs[JAX]["path"], device="cpu")
    fresh, _ = kinds_batch(PORT, FRESH, 23)
    _close(_scores(model, fresh), runs[JAX]["scores"])


def test_port_bundle_reloads_bit_for_bit(runs):
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    model = WorkflowModel.load(runs[PORT]["path"], device="cpu")
    fresh, _ = kinds_batch(PORT, FRESH, 23)
    got, want = _scores(model, fresh), runs[PORT]["scores"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("min_fill_rate", [0.001, 0.97])
def test_raw_feature_filter_on_the_new_kinds_matches_jax(min_fill_rate):
    """The RawFeatureFilter over every raw kind of the workload (dates as
    numbers, lists, sets, locations and maps as the JAX package profiles
    them): the same distributions, dropped features and reasons; at a
    fill rate of 0.97 the 5%-null columns drop in both."""
    out = {}
    for pkg in (JAX, PORT):
        b, schema = kinds_batch(pkg, N, 3)
        F, TY = _mod(pkg, "features"), _mod(pkg, "types")
        raw = [F.FeatureBuilder(n, getattr(TY, k.__name__))
               .as_response() if n == "label" else
               F.FeatureBuilder(n, getattr(TY, k.__name__)).as_predictor()
               for n, k in schema.items()]
        rff = _mod(pkg, "filters").RawFeatureFilter(
            min_fill_rate=min_fill_rate)
        _, dropped, res = rff.filter_batch(b, raw)
        out[pkg] = (sorted(f.name for f in dropped), res.to_json())
    assert out[PORT][0] == out[JAX][0]
    assert out[PORT][1] == out[JAX][1]
    if min_fill_rate > 0.9:
        assert "geo" in out[PORT][0] and "r0" in out[PORT][0]


def test_the_raw_schema_of_the_new_kinds_matches_jax():
    """``quality.RawSchema.derive`` over the workload's raw features: the
    same ``schema.json`` (kinds, nullability, each numeric column's range:
    the dates' too) in both packages."""
    got = {}
    for pkg in (JAX, PORT):
        b, schema = kinds_batch(pkg, N, 3)
        F, TY = _mod(pkg, "features"), _mod(pkg, "types")
        feats = [F.FeatureBuilder(n, getattr(TY, k.__name__)).as_predictor()
                 for n, k in schema.items()]
        got[pkg] = _mod(pkg, "quality").RawSchema.derive(feats, b).to_json()
    assert got[PORT] == got[JAX]


@pytest.fixture(scope="module")
def tvs_bundles(tmp_path_factory):
    """Each package's train with ``use_train_validation_split`` over LR,
    saved, with its scores of the fresh batch."""
    out = {}
    for pkg in (JAX, PORT):
        b, schema = kinds_batch(pkg, N, 17)
        wf, _, _ = build(pkg, b, schema, use_train_validation_split=True,
                         model_types_to_use=["OpLogisticRegression"])
        model = wf.train()
        path = str(tmp_path_factory.mktemp(f"tvs-{pkg}") / "bundle")
        model.save(path, **({"aot": False} if pkg == JAX else {}))
        fresh, _ = kinds_batch(pkg, FRESH, 23)
        out[pkg] = (model, path, _scores(model, fresh))
    return out


@pytest.mark.parametrize("trainer", [JAX, PORT])
def test_a_train_validation_split_bundle_loads_in_both(tvs_bundles, trainer):
    model, path, want = tvs_bundles[trainer]
    summ = model.selected_model.summary
    assert summ.validation_type == "TrainValidationSplit"
    assert summ.validation_parameters["trainRatio"] == 0.75
    for pkg in (JAX, PORT):
        WM = _mod(pkg, "workflow").WorkflowModel
        loaded = WM.load(path, **({"device": "cpu"} if pkg == PORT else {}))
        ls = loaded.selected_model.metadata["summary"]
        assert ls["validationType"] == "TrainValidationSplit"
        assert ls["validationParameters"]["trainRatio"] == 0.75
        assert "numFolds" not in ls["validationParameters"]
        fresh, _ = kinds_batch(pkg, FRESH, 23)
        _close(_scores(loaded, fresh), want)


def _export(jax_model):
    """A JAX-fitted model's stages as the plain parameter dicts
    ``convert.workflow_model`` takes, in DAG order (the new kinds' stages
    among them)."""
    out = []
    for st in (s for layer in jax_model.fitted_dag for s in layer):
        name, f = type(st).__name__, getattr(st, "fitted", {})
        p = {"stage": name}
        if name in ("RealVectorizerModel", "GeolocationVectorizerModel"):
            p["fills"] = np.asarray(f["fills"])
        elif name == "MultiPickListVectorizerModel":
            p["top_values"] = {k: sorted(v, key=v.get)
                               for k, v in f["vocabs"].items()}
        elif name == "DecisionTreeNumericBucketizerModel":
            p["splits"] = np.asarray(f["splits"])
        elif name == "DecisionTreeNumericMapBucketizerModel":
            p["keys"] = list(f["keys"])
            p["splits_by_key"] = {k: np.asarray(v)
                                  for k, v in f["splits_by_key"].items()}
        elif name == "SanityCheckerModel":
            p["indices_to_keep"] = np.asarray(f["indices_to_keep"])
        elif name == "SelectedModel":
            best = st.best_model
            p["model"] = type(best).__name__
            p["fitted"] = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                           for k, v in best.fitted.items()}
        out.append(p)
    return out


def _convert_case(pkg, b, schema):
    """Dates, a date list, a multi-pick-list, a location, a real through
    ``auto_bucketize``, another through ``bucketize``, a third scaled, the
    map through its bucketizer → transmogrify → sanity_check → LR."""
    F, S, TY = (_mod(pkg, m) for m in ("features", "selector", "types"))
    raw = {n: F.FeatureBuilder(n, getattr(TY, schema[n].__name__))
           for n in ("label", "d1", "dt", "dl", "mpl1", "geo", "r0", "r1",
                     "r2", "rmap")}
    label = raw.pop("label").as_response()
    f = {n: v.as_predictor() for n, v in raw.items()}
    mb = _mod(pkg, "ops.bucketizers").DecisionTreeNumericMapBucketizer(
        track_nulls=False)
    mb.set_input(label, f["rmap"])
    fv = _mod(pkg, "ops.transmogrify").transmogrify(
        [f[n] for n in ("d1", "dt", "dl", "mpl1", "geo")]
        + [f["r0"].auto_bucketize(label), mb.get_output(),
           f["r1"].bucketize([-np.inf, 0.0, np.inf]),
           f["r2"].scale("Linear", {"slope": 2.0})])
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        _mod(pkg, "models.linear").OpLogisticRegression(),
        S.grid(reg_param=[0.01], max_iter=[50]), "OpLogisticRegression")])
    sel.set_input(label, label.sanity_check(fv, remove_bad_features=True))
    pred = sel.get_output()
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(b)
    return wf.set_result_features(pred), pred


def test_convert_scores_a_jax_trained_workflow_of_the_new_kinds_like_jax():
    """``convert.workflow_model`` carries the JAX package's fitted fills,
    top values and splits into the port's stages: the same scores
    (probability within 1e-5, predictions equal)."""
    from transmogrifai_tpu_torch import convert
    jb, schema = kinds_batch(JAX, N, 17)
    jwf, jpred = _convert_case(JAX, jb, schema)
    jm = jwf.train()
    pb, _ = kinds_batch(PORT, N, 17)
    _, ppred = _convert_case(PORT, pb, schema)
    model = convert.workflow_model([ppred], _export(jm), device="cpu")
    want = {k: _np(v) for k, v in jm.score(
        kinds_batch(JAX, FRESH, 23)[0])[jpred.name].values.items()}
    got = {k: _np(v) for k, v in model.score(
        kinds_batch(PORT, FRESH, 23)[0])[ppred.name].values.items()}
    _close(got, want)


def test_convert_carries_the_calibrators_of_the_jax_package():
    """A JAX-fitted PercentileCalibrator and IsotonicRegressionCalibrator,
    carried across as splits and PAV blocks, transform a score like the
    JAX package's (1e-6)."""
    from transmogrifai_tpu_torch import convert
    rng = np.random.default_rng(4)
    score = rng.random(N).astype(np.float32)
    y = (score + rng.normal(scale=0.3, size=N) > 0.5).astype(np.float32)
    outs = {}
    for pkg in (JAX, PORT):
        C, TY, F = (_mod(pkg, m) for m in ("columns", "types", "features"))
        bk = _mod(pkg, "ops.bucketizers")
        cols = {"label": C.Column(TY.RealNN, y),
                "s": C.Column(TY.RealNN, score)}
        b = (C.ColumnBatch(cols, N, device="cpu") if pkg == PORT
             else C.ColumnBatch(cols, N))
        label = F.FeatureBuilder("label", TY.RealNN).as_response()
        s = F.FeatureBuilder("s", TY.RealNN).as_predictor()
        pc, iso = bk.PercentileCalibrator(), bk.IsotonicRegressionCalibrator()
        pc.set_input(s)
        iso.set_input(label, s)
        outs[pkg] = (b, pc, iso)
    jb, jpc, jiso = outs[JAX]
    pbatch, ppc, piso = outs[PORT]
    jp, ji = jpc.fit(jb), jiso.fit(jb)
    cp = convert.fitted_stage(ppc, {"stage": "PercentileCalibratorModel",
                                    "splits": jp.fitted["splits"]}, "cpu")
    ci = convert.fitted_stage(piso, {
        "stage": "IsotonicRegressionCalibratorModel",
        "boundaries": ji.fitted["boundaries"],
        "predictions": ji.fitted["predictions"]}, "cpu")
    for j, c in ((jp, cp), (ji, ci)):
        np.testing.assert_allclose(_np(c.transform(pbatch).values),
                                   _np(j.transform(jb).values),
                                   rtol=0, atol=1e-6)
    assert cp.metadata["origSplits"] == jp.metadata["origSplits"]
