"""The port's dense binary slice end to end against the JAX package, on the
CPU: RealNN features → transmogrify → sanity_check →
BinaryClassificationModelSelector (3-fold CV, racing over LR x4 + GBT, and
the bench's full LR x4 + RF + GBT set) → train / evaluate / score, and
``convert`` scoring a JAX-fitted model in the port.  Tolerances: folds,
raced-out set and winner exact; per-candidate LR and GBT CV metrics and
train AuROC 1e-4; the forest's CV AuPR within ``RF_CV_AUPR_TOL`` (its draws
are torch's, not jax.random's); scores of models each package trained rtol
1e-4 / atol 1e-5 (LR coefficients agree to 1e-4); scores of one JAX-fitted
model scored by both packages rtol 1e-5 / atol 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

N, D = 400, 6
# max(0.01, 3 x the JAX package's spread 0.0280 of the bench forest's CV
# AuPR over RF seeds 42, 0, 1, 2, 3 on these 400 x 6 rows, measured by
# `python tests/test_torch_forest.py`)
RF_CV_AUPR_TOL = 0.084


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32) / np.sqrt(D)
    logits = (X @ w + 0.35 * (X[:, 0] * X[:, 1]) - 0.25 * (X[:, 2] ** 2)
              + 0.1 + 0.3 * np.sin(2 * X[:, 3]))
    y = (logits + rng.normal(size=N).astype(np.float32) > 0).astype(np.float32)
    return X, y


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _build(pkg, X, y, families=("lr", "gbt"), **wf_kw):
    """The bench's dense workflow in package ``pkg``, cut to 6 features and
    a 3-round depth-2 GBT; the forest, when asked for, is the bench's (20
    trees, depth 6)."""
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    checked = label.sanity_check(fv, remove_bad_features=True)
    models = []
    if "lr" in families:
        models.append(S.ModelCandidate(
            _mod(pkg, "models.linear").OpLogisticRegression(),
            S.grid(reg_param=[0.001, 0.01, 0.1, 0.2], elastic_net_param=[0.1],
                   max_iter=[50]), "OpLogisticRegression"))
    if "rf" in families:
        models.append(S.ModelCandidate(
            _mod(pkg, "models.trees").OpRandomForestClassifier(),
            S.grid(num_trees=[20], max_depth=[6], min_instances_per_node=[10]),
            "OpRandomForestClassifier"))
    if "gbt" in families:
        models.append(S.ModelCandidate(
            _mod(pkg, "models.trees").OpGBTClassifier(),
            S.grid(max_iter=[3], max_depth=[2], min_instances_per_node=[10]),
            "OpGBTClassifier"))
    sel = S.BinaryClassificationModelSelector(models=models)
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    batch = C.ColumnBatch(cols, N)
    wf = _mod(pkg, "workflow").Workflow(**wf_kw).set_input_batch(batch)
    return wf.set_result_features(pred), batch, pred


def _train(pkg, families=("lr", "gbt"), seed=0):
    X, y = _data(seed)
    kw = {"device": "cpu"} if pkg == "transmogrifai_tpu_torch" else {}
    wf, batch, pred = _build(pkg, X, y, families, **kw)
    model = wf.train()
    ev = _mod(pkg, "evaluators").Evaluators.BinaryClassification.auROC()
    return {"model": model, "batch": batch, "pred": pred, "X": X, "y": y,
            "auroc": float(model.evaluate(ev, batch=batch)["AuROC"])}


@pytest.fixture(scope="module")
def slice_runs():
    return _train("transmogrifai_tpu"), _train("transmogrifai_tpu_torch")


@pytest.fixture(scope="module")
def gbt_runs():
    """GBT as the only family, so the selected (and scored) model is GBT."""
    return (_train("transmogrifai_tpu", ("gbt",)),
            _train("transmogrifai_tpu_torch", ("gbt",)))


@pytest.fixture(scope="module")
def full_runs():
    """The bench's full candidate set: LR x4 + RF + GBT."""
    fams = ("lr", "rf", "gbt")
    return (_train("transmogrifai_tpu", fams),
            _train("transmogrifai_tpu_torch", fams))


@pytest.fixture(scope="module")
def rf_runs():
    """The forest as the only family, so the selected model is a forest."""
    return (_train("transmogrifai_tpu", ("rf",)),
            _train("transmogrifai_tpu_torch", ("rf",)))


def _results(run):
    return [(r.model_name, r.params, r.metric_values["AuPR"], r.raced_out)
            for r in run["model"].selected_model.summary.validation_results]


def test_same_folds_as_jax():
    from transmogrifai_tpu.tuning import OpCrossValidation as JCV
    from transmogrifai_tpu_torch.tuning import OpCrossValidation as PCV
    _, y = _data()
    for stratify in (False, True):
        for (jtr, jva), (ptr, pva) in zip(JCV(3, stratify=stratify).splits(y),
                                          PCV(3, stratify=stratify).splits(y)):
            np.testing.assert_array_equal(ptr, jtr)
            np.testing.assert_array_equal(pva, jva)


def test_winner_raced_out_set_and_cv_metrics_match_jax(slice_runs):
    ref, port = slice_runs
    rs, ps = _results(ref), _results(port)
    assert [(n, p, r) for n, p, _, r in ps] == [(n, p, r) for n, p, _, r in rs]
    assert sum(r for *_, r in rs) == 2          # racing pruned 2 of 4 LR points
    np.testing.assert_allclose([m for _, _, m, _ in ps],
                               [m for _, _, m, _ in rs], rtol=0, atol=1e-4)
    assert (port["model"].selected_model.summary.best_model_name
            == ref["model"].selected_model.summary.best_model_name)
    assert abs(port["auroc"] - ref["auroc"]) <= 1e-4


def test_full_candidate_set_matches_jax(full_runs):
    """Same folds and raced-out set, the same winner; LR and GBT CV metrics
    as tight as without the forest, the forest's within RF_CV_AUPR_TOL."""
    ref, port = full_runs
    rs, ps = _results(ref), _results(port)
    assert [(n, p, r) for n, p, _, r in ps] == [(n, p, r) for n, p, _, r in rs]
    for (name, _, pm, _), (_, _, jm, _) in zip(ps, rs):
        tol = RF_CV_AUPR_TOL if name == "OpRandomForestClassifier" else 1e-4
        assert abs(pm - jm) <= tol, (name, pm, jm)
    assert (port["model"].selected_model.summary.best_model_name
            == ref["model"].selected_model.summary.best_model_name)
    assert abs(port["auroc"] - ref["auroc"]) <= 1e-4
    secs = port["model"].selected_model.selector_seconds
    assert set(secs) == {"OpLogisticRegression", "OpRandomForestClassifier",
                         "OpGBTClassifier", "refit", "train_evaluation"}


def test_forest_winner_scores_and_converts(rf_runs):
    """A forest winner: the port's scores are a forest's (class shares that
    sum to 1, log-share raw predictions), its train AuROC within the CV
    tolerance of the JAX package's; the JAX-trained forest converted into
    the port scores as the JAX package scores it."""
    ref, port = rf_runs
    assert (port["model"].selected_model.summary.best_model_name
            == "OpRandomForestClassifier")
    assert abs(port["auroc"] - ref["auroc"]) <= RF_CV_AUPR_TOL
    name = port["pred"].name
    got = port["model"].score(port["batch"])[name].values
    prob = got["probability"]
    torch.testing.assert_close(prob.sum(dim=1), torch.ones(N))
    torch.testing.assert_close(got["rawPrediction"],
                               torch.log(torch.clamp(prob, min=1e-12)))
    from transmogrifai_tpu_torch import convert
    _, batch, pred = _build("transmogrifai_tpu_torch", ref["X"], ref["y"],
                            ("rf",), device="cpu")
    model = convert.workflow_model([pred], _export(ref["model"]),
                                   device="cpu")
    conv = model.score(batch)[pred.name].values
    want = ref["model"].score(ref["batch"])[ref["pred"].name].values
    np.testing.assert_allclose(conv["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(conv["prediction"].numpy(),
                                  np.asarray(want["prediction"]))


def test_feature_vector_and_sanity_checker_match_jax(slice_runs):
    ref, port = slice_runs

    def checker(run):
        return next(s for s in run["model"].stages
                    if type(s).__name__ == "SanityCheckerModel")

    jc, pc = checker(ref), checker(port)
    np.testing.assert_array_equal(pc.fitted["indices_to_keep"],
                                  jc.fitted["indices_to_keep"])
    js_, ps_ = jc.metadata["summary"], pc.metadata["summary"]
    assert ps_["names"] == js_["names"]
    for key in ("means", "variances", "mins", "maxs", "correlationsWithLabel"):
        np.testing.assert_allclose(ps_[key], js_[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("runs", ["slice_runs", "gbt_runs"])
def test_scores_match_jax(runs, request):
    ref, port = request.getfixturevalue(runs)
    assert (port["model"].selected_model.summary.best_model_name
            == ref["model"].selected_model.summary.best_model_name)
    assert abs(port["auroc"] - ref["auroc"]) <= 1e-4
    name = port["pred"].name
    ps_ = port["model"].score(port["batch"])[name].values
    js_ = ref["model"].score(ref["batch"])[ref["pred"].name].values
    np.testing.assert_allclose(ps_["probability"].numpy(),
                               np.asarray(js_["probability"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ps_["prediction"].numpy(),
                                  np.asarray(js_["prediction"]))


def _export(jax_model):
    """A JAX-fitted WorkflowModel as plain per-stage parameter dicts in DAG
    order (the input ``convert.workflow_model`` takes)."""
    out = []
    for st in (s for layer in jax_model.fitted_dag for s in layer):
        name = type(st).__name__
        p = {"stage": name}
        if name == "RealVectorizerModel":
            p["fills"] = np.asarray(st.fitted["fills"])
        elif name == "SanityCheckerModel":
            p["indices_to_keep"] = np.asarray(st.fitted["indices_to_keep"])
            p["summary"] = st.metadata.get("summary")
        elif name == "SelectedModel":
            best = st.best_model
            p["model"] = type(best).__name__
            p["fitted"] = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                           for k, v in best.fitted.items()}
        out.append(p)
    return out


@pytest.mark.parametrize("runs", ["slice_runs", "gbt_runs"])
def test_convert_scores_a_jax_trained_model_like_jax(runs, request):
    ref = request.getfixturevalue(runs)[0]
    families = ("lr", "gbt") if runs == "slice_runs" else ("gbt",)
    from transmogrifai_tpu_torch import convert
    X, y = ref["X"], ref["y"]
    _, batch, pred = _build("transmogrifai_tpu_torch", X, y, families,
                            device="cpu")
    model = convert.workflow_model([pred], _export(ref["model"]), device="cpu")
    got = model.score(batch)[pred.name].values
    want = ref["model"].score(ref["batch"])[ref["pred"].name].values
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["rawPrediction"].numpy(),
                               np.asarray(want["rawPrediction"]),
                               rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA rule is checked on CPU hosts")
    from transmogrifai_tpu_torch.device import resolve_device
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.workflow import Workflow
    with pytest.raises(RuntimeError, match="CUDA"):
        Workflow()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    X, y = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        OpLogisticRegression().fit_arrays(X, y)
    assert resolve_device("cpu").type == "cpu"
    # Stages given a batch with no device run on CUDA too.
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.numeric import RealNNVectorizer
    from transmogrifai_tpu_torch.types import OPVector, RealNN
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    raw = ColumnBatch({f"f{i}": Column(RealNN, X[:, i]) for i in range(D)})
    vec_model = RealNNVectorizer().set_input(*feats).fit(raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        vec_model.transform(raw)
    assert vec_model.transform(raw.on("cpu")).values.device.type == "cpu"
    label = FeatureBuilder.RealNN("label").as_response()
    vec = FeatureBuilder.OPVector("fv").as_predictor()
    est = OpLogisticRegression().set_input(label, vec)
    with pytest.raises(RuntimeError, match="CUDA"):
        est.fit(ColumnBatch({"label": Column(RealNN, y),
                             "fv": Column(OPVector, X)}))


def test_other_feature_kinds_name_the_slice_that_brings_them():
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    # dates arrive with the dates-and-bucketizers slice; text lists still
    # wait for theirs
    with pytest.raises(NotImplementedError, match="later slice"):
        transmogrify([FeatureBuilder.TextList("t").as_predictor()])


@pytest.mark.parametrize("spearman", [False, True])
def test_sanity_checker_col_stats_match_jax(spearman):
    import jax.numpy as jnp

    from transmogrifai_tpu.preparators.sanity_checker import _col_stats as jcs
    from transmogrifai_tpu_torch.preparators.sanity_checker import _col_stats as pcs
    X, y = _data(1)
    X[:, 2] = np.round(X[:, 2])                 # ties for the rank transform
    ref = jcs(jnp.asarray(X), jnp.asarray(y), spearman=spearman)
    got = pcs(torch.as_tensor(X), torch.as_tensor(y), spearman=spearman)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_real_vectorizer_and_its_conversion_match_jax():
    """Nullable reals: train-mean fills + null indicators, fitted by each
    package and converted from the JAX fit (RealVectorizer, numeric.py:32)."""
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as tier-1 runs it)

    rng = np.random.default_rng(4)
    vals = rng.normal(size=(2, N)).astype(np.float32)
    masks = rng.random((2, N)) > 0.2
    vals[~masks] = np.nan

    def run(pkg, **kw):
        C, F, TY = _mod(pkg, "columns"), _mod(pkg, "features"), _mod(pkg, "types")
        feats = [F.FeatureBuilder.Real(f"r{i}").as_predictor() for i in range(2)]
        st = _mod(pkg, "ops.numeric").RealVectorizer()
        st.set_input(*feats)
        batch = C.ColumnBatch({f"r{i}": C.Column(TY.Real, vals[i], mask=masks[i])
                               for i in range(2)}, N, **kw)
        model = st.fit(batch)
        return st, model, batch, model.transform(batch)

    _, jm, _, jcol = run("transmogrifai_tpu")
    pst, pm, pbatch, pcol = run("transmogrifai_tpu_torch", device="cpu")
    np.testing.assert_allclose(pm.fitted["fills"].numpy(),
                               np.asarray(jm.fitted["fills"]), rtol=1e-6)
    np.testing.assert_allclose(pcol.values.numpy(), np.asarray(jcol.values),
                               rtol=1e-6)
    assert pcol.meta.column_names() == jcol.meta.column_names()
    from transmogrifai_tpu_torch import convert
    conv = convert.fitted_stage(pst, {"stage": "RealVectorizerModel",
                                      "fills": np.asarray(jm.fitted["fills"])},
                                torch.device("cpu"))
    np.testing.assert_allclose(conv.transform(pbatch).values.numpy(),
                               np.asarray(jcol.values), rtol=1e-6)
