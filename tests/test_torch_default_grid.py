"""The port's default binary model grid against the JAX package, on the CPU:
``BinaryClassificationModelSelector()`` with no ``models=`` builds the same
candidates (families, order, names, estimator defaults and grid dicts, as
Python values), trains at a tiny size and races each family to the JAX
package's survivor counts, and the splitter's test holdout takes the JAX
package's rows.  Tolerances: candidate lists and grids exact; holdout
AuROC of an LR-only selector 1e-4 (coefficients agree to 1e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

from transmogrifai_tpu import selector as js  # noqa: E402
from transmogrifai_tpu_torch import selector as ps  # noqa: E402

FAMILIES = ["OpLogisticRegression", "OpRandomForestClassifier",
            "OpGBTClassifier", "OpLinearSVC"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = ((X @ w + 0.6 * X[:, 0] * X[:, 1] + rng.normal(size=n)) > 0
         ).astype(np.float32)
    return X, y


def _train(pkg, X, y, **sel_kw):
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    D = X.shape[1]
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    checked = label.sanity_check(_mod(pkg, "ops.transmogrify").transmogrify(
        feats), remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(**sel_kw)
    sel.set_input(label, checked)
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    wf_kw = {"device": "cpu"} if pkg == "transmogrifai_tpu_torch" else {}
    wf = _mod(pkg, "workflow").Workflow(**wf_kw).set_input_batch(
        C.ColumnBatch(cols, len(y)))
    return wf.set_result_features(sel.get_output()).train()


def _candidates(sel):
    return [(c.model_name, type(c.estimator).__name__, c.grid)
            for c in sel.models]


def test_default_candidates_and_grids_match_jax():
    ref = js.BinaryClassificationModelSelector()
    port = ps.BinaryClassificationModelSelector()
    assert [c[0] for c in _candidates(port)] == FAMILIES
    assert _candidates(port) == _candidates(ref)
    assert [len(c.grid) for c in port.models] == [8, 18, 18, 4]
    for pc, jc in zip(port.models, ref.models):
        # the estimators' own defaults fill what the grid leaves out
        common = set(pc.estimator._params) & set(jc.estimator._params)
        assert {k: pc.estimator._params[k] for k in common} == \
            {k: jc.estimator._params[k] for k in common}
    for name, vals in vars(ps.DefaultSelectorParams).items():
        if name.isupper():
            assert getattr(js.DefaultSelectorParams, name) == vals, name
    assert type(port.splitter).__name__ == "DataSplitter"
    assert port.splitter.reserve_test_fraction == 0.0
    assert port.splitter.seed == ref.splitter.seed
    assert (_candidates(ps.BinaryClassificationModelSelector(
        models=ps.BinaryClassificationModelSelector.compact_models()))
        == _candidates(js.BinaryClassificationModelSelector(
            models=js.BinaryClassificationModelSelector.compact_models())))


def test_default_selector_trains_and_races_like_jax():
    """The whole default grid at 300 x 3 on the CPU twins: every family
    trains, racing keeps the JAX package's survivors per family (LR 3 of
    8, RF 6 of 18, GBT 6 of 18, SVC 2 of 4), the winner is one of the four
    families, and the model scores."""
    X, y = _data(300, 3)
    model = _train("transmogrifai_tpu_torch", X, y)
    summ = model.selected_model.summary
    kept = {f: 0 for f in FAMILIES}
    seen = {f: 0 for f in FAMILIES}
    for r in summ.validation_results:
        seen[r.model_name] += 1
        kept[r.model_name] += not r.raced_out
        if not r.raced_out:
            assert np.isfinite(r.metric_values["AuPR"])
    assert seen == {"OpLogisticRegression": 8, "OpRandomForestClassifier": 18,
                    "OpGBTClassifier": 18, "OpLinearSVC": 4}
    assert kept == {"OpLogisticRegression": 3, "OpRandomForestClassifier": 6,
                    "OpGBTClassifier": 6, "OpLinearSVC": 2}
    assert summ.best_model_name in FAMILIES
    secs = model.selected_model.selector_seconds
    assert set(FAMILIES) <= set(secs)
    pred = model.score()[model.result_features[0].name].values
    assert pred["prediction"].shape == (300,)
    assert bool(torch.isfinite(pred["rawPrediction"]).all())


def test_splitter_holdout_matches_jax():
    """A reserved test fraction takes the JAX package's rows: the same
    winner and holdout AuROC within 1e-4 on an LR-only grid."""
    X, y = _data(600, 5, seed=3)
    out = {}
    for pkg in ("transmogrifai_tpu", "transmogrifai_tpu_torch"):
        S = _mod(pkg, "selector")
        T = _mod(pkg, "tuning")
        LR = _mod(pkg, "models.linear").OpLogisticRegression
        model = _train(pkg, X, y, splitter=T.DataSplitter(
            seed=7, reserve_test_fraction=0.25), models=[S.ModelCandidate(
                LR(), S.grid(reg_param=[0.01, 0.1], max_iter=[50]),
                "OpLogisticRegression")])
        summ = model.selected_model.summary.to_json()
        out[pkg] = (summ["bestModelName"],
                    summ["holdoutEvaluation"]["binEval"]["AuROC"],
                    summ["trainEvaluation"]["binEval"]["AuROC"])
    (jw, jh, jt), (pw, ph, pt) = out.values()
    assert pw == jw
    assert abs(ph - jh) <= 1e-4 and abs(pt - jt) <= 1e-4
