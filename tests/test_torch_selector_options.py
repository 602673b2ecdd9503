"""The binary selector's ``model_types_to_use`` and
``use_train_validation_split`` / ``train_ratio`` in the port against the
JAX package, on the CPU, on ``tests/test_torch_workflow.py``'s 400 x 6
rows with LR x4 + GBT (3 rounds, depth 2).  Tolerances: the candidate set,
the validation type and parameters, the split and the winner exact; the
CV metrics within 1e-4 (the dense slice's tolerance); the unknown-type
``ValueError`` and the single split's "degraded" racing record as in the
JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

N, D = 400, 6
JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"


def _data(seed=0):
    """``tests/test_torch_workflow.py``'s ``_data``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32) / np.sqrt(D)
    logits = (X @ w + 0.35 * (X[:, 0] * X[:, 1]) - 0.25 * (X[:, 2] ** 2)
              + 0.1 + 0.3 * np.sin(2 * X[:, 3]))
    y = (logits + rng.normal(size=N).astype(np.float32) > 0).astype(np.float32)
    return X, y


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _models(pkg):
    S = _mod(pkg, "selector")
    return [S.ModelCandidate(
                _mod(pkg, "models.linear").OpLogisticRegression(),
                S.grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                       elastic_net_param=[0.1], max_iter=[50]),
                "OpLogisticRegression"),
            S.ModelCandidate(
                _mod(pkg, "models.trees").OpGBTClassifier(),
                S.grid(max_iter=[3], max_depth=[2],
                       min_instances_per_node=[10]),
                "OpGBTClassifier")]


def _train(pkg, **sel_kw):
    X, y = _data(0)
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    checked = label.sanity_check(fv, remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(models=_models(pkg), **sel_kw)
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(
        C.ColumnBatch(cols, N))
    model = wf.set_result_features(pred).train()
    return model, sel


def _summary(model):
    return model.selected_model.summary


def _results(model):
    return [(r.model_name, r.params, r.metric_values["AuPR"])
            for r in _summary(model).validation_results]


OPTIONS = {
    "gbt only": dict(model_types_to_use=["OpGBTClassifier"]),
    "lr only": dict(model_types_to_use=["OpLogisticRegression"]),
    "tvs": dict(use_train_validation_split=True),
    "tvs 0.6 lr": dict(use_train_validation_split=True, train_ratio=0.6,
                       model_types_to_use=["OpLogisticRegression"]),
}


@pytest.fixture(scope="module")
def runs():
    return {(pkg, name): _train(pkg, **kw)
            for name, kw in OPTIONS.items() for pkg in (JAX, PORT)}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_candidates_validation_and_winner_match_jax(runs, name):
    (ref, _), (port, _) = runs[(JAX, name)], runs[(PORT, name)]
    rs, ps = _results(ref), _results(port)
    assert [(n, p) for n, p, _ in ps] == [(n, p) for n, p, _ in rs]
    np.testing.assert_allclose([m for *_, m in ps], [m for *_, m in rs],
                               rtol=0, atol=1e-4)
    js, pj = _summary(ref), _summary(port)
    assert pj.validation_type == js.validation_type
    assert pj.best_model_name == js.best_model_name
    want = OPTIONS[name]
    if "model_types_to_use" in want:
        assert {n for n, *_ in ps} == set(want["model_types_to_use"])
    vp = pj.validation_parameters
    if want.get("use_train_validation_split"):
        assert pj.validation_type == "TrainValidationSplit"
        assert vp["trainRatio"] == want.get("train_ratio", 0.75)
        assert "numFolds" not in vp
        assert js.validation_parameters["trainRatio"] == vp["trainRatio"]
    else:
        assert pj.validation_type == "CrossValidation"
        assert vp["numFolds"] == 3 and "trainRatio" not in vp


def test_gbt_only_leaves_one_candidate_and_a_gbt_winner(runs):
    port, _ = runs[(PORT, "gbt only")]
    assert len(_results(port)) == 1
    assert _summary(port).best_model_name == "OpGBTClassifier"


@pytest.mark.parametrize("ratio", [0.75, 0.6, 0.5])
@pytest.mark.parametrize("stratify", [False, True])
def test_train_validation_split_matches_jax(ratio, stratify):
    from transmogrifai_tpu.tuning import OpTrainValidationSplit as J
    from transmogrifai_tpu_torch.tuning import OpTrainValidationSplit as P
    _, y = _data()
    (jtr, jva), = J(ratio, stratify=stratify).splits(y)
    (ptr, pva), = P(ratio, stratify=stratify).splits(y)
    np.testing.assert_array_equal(ptr, jtr)
    np.testing.assert_array_equal(pva, jva)
    assert len(ptr) == int(round(N * ratio))


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_unknown_model_type_raises(pkg):
    S = _mod(pkg, "selector")
    with pytest.raises(ValueError, match="NoSuchModel") as e:
        S.BinaryClassificationModelSelector(
            models=_models(pkg), model_types_to_use=["NoSuchModel"])
    assert "OpGBTClassifier" in str(e.value)


def test_single_split_is_recorded_degraded_in_both(runs):
    for pkg in (JAX, PORT):
        model, _ = runs[(pkg, "tvs")]
        notes = [e for e in model.failure_log
                 if e.action == "degraded" and e.point == "selector.racing"]
        assert len(notes) == 1 and "single" in notes[0].cause
        model, _ = runs[(pkg, "gbt only")]
        assert not [e for e in model.failure_log
                    if e.point == "selector.racing"]


def test_selector_keeps_every_family_without_the_option():
    sel = _mod(PORT, "selector").BinaryClassificationModelSelector()
    assert [c.model_name for c in sel.models] == [
        "OpLogisticRegression", "OpRandomForestClassifier", "OpGBTClassifier",
        "OpLinearSVC"]
    assert type(sel.validator).__name__ == "OpCrossValidation"
