"""The binary selector ranked by Precision, Recall, F1 and Error, against
the JAX package on the CPU: the dense binary workload of
``test_torch_workflow.py`` (400 x 6 RealNN, transmogrify, sanity check, 3-fold
CV with racing) with the logistic-regression grid, and with a LinearSVC grid
beside it, so that the SVC's ``margin > 0`` prediction is what is counted
(its score panel is the margin itself, not a probability).  Tolerances: the
winner and the raced-out set exact, each candidate's CV metric within 1e-4
(the workflow file's LR tolerance); the panels' counts are integers, so the
confusion metrics agree exactly where the predictions do.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

N, D = 400, 6
METRICS = ("precision", "recall", "f1", "error")


def _data(seed=0):
    """``test_torch_workflow._data``: a nonlinear logit with noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32) / np.sqrt(D)
    logits = (X @ w + 0.35 * (X[:, 0] * X[:, 1]) - 0.25 * (X[:, 2] ** 2)
              + 0.1 + 0.3 * np.sin(2 * X[:, 3]))
    y = (logits + rng.normal(size=N).astype(np.float32) > 0).astype(np.float32)
    return X, y


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _train(pkg, metric: str, svc: bool):
    X, y = _data()
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    lin = _mod(pkg, "models.linear")
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    checked = label.sanity_check(fv, remove_bad_features=True)
    models = [S.ModelCandidate(
        lin.OpLogisticRegression(),
        S.grid(reg_param=[0.001, 0.01, 0.1, 0.2], elastic_net_param=[0.1],
               max_iter=[50]), "OpLogisticRegression")]
    if svc:
        models.append(S.ModelCandidate(
            lin.OpLinearSVC(), S.grid(reg_param=[0.01, 0.1], max_iter=[50]),
            "OpLinearSVC"))
    ev = getattr(_mod(pkg, "evaluators").Evaluators.BinaryClassification,
                 metric)()
    sel = S.BinaryClassificationModelSelector(models=models,
                                              validation_metric=ev)
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    kw = {"device": "cpu"} if pkg == "transmogrifai_tpu_torch" else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(
        C.ColumnBatch(cols, N))
    summary = wf.set_result_features(pred).train().selected_model.summary
    name = ev.default_metric
    return (summary.best_model_name,
            [(r.model_name, r.params, r.metric_values[name], r.raced_out)
             for r in summary.validation_results])


def _assert_same(metric: str, svc: bool):
    ref = _train("transmogrifai_tpu", metric, svc)
    port = _train("transmogrifai_tpu_torch", metric, svc)
    assert port[0] == ref[0]
    assert ([(n, p, r) for n, p, _, r in port[1]]
            == [(n, p, r) for n, p, _, r in ref[1]])
    np.testing.assert_allclose([m for _, _, m, _ in port[1]],
                               [m for _, _, m, _ in ref[1]], rtol=0,
                               atol=1e-4)
    return port


@pytest.mark.parametrize("metric", METRICS)
def test_lr_grid_ranked_by_confusion_metric_matches_jax(metric):
    port = _assert_same(metric, svc=False)
    assert all(np.isfinite(m) for _, _, m, _ in port[1])


def test_svc_in_the_grid_counts_its_margin_prediction():
    """With LinearSVC beside the LR grid, ranked by F1: the SVC's CV F1 is
    that of ``margin > 0`` (the JAX package's), not of a 0.5 cut of its
    margin, and the winner is the JAX package's."""
    port = _assert_same("f1", svc=True)
    assert any(n == "OpLinearSVC" for n, *_ in port[1])


def test_error_is_smaller_is_better_and_zero_guards_hold():
    """Error ranks smaller-is-better; the confusion panel's 0-when-empty rules
    for precision, recall and F1, and Error over max(total weight, 1)."""
    from transmogrifai_tpu_torch import metrics_device as md
    from transmogrifai_tpu_torch.evaluators import Evaluators
    assert not Evaluators.BinaryClassification.error().is_larger_better
    for m in ("precision", "recall", "f1"):
        ev = getattr(Evaluators.BinaryClassification, m)()
        assert ev.is_larger_better and ev.grid_panel_input == "predictions"
    assert Evaluators.BinaryClassification.auPR().grid_panel_input == "scores"
    y = torch.tensor([1.0, 0.0, 1.0, 0.0])
    P = torch.tensor([[0, 1], [0, 1], [0, 0], [0, 0]], dtype=torch.int32)
    W = torch.tensor([1.0, 1.0, 1.0, 0.0])
    assert md.masked_binary_metric_grid(y, P, W, "Precision").tolist() \
        == [0.0, 0.5]
    assert md.masked_binary_metric_grid(y, P, W, "Recall").tolist() \
        == [0.0, 0.5]
    assert md.masked_binary_metric_grid(y, P, W, "F1").tolist() == [0.0, 0.5]
    assert md.masked_binary_metric_grid(
        y, P, W, "Error").tolist() == [2 / 3, 2 / 3]
    assert md.masked_binary_metric_grid(
        y, P, torch.zeros(4), "Error").tolist() == [0.0, 0.0]
    fold = md.masked_binary_metric_fold_grid(
        y, P[:, None, :], W[None, :], "F1")
    assert fold.shape == (1, 2) and fold.tolist() == [[0.0, 0.5]]
