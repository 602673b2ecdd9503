"""Workflow-level cross-validation in the port against the JAX package, on
the CPU: ``dag.cut_dag`` gives the same (before, during, after) partitions
on the four shapes of ``tests/test_cut_dag.py`` (a ``LambdaTransformer``
where that file uses ``AliasTransformer`` or ``StandardScaler``, in both
packages), and a ``with_workflow_cv()`` train of the bench's dense
workflow (LR x4 + GBT over SanityChecker) gives the JAX package's winner,
per-candidate CV metrics and "racing disabled" record.  A leaky column,
nearly the label outside fold 0's validation rows and noise on them, makes
fold 0's SanityChecker drop it while a fit on all rows keeps it, so the
workflow-CV metrics differ from a selector-CV train's in both packages:
the refit happened.  Tolerances: partitions, winner and raced-out set
exact; LR CV metrics 1e-4; the GBT's no further from the JAX package's
than in a selector-CV train of the same rows (see its test)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
N, D = 400, 6


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _alias(pkg, feature, name):
    T = _mod(pkg, "types")
    lam = _mod(pkg, "stages.base").LambdaTransformer(
        lambda c: c, T.OPVector, name=name)
    return lam.set_input(feature).get_output()


def _lr_selector(pkg, label, vec, regs=(0.01,)):
    S = _mod(pkg, "selector")
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        _mod(pkg, "models.linear").OpLogisticRegression(),
        S.grid(reg_param=list(regs)), "LR")])
    sel.set_input(label, vec)
    return sel


def _shape(pkg, which):
    """(result features, selector) of one of the four shapes."""
    F = _mod(pkg, "features")
    label = F.FeatureBuilder.RealNN("y").as_response()
    preds = [F.FeatureBuilder.Real(f"x{j}").as_predictor() for j in range(4)]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(preds)
    if which == "interleaved":
        checked = label.sanity_check(fv, remove_bad_features=True)
        sel = _lr_selector(pkg, label, _alias(pkg, checked, "Alias"))
        return [sel.get_output()], sel
    if which == "non_label_estimator_before":
        scaled = _alias(pkg, fv, "Scaler")
        checked = label.sanity_check(scaled, remove_bad_features=True)
        sel = _lr_selector(pkg, label, checked)
        return [sel.get_output()], sel
    if which == "side_branch":
        checked = label.sanity_check(fv, remove_bad_features=True)
        side2 = _alias(pkg, _alias(pkg, checked, "Side1"), "Side2")
        sel = _lr_selector(pkg, label, checked)
        return [sel.get_output(), side2], sel
    checked = label.sanity_check(fv, remove_bad_features=True)
    sel = _lr_selector(pkg, label, _alias(pkg, checked, "Alias2"),
                       regs=(0.01, 0.1))
    return [sel.get_output()], sel


def _partitions(pkg, which):
    D_ = _mod(pkg, "dag")
    results, sel = _shape(pkg, which)
    parts = D_.cut_dag(D_.compute_dag(results), sel)
    return [[sorted(s.operation_name for s in layer) for layer in part]
            for part in parts]


@pytest.mark.parametrize("which", ["interleaved", "non_label_estimator_before",
                                   "side_branch", "two_points"])
def test_cut_dag_partitions_match_jax(which):
    ref, port = _partitions(JAX, which), _partitions(PORT, which)
    assert port == ref
    before, during, after = port
    names = lambda part: {n for layer in part for n in layer}  # noqa: E731
    assert "SanityChecker" in names(during)
    assert "SanityChecker" not in names(before)
    assert any("Selector" in n for n in names(after))
    if which == "non_label_estimator_before":
        assert names(during) == {"SanityChecker"}
        assert "Scaler" in names(before)
    if which == "side_branch":
        assert {"Side1", "Side2"} <= names(during) | names(after)
        assert not {"Side1", "Side2"} & names(before)


def test_cut_dag_without_a_selector_is_all_before():
    D_ = _mod(PORT, "dag")
    results, sel = _shape(PORT, "interleaved")
    dag = D_.compute_dag(results)
    assert D_.cut_dag(dag, object()) == (dag, [], [])


# -- a workflow-CV train ---------------------------------------------------------

def _leaky_data(seed=0):
    """The dense slice's rows plus a leaky last column: y + small noise on
    the rows outside fold 0's validation slice, noise on that slice."""
    from transmogrifai_tpu_torch.tuning import OpCrossValidation
    from test_torch_workflow import _data
    X, y = _data(seed)
    rng = np.random.default_rng(seed + 1)
    leak = (y + 0.05 * rng.normal(size=N)).astype(np.float32)
    (_, va0), *_ = OpCrossValidation(3).splits(y.astype(np.float64))
    leak[va0] = rng.normal(size=len(va0)).astype(np.float32)
    return np.concatenate([X, leak[:, None]], axis=1), y


def _train(pkg, workflow_cv, racing=True, seed=0):
    X, y = _leaky_data(seed)
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor()
             for i in range(X.shape[1])]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    checked = label.sanity_check(fv, remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(models=[
        S.ModelCandidate(_mod(pkg, "models.linear").OpLogisticRegression(),
                         S.grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                                elastic_net_param=[0.1], max_iter=[50]),
                         "OpLogisticRegression"),
        S.ModelCandidate(_mod(pkg, "models.trees").OpGBTClassifier(),
                         S.grid(max_iter=[3], max_depth=[2],
                                min_instances_per_node=[10]),
                         "OpGBTClassifier")])
    sel.validator.racing = racing
    sel.set_input(label, checked)
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(X.shape[1]):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(
        C.ColumnBatch(cols, N)).set_result_features(sel.get_output())
    if workflow_cv:
        wf.with_workflow_cv()
    return wf.train()


def _vr(model):
    return [(r.model_name, r.params, r.metric_values["AuPR"], r.raced_out)
            for r in model.selected_model.summary.validation_results]


@pytest.fixture(scope="module")
def runs():
    return {(pkg, cv): _train(pkg, cv)
            for pkg in (JAX, PORT) for cv in (True, False)}


def test_workflow_cv_train_matches_jax(runs):
    """LR points within 1e-4.  The GBT point's CV AuPR parts from the JAX
    package's by 1.94e-4 in a plain selector-CV train of these rows too
    (fold 0's trees split on the leaky column, which separates its training
    rows: the saturated f32 scores tie differently), so the workflow-CV
    train is held to add nothing to that gap."""
    ref, port = runs[(JAX, True)], runs[(PORT, True)]
    rs, ps = _vr(ref), _vr(port)
    assert [(n, p, r) for n, p, _, r in ps] == [(n, p, r) for n, p, _, r in rs]
    assert not any(r for *_, r in ps)           # in-fold sweeps run unraced
    assert np.isfinite([m for _, _, m, _ in ps]).all()
    lr = [i for i, (n, *_) in enumerate(ps) if n == "OpLogisticRegression"]
    np.testing.assert_allclose([ps[i][2] for i in lr], [rs[i][2] for i in lr],
                               rtol=0, atol=1e-4)
    plain = {pkg: dict(((n, str(p)), m) for n, p, m, _ in
                       _vr(runs[(pkg, False)])) for pkg in (JAX, PORT)}
    for i, (n, p, m, _) in enumerate(ps):
        if n == "OpGBTClassifier":
            k = (n, str(p))
            gap = abs(plain[PORT][k] - plain[JAX][k])
            assert abs(m - rs[i][2]) <= gap + 1e-6
    assert (port.selected_model.summary.best_model_name
            == ref.selected_model.summary.best_model_name)


def test_racing_disabled_is_recorded_degraded_in_both(runs):
    for pkg in (JAX, PORT):
        notes = [e for e in runs[(pkg, True)].failure_log
                 if e.action == "degraded" and e.point == "selector.racing"]
        assert len(notes) == 1 and "in-fold" in notes[0].cause
        assert not [e for e in runs[(pkg, False)].failure_log
                    if e.point == "selector.racing"]


def test_the_refit_moves_the_cv_metrics_in_both(runs):
    """Selector CV scores fold 0 with the leaky column fit on its training
    rows; workflow CV drops it there.  The unraced points of both trains
    differ, and by the same amount in both packages."""
    deltas = {}
    for pkg in (JAX, PORT):
        wcv = {(n, str(p)): m for n, p, m, r in _vr(runs[(pkg, True)])}
        scv = {(n, str(p)): m for n, p, m, r in _vr(runs[(pkg, False)])
               if not r}
        deltas[pkg] = [wcv[k] - scv[k] for k in sorted(scv)]
        assert max(abs(d) for d in deltas[pkg]) > 1e-3
    np.testing.assert_allclose(deltas[PORT], deltas[JAX], rtol=0, atol=2e-4)


def test_the_final_model_keeps_the_full_data_sanity_checker(runs):
    """The final model's SanityChecker is the one fit on all rows (it keeps
    the leaky column), in both packages."""
    kept = {}
    for pkg in (JAX, PORT):
        m = runs[(pkg, True)]
        sc = next(s for s in m.stages
                  if type(s).__name__ == "SanityCheckerModel")
        kept[pkg] = sorted(int(i) for i in np.asarray(
            sc.fitted["indices_to_keep"]))
    assert kept[PORT] == kept[JAX]
    assert len(kept[PORT]) == D + 1


def test_workflow_cv_side_branch_shape_trains_and_scores():
    """The side-branch shape end to end in the port: the side columns are
    made after their producer, and the model scores every row."""
    C, TY = _mod(PORT, "columns"), _mod(PORT, "types")
    results, sel = _shape(PORT, "side_branch")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    cols = {"y": C.Column(TY.RealNN, y)}
    for j in range(4):
        cols[f"x{j}"] = C.Column(TY.Real, X[:, j], np.ones(300, bool))
    wf = (_mod(PORT, "workflow").Workflow(device="cpu")
          .set_input_batch(C.ColumnBatch(cols, 300))
          .set_result_features(*results).with_workflow_cv())
    model = wf.train()
    scored = model.score()
    assert len(scored[results[0].name].values["prediction"]) == 300
    assert results[1].name in scored
