"""The train-time quality screen in the port against the JAX package, on the
CPU: the bench's dense workflow (400 x 6, LR x4 + GBT, 3-fold CV with
racing; ``test_torch_workflow._build``) trained from an input batch that
holds NaN or ±inf at present positions of its numeric columns.  Both
packages resolve ``QualityConfig`` from ``parameters["quality"]`` (enabled
with policy ``coerce`` by default) and drop the same rows before the fit,
with the same "quarantined" event; past ``maxQuarantineFraction`` both raise
``DataQualityError`` with the same counts.  Tolerances: dropped rows, the
event, the raced-out set and the winner exact; per-candidate CV metrics
1e-4 (the dense slice's tolerance)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_workflow import _build, _data  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"


def _poisoned(rows_cols_values):
    X, y = _data()
    X = X.copy()
    for r, c, v in rows_cols_values:
        X[r, c] = v
    return X, y


def _train(pkg, X, y, params=None):
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf, batch, pred = _build(pkg, X, y, **kw)
    if params is not None:
        wf.set_parameters(params)
    return wf.train()


def _results(model):
    return [(r.model_name, r.params, r.metric_values["AuPR"], r.raced_out)
            for r in model.selected_model.summary.validation_results]


def _quarantined(model):
    return [(e.stage, e.action, e.point, e.detail.get("rows"))
            for e in model.failure_log if e.action == "quarantined"]


PROBE = [(5, 2, np.inf), (17, 0, np.nan)]


@pytest.fixture(scope="module")
def probe_runs():
    X, y = _poisoned(PROBE)
    return _train(JAX, X, y), _train(PORT, X, y)


def test_probe_drops_the_same_rows_with_the_same_event(probe_runs):
    ref, port = probe_runs
    assert _quarantined(ref) == [("train", "quarantined", "train.quality",
                                  [5, 17])]
    assert _quarantined(port) == _quarantined(ref)


def test_probe_cv_metrics_and_winner_match_jax(probe_runs):
    ref, port = probe_runs
    rs, ps = _results(ref), _results(port)
    assert [(n, p, r) for n, p, _, r in ps] == [(n, p, r) for n, p, _, r in rs]
    np.testing.assert_allclose([m for _, _, m, _ in ps],
                               [m for _, _, m, _ in rs], rtol=0, atol=1e-4)
    assert (port.selected_model.summary.best_model_name
            == ref.selected_model.summary.best_model_name)


def test_probe_matches_a_train_on_the_clean_rows(probe_runs):
    """What the screen leaves is what a train on the 398 finite rows sees:
    the port's CV metrics equal that train's."""
    _, port = probe_runs
    X, y = _poisoned(PROBE)
    keep = np.setdiff1d(np.arange(len(y)), [5, 17])
    C, TY = (__import__(f"{PORT}.{m}", fromlist=["_"])
             for m in ("columns", "types"))
    wf, _, _ = _build(PORT, X, y, device="cpu")
    cols = {"label": C.Column(TY.RealNN, y[keep])}
    for i in range(X.shape[1]):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[keep, i])
    clean = wf.set_input_batch(C.ColumnBatch(cols, len(keep))).train()
    assert not _quarantined(clean)
    assert [m for _, _, m, _ in _results(clean)] == \
        [m for _, _, m, _ in _results(port)]


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_past_the_quarantine_fraction_raises_the_same_counts(pkg):
    rng = np.random.default_rng(3)
    rows = rng.choice(400, size=80, replace=False)
    X, y = _poisoned([(int(r), int(r) % 6, np.inf if r % 2 else np.nan)
                      for r in rows])
    DQ = __import__(f"{pkg}.quality", fromlist=["_"]).DataQualityError
    with pytest.raises(DQ) as ei:
        _train(pkg, X, y)
    assert (ei.value.quarantined, ei.value.total) == (80, 400)
    assert ei.value.fraction == pytest.approx(0.2)
    assert ei.value.limit == pytest.approx(0.1)
    assert {v.kind for v in ei.value.sample} == {"NonFiniteValue"}


@pytest.mark.parametrize("params", [{"quality": {"enabled": False}},
                                    {"quality": {"policy": "off"}}])
def test_a_disabled_screen_trains_on_every_row_in_both(params):
    """With the screen off neither package drops a row or logs one; both
    then train on the non-finite value (the folds and the winner agree;
    the metrics follow each package's handling of inf in its solvers, so
    only their finiteness is held)."""
    X, y = _poisoned([(5, 2, np.inf)])
    runs = {pkg: _train(pkg, X, y, params) for pkg in (JAX, PORT)}
    for m in runs.values():
        assert not _quarantined(m)
        assert m.parameters == params
    ref, port = runs[JAX], runs[PORT]
    assert [(n, p) for n, p, _, _ in _results(port)] == \
        [(n, p) for n, p, _, _ in _results(ref)]


def test_policy_quarantine_screens_like_coerce_in_both():
    X, y = _poisoned(PROBE)
    params = {"quality": {"policy": "quarantine",
                          "maxQuarantineFraction": 0.5}}
    ref, port = (_train(pkg, X, y, params) for pkg in (JAX, PORT))
    assert _quarantined(port) == _quarantined(ref) == [
        ("train", "quarantined", "train.quality", [5, 17])]


def test_parameters_reach_the_model_and_its_bundle(tmp_path):
    X, y = _data()
    params = {"quality": {"maxQuarantineFraction": 0.25}}
    m = _train(PORT, X, y, params)
    assert m.parameters == params
    m.save(str(tmp_path / "b"))
    from transmogrifai_tpu.workflow import WorkflowModel as JWM
    from transmogrifai_tpu_torch.workflow import WorkflowModel as PWM
    assert PWM.load(str(tmp_path / "b"), device="cpu").parameters == params
    assert JWM.load(str(tmp_path / "b")).parameters == params
