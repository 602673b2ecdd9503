"""Parity of the PyTorch port's multiclass family with the JAX package, on
the CPU.

On a CPU tensor every kernel wrapper runs its plain-PyTorch twin, so these
tests hold the ``fista_softmax`` twin (the multinomial FISTA gradient), the
softmax grid fit, naive Bayes, the MLP's training loop, the
``multiclass_confusion`` twin and the multiclass panels, the evaluator,
``DataCutter``, the multinomial prediction grid, the
``MultiClassificationModelSelector`` on iris, ``convert`` and the
insights against the JAX package on the same numpy inputs, and both
kernels' launch plans.

Tolerances: the softmax gradient within 1e-6 of its scale (f32, another
order); FISTA coefficients within 1e-4 of max |coef|, ``n_iter`` within 2
with at most 2 lanes apart (lanes stop 1-2 iterations apart between f32
orders); naive Bayes logits rtol 1e-6 and its probabilities within 1e-6 of the
logits' scale, converted scores 1e-6; the MLP's weights after 30
Adam steps within 1e-4 (autograd against ``jax.grad``, another f32 order)
with equal predictions; confusion matrices and f32 panel metrics within
1e-6 (in fact equal: the port sums the classes in XLA's order); evaluator
panels, ``DataCutter`` and the prediction grid equal; iris CV F1 of the
linear candidates and naive Bayes equal (or each difference traced to a
row whose two top JAX margins lie within 1e-4), the forest's within
``IRIS_RF_TOL``, refit coefficients within 1e-3 of max |coef|.
"""

import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu import metrics_device as jmd  # noqa: E402
from transmogrifai_tpu.models import solvers as js  # noqa: E402
from transmogrifai_tpu_torch import metrics_device as pmd  # noqa: E402
from transmogrifai_tpu_torch import metrics_kernels as mk  # noqa: E402
from transmogrifai_tpu_torch.models import linear_kernels as lk  # noqa: E402
from transmogrifai_tpu_torch.models import solvers as ps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import multiclass_grid_reference as mgr  # noqa: E402

CPU = torch.device("cpu")
JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
# 3 x the JAX package's spread of the iris compact grid's forest CV F1 over
# RF seeds 42, 0, 1, 2, 3 (`PYTHONPATH=. JAX_PLATFORMS=cpu python
# scripts/multiclass_grid_reference.py --package jax --data iris --grid
# compact --rf-seeds 42,0,1,2,3`)
IRIS_RF_TOL = 0.0401            # 3 x 0.013345


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _blobs(n, d, C, seed=0, spread=1.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, d)) * spread
    y = rng.integers(0, C, n)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return X, y.astype(np.float32)


# --------------------------------------------------------------------------
# K4m: the softmax gradient and the multinomial grid fit
# --------------------------------------------------------------------------

def test_softmax_gradient_matches_jax():
    """One lane's row gradients and (Xᵀg, Σg) of the twin against
    ``_softmax_loss_grad`` on the same margins."""
    X, y = _blobs(500, 7, 4)
    rng = np.random.default_rng(1)
    V = rng.normal(scale=0.4, size=(1, 4, 7)).astype(np.float32)
    b = rng.normal(scale=0.2, size=(1, 4)).astype(np.float32)
    w = (rng.random(500) > 0.3).astype(np.float32)
    logits = X @ V[0].T + b[0]
    yoh = np.eye(4, dtype=np.float32)[y.astype(int)]
    _, want = js._softmax_loss_grad(jnp.asarray(logits), jnp.asarray(yoh),
                                    jnp.asarray(w))
    want = np.asarray(want)
    args = (torch.as_tensor(X), torch.as_tensor(V), torch.zeros((1, 4)),
            torch.as_tensor(b), torch.as_tensor(w[None]),
            torch.as_tensor(y).to(torch.int32),
            torch.as_tensor(w.sum()[None]), 1)
    g = lk.fista_softmax_row_grads(*args)[0].T.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(g, want, atol=1e-6 * scale)
    gx, gs = lk.fista_softmax_step(*args)
    mass = np.abs(want).T @ np.abs(X)
    assert (np.abs(gx[0].numpy() - want.T @ X) <= 1e-5 * mass).all()
    np.testing.assert_allclose(gs[0].numpy(), want.sum(0), atol=1e-6)


@pytest.mark.parametrize("C", [3, 5])
def test_linear_grid_fit_softmax_matches_jax(C):
    X, y = _blobs(600, 6, C, seed=C)
    rng = np.random.default_rng(C)
    W = (rng.random((2, 600)) > 0.3).astype(np.float32)
    l2 = np.array([0.01, 0.1], np.float32)
    l1 = np.array([0.001, 0.02], np.float32)
    rj = js.linear_grid_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                            jnp.asarray(l2), jnp.asarray(l1), loss="softmax",
                            n_classes=C, max_iter=50)
    rp = ps.linear_grid_fit(torch.as_tensor(X), torch.as_tensor(y),
                            torch.as_tensor(W), torch.as_tensor(l2),
                            torch.as_tensor(l1), loss="softmax", n_classes=C,
                            max_iter=50)
    cj = np.asarray(rj.coef)
    assert rp.coef.shape == cj.shape == (2, 2, 6, C)
    assert rp.intercept.shape == (2, 2, C)
    scale = np.abs(cj).max()
    np.testing.assert_allclose(rp.coef.numpy(), cj, atol=1e-4 * scale)
    np.testing.assert_allclose(rp.intercept.numpy(), np.asarray(rj.intercept),
                               atol=1e-4 * scale)
    nj, np_ = np.asarray(rj.n_iter).ravel(), rp.n_iter.numpy().ravel()
    assert np.abs(nj - np_).max() <= 2 and (nj != np_).sum() <= 2


def test_softmax_loop_freezes_lanes_and_unscales_like_jax():
    """A lane that meets its tolerance keeps its state; the C > 1 form of
    ``unscale_params`` is the JAX package's."""
    X, y = _blobs(300, 4, 3, seed=7, spread=4.0)
    res = ps.linear_grid_fit(torch.as_tensor(X), torch.as_tensor(y),
                             torch.ones((1, 300)), torch.tensor([1.0]),
                             torch.tensor([0.0]), loss="softmax",
                             n_classes=3, max_iter=500, tol=1e-3)
    assert int(res.n_iter[0, 0]) < 500
    rng = np.random.default_rng(3)
    coef = rng.normal(size=(4, 3)).astype(np.float32)
    inter = rng.normal(size=3).astype(np.float32)
    mean = rng.normal(size=4).astype(np.float32)
    scale = rng.random(4).astype(np.float32) + 0.5
    want = js.unscale_params(js.FitResult(jnp.asarray(coef),
                                          jnp.asarray(inter), 0, 0),
                             jnp.asarray(mean), jnp.asarray(scale), 3)
    c, i = ps.unscale_params(torch.as_tensor(coef), torch.as_tensor(inter),
                             torch.as_tensor(mean), torch.as_tensor(scale), 3)
    np.testing.assert_allclose(c.numpy(), np.asarray(want.coef), rtol=1e-6)
    np.testing.assert_allclose(i.numpy(), np.asarray(want.intercept),
                               rtol=1e-6, atol=1e-6)


def test_sparse_multinomial_is_refused_for_the_skip_seam():
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    X, y = _blobs(40, 3, 3)
    Xs = SparseMatrix.from_dense(torch.as_tensor(X), device="cpu")
    with pytest.raises(TypeError, match="sparse multinomial"):
        OpLogisticRegression().fit_arrays_grid(Xs, y, np.ones((1, 40)),
                                               [{}], device="cpu")


# --------------------------------------------------------------------------
# naive Bayes and the MLP
# --------------------------------------------------------------------------

def test_naive_bayes_fit_and_scores_match_jax():
    from transmogrifai_tpu.models import linear as jl
    from transmogrifai_tpu_torch.models import linear as pl
    X, y = _blobs(400, 5, 4, seed=2)
    X = np.abs(X)
    w = (np.random.default_rng(2).random(400) > 0.2).astype(np.float32)
    jp, jq = js.naive_bayes_fit(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(w), jnp.float32(1.0), n_classes=4)
    pp, pq = ps.naive_bayes_fit(torch.as_tensor(X), torch.as_tensor(y),
                                torch.as_tensor(w), 1.0, n_classes=4)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-6)
    jf = jl.OpNaiveBayes().fit_arrays(X, y, w)
    pf = pl.OpNaiveBayes().fit_arrays(X, y, w, device="cpu")
    want = jl.NaiveBayesModel(fitted=jf).device_scores(jnp.asarray(X),
                                                       full=True)
    got = pl.NaiveBayesModel(fitted=pf).device_scores(torch.as_tensor(X),
                                                      full=True)
    # logits rtol 1e-6; a probability moves by at most the logits' error,
    # 1e-6 of their scale (sums over 5 features in another f32 order)
    logits = np.asarray(want["rawPrediction"])
    np.testing.assert_allclose(got["rawPrediction"].numpy(), logits,
                               rtol=1e-6)
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]),
                               atol=1e-6 * np.abs(logits).max())
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))


def _jax_mlp_init(sizes, seed):
    """The JAX package's initial weights (linear.py:583-589), rebuilt."""
    key = jax.random.PRNGKey(seed)
    params = []
    for i in range(len(sizes) - 1):
        key, k1 = jax.random.split(key)
        W = jax.random.normal(k1, (sizes[i], sizes[i + 1]),
                              jnp.float32) * jnp.sqrt(2.0 / sizes[i])
        params.append((np.array(W), np.zeros(sizes[i + 1], np.float32)))
    return params


def test_mlp_train_from_jax_init_matches_optax():
    from transmogrifai_tpu.models import linear as jl
    from transmogrifai_tpu_torch.models import linear as pl
    X, y = mgr.iris()
    seed = 3
    jf = jl.OpMultilayerPerceptronClassifier(
        hidden_layers=(8,), max_iter=30, seed=seed).fit_arrays(X, y)
    init = _jax_mlp_init([4, 8, 3], seed)
    got = pl.mlp_train([(torch.as_tensor(W), torch.as_tensor(b))
                        for W, b in init], torch.as_tensor(X),
                       torch.as_tensor(y), torch.ones(150), 30, 0.05)
    for i, (W, b) in enumerate(got):
        np.testing.assert_allclose(W.numpy(), jf[f"W{i}"], atol=1e-4)
        np.testing.assert_allclose(b.numpy(), jf[f"b{i}"], atol=1e-4)
    fitted = {"n_layers": 2, "W0": got[0][0], "b0": got[0][1],
              "W1": got[1][0], "b1": got[1][1]}
    want = jl.MLPClassificationModel(fitted=jf).device_scores(jnp.asarray(X))
    out = pl.MLPClassificationModel(fitted=fitted).device_scores(
        torch.as_tensor(X))
    np.testing.assert_array_equal(out["prediction"].numpy(),
                                  np.asarray(want["prediction"]))
    # the port's own fit: its seeded init, then the same loop
    est = pl.OpMultilayerPerceptronClassifier(hidden_layers=(8,),
                                              max_iter=30, seed=seed)
    pf = est.fit_arrays(X, y, device="cpu")
    again = pl.mlp_train(est.init_params(4, 3, CPU), torch.as_tensor(X),
                         torch.as_tensor(y), torch.ones(150), 30, 0.05)
    assert torch.equal(pf["W0"], again[0][0])
    assert pf["kind"] == "mlp" and pf["n_classes"] == 3
    init0 = est.init_params(4, 3, CPU)[0][0]
    assert abs(float(init0.std()) - (2.0 / 4) ** 0.5) < 0.35


# --------------------------------------------------------------------------
# K5m: the confusion kernel's twin, the panels and the evaluator
# --------------------------------------------------------------------------

def _panel_inputs(seed=0, n=400, C=5, K=6):
    """Labels with class 4 absent, predictions of K candidates, fold masks
    with fold 2 empty."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C - 1, n)
    P = np.where(rng.random((n, K)) < 0.7, y[:, None],
                 rng.integers(0, C - 1, (n, K))).astype(np.int32)
    W = (rng.random((3, n)) < 0.5).astype(np.float32)
    W[2] = 0.0
    return y.astype(np.float32), P, W


def test_confusion_twin_matches_jax():
    y, P, W = _panel_inputs()
    for k in range(P.shape[1]):
        want = np.asarray(jmd.masked_multiclass_confusion(
            jnp.asarray(y), jnp.asarray(P[:, k]), jnp.asarray(W[0]),
            n_classes=5))
        got = pmd.masked_multiclass_confusion(
            torch.as_tensor(y), torch.as_tensor(P[:, k]),
            torch.as_tensor(W[0]), n_classes=5)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    conf = mk.multiclass_confusion(torch.as_tensor(y).to(torch.int32),
                                   torch.as_tensor(P), torch.as_tensor(W), 2,
                                   5)
    assert conf.shape == (6, 5, 5)
    assert float(conf[4:].sum()) == 0.0          # fold 2 is empty
    assert float(conf[:, 4].sum()) == 0.0        # class 4 never a label


@pytest.mark.parametrize("metric", ["Precision", "Recall", "F1", "Error"])
def test_multiclass_panels_match_jax(metric):
    y, P, W = _panel_inputs(seed=1)
    n, K = P.shape
    kw = dict(n_classes=5, metric=metric)
    want = np.asarray(jmd.masked_multiclass_metric_grid(
        jnp.asarray(y), jnp.asarray(P), jnp.asarray(W[0]), **kw))
    got = pmd.masked_multiclass_metric_grid(
        torch.as_tensor(y), torch.as_tensor(P), torch.as_tensor(W[0]), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    Wk = W[np.arange(K) % 3]
    want = np.asarray(jmd.masked_multiclass_metric_grid(
        jnp.asarray(y), jnp.asarray(P), jnp.asarray(Wk), **kw))
    got = pmd.masked_multiclass_metric_grid(
        torch.as_tensor(y), torch.as_tensor(P), torch.as_tensor(Wk), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    want = np.asarray(jmd.masked_multiclass_metric_fold_grid(
        jnp.asarray(y), jnp.asarray(P.reshape(n, 3, 2)), jnp.asarray(W),
        **kw))
    got = pmd.masked_multiclass_metric_fold_grid(
        torch.as_tensor(y), torch.as_tensor(P.reshape(n, 3, 2)),
        torch.as_tensor(W), **kw)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _tied_scores(n=300, C=4, seed=5):
    """Labels, predictions and forest-like probabilities with many ties
    (shares of 10 trees)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n)
    votes = rng.multinomial(10, np.full(C, 1.0 / C), size=n)
    votes[np.arange(n), y] += rng.integers(0, 6, n)
    prob = (votes / votes.sum(1, keepdims=True)).astype(np.float32)
    pred = np.argmax(prob, 1).astype(np.float32)
    return y.astype(np.float32), pred, prob


def test_evaluator_matches_jax_with_tied_probabilities():
    from transmogrifai_tpu import evaluators as je
    from transmogrifai_tpu_torch import evaluators as pe
    y, pred, prob = _tied_scores()
    w = np.ones_like(y)
    jev, pev = je.OpMultiClassificationEvaluator(), \
        pe.OpMultiClassificationEvaluator()
    want = jev.evaluate_all(y, {"prediction": pred, "probability": prob})
    got = pev.evaluate_all(y, {"prediction": pred, "probability": prob})
    assert got.to_json() == want.to_json()
    want = jev.evaluate_all_device(
        jnp.asarray(y), {"prediction": jnp.asarray(pred),
                         "probability": jnp.asarray(prob)}, jnp.asarray(w))
    got = pev.evaluate_all_device(
        torch.as_tensor(y), {"prediction": torch.as_tensor(pred),
                             "probability": torch.as_tensor(prob)},
        torch.as_tensor(w))
    assert got.to_json() == want.to_json()
    assert pev.name == "multiEval" and pev.grid_panel_input == "predictions"
    for m in ("Precision", "Recall", "F1", "Error"):
        ev = getattr(pe.Evaluators.MultiClassification, m.lower())()
        assert ev.default_metric == m
        assert ev.is_larger_better == (m != "Error")
        jv = getattr(je.Evaluators.MultiClassification, m.lower())()
        mask = (np.arange(len(y)) % 3 == 0).astype(np.float32)
        assert ev.evaluate_masked(
            torch.as_tensor(y), {"prediction": torch.as_tensor(pred)},
            torch.as_tensor(mask)) == jv.evaluate_masked(
            jnp.asarray(y), {"prediction": jnp.asarray(pred)},
            jnp.asarray(mask))


@pytest.mark.parametrize("kw", [{"min_label_fraction": 0.2},
                                {"max_label_categories": 2}])
def test_data_cutter_matches_jax(kw):
    rng = np.random.default_rng(4)
    y = rng.choice([0.0, 1.0, 2.0, 3.0], size=200, p=[0.4, 0.3, 0.22, 0.08])
    batches = {}
    for pkg in (JAX, PORT):
        C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
        bkw = {"device": "cpu"} if pkg == PORT else {}
        batches[pkg] = C.ColumnBatch(
            {"label": C.Column(TY.RealNN, y.astype(np.float32)),
             "x": C.Column(TY.RealNN, np.arange(200, dtype=np.float32))},
            200, **bkw)
    cut = {pkg: _mod(pkg, "tuning").DataCutter(**kw) for pkg in (JAX, PORT)}
    for pkg in (JAX, PORT):
        cut[pkg].pre_validation_prepare(batches[pkg], "label")
    j, p = cut[JAX], cut[PORT]
    assert p.labels_kept == j.labels_kept and p.labels_dropped == \
        j.labels_dropped and p.labels_dropped
    assert p.summary.info == j.summary.info
    w = rng.random(200).astype(np.float32)
    np.testing.assert_array_equal(p.validation_prepare_weights(y, w),
                                  j.validation_prepare_weights(y, w))
    kept_j = j.validation_prepare(batches[JAX], "label")
    kept_p = p.validation_prepare(batches[PORT], "label")
    np.testing.assert_array_equal(np.asarray(kept_p["x"].values),
                                  np.asarray(kept_j["x"].values))


def test_multinomial_pred_grid_matches_jax():
    from transmogrifai_tpu import tuning as jt
    from transmogrifai_tpu_torch import tuning as pt
    rng = np.random.default_rng(6)
    X = rng.normal(size=(500, 7)).astype(np.float32)
    C3 = rng.normal(size=(6, 7, 4)).astype(np.float32)
    B = rng.normal(size=(6, 4)).astype(np.float32)
    want = np.asarray(jt._multinomial_pred_grid(jnp.asarray(X),
                                                jnp.asarray(C3),
                                                jnp.asarray(B)))
    got = pt._multinomial_pred_grid(torch.as_tensor(X), torch.as_tensor(C3),
                                    torch.as_tensor(B))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the selector on iris, with a label dropped, and on the bench data
# --------------------------------------------------------------------------

def _nb_candidate(pkg):
    S, lin = _mod(pkg, "selector"), _mod(pkg, "models.linear")
    return S.ModelCandidate(lin.OpNaiveBayes(), [{}], "OpNaiveBayes")


@pytest.fixture(scope="module")
def iris_runs():
    X, y = mgr.iris()
    out = {}
    for grid in ("lr", "compact"):
        models = {pkg: mgr.grid_models(pkg, grid) + [_nb_candidate(pkg)]
                  for pkg in (JAX, PORT)}
        out[grid] = (mgr.train(JAX, X, y, models[JAX])[0],
                     mgr.train(PORT, X, y, models[PORT], device="cpu")[0])
    return X, y, out


def _near_tie_rows(X, coef, inter):
    m = X @ np.asarray(coef) + np.asarray(inter)
    top = np.sort(m, axis=1)[:, -2:]
    return np.flatnonzero(top[:, 1] - top[:, 0] <= 1e-4)


@pytest.mark.parametrize("grid", ["lr", "compact"])
def test_iris_selector_matches_jax(iris_runs, grid):
    X, y, runs = iris_runs
    jm, pm = runs[grid]
    jc, pc = mgr.candidates(jm), mgr.candidates(pm)
    assert [(n, p, r) for n, p, _, r in pc] == [(n, p, r) for n, p, _, r in jc]
    for (name, params, pv, _), (_, _, jv, _) in zip(pc, jc):
        if name == mgr.RF:
            assert abs(pv - jv) <= IRIS_RF_TOL, (name, pv, jv)
        elif pv != jv:
            # a differing F1 must come from a near-tie of the JAX margins
            assert name == mgr.LR, (name, params, pv, jv)
            est = _mod(JAX, "models.linear").OpLogisticRegression(**params)
            f = est.fit_arrays(X, y)
            assert len(_near_tie_rows(X, f["coef"], f["intercept"])), \
                (name, params, pv, jv)
    js_, ps_ = jm.selected_model.summary, pm.selected_model.summary
    assert ps_.best_model_name == js_.best_model_name == mgr.LR
    assert ps_.problem_type == "MultiClassification"
    assert ps_.evaluation_metric == "F1"
    assert ps_.data_prep_results == js_.data_prep_results == {
        "labelsKept": [0.0, 1.0, 2.0], "labelsDropped": []}
    jb, pb = jm.selected_model.best_model, pm.selected_model.best_model
    scale = np.abs(np.asarray(jb.fitted["coef"])).max()
    np.testing.assert_allclose(pb.fitted["coef"].numpy(),
                               np.asarray(jb.fitted["coef"]),
                               atol=1e-3 * scale)
    assert pb.fitted["kind"] == "multinomial"
    ev = {pkg: _mod(pkg, "evaluators").Evaluators.MultiClassification.f1()
          for pkg in (JAX, PORT)}
    te_p = pm.selected_model.summary.train_evaluation["multiEval"]
    te_j = jm.selected_model.summary.train_evaluation["multiEval"]
    assert te_p["confusionMatrix"] == te_j["confusionMatrix"]
    assert abs(te_p["F1"] - te_j["F1"]) < 1e-12
    assert set(ev)


def test_selector_drops_a_label_like_jax():
    """DataCutter in the selector: the dropped label's rows leave the
    training folds (weights) and the refit; the summary lists them."""
    X, y = _blobs(300, 4, 4, seed=8, spread=2.0)
    y[:12] = 4.0                                    # a rare fifth label
    runs = {}
    for pkg in (JAX, PORT):
        S, T = _mod(pkg, "selector"), _mod(pkg, "tuning")
        C, F = _mod(pkg, "columns"), _mod(pkg, "features")
        TY = _mod(pkg, "types")
        label = F.FeatureBuilder.RealNN("label").as_response()
        feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor()
                 for i in range(4)]
        sel = S.MultiClassificationModelSelector(
            models=mgr.grid_models(pkg, "compact")[:1],
            splitter=T.DataCutter(min_label_fraction=0.05))
        sel.set_input(label, _mod(pkg, "ops.transmogrify").transmogrify(
            feats))
        cols = {"label": C.Column(TY.RealNN, y)}
        for i in range(4):
            cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
        kw = {"device": "cpu"} if pkg == PORT else {}
        wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(
            C.ColumnBatch(cols, 300))
        runs[pkg] = wf.set_result_features(sel.get_output()).train()
    js_ = runs[JAX].selected_model.summary
    ps_ = runs[PORT].selected_model.summary
    assert ps_.data_prep_results == js_.data_prep_results
    assert ps_.data_prep_results["labelsDropped"] == [4.0]
    assert [r.metric_values["F1"] for r in ps_.validation_results] == \
        [r.metric_values["F1"] for r in js_.validation_results]
    assert ps_.train_evaluation["multiEval"]["confusionMatrix"] == \
        js_.train_evaluation["multiEval"]["confusionMatrix"]


def test_naive_bayes_candidate_scores_one_at_a_time(iris_runs):
    """Naive Bayes has no batched panel: its CV F1 comes candidate by
    candidate from ``evaluate_masked``, as the JAX package's
    ``device_metric`` gives it."""
    _, _, runs = iris_runs
    jm, pm = runs["lr"]
    nb = [(p[2], j[2]) for p, j in zip(mgr.candidates(pm),
                                       mgr.candidates(jm))
          if p[0] == "OpNaiveBayes"]
    assert len(nb) == 1 and nb[0][0] == nb[0][1]


def test_make_multiclass_data_is_the_bench_draw():
    from transmogrifai_tpu_torch.synthetic import (make_multiclass_data,
                                                   make_regression_data)
    rng = np.random.default_rng(11)
    n, d = 500, 16
    ym = rng.integers(0, 4, n)
    centers = rng.normal(size=(4, d)) * 2.5
    Xm = (centers[ym] + rng.normal(size=(n, d))).astype(np.float32)
    X, y = make_multiclass_data(n)
    np.testing.assert_array_equal(X, Xm)
    np.testing.assert_array_equal(y, ym.astype(np.float32))
    # the regression generator still discards exactly these draws
    w = rng.normal(size=d).astype(np.float32)
    Xr = rng.normal(size=(n, d)).astype(np.float32)
    np.testing.assert_array_equal(make_regression_data(n)[0], Xr)
    assert w.shape == (d,)


# --------------------------------------------------------------------------
# convert, insights, LOCO
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_multiclass_models():
    from transmogrifai_tpu.models import linear as jl
    from transmogrifai_tpu.models import trees as jtr
    from transmogrifai_tpu_torch import convert
    X, y = _blobs(400, 5, 4, seed=9)
    fits = {"multinomial": (jl.LinearPredictionModel,
                            jl.OpLogisticRegression(reg_param=0.01)),
            "naive_bayes": (jl.NaiveBayesModel, jl.OpNaiveBayes()),
            "mlp": (jl.MLPClassificationModel,
                    jl.OpMultilayerPerceptronClassifier(max_iter=20)),
            "forest": (jtr.TreeEnsembleModel,
                       jtr.OpRandomForestClassifier(num_trees=5,
                                                    max_depth=4))}
    out = {}
    for kind, (cls, est) in fits.items():
        Xf = np.abs(X) if kind == "naive_bayes" else X
        jm = cls(fitted=est.fit_arrays(Xf, y))
        pm = convert.prediction_model(
            {"model": cls.__name__,
             "fitted": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                        for k, v in jm.fitted.items()}}, CPU)
        out[kind] = (Xf, jm, pm)
    return out


@pytest.mark.parametrize("kind", ["multinomial", "naive_bayes", "mlp",
                                  "forest"])
def test_convert_scores_jax_multiclass_models_like_jax(jax_multiclass_models,
                                                       kind):
    X, jm, pm = jax_multiclass_models[kind]
    want = jm.device_scores(jnp.asarray(X), full=True)
    got = pm.device_scores(torch.as_tensor(X), full=True)
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), atol=1e-6)
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))


def test_naive_bayes_contributions_match_jax(jax_multiclass_models):
    from transmogrifai_tpu import insights as jins
    from transmogrifai_tpu_torch import insights as pins
    _, jm, pm = jax_multiclass_models["naive_bayes"]

    class Sel:
        def __init__(self, m):
            self.best_model = m

    np.testing.assert_allclose(pins._model_contributions(Sel(pm)),
                               jins._model_contributions(Sel(jm)),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["multinomial", "naive_bayes", "mlp"])
def test_loco_refuses_models_with_no_kernel_link(jax_multiclass_models,
                                                 kind):
    """Multinomial, naive Bayes and MLP models now have a LOCO kernel link:
    ``model_loco`` explains them through ``loco_softmax`` (on the CPU its
    twin: the last class's probability), and a model with no link at all
    is still refused on every device rather than explained through
    another score than the card would give."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models.base import PredictionModel
    X, _, pm = jax_multiclass_models[kind]
    Xt = torch.as_tensor(X)
    cg = torch.arange(X.shape[1], dtype=torch.int32)
    idx, val = ik.model_loco(pm, Xt, cg, X.shape[1], 2, "abs")
    want = ik.loco_topk_twin(
        Xt, lambda Z: pm.device_scores(Z)["probability"][:, -1], cg,
        X.shape[1], 2, "abs")
    assert torch.equal(idx, want[0]) and torch.equal(val, want[1])

    class NoLink(PredictionModel):
        def device_scores(self, X, full=False):
            return pm.device_scores(X, full)

    with pytest.raises(NotImplementedError, match="no LOCO kernel"):
        ik.model_loco(NoLink(fitted={"kind": kind}), Xt, cg, X.shape[1], 2,
                      "abs")


# --------------------------------------------------------------------------
# the kernels' launch plans and wrappers on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("C", [2, 3, 4, 40, 65, 300])
@pytest.mark.parametrize("D", [16, 1596, 27_009])
def test_launch_plans_cover_the_shapes(C, D):
    """``fista_softmax`` runs whole lanes, at most 64 columns a launch, so
    every C up to 40 fits at the transmogrified width, in shared memory the
    kernel's own carve-up sizes; more than 64 classes, or a width no
    tensor-core launch holds, runs the two-pass form with every lane's
    classes in one launch; fewer than 2 classes is refused.
    ``multiclass_confusion`` takes its thread form where a block's cells
    fit shared memory (up to 14 classes) and its shared form (warps'
    histograms) above, on an H100 SXM's 132 SMs."""
    L = 24
    plan = lk.softmax_launch_plan(D, L, C)
    if C > lk.TC_COLS or D > 20_000:
        assert plan["form"] == "wide"
        assert plan["cols"] == L * C and plan["Jp"] >= L * C
        with pytest.raises(ValueError, match="classes"):
            lk.softmax_launch_plan(D, L, 1)
        return
    assert plan["smem"] <= lk._SMEM_MAX
    assert plan["lanes"] == min(L, lk.TC_COLS // C)
    assert plan["lanes"] * C <= lk.TC_COLS
    assert plan["smem"] == lk._tc_layout(
        plan["TR"], plan["CS"], plan["DS"], plan["S"], plan["cols"],
        plan["v_res"], plan["acc_res"])["smem"]
    assert plan["form"] == ("narrow" if D == 16 else "cluster")
    assert lk.softmax_launch_plan(16, 8, 4)["TR"] == 128
    assert lk.softmax_launch_plan(1596, 6, 4)["form"] == "cluster"
    with pytest.raises(ValueError, match="classes"):
        lk.softmax_launch_plan(D, L, 1)
    for K in (1, 24, 300):
        p = mk.confusion_plan(K, C, 1_000_000, 132)
        assert p.smem <= mk._SMEM_MAX and 1 <= p.k_chunk <= K
        if mk.thread_form_fits(C):
            assert p.form == "thread"
            assert p.smem == 4 * C * C * p.threads
        else:
            assert p.form == "shared"
            assert p.smem == 4 * (p.threads // 32) * p.k_chunk \
                * p.c_chunk * C
    assert mk.confusion_plan(24, 4, 1_000_000, 132) == mk.ConfusionPlan(
        "thread", 24, 4, 240, 10, 528, 15_360)
    big = mk.confusion_plan(3, 400, 1_000_000, 132)
    assert big.c_chunk < 400 and big.threads == 32 and big.k_chunk == 1


def test_wrappers_check_their_inputs():
    X = torch.zeros((10, 3))
    V = torch.zeros((2, 3, 3))
    z = torch.zeros((2, 3))
    W = torch.ones((1, 10))
    y = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        lk.fista_softmax_step(X, V, z, z, W, y.float(), torch.ones(2), 2)
    with pytest.raises(ValueError, match="disagree"):
        lk.fista_softmax_step(X, V, z, z, W, y, torch.ones(2), 1)
    gx, gs = lk.fista_softmax_step(X, V, z, z, W, y, torch.ones(2), 2)
    assert gx.shape == (2, 3, 3) and gs.shape == (2, 3)
    P = torch.zeros((10, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        mk.multiclass_confusion(y, P, torch.ones((1, 10)), 1, 3)
    conf = mk.multiclass_confusion(y, P, torch.ones((1, 10)), 2, 3)
    assert conf.shape == (2, 3, 3) and float(conf[:, 0, 0].sum()) == 20.0


def test_naive_bayes_in_a_binary_selector_ranks_its_scores_like_jax():
    """The per-candidate path under the binary evaluator: naive Bayes's
    class-1 probability ranked by AuPR, as the JAX package's
    ``device_metric`` ranks it."""
    X, y = _blobs(300, 4, 2, seed=11)
    X = np.abs(X)
    cv = {}
    for pkg in (JAX, PORT):
        S, C, F = (_mod(pkg, "selector"), _mod(pkg, "columns"),
                   _mod(pkg, "features"))
        TY = _mod(pkg, "types")
        label = F.FeatureBuilder.RealNN("label").as_response()
        feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor()
                 for i in range(4)]
        sel = S.BinaryClassificationModelSelector(models=[_nb_candidate(pkg)])
        sel.set_input(label, _mod(pkg, "ops.transmogrify").transmogrify(
            feats))
        cols = {"label": C.Column(TY.RealNN, y)}
        for i in range(4):
            cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
        kw = {"device": "cpu"} if pkg == PORT else {}
        wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(
            C.ColumnBatch(cols, 300))
        m = wf.set_result_features(sel.get_output()).train()
        cv[pkg] = [r.metric_values["AuPR"]
                   for r in m.selected_model.summary.validation_results]
    np.testing.assert_allclose(cv[PORT], cv[JAX], rtol=1e-6)
