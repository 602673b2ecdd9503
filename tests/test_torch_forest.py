"""Parity of the PyTorch port's random forests and decision trees with the
JAX package, on the CPU.

On a CPU tensor every tree kernel wrapper runs its plain-PyTorch twin, so
these tests hold ``tree_split_gini_twin`` and the forest fit and scoring
built on the twins against the JAX reference on the same numpy inputs.

Tolerances: gini gains rtol 1e-6 of wgini(parent) (the terms they are a
difference of), chosen splits identical wherever the best-vs-runner-up gap
exceeds 1e-5 of wgini(parent), and on exact ties; decision trees and
forests without bootstrap over all features identical in structure, leaves
at rtol 1e-5; forest probabilities scored from the same trees rtol 1e-6,
predictions exact.  The port cannot reproduce ``jax.random``'s streams, so
a forest with bootstrap and per-node subsets is held statistically: its
held-out AuROC within ``HELDOUT_AUROC_TOL`` of the JAX package's.

Run as a script, this file measures the JAX package's spread of the bench
forest's CV AuPR over RF seeds on ``bench.make_data`` at 20,000 x 28 and at
400 x 6 (the tolerances of the port's forest in ``chip_smoke.py`` and
``tests/test_torch_workflow.py``; PERF.md), and the held-out AuROC spread
behind ``HELDOUT_AUROC_TOL``; with ``--offset-seeds N`` instead the mean
difference of that CV AuPR (port minus JAX) over N forest seeds at 20,000
rows and its standard error:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_forest.py
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_forest.py \
        --offset-seeds 20
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

N, D, NB = 3000, 8, 32
# |port - JAX| of the mean held-out AuROC over RF seeds HELDOUT_SEEDS of a
# 10-tree depth-4 forest with bootstrap and sqrt subsets (1,500 rows to fit,
# 1,500 held out).  The JAX package's per-seed sd of that AuROC is 0.0086
# (`python tests/test_torch_forest.py`, CPU), so the difference of two
# 5-seed means has a standard error of 0.0086·sqrt(2/5) = 0.0054; the
# tolerance is 3 of those.
HELDOUT_SEEDS = (42, 0, 1, 2, 3)
HELDOUT_AUROC_TOL = 0.016


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    X[:, 5] = np.round(X[:, 5], 1)                  # ties at split values
    X[:, 7] = X[:, 6]                               # an exact tie column
    w = rng.normal(size=D).astype(np.float32)
    logits = X @ w + 0.8 * X[:, 0] * X[:, 1] - 0.5 * X[:, 2] ** 2
    y = ((logits + rng.normal(size=n)) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def binned(data):
    X, _ = data
    splits = jt.build_bin_splits(X, NB)
    B = np.array(jt.bin_data(jnp.asarray(X), jnp.asarray(splits)))
    return splits, B


def _gini_level(data, binned, seed=3):
    """Gini statistics (w, w·[y=0], w·[y=1]) for 3 lanes at a depth-3 level
    (offset 3, P = 4) with Poisson(1) row weights, a held-out third per lane
    and some rows parked at leaves above; per-node subsets of 3 of the D
    features."""
    X, y = data
    rng = np.random.default_rng(seed)
    K, P = 3, 4
    w = rng.poisson(1.0, size=(K, N)) * (rng.random((K, N)) > 0.33)
    base = np.stack([np.ones(N), 1 - y, y], axis=1)
    stats = (base[None] * w[:, :, None]).astype(np.float32)
    row_node = rng.integers(1, 7, size=(K, N)).astype(np.int32)
    node_mask = np.zeros((K, P, D), bool)
    for k in range(K):
        for p in range(P):
            node_mask[k, p, rng.choice(D, 3, replace=False)] = True
    node_mask[0, 0, 6:8] = True                     # the tie pair, both in
    _, B = binned
    hist, tot = tk.tree_hist(torch.as_tensor(B), torch.as_tensor(row_node),
                             torch.as_tensor(stats), 3, P, NB)
    return hist, tot, torch.as_tensor(node_mask)


def _jax_gini_table(hist, tot, mi, node_mask):
    """The JAX level body's gain table for one lane (trees.py:339-346)."""
    left = jnp.cumsum(jnp.asarray(hist), axis=2)       # [P, D, NB, S]
    parent = jnp.asarray(tot)[:, None, None, :]
    gains = jt._gain_gini(left, parent - left, parent, 1.0)
    ok = ((left[..., 0] >= mi) & ((parent - left)[..., 0] >= mi)
          & jnp.asarray(node_mask)[:, :, None] & (jnp.arange(NB) < NB - 1))
    return np.asarray(jnp.where(ok, gains, -jnp.inf)).reshape(hist.shape[0], -1)


def test_tree_split_gini_twin_matches_jax_gains_and_choices(data, binned):
    splits, _ = binned
    hist, tot, node_mask = _gini_level(data, binned)
    K = hist.shape[0]
    lane = lambda v: torch.full((K,), v)
    out = tk.tree_split_gini(hist, tot, torch.ones(D, dtype=torch.bool),
                             node_mask, torch.as_tensor(splits), lane(5.0),
                             lane(0.0))
    scale = tk.wgini(tot).numpy()
    for k in range(K):
        flat = _jax_gini_table(hist[k].numpy(), tot[k].numpy(), 5.0,
                               node_mask[k].numpy())
        best = flat.max(axis=1)
        fin = np.isfinite(best)
        assert fin.all()
        np.testing.assert_array_equal(np.isfinite(out["gain"][k].numpy()), fin)
        assert (np.abs(out["gain"][k].numpy() - best) <= 1e-6 * scale[k]).all()
        clear = (best - np.sort(flat, axis=1)[:, -2]) > 1e-5 * scale[k]
        idx = np.asarray(jnp.argmax(jnp.asarray(flat), axis=1))
        np.testing.assert_array_equal(out["feature"][k].numpy()[clear],
                                      (idx // NB)[clear])
        np.testing.assert_array_equal(out["bin"][k].numpy()[clear],
                                      (idx % NB)[clear])
        np.testing.assert_array_equal(
            out["threshold"][k].numpy()[clear],
            splits[idx // NB, np.minimum(idx % NB, NB - 2)][clear])
        np.testing.assert_array_equal(out["is_leaf"][k].numpy(), ~(best > 0))
    # the gap helper sees the same table
    gap = tk.split_gap_gini(hist, tot, torch.ones(D, dtype=torch.bool),
                            node_mask, lane(5.0))
    assert gap.shape == (K, 4) and bool((gap >= 0).all())


def test_tree_split_gini_exact_ties_resolve_to_lowest_feature_then_bin(data):
    """Columns 6 and 7 are equal (identical histograms, equal gains); a
    two-valued column gives a flat prefix (equal gains over bins)."""
    X, y = data
    Xt = X.copy()
    Xt[:, 6] = np.where(X[:, 6] > 0.2, 1.0, -1.0)
    Xt[:, 7] = Xt[:, 6]
    yy = (Xt[:, 6] > 0).astype(np.float32)          # col 6/7 split it perfectly
    splits = jt.build_bin_splits(Xt, NB)
    B = np.array(jt.bin_data(jnp.asarray(Xt), jnp.asarray(splits)))
    stats = np.stack([np.ones(N), 1 - yy, yy], axis=1).astype(np.float32)
    ref = jt.fit_tree(jnp.asarray(B), jnp.asarray(splits), jnp.asarray(stats),
                      jnp.ones(D) > 0, impurity="gini", max_depth=1,
                      n_bins=NB, min_instances=jnp.float32(1),
                      min_gain=jnp.float32(0), lam=jnp.float32(1),
                      hist_dtype=jnp.float32)
    port = pt.fit_trees(torch.as_tensor(B), torch.as_tensor(splits),
                        torch.as_tensor(stats)[None],
                        torch.ones(D, dtype=torch.bool), max_depth=1,
                        n_bins=NB, min_instances=torch.ones(1),
                        min_gain=torch.zeros(1), impurity="gini")
    assert int(ref.feature[0]) == int(port.feature[0, 0]) == 6
    assert float(port.threshold[0, 0]) == float(ref.threshold[0]) \
        == float(splits[6, 0])                      # the lowest bin
    np.testing.assert_allclose(port.leaf[0].numpy(), np.asarray(ref.leaf),
                               rtol=1e-5)
    # a node subset without column 6 takes its twin, column 7
    nm = torch.ones((1, 1, D), dtype=torch.bool)
    nm[0, 0, 6] = False
    sub = pt.fit_trees(torch.as_tensor(B), torch.as_tensor(splits),
                       torch.as_tensor(stats)[None],
                       torch.ones(D, dtype=torch.bool), max_depth=1,
                       n_bins=NB, min_instances=torch.ones(1),
                       min_gain=torch.zeros(1), impurity="gini",
                       node_masks=[nm])
    assert int(sub.feature[0, 0]) == 7


def _assert_same_trees(port: dict, ref: dict):
    np.testing.assert_array_equal(np.asarray(port["feature"]),
                                  np.asarray(ref["feature"]))
    np.testing.assert_array_equal(np.asarray(port["is_leaf"]),
                                  np.asarray(ref["is_leaf"]))
    np.testing.assert_array_equal(np.asarray(port["threshold"]),
                                  np.asarray(ref["threshold"]))
    np.testing.assert_allclose(np.asarray(port["leaf"]),
                               np.asarray(ref["leaf"]), rtol=1e-5, atol=1e-7)


DETERMINISTIC = {
    "decision_tree": (pt.OpDecisionTreeClassifier, jt.OpDecisionTreeClassifier,
                      dict(max_depth=4, min_instances_per_node=5)),
    "forest_all_no_bootstrap": (
        pt.OpRandomForestClassifier, jt.OpRandomForestClassifier,
        dict(num_trees=3, max_depth=4, min_instances_per_node=10,
             bootstrap=False, feature_subset_strategy="all")),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_trees_match_jax_structure_and_leaves(name, data):
    port_cls, jax_cls, kw = DETERMINISTIC[name]
    X, y = data
    ref = jax_cls(**kw).fit_arrays(X, y)
    port = port_cls(**kw).fit_arrays(X, y, device="cpu")
    assert port["kind"] == ref["kind"] == "forest"
    assert port["leaf"].shape == ref["leaf"].shape
    _assert_same_trees(port, ref)
    np.testing.assert_allclose(port["feature_gain"].numpy(),
                               ref["feature_gain"], rtol=1e-4, atol=1e-3)


def test_forest_grid_matches_jax_without_bootstrap(data):
    """fit_arrays_grid over 2 folds × 2 grid points, the per-lane weighted
    min_instances included (fold weights 0/1 and 2: a weighted count)."""
    X, y = data
    rng = np.random.default_rng(11)
    W = ((rng.random((2, N)) > 0.33) * (1 + (rng.random(N) > 0.8))).astype(
        np.float32)
    grids = [{"min_instances_per_node": 10}, {"min_instances_per_node": 40,
                                              "min_info_gain": 1.0}]
    kw = dict(num_trees=2, max_depth=3, bootstrap=False,
              feature_subset_strategy="all")
    ref = jt.OpRandomForestClassifier(**kw).fit_arrays_grid(
        jnp.asarray(X), jnp.asarray(y), W, grids)
    port = pt.OpRandomForestClassifier(**kw).fit_arrays_grid(
        torch.as_tensor(X), y, W, grids)
    for k in range(2):
        for g in range(2):
            _assert_same_trees(port[k][g], ref[k][g])


def test_forest_draws_properties():
    D_, T, n, fpn, depth = 28, 20, 50_000, 5, 4
    fmask = torch.ones(D_, dtype=torch.bool)
    fmask[[3, 17]] = False
    gen = torch.Generator().manual_seed(7)
    dr = pt.forest_draws(gen, n_trees=T, n_rows=n, rates=[1.0, 0.5],
                         max_depth=depth, fmask=fmask, features_per_node=fpn)
    assert len(dr.subsets) == depth
    for lvl, m in enumerate(dr.subsets):
        assert m.shape == (T, 1 << lvl, D_)
        assert bool((m.sum(dim=2) == fpn).all())    # exactly fpn per node
        assert not bool(m[..., ~fmask].any())      # all inside fmask
    for rate, b in dr.boot.items():
        assert b.shape == (T, n)
        # Poisson(rate): mean within 4 sigma of the rate over T*n draws
        assert abs(float(b.double().mean()) - rate) <= 4 * np.sqrt(rate / (T * n))
        assert bool((b == torch.round(b)).all()) and float(b.min()) >= 0
    again = pt.forest_draws(torch.Generator().manual_seed(7), n_trees=T,
                            n_rows=n, rates=[1.0, 0.5], max_depth=depth,
                            fmask=fmask, features_per_node=fpn)
    assert all(torch.equal(a, b) for a, b in zip(dr.subsets, again.subsets))
    assert torch.equal(dr.boot[0.5], again.boot[0.5])
    assert pt._features_per_node("sqrt", 28) == 5
    assert pt._features_per_node("onethird", 28) == 9
    assert pt._features_per_node("all", 28) is None
    assert pt._features_per_node("sqrt", 1) is None


RF_KW = dict(num_trees=10, max_depth=4, min_instances_per_node=10)


def test_forest_draws_are_shared_across_folds_and_seeded(data):
    """Two folds with equal row weights see the same bootstrap and subsets,
    so they grow the same trees; the same seed gives a bit-identical
    forest, another seed another one."""
    X, y = data
    est = pt.OpRandomForestClassifier(**RF_KW)
    W = np.ones((2, N), np.float32)
    W[:, : N // 4] = 0.0
    a = est.fit_arrays_grid(torch.as_tensor(X), y, W, [{}])
    b = est.fit_arrays_grid(torch.as_tensor(X), y, W, [{}])
    for key in ("feature", "threshold", "is_leaf", "leaf"):
        assert torch.equal(a[0][0][key], a[1][0][key])
        assert torch.equal(a[0][0][key], b[0][0][key])
    other = pt.OpRandomForestClassifier(seed=43, **RF_KW).fit_arrays_grid(
        torch.as_tensor(X), y, W[:1], [{}])
    assert not torch.equal(other[0][0]["feature"], a[0][0]["feature"])
    # the trees of one forest differ from each other (bootstrap + subsets)
    assert len({tuple(f.tolist()) for f in a[0][0]["feature"]}) > 1


def _auroc(y, s):
    from transmogrifai_tpu_torch.metrics_device import masked_auroc
    return float(masked_auroc(torch.as_tensor(y), torch.as_tensor(s),
                              torch.ones(len(y))))


def _heldout_aurocs(data, seeds):
    X, y = data
    tr, te = slice(0, N // 2), slice(N // 2, N)
    jax_s, port_s = [], []
    for seed in seeds:
        ref = jt.OpRandomForestClassifier(seed=seed, **RF_KW).fit_arrays(
            X[tr], y[tr])
        jm = jt.TreeEnsembleModel(fitted=ref)
        jax_s.append(_auroc(y[te], np.asarray(
            jm.device_scores(jnp.asarray(X[te]))["scores"])))
        port = pt.OpRandomForestClassifier(seed=seed, **RF_KW).fit_arrays(
            X[tr], y[tr], device="cpu")
        pm = pt.TreeEnsembleModel(fitted=port)
        port_s.append(_auroc(y[te], pm.device_scores(
            torch.as_tensor(X[te]))["scores"].numpy()))
    return np.asarray(jax_s), np.asarray(port_s)


def test_forest_with_bootstrap_and_subsets_heldout_auroc_near_jax(data):
    jax_s, port_s = _heldout_aurocs(data, HELDOUT_SEEDS)
    assert 0.85 < jax_s.mean() < 0.95
    assert abs(port_s.mean() - jax_s.mean()) <= HELDOUT_AUROC_TOL, (
        port_s, jax_s)


def test_jax_trained_forest_converted_scores_like_jax(data):
    """A forest fitted by the JAX package, exported as plain arrays and
    built by ``convert``, scores as the JAX package scores it."""
    from transmogrifai_tpu_torch import convert
    X, y = data
    ref = jt.OpRandomForestClassifier(**RF_KW).fit_arrays(X, y)
    exported = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in ref.items()}
    fitted = convert._model_fitted("TreeEnsembleModel", exported,
                                   torch.device("cpu"))
    got = pt.TreeEnsembleModel(fitted=fitted).device_scores(
        torch.as_tensor(X), full=True)
    want = jt.TreeEnsembleModel(fitted=ref).device_scores(jnp.asarray(X),
                                                          full=True)
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))
    np.testing.assert_allclose(got["rawPrediction"].numpy(),
                               np.asarray(want["rawPrediction"]), rtol=1e-6,
                               atol=1e-6)
    # forest regressors convert too (tests/test_torch_regression.py); a
    # task the port has no model for is refused
    with pytest.raises(NotImplementedError, match="task"):
        convert._model_fitted("TreeEnsembleModel",
                              {**exported, "task": "ranking"},
                              torch.device("cpu"))


# --------------------------------------------------------------------------
# measurement script: the JAX package's RF CV AuPR spread over RF seeds
# --------------------------------------------------------------------------

def rf_cv_aupr(pkg: str, X, y, seed: int, **wf_kw) -> float:
    """CV AuPR of the bench's forest candidate (20 trees, depth 6,
    min_instances 10; 3-fold CV) alone in package ``pkg``'s selector."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    C, F = mod("columns"), mod("features")
    S, TY = mod("selector"), mod("types")
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor()
             for i in range(X.shape[1])]
    checked = label.sanity_check(mod("ops.transmogrify").transmogrify(feats),
                                 remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        mod("models.trees").OpRandomForestClassifier(seed=seed),
        S.grid(num_trees=[20], max_depth=[6], min_instances_per_node=[10]),
        "OpRandomForestClassifier")])
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(X.shape[1]):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    wf = mod("workflow").Workflow(**wf_kw).set_input_batch(
        C.ColumnBatch(cols, len(y))).set_result_features(pred)
    res = wf.train().selected_model.summary.validation_results
    return float(next(iter(res[0].metric_values.values())))


def forest_offset(n_seeds: int, rows: int = 20_000) -> dict:
    """Mean difference (port CPU twins - JAX) of the bench forest's CV AuPR
    over forest seeds 0 .. n_seeds-1 on ``bench.make_data(rows, 28)``, and
    its standard error (the per-seed differences' sd / sqrt(n))."""
    from bench import make_data
    X, y = make_data(rows, 28)
    seeds = list(range(n_seeds))
    jax_v = [rf_cv_aupr("transmogrifai_tpu", X, y, s) for s in seeds]
    port_v = [rf_cv_aupr("transmogrifai_tpu_torch", X, y, s, device="cpu")
              for s in seeds]
    diff = np.asarray(port_v) - np.asarray(jax_v)
    se = float(diff.std(ddof=1) / np.sqrt(n_seeds))
    return {"rows": rows, "seeds": seeds, "jax_rf_cv_aupr": jax_v,
            "port_cpu_rf_cv_aupr": port_v, "mean_difference":
            float(diff.mean()), "standard_error": se,
            "jax_mean": float(np.mean(jax_v)),
            "port_mean": float(np.mean(port_v))}


def main() -> None:
    import json
    import sys

    from bench import make_data
    if "--offset-seeds" in sys.argv:
        n = int(sys.argv[sys.argv.index("--offset-seeds") + 1])
        print(json.dumps(forest_offset(n)))
        return
    seeds = (42, 0, 1, 2, 3)
    for n, d in ((20_000, 28), (400, 6)):
        X, y = make_data(n, d)
        jax_v = [rf_cv_aupr("transmogrifai_tpu", X, y, s) for s in seeds]
        port_v = [rf_cv_aupr("transmogrifai_tpu_torch", X, y, s,
                             device="cpu") for s in seeds]
        spread = max(jax_v) - min(jax_v)
        print(json.dumps({"rows": n, "features": d, "seeds": seeds,
                          "jax_rf_cv_aupr": jax_v,
                          "port_cpu_rf_cv_aupr": port_v, "jax_spread": spread,
                          "tolerance": max(0.01, 3 * spread)}))
    ho_j, ho_p = _heldout_aurocs(_data(), HELDOUT_SEEDS)
    print(json.dumps({"heldout_auroc_jax": ho_j.tolist(),
                      "heldout_auroc_port": ho_p.tolist(),
                      "jax_sd": float(ho_j.std(ddof=1)),
                      "mean_difference": float(ho_p.mean() - ho_j.mean())}))


if __name__ == "__main__":
    main()
