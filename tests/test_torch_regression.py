"""Parity of the PyTorch port's regression family with the JAX package, on
the CPU.

On a CPU tensor every kernel wrapper runs its plain-PyTorch twin, so these
tests hold ``tree_split_variance_twin``, the ``fista_step`` twin with the
squared loss, the variance trees, the GBT and forest regressors, ridge, the
regression metric panels, ``OpRegressionEvaluator``, the
``RegressionModelSelector``, ``convert`` and LOCO on regression models
against the JAX package on the same numpy inputs.

Tolerances: ``_gain_variance`` / ``_leaf_variance`` equal bit for bit (the
same f32 operations in the same order); split gains within 1e-6 of
sse(parent) (+1e-6; the bin prefix sums in another order), chosen splits
identical wherever the best-vs-runner-up gap exceeds 1e-5 of sse(parent);
variance trees identical on reachable nodes, leaves and per-feature gains
rtol 1e-5; the GBT's per-fold base rtol 1e-6, its first-round trees
identical; FISTA coefficients within 1e-4, ``n_iter`` within 2 with at most
2 lanes apart; ridge rtol 1e-4 against the JAX package and against a numpy
f64 solve; metric panels rtol 1e-6 and histogram counts equal; selector
CV RMSE rtol 1e-4 (linear) and 1e-3 (GBT), the forest's within
``BOSTON_RF_TOL``; scores of converted JAX models rtol 1e-5; LOCO diffs
within 1e-6 of the prediction's scale (f32 forwards summed in another
order over features of magnitude up to ~700).

Run as a script, this file measures the JAX package's spread of the Boston
RF regressor's CV RMSE over forest seeds (``BOSTON_RF_TOL``):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_regression.py
"""

import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu import metrics_device as jmd  # noqa: E402
from transmogrifai_tpu.models import solvers as js  # noqa: E402
from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch import metrics_device as pmd  # noqa: E402
from transmogrifai_tpu_torch.models import solvers as ps  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

CPU = torch.device("cpu")
NB = 32
JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
BOSTON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "boston", "housingData.csv")
BOSTON_HEADERS = ["rowId", "crim", "zn", "indus", "chas", "nox", "rm", "age",
                  "dis", "rad", "tax", "ptratio", "b", "lstat", "medv"]
# 3 x the JAX package's spread 0.3485 of the Boston RF regressor's CV RMSE
# (5 trees, depth 4; 4.549 to 4.898) over RF seeds 42, 0, 1, 2, 3, measured
# by `python tests/test_torch_regression.py`
BOSTON_RF_TOL = 1.045
# The Boston GBT regressor's CV RMSE, rtol: on fold 2 two features split one
# node's 74 rows identically (an exact tie in exact arithmetic), and each
# package's f32 sums break it another way, so its later rounds differ
# (1.4e-3 apart); ``test_boston_gbt_trees_differ_only_at_exact_ties`` holds
# the trees themselves.
BOSTON_GBT_RTOL = 3e-3


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _reg_data(n=2000, d=6, seed=0):
    """A regression set with an interaction, a square and label noise; one
    column rounded (ties at split values)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 4] = np.round(X[:, 4], 1)
    w = rng.normal(size=d).astype(np.float32)
    y = (X @ w + 0.8 * X[:, 0] * X[:, 1] - 0.5 * X[:, 2] ** 2
         + 0.3 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _fold_weights(y, folds=3):
    from transmogrifai_tpu_torch.tuning import OpCrossValidation
    W = np.zeros((folds, len(y)), np.float32)
    for f, (tr, _) in enumerate(OpCrossValidation(folds).splits(y)):
        W[f, tr] = 1.0
    return W


# --------------------------------------------------------------------------
# the variance gain, its split twin and the variance trees
# --------------------------------------------------------------------------

def _stats(rng, shape):
    """Random (w, w·y, w·y²) with integer weights (zeros included)."""
    w = rng.integers(0, 6, size=shape).astype(np.float32)
    y = rng.normal(scale=3.0, size=shape).astype(np.float32)
    return np.stack([w, w * y, w * y * y + w * rng.random(shape).astype(
        np.float32)], axis=-1)


def test_gain_and_leaf_variance_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    left, right = _stats(rng, (500,)), _stats(rng, (500,))
    parent = left + right
    want = np.asarray(jt._gain_variance(jnp.asarray(left), jnp.asarray(right),
                                        jnp.asarray(parent), 1.0))
    got = tk.variance_gain(torch.as_tensor(left), torch.as_tensor(right),
                           torch.as_tensor(parent)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pt._leaf_variance(torch.as_tensor(parent)).numpy(),
        np.asarray(jt._leaf_variance(jnp.asarray(parent))))


def _jax_scan_choice(hist, tot, mi, node_mask, chunk=32):
    """The JAX level body's choice per node (trees.py:339-361): its gain
    table, first max over bins then features inside a chunk of ``chunk``
    features, strict ``>`` across chunks.  hist [P, D, NB, 3] → (best,
    feature, bin) [P]."""
    left = jnp.cumsum(jnp.asarray(hist), axis=2)
    parent = jnp.asarray(tot)[:, None, None, :]
    gains = jt._gain_variance(left, parent - left, parent, 1.0)
    ok = ((left[..., 0] >= mi) & ((parent - left)[..., 0] >= mi)
          & jnp.asarray(node_mask)[:, :, None] & (jnp.arange(NB) < NB - 1))
    gains = np.asarray(jnp.where(ok, gains, -jnp.inf))     # [P, D, NB]
    P, D = gains.shape[:2]
    best = np.full(P, -np.inf, np.float32)
    feat, bin_ = np.zeros(P, np.int64), np.zeros(P, np.int64)
    for c0 in range(0, D, chunk):
        g = gains[:, c0:c0 + chunk]
        cg, cb = g.max(axis=2), g.argmax(axis=2)
        fi = cg.argmax(axis=1)
        fg = cg[np.arange(P), fi]
        better = fg > best
        best = np.where(better, fg, best)
        feat = np.where(better, c0 + fi, feat)
        bin_ = np.where(better, cb[np.arange(P), fi], bin_)
    return best, feat, bin_, gains.reshape(P, -1)


def _variance_level(D, n=400, seed=1, K=2, P=4):
    """Histograms of a depth-2 level (offset 3) for K lanes: rows over the
    level's P nodes, Poisson-like integer weights, node subsets of a third
    of the features.  Column 1,500 (when present) repeats column 100 and the
    label follows column 100: an exact tie across the 1,024-feature
    chunks."""
    rng = np.random.default_rng(seed)
    B = rng.integers(0, NB, size=(n, D)).astype(np.int8)
    y = rng.normal(size=n).astype(np.float32)
    if D > 1500:
        B[:, 1500] = B[:, 100]
        y = (B[:, 100] > 15).astype(np.float32) * 3.0 + 0.1 * y
    w = rng.integers(0, 3, size=(K, n)).astype(np.float32)
    base = np.stack([np.ones(n), y, y * y], axis=1).astype(np.float32)
    stats = torch.as_tensor(base[None] * w[:, :, None])
    row_node = torch.as_tensor(rng.integers(3, 3 + P, size=(K, n))
                               .astype(np.int32))
    mask = np.zeros((K, P, D), bool)
    for k in range(K):
        for p in range(P):
            mask[k, p, rng.choice(D, max(1, D // 3), replace=False)] = True
    if D > 1500:
        mask[:, :, [100, 1500]] = True
        mask[1, 1, 100] = False          # this node must take the copy
    hist, tot = tk.tree_hist(torch.as_tensor(B), row_node, stats, 3, P, NB)
    splits = np.sort(rng.normal(size=(D, NB - 1)), axis=1).astype(np.float32)
    return hist, tot, torch.as_tensor(mask), torch.as_tensor(splits)


@pytest.mark.parametrize("D", [6, 1597])
def test_split_variance_twin_matches_jax_scan_choice(D):
    hist, tot, mask, splits = _variance_level(D)
    K, P = tot.shape[:2]
    lane = lambda v: torch.full((K,), v)
    out = tk.tree_split_variance(hist, tot, torch.ones(D, dtype=torch.bool),
                                 mask, splits, lane(2.0), lane(0.0))
    scale = tk.sse(tot).abs().numpy()
    for k in range(K):
        best, feat, bin_, flat = _jax_scan_choice(
            hist[k].numpy(), tot[k].numpy(), 2.0, mask[k].numpy())
        fin = np.isfinite(best)
        np.testing.assert_array_equal(np.isfinite(out["gain"][k].numpy()),
                                      fin)
        g = out["gain"][k].numpy()
        assert (np.abs(g[fin] - best[fin])
                <= 1e-6 * scale[k][fin] + 1e-6).all()
        top2 = np.sort(flat, axis=1)[:, -2:]
        clear = fin & ((top2[:, 1] - top2[:, 0]) > 1e-5 * scale[k] + 1e-6)
        np.testing.assert_array_equal(out["feature"][k].numpy()[clear],
                                      feat[clear])
        np.testing.assert_array_equal(out["bin"][k].numpy()[clear],
                                      bin_[clear])
        np.testing.assert_array_equal(
            out["threshold"][k].numpy()[clear],
            splits.numpy()[feat, np.minimum(bin_, NB - 2)][clear])
        np.testing.assert_array_equal(out["is_leaf"][k].numpy(),
                                      ~(np.isfinite(best) & (best > 0)))
    if D > 1500:
        # the cross-chunk tie goes to the first feature, and a node whose
        # subset lacks it to its copy in the second chunk
        assert int(out["feature"][0, 0]) == 100
        assert int(out["feature"][1, 1]) == 1500
    gap = tk.split_gap_variance(hist, tot, torch.ones(D, dtype=torch.bool),
                                mask, lane(2.0))
    assert gap.shape == (K, P) and bool((gap >= 0).all())


def _reachable(is_leaf):
    T = is_leaf.shape[-1]
    r = np.zeros_like(is_leaf, dtype=bool)
    r[..., 0] = True
    for i in range(1, T):
        p = (i - 1) // 2
        r[..., i] = r[..., p] & ~is_leaf[..., p]
    return r


def _variance_near_tie(X, y, feat, thr):
    """Both choices' variance gains at a node, recomputed in f64 from the
    rows that reach it, agree within 1e-5 of sse(parent)."""
    def sse(v):
        return float(((v - v.mean()) ** 2).sum()) if len(v) else 0.0

    def check(node, a, b):
        path, i = [], node
        while i:
            path.append(((i - 1) // 2, i % 2 == 0))
            i = (i - 1) // 2
        at = np.ones(len(y), bool)
        for parent, right in path:
            at &= (X[:, feat[parent]] > thr[parent]) == right
        yy = y[at].astype(np.float64)

        def gain(f, th):
            r = X[at, f] > th
            return sse(yy) - sse(yy[~r]) - sse(yy[r])

        return abs(gain(*a) - gain(*b)) <= 1e-5 * max(sse(yy), 1e-12)

    return check


@pytest.mark.parametrize("depth", [3, 9])
def test_variance_decision_tree_matches_jax(depth):
    """``OpDecisionTreeRegressor`` (one tree, every feature, no bootstrap:
    no random draws) against the JAX package's, depth 3 (its compact form)
    and depth 9 (its unrolled form), on reachable nodes."""
    X, y = _reg_data()
    kw = dict(max_depth=depth, min_instances_per_node=5)
    ref = jt.OpDecisionTreeRegressor(**kw).fit_arrays(X, y)
    port = pt.OpDecisionTreeRegressor(**kw).fit_arrays(X, y, device="cpu")
    assert port["task"] == "regression" and port["leaf"].shape[-1] == 1
    pf, jf = np.asarray(port["feature"])[0], np.asarray(ref["feature"])[0]
    pth, jth = (np.asarray(port["threshold"])[0],
                np.asarray(ref["threshold"])[0])
    pl, jl = np.asarray(port["is_leaf"])[0], np.asarray(ref["is_leaf"])[0]
    pv, jv = np.asarray(port["leaf"])[0], np.asarray(ref["leaf"])[0]
    near_tie = _variance_near_tie(X, y, pf, pth)
    todo, ties, deepest = [0], 0, 0
    while todo:
        i = todo.pop()
        deepest = max(deepest, int(np.log2(i + 1)))
        assert pl[i] == jl[i], i
        np.testing.assert_allclose(pv[i], jv[i], rtol=1e-5, atol=1e-6)
        if jl[i]:
            continue
        if (pf[i], pth[i]) != (jf[i], jth[i]):
            assert near_tie(i, (pf[i], pth[i]), (jf[i], jth[i])), i
            ties += 1
            continue
        todo += [c for c in (2 * i + 1, 2 * i + 2) if c < len(pl)]
    assert ties <= 2 and deepest >= min(depth, 8)
    if not ties:
        np.testing.assert_allclose(np.asarray(port["feature_gain"]),
                                   np.asarray(ref["feature_gain"]),
                                   rtol=1e-5)
    got = pt.TreeEnsembleModel(fitted=port).device_scores(torch.as_tensor(X))
    want = jt.TreeEnsembleModel(fitted=ref).device_scores(jnp.asarray(X))
    assert set(got) == set(want) == {"prediction"}
    if not ties:
        np.testing.assert_allclose(got["prediction"].numpy(),
                                   np.asarray(want["prediction"]),
                                   rtol=1e-5, atol=1e-5)


def test_gbt_regressor_grid_matches_jax():
    """2 folds x 2 grid points: each fold's base is its weighted label mean,
    the first round's trees are equal, the later rounds' predictions close,
    and the CV RMSE of each candidate within 1e-3 relative."""
    X, y = _reg_data()
    W = _fold_weights(y, 2)
    grids = [{"min_instances_per_node": 10}, {"min_instances_per_node": 100}]
    kw = dict(max_iter=4, max_depth=3)
    ref = jt.OpGBTRegressor(**kw).fit_arrays_grid(X, y, W, grids)
    port = pt.OpGBTRegressor(**kw).fit_arrays_grid(X, y, W, grids,
                                                   device="cpu")
    Xd = torch.as_tensor(X)
    for k in range(2):
        want_base = float((W[k] @ y) / W[k].sum())
        for g in range(2):
            p, r = port[k][g], ref[k][g]
            assert p["task"] == r["task"] == "regression"
            np.testing.assert_allclose(p["base"], r["base"], rtol=1e-6)
            np.testing.assert_allclose(p["base"], want_base, rtol=1e-6)
            for key in ("feature", "threshold", "is_leaf"):
                np.testing.assert_array_equal(np.asarray(p[key])[0],
                                              np.asarray(r[key])[0])
            np.testing.assert_allclose(np.asarray(p["leaf"])[0],
                                       np.asarray(r["leaf"])[0], rtol=1e-5,
                                       atol=1e-6)
            pp = pt.TreeEnsembleModel(fitted=p).device_scores(Xd)
            jp = jt.TreeEnsembleModel(fitted=r).device_scores(jnp.asarray(X))
            va = W[k] == 0
            rmse = lambda v: float(np.sqrt(np.mean((v[va] - y[va]) ** 2)))
            np.testing.assert_allclose(
                rmse(pp["prediction"].numpy()),
                rmse(np.asarray(jp["prediction"])), rtol=1e-3)


def test_forest_regressor_scores_are_mean_leaves():
    """A bootstrapped "onethird" forest regressor: leaves are node means
    (V = 1), its prediction the mean of the reached leaves, and the CV
    panel's forest prediction the same numbers."""
    X, y = _reg_data(600)
    est = pt.OpRandomForestRegressor(num_trees=4, max_depth=4)
    assert est._strategy(est._params) == "onethird"
    fit = est.fit_arrays(X, y, device="cpu")
    assert fit["task"] == "regression" and fit["leaf"].shape[2] == 1
    model = pt.TreeEnsembleModel(fitted=fit)
    pred = model.device_scores(torch.as_tensor(X))["prediction"]
    walk = tk.tree_walk_twin(torch.as_tensor(X), fit["feature"],
                             fit["threshold"], fit["is_leaf"], fit["leaf"],
                             5, 1, "sum")[:, 0, 0] / 4.0
    torch.testing.assert_close(pred, walk, rtol=1e-6, atol=1e-6)
    assert abs(float(pred.mean()) - float(y.mean())) < 0.5


# --------------------------------------------------------------------------
# linear: the squared loss, ridge
# --------------------------------------------------------------------------

def test_linear_grid_fit_squared_matches_jax():
    X, y = _reg_data(1500)
    W = _fold_weights(y)
    l2s = np.asarray([0.001, 0.01, 0.05, 0.1], np.float32)
    l1s = np.asarray([0.001, 0.005, 0.01, 0.05], np.float32)
    ref = js.linear_grid_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                             jnp.asarray(l2s), jnp.asarray(l1s),
                             loss="squared", max_iter=50)
    got = ps.linear_grid_fit(torch.as_tensor(X), torch.as_tensor(y),
                             torch.as_tensor(W), torch.as_tensor(l2s),
                             torch.as_tensor(l1s), loss="squared",
                             max_iter=50)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.intercept.numpy(),
                               np.asarray(ref.intercept), rtol=0, atol=1e-4)
    d_it = np.abs(got.n_iter.numpy() - np.asarray(ref.n_iter))
    assert d_it.max() <= 2 and (d_it > 0).sum() <= 2


def _ridge_f64(X, y, w, l2):
    """Standardised weighted ridge solved in f64: coef [D], intercept."""
    X, y, w = (a.astype(np.float64) for a in (X, y, w))
    s = w.sum()
    m = w @ X / s
    ym = w @ y / s
    Xc = X - m
    scale = np.sqrt(np.maximum((w @ (Xc * Xc)) / s, 1e-12))
    A = (Xc * w[:, None]).T @ Xc / s / np.outer(scale, scale)
    b = (Xc * w[:, None]).T @ (y - ym) / s / scale
    c = np.linalg.solve(A + l2 * np.eye(len(m)), b) / scale
    return c, ym - m @ c


def test_ridge_grid_fit_matches_jax_and_f64():
    X, y = _reg_data(1500)
    X[:, 3] += 50.0                              # a column of large mean
    W = _fold_weights(y)
    l2s = np.asarray([0.001, 0.01, 0.1, 0.2], np.float32)
    ref = js.ridge_grid_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                            jnp.asarray(l2s))
    got = ps.ridge_grid_fit(torch.as_tensor(X), torch.as_tensor(y),
                            torch.as_tensor(W), torch.as_tensor(l2s))
    assert got.coef.shape == (3, 4, X.shape[1])
    assert got.intercept.shape == (3, 4, 1)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.intercept.numpy(),
                               np.asarray(ref.intercept), rtol=1e-4)
    for f in range(3):
        for g, l2 in enumerate(l2s):
            c, b = _ridge_f64(X, y, W[f], float(l2))
            np.testing.assert_allclose(got.coef[f, g].numpy(), c, rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(float(got.intercept[f, g, 0]), b,
                                       rtol=1e-4)


def test_ridge_fit_matches_jax_and_f64():
    X, y = _reg_data(800)
    w = np.random.default_rng(3).integers(0, 3, 800).astype(np.float32)
    for fit_intercept in (True, False):
        ref = js.ridge_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                           jnp.float32(0.05), fit_intercept=fit_intercept)
        got = ps.ridge_fit(torch.as_tensor(X), torch.as_tensor(y),
                           torch.as_tensor(w), 0.05,
                           fit_intercept=fit_intercept)
        np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got.intercept.numpy(),
                                   np.asarray(ref.intercept), rtol=1e-4,
                                   atol=1e-6)
    # unstandardised, with an intercept, against f64 normal equations
    got = ps.ridge_fit(torch.as_tensor(X), torch.as_tensor(y),
                       torch.as_tensor(w), 0.05)
    X64, y64, w64 = X.astype(np.float64), y.astype(np.float64), w.astype(
        np.float64)
    m, ym = w64 @ X64 / w64.sum(), w64 @ y64 / w64.sum()
    Xc = X64 - m
    c = np.linalg.solve((Xc * w64[:, None]).T @ Xc / w64.sum()
                        + 0.05 * np.eye(X.shape[1]),
                        (Xc * w64[:, None]).T @ (y64 - ym) / w64.sum())
    np.testing.assert_allclose(got.coef.numpy(), c, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.intercept[0]), ym - m @ c,
                               rtol=1e-4)


def test_linear_regression_estimator_paths():
    """Ridge when no grid point has an l1 penalty, FISTA on the squared
    loss otherwise; the single fit standardises and solves like the JAX
    package; a SparseMatrix is refused with the skip seam's TypeError."""
    from transmogrifai_tpu.models.linear import OpLinearRegression as JLR
    from transmogrifai_tpu_torch.models.linear import \
        OpLinearRegression as PLR
    X, y = _reg_data(800)
    for kw in ({"reg_param": 0.05}, {"reg_param": 0.05,
                                     "elastic_net_param": 0.5}):
        ref = JLR(max_iter=50, **kw).fit_arrays(X, y)
        got = PLR(max_iter=50, **kw).fit_arrays(X, y, device="cpu")
        assert got["kind"] == ref["kind"] == "regression"
        np.testing.assert_allclose(got["coef"].numpy(), ref["coef"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["intercept"].numpy(),
                                   ref["intercept"], rtol=0, atol=1e-4)
    W = _fold_weights(y)
    grid = [{"reg_param": 0.01}, {"reg_param": 0.1}]
    ref = JLR().fit_arrays_grid(X, y, W, grid)
    got = PLR().fit_arrays_grid(X, y, W, grid, device="cpu")
    for f in range(3):
        for g in range(2):
            assert got[f][g]["n_iter"] == ref[f][g]["n_iter"] == 0
            np.testing.assert_allclose(got[f][g]["coef"].numpy(),
                                       ref[f][g]["coef"], rtol=1e-4,
                                       atol=1e-6)
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    sp = SparseMatrix.from_dense(torch.as_tensor(X))
    with pytest.raises(TypeError, match="sparse regression"):
        PLR().fit_arrays_grid(sp, y, W, grid, device="cpu")


# --------------------------------------------------------------------------
# metric panels and the evaluator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["RootMeanSquaredError",
                                    "MeanSquaredError", "MeanAbsoluteError"])
def test_regression_panels_match_jax(metric):
    rng = np.random.default_rng(4)
    n, F, G = 300, 3, 4
    y = rng.normal(size=n).astype(np.float32)
    S = (y[:, None, None] + rng.normal(size=(n, F, G))).astype(np.float32)
    W = (rng.random((F, n)) > 0.6).astype(np.float32)
    want = np.asarray(jmd.masked_reg_metric_fold_grid(
        jnp.asarray(y), jnp.asarray(S), jnp.asarray(W), metric=metric))
    got = pmd.masked_reg_metric_fold_grid(torch.as_tensor(y),
                                          torch.as_tensor(S),
                                          torch.as_tensor(W), metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    S2 = S[:, 0]
    for Wg in (W[0], np.repeat(W[:1], G, axis=0)):
        want = np.asarray(jmd.masked_reg_metric_grid(
            jnp.asarray(y), jnp.asarray(S2), jnp.asarray(Wg), metric=metric))
        got = pmd.masked_reg_metric_grid(torch.as_tensor(y),
                                         torch.as_tensor(S2),
                                         torch.as_tensor(Wg), metric)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        pmd.masked_reg_errors(torch.as_tensor(y), torch.as_tensor(S2[:, 0]),
                              torch.as_tensor(W[0])).numpy(),
        np.asarray(jmd.masked_reg_errors(jnp.asarray(y),
                                         jnp.asarray(S2[:, 0]),
                                         jnp.asarray(W[0]))), rtol=1e-6)


def test_r2_panel_matches_host_r2():
    rng = np.random.default_rng(5)
    y = rng.normal(size=200).astype(np.float32)
    S = (y[:, None] + 0.5 * rng.normal(size=(200, 3))).astype(np.float32)
    w = (rng.random(200) > 0.3).astype(np.float32)
    got = pmd.masked_reg_metric_grid(torch.as_tensor(y), torch.as_tensor(S),
                                     torch.as_tensor(w), "R2").numpy()
    v = w > 0
    want = [1.0 - np.mean((S[v, j] - y[v]) ** 2) / np.var(y[v])
            for j in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluator_matches_jax_with_errors_on_edges():
    """The full panel against the JAX package's, on errors spread over
    their range and on errors that fall exactly on histogram edges."""
    from transmogrifai_tpu.evaluators import OpRegressionEvaluator as JEv
    from transmogrifai_tpu_torch.evaluators import Evaluators
    rng = np.random.default_rng(6)
    y = rng.normal(size=400).astype(np.float32)
    cases = [y + rng.normal(size=400).astype(np.float32),
             # errors 0, 1, ..., 20 with 20 bins: every error on an edge
             y + np.arange(400, dtype=np.float32) % 21]
    w = np.ones(400, np.float32)
    w[::7] = 0.0
    for pred in cases:
        want = JEv().evaluate_all_device(
            jnp.asarray(y), {"prediction": jnp.asarray(pred)},
            jnp.asarray(w)).to_json()
        got = Evaluators.Regression.rmse().evaluate_all_device(
            torch.as_tensor(y), {"prediction": torch.as_tensor(pred)},
            torch.as_tensor(w)).to_json()
        assert set(got) == set(want)
        for k in ("RootMeanSquaredError", "MeanSquaredError",
                  "MeanAbsoluteError", "R2"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        h, jh = (got["SignedPercentageErrorHistogram"],
                 want["SignedPercentageErrorHistogram"])
        assert h["counts"] == jh["counts"]
        np.testing.assert_allclose(h["bins"], jh["bins"], rtol=1e-6)
    # the edge case: counts by searchsorted(side="right") on f32 edges
    err = (cases[1] - y)[w > 0]
    edges = np.linspace(err.min(), err.max(), 21)
    idx = np.clip(np.searchsorted(edges[1:-1].astype(np.float32), err,
                                  side="right"), 0, 19)
    assert h["counts"] == np.bincount(idx, minlength=20).tolist()
    ev = Evaluators.Regression
    assert [e().default_metric for e in (ev.rmse, ev.mse, ev.mae, ev.r2)] == [
        "RootMeanSquaredError", "MeanSquaredError", "MeanAbsoluteError",
        "R2"]
    assert not ev.rmse().is_larger_better and ev.r2().is_larger_better


# --------------------------------------------------------------------------
# the selector on Boston housing, convert, LOCO and the summary
# --------------------------------------------------------------------------

def _boston_columns(pkg):
    """The Boston CSV read with numpy, typed as tests/test_workflow_e2e.py
    types it (``chas`` a PickList, ``rad`` Integral, ``medv`` the RealNN
    response, the rest Real)."""
    C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
    raw = np.loadtxt(BOSTON, delimiter=",")
    cols, schema = {}, {}
    for j, h in enumerate(BOSTON_HEADERS):
        if h == "rowId":
            continue
        v = raw[:, j]
        if h == "medv":
            cols[h], schema[h] = C.Column(TY.RealNN, v.astype(np.float32)), \
                TY.RealNN
        elif h == "chas":
            cols[h] = C.text_column(TY.PickList, [str(int(x)) for x in v])
            schema[h] = TY.PickList
        elif h == "rad":
            cols[h] = C.Column(TY.Integral, v.astype(np.int64),
                               mask=np.ones(len(v), bool))
            schema[h] = TY.Integral
        else:
            cols[h] = C.Column(TY.Real, v.astype(np.float32),
                               mask=np.ones(len(v), bool))
            schema[h] = TY.Real
    return cols, schema, len(raw)


def _boston_models(pkg):
    S = _mod(pkg, "selector")
    lin, trees = _mod(pkg, "models.linear"), _mod(pkg, "models.trees")
    return [S.ModelCandidate(lin.OpLinearRegression(),
                             S.grid(reg_param=[0.01, 0.1]),
                             "OpLinearRegression"),
            S.ModelCandidate(trees.OpRandomForestRegressor(),
                             S.grid(num_trees=[5], max_depth=[4]),
                             "OpRandomForestRegressor"),
            S.ModelCandidate(trees.OpGBTRegressor(), S.grid(max_iter=[5]),
                             "OpGBTRegressor")]


def _boston_train(pkg, models=None):
    cols, schema, n = _boston_columns(pkg)
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S = _mod(pkg, "selector")
    medv, predictors = F.features_from_schema(schema, response="medv")
    fv = _mod(pkg, "ops.transmogrify").transmogrify(predictors)
    sel = S.RegressionModelSelector(
        models=_boston_models(pkg) if models is None else models)
    sel.set_input(medv, fv)
    pred = sel.get_output()
    batch = C.ColumnBatch(cols, n)
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(batch)
    model = wf.set_result_features(pred).train()
    ev = _mod(pkg, "evaluators").Evaluators.Regression.rmse()
    return {"model": model, "batch": batch, "pred": pred, "fv": fv,
            "metrics": model.evaluate(ev, batch=batch)}


@pytest.fixture(scope="module")
def boston():
    return _boston_train(JAX), _boston_train(PORT)


def _cv(run):
    return [(r.model_name, r.params, r.metric_values["RootMeanSquaredError"],
             r.raced_out)
            for r in run["model"].selected_model.summary.validation_results]


def test_boston_selector_matches_jax(boston):
    ref, port = boston
    rs, ps_ = _cv(ref), _cv(port)
    assert [(n, p, r) for n, p, _, r in ps_] == [(n, p, r) for n, p, _, r in rs]
    for (name, _, pm, _), (_, _, jm, _) in zip(ps_, rs):
        if name == "OpRandomForestRegressor":
            assert abs(pm - jm) <= BOSTON_RF_TOL, (name, pm, jm)
        else:
            tol = (1e-4 if name == "OpLinearRegression"
                   else BOSTON_GBT_RTOL)
            np.testing.assert_allclose(pm, jm, rtol=tol, err_msg=name)
    ps_sum = port["model"].selected_model.summary
    assert ps_sum.best_model_name == \
        ref["model"].selected_model.summary.best_model_name
    assert ps_sum.problem_type == "Regression"
    assert ps_sum.evaluation_metric == "RootMeanSquaredError"
    assert port["metrics"]["R2"] > 0.6 and ref["metrics"]["R2"] > 0.6
    if ps_sum.best_model_name == "OpLinearRegression":
        np.testing.assert_allclose(port["metrics"]["RootMeanSquaredError"],
                                   ref["metrics"]["RootMeanSquaredError"],
                                   rtol=1e-4)
    scored = port["model"].score(port["batch"])[port["pred"].name].values
    assert set(scored) == {"prediction"} or scored.get("probability") is None
    assert tuple(scored["prediction"].shape) == (len(port["batch"]),)
    assert set(port["model"].selected_model.selector_seconds) == {
        "OpLinearRegression", "OpRandomForestRegressor", "OpGBTRegressor",
        "refit", "train_evaluation"}


def _xgb_gain_f64(X, g, rows, f, th, lam=1.0):
    """The xgb gain (h = 1) of splitting ``rows`` at (feature, threshold),
    in f64."""
    gg = g[rows]
    r = X[rows, f] > th
    s = lambda m: gg[m].sum() ** 2 / (m.sum() + lam)
    return 0.5 * (s(~r) + s(r) - gg.sum() ** 2 / (len(gg) + lam))


def test_boston_gbt_trees_differ_only_at_exact_ties(boston):
    """The Boston GBT regressor's per-fold fits (the selector's folds, the
    JAX vector) in both packages: each fold's base rtol 1e-6, and every
    round equal on reachable nodes up to the first round where they part;
    there each topmost differing node is a tie, its two choices' gains
    equal within 1e-6 in f64 on the rows that reach it."""
    ref = boston[0]
    X, _ = _vector(ref)
    y = np.asarray(ref["batch"]["medv"].values, np.float32)
    W = _fold_weights(y)
    grids = [{"max_iter": 5}]
    jfits = jt.OpGBTRegressor().fit_arrays_grid(X, y, W, grids)
    pfits = pt.OpGBTRegressor().fit_arrays_grid(X, y, W, grids, device="cpu")
    parted = 0
    for k in range(3):
        a, b = jfits[k][0], pfits[k][0]
        np.testing.assert_allclose(b["base"], a["base"], rtol=1e-6)
        fa, fb = np.asarray(a["feature"]), np.asarray(b["feature"])
        ta, tb = np.asarray(a["threshold"]), np.asarray(b["threshold"])
        la = np.asarray(a["is_leaf"])
        margin = np.full(len(y), a["base"], np.float64)
        for rd in range(fa.shape[0]):
            reach = _reachable(la[rd][None])[0] & ~la[rd]
            diff = [i for i in np.nonzero(reach & ((fa[rd] != fb[rd])
                                                   | (ta[rd] != tb[rd])))[0]
                    if i == 0 or not (reach[(i - 1) // 2] and (
                        fa[rd][(i - 1) // 2] != fb[rd][(i - 1) // 2]))]
            if diff:
                g = margin - y
                for i in diff:
                    path, j = [], i
                    while j:
                        path.append(((j - 1) // 2, j % 2 == 0))
                        j = (j - 1) // 2
                    rows = W[k] > 0
                    for par, right in path:
                        rows &= (X[:, fa[rd][par]] > ta[rd][par]) == right
                    ga = _xgb_gain_f64(X, g, rows, fa[rd][i], ta[rd][i])
                    gb = _xgb_gain_f64(X, g, rows, fb[rd][i], tb[rd][i])
                    assert abs(ga - gb) <= 1e-6 * abs(ga), (k, rd, i, ga, gb)
                parted += 1
                break
            np.testing.assert_allclose(np.asarray(b["leaf"])[rd][reach],
                                       np.asarray(a["leaf"])[rd][reach],
                                       rtol=1e-5, atol=1e-6)
            step = jt._predict_trees_np(X, fa[rd][None], ta[rd][None],
                                        la[rd][None],
                                        np.asarray(a["leaf"])[rd][None],
                                        int(a["max_depth"]) + 1)[:, 0, 0]
            margin = margin + a["eta"] * step
    assert parted <= 2


def _vector(run):
    """The Boston feature vector of a trained run, as numpy with its meta
    as JSON."""
    batch = run["model"].score(run["batch"], keep_intermediate_features=True)
    col = batch[run["fv"].name]
    X = col.values
    X = X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    return X.astype(np.float32), col.meta.to_json()


def _jax_fit(kind, X, y):
    from transmogrifai_tpu.columns import Column as JC
    from transmogrifai_tpu.columns import ColumnBatch as JB
    from transmogrifai_tpu.features import Feature as JF
    from transmogrifai_tpu.models import linear as jlin
    from transmogrifai_tpu.types import OPVector as JV
    from transmogrifai_tpu.types import RealNN as JR
    est = {"linreg": lambda: jlin.OpLinearRegression(reg_param=0.01),
           "linreg_en": lambda: jlin.OpLinearRegression(
               reg_param=0.01, elastic_net_param=0.5, max_iter=50),
           "gbt": lambda: jt.OpGBTRegressor(max_iter=5, max_depth=3),
           "rf": lambda: jt.OpRandomForestRegressor(num_trees=5,
                                                    max_depth=4)}[kind]()
    est.set_input(JF("label", JR, True, None, parents=()),
                  JF("v", JV, False, None, parents=()))
    return est.fit(JB({"label": JC(JR, y), "v": JC(JV, X)}, len(y)))


@pytest.fixture(scope="module")
def jax_boston_models(boston):
    ref = boston[0]
    X, meta = _vector(ref)
    y = np.asarray(ref["batch"]["medv"].values, np.float32)
    from transmogrifai_tpu_torch import convert
    out = {}
    for kind in ("linreg", "linreg_en", "gbt", "rf"):
        jm = _jax_fit(kind, X, y)
        out[kind] = (jm, convert.prediction_model(
            {"model": type(jm).__name__,
             "fitted": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                        for k, v in jm.fitted.items()}}, CPU))
    return X, meta, out


@pytest.mark.parametrize("kind", ["linreg", "linreg_en", "gbt", "rf"])
def test_convert_scores_jax_regressors_like_jax(jax_boston_models, kind):
    X, _, ms = jax_boston_models
    jm, pm = ms[kind]
    want = np.asarray(jm.device_scores(jnp.asarray(X))["prediction"])
    got = pm.device_scores(torch.as_tensor(X))
    assert set(got) == {"prediction"}
    np.testing.assert_allclose(got["prediction"].numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["linreg", "gbt", "rf"])
def test_loco_explains_the_prediction_like_jax(jax_boston_models, kind):
    """LOCO on a regression model explains ``prediction`` (no sigmoid):
    the port's twin on the converted JAX model against the JAX package's
    RecordInsightsLOCO on the Boston vector, grouped by raw parent."""
    from transmogrifai_tpu import record_insights as jri
    from transmogrifai_tpu.columns import Column as JC
    from transmogrifai_tpu.columns import ColumnBatch as JB
    from transmogrifai_tpu.features import Feature as JF
    from transmogrifai_tpu.types import OPVector as JV
    from transmogrifai_tpu.vector_meta import VectorMeta as JVM
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch import record_insights as pri
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import Feature
    from transmogrifai_tpu_torch.types import OPVector
    from transmogrifai_tpu_torch.vector_meta import VectorMeta
    X, meta, ms = jax_boston_models
    jm, pm = ms[kind]
    jl = jri.RecordInsightsLOCO(model=jm, top_k=4)
    jl.set_input(JF("v", JV, False, None, parents=()))
    want = jl.transform(JB({"v": JC(JV, X, meta=JVM.from_json(meta))},
                           len(X))).values
    pl = pri.RecordInsightsLOCO(model=pm, top_k=4)
    pl.set_input(Feature("v", OPVector, False, None, parents=()))
    got = pl.transform(ColumnBatch(
        {"v": Column(OPVector, torch.as_tensor(X),
                     meta=VectorMeta.from_json(meta))}, len(X),
        device="cpu")).values
    scale = float(np.abs(np.asarray(
        jm.device_scores(jnp.asarray(X))["prediction"])).max())
    tol = 1e-6 * scale
    for rw, rg in zip(want, got):
        pw = [(k, json.loads(v)[0][1]) for k, v in rw.items()]
        pg = [(k, json.loads(v)[0][1]) for k, v in rg.items()]
        assert len(pw) == len(pg) == 4
        for (nw, vw), (ng, vg) in zip(pw, pg):
            if nw != ng:
                assert abs(abs(vw) - abs(vg)) <= tol
        dw, dg = dict(pw), dict(pg)
        for n in set(dw) & set(dg):
            assert abs(dw[n] - dg[n]) <= tol, (n, dw[n], dg[n])
    # the score explained is the prediction itself: a group's diff is the
    # prediction's change, which a sigmoid would squash into (-1, 1)
    assert max(abs(json.loads(v)[0][1]) for r in got for v in r.values()) > 1
    assert torch.equal(ik.loco_score(pm, torch.as_tensor(X)),
                       pm.device_scores(torch.as_tensor(X))["prediction"])


def test_summary_matches_jax():
    """``WorkflowModel.summary()`` of the Boston LinReg workflow against the
    JAX package's: the same keys, numbers rtol 1e-5, the error histogram's
    counts equal and its edges within 1e-5 of its range."""
    runs = []
    for pkg in (JAX, PORT):
        S = _mod(pkg, "selector")
        lin = _mod(pkg, "models.linear")
        runs.append(_boston_train(pkg, [S.ModelCandidate(
            lin.OpLinearRegression(), S.grid(reg_param=[0.01, 0.1]),
            "OpLinearRegression")])["model"].summary())
    want, got = runs
    for s in (want, got):
        s.pop("stageInfo")
        s["selectedModelInfo"].pop("bestModelUID")
        s["selectedModelInfo"]["validationParameters"].pop("parallelism")
    _assert_summary_close(got, want)


def _assert_json_close(got, want, path="summary"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def _assert_summary_close(got, want, path="summary"):
    """``_assert_json_close``, but the error histogram's edges within 1e-5
    of the error range (an edge near 0 inherits the absolute error of the
    range's ends)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            if k == "SignedPercentageErrorHistogram":
                assert got[k]["counts"] == want[k]["counts"], path
                span = max(want[k]["bins"]) - min(want[k]["bins"])
                np.testing.assert_allclose(got[k]["bins"], want[k]["bins"],
                                           rtol=0, atol=1e-5 * span)
            else:
                _assert_summary_close(got[k], want[k], f"{path}.{k}")
    else:
        _assert_json_close(got, want, path)


def test_make_regression_data_is_the_bench_draw():
    """The port's generator against the lines of bench.run_selector_smoke
    that draw the regression data (after its multiclass draws), run here
    as the bench writes them."""
    import bench
    from transmogrifai_tpu_torch.synthetic import make_regression_data
    src = inspect.getsource(bench.run_selector_smoke)
    lines = ["rng = np.random.default_rng(11)",
             "ym = rng.integers(0, C, n)",
             "centers = rng.normal(size=(C, d)) * 2.5",
             "Xm = (centers[ym] + rng.normal(size=(n, d))).astype(np.float32)",
             "w = rng.normal(size=d).astype(np.float32)",
             "Xr = rng.normal(size=(n, d)).astype(np.float32)",
             "yr = Xr @ w + 0.3 * rng.normal(size=n).astype(np.float32)"]
    pos = [src.index(line) for line in lines]
    assert pos == sorted(pos)
    env = {"np": np, "n": 4000, "d": 16, "C": 4}
    exec("\n".join(lines), env)
    X, y = make_regression_data(4000)
    np.testing.assert_array_equal(X, env["Xr"])
    np.testing.assert_array_equal(y, env["yr"].astype(np.float32))
    assert X.dtype == y.dtype == np.float32


# --------------------------------------------------------------------------
# measurement script: the JAX package's Boston RF CV RMSE over forest seeds
# --------------------------------------------------------------------------

def _boston_rf_spread(seeds=(42, 0, 1, 2, 3)) -> dict:
    vals = []
    for seed in seeds:
        S = _mod(JAX, "selector")
        est = jt.OpRandomForestRegressor(seed=seed)
        run = _boston_train(JAX, [S.ModelCandidate(
            est, S.grid(num_trees=[5], max_depth=[4]),
            "OpRandomForestRegressor")])
        vals.append(float(_cv(run)[0][2]))
    return {"seeds": list(seeds), "cv_rmse": vals,
            "spread": max(vals) - min(vals)}


if __name__ == "__main__":
    print(json.dumps({"boston_rf_cv_rmse": _boston_rf_spread()}))
