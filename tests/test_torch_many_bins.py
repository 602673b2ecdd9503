"""The tree families at ``max_bins=64`` against the JAX package.

``bin_data`` holds up to 127 bins and the estimators take ``max_bins`` up to
that; the split kernels hold them too (lane l of a warp takes bins
l*Q .. l*Q+Q-1, ``csrc/split_scan.cuh``).  On the CPU the same fits run on
the twins: each family at 64 bins on 2,000 x 4 normal rows against the JAX
package's fit at the same ``max_bins``, at the tolerances the port holds
each family to elsewhere — the same trees (features, leaf flags,
thresholds) and leaf values within 1e-5 for the decision trees, the
forests without random draws (``bootstrap=False``, every feature) and the
GBT rounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

N, D, NB = 2000, 4, 64


def _data(task: str):
    rng = np.random.default_rng(64)
    X = rng.normal(size=(N, D)).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1] ** 2 - 0.7 * X[:, 2] * X[:, 3]
    if task == "classification":
        y = (z + 0.3 * rng.normal(size=N) > 0.4).astype(np.float32)
    else:
        y = (z + 0.1 * rng.normal(size=N)).astype(np.float32)
    return X, y


def _reachable(is_leaf: np.ndarray) -> np.ndarray:
    reach = np.ones(len(is_leaf), bool)
    for node in range(1, len(reach)):
        parent = (node - 1) // 2
        reach[node] = reach[parent] and not is_leaf[parent]
    return reach


def _assert_same_trees(port: dict, ref: dict, rtol: float = 1e-5):
    pl = np.asarray(port["is_leaf"])
    np.testing.assert_array_equal(pl, np.asarray(ref["is_leaf"]))
    for t in range(pl.shape[0]):
        reach = _reachable(pl[t])
        for key in ("feature", "threshold"):
            np.testing.assert_array_equal(
                np.asarray(port[key])[t][reach & ~pl[t]],
                np.asarray(ref[key])[t][reach & ~pl[t]])
        np.testing.assert_allclose(np.asarray(port["leaf"])[t][reach],
                                   np.asarray(ref["leaf"])[t][reach],
                                   rtol=rtol, atol=1e-6)


def test_bins_reach_64():
    """At 64 bins the bin ids really run past the 32 a warp lane held."""
    X, _ = _data("classification")
    _, _, B = pt.binned(X, torch.as_tensor(X), NB)
    assert int(B.max()) >= 60


@pytest.mark.parametrize("family", [
    "OpDecisionTreeClassifier", "OpRandomForestClassifier",
    "OpDecisionTreeRegressor", "OpRandomForestRegressor"])
def test_tree_family_at_64_bins_matches_jax(family):
    """Decision trees, and forests of 3 trees without bootstrap over every
    feature (no random draws: each tree is the decision tree), fitted at
    ``max_bins=64`` on the twins, equal the JAX package's on every
    reachable node and score the same."""
    task = "regression" if "Regressor" in family else "classification"
    X, y = _data(task)
    kw = dict(max_depth=5, min_instances_per_node=5, max_bins=NB)
    if "Forest" in family:
        kw.update(num_trees=3, bootstrap=False,
                  feature_subset_strategy="all")
    ref = getattr(jt, family)(**kw).fit_arrays(X, y)
    port = getattr(pt, family)(**kw).fit_arrays(X, y, device="cpu")
    _assert_same_trees(port, ref)
    got = pt.TreeEnsembleModel(fitted=port).device_scores(torch.as_tensor(X))
    want = jt.TreeEnsembleModel(fitted=ref).device_scores(jnp.asarray(X))
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_gbt_at_64_bins_matches_jax(task):
    """GBT at ``max_bins=64``, 3 rounds of depth 3: the port's rounds equal
    the JAX package's trees, the leaves agree within 1e-4 (each round's
    gradients sum the previous rounds' f32 margins, whose summation order
    differs between the packages) and the per-feature gains, differences
    of node scores, within 1e-5 of the trees' total gain."""
    X, y = _data(task)
    kw = dict(n_rounds=3, max_depth=3, max_bins=NB, min_instances=10.0,
              min_gain=0.0, eta=0.1, lam=1.0)
    ref = jt.fit_gbt(X, y, task=task, seed=0, **kw)
    port = pt.fit_gbt(X, y, task=task, device="cpu", **kw)
    _assert_same_trees(port, ref, rtol=1e-4)
    ref_gain = np.asarray(ref["feature_gain"])
    np.testing.assert_allclose(port["feature_gain"].numpy(), ref_gain,
                               rtol=0, atol=1e-5 * float(ref_gain.sum()))


@pytest.mark.parametrize("n_bins", [33, 64, 127])
def test_split_twins_take_the_first_max_past_32_bins(n_bins):
    """Past 32 bins the split twins still take the first max over
    (feature, bin): a histogram whose best cut lies in the last lane's bins
    and ties a cut of a later feature picks the earlier feature, at the
    lowest of equal bins."""
    K, P, S = 1, 1, 3
    hist = torch.zeros((K, P, 2, n_bins, S))
    for d in range(2):
        hist[0, 0, d, n_bins - 3, :] = torch.tensor([10.0, 10.0, 0.0])
        hist[0, 0, d, n_bins - 1, :] = torch.tensor([10.0, 0.0, 10.0])
    tot = hist[:, :, 0].sum(dim=2)
    fmask = torch.ones(2, dtype=torch.bool)
    splits = torch.arange(2 * (n_bins - 1), dtype=torch.float32).reshape(
        2, n_bins - 1)
    one = torch.ones(K)
    out = tk.tree_split_gini_twin(hist, tot, fmask, None, splits, one,
                                  0 * one)
    assert int(out["feature"][0, 0]) == 0
    assert int(out["bin"][0, 0]) == n_bins - 3
    assert float(out["threshold"][0, 0]) == float(splits[0, n_bins - 3])
