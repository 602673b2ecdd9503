"""Trees deeper than 7 in the PyTorch port against the JAX package's
``_fit_tree_unrolled``, on the CPU.

The port grows every depth with one level loop; the JAX package switches to
its unrolled form past depth 7, which routes rows on below a leaf and so
writes other thresholds and leaf values on nodes no walk reaches.  So trees
are compared on their reachable nodes (every ancestor a split): feature,
threshold and leaf flag identical, leaf values rtol 1e-5; predictions and
per-feature gains as for shallow trees.  Also pinned here: the port's own
convention below a leaf, the split twins' closed form for empty nodes
against the full gain table (exact), the fit's closed form for the levels
below its last live row, lane batching under the byte budget (exact), the
node-masked histogram, and ``convert`` of a JAX depth-12 forest (scores
rtol 1e-6)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

N, D, NB = 3000, 6, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:, 5] = np.round(X[:, 5], 1)                  # ties at split values
    w = rng.normal(size=D).astype(np.float32)
    logits = X @ w + 0.8 * X[:, 0] * X[:, 1] - 0.5 * X[:, 2] ** 2
    y = ((logits + rng.normal(size=N)) > 0).astype(np.float32)
    return X, y


def _reachable(is_leaf: np.ndarray) -> np.ndarray:
    """[..., T] nodes whose every ancestor is a split."""
    T = is_leaf.shape[-1]
    r = np.zeros_like(is_leaf, dtype=bool)
    r[..., 0] = True
    for i in range(1, T):
        p = (i - 1) // 2
        r[..., i] = r[..., p] & ~is_leaf[..., p]
    return r


def _assert_same_reachable(port: dict, ref: dict, min_depth: int,
                           near_tie=None):
    """Reachable nodes identical.  Where the two trees split one node on
    different (feature, threshold) and ``near_tie(tree, node, (feature,
    threshold) of the port, of JAX)`` finds the two choices' gains equal
    within rounding, that node's subtrees are left out (at most 2 such
    nodes a tree)."""
    pf, jf = np.asarray(port["feature"]), np.asarray(ref["feature"])
    pth, jth = np.asarray(port["threshold"]), np.asarray(ref["threshold"])
    pl, jl = np.asarray(port["is_leaf"]), np.asarray(ref["is_leaf"])
    pv, jv = np.asarray(port["leaf"]), np.asarray(ref["leaf"])
    T = pl.shape[-1]
    deepest = 0
    for t in range(pl.shape[0]):
        todo, ties = [0], 0
        while todo:
            i = todo.pop()
            deepest = max(deepest, int(np.log2(i + 1)))
            assert pl[t, i] == jl[t, i], (t, i)
            np.testing.assert_allclose(pv[t, i], jv[t, i], rtol=1e-5,
                                       atol=1e-7)
            if jl[t, i]:
                assert pf[t, i] == jf[t, i] == -1
                continue
            if (pf[t, i], pth[t, i]) != (jf[t, i], jth[t, i]):
                assert near_tie is not None and near_tie(
                    t, i, (pf[t, i], pth[t, i]), (jf[t, i], jth[t, i])), (t, i)
                ties += 1
                continue
            todo += [c for c in (2 * i + 1, 2 * i + 2) if c < T]
        assert ties <= 2, t
    # a tree this deep actually grew past the compact form's depth 7
    assert deepest >= min_depth


def _gini_near_tie(X, y, w, port_tree, t):
    """``near_tie`` for gini trees: both choices' gains at the node,
    recomputed in f64 from the rows that reach it (weights ``w``), agree
    within 1e-5 of wgini(parent)."""
    feat = np.asarray(port_tree["feature"])[t]
    thr = np.asarray(port_tree["threshold"])[t]

    def wgini(cnt, pos):
        c = max(cnt, 1e-12)
        return c * (1.0 - (pos / c) ** 2 - ((cnt - pos) / c) ** 2)

    def check(_, node, a, b):
        path, i = [], node
        while i:
            path.append(((i - 1) // 2, i % 2 == 0))
            i = (i - 1) // 2
        at = np.ones(len(y), bool)
        for parent, right in path:
            at &= (X[:, feat[parent]] > thr[parent]) == right
        ww, yy = w[at].astype(np.float64), y[at]
        parent = wgini(ww.sum(), (ww * yy).sum())

        def gain(f, th):
            r = X[at, f] > th
            return (parent - wgini(ww[~r].sum(), (ww[~r] * yy[~r]).sum())
                    - wgini(ww[r].sum(), (ww[r] * yy[r]).sum()))

        return abs(gain(*a) - gain(*b)) <= 1e-5 * parent

    return check


@pytest.fixture(scope="module")
def deep_tree(data):
    """A depth-12 decision tree (deterministic) in both packages."""
    X, y = data
    kw = dict(max_depth=12, min_instances_per_node=2)
    ref = jt.OpDecisionTreeClassifier(**kw).fit_arrays(X, y)
    port = pt.OpDecisionTreeClassifier(**kw).fit_arrays(X, y, device="cpu")
    return ref, port


def test_depth12_decision_tree_matches_unrolled_form(data, deep_tree):
    X, _ = data
    ref, port = deep_tree
    assert np.asarray(ref["feature"]).shape == (1, 2 ** 13 - 1)
    _assert_same_reachable(port, ref, 9)
    got = pt.TreeEnsembleModel(fitted=port).device_scores(torch.as_tensor(X))
    want = jt.TreeEnsembleModel(fitted=ref).device_scores(jnp.asarray(X))
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port["feature_gain"].numpy(),
                               np.asarray(ref["feature_gain"]), rtol=1e-4,
                               atol=1e-4)


def test_nodes_below_a_leaf_follow_the_ports_convention(deep_tree):
    """Below a leaf every node is a leaf with feature -1 and zero leaf
    values; the unrolled form writes values there that no walk reads."""
    ref, port = deep_tree
    is_leaf = port["is_leaf"].numpy()
    below = ~_reachable(is_leaf)
    assert below.any()
    assert is_leaf[below].all()
    assert (port["feature"].numpy()[below] == -1).all()
    assert (port["leaf"].numpy()[below] == 0).all()
    jleaf = np.asarray(ref["leaf"])
    assert (jleaf[below] != 0).any()


def test_depth12_gbt_matches_unrolled_form(data):
    """One boosting round, whose statistics (g = 0.5 - y, h = 0.25) sum
    exactly in f32 in any order, so no near-tie can flip a split; later
    rounds' gradients round, and a gap of one ulp may then pick another
    split in either package."""
    X, y = data
    kw = dict(n_rounds=1, max_depth=12, max_bins=NB, min_instances=5.0,
              min_gain=0.0, eta=0.1, lam=1.0)
    ref = jt.fit_gbt(X, y, task="classification", seed=0, **kw)
    port = pt.fit_gbt(X, y, device="cpu", **kw)
    _assert_same_reachable(port, ref, 9)
    got = pt.TreeEnsembleModel(fitted=port).device_scores(torch.as_tensor(X))
    want = jt.TreeEnsembleModel(fitted=ref).device_scores(jnp.asarray(X))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def forest_grid(data):
    """Depth-12 forests without bootstrap over all features (deterministic):
    two grid points that differ only in min_info_gain, over 2 folds."""
    X, y = data
    rng = np.random.default_rng(3)
    W = (rng.random((2, N)) > 1 / 3).astype(np.float32)
    grids = [{"min_info_gain": 0.001}, {"min_info_gain": 2.0}]
    kw = dict(num_trees=2, max_depth=12, min_instances_per_node=3,
              bootstrap=False, feature_subset_strategy="all")
    ref = jt.OpRandomForestClassifier(**kw).fit_arrays_grid(
        jnp.asarray(X), jnp.asarray(y), W, grids)
    port = pt.OpRandomForestClassifier(**kw).fit_arrays_grid(
        torch.as_tensor(X), y, W, grids)
    return ref, port, W


def test_depth12_forest_grid_with_per_lane_min_info_gain(data, forest_grid):
    X, y = data
    ref, port, W = forest_grid
    for k in range(2):
        for g in range(2):
            for t in range(2):
                one = {key: port[k][g][key][t:t + 1] for key in
                       ("feature", "threshold", "is_leaf", "leaf")}
                _assert_same_reachable(
                    one, {key: np.asarray(ref[k][g][key])[t:t + 1]
                          for key in one}, 9,
                    _gini_near_tie(X, y, W[k], one, 0))
        assert (port[k][1]["is_leaf"].sum() > port[k][0]["is_leaf"].sum())


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    if a.is_floating_point():
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return torch.equal(a, b)


def _table_first_max(gains, splits, min_gain):
    NB_ = splits.shape[1] + 1
    idx = torch.argmax(gains, dim=2)
    best = torch.gather(gains, 2, idx[..., None])[..., 0]
    feat, bin_ = idx // NB_, idx % NB_
    thr = splits[feat, torch.clamp(bin_, 0, NB_ - 2)]
    return best, feat.to(torch.int32), bin_.to(torch.int32), thr, ~(
        torch.isfinite(best) & (best > min_gain[:, None]))


@pytest.mark.parametrize("mi", [0.0, 5.0])
def test_split_twins_empty_nodes_equal_the_full_table(data, mi):
    """The split twins build the gain table only at non-empty nodes; the
    closed form at empty nodes must equal the full table's first max, with
    and without node subsets, also on a level where every node is empty."""
    X, y = data
    splits = torch.as_tensor(pt.build_bin_splits(X, NB))
    B = pt.bin_data(torch.as_tensor(X), splits)
    K, P = 3, 16
    rng = np.random.default_rng(5)
    # rows in only some of the level's nodes; the rest stay empty
    row_node = torch.as_tensor(
        (15 + rng.choice([0, 3, 4, 9], size=(K, N))).astype(np.int32))
    yt = torch.as_tensor(y)
    gstats = torch.stack([torch.ones(N), 1 - yt, yt], 1)[None].repeat(K, 1, 1)
    hist, tot = tk.tree_hist(B, row_node, gstats.contiguous(), 15, P, NB)
    assert (tot[..., 0] == 0).any()
    fmask = torch.tensor([True, False, True, True, True, True])
    node_mask = torch.as_tensor(rng.random((K, P, D)) > 0.4)
    node_mask[0, 1] = False                       # a node with no feature
    lane = lambda v: torch.full((K,), v)
    for nm in (None, node_mask):
        got = tk.tree_split_gini_twin(hist, tot, fmask, nm, splits, lane(mi),
                                      torch.tensor([0.0, 1e-3, -1.0]))
        want = _table_first_max(tk.split_gains_gini(hist, tot, fmask, nm,
                                                    lane(mi)), splits,
                                torch.tensor([0.0, 1e-3, -1.0]))
        for key, w in zip(("gain", "feature", "bin", "threshold", "is_leaf"),
                          want):
            assert _same(got[key], w), key
        h0, t0 = torch.zeros_like(hist), torch.zeros_like(tot)
        zero = tk.tree_split_gini_twin(h0, t0, fmask, nm, splits, lane(mi),
                                       torch.tensor([0.0, 1e-3, -1.0]))
        want = _table_first_max(tk.split_gains_gini(h0, t0, fmask, nm,
                                                    lane(mi)), splits,
                                torch.tensor([0.0, 1e-3, -1.0]))
        for key, w in zip(("gain", "feature", "bin", "threshold", "is_leaf"),
                          want):
            assert _same(zero[key], w), key
    lam = torch.tensor([1.0, 0.5, 0.0])
    xstats = torch.as_tensor(rng.normal(size=(K, N, 3)).astype(np.float32))
    xstats[..., 0], xstats[..., 2] = 1.0, xstats[..., 2].abs()
    hist, tot = tk.tree_hist(B, row_node, xstats, 15, P, NB)
    got = tk.tree_split_twin(hist, tot, fmask, splits, lane(mi), lane(0.0),
                             lam)
    want = _table_first_max(tk.split_gains(hist, tot, fmask, lane(mi), lam),
                            splits, lane(0.0))
    for key, w in zip(("gain", "feature", "bin", "threshold", "is_leaf"),
                      want):
        assert _same(got[key], w), key
    h0, t0 = torch.zeros_like(hist), torch.zeros_like(tot)
    zero = tk.tree_split_twin(h0, t0, fmask, splits, lane(mi), lane(0.0), lam)
    want = _table_first_max(tk.split_gains(h0, t0, fmask, lane(mi), lam),
                            splits, lane(0.0))
    for key, w in zip(("gain", "feature", "bin", "threshold", "is_leaf"),
                      want):
        assert _same(zero[key], w), key


def test_tree_hist_twin_node_mask_zeroes_cells_outside_the_subset(data):
    X, y = data
    splits = torch.as_tensor(pt.build_bin_splits(X, NB))
    B = pt.bin_data(torch.as_tensor(X), splits)
    rng = np.random.default_rng(2)
    K, P = 2, 4
    row_node = torch.as_tensor(rng.integers(2, 7, size=(K, N)).astype(np.int32))
    stats = torch.as_tensor(rng.poisson(1.0, size=(K, N, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.random((K, P, D)) > 0.5)
    full, tot = tk.tree_hist(B, row_node, stats, 3, P, NB)
    masked, tot_m = tk.tree_hist(B, row_node, stats, 3, P, NB, node_mask=mask)
    assert torch.equal(tot, tot_m)
    assert torch.equal(masked, torch.where(mask[..., None, None], full, 0.0))


def test_lane_batches_grow_the_same_forest(data, monkeypatch):
    """A byte budget that forces one lane per batch grows, lane for lane,
    the forest of one batch (bootstrap and node subsets on)."""
    X, y = data[0][:1000], data[1][:1000]
    W = np.ones((2, 1000), np.float32)
    W[0, :300] = 0.0
    est = pt.OpRandomForestClassifier(num_trees=3, max_depth=9,
                                      min_instances_per_node=5)
    grids = [{}, {"min_info_gain": 0.01}]
    one = est.fit_arrays_grid(torch.as_tensor(X), y, W, grids)
    monkeypatch.setitem(pt.LANE_BUDGET_BYTES, "cpu", 1)
    assert len(pt.lane_batches(12, 1, torch.device("cpu"))) == 12
    many = est.fit_arrays_grid(torch.as_tensor(X), y, W, grids)
    for k in range(2):
        for g in range(2):
            for key in ("feature", "threshold", "is_leaf", "leaf",
                        "feature_gain"):
                assert torch.equal(one[k][g][key], many[k][g][key]), key


def test_jax_depth12_forest_converted_scores_like_jax(data, forest_grid):
    """A depth-12 forest fitted by the JAX package (its unrolled arrays),
    exported as plain arrays and built by ``convert``, scores as the JAX
    package scores it."""
    from transmogrifai_tpu_torch import convert
    X, _ = data
    ref = forest_grid[0][0][0]
    exported = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in ref.items()}
    assert exported["feature"].shape == (2, 2 ** 13 - 1)
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
