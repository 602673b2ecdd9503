"""The port's bucketizers, calibrators and scalers against the JAX package,
on the CPU.  Tolerances: the decision-tree bucketizers' thresholds exactly
equal (gini statistics are integer counts, and the split scans bins in the
JAX package's prefix order) — but for a node where two splits' gini gains
are equal in exact arithmetic: there the f32 rounding picks one, and the
JAX package's jitted level body rounds its gain otherwise than the
port's order (``tree_kernels.gini_gain``, the eager expression's: XLA:CPU
contracts products into FMAs), so the trees may part there, and only
there (ROADMAP queue 3, open); a stage's columns
fitted together equal to each fitted alone, every bucket matrix, label and
metadata exactly equal (where the trees agree); ``pav_fit``, the
isotonic, percentile, scaler and descaler outputs within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

from transmogrifai_tpu_torch.ops import bucketizers as pb  # noqa: E402
from transmogrifai_tpu_torch.synthetic import make_kinds_columns  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
N = 2000


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _xy(seed, n=N, classes=2, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    if ties:
        x = np.round(x * 2) / 2
    y = ((x > 0.3) ^ (rng.random(n) < 0.2)).astype(np.float64)
    if classes > 2:
        y = np.clip(np.floor((x + 2) * classes / 4), 0, classes - 1)
        noisy = rng.random(n) < 0.1
        y[noisy] = rng.integers(0, classes, size=int(noisy.sum()))
    return x, y


def _jax_tree(x, y, max_depth=5, max_bins=32, min_instances=1,
              min_gain=0.01):
    """The JAX package's one-column gini tree (``tree_splits_for_feature``'s
    fit) and its inputs: (feature, threshold, is_leaf) [T], bins [N],
    class ids [N]."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models import trees as jt
    X = np.asarray(x, np.float32)[:, None]
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    C = max(len(classes), 2)
    splits = jt.build_bin_splits(X, max_bins)
    B = jt.bin_data(jnp.asarray(X), jnp.asarray(splits))
    stats = np.zeros((len(x), 1 + C), np.float32)
    stats[:, 0] = 1.0
    stats[np.arange(len(x)), 1 + y_idx] = 1.0
    t = jt.fit_tree(B, jnp.asarray(splits), jnp.asarray(stats),
                    jnp.ones((1,), jnp.float32) > 0, impurity="gini",
                    max_depth=max_depth, n_bins=max_bins,
                    min_instances=jnp.float32(min_instances),
                    min_gain=jnp.float32(min_gain), lam=jnp.float32(1.0))
    return ((np.asarray(t.feature), np.asarray(t.threshold),
             np.asarray(t.is_leaf)), np.asarray(B)[:, 0].astype(np.int64),
            y_idx, C, splits[0])


def _assert_equal_but_at_exact_ties(x, y, **kw):
    """The port's one-column tree equals the JAX package's node by node
    until the first node where they part, and there the two splits' gini
    gains are equal in f64 (an exact tie, which each framework's f32
    rounding breaks its own way).  Returns whether they parted."""
    from transmogrifai_tpu_torch.models import trees as pt
    fit_kw = {k: kw[k] for k in ("max_depth", "max_bins", "min_instances",
                                 "min_gain") if k in kw}
    (jf, jthr, jl), b, y_idx, C, sp = _jax_tree(x, y, **fit_kw)
    nb = fit_kw.get("max_bins", 32)
    stats = np.zeros((len(x), 1 + C), np.float32)
    stats[:, 0] = 1.0
    stats[np.arange(len(x)), 1 + y_idx] = 1.0
    t = pt.fit_trees(torch.as_tensor(b[:, None].astype(np.int8)),
                     torch.as_tensor(sp[None]), torch.as_tensor(stats)[None],
                     torch.ones(1, dtype=torch.bool),
                     max_depth=fit_kw.get("max_depth", 5), n_bins=nb,
                     min_instances=torch.tensor(
                         [float(fit_kw.get("min_instances", 1))]),
                     min_gain=torch.tensor([fit_kw.get("min_gain", 0.01)]),
                     impurity="gini")
    pf, pthr, pl = (a[0].numpy() for a in (t.feature, t.threshold,
                                          t.is_leaf))
    depth = fit_kw.get("max_depth", 5)
    at = [np.zeros(len(x), np.int64)]          # rows' nodes, level by level
    for _ in range(depth):
        n = at[-1]
        go = np.where(b <= np.searchsorted(sp, pthr[n]), 2 * n + 1, 2 * n + 2)
        at.append(np.where(pl[n] | (pf[n] < 0), n, go))
    for i in range(len(jf)):
        same = (jl[i] == pl[i] and jf[i] == pf[i]
                and (jf[i] < 0 or jthr[i] == pthr[i]))
        if same:
            continue
        # heap order: node i's ancestors agreed, so its rows are the port's
        rows = at[int(np.log2(i + 1))] == i
        assert rows.any(), i
        h = np.zeros((nb, 1 + C))
        np.add.at(h, b[rows], stats[rows])
        left = np.cumsum(h, axis=0)
        par = h.sum(0)

        def wg(s):
            c = np.maximum(s[..., 0], 1e-12)
            return c * (1 - ((s[..., 1:] / c[..., None]) ** 2).sum(-1))
        g = wg(par) - wg(left) - wg(par - left)
        gj = g[np.searchsorted(sp, jthr[i])] if jf[i] >= 0 else None
        gp = g[np.searchsorted(sp, pthr[i])] if pf[i] >= 0 else None
        assert gj is not None and gp is not None, (i, jf[i], pf[i])
        assert abs(gj - gp) <= 1e-9 * max(1.0, abs(gj)), (i, gj, gp)
        return True
    return False


@pytest.mark.parametrize("seed,classes,ties,kw", [
    (0, 2, False, {}), (1, 2, True, {}), (2, 3, False, {}),
    (3, 2, False, {"max_depth": 3, "min_gain": 0.0}),
    (4, 2, False, {"max_bins": 16, "min_instances": 50}),
    (5, 4, True, {"max_depth": 2}),
])
def test_tree_splits_for_feature_equal_jax(seed, classes, ties, kw):
    from transmogrifai_tpu.ops.bucketizers import tree_splits_for_feature as j
    x, y = _xy(seed, classes=classes, ties=ties)
    want = j(x, y, **kw)
    got = pb.tree_splits_for_feature(x, y, device="cpu", **kw)
    assert got.dtype == np.float64
    if not _assert_equal_but_at_exact_ties(x, y, **kw):
        np.testing.assert_array_equal(got, want)


def test_tree_splits_of_a_constant_column_and_of_one_class():
    from transmogrifai_tpu.ops.bucketizers import tree_splits_for_feature as j
    x = np.ones(300)
    y = (np.arange(300) % 2).astype(np.float64)
    np.testing.assert_array_equal(pb.tree_splits_for_feature(x, y,
                                                             device="cpu"),
                                  j(x, y))
    x = np.random.default_rng(0).normal(size=300)
    np.testing.assert_array_equal(
        pb.tree_splits_for_feature(x, np.zeros(300), device="cpu"),
        j(x, np.zeros(300)))
    assert len(pb.tree_splits_for_feature(np.zeros(0), np.zeros(0),
                                          device="cpu")) == 0


def test_columns_fitted_together_equal_each_fitted_alone():
    """A lane a column, each over its present rows: the thresholds of the
    batched fit are those of the one-column fits (and of the JAX package's
    fit of the column's present rows)."""
    from transmogrifai_tpu.ops.bucketizers import tree_splits_for_feature as j
    rng = np.random.default_rng(7)
    n, K = 1500, 6
    vals = rng.normal(size=(n, K))
    y = ((vals[:, 0] + vals[:, 3] > 0) ^ (rng.random(n) < 0.15)).astype(
        np.float64)
    present = rng.random((n, K)) < np.linspace(0.3, 1.0, K)
    present[:, 5] = False                      # a column with no row
    present[:40, 4] = True
    got = pb.tree_splits_for_columns(vals, present, y, device="cpu")
    for k in range(K):
        pk = present[:, k]
        alone = pb.tree_splits_for_feature(vals[pk, k], y[pk], device="cpu")
        np.testing.assert_array_equal(got[k], alone)
        if pk.any() and not _assert_equal_but_at_exact_ties(vals[pk, k],
                                                             y[pk]):
            np.testing.assert_array_equal(got[k], j(vals[pk, k], y[pk]))
    assert len(got[5]) == 0 and len(got[0]) > 0


def test_columns_whose_present_rows_hold_other_classes():
    """Columns whose present rows hold different label sets grow in
    separate fits (their one-hot widths differ) and still equal the JAX
    package's one-column fits."""
    from transmogrifai_tpu.ops.bucketizers import tree_splits_for_feature as j
    rng = np.random.default_rng(8)
    n = 900
    y = rng.integers(0, 3, size=n).astype(np.float64)
    vals = rng.normal(size=(n, 3)) + y[:, None]
    present = np.ones((n, 3), bool)
    present[:, 1] = y != 2                      # classes {0, 1}
    present[:, 2] = y == 1                      # one class
    got = pb.tree_splits_for_columns(vals, present, y, device="cpu")
    for k in range(3):
        xk, yk = vals[present[:, k], k], y[present[:, k]]
        np.testing.assert_array_equal(
            got[k], pb.tree_splits_for_feature(xk, yk, device="cpu"))
        if not _assert_equal_but_at_exact_ties(xk, yk):
            np.testing.assert_array_equal(got[k], j(xk, yk))


@pytest.fixture(scope="module")
def kinds():
    cols, schema = make_kinds_columns(N, seed=9)
    out = {}
    for pkg in (JAX, PORT):
        C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
        pc = {k: C.Column(getattr(TY, v.kind.__name__), v.values, mask=v.mask)
              for k, v in cols.items()}
        out[pkg] = (C.ColumnBatch(pc, N, device="cpu") if pkg == PORT
                    else C.ColumnBatch(pc, N))
    return out, schema


def _stage(pkg, cls, names, schema, **kw):
    F, TY = _mod(pkg, "features"), _mod(pkg, "types")
    st = getattr(_mod(pkg, "ops.bucketizers"), cls)(**kw)
    feats = [F.FeatureBuilder(n, getattr(TY, schema[n].__name__))
             .as_response() if n == "label" else
             F.FeatureBuilder(n, getattr(TY, schema[n].__name__))
             .as_predictor() for n in names]
    st.set_input(*feats)
    return st


@pytest.mark.parametrize("cls,names,kw", [
    ("DecisionTreeNumericBucketizer", ["label", "r0"], {}),
    ("DecisionTreeNumericBucketizer", ["label", "r1"],
     {"track_invalid": False, "track_nulls": False}),
    ("DecisionTreeNumericBucketizer", ["label", "r2"],
     {"min_info_gain": 0.5}),
    ("DecisionTreeNumericMapBucketizer", ["label", "rmap"], {}),
    ("DecisionTreeNumericMapBucketizer", ["label", "rmap"],
     {"track_invalid": True, "max_keys": 7}),
    ("NumericBucketizer", ["r3"], {"splits": [-np.inf, -1.0, 0.0, 2.0,
                                              np.inf]}),
    ("NumericBucketizer", ["r3"], {"splits": [-1.0, 0.0, 1.0],
                                   "split_inclusion": "Right",
                                   "track_invalid": True}),
])
def test_bucketizer_stage_matches_jax(kinds, cls, names, kw):
    """The bucket blocks equal the JAX package's — the map bucketizer's
    with each split key's second null column left out (the JAX package's
    model writes it twice, one column more than its metadata names; the
    port writes it once)."""
    b, schema = kinds
    outs, models = {}, {}
    for pkg in (JAX, PORT):
        st = _stage(pkg, cls, names, schema, **kw)
        model = st.fit(b[pkg]) if hasattr(st, "fit") else st
        models[pkg], outs[pkg] = model, model.transform(b[pkg])
    want = _np(outs[JAX].values)
    if cls == "DecisionTreeNumericMapBucketizer":
        _keys_equal_but_at_exact_ties(b[PORT], models)
        if any(len(v) != len(models[JAX].fitted["splits_by_key"][k])
               or (v != models[JAX].fitted["splits_by_key"][k]).any()
               for k, v in models[PORT].fitted["splits_by_key"].items()):
            return
    if cls == "DecisionTreeNumericMapBucketizer" and \
            kw.get("track_nulls", True):
        keep, c = [], 0
        jf = models[JAX].fitted
        for k in jf["keys"]:
            ks = jf["splits_by_key"][k]
            width = (len(ks) - 1 + int(kw.get("track_invalid", False)) + 1
                     if len(ks) else 1)
            keep += list(range(c, c + width))
            c += width + (1 if len(ks) else 0)     # the second null column
        assert c == want.shape[1] > len(keep)
        np.testing.assert_array_equal(want[:, keep[-1] + 1 - 1],
                                      want[:, -1])
        want = want[:, keep]
    got = _np(outs[PORT].values)
    assert got.shape[1] == len(outs[PORT].meta.columns)
    np.testing.assert_array_equal(got, want)
    assert outs[PORT].meta.to_json()["columns"] == \
        outs[JAX].meta.to_json()["columns"]
    jf, pf = models[JAX], models[PORT]
    if "splits" in getattr(jf, "fitted", {}):
        np.testing.assert_array_equal(pf.fitted["splits"],
                                      jf.fitted["splits"])
        assert pf.fitted["should_split"] == jf.fitted["should_split"]
    if "splits_by_key" in getattr(jf, "fitted", {}):
        assert pf.fitted["keys"] == jf.fitted["keys"]
        for k in jf.fitted["keys"]:
            np.testing.assert_array_equal(pf.fitted["splits_by_key"][k],
                                          jf.fitted["splits_by_key"][k])
        assert sum(len(v) > 0 for v in pf.fitted["splits_by_key"].values())


def _keys_equal_but_at_exact_ties(batch, models):
    """Each map key's thresholds: the JAX package's, or parted from them
    only at an exact tie (``_assert_equal_but_at_exact_ties``)."""
    maps = batch["rmap"].values
    y = np.asarray(batch["label"].values, np.float64)
    jf, pf = models[JAX].fitted, models[PORT].fitted
    assert pf["keys"] == jf["keys"]
    for k in jf["keys"]:
        a, c = jf["splits_by_key"][k], pf["splits_by_key"][k]
        if len(a) == len(c) and (a == c).all():
            continue
        v = np.asarray([m.get(k, np.nan) for m in maps], np.float64)
        p = ~np.isnan(v)
        assert _assert_equal_but_at_exact_ties(v[p], y[p]), k


def test_bucketize_values_matches_jax():
    from transmogrifai_tpu.ops.bucketizers import bucketize_values as j
    v = np.asarray([-np.inf, -2.0, -1.0, 0.0, 0.5, 1.0, 3.0, np.inf, np.nan])
    mask = np.asarray([1, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    for inc in ("Left", "Right"):
        for splits in ([-np.inf, -1.0, 1.0, np.inf], [-1.0, 0.0, 1.0]):
            for ti in (False, True):
                for tn in (False, True):
                    kw = dict(inclusion=inc, track_invalid=ti, track_nulls=tn)
                    np.testing.assert_array_equal(
                        pb.bucketize_values(v, mask, np.asarray(splits), **kw),
                        j(v, mask, np.asarray(splits), **kw))
    assert pb.splits_to_bucket_labels([0.0, 1.0, 2.5], "Right") == \
        ["(0.0-1.0]", "(1.0-2.5]"]


@pytest.mark.parametrize("increasing", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_pav_and_isotonic_calibrator_match_jax(kinds, seed, increasing):
    from transmogrifai_tpu.ops.bucketizers import pav_fit as j
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=500), 2)
    y = (x + rng.normal(size=500) > 0).astype(np.float64)
    w = rng.random(500) + 0.5
    for ww in (None, w):
        bj, vj = j(x, y, ww, increasing)
        bp, vp = pb.pav_fit(x, y, ww, increasing)
        np.testing.assert_allclose(bp, bj, rtol=0, atol=1e-6)
        np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-6)
    b, schema = kinds
    outs = []
    for pkg in (JAX, PORT):
        st = _stage(pkg, "IsotonicRegressionCalibrator", ["label", "score"],
                    {"label": schema["label"], "score": schema["label"]},
                    isotonic=increasing)
        C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
        score = _np(b[PORT]["r0"].values)
        score = np.where(np.isnan(score), 0.0, score).astype(np.float32)
        cols = {"label": b[pkg]["label"], "score": C.Column(TY.RealNN, score)}
        bb = (C.ColumnBatch(cols, N, device="cpu") if pkg == PORT
              else C.ColumnBatch(cols, N))
        outs.append(_np(st.fit(bb).transform(bb).values))
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("buckets", [100, 7, 5000])
def test_percentile_calibrator_matches_jax(kinds, buckets):
    b, schema = kinds
    outs = []
    for pkg in (JAX, PORT):
        C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
        v = np.nan_to_num(_np(b[PORT]["r1"].values)).astype(np.float32)
        cols = {"s": C.Column(TY.RealNN, v)}
        bb = (C.ColumnBatch(cols, N, device="cpu") if pkg == PORT
              else C.ColumnBatch(cols, N))
        st = _stage(pkg, "PercentileCalibrator", ["s"], {"s": schema["label"]},
                    expected_num_buckets=buckets)
        m = st.fit(bb)
        outs.append((_np(m.transform(bb).values), m.metadata["origSplits"]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=1e-6)
    assert outs[1][1] == outs[0][1]


@pytest.mark.parametrize("stype,args", [
    ("Linear", {"slope": 2.5, "intercept": -1.0}), ("Linear", {}),
    ("Logarithmic", {})])
def test_scaler_and_descaler_match_jax(kinds, stype, args):
    b, schema = kinds
    outs = []
    for pkg in (JAX, PORT):
        F, TY = _mod(pkg, "features"), _mod(pkg, "types")
        f = F.FeatureBuilder("r2", TY.Real).as_predictor()
        scaled = f.scale(stype, args)
        back = scaled.descale(scaled)
        bb = b[pkg]
        if stype == "Logarithmic":
            C = _mod(pkg, "columns")
            v = np.abs(_np(b[PORT]["r2"].values)) + 0.1
            bb = (C.ColumnBatch({"r2": C.Column(TY.Real, v,
                                                mask=b[PORT]["r2"].mask)},
                                N, device="cpu") if pkg == PORT
                  else C.ColumnBatch({"r2": C.Column(TY.Real, v,
                                                     mask=b[PORT]["r2"].mask)},
                                     N))
        sc = scaled.origin_stage.transform(bb)
        bb2 = bb.with_columns({scaled.name: sc})
        de = back.origin_stage.transform(bb2)
        outs.append((_np(sc.values), _np(de.values), _np(de.mask)))
    for a, c in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        pb.ScalerTransformer("Linear", {"slope": 0.0})
    with pytest.raises(ValueError):
        pb.ScalerTransformer("Cubic")


def test_dsl_methods_build_the_jax_stages():
    names = {}
    for pkg in (JAX, PORT):
        F, TY = _mod(pkg, "features"), _mod(pkg, "types")
        label = F.FeatureBuilder("label", TY.RealNN).as_response()
        x = F.FeatureBuilder("x", TY.Real).as_predictor()
        d = F.FeatureBuilder("d", TY.Date).as_predictor()
        feats = [x.auto_bucketize(label), x.bucketize([-1.0, 0.0, 1.0]),
                 x.scale(), x.scale().descale(x.scale()), d.to_unit_circle(),
                 d.to_time_period("HourOfDay")]
        names[pkg] = [(type(f.origin_stage).__name__, f.kind.__name__)
                      for f in feats]
    assert names[PORT] == names[JAX]
