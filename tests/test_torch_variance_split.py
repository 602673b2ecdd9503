"""``tree_split_variance`` on the gini split's body (``csrc/split_node.cuh``
with the variance impurity) and its level's tree arrays, on the CPU.

The kernel runs on the card only; these tests hold what surrounds it.
``gini_split_plan`` at C = 2 sizes every shape ``fit_trees`` sends a
regression tree (1 to 2,048 nodes, 2 to 127 bins, subsets or none).  A numpy
emulation of the body's variance arithmetic — each warp's compacted features
in groups, lane l on feature l // ipf and its hb bins, the bins before them
added in blocks of 16, ``_gain_variance`` in its f32 order with right =
parent - left statistic by statistic, the first max over the lanes and the W
chunks of a node — runs on the wrapper's own plan and gives the twin's bits;
the twin (the bin prefix in XLA:CPU's order, ``block_prefix``) is held to
the JAX package's scan (trees.py:331-356) bit for bit on fractional weights;
the level writes (``tree=``) equal the torch bookkeeping ``fit_trees`` ran
after the variance split before the split wrote them, at depth 3 and 9 with
node subsets.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

F32 = np.float32
INT_MAX = 2 ** 31 - 1


@pytest.mark.parametrize("K", [1, 6, 60, 150, 300])
@pytest.mark.parametrize("D,width", [(1, None), (6, 2), (16, None), (16, 5),
                                     (28, 9), (1597, None), (1597, 40)])
def test_variance_plan_covers_every_shape_fit_trees_sends(K, D, width):
    """The variance form of ``gini_split_plan`` (C = 2: one stage a group,
    the count and two statistics a bin, contiguous rows): W warps of fc
    features cover D, FPS features a group keep FPS·ipf <= 32 lanes, a
    staged row holds bins 0 .. NB-2 at a stride = 1 mod 32, and the shared
    memory is each warp's two slices and lists, two blocks an SM at most."""
    for P in (1, 2, 32, 256, 2048):
        for NB in (2, 17, 32, 64, 127):
            plan = tk.gini_split_plan(K, P, D, NB, 2, width)
            assert (plan["ct"], plan["class_chunks"]) == (2, 1)
            assert plan["W"] in (1, 2, 4, 8) and plan["W"] * plan["fc"] >= D
            assert plan["FPS"] * plan["ipf"] <= 32
            assert plan["ipf"] == -(-(NB - 1) // plan["hb"])
            assert plan["FST"] >= (NB - 1) * 3 and plan["FST"] % 32 == 1
            assert plan["smem"] == 4 * 8 * (2 * plan["FPS"] * plan["FST"]
                                            + 2 * plan["FPS"])
            assert plan["smem"] <= 113 * 1024
            assert plan["blocks"] == -(-P // plan["nodes_per_block"]) * K


def _var_level(rng, K, P, D, NB, dup=(), zero_nodes=0.2,
               weights=(0.0, 0.5, 1.0, 1.25, 2.0), n=40):
    """Histograms [K, P, D, NB, 3] of (w, w·y, w·y²) over fractional
    non-negative weights w and labels y, every feature's bins summing to the
    node's totals; columns ``dup`` = (i, j): feature j a copy of feature i
    (an exact tie); a share of the nodes empty."""
    w = rng.choice(np.asarray(weights, F32), size=(K, P, n))
    w[rng.random((K, P)) < zero_nodes] = 0
    y = rng.normal(loc=3.0, scale=2.0, size=(K, P, n)).astype(F32)
    st = np.stack([w, w * y, w * y * y], axis=-1).astype(F32)
    bins = rng.integers(0, NB, size=(K, P, n, D))
    for i, j in dup:
        bins[..., j] = bins[..., i]
    hist = np.zeros((K, P, D, NB, 3), F32)
    for d in range(D):
        for r in range(n):
            np.add.at(hist[:, :, d], (np.arange(K)[:, None],
                                      np.arange(P)[None, :],
                                      bins[:, :, r, d]), st[:, :, r])
    tot = np.zeros((K, P, 3), F32)
    for r in range(n):
        tot += st[:, :, r]
    splits = np.sort(rng.normal(size=(D, NB - 1)).astype(F32), axis=1)
    return hist, tot, splits


def _better(a, b):
    """(gain, feature, bin) a beats b: split_level.cuh's split_better."""
    return a[0] > b[0] or (a[0] == b[0] and (a[1] < b[1] or (
        a[1] == b[1] and a[2] < b[2])))


def _sse(c, s1, s2):
    return F32(s2 - F32(s1 * s1) / max(c, F32(1e-12)))


def _emulate_variance(hist, tot, fmask, node_mask, splits, mi, mg, plan):
    """``csrc/split_node.cuh``'s variance arithmetic in numpy f32: a node
    under 2·mi reads nothing; else each of its W warps compacts the allowed
    features of its chunk into groups of FPS and lane l on feature l // ipf
    adds the bins before its hb bins (blocks of 16 serially, then the
    block's start) and walks its bins: sse(parent) - sse(left) - sse(right)
    with right = parent - left, a strict ``>``; then the first max over the
    lanes and the chunks."""
    K, P, D, NB, _ = hist.shape
    W, fc, hb, FPS, ipf = (plan[k] for k in ("W", "fc", "hb", "FPS", "ipf"))
    out = {"gain": np.zeros((K, P), F32), "feature": np.zeros((K, P), np.int32),
           "bin": np.zeros((K, P), np.int32),
           "is_leaf": np.zeros((K, P), bool),
           "threshold": np.zeros((K, P), F32)}
    for k in range(K):
        m = F32(mi[k])
        for p in range(P):
            t = tot[k, p]
            pc = t[0]
            best = (F32(-np.inf), INT_MAX, 0)
            if pc >= F32(2) * m:
                spar = _sse(pc, t[1], t[2])
                for c in range(W):
                    d0, d1 = c * fc, min(D, c * fc + fc)
                    ok = [d for d in range(d0, d1) if fmask[d] and (
                        node_mask is None or node_mask[k, p, d])]
                    lanes = [(F32(-np.inf), INT_MAX, 0)] * 32
                    for g0 in range(0, len(ok), FPS):
                        grp = ok[g0:g0 + FPS]
                        for lane in range(32):
                            i, sub = divmod(lane, ipf)
                            if i >= len(grp):
                                continue
                            f = grp[i]
                            b0 = sub * hb
                            b1 = min(b0 + hb, NB - 1)
                            x = hist[k, p, f]
                            ib = np.zeros(3, F32)
                            ob = np.zeros(3, F32)
                            for b in range(b0):
                                if b % 16 == 0 and b:
                                    ob, ib = ob + ib, np.zeros_like(ib)
                                ib = ib + x[b]
                            for b in range(b0, b1):
                                if b % 16 == 0 and b:
                                    ob, ib = ob + ib, np.zeros_like(ib)
                                ib = ib + x[b]
                                l = ib + ob
                                lc, rc = l[0], F32(pc - l[0])
                                gain = F32(F32(spar - _sse(lc, l[1], l[2]))
                                           - _sse(rc, F32(t[1] - l[1]),
                                                  F32(t[2] - l[2])))
                                if (lc >= m and rc >= m
                                        and gain > lanes[lane][0]):
                                    lanes[lane] = (gain, f, b)
                    for cand in lanes:
                        if _better(cand, best):
                            best = cand
            g, f, b = best
            if not g > -np.inf:
                f, b = 0, 0
            out["gain"][k, p] = g
            out["feature"][k, p] = f
            out["bin"][k, p] = b
            out["is_leaf"][k, p] = not (np.isfinite(g) and g > F32(mg[k]))
            out["threshold"][k, p] = splits[f, min(max(b, 0), NB - 2)]
    return out


def _node_mask(rng, K, P, D, sub):
    if sub is None:
        return None
    m = np.zeros((K, P, D), bool)
    for k in range(K):
        for p in range(P):
            m[k, p, rng.permutation(D)[:sub]] = True
    return m


def _twin(hist, tot, fmask, node_mask, splits, mi, mg):
    return tk.tree_split_variance_twin(*(
        None if a is None else torch.as_tensor(a)
        for a in (hist, tot, fmask, node_mask, splits, mi, mg)))


@pytest.mark.parametrize("K,P,D,NB,sub,dup", [
    (3, 4, 12, 32, 5, ((3, 9),)),         # subsets, a tie across lanes
    (2, 8, 7, 17, None, ((1, 6),)),       # every feature, one block + 1 bin
    (2, 1, 28, 32, 5, ()),                # one node: W = 8 chunks
    (2, 4, 5, 127, None, ()),             # 127 bins: 8 blocks of 16
    (2, 4, 16, 64, 5, ((0, 15),)),        # the max_bins=64 fits
    (3, 16, 6, 2, None, ()),              # 2 bins: one split point
])
def test_variance_emulation_gives_the_twins_bits(K, P, D, NB, sub, dup):
    """The body's variance arithmetic on the wrapper's own plan gives the
    twin's bits in every output, at min_instances that leave some nodes
    under 2·min_instances, on fractional weights, node subsets with empty
    nodes and a node with no feature, and exact ties taken by the lowest
    feature, then bin."""
    rng = np.random.default_rng(K * 1000 + P * 10 + NB)
    hist, tot, splits = _var_level(rng, K, P, D, NB, dup)
    fmask = np.ones(D, bool)
    fmask[D // 3] = D < 3
    node_mask = _node_mask(rng, K, P, D, sub)
    if node_mask is not None:
        node_mask[0, 0] = False
    mi = np.asarray([1.0, 0.0, 3.0][:K], F32)
    mg = np.asarray([0.0, 0.01, -1.0][:K], F32)
    width = None if node_mask is None else int(node_mask.sum(axis=2).max())
    plan = tk.gini_split_plan(K, P, D, NB, 2, width)
    want = _emulate_variance(hist, tot, fmask, node_mask, splits, mi, mg,
                             plan)
    got = _twin(hist, tot, fmask, node_mask, splits, mi, mg)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    assert np.isfinite(want["gain"]).any()
    for i, j in dup:
        assert not (got["feature"].numpy() == j).any()


@pytest.mark.parametrize("hb", [4, 6, 8, 16])
@pytest.mark.parametrize("K,P,D,NB,sub", [(3, 4, 12, 32, 5),
                                          (2, 4, 9, 40, None),
                                          (1, 3, 5, 127, None)])
def test_variance_emulation_at_every_lane_width(monkeypatch, hb, K, P, D, NB,
                                                sub):
    """Each of the body's lane widths (4, 6, 8 and 16 bins a lane) gives
    the twin's bits through the emulation, with the plan made to pick it."""
    monkeypatch.setattr(tk, "GINI_LANE_BINS", (hb,))
    rng = np.random.default_rng(hb * 100 + NB)
    hist, tot, splits = _var_level(rng, K, P, D, NB)
    fmask = np.ones(D, bool)
    node_mask = _node_mask(rng, K, P, D, sub)
    mi = np.asarray([1.0, 0.0, 3.0][:K], F32)
    mg = np.zeros(K, F32)
    plan = tk.gini_split_plan(K, P, D, NB, 2, sub)
    assert plan["hb"] == hb
    want = _emulate_variance(hist, tot, fmask, node_mask, splits, mi, mg,
                             plan)
    got = _twin(hist, tot, fmask, node_mask, splits, mi, mg)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)


def _jax_variance_scan(hist, tot, node_mask, mi, chunk):
    """The JAX level body's choice per node (trees.py:331-356) for one
    lane: cumsum over bins, ``_gain_variance``, the ``ok`` mask with the
    node subsets, max / argmax over bins, then over the features of each
    ``chunk`` and across chunks with a strict ``>``.  hist [P, D, NB, 3]
    → (gains [P, D, NB], gain, feature, bin [P])."""
    P, D, NB, _ = hist.shape
    best = np.full(P, -np.inf, F32)
    bf = np.zeros(P, np.int32)
    bb = np.zeros(P, np.int32)
    node_stats = jnp.asarray(tot)
    tables = []
    for c0 in range(0, D, chunk):
        h = jnp.asarray(hist[:, c0:c0 + chunk]).transpose(1, 0, 2, 3)
        left = jnp.cumsum(h, axis=2)
        right = node_stats[None, :, None, :] - left
        gains = jt._gain_variance(left, right, node_stats[None, :, None, :],
                                  1.0)
        nm = jnp.asarray(node_mask[:, c0:c0 + chunk].T)
        ok = ((left[..., 0] >= mi) & (right[..., 0] >= mi) & nm[:, :, None]
              & (jnp.arange(NB)[None, None, :] < NB - 1))
        gains = jnp.where(ok, gains, -jnp.inf)
        tables.append(np.asarray(gains).transpose(1, 0, 2))
        cg, cb = jnp.max(gains, axis=2), jnp.argmax(gains, axis=2)
        fg, fi = np.asarray(jnp.max(cg, axis=0)), np.asarray(
            jnp.argmax(cg, axis=0))
        fb = np.asarray(cb)[fi, np.arange(P)]
        better = fg > best
        best = np.where(better, fg, best)
        bf = np.where(better, c0 + fi, bf)
        bb = np.where(better, fb, bb)
    return np.concatenate(tables, axis=1), best, bf, bb


@pytest.mark.parametrize("NB,chunk", [(32, 1024), (127, 1024), (64, 3)])
def test_variance_twin_equals_the_jax_scan_bit_for_bit(NB, chunk):
    """A regression forest level of fractional weights and real labels with
    node subsets: the twin's gain table (the bin prefix in blocks of 16)
    equals the JAX package's ``_gain_variance`` table bit for bit at every
    allowed (node, feature, bin), and its chosen gain, feature and bin are
    the JAX scan's at every node (also where the scan takes the features in
    chunks of 3); the prefix sums are inexact in f32, so another order
    would round them otherwise."""
    rng = np.random.default_rng(NB + chunk)
    P, D, mi = 24, 9, F32(1.5)
    hist, tot, splits = _var_level(rng, 1, P, D, NB, weights=(
        0.1, 0.3, 0.7, 0.25, 1.3), zero_nodes=0.1, n=60)
    node_mask = _node_mask(rng, 1, P, D, 4)
    got = tk.tree_split_variance_twin(
        torch.as_tensor(hist), torch.as_tensor(tot),
        torch.ones(D, dtype=torch.bool), torch.as_tensor(node_mask),
        torch.as_tensor(splits), torch.tensor([mi]), torch.tensor([0.0]))
    table, best, bf, bb = _jax_variance_scan(hist[0], tot[0], node_mask[0],
                                             mi, chunk)
    mine = tk.split_gains_variance(
        torch.as_tensor(hist), torch.as_tensor(tot),
        torch.ones(D, dtype=torch.bool), torch.as_tensor(node_mask),
        torch.tensor([mi]))[0].reshape(P, D, NB).numpy()
    np.testing.assert_array_equal(mine.view(np.uint32),
                                  table.astype(F32).view(np.uint32))
    np.testing.assert_array_equal(got["gain"][0].numpy(), best)
    np.testing.assert_array_equal(got["feature"][0].numpy(), bf)
    np.testing.assert_array_equal(got["bin"][0].numpy(), bb)
    assert np.isfinite(best).sum() >= P // 2
    serial = np.cumsum(hist[0, ..., 1].astype(np.float64), axis=2)
    assert (serial != serial.astype(F32)).any()


def test_variance_epilogue_writes_the_level_arrays():
    """With ``tree=`` the wrapper writes the level's slices — feature -1 on
    a leaf, the threshold, the leaf flag, the mean label tot[1] /
    max(tot[0], 1e-12) — and adds the split nodes' gains in node order, as
    the body's epilogue and the gain walk do, leaving the rest as it was."""
    rng = np.random.default_rng(3)
    K, P, D, NB = 3, 8, 6, 32
    hist, tot, splits = _var_level(rng, K, P, D, NB)
    T, off = 31, 7
    tree0 = (np.full((K, T), -1, np.int32), np.full((K, T), np.inf, F32),
             np.zeros((K, T), bool), np.zeros((K, T, 1), F32),
             rng.random((K, D)).astype(F32))
    tree = tuple(torch.as_tensor(a.copy()) for a in tree0)
    args = [torch.as_tensor(a) for a in (hist, tot)] + [
        torch.ones(D, dtype=torch.bool), None, torch.as_tensor(splits),
        torch.tensor([1.0, 0.0, 2.0]), torch.tensor([0.0, 0.01, 0.0])]
    out = {k: v.numpy() for k, v in
           tk.tree_split_variance(*args, tree=tree, offset=off).items()}
    feature, threshold, is_leaf, leaf, gain = (a.copy() for a in tree0)
    for k in range(K):
        for p in range(P):
            t, lf = off + p, bool(out["is_leaf"][k, p])
            feature[k, t] = -1 if lf else out["feature"][k, p]
            threshold[k, t] = out["threshold"][k, p]
            is_leaf[k, t] = lf
            leaf[k, t, 0] = tot[k, p, 1] / max(tot[k, p, 0], F32(1e-12))
            if not lf:
                f = out["feature"][k, p]
                gain[k, f] = F32(gain[k, f] + out["gain"][k, p])
    for a, b, name in zip(tree, (feature, threshold, is_leaf, leaf, gain),
                          pt.TreeArrays._fields):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert (~out["is_leaf"]).any() and out["is_leaf"].any()


def _fit_trees_torch_bookkeeping(B, splits, stats, fmask, node_masks, *,
                                 max_depth, n_bins, min_instances, min_gain):
    """``fit_trees(impurity="variance")`` as it was before the split wrote
    its level's arrays: the split's dict, the route, then the level's leaf
    values, flags, features, thresholds and gain sums by torch ops."""
    K, N, S = stats.shape
    D = B.shape[1]
    T = 2 ** (max_depth + 1) - 1
    feature = torch.full((K, T), -1, dtype=torch.int32)
    threshold = torch.full((K, T), float("inf"))
    is_leaf = torch.zeros((K, T), dtype=torch.bool)
    leaf = torch.zeros((K, T, 1))
    gain = torch.zeros((K, D))
    row_node = torch.zeros((K, N), dtype=torch.int32)
    for lvl in range(max_depth + 1):
        off, P = (1 << lvl) - 1, 1 << lvl
        bottom = lvl == max_depth
        nm = None if bottom else node_masks[lvl]
        hist, totals = tk.tree_hist(B, row_node, stats, off, P, n_bins,
                                    with_hist=not bottom, node_mask=nm)
        if bottom:
            break
        sp = tk.tree_split_variance(hist, totals, fmask, nm, splits,
                                    min_instances, min_gain)
        row_node = tk.tree_route_twin(B, row_node, sp["feature"], sp["bin"],
                                      sp["is_leaf"], off)
        leaf[:, off:off + P] = tk.variance_leaf(totals)
        lf = sp["is_leaf"]
        is_leaf[:, off:off + P] = lf
        feature[:, off:off + P] = torch.where(lf, -1, sp["feature"])
        threshold[:, off:off + P] = sp["threshold"]
        gain.scatter_add_(1, sp["feature"].long(),
                          torch.where(lf, 0.0, sp["gain"]))
    leaf[:, off:] = tk.variance_leaf(totals)
    is_leaf[:, off:] = True
    return pt.TreeArrays(feature, threshold, is_leaf, leaf, gain)


@pytest.mark.parametrize("depth,subsets", [(3, True), (9, True), (4, False)])
def test_fit_trees_variance_with_the_split_epilogue_keeps_its_bits(depth,
                                                                   subsets):
    """``fit_trees(impurity="variance")``, whose split writes each level's
    tree arrays, gives the bits of the loop that wrote them with torch ops
    after the split, on 4 lanes of Poisson-like weights, with per-node
    subsets of 3 of 6 features or none (depth 9 reaches the deep
    histograms)."""
    rng = np.random.default_rng(depth * 10 + subsets)
    N, D, NB, K = 3_000, 6, 32, 4
    X = rng.normal(size=(N, D)).astype(F32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N)).astype(F32)
    splits = pt.build_bin_splits(X, NB)
    B = pt.bin_data(torch.as_tensor(X), torch.as_tensor(splits))
    w = rng.poisson(1.0, size=(K, N)).astype(F32) * (
        rng.random((K, N)) > 0.33)
    stats = torch.as_tensor(np.stack([w, w * y, w * y * y], axis=2)
                            .astype(F32))
    masks = None
    if subsets:
        masks = []
        for lvl in range(depth):
            m = np.zeros((K, 1 << lvl, D), bool)
            keys = rng.random(m.shape)
            np.put_along_axis(m, np.argsort(keys, axis=2)[..., :3], True,
                              axis=2)
            masks.append(torch.as_tensor(m))
    kw = dict(max_depth=depth, n_bins=NB,
              min_instances=torch.tensor([1.0, 5.0, 1.0, 20.0]),
              min_gain=torch.tensor([0.0, 0.0, 0.01, 0.001]))
    fmask = torch.ones(D, dtype=torch.bool)
    got = pt.fit_trees(B, torch.as_tensor(splits), stats, fmask,
                       impurity="variance", node_masks=masks, **kw)
    want = _fit_trees_torch_bookkeeping(
        B, torch.as_tensor(splits), stats, fmask,
        masks if masks is not None else [None] * depth, **kw)
    for a, b, name in zip(got, want, pt.TreeArrays._fields):
        assert torch.equal(a, b), name
    assert int((~got.is_leaf).sum()) > 10
