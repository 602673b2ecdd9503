"""``tree_split_gini`` (the gini split with its level's tree arrays) of the
PyTorch port, on the CPU.

The kernel runs on the card only; these tests hold what surrounds it.
``gini_split_plan`` sizes every shape ``fit_trees`` can send (1 to 2,048
nodes, 2 to 127 bins, 2 to 40 classes, node subsets or none).  A numpy
emulation of ``csrc/tree_split_gini.cu``'s arithmetic — each warp's
compacted features in groups, lane l on feature l // ipf and its hb bins,
the bins before them added in blocks of 16, the classes in chunks, the
first max over the lanes and the W chunks of a node — runs on the
wrapper's own plan and gives the twin's bits; the twin is held to the JAX
package's scan (trees.py:331-356) bit for bit on fractional weights (the
bin prefix is XLA:CPU's own order); the level writes (``tree=``) equal the
torch bookkeeping ``fit_trees`` used to run after the split
(``_fit_trees_torch_bookkeeping``), at depth 3 and depth 9 with node
subsets.  ``chip_smoke._device_ms`` picks a kernel's device time out of a
profiler table by the kernel's own name.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

F32 = np.float32
INT_MAX = 2 ** 31 - 1


# --------------------------------------------------------------------------
# gini_split_plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 60, 150, 300])
@pytest.mark.parametrize("D,width", [(1, None), (6, 2), (28, None), (28, 5),
                                     (33, 6), (1597, None), (1597, 40)])
def test_gini_split_plan_covers_every_shape(K, D, width):
    """K lanes x P nodes up to 2,048 at 2 .. 127 bins and 2 .. 40 classes:
    W (1, 2, 4, 8) warps a node of ``fc`` features each cover D, spread
    only where the level's warps fall short; the class chunk is the
    smallest template that holds C (8 past it, in chunks); FPS features a
    group keep FPS·ipf <= 32 lanes; a staged row holds bins 0 .. NB-2 of
    the chunk's statistics at a stride = 1 mod 32; ``hb`` is the cheapest
    of (16, 8, 6, 4) by ``_gini_cost`` (the larger on a tie); shared memory is
    each warp's two slices and two lists, two blocks an SM at most."""
    for P in (1, 2, 32, 256, 2048):
        for NB in (2, 17, 32, 64, 127):
            for C in (2, 3, 4, 6, 9, 40):
                plan = tk.gini_split_plan(K, P, D, NB, C, width)
                W, fc = plan["W"], plan["fc"]
                assert W in (1, 2, 4, 8) and W * fc >= D
                assert fc == -(-D // W)
                if W > 1:
                    assert W <= D and K * P * W // 2 < tk.SPLIT_TARGET_WARPS
                if W < 8:
                    assert 2 * W > D or K * P * W >= tk.SPLIT_TARGET_WARPS
                ct = plan["ct"]
                assert ct == next((t for t in (2, 4, 8) if t >= C), 8)
                assert plan["class_chunks"] == -(-C // ct)
                hb, ipf, FPS = plan["hb"], plan["ipf"], plan["FPS"]
                assert hb in (16, 8, 6, 4) and ipf == -(-(NB - 1) // hb)
                assert 1 <= FPS and FPS * ipf <= 32
                SP = 1 + min(ct, C)
                assert plan["FST"] >= (NB - 1) * SP
                assert plan["FST"] % 32 == 1 and plan["FST"] - 32 < (NB - 1) * SP
                words = 2 * FPS * plan["FST"] + 2 * FPS
                assert words <= tk.GINI_WARP_WORDS or FPS == 1
                assert plan["smem"] == 4 * 8 * words <= 227 * 1024
                assert plan["nodes_per_block"] == 8 // W
                assert plan["blocks"] == -(-P // (8 // W)) * K
                nf = max(1, min(fc, D if width is None else width))
                costs = {}
                for h in (16, 8, 6, 4):
                    i = -(-(NB - 1) // h)
                    cap = max(1, (tk.GINI_WARP_WORDS // 2)
                              // (plan["FST"] + 1))
                    f = max(1, min(32 // i, nf, cap))
                    costs[h] = tk._gini_cost(NB, SP, h, nf, f,
                                             plan["class_chunks"])
                assert costs[hb] == min(costs.values())
                assert all(costs[h] > costs[hb] for h in costs if h > hb)


def test_gini_split_plan_main_shapes():
    """The default grid's forest levels (5-of-28 subsets, 32 bins, binary):
    a warp a node at level 11 with 150 lanes, 6 bins a lane (30 lanes on a
    5-feature subset), one group; 8 warps a node at the root."""
    deep = tk.gini_split_plan(150, 2048, 28, 32, 2, 5)
    assert (deep["W"], deep["hb"], deep["FPS"], deep["FST"]) == (1, 6, 5, 97)
    assert tk.gini_split_plan(150, 1, 28, 32, 2, 5)["W"] == 8
    assert tk.gini_split_plan(60, 32, 28, 32, 2, 5)["W"] == 2
    forty = tk.gini_split_plan(3, 4, 28, 32, 40)
    assert (forty["ct"], forty["class_chunks"]) == (8, 5)
    assert tk.gini_split_plan(6, 64, 16, 32, 4, 4)["ct"] == 4


@pytest.mark.parametrize("shape", [(0, 4, 28, 32, 2), (3, 0, 28, 32, 2),
                                   (3, 4, 0, 32, 2), (3, 4, 28, 1, 2),
                                   (3, 4, 28, 128, 2), (3, 4, 28, 32, 1),
                                   (65536, 4, 28, 32, 2)])
def test_gini_split_plan_refuses_what_no_launch_holds(shape):
    with pytest.raises(ValueError, match="gini_split_plan"):
        tk.gini_split_plan(*shape)


# --------------------------------------------------------------------------
# the kernel's arithmetic emulated, the twin against JAX
# --------------------------------------------------------------------------

def _gini_level(rng, K, P, D, NB, C, dup=(), zero_nodes=0.2,
                weights=(0.0, 0.5, 1.0, 1.25, 2.0), n=40):
    """Histograms [K, P, D, NB, 1+C] of fractional non-negative weights w
    and w·[y = c], every feature's bins summing to the node's totals;
    columns ``dup`` = (i, j): feature j a copy of feature i (an exact tie);
    a share of the nodes empty."""
    w = rng.choice(np.asarray(weights, F32), size=(K, P, n))
    w[rng.random((K, P)) < zero_nodes] = 0
    y = rng.integers(0, C, size=(K, P, n))
    st = np.concatenate([w[..., None], w[..., None] * (
        y[..., None] == np.arange(C)).astype(F32)], axis=-1).astype(F32)
    bins = rng.integers(0, NB, size=(K, P, n, D))
    for i, j in dup:
        bins[..., j] = bins[..., i]
    hist = np.zeros((K, P, D, NB, 1 + C), F32)
    for d in range(D):
        for r in range(n):
            np.add.at(hist[:, :, d], (np.arange(K)[:, None],
                                      np.arange(P)[None, :],
                                      bins[:, :, r, d]), st[:, :, r])
    tot = np.zeros((K, P, 1 + C), F32)
    for r in range(n):
        tot += st[:, :, r]
    splits = np.sort(rng.normal(size=(D, NB - 1)).astype(F32), axis=1)
    return hist, tot, splits


def _better(a, b):
    """(gain, feature, bin) a beats b: split_level.cuh's split_better."""
    return a[0] > b[0] or (a[0] == b[0] and (a[1] < b[1] or (
        a[1] == b[1] and a[2] < b[2])))


def _emulate_gini(hist, tot, fmask, node_mask, splits, mi, mg, plan):
    """``csrc/tree_split_gini.cu``'s arithmetic in numpy f32: a node under
    2·mi reads nothing; else each of its W warps compacts the allowed
    features of its chunk into groups of FPS and, group by group and class
    chunk by class chunk, lane l on feature l // ipf adds the bins before
    its hb bins (blocks of 16 serially, then the block's start) and walks
    its bins: the class squares in class order, the gain at the last chunk,
    a strict ``>``; then the first max over the lanes and the chunks."""
    K, P, D, NB, S = hist.shape
    C = S - 1
    W, fc, ct, hb, FPS = (plan[k] for k in ("W", "fc", "ct", "hb", "FPS"))
    ipf, ncc = plan["ipf"], plan["class_chunks"]
    z, tiny = F32(0), F32(1e-12)
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
                pcnt = max(pc, tiny)
                psq = z
                for j in range(C):
                    q = t[1 + j] / pcnt
                    psq = psq + q * q
                wpar = pcnt * (F32(1) - psq)
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
                            lsq, rsq = [z] * hb, [z] * hb
                            for cc in range(ncc):
                                c0 = cc * ct
                                ctn = min(ct, C - c0)
                                x = hist[k, p, f][:, [0] + [1 + c0 + j for j in
                                                            range(ctn)]]
                                ib = np.zeros(1 + ctn, F32)
                                ob = np.zeros(1 + ctn, F32)
                                for b in range(b0):
                                    if b % 16 == 0 and b:
                                        ob, ib = ob + ib, np.zeros_like(ib)
                                    ib = ib + x[b]
                                for h in range(hb):
                                    b = b0 + h
                                    if b >= b1:
                                        continue
                                    if b % 16 == 0 and b:
                                        ob, ib = ob + ib, np.zeros_like(ib)
                                    ib = ib + x[b]
                                    l = ib + ob
                                    lc, rc = l[0], pc - l[0]
                                    cl, cr = max(lc, tiny), max(rc, tiny)
                                    for j in range(ctn):
                                        ql = l[1 + j] / cl
                                        lsq[h] = lsq[h] + ql * ql
                                        qr = (t[1 + c0 + j] - l[1 + j]) / cr
                                        rsq[h] = rsq[h] + qr * qr
                                    if cc == ncc - 1:
                                        wl = cl * (F32(1) - lsq[h])
                                        wr = cr * (F32(1) - rsq[h])
                                        gain = (wpar - wl) - wr
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


@pytest.mark.parametrize("K,P,D,NB,C,sub,dup", [
    (3, 4, 12, 32, 2, 5, ((3, 9),)),      # subsets, a tie across lanes
    (2, 8, 7, 17, 2, None, ((1, 6),)),    # every feature, one block + 1 bin
    (2, 1, 28, 32, 2, 5, ()),             # one node: W = 8 chunks
    (2, 4, 5, 127, 2, None, ()),          # 127 bins: 8 blocks of 16
    (2, 4, 6, 33, 4, 3, ((0, 5),)),       # the multiclass workload's C
    (1, 3, 5, 20, 40, None, ()),          # 40 classes: 5 class chunks
    (3, 16, 6, 2, 3, None, ()),           # 2 bins: one split point
])
def test_gini_emulation_gives_the_twins_bits(K, P, D, NB, C, sub, dup):
    """The kernel's arithmetic (``_emulate_gini``) on the wrapper's own plan
    gives the twin's bits in every output, at min_instances that leave
    some nodes under 2·min_instances, on fractional weights, node subsets
    with empty nodes and a node with no feature, and exact ties taken by
    the lowest feature, then bin."""
    rng = np.random.default_rng(K * 1000 + P * 10 + NB + C)
    hist, tot, splits = _gini_level(rng, K, P, D, NB, C, dup)
    fmask = np.ones(D, bool)
    fmask[D // 3] = D < 3
    node_mask = None
    if sub is not None:
        node_mask = np.zeros((K, P, D), bool)
        for k in range(K):
            for p in range(P):
                node_mask[k, p, rng.permutation(D)[:sub]] = True
        node_mask[0, 0] = False
    mi = np.asarray([1.0, 0.0, 3.0][:K], F32)
    mg = np.asarray([0.0, 0.01, -1.0][:K], F32)
    width = None if node_mask is None else int(node_mask.sum(axis=2).max())
    plan = tk.gini_split_plan(K, P, D, NB, C, width)
    want = _emulate_gini(hist, tot, fmask, node_mask, splits, mi, mg, plan)
    got = tk.tree_split_gini_twin(*(None if a is None else torch.as_tensor(a)
                                    for a in (hist, tot, fmask, node_mask,
                                              splits, mi, mg)))
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    if P > 1:
        assert (~(tot[..., 0] >= 2 * mi[:, None])).any()
    assert np.isfinite(want["gain"]).any()
    for i, j in dup:
        assert not (got["feature"].numpy() == j).any()


@pytest.mark.parametrize("hb", [4, 6, 8, 16])
@pytest.mark.parametrize("K,P,D,NB,C,sub", [
    (3, 4, 12, 32, 2, 5),                 # the forests' subsets
    (2, 4, 9, 40, 4, None),               # 39 split points: ragged lanes
    (1, 3, 5, 127, 9, None),              # 127 bins, two class chunks
])
def test_gini_emulation_at_every_lane_width(monkeypatch, hb, K, P, D, NB, C,
                                            sub):
    """Each of the kernel's lane widths (4, 6, 8 and 16 bins a lane: 6 puts
    lanes across the blocks of 16 bins, whose sums the lane then splits at
    the block's edge) gives the twin's bits through the emulation, with
    the plan made to pick it."""
    monkeypatch.setattr(tk, "GINI_LANE_BINS", (hb,))
    rng = np.random.default_rng(hb * 100 + NB + C)
    hist, tot, splits = _gini_level(rng, K, P, D, NB, C)
    fmask = np.ones(D, bool)
    node_mask = None
    if sub is not None:
        node_mask = np.zeros((K, P, D), bool)
        for k in range(K):
            for p in range(P):
                node_mask[k, p, rng.permutation(D)[:sub]] = True
    mi = np.asarray([1.0, 0.0, 3.0][:K], F32)
    mg = np.zeros(K, F32)
    plan = tk.gini_split_plan(K, P, D, NB, C, sub)
    assert plan["hb"] == hb
    want = _emulate_gini(hist, tot, fmask, node_mask, splits, mi, mg, plan)
    got = tk.tree_split_gini_twin(*(None if a is None else torch.as_tensor(a)
                                    for a in (hist, tot, fmask, node_mask,
                                              splits, mi, mg)))
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    assert np.isfinite(want["gain"]).any()


def _jax_gini_scan(hist, tot, node_mask, mi, chunk):
    """The JAX level body's choice per node (trees.py:331-356) for one
    lane: cumsum over bins, ``_gain_gini``, the ``ok`` mask with the
    node subsets, max / argmax over bins, then over the features of each
    ``chunk`` and across chunks with a strict ``>``.  hist [P, D, NB, S]
    → (gain, feature, bin) [P]."""
    P, D, NB, _ = hist.shape
    best = np.full(P, -np.inf, F32)
    bf = np.zeros(P, np.int32)
    bb = np.zeros(P, np.int32)
    node_stats = jnp.asarray(tot)
    for c0 in range(0, D, chunk):
        h = jnp.asarray(hist[:, c0:c0 + chunk]).transpose(1, 0, 2, 3)
        left = jnp.cumsum(h, axis=2)
        right = node_stats[None, :, None, :] - left
        gains = jt._gain_gini(left, right, node_stats[None, :, None, :], 1.0)
        nm = jnp.asarray(node_mask[:, c0:c0 + chunk].T)
        ok = ((left[..., 0] >= mi) & (right[..., 0] >= mi) & nm[:, :, None]
              & (jnp.arange(NB)[None, None, :] < NB - 1))
        gains = jnp.where(ok, gains, -jnp.inf)
        cg, cb = jnp.max(gains, axis=2), jnp.argmax(gains, axis=2)
        fg, fi = np.asarray(jnp.max(cg, axis=0)), np.asarray(
            jnp.argmax(cg, axis=0))
        fb = np.asarray(cb)[fi, np.arange(P)]
        better = fg > best
        best = np.where(better, fg, best)
        bf = np.where(better, c0 + fi, bf)
        bb = np.where(better, fb, bb)
    return best, bf, bb


@pytest.mark.parametrize("NB,chunk", [(32, 1024), (127, 1024), (32, 3)])
def test_gini_twin_equals_the_jax_scan_bit_for_bit(NB, chunk):
    """A forest level of fractional (non-integral) weights with node
    subsets: the twin (the bin prefix in blocks of 16, a node under
    2·min_instances a leaf without its table) gives the JAX scan's gain
    bits, feature and bin at every node — also where the JAX scan takes
    the features in chunks of 3 — and the sums it adds are inexact in f32
    (another order would round them otherwise)."""
    rng = np.random.default_rng(NB + chunk)
    P, D, mi = 24, 9, F32(1.5)
    hist, tot, splits = _gini_level(rng, 1, P, D, NB, 2, weights=(
        0.1, 0.3, 0.7, 0.25, 1.3), zero_nodes=0.1, n=60)
    node_mask = np.zeros((1, P, D), bool)
    for p in range(P):
        node_mask[0, p, rng.permutation(D)[:4]] = True
    got = tk.tree_split_gini_twin(
        torch.as_tensor(hist), torch.as_tensor(tot),
        torch.ones(D, dtype=torch.bool), torch.as_tensor(node_mask),
        torch.as_tensor(splits), torch.tensor([mi]), torch.tensor([0.0]))
    best, bf, bb = _jax_gini_scan(hist[0], tot[0], node_mask[0], mi, chunk)
    np.testing.assert_array_equal(got["gain"][0].numpy(), best)
    np.testing.assert_array_equal(got["feature"][0].numpy(), bf)
    np.testing.assert_array_equal(got["bin"][0].numpy(), bb)
    assert np.isfinite(best).sum() >= P // 2
    serial = np.cumsum(hist[0, ..., 0].astype(np.float64), axis=2)
    assert (serial != serial.astype(F32)).any()


# --------------------------------------------------------------------------
# the epilogue: the level's tree arrays
# --------------------------------------------------------------------------

def _emulate_gini_epilogue(out, tot, tree0, offset):
    """``csrc/tree_split_gini.cu``'s epilogue and split_level.cuh's gain
    walk on numpy arrays: each node's feature (-1 on a leaf), threshold,
    is_leaf and class shares tot[1:] / max(tot[0], 1e-12), then each
    lane's split nodes' gains added into gain[k, feature] in node order."""
    feature, threshold, is_leaf, leaf, gain = (a.copy() for a in tree0)
    K, P = out["feature"].shape
    for k in range(K):
        for p in range(P):
            t = offset + p
            lf = bool(out["is_leaf"][k, p])
            feature[k, t] = -1 if lf else out["feature"][k, p]
            threshold[k, t] = out["threshold"][k, p]
            is_leaf[k, t] = lf
            leaf[k, t] = tot[k, p, 1:] / max(tot[k, p, 0], F32(1e-12))
            if not lf:
                f = out["feature"][k, p]
                gain[k, f] = F32(gain[k, f] + out["gain"][k, p])
    return feature, threshold, is_leaf, leaf, gain


def test_gini_epilogue_writes_the_level_arrays():
    """With ``tree=`` the wrapper writes the level's slices — feature -1 on
    a leaf, the threshold, the leaf flag, the C class shares of the node's
    totals — and adds the split nodes' gains in node order, as the kernel's
    epilogue and gain walk do (emulated), leaving the rest of the arrays
    as they were."""
    rng = np.random.default_rng(3)
    K, P, D, NB, C = 3, 8, 6, 32, 4
    hist, tot, splits = _gini_level(rng, K, P, D, NB, C)
    T, off = 31, 7
    tree0 = (np.full((K, T), -1, np.int32), np.full((K, T), np.inf, F32),
             np.zeros((K, T), bool), np.zeros((K, T, C), F32),
             rng.random((K, D)).astype(F32))
    tree = tuple(torch.as_tensor(a.copy()) for a in tree0)
    args = [torch.as_tensor(a) for a in (hist, tot)] + [
        torch.ones(D, dtype=torch.bool), None, torch.as_tensor(splits),
        torch.tensor([1.0, 0.0, 2.0]), torch.tensor([0.0, 0.01, 0.0])]
    out = tk.tree_split_gini(*args, tree=tree, offset=off)
    want = _emulate_gini_epilogue({k: v.numpy() for k, v in out.items()},
                                  tot, tree0, off)
    for a, b, name in zip(tree, want, pt.TreeArrays._fields):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert (~out["is_leaf"]).any() and out["is_leaf"].any()
    assert (tree[0][:, :off] == -1).all() and (tree[2][:, off + P:] == 0).all()


def _fit_trees_torch_bookkeeping(B, splits, stats, fmask, node_masks, *,
                                 max_depth, n_bins, min_instances, min_gain):
    """``fit_trees(impurity="gini")`` as it was before the split wrote its
    level's arrays: the split's dict, the route, then the
    level's leaf values, flags, features, thresholds and gain sums by torch
    ops."""
    K, N, S = stats.shape
    D = B.shape[1]
    T = 2 ** (max_depth + 1) - 1
    feature = torch.full((K, T), -1, dtype=torch.int32)
    threshold = torch.full((K, T), float("inf"))
    is_leaf = torch.zeros((K, T), dtype=torch.bool)
    leaf = torch.zeros((K, T, S - 1))
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
        sp = tk.tree_split_gini(hist, totals, fmask, nm, splits,
                                min_instances, min_gain)
        row_node = tk.tree_route_twin(B, row_node, sp["feature"], sp["bin"],
                                      sp["is_leaf"], off)
        leaf[:, off:off + P] = tk.gini_leaf(totals)
        lf = sp["is_leaf"]
        is_leaf[:, off:off + P] = lf
        feature[:, off:off + P] = torch.where(lf, -1, sp["feature"])
        threshold[:, off:off + P] = sp["threshold"]
        gain.scatter_add_(1, sp["feature"].long(),
                          torch.where(lf, 0.0, sp["gain"]))
    leaf[:, off:] = tk.gini_leaf(totals)
    is_leaf[:, off:] = True
    return pt.TreeArrays(feature, threshold, is_leaf, leaf, gain)


@pytest.mark.parametrize("depth,C", [(3, 2), (9, 2), (4, 4)])
def test_fit_trees_gini_with_the_split_epilogue_keeps_its_bits(depth, C):
    """``fit_trees(impurity="gini")``, whose split writes each level's tree
    arrays, gives the bits of the loop that wrote them with torch ops after
    the split, on 4 lanes of Poisson-like weights with per-node subsets of
    3 of 6 features (depth 9 reaches the deep histograms)."""
    rng = np.random.default_rng(depth * 10 + C)
    N, D, NB, K = 3_000, 6, 32, 4
    X = rng.normal(size=(N, D)).astype(F32)
    z = X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N)
    y = np.clip(np.floor((z + 2) * C / 4), 0, C - 1).astype(np.int64)
    splits = pt.build_bin_splits(X, NB)
    B = pt.bin_data(torch.as_tensor(X), torch.as_tensor(splits))
    w = rng.poisson(1.0, size=(K, N)).astype(F32) * (
        rng.random((K, N)) > 0.33)
    onehot = (y[None, :, None] == np.arange(C)).astype(F32)
    stats = torch.as_tensor(np.concatenate(
        [w[..., None], w[..., None] * onehot], axis=2).astype(F32))
    masks = []
    for lvl in range(depth):
        m = np.zeros((K, 1 << lvl, D), bool)
        keys = rng.random(m.shape)
        np.put_along_axis(m, np.argsort(keys, axis=2)[..., :3], True, axis=2)
        masks.append(torch.as_tensor(m))
    kw = dict(max_depth=depth, n_bins=NB,
              min_instances=torch.tensor([1.0, 5.0, 1.0, 20.0]),
              min_gain=torch.tensor([0.0, 0.0, 0.01, 0.001]))
    fmask = torch.ones(D, dtype=torch.bool)
    got = pt.fit_trees(B, torch.as_tensor(splits), stats, fmask,
                       impurity="gini", node_masks=masks, **kw)
    want = _fit_trees_torch_bookkeeping(B, torch.as_tensor(splits), stats,
                                        fmask, masks, **kw)
    for a, b, name in zip(got, want, pt.TreeArrays._fields):
        assert torch.equal(a, b), name
    assert int((~got.is_leaf).sum()) > 10


# --------------------------------------------------------------------------
# chip_smoke's device time by kernel name
# --------------------------------------------------------------------------

def test_device_ms_matches_kernels_by_their_own_names():
    """``chip_smoke._device_ms`` sums the profiler's rows whose kernel —
    the identifier of a demangled name (``void ns::k<8>(...)``) or of a
    mangled one (``_Z17tree_split_kernelILi8EE...``) — is one of the
    names asked for: the gini split's own kernel and its gain walk, never
    the xgb split's or another kernel whose name merely starts alike; None
    where the window holds none of them."""
    kms = {"void tree_split_kernel<8>(float const*, float const*, unsigned": 1.0,
           "void tree_split_gini_kernel<2, 8>(float const*, float const*, ": 2.0,
           "tree_split_gain_kernel(float const*, int const*, unsigned char": 0.25,
           "_Z22tree_split_gini_kernelILi4ELi16EEvPKfS1_PKhS3_S1_S1_S1_PfPiS": 0.5,
           "void at::native::elementwise_kernel<128, 2>(int, at::native::": 4.0,
           "Memset (Device)": 8.0}
    assert chip_smoke._kernel_id(
        "void tree_split_gini_kernel<2, 8>(float const*)") == \
        "tree_split_gini_kernel"
    assert chip_smoke._kernel_id("_Z17tree_split_kernelILi8EEvPKf") == \
        "tree_split_kernel"
    assert chip_smoke._kernel_id(
        "void at::native::elementwise_kernel<128, 2>(int)") == \
        "elementwise_kernel"
    assert chip_smoke._device_ms(
        kms, "tree_split_gini_kernel", "tree_split_gain_kernel") == 2.75
    assert chip_smoke._device_ms(kms, "tree_split_kernel") == 1.0
    assert chip_smoke._device_ms(kms, "tree_route_kernel") is None
    assert chip_smoke._device_ms(kms, "tree_split_gini") == 2.75
    assert chip_smoke._device_ms(kms, "tree_split") == 1.25
