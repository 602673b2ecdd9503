"""``tree_route`` (rows to children, in place) and ``tree_split`` (the xgb
split with its level's tree arrays) of the PyTorch port, on the CPU.

The kernels run on the card only; these tests hold what surrounds them.
``route_plan`` and ``xgb_split_plan`` size every shape ``fit_trees`` can
send.  A numpy emulation of ``csrc/tree_route.cu``'s blocks (row tiles on
x, lane chunks on y, B's tile staged or gathered, only moved ids written)
and one of ``csrc/tree_split.cu``'s arithmetic (each lane's features, the
bin prefix in blocks of 16 bins, ``_gain_xgb`` in f32, the first max; its
gain kernel's walk) run on the wrappers' own arrays and must give the
twins' bits.  The twins are held to the JAX package: the route to its
routing block (trees.py:373-391) exactly, the split to its scan
(:339-356) bit for bit — the bin prefix is XLA:CPU's own order — with the
early leaf rule (a node under 2·min_instances) at its edge on fractional
weights.  ``fit_trees(impurity="xgb")`` with the split writing the level's
arrays gives the bits of the loop that wrote them with torch ops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

F32 = np.float32


# --------------------------------------------------------------------------
# route_plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 600, 5_000, 1_000_000, (1 << 31) - 1])
@pytest.mark.parametrize("D", [1, 28, 48, 49, 96, 192, 193, 1597])
def test_route_plan_covers_every_shape(N, D):
    """Every lane count fit_trees batches (1 .. 300) has a plan at every
    width: tiles of threads x rpt rows cover N, lane chunks of at most
    ``ROUTE_LANES`` cover K in at most 65,535 chunks, B's tile is staged
    exactly where it fits ``ROUTE_SMEM`` (D <= 64), and a launch whose
    row tiles alone are few splits its lanes further."""
    for K in (1, 2, 3, 6, 12, 60, 150, 200, 225, 300, 4_000):
        plan = tk.route_plan(N, D, K)
        rows = plan["threads"] * plan["rpt"]
        assert plan["rows"] == rows and plan["rpt"] in (1, 2, 4)
        assert plan["threads"] == tk.ROUTE_THREADS
        assert plan["nx"] * rows >= N > (plan["nx"] - 1) * rows
        assert plan["ny"] * plan["kc"] >= K > (plan["ny"] - 1) * plan["kc"]
        assert 1 <= plan["kc"] <= tk.ROUTE_LANES and plan["ny"] <= 65535
        assert plan["blocks"] == plan["nx"] * plan["ny"]
        assert plan["stage"] == (D <= tk.ROUTE_SMEM // tk.ROUTE_THREADS)
        if plan["stage"]:
            assert plan["smem"] == rows * D <= tk.ROUTE_SMEM
            assert 2 * rows * D > tk.ROUTE_SMEM or plan["rpt"] == 4
        else:
            assert plan["smem"] == 0 and plan["rpt"] == 4
        assert plan["blocks"] >= min(tk.ROUTE_MIN_BLOCKS, plan["nx"] * K)
    assert tk.route_plan(1_000_000, 28, 300)["kc"] == 30    # B read 10 times
    assert tk.route_plan(1_000_000, 28, 6)["kc"] == 6       # B read once


@pytest.mark.parametrize("shape", [(0, 28, 3), (10, 0, 3), (10, 28, 0),
                                   (1 << 31, 28, 3),
                                   (10, 28, 65535 * 32 + 1)])
def test_route_plan_refuses_what_no_launch_holds(shape):
    with pytest.raises(ValueError, match="route_plan"):
        tk.route_plan(*shape)


# --------------------------------------------------------------------------
# xgb_split_plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 6, 12, 60, 300])
@pytest.mark.parametrize("D", [1, 28, 33, 100, 1597])
def test_xgb_split_plan_covers_every_shape(K, D):
    """K lanes x P nodes up to 4,096 at 2 .. 127 bins: W (1, 2, 4, 8) warps
    a node of ``fc`` features each cover D; a node's features spread over
    several warps (each keeping a feature) only where the level's K·P
    warps fall short of ``SPLIT_TARGET_WARPS``; 256-thread blocks of 8 / W
    nodes; each warp's bins staged 8 at a time, or 32 where it holds at
    most 8 features, in two slices of shared memory."""
    for P in (1, 2, 4, 32, 256, 2048, 4096):
        for NB in (2, 16, 32, 64, 127):
            plan = tk.xgb_split_plan(K, P, D, NB)
            W, fc = plan["W"], plan["fc"]
            assert W in (1, 2, 4, 8) and W * fc >= D
            assert fc == -(-D // W)
            if W > 1:
                assert W <= D and K * P * W // 2 < tk.SPLIT_TARGET_WARPS
            if W < 8:
                assert 2 * W > D or K * P * W >= tk.SPLIT_TARGET_WARPS
            assert plan["threads"] == 256
            assert plan["nodes_per_block"] == 8 // W
            assert plan["blocks"] == -(-P // (8 // W)) * K
            assert plan["smem"] == 4 * 2 * 8 * tk.SPLIT_SLICE <= 227 * 1024
            sb, nfw = plan["sb"], min(32, fc)
            assert sb == (32 if fc <= 8 else 8)
            assert nfw * (3 * sb + 1) <= tk.SPLIT_SLICE
    assert tk.xgb_split_plan(6, 2048, 28, 32)["W"] == 1
    assert tk.xgb_split_plan(3, 4, 28, 32)["W"] == 8
    assert tk.xgb_split_plan(3, 4, 28, 32)["sb"] == 32     # one stage
    assert tk.xgb_split_plan(6, 2048, 28, 32)["sb"] == 8
    assert tk.xgb_split_plan(2, 1, 1597, 32)["W"] == 8


@pytest.mark.parametrize("shape", [(0, 4, 28, 32), (3, 0, 28, 32),
                                   (3, 4, 0, 32), (3, 4, 28, 1),
                                   (3, 4, 28, 128), (65536, 4, 28, 32)])
def test_xgb_split_plan_refuses_what_no_launch_holds(shape):
    with pytest.raises(ValueError, match="xgb_split_plan"):
        tk.xgb_split_plan(*shape)


# --------------------------------------------------------------------------
# tree_route: the kernel's tiling emulated, the twin against the JAX block
# --------------------------------------------------------------------------

def _route_level(rng, K, N, D, P, NB=32, leaf_share=0.2):
    """B, ids at, above and below a level at offset P - 1 (P nodes), each
    node's split (a share of them leaves, some bins below 0 or past the
    bins B holds)."""
    off = P - 1
    B = rng.integers(0, NB, size=(N, D)).astype(np.int8)
    row_node = rng.integers(max(0, off - P // 2), off + P + P // 2,
                            size=(K, N)).astype(np.int32)
    feat = rng.integers(0, D, size=(K, P)).astype(np.int32)
    bin_ = rng.integers(0, NB - 1, size=(K, P)).astype(np.int32)
    bin_[:, ::7] = -5                   # every row goes right
    bin_[:, 3::11] = 300                # every row goes left
    leaf = rng.random((K, P)) < leaf_share
    return B, row_node, feat, bin_, leaf, off


def _emulate_route(B, row_node, feat, bin_, leaf, off, plan):
    """``csrc/tree_route.cu`` on numpy arrays: each node's split packed into
    one code (-1 at a leaf, else feature << 8 | (bin clamped to [-1, 127]
    + 1)), then block by block: block (x, y) stages rows [x·rows, ..) of B
    (or gathers them) and routes lanes [y·kc, ..) of its tile in place from
    the codes, writing only moved ids.  Returns the routed ids and how many
    ids were written."""
    K, N = row_node.shape
    P = feat.shape[1]
    code = np.where(leaf, -1, (feat.astype(np.int64) << 8)
                    | (np.clip(bin_, -1, 127) + 1)).astype(np.int32)
    out = row_node.copy()
    writes = 0
    rows, kc = plan["rows"], plan["kc"]
    for by in range(plan["ny"]):
        for bx in range(plan["nx"]):
            n0, n1 = bx * rows, min(N, (bx + 1) * rows)
            tile = B[n0:n1].copy() if plan["stage"] else None
            for k in range(by * kc, min(K, (by + 1) * kc)):
                node = out[k, n0:n1].astype(np.int64)
                p = node - off
                at = (p >= 0) & (p < P)
                pc = np.where(at, p, 0)
                cd = code[k, pc]
                r = np.nonzero(at & (cd >= 0))[0]
                f = cd[r] >> 8
                b = (tile[r, f] if plan["stage"] else B[n0 + r, f])
                out[k, n0 + r] = 2 * node[r] + 1 + (b > (cd[r] & 255) - 1)
                writes += r.size
    return out, writes


@pytest.mark.parametrize("K,N,D,P,lanes,smem", [
    (3, 5_000, 28, 4, 32, 48 * 1024),      # one lane chunk, 5 tiles
    (60, 3_001, 28, 32, 4, 48 * 1024),     # 15 lane chunks, a ragged tile
    (7, 2_500, 120, 64, 3, 48 * 1024),     # rpt 1 (D = 120), 10 tiles
    (5, 2_000, 300, 2048, 2, 48 * 1024),   # wide B: gathered
    (4, 1_000, 28, 16, 32, 8 * 1024),      # an 8 KB budget: tiles of 256 rows
])
def test_route_emulation_equals_the_twin(monkeypatch, K, N, D, P, lanes,
                                         smem):
    """The route's blocks (row tiles, lane chunks, staged or gathered B)
    on the wrapper's own arrays give the twin's ids, write only the ids
    that move, and the wrapper routes in place (a CPU tensor: the twin's
    ids copied back into it, the same tensor returned)."""
    monkeypatch.setattr(tk, "ROUTE_LANES", lanes)
    monkeypatch.setattr(tk, "ROUTE_SMEM", smem)
    rng = np.random.default_rng(K * N + D)
    B, rn, feat, bin_, leaf, off = _route_level(rng, K, N, D, P)
    plan = tk.route_plan(N, D, K)
    if smem < 48 * 1024:
        assert plan["rows"] == 256 and plan["stage"]
    assert (plan["nx"] > 1 or plan["ny"] > 1)
    got, writes = _emulate_route(B, rn, feat, bin_, leaf, off, plan)
    args = [torch.as_tensor(a) for a in (B, rn, feat, bin_, leaf)]
    want = tk.tree_route_twin(*args, off).numpy()
    np.testing.assert_array_equal(got, want)
    assert writes == int((want != rn).sum())
    t = torch.as_tensor(rn.copy())
    assert tk.tree_route(args[0], t, *args[2:], off) is t
    np.testing.assert_array_equal(t.numpy(), want)


def _jax_route(B, row_node, feat, bin_, leaf, off):
    """The JAX package's routing block (trees.py:373-391) for one lane."""
    P = feat.shape[0]
    nodes = off + jnp.arange(P, dtype=jnp.int32)
    rn = jnp.asarray(row_node)
    oh = (rn[:, None] == nodes[None, :]).astype(jnp.float32)
    f_of_row = (oh @ jnp.asarray(feat).astype(jnp.float32)).astype(jnp.int32)
    bin_of_row = oh @ jnp.asarray(bin_).astype(jnp.float32)
    dead_of_row = oh @ jnp.asarray(leaf).astype(jnp.float32)
    at_level = jnp.sum(oh, axis=1) > 0.5
    b_of_row = jnp.take_along_axis(jnp.asarray(B), f_of_row[:, None],
                                   axis=1)[:, 0].astype(jnp.float32)
    go_right = (b_of_row > bin_of_row).astype(jnp.int32)
    child = 2 * rn + 1 + go_right
    return np.asarray(jnp.where(at_level & (dead_of_row < 0.5), child, rn))


@pytest.mark.parametrize("P", [1, 4, 32, 256])
def test_route_twin_equals_the_jax_routing_block(P):
    """Each lane's ids after the twin's route equal the JAX routing block's
    on the same numpy inputs: rows above the level, below it, under a leaf
    and under a split, B's bins at and past the split bin."""
    rng = np.random.default_rng(P)
    K, N, D = 3, 2_000, 7
    B, rn, feat, bin_, leaf, off = _route_level(rng, K, N, D, P)
    want = np.stack([_jax_route(B, rn[k], feat[k], bin_[k], leaf[k], off)
                     for k in range(K)])
    got = tk.tree_route_twin(*(torch.as_tensor(a) for a in
                               (B, rn, feat, bin_, leaf)), off).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != rn).any() and (got == rn).any()


# --------------------------------------------------------------------------
# tree_split: the kernel's arithmetic emulated, the twin against JAX
# --------------------------------------------------------------------------

def _xgb_level(rng, K, P, D, NB, dup=(), zero_nodes=0.2, weights=(
        0.0, 0.5, 1.0, 1.25)):
    """Histograms [K, P, D, NB, 3] of fractional non-negative counts,
    w·g, w·h, every feature's bins summing to the node's totals; columns
    ``dup`` = (i, j): feature j a copy of feature i (an exact tie); a share
    of the nodes empty."""
    n = 40
    w = rng.choice(np.asarray(weights, F32), size=(K, P, n))
    w[rng.random((K, P)) < zero_nodes] = 0
    p = rng.random((K, P, n)).astype(F32)
    y = (rng.random((K, P, n)) < 0.4).astype(F32)
    st = np.stack([w, w * (p - y), w * p * (1 - p)], axis=-1).astype(F32)
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


def _emulate_split(hist, tot, fmask, splits, mi, mg, lam, plan):
    """``csrc/tree_split.cu``'s arithmetic in numpy f32: a node under
    2·mi reads nothing; else lane l of chunk c walks its features' bins,
    the prefix serial within blocks of 16 bins plus the blocks before, the
    gain ``0.5 * ((gl²/(hl+λ) + gr²/(hr+λ)) - gp²/(hp+λ))``, a strict
    ``>``; then the best gain, the lowest feature on a tie, across the
    lanes and chunks."""
    K, P, D, NB, _ = hist.shape
    pc, pg, ph = (tot[..., i][..., None] for i in range(3))
    lamk = lam[:, None, None]
    ps = pg * pg / (ph + lamk)
    best = np.full((K, P, D), -np.inf, F32)
    bbin = np.zeros((K, P, D), np.int32)
    ic, ig, ih, oc, og, oh = (np.zeros((K, P, D), F32) for _ in range(6))
    for b in range(NB - 1):
        if b and b % 16 == 0:
            oc, og, oh = oc + ic, og + ig, oh + ih
            ic, ig, ih = (np.zeros((K, P, D), F32) for _ in range(3))
        ic = ic + hist[:, :, :, b, 0]
        ig = ig + hist[:, :, :, b, 1]
        ih = ih + hist[:, :, :, b, 2]
        cl, gl, hl = ic + oc, ig + og, ih + oh
        rc, rg, rh = pc - cl, pg - gl, ph - hl
        gn = F32(0.5) * ((gl * gl / (hl + lamk) + rg * rg / (rh + lamk))
                         - ps)
        take = (fmask[None, None, :] & (cl >= mi[:, None, None])
                & (rc >= mi[:, None, None]) & (gn > best))
        best = np.where(take, gn, best)
        bbin = np.where(take, b, bbin)
    can = tot[..., 0] >= F32(2) * mi[:, None]
    best[~can] = -np.inf
    bbin[~can] = 0
    # lanes, then chunks: the highest gain, the lowest feature on a tie
    feat = np.argmax(best, axis=2).astype(np.int32)
    g = np.take_along_axis(best, feat[..., None], axis=2)[..., 0]
    b = np.take_along_axis(bbin, feat[..., None], axis=2)[..., 0]
    leaf = ~(np.isfinite(g) & (g > mg[:, None]))
    thr = splits[feat, np.clip(b, 0, NB - 2)]
    value = -(tot[..., 1] / (tot[..., 2] + lam[:, None]))
    return {"gain": g, "feature": feat, "bin": b, "is_leaf": leaf,
            "threshold": thr, "value": value}


@pytest.mark.parametrize("K,P,D,NB,dup", [
    (3, 4, 28, 32, ((3, 20),)),            # a tie across lanes
    (2, 2, 40, 32, ((5, 37),)),            # a tie across chunks (W = 2)
    (2, 8, 70, 17, ((1, 65),)),            # a lane's two features tie
    (3, 4, 8, 127, ()),                    # 127 bins: 8 blocks of 16
    (6, 64, 6, 2, ()),                     # 2 bins: one split point
])
def test_split_emulation_gives_the_twins_bits(K, P, D, NB, dup):
    """The kernel's arithmetic (``_emulate_split``) on the same level gives
    the twin's bits in every output, at min_instances that leave some
    nodes under 2·min_instances, with exact ties across lanes, chunks and
    a lane's features taken by the lowest feature."""
    rng = np.random.default_rng(K * 100 + D + NB)
    hist, tot, splits = _xgb_level(rng, K, P, D, NB, dup)
    fmask = np.ones(D, bool)
    fmask[D // 3] = False
    mi = np.asarray([1.0, 0.0, 0.5, 3.0, 20.0, 2.0][:K], F32)
    mg = np.asarray([0.0, 0.01, 0.001, 0.0, 0.1, 0.0][:K], F32)
    lam = np.ones(K, F32)
    plan = tk.xgb_split_plan(K, P, D, NB)
    want = _emulate_split(hist, tot, fmask, splits, mi, mg, lam, plan)
    got = tk.tree_split_twin(*(torch.as_tensor(a) for a in (
        hist, tot, fmask, splits, mi, mg, lam)))
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    assert (~(tot[..., 0] >= 2 * mi[:, None])).any()
    for i, j in dup:
        assert not (got["feature"].numpy() == j).any()


def _jax_scan(hist, tot, mi, lam, chunk):
    """The JAX level body's choice per node (trees.py:339-356): cumsum
    over bins, ``_gain_xgb``, the ``ok`` mask, max / argmax over bins, then
    over the features of each ``chunk`` and across chunks with a strict
    ``>``.  hist [P, D, NB, 3] → (gain, feature, bin) [P]."""
    P, D, NB, _ = hist.shape
    best = np.full(P, -np.inf, F32)
    bf = np.zeros(P, np.int32)
    bb = np.zeros(P, np.int32)
    node_stats = jnp.asarray(tot)
    for c0 in range(0, D, chunk):
        h = jnp.asarray(hist[:, c0:c0 + chunk]).transpose(1, 0, 2, 3)
        left = jnp.cumsum(h, axis=2)
        right = node_stats[None, :, None, :] - left
        gains = jt._gain_xgb(left, right, node_stats[None, :, None, :], lam)
        ok = ((left[..., 0] >= mi) & (right[..., 0] >= mi)
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


@pytest.mark.parametrize("NB", [32, 127])
def test_split_twin_equals_the_jax_scan_at_the_early_leaf_edge(NB):
    """Nodes of fractional weights whose count totals sit just under, at and
    just over 2·min_instances: the twin (which makes a node under the edge
    a leaf without its table) gives the JAX scan's gain bits, feature and
    bin at every node; some nodes under the edge had a left side of at
    least min_instances, none of them a split; at the edge a split is
    still found."""
    rng = np.random.default_rng(NB)
    P, D, mi = 96, 5, F32(1.5)
    hist = np.zeros((1, P, D, NB, 3), F32)
    tot = np.zeros((1, P, 3), F32)
    for p in range(P):
        n = 4 + p % 5
        w = rng.choice(np.asarray([0.1, 0.3, 0.7, 0.25], F32), size=n)
        w *= F32(3.0 / max(float(w.sum()), 1e-3)) * F32(1 + (p % 3 - 1) * 1e-7)
        w = w.astype(F32)
        g = rng.normal(size=n).astype(F32)
        hh = rng.random(n).astype(F32)
        st = np.stack([w, w * g, w * hh], axis=-1).astype(F32)
        for r in range(n):
            tot[0, p] += st[r]
            for d in range(D):
                hist[0, p, d, rng.integers(0, NB)] += st[r]
    pc = tot[0, :, 0]
    under = pc < 2 * mi
    assert under.any() and (~under).any()
    lanes = [torch.as_tensor(np.asarray([v], F32)) for v in (mi, 0.0, 1.0)]
    splits = np.sort(rng.normal(size=(D, NB - 1)).astype(F32), axis=1)
    got = tk.tree_split_twin(torch.as_tensor(hist), torch.as_tensor(tot),
                             torch.ones(D, dtype=torch.bool),
                             torch.as_tensor(splits), *lanes)
    best, bf, bb = _jax_scan(hist[0], tot[0], mi, F32(1.0), 1024)
    np.testing.assert_array_equal(got["gain"][0].numpy(), best)
    np.testing.assert_array_equal(got["feature"][0].numpy(), bf)
    np.testing.assert_array_equal(got["bin"][0].numpy(), bb)
    assert np.isinf(best[under]).all() and np.isfinite(best[~under]).any()
    left0 = np.cumsum(hist[0, :, 0, :, 0], axis=1)
    assert (under & (left0[:, :-1] >= mi).any(axis=1)).any()


def _emulate_gain_walk(out, gain, WIN=1024):
    """``csrc/tree_split.cu``'s gain kernel for each lane: windows of
    ``WIN`` nodes staged (a leaf's feature read as -1), then a thread a
    feature walking them in order and adding the gains of its feature's
    nodes."""
    g = gain.copy()
    K, P = out["feature"].shape
    for k in range(K):
        f = np.where(out["is_leaf"][k], -1, out["feature"][k])
        for t in range(gain.shape[1]):
            a = g[k, t]
            for w0 in range(0, P, WIN):
                for i in range(w0, min(P, w0 + WIN)):
                    if f[i] == t:
                        a = F32(a + out["gain"][k, i])
            g[k, t] = a
    return g


def test_epilogue_gain_walk_equals_the_serial_scatter_add():
    """The gain kernel's walk (three windows of nodes, many nodes on one
    feature) adds the split nodes' gains into the lane's sums with the
    bits of ``write_level_twin``'s CPU ``scatter_add_`` in node order, and
    ``write_level_twin`` writes the level's slices as the old torch
    bookkeeping did."""
    rng = np.random.default_rng(5)
    K, P, D, T, off = 3, 2 * 1024 + 40, 6, 8191, 2047
    out = {"feature": rng.integers(0, D, (K, P)).astype(np.int32),
           "gain": (rng.random((K, P)) * 10.0 ** rng.integers(-3, 3, (K, P))
                    ).astype(F32),
           "is_leaf": rng.random((K, P)) < 0.3,
           "bin": rng.integers(0, 31, (K, P)).astype(np.int32),
           "threshold": rng.normal(size=(K, P)).astype(F32),
           "value": rng.normal(size=(K, P)).astype(F32)}
    gain0 = rng.random((K, D)).astype(F32)
    tree = (torch.full((K, T), -1, dtype=torch.int32),
            torch.full((K, T), float("inf")),
            torch.zeros((K, T), dtype=torch.bool), torch.zeros((K, T, 1)),
            torch.as_tensor(gain0.copy()))
    tk.write_level_twin({k: torch.as_tensor(v) for k, v in out.items()},
                        tree, off)
    np.testing.assert_array_equal(tree[4].numpy(),
                                  _emulate_gain_walk(out, gain0))
    lf = out["is_leaf"]
    sl = slice(off, off + P)
    np.testing.assert_array_equal(tree[0][:, sl].numpy(),
                                  np.where(lf, -1, out["feature"]))
    np.testing.assert_array_equal(tree[1][:, sl].numpy(), out["threshold"])
    np.testing.assert_array_equal(tree[2][:, sl].numpy(), lf)
    np.testing.assert_array_equal(tree[3][:, sl, 0].numpy(), out["value"])
    assert (tree[0][:, :off] == -1).all() and (tree[2][:, off + P:] == 0).all()


def _fit_trees_torch_bookkeeping(B, splits, stats, fmask, *, max_depth,
                                 n_bins, min_instances, min_gain, lam):
    """``fit_trees(impurity="xgb")`` as it was before the split wrote its
    level's arrays: the split's dict, the route out of place, then the
    level's slices and gain sums by torch ops."""
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
        hist, totals = tk.tree_hist(B, row_node, stats, off, P, n_bins,
                                    with_hist=not bottom)
        if bottom:
            break
        sp = tk.tree_split(hist, totals, fmask, splits, min_instances,
                           min_gain, lam)
        row_node = tk.tree_route_twin(B, row_node, sp["feature"], sp["bin"],
                                      sp["is_leaf"], off)
        leaf[:, off:off + P, 0] = sp["value"]
        lf = sp["is_leaf"]
        is_leaf[:, off:off + P] = lf
        feature[:, off:off + P] = torch.where(lf, -1, sp["feature"])
        threshold[:, off:off + P] = sp["threshold"]
        gain.scatter_add_(1, sp["feature"].long(),
                          torch.where(lf, 0.0, sp["gain"]))
    leaf[:, off:, 0] = -(totals[..., 1] / (totals[..., 2] + lam[:, None]))
    is_leaf[:, off:] = True
    return pt.TreeArrays(feature, threshold, is_leaf, leaf, gain)


@pytest.mark.parametrize("depth", [3, 9])
def test_fit_trees_xgb_with_the_split_epilogue_keeps_its_bits(depth):
    """``fit_trees(impurity="xgb")``, whose split writes each level's tree
    arrays and whose route moves ids in place, gives the bits of the loop
    that routed out of place and wrote the arrays with torch ops, at depth
    3 and at depth 9 (the deep levels' histograms), 4 lanes of fold
    weights and min_instances 5 and 40."""
    rng = np.random.default_rng(depth)
    N, D, NB, K = 3_000, 6, 32, 4
    X = rng.normal(size=(N, D)).astype(F32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N) > 0).astype(F32)
    splits = pt.build_bin_splits(X, NB)
    B = pt.bin_data(torch.as_tensor(X), torch.as_tensor(splits))
    p = 1 / (1 + np.exp(-0.4 * rng.normal(size=(K, N))))
    w = (rng.random((K, N)) > 0.33).astype(F32)
    stats = torch.as_tensor(np.stack(
        [w, w * (p - y), w * np.maximum(p * (1 - p), 1e-6)], axis=2)
        .astype(F32))
    kw = dict(max_depth=depth, n_bins=NB,
              min_instances=torch.tensor([5.0, 40.0, 5.0, 40.0]),
              min_gain=torch.tensor([0.0, 0.0, 0.01, 0.01]),
              lam=torch.ones(K))
    fmask = torch.ones(D, dtype=torch.bool)
    got = pt.fit_trees(B, torch.as_tensor(splits), stats, fmask, **kw)
    want = _fit_trees_torch_bookkeeping(B, torch.as_tensor(splits), stats,
                                        fmask, **kw)
    for a, b, name in zip(got, want, pt.TreeArrays._fields):
        assert torch.equal(a, b), name
    assert int((~got.is_leaf).sum()) > 10
