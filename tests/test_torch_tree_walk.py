"""``tree_walk``'s node packing, launch plan and a numpy emulation of its
kernel (``csrc/tree_walk.cu``), held to the plain twin and the JAX package;
and ``lane_bytes`` with the deep histogram's partition.

The kernel runs only on the card; what can go wrong on the host side of it
— the packed nodes, the plan's sizes, which rows a block and thread walk,
which nodes come from shared memory — is emulated here on the wrapper's own
arrays with the kernel's index arithmetic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

SMEM_MAX = 227 * 1024


def _trees(Tr, depth, D, V, seed):
    """Perfect heaps with a leaf above the bottom level, +inf and 1e30
    thresholds (never taken), leaves at -1 features."""
    rng = np.random.default_rng(seed)
    T = 2 ** (depth + 1) - 1
    feature = rng.integers(0, D, size=(Tr, T)).astype(np.int32)
    threshold = rng.normal(scale=0.7, size=(Tr, T)).astype(np.float32)
    is_leaf = np.zeros((Tr, T), bool)
    is_leaf[:, 2 ** depth - 1:] = True
    is_leaf[:, 2] = True
    threshold[:, 3] = np.inf
    threshold[:, 5] = 1e30
    feature[is_leaf] = -1
    leaf = rng.normal(size=(Tr, T, V)).astype(np.float32)
    return feature, threshold, is_leaf, leaf


def test_node_packing_round_trips():
    """A node packs into 8 bytes — the feature (past int16: D can exceed
    32,767) or -1 at a leaf, and the threshold's bits (+-inf, 1e30, -0.0
    and NaN kept) — and unpacks to the same feature, flag and threshold."""
    feature = torch.tensor([[0, 7, 40_000, 1_596, -1, -1, 32_768]],
                           dtype=torch.int32)
    is_leaf = torch.tensor([[False, False, False, False, True, True,
                             False]])
    threshold = torch.tensor([[0.25, float("inf"), float("-inf"), 1e30, -0.0,
                               float("nan"), -1e30]])
    packed = tk.pack_nodes(feature, threshold, is_leaf)
    assert packed.dtype == torch.int32 and packed.shape == (1, 7, 2)
    f, thr, lf = tk.unpack_nodes(packed)
    assert torch.equal(f, feature) and torch.equal(lf, is_leaf)
    assert torch.equal(thr.view(torch.int32), threshold.view(torch.int32))
    # a split whose feature is negative reads feature 0, as the twin does
    f, _, lf = tk.unpack_nodes(tk.pack_nodes(
        torch.tensor([-3]), torch.tensor([0.5]), torch.tensor([False])))
    assert f.tolist() == [0] and lf.tolist() == [False]


def emulate_tree_walk(X, feature, threshold, is_leaf, leaf, steps, members,
                      op, plan):
    """The kernel of ``csrc/tree_walk.cu`` in numpy: the nodes packed once,
    blocks of ``threads`` rows a member (thread t of block b walks row
    b·threads + t), each tree's first ``sl`` steps (all
    of them where every node is staged) read from the block's staged copy
    of its top ``top`` nodes and deeper ones from the packed array, X
    from the staged rows (or gathered), a leaf or a child past the heap
    stopping a walk, and the leaf values summed in f32 in tree order, once
    per chunk of 4 values.  Every output is written once."""
    N, D = X.shape
    Tr, T = feature.shape
    V = leaf.shape[2]
    Tm = Tr // members
    packed = tk.pack_nodes(torch.as_tensor(feature),
                           torch.as_tensor(threshold),
                           torch.as_tensor(is_leaf)).numpy()
    rows, top, sl = (plan[k] for k in ("threads", "top", "sl"))
    s_st = steps if top == T else min(sl, steps)
    assert top == T or top >= (1 << sl) - 1
    out = np.full((N, members, V), np.nan, np.float32)
    written = np.zeros((N, members), np.int64)
    for m in range(members):
        gm = packed[m * Tm:(m + 1) * Tm]
        staged = gm[:, :top].copy()
        for b in range(-(-N // rows)):
            n0 = b * rows
            lr = np.arange(min(rows, N - n0))
            xs = X[n0 + lr]                        # the block's rows of X
            written[n0 + lr, m] += 1
            for v0 in range(0, V, 4):
                vn = min(4, V - v0)
                acc = np.zeros((len(lr), vn), np.float32)
                for t in range(Tm):
                    node = np.zeros(len(lr), np.int64)
                    go = np.ones(len(lr), bool)
                    for s in range(steps):
                        if s < s_st:        # the staged levels' steps
                            assert (node < top).all()
                            nd = staged[t][node]
                        else:
                            nd = gm[t][node]
                        go &= nd[:, 0] >= 0
                        x = xs[np.arange(len(lr)), np.maximum(nd[:, 0], 0)]
                        nxt = 2 * node + 1 + (x > nd[:, 1].view(np.float32))
                        go &= nxt < T
                        node = np.where(go, nxt, node)
                        if not go.any():
                            break
                    acc += leaf[m * Tm + t, node, v0:v0 + vn]
                res = acc / np.float32(Tm) if op == "mean" else acc
                out[n0 + lr, m, v0:v0 + vn] = res
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("N,D,Tr,members,depth,V,op", [
    (1000, 28, 20, 1, 3, 1, "sum"),          # GBT 20 x d3
    (1000, 28, 20, 1, 6, 2, "mean"),         # RF 20 x d6
    (300, 28, 50, 1, 12, 2, "mean"),         # RF member 50 x d12
    (600, 28, 6, 6, 12, 1, "sum"),           # GBT margins, 6 lanes
    (700, 16, 8, 2, 4, 6, "mean"),           # V = 6: two leaf chunks
    (500, 16, 4, 1, 3, 40, "sum"),           # V = 40 classes
    (400, 1597, 6, 2, 5, 2, "sum"),          # wide X: gathered
])
def test_kernel_emulation_matches_twin(N, D, Tr, members, depth, V, op):
    """The emulated walk equals ``tree_walk_twin`` (which sums in the same
    tree order) bit for bit, with the plan of the shape."""
    feature, threshold, is_leaf, leaf = _trees(Tr, depth, D, V, N + Tr)
    X = np.random.default_rng(depth).normal(size=(N, D)).astype(np.float32)
    plan = tk.walk_plan(N, D, Tr // members, feature.shape[1], V, members)
    got = emulate_tree_walk(X, feature, threshold, is_leaf, leaf, depth + 1,
                            members, op, plan)
    want = tk.tree_walk_twin(*(torch.as_tensor(a) for a in (
        X, feature, threshold, is_leaf, leaf)), depth + 1, members, op)
    np.testing.assert_array_equal(got, want.numpy())


def test_emulation_with_tops_and_rows_that_force_every_path(monkeypatch):
    """Small blocks (32 threads) and a small staging budget: trees
    staged by their top levels only, and not at all; X staged and
    gathered; a ragged last block."""
    feature, threshold, is_leaf, leaf = _trees(12, 7, 10, 3, 5)
    X = np.random.default_rng(1).normal(size=(333, 10)).astype(np.float32)
    twin = tk.tree_walk_twin(*(torch.as_tensor(a) for a in (
        X, feature, threshold, is_leaf, leaf)), 8, 2, "mean").numpy()
    monkeypatch.setattr(tk, "WALK_THREADS", 32)
    tops = set()
    for smem, xs in ((6000, 1 << 20), (40, 0), (8 * 6 * 255 + 5000, 0)):
        monkeypatch.setattr(tk, "WALK_SMEM", smem)
        monkeypatch.setattr(tk, "WALK_X_SMEM", xs)
        plan = tk.walk_plan(333, 10, 6, feature.shape[1], 3, 2)
        tops.add(plan["top"])
        got = emulate_tree_walk(X, feature, threshold, is_leaf, leaf, 8, 2,
                                "mean", plan)
        np.testing.assert_array_equal(got, twin)
    assert 0 in tops and any(0 < t < feature.shape[1] for t in tops)


def test_twin_matches_jax_at_depth_12():
    """``tree_walk_twin`` (the emulation's yardstick) stays within rtol 1e-6
    of the JAX package's ``_predict_trees_block`` at depth 12: the reached
    leaves exactly, their sum and mean over a member's trees within 1e-6
    (XLA adds in its own order)."""
    feature, threshold, is_leaf, leaf = _trees(4, 12, 9, 1, 12)
    X = np.random.default_rng(12).normal(size=(150, 9)).astype(np.float32)
    targs = [torch.as_tensor(a) for a in (feature, threshold, is_leaf, leaf)]
    jargs = [jnp.asarray(a) for a in (feature, threshold, is_leaf, leaf)]
    Xt, Xj = torch.as_tensor(X), jnp.asarray(X)
    np.testing.assert_array_equal(
        pt.predict_trees_raw(Xt, *targs, 13).numpy(),
        np.asarray(jt.predict_trees_raw(Xj, *jargs, 13)))
    for op in ("sum", "mean"):
        np.testing.assert_allclose(
            pt.predict_trees_agg(Xt, *targs, 13, op=op).numpy(),
            np.asarray(jt.predict_trees_agg(Xj, *jargs, 13, op=op)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("V", [2, 6, 40])
@pytest.mark.parametrize("D", [28, 1597])
def test_walk_plan_at_the_main_path_shapes(D, V):
    """GBT 20 x d3, RF 20 x d6, an RF member 50 x d12 and a GBT margin
    update (12 lanes of one d12 tree): a block fits its shared memory
    (several a SM); X is staged where its rows fit (D = 28) and gathered at
    1,597 features; every tree is staged by at most its top ``WALK_TOP``
    nodes (a smaller block keeps more of them on an SM, which hides the
    deep levels' latency better)."""
    for Tm, depth, M in ((20, 3, 1), (20, 6, 1), (50, 12, 1), (1, 12, 12)):
        T = 2 ** (depth + 1) - 1
        plan = tk.walk_plan(1_000_000, D, Tm, T, V, M)
        assert plan["smem"] <= tk.WALK_SMEM <= SMEM_MAX
        assert plan["smem"] == 8 * Tm * plan["top"] + (
            4 * plan["threads"] * plan["Dp"] if plan["x_smem"] else 0)
        assert plan["x_smem"] == (D == 28)
        assert plan["Dp"] >= D and plan["Dp"] % 2 == 1
        assert plan["threads"] <= 256
        assert plan["blocks"] == -(-1_000_000 // plan["threads"]) * M
        assert plan["top"] == min(T, tk.WALK_TOP) == (1 << plan["sl"]) - 1 \
            or plan["top"] == T
        assert plan["smem"] <= 64 * 1024


def test_lane_bytes_counts_the_deep_partition():
    """On the card a lane whose deepest level takes ``tree_hist_deep``
    books its partition (a (6 + 4·S)-byte record a row and the group runs)
    beside its rows and histogram, and a lane of fixed-point statistics
    (any but integer counts) the histogram's 64-bit sums too, its deep
    route starting a level earlier (8-byte cells); shallow trees and the
    CPU book no partition."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    N, D, S, NB = 1_000_000, 28, 3, 32
    rows = 4 * N * (2 * S + 4)
    for depth in (3, 6, 8):
        assert pt.lane_bytes(N, D, S, NB, depth, cuda, fixed_point=False) \
            == rows + 4 * (1 << (depth - 1)) * D * NB * S
    for depth in (3, 6, 7):
        assert pt.lane_bytes(N, D, S, NB, depth, cuda) == \
            rows + 3 * 4 * (1 << (depth - 1)) * D * NB * S
    assert tk.hist_plan(N, D, 1, 64, NB, S, cell_bytes=8)["route"] == \
        "shared"
    assert tk.hist_plan(N, D, 1, 128, NB, S, cell_bytes=8)["route"] == "deep"
    assert tk.hist_plan(N, D, 1, 128, NB, S)["route"] == "shared"
    plan = tk.hist_plan(N, D, 1, 2048, NB, S)
    assert plan["route"] == "deep"
    part = (6 + 4 * S) * N + 8 * plan["NG"] * plan["nseg"]
    assert tk.deep_partition_bytes(N, D, 2048, NB, S) == part
    assert pt.lane_bytes(N, D, S, NB, 12, cuda, fixed_point=False) == \
        rows + 4 * 2048 * D * NB * S + part
    plan8 = tk.hist_plan(N, D, 1, 2048, NB, S, cell_bytes=8)
    part8 = (6 + 4 * S) * N + 8 * plan8["NG"] * plan8["nseg"]
    assert tk.deep_partition_bytes(N, D, 2048, NB, S, 8) == part8
    assert pt.lane_bytes(N, D, S, NB, 12, cuda) == \
        rows + 3 * 4 * 2048 * D * NB * S + part8
    assert pt.lane_bytes(N, D, S, NB, 12, cpu) == \
        rows + 3 * 4 * 2048 * D * NB * S + N * D * (8 + 4 * S)
    # the card's budget still batches the default grid's depth-12
    # classification forests (300 lanes a fold) in two batches
    per = pt.lane_bytes(N, D, S, NB, 12, cuda, fixed_point=False)
    assert [s.stop - s.start for s in pt.lane_batches(300, per, cuda)] == \
        [150, 150]
