"""``loco_tree``'s walk order and launch plan, on the CPU.

The card kernel (``csrc/loco_tree.cu``) walks a row's base path through each
tree once and walks a group again only from the first node on that path
that reads one of its features (with its features read as 0); every other
group takes the base leaf.  Each group's leaf sums add tree by tree in tree order,
in windows of at most 64 groups.  That order is emulated here in numpy f32
on the very node records the wrapper packs (``pack_tree_nodes``) and held
to the twin's walk (``tree_walk_twin`` on ``X * m_g``, what
``loco_topk_twin`` scores) bit for bit: the sums of every group of GBT and
forest classifiers and regressors, and the diffs through each model's own
link; the forest classifier's normalising sum (leaf_b: a node's class shares
summed, then over the trees) is the kernel's own, within 1e-6 of the
twin's.  ``loco_plan`` plans every G from 1 to 2,000.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu_torch import insights_kernels as ik  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402
from transmogrifai_tpu_torch.models.tree_kernels import \
    tree_walk_twin  # noqa: E402

F32 = np.float32
CPU = torch.device("cpu")


@pytest.mark.parametrize("D", [1, 28, 63, 64, 1596])
@pytest.mark.parametrize("forest", [False, True])
def test_loco_tree_plan_holds_every_group_count(D, forest):
    """G = 1 .. 2,000 (any K <= G): a window of min(G, 64) groups, the
    slab of one or two sums a group a row plus the staged rows of X within
    one block's shared memory, X staged at an odd stride >= D where the
    block's rows fit ``TREE_X_SMEM``, one block a ``TREE_ROWS`` rows."""
    R = ik.TREE_ROWS
    assert R in (128, 256)
    for G in range(1, 2001):
        for K in sorted({1, min(G, 20), min(G, 33), G}):
            p = ik.loco_plan("tree", 1_000_000, D, G, K, forest)
            assert p.threads == R
            assert p.group_window == min(G, 64)
            assert p.blocks == -(-1_000_000 // R)
            xs = D | 1 if 4 * R * (D | 1) <= ik.TREE_X_SMEM else 0
            assert p.x_stride == xs and (xs == 0 or xs % 2 == 1)
            assert p.smem_bytes == 4 * ((2 if forest else 1)
                                        * p.group_window * (R + 1) + R * xs)
            assert p.smem_bytes <= ik.SMEM_MAX
    with pytest.raises(ValueError, match="K <= G"):
        ik.loco_plan("tree", 10, D, 3, 4)


def _fit(link, seed=8, N=600, D=12, depth=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(F32)
    X[:, 5] = 0.0                                  # a column of zeros
    y = X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N).astype(F32)
    if not link.endswith("regression"):
        y = (y > 0).astype(F32)
    est = {"gbt": lambda: pt.OpGBTClassifier(max_iter=6, max_depth=depth),
           "forest": lambda: pt.OpRandomForestClassifier(
               num_trees=7, max_depth=depth),
           "gbt_regression": lambda: pt.OpGBTRegressor(max_iter=6,
                                                       max_depth=depth),
           "forest_regression": lambda: pt.OpRandomForestRegressor(
               num_trees=7, max_depth=depth),
           "tree": lambda: pt.OpDecisionTreeClassifier(max_depth=depth)
           }[link]()
    Xt = torch.as_tensor(X)
    return Xt, pt.TreeEnsembleModel(fitted=est.fit_arrays(Xt, y))


def _emulate_sums(X, nodes, G, window=64):
    """The kernel's sums in numpy f32: per row and window of groups, per
    tree in order the base path (records: feature, threshold bits, group,
    leaf_a bits), each window group met on it walked again once from its
    first node there with its features read as 0, every other group the
    base leaf.  Returns (base sums [N] a and b, group sums [N, G] a and
    b)."""
    rec = nodes["records"].numpy()
    lb = None if nodes["leaf_b"] is None else nodes["leaf_b"].numpy()
    Tr, T, steps = nodes["trees"], nodes["T"], nodes["steps"]
    feat, grp = rec[..., 0], rec[..., 2]
    thr = rec[..., 1].view(F32)
    la = rec[..., 3].view(F32)
    N = X.shape[0]
    base = np.zeros((N, 2), F32)
    sums = np.zeros((N, G, 2), F32)
    for n in range(N):
        x = X[n]
        for g0 in range(0, G, window):
            gn = min(window, G - g0)
            acc = np.zeros((gn, 2), F32)
            b0 = np.zeros(2, F32)
            for t in range(Tr):
                def walk(node, s, g):
                    while s < steps and feat[t, node] >= 0:
                        v = F32(0) if grp[t, node] == g else x[feat[t, node]]
                        nxt = 2 * node + 1 + int(v > thr[t, node])
                        if nxt >= T:
                            break
                        node, s = nxt, s + 1
                    return node
                node, s, met = 0, 0, {}
                while s < steps and feat[t, node] >= 0:
                    j = grp[t, node] - g0
                    if 0 <= j < gn and j not in met:
                        met[j] = walk(node, s, grp[t, node])
                    nxt = 2 * node + 1 + int(x[feat[t, node]] > thr[t, node])
                    if nxt >= T:
                        break
                    node, s = nxt, s + 1

                def leaf(at):
                    return np.array([la[t, at], 0 if lb is None
                                     else lb[t, at]], F32)
                b0 = b0 + leaf(node)
                for j in range(gn):
                    acc[j] = acc[j] + leaf(met.get(j, node))
            base[n] = b0
            sums[n, g0:g0 + gn] = acc
    return base, sums


def _twin_sums(X, model, col_group, G):
    """The twin's walk (``tree_walk_twin``, trees in order) of X and of
    each X * m_g: the leaf sums [N, V] of the unmasked rows and [N, G, V]."""
    f = model.fitted
    leaf = f["leaf"] if f["leaf"].ndim == 3 else f["leaf"][..., None]

    def walk(Z):
        return tree_walk_twin(Z, f["feature"], f["threshold"], f["is_leaf"],
                              leaf, int(f["max_depth"]) + 1, 1, "sum")[:, 0]
    cg = torch.as_tensor(col_group)
    return walk(X), torch.stack(
        [walk(X * (cg != g).to(X.dtype)[None, :]) for g in range(G)], dim=1)


@pytest.mark.parametrize("link", ["gbt", "forest", "gbt_regression",
                                  "forest_regression", "tree"])
@pytest.mark.parametrize("grouping", ["column", "pairs", "one", "scattered"])
def test_emulated_walk_order_gives_the_twins_sums(link, grouping):
    """Base walk, re-walk from the first node of the group, tree-order sums:
    on the wrapper's own node records every group's leaf sum equals the
    twin's walk of X * m_g bit for bit (a forest classifier's last class
    share and the base's too), for one group a column, a group a pair of
    columns, one group of every column, and groups scattered over the
    columns; the diffs through the model's own link then equal the twin's
    (the forest classifier's within 1e-6: its normalising sum adds the class
    shares a node first)."""
    X, model = _fit(link)
    N, D = X.shape
    cg = {"column": np.arange(D), "pairs": np.arange(D) // 2,
          "one": np.zeros(D, np.int64),
          "scattered": np.random.default_rng(3).permutation(np.arange(D) % 5)
          }[grouping].astype(np.int32)
    G = int(cg.max()) + 1
    cgt = torch.as_tensor(cg)
    nodes = ik.tree_nodes(model, cgt, CPU)
    assert ik.tree_nodes(model, cgt, CPU) is nodes      # packed once
    Xs = X[:64]
    base, sums = _emulate_sums(Xs.numpy(), nodes, G, window=3)
    tb, ts = _twin_sums(Xs, model, cg, G)
    forest_cls = link in ("forest", "tree")
    v = -1 if forest_cls else 0
    np.testing.assert_array_equal(base[:, 0], tb[:, v].numpy())
    np.testing.assert_array_equal(sums[..., 0], ts[..., v].numpy())
    if forest_cls:
        np.testing.assert_allclose(sums[..., 1], ts.sum(dim=2).numpy(),
                                   rtol=0, atol=1e-5)
    # the diffs through the model's own link against the twin's
    ti, tv = ik.loco_topk_twin(Xs, lambda Z: ik.loco_score(model, Z), cgt,
                               G, G, "abs")
    want = torch.empty_like(tv).scatter_(1, ti.long(), tv).numpy()
    f = model.fitted
    if forest_cls:
        tr = F32(f["feature"].shape[0])
        score = lambda a, b: (a / tr) / np.maximum(b / tr, F32(1e-12))  # noqa
        got = score(base[:, None, 0], base[:, None, 1]) - score(
            sums[..., 0], sums[..., 1])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    margin = lambda s: (F32(f.get("base", 0)) + F32(f.get("eta", 1)) * s  # noqa
                        if f["kind"] == "gbt" else s / F32(
                            f["feature"].shape[0]))
    link_fn = (lambda m: torch.sigmoid(torch.as_tensor(m)).numpy()  # noqa
               if link == "gbt" else m)
    got = link_fn(margin(base[:, None, 0])) - link_fn(margin(sums[..., 0]))
    np.testing.assert_array_equal(got.astype(F32), want)


def test_node_records_decode_to_the_trees():
    """The packed records: feature (-1 at a leaf), the threshold's bits, the
    feature's group (-1 at a leaf), the leaf value's bits (a forest
    classifier's last class share, with leaf_b its class shares' sum)."""
    X, model = _fit("forest")
    D = X.shape[1]
    cg = torch.as_tensor((np.arange(D) * 7) % 4, dtype=torch.int32)
    nodes = ik.tree_nodes(model, cg, CPU)
    rec = nodes["records"]
    f = model.fitted
    leafy = torch.as_tensor(f["is_leaf"])
    feat = torch.as_tensor(f["feature"]).long().clamp(min=0)
    assert torch.equal(rec[..., 0], torch.where(leafy, -1, feat.int()))
    assert torch.equal(rec[..., 1].view(torch.float32),
                       torch.as_tensor(f["threshold"], dtype=torch.float32))
    assert torch.equal(rec[..., 2], torch.where(leafy, -1, cg[feat]))
    assert torch.equal(rec[..., 3].view(torch.float32),
                       torch.as_tensor(f["leaf"])[..., -1])
    assert torch.equal(nodes["leaf_b"], torch.as_tensor(f["leaf"]).sum(dim=2))
    assert nodes["steps"] == int(f["max_depth"]) + 1
