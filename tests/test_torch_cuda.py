"""The port's CUDA kernels against their plain-PyTorch twins on the card.

Marked ``cuda``: every test skips (from its fixture) where
``torch.cuda.is_available()`` is False.  Run them on a machine with an
NVIDIA card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest`` because ``tests/conftest.py`` sets up JAX, which the port's
machines need not have).
Tolerances: routing exact; the walk exact per (row, tree) and 1e-6 on sums;
histograms within 1e-5 of each cell's absolute mass of the twin run in f64
(f32 atomics reorder the sums; a serial f32 sum drifts further at 10^5 rows);
split gains within 1e-5 of |gain| + the parent score G²/(H+λ) they are a
difference of, choices identical where the runner-up gap is clear; gini
gains within 1e-6 of wgini(parent) (the kernel rounds as the twin does, so
they agree bit for bit on these integer counts), choices identical where
the gap passes 1e-5 of it and on exact ties; a forest fitted on the card
with the draws made on the host equals the CPU twins' forest in structure,
leaves at rtol 1e-6; ``fista_step`` within 1e-5 of each output's absolute
mass of the twin run in f64 (tile and block sums in another order than
cuBLAS), and the same bits on two launches; the one-pass deep histogram
like ``tree_hist``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def level(cuda):
    from transmogrifai_tpu_torch.models.trees import binned
    rng = np.random.default_rng(0)
    N, D, K = 50_000, 28, 3
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32), device=cuda)
    _, splits, B = binned(X, X, 32)
    stats = torch.as_tensor(rng.normal(size=(K, N, 3)).astype(np.float32),
                            device=cuda)
    stats[..., 0] = 1.0
    stats[..., 2] = stats[..., 2].abs()
    row_node = torch.as_tensor(rng.integers(1, 7, size=(K, N)).astype(np.int32),
                               device=cuda)
    return X, B, splits, stats, row_node


def test_tree_hist_matches_twin(level):
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    _, B, _, stats, row_node = level
    for off, P, with_hist in ((3, 4, True), (0, 1, True), (7, 8, False)):
        h, t = tk.tree_hist(B, row_node, stats, off, P, 32, with_hist)
        s64 = stats.double()
        ht, tt = tk.tree_hist_twin(B, row_node, s64, off, P, 32, with_hist)
        mass, mass_t = tk.tree_hist_twin(B, row_node, s64.abs(), off, P, 32,
                                         with_hist)
        assert bool(((t.double() - tt).abs() <= 1e-5 + 1e-5 * mass_t).all())
        if with_hist:
            assert bool(((h.double() - ht).abs() <= 1e-5 + 1e-5 * mass).all())


def test_tree_split_route_and_walk_match_twins(level):
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    X, B, splits, stats, row_node = level
    K, D = row_node.shape[0], B.shape[1]
    hist, tot = tk.tree_hist(B, row_node, stats, 3, 4, 32)
    lane = lambda v: torch.full((K,), v, device=X.device)
    args = (hist, tot, torch.ones(D, dtype=torch.bool, device=X.device),
            splits, lane(10.0), lane(0.0), lane(1.0))
    sk, st = tk.tree_split(*args), tk.tree_split_twin(*args)
    fin = torch.isfinite(st["gain"])
    assert torch.equal(fin, torch.isfinite(sk["gain"]))
    scale = st["gain"].abs() + tot[..., 1] ** 2 / (tot[..., 2] + 1.0)
    assert bool(((sk["gain"] - st["gain"]).abs()[fin]
                 <= 1e-5 * scale[fin] + 1e-6).all())
    gap = tk.split_gap(hist, tot, args[2], args[4], args[6])
    clear = gap > 1e-4 * st["gain"].abs()
    assert torch.equal(sk["feature"][clear], st["feature"][clear])
    assert torch.equal(sk["bin"][clear], st["bin"][clear])
    assert torch.equal(tk.tree_route(B, row_node, st["feature"], st["bin"],
                                     st["is_leaf"], 3),
                       tk.tree_route_twin(B, row_node, st["feature"],
                                          st["bin"], st["is_leaf"], 3))
    rng = np.random.default_rng(1)
    T = 15
    feat = torch.as_tensor(rng.integers(0, D, (6, T)).astype(np.int32),
                           device=X.device)
    thr = torch.as_tensor(rng.normal(size=(6, T)).astype(np.float32),
                          device=X.device)
    leafm = torch.zeros((6, T), dtype=torch.bool, device=X.device)
    leafm[:, 7:] = True
    leafm[:, 2] = True
    thr[:, 4] = float("inf")
    vals = torch.as_tensor(rng.normal(size=(6, T, 1)).astype(np.float32),
                           device=X.device)
    for members, op in ((6, "sum"), (2, "sum"), (1, "mean")):
        torch.testing.assert_close(
            tk.tree_walk(X, feat, thr, leafm, vals, 4, members, op),
            tk.tree_walk_twin(X, feat, thr, leafm, vals, 4, members, op),
            rtol=1e-6, atol=1e-7)


def test_tree_walk_reads_large_members_from_device_memory(cuda):
    """A member whose trees pass the 227 KB a block can stage (300 trees of
    depth 5: 18,900 nodes) walks them from device memory."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(3)
    Tr, T, D = 600, 63, 28
    X = torch.as_tensor(rng.normal(size=(20_000, D)).astype(np.float32),
                        device=cuda)
    feat = torch.as_tensor(rng.integers(0, D, (Tr, T)).astype(np.int32),
                           device=cuda)
    thr = torch.as_tensor(rng.normal(size=(Tr, T)).astype(np.float32),
                          device=cuda)
    leafm = torch.zeros((Tr, T), dtype=torch.bool, device=cuda)
    leafm[:, 31:] = True
    leafm[:, 2] = True
    thr[:, 4] = float("inf")
    vals = torch.as_tensor(rng.normal(size=(Tr, T, 1)).astype(np.float32),
                           device=cuda)
    for members in (2, 1):
        torch.testing.assert_close(
            tk.tree_walk(X, feat, thr, leafm, vals, 6, members),
            tk.tree_walk_twin(X, feat, thr, leafm, vals, 6, members),
            rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def forest_level(cuda):
    """A depth-3 level (offset 3, P = 4) of 6 forest lanes: gini statistics
    with Poisson(1) x held-out-third weights (many zero-weight rows), per-node
    subsets of 5 features, and column 1 a copy of column 0 (exact ties)."""
    from transmogrifai_tpu_torch.models.trees import binned
    rng = np.random.default_rng(5)
    N, D, K, P = 50_000, 28, 6, 4
    Xn = rng.normal(size=(N, D)).astype(np.float32)
    Xn[:, 1] = Xn[:, 0]
    y = ((Xn[:, 0] + 0.5 * Xn[:, 2] * Xn[:, 3] + rng.normal(size=N)) > 0
         ).astype(np.float32)
    X = torch.as_tensor(Xn, device=cuda)
    _, splits, B = binned(X, X, 32)
    w = rng.poisson(1.0, size=(K, N)) * (rng.random((K, N)) > 0.33)
    base = np.stack([np.ones(N), 1 - y, y], axis=1)
    stats = torch.as_tensor((base[None] * w[:, :, None]).astype(np.float32),
                            device=cuda)
    row_node = torch.as_tensor(rng.integers(1, 7, size=(K, N)).astype(
        np.int32), device=cuda)
    mask = np.zeros((K, P, D), bool)
    for k in range(K):
        for p in range(P):
            mask[k, p, rng.choice(D, 5, replace=False)] = True
    mask[:, 0, :2] = True                        # the tie pair in every lane
    return X, B, splits, stats, row_node, torch.as_tensor(mask, device=cuda)


def test_tree_hist_gini_stats_with_zero_weight_rows(forest_level):
    """Integer gini counts with many zero-weight rows are exact in f32: the
    kernel equals the f64 twin cell for cell, and at the P = 4 level also
    with the nodes' feature subsets (the masked shared-memory form)."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    _, B, _, stats, row_node, mask = forest_level
    assert float((stats[..., 0] == 0).float().mean()) > 0.5
    kernels.reset_launch_counts()
    for off, P, with_hist, nm in ((3, 4, True, None), (3, 4, True, mask),
                                  (0, 1, True, None), (7, 8, False, None)):
        got = tk.tree_hist(B, row_node, stats, off, P, 32, with_hist,
                           node_mask=nm)
        want = tk.tree_hist_twin(B, row_node, stats.double(), off, P, 32,
                                 with_hist, node_mask=nm)
        for g, w in zip(got, want):
            if w is not None:       # integer counts: exact in f32
                assert torch.equal(g.double(), w)
    assert kernels.launch_counts()["tree_hist"] == 4
    assert kernels.launch_counts()["tree_hist_deep"] == 0


def test_tree_split_gini_matches_twin_with_node_masks_and_ties(forest_level):
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    _, B, splits, stats, row_node, mask = forest_level
    K, D = row_node.shape[0], B.shape[1]
    hist, tot = tk.tree_hist(B, row_node, stats, 3, 4, 32)
    lane = lambda v: torch.full((K,), v, device=B.device)
    fmask = torch.ones(D, dtype=torch.bool, device=B.device)
    for m in (mask, None):
        args = (hist, tot, fmask, m, splits, lane(10.0), lane(0.0))
        sk, st = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
        scale = tk.wgini(tot)
        fin = torch.isfinite(st["gain"])
        assert torch.equal(fin, torch.isfinite(sk["gain"]))
        assert bool(((sk["gain"] - st["gain"]).abs()[fin]
                     <= 1e-6 * scale[fin]).all())
        clear = tk.split_gap_gini(hist, tot, fmask, m, args[5]) > 1e-5 * scale
        for key in ("feature", "bin", "is_leaf", "threshold"):
            assert torch.equal(sk[key][clear], st[key][clear])
    # node 0 holds both tie columns: if either wins, the lower one does
    sk = tk.tree_split_gini(hist, tot, fmask, mask, splits, lane(10.0),
                            lane(0.0))
    assert not bool((sk["feature"][:, 0] == 1).any())


def test_tree_walk_two_class_mean(level):
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    X = level[0]
    rng = np.random.default_rng(4)
    Tr, T, D = 20, 127, X.shape[1]
    feat = torch.as_tensor(rng.integers(0, D, (Tr, T)).astype(np.int32),
                           device=X.device)
    thr = torch.as_tensor(rng.normal(size=(Tr, T)).astype(np.float32),
                          device=X.device)
    leafm = torch.zeros((Tr, T), dtype=torch.bool, device=X.device)
    leafm[:, 63:] = True
    leafm[:, 2] = True
    p = rng.random((Tr, T, 1)).astype(np.float32)
    vals = torch.as_tensor(np.concatenate([1 - p, p], axis=2), device=X.device)
    for members, op in ((1, "mean"), (4, "sum")):
        torch.testing.assert_close(
            tk.tree_walk(X, feat, thr, leafm, vals, 7, members, op),
            tk.tree_walk_twin(X, feat, thr, leafm, vals, 7, members, op),
            rtol=1e-6, atol=1e-7)


def test_forest_fit_on_the_card_matches_cpu_twins_with_host_draws(cuda):
    """With the draws made by one CPU generator, the 3-fold x 10-tree forest
    block fitted on the card equals the one fitted by the CPU twins: the
    gini counts are integers, exact in f32 in any order."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    rng = np.random.default_rng(6)
    N, D = 20_000, 12
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = ((X[:, 0] - X[:, 1] * X[:, 2] + rng.normal(size=N)) > 0).astype(
        np.float32)
    W = (rng.random((3, N)) > 1 / 3).astype(np.float32)
    est = OpRandomForestClassifier(num_trees=10, max_depth=5,
                                   min_instances_per_node=10,
                                   draw_device="cpu")
    kernels.reset_launch_counts()
    gpu = est.fit_arrays_grid(torch.as_tensor(X, device=cuda), y, W, [{}])
    assert kernels.launch_counts()["tree_split_gini"] == 5
    cpu = est.fit_arrays_grid(torch.as_tensor(X), y, W, [{}])
    for k in range(3):
        for key in ("feature", "threshold", "is_leaf"):
            assert torch.equal(gpu[k][0][key].cpu(), cpu[k][0][key])
        torch.testing.assert_close(gpu[k][0]["leaf"].cpu(), cpu[k][0]["leaf"],
                                   rtol=1e-6, atol=1e-7)


def _small_main_path(device, n):
    """LR x4 + RF (10 trees, depth 4, host draws) + GBT (5 rounds, depth
    3) with 3-fold CV on ``n`` rows."""
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import (OpGBTClassifier,
                                                      OpRandomForestClassifier)
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, ModelCandidate, grid)
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.normal(size=n)) > 0
         ).astype(np.float32)
    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(8)]
    sel = BinaryClassificationModelSelector(models=[
        ModelCandidate(OpLogisticRegression(),
                       grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                            elastic_net_param=[0.1], max_iter=[50]),
                       "OpLogisticRegression"),
        ModelCandidate(OpRandomForestClassifier(draw_device="cpu"),
                       grid(num_trees=[10], max_depth=[4],
                            min_instances_per_node=[10]),
                       "OpRandomForestClassifier"),
        ModelCandidate(OpGBTClassifier(),
                       grid(max_iter=[5], max_depth=[3],
                            min_instances_per_node=[10]), "OpGBTClassifier")])
    sel.set_input(label, label.sanity_check(transmogrify(feats),
                                            remove_bad_features=True))
    cols = {"label": Column(RealNN, y)}
    cols.update({f"f{i}": Column(RealNN, X[:, i]) for i in range(8)})
    model = (Workflow(device=device).set_input_batch(ColumnBatch(cols, n))
             .set_result_features(sel.get_output()).train())
    summ = model.selected_model.summary
    return summ.best_model_name, [r.metric_values["AuPR"]
                                  for r in summ.validation_results]


def test_small_main_path_on_the_card_matches_the_twins(cuda):
    from transmogrifai_tpu_torch.models import kernels
    kernels.reset_launch_counts()
    gpu = _small_main_path("cuda", 5000)
    # depth-4 and depth-3 trees never need the one-pass deep histogram
    assert all(v > 0 for k, v in kernels.launch_counts().items()
               if k != "tree_hist_deep")
    cpu = _small_main_path("cpu", 5000)
    assert gpu[0] == cpu[0]
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=0, atol=1e-3)


@pytest.mark.parametrize("loss,G,D", [("logistic", 8, 28),
                                      ("squared_hinge", 4, 28),
                                      ("gram", 1, 28),
                                      # too wide for one tile of 24 lanes:
                                      # the wrapper launches lane chunks
                                      ("logistic", 8, 1200)])
def test_fista_step_matches_twin_and_repeats_bit_for_bit(cuda, loss, G, D):
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    rng = np.random.default_rng(2)
    N, F = 70_001, 3
    L = F * G
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=cuda)
    W = torch.as_tensor((rng.random((F, N)) > 1 / 3).astype(np.float32),
                        device=cuda)
    y = torch.as_tensor((rng.random(N) > 0.5).astype(np.float32), device=cuda)
    V = torch.as_tensor(rng.normal(scale=0.3, size=(L, D)).astype(np.float32),
                        device=cuda)
    muv = torch.as_tensor(rng.normal(size=L).astype(np.float32), device=cuda)
    b = torch.as_tensor(rng.normal(size=L).astype(np.float32), device=cuda)
    tgt = None if loss == "gram" else (2 * y - 1 if loss == "squared_hinge"
                                       else y)
    ws = W.sum(dim=1)[torch.arange(L, device=cuda) // G]
    args = (X, V, muv, b, W, tgt, ws, G, loss)
    gx, gs = lk.fista_step(*args)
    gx2, gs2 = lk.fista_step(*args)
    assert torch.equal(gx, gx2) and torch.equal(gs, gs2)
    a64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
    g64 = lk.fista_row_grads(*a64)
    X64 = X.double()
    assert bool(((gx.double() - g64 @ X64).abs()
                 <= 1e-5 * (g64.abs() @ X64.abs()) + 1e-12).all())
    assert bool(((gs.double() - g64.sum(dim=1)).abs()
                 <= 1e-5 * g64.abs().sum(dim=1) + 1e-12).all())


@pytest.mark.parametrize("masked", [False, True])
def test_tree_hist_deep_level_matches_twin(cuda, masked):
    """A level of 512 nodes (past one block's shared memory) runs the
    one-pass kernel: held to the f64 twin, with and without node subsets,
    totals counting every row whatever the mask."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import binned
    rng = np.random.default_rng(4)
    N, D, K, P, off = 60_000, 28, 4, 512, 511
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32), device=cuda)
    _, _, B = binned(X, X, 32)
    stats = torch.as_tensor(rng.normal(size=(K, N, 3)).astype(np.float32),
                            device=cuda)
    stats[..., 0] = torch.as_tensor(rng.poisson(1.0, size=(K, N)).astype(
        np.float32), device=cuda)
    row_node = torch.as_tensor(rng.integers(off - 40, off + P, size=(K, N))
                               .astype(np.int32), device=cuda)
    mask = (torch.as_tensor(rng.random((K, P, D)) > 0.6, device=cuda)
            if masked else None)
    kernels.reset_launch_counts()
    h, t = tk.tree_hist(B, row_node, stats, off, P, 32, node_mask=mask)
    assert kernels.launch_counts()["tree_hist_deep"] == 1
    s64 = stats.double()
    ht, tt = tk.tree_hist_twin(B, row_node, s64, off, P, 32, node_mask=mask)
    mass, mt = tk.tree_hist_twin(B, row_node, s64.abs(), off, P, 32,
                                 node_mask=mask)
    assert bool(((t.double() - tt).abs() <= 1e-5 + 1e-5 * mt).all())
    assert bool(((h.double() - ht).abs() <= 1e-5 + 1e-5 * mass).all())
    if masked:
        assert bool((h[~mask] == 0).all())
