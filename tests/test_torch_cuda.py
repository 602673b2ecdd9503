"""The port's CUDA kernels against their plain-PyTorch twins on the card.

Marked ``cuda``: every test skips (from its fixture) where
``torch.cuda.is_available()`` is False.  Run them on a machine with an
NVIDIA card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest`` because ``tests/conftest.py`` sets up JAX, which the port's
machines need not have).
Tolerances: routing exact (in place, on copies of the ids); the walk exact
per (row, tree) and 1e-6 on sums; histograms within 1e-5 of each cell's
absolute mass of the twin run in f64
(float statistics sum in fixed point, the values rounded to v·2^e; a
serial f32 sum drifts further at 10^5 rows);
the xgb split bit-equal to its twin (the same bin-prefix order and f32
expression), and against the twin run in f64 its gains within 1e-5 of
|gain| + the parent score G²/(H+λ) they are a difference of, choices
identical where the runner-up gap is clear; its epilogue's tree arrays
equal to the twin's bookkeeping run on the CPU; the gini split
bit-equal to its twin likewise (fractional weights, 2 to 40 classes), its
epilogue's tree arrays (the class shares too) equal to the twin's
bookkeeping; a forest fitted on the card
with the draws made on the host equals the CPU twins' forest in structure,
leaves at rtol 1e-6; ``fista_step`` within 1e-5 of each output's absolute
mass of the twin run in f64 (split-TF32 products on tensor cores, tile and
block sums in another order than cuBLAS), and the same bits on two
launches (the squared loss too); variance
split gains within 1e-5 of the parent's Σw·y² (+1e-6: the terms they are a
difference of) of the twin run on the f64 histogram, choices identical
where the f64 runner-up gap passes twice that, cross-chunk exact ties to
the first feature; LOCO on regression models (the prediction: identity
links) like the classifiers'; the one-pass deep histogram
like ``tree_hist``; ``hash_counts`` equal to its twin (integer counts);
``sp_matmat`` / ``sp_rmatmat`` within 1e-5 of each output's absolute mass
of the twin run in f64 (team lanes and piece partials added in another
order), the same bits on two launches, and the bits of the numpy emulation
of their order (``segsum_emulate``) under every team size, with the dense
operand or the entry stream unaligned; the sparse-text workflow on the card against
the CPU twins like the transmog one; ``fista_softmax`` like
``fista_step`` (within 1e-5 of each output's absolute mass of the f64 twin,
the same bits twice); ``multiclass_confusion`` equal to its twin on 0/1
masks and within 1e-6 of the f64 sums on other weights, the same bits
twice; the multiclass selector on the card like the CPU twins;
``fista_glm`` (poisson, gamma; gradient and value forms) within 1e-5 of
each output's absolute mass of the f64 twin and the same bits twice, and a
GLM grid fit on the card repeating its coefficients, ``n_iter`` and step
halvings exactly and within 1e-3 of the CPU twins' coefficients;
``loco_linear``'s GLM links and ``loco_softmax`` (multinomial LR up to 40
classes, naive Bayes, MLPs with one and two hidden layers, scattered and
contiguous groups, k past 32, a layer of 2,048 units with its slots in
device memory) like the other LOCO kernels, and ``loco_tree`` also past one
window of 64 groups and at k past 32; the variance split (the gini body)
bit-equal to its f32 twin and its epilogue's tree arrays (the mean label)
equal to the twin's bookkeeping; ``hash_counts`` past 58,112 hashes (column
windows) equal to its twin; a dense GBT, a transmog and a sparse-text model
saved on the card and loaded on the card score a fresh batch with the
in-memory model's bits (through ``ScoreProgram`` and ``apply_dag``, the
kernels launched), and loaded on the CPU with predictions equal and scores
within 1e-6.
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
    for key in st:                   # the twin's bits
        assert torch.equal(sk[key], st[key]), key
    # the route moves ids in place: it gets a copy of the fixture's ids
    assert torch.equal(tk.tree_route(B, row_node.clone(), st["feature"],
                                     st["bin"], st["is_leaf"], 3),
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
        for key in st:                  # the twin's bits
            assert torch.equal(sk[key], st[key]), key
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
    # depth-4 and depth-3 trees never need the one-pass deep histogram;
    # the dense binary path hashes no text, holds no sparse matrix, fits no
    # regression tree, multinomial model or GLM, explains nothing and is
    # narrow enough for the tensor-core FISTA launch
    assert all(v > 0 for k, v in kernels.launch_counts().items()
               if k not in ("tree_hist_deep", "hash_counts", "sp_matmat",
                            "sp_rmatmat", "loco_linear", "loco_tree",
                            "tree_split_variance", "fista_softmax",
                            "multiclass_confusion", "fista_glm",
                            "loco_softmax", "fista_wide"))
    cpu = _small_main_path("cpu", 5000)
    assert gpu[0] == cpu[0]
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=0, atol=1e-3)


@pytest.mark.parametrize("loss,G,D,F", [("logistic", 8, 28, 3),
                                        ("squared_hinge", 4, 28, 3),
                                        ("gram", 1, 28, 3),
                                        # too wide for one tile of 24 lanes:
                                        # the wide two-pass form
                                        ("logistic", 8, 1200, 3),
                                        # the transmogrified width: 24 CV
                                        # lanes, the refit's one lane, the
                                        # power iteration, and 48 lanes in
                                        # two launches of the wide form
                                        ("logistic", 8, 1597, 3),
                                        ("logistic", 1, 1597, 1),
                                        ("gram", 1, 1597, 3),
                                        ("squared_hinge", 16, 1597, 3),
                                        # linear regression: the CV block
                                        # and the wide form
                                        ("squared", 8, 16, 3),
                                        ("squared", 8, 1597, 3),
                                        # one lane on a narrow X; 72 lanes,
                                        # past one launch's 64, narrow and
                                        # at the transmogrified width; the
                                        # fold-0 screen there; the widest X
                                        ("logistic", 1, 28, 1),
                                        ("logistic", 24, 28, 3),
                                        ("logistic", 24, 1596, 3),
                                        ("logistic", 8, 1596, 1),
                                        ("logistic", 2, 16384, 3)])
def test_fista_step_matches_twin_and_repeats_bit_for_bit(cuda, loss, G, D, F):
    """Within 1e-5 of each output's absolute mass of the twin run in f64,
    the same bits on two launches, one launch per ``lanes`` of the plan.
    N = 70,001 is no multiple of any plan's row tile."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    rng = np.random.default_rng(2)
    N = 70_001
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
    kernels.reset_launch_counts()
    gx, gs = lk.fista_step(*args)
    assert kernels.launch_counts()["fista_step"] == len(list(lk.tc_chunks(
        V, muv, b, ws, G, lk.launch_plan(D, L))))
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


def _hash_stream(rng, n, H, p_null=0.2, max_tok=12):
    """Per-row token counts (0 on null rows) and bucket ids < H."""
    null = rng.random(n) < p_null
    lens = np.where(null, 0, rng.integers(0, max_tok, size=n)).astype(np.int64)
    flat = rng.integers(0, H, size=int(lens.sum())).astype(np.int32)
    return null, lens, flat


@pytest.mark.parametrize("H,packed", [(512, True), (1023, True),
                                      (2048, False)])
def test_hash_counts_matches_twin_with_offset_and_sentinels(cuda, H, packed):
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.ops.text import pack_ids3
    from transmogrifai_tpu_torch.ops.text_kernels import (hash_counts,
                                                          hash_counts_twin)
    rng = np.random.default_rng(7)
    n = 100_003
    null, lens, flat = _hash_stream(rng, n, H)
    flat[::97] = H          # sentinel ids inside rows are dropped too
    if packed:
        # the packed wire padded past the last row with sentinel words, as
        # the JAX package pads it to a size class
        w = pack_ids3(flat, H)
        ids = np.concatenate([w, np.full(5, H | (H << 10) | (H << 20),
                                         np.int32)])
    else:
        ids = np.concatenate([flat, np.full(7, H, np.int32)])
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ids_d = torch.as_tensor(ids, device=cuda)
    off_d = torch.as_tensor(off, device=cuda)
    null_d = torch.as_tensor(null, device=cuda)
    # written at column 5 of a wider matrix whose other columns must stay
    out = torch.full((n, H + 9), -1.0, device=cuda)
    kernels.reset_launch_counts()
    hash_counts(ids_d, off_d, null_d, H, out=out, col0=5, packed=packed)
    assert kernels.launch_counts()["hash_counts"] == 1
    want = torch.full((n, H + 9), -1.0)
    hash_counts_twin(torch.as_tensor(ids), torch.as_tensor(off),
                     torch.as_tensor(null), H, want, 5, packed)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    assert float(want[:, 5:5 + H].sum()) == float((flat < H).sum())
    # no null column: the block alone
    alone = hash_counts(ids_d, off_d, None, H, packed=packed)
    assert torch.equal(alone.cpu(), want[:, 5:5 + H])


@pytest.mark.parametrize("H", [60_000, 100_003])
def test_hash_counts_past_one_tile_match_twin(cuda, H):
    """Past one row's shared-memory tile (58,112 hashes) the column windows
    give the twin's counts exactly, at a column offset, with and without
    the null column."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.ops import text_kernels as tk
    rng = np.random.default_rng(16)
    n = 3_001
    null, lens, flat = _hash_stream(rng, n, H, max_tok=40)
    flat[::89] = H
    ids = np.concatenate([flat, np.full(7, H, np.int32)])
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ids_d = torch.as_tensor(ids, device=cuda)
    off_d = torch.as_tensor(off, device=cuda)
    null_d = torch.as_tensor(null, device=cuda)
    out = torch.full((n, H + 4), -1.0, device=cuda)
    kernels.reset_launch_counts()
    tk.hash_counts(ids_d, off_d, null_d, H, out=out, col0=2, packed=False)
    assert kernels.launch_counts()["hash_counts"] == 1
    want = torch.full((n, H + 4), -1.0)
    tk.hash_counts_twin(torch.as_tensor(ids), torch.as_tensor(off),
                        torch.as_tensor(null), H, want, 2, False)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    alone = tk.hash_counts(ids_d, off_d, None, H, packed=False)
    assert torch.equal(alone.cpu(), want[:, 2:2 + H])


def test_transmog_path_on_the_card_matches_the_twins(cuda):
    """The transmog workflow at 3,000 rows on the card and on the CPU
    twins: the same width, dropped set, Cramér's V and winner, CV AuPR and
    train AuROC within 1e-4, with ``hash_counts`` and ``fista_step``
    launched on the card."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import transmog_reference as tr
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.synthetic import make_transmog_columns
    facts = {}
    for device in ("cuda", "cpu"):
        cols, schema = make_transmog_columns(3000)
        kernels.reset_launch_counts()
        wf, batch, _ = tr.build(tr.PACKAGES["torch"], cols, schema, 3000,
                                device=device)
        facts[device] = tr.facts(tr.PACKAGES["torch"], wf.train(), batch)
        if device == "cuda":
            launched = kernels.launch_counts()
            assert launched["hash_counts"] > 0 and launched["fista_step"] > 0
    a, b = facts["cuda"], facts["cpu"]
    for k in ("width", "dropped", "winner"):
        assert a[k] == b[k], k
    for g, v in b["cramers_v"].items():
        assert (a["cramers_v"][g] is None) == (v is None)
        if v is not None:
            assert abs(a["cramers_v"][g] - v) <= 1e-5
    for c, v in b["cv_aupr"].items():
        assert abs(a["cv_aupr"][c] - v) <= 1e-4
    assert abs(a["train_auroc"] - b["train_auroc"]) <= 1e-4


def _skewed_sparse(device, n=60_013, d=110_003, seed=8):
    """Random ~9-entry rows (duplicates possible), column 7 holding every
    non-empty row, row 11 holding 100,000 entries, empty rows (every 13th)
    and empty columns (the last 1,000)."""
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 9)
    c = rng.integers(0, d - 1000, r.size)
    r = np.concatenate([r, np.arange(n), np.full(100_000, 11)])
    c = np.concatenate([c, np.full(n, 7), rng.permutation(d - 1000)[:100_000]])
    keep = r % 13 != 0
    r, c = r[keep], c[keep]
    perm = rng.permutation(r.size)          # entries in no particular order
    return SparseMatrix.from_coo(r[perm], c[perm], rng.normal(
        size=r.size).astype(np.float32), n, d, device=device)


@pytest.mark.parametrize("k", [1, 6, 32, 40])
def test_sparse_kernels_match_twins_and_repeat_bit_for_bit(cuda, k):
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk
    X = _skewed_sparse(cuda)
    rng = np.random.default_rng(k)
    M = torch.as_tensor(rng.normal(size=(X.n_cols, k)).astype(np.float32),
                        device=cuda)
    G = torch.as_tensor(rng.normal(size=(X.n_rows, k)).astype(np.float32),
                        device=cuda)
    for fn, twin, dense, n_out, name in (
            (sk.sp_matmat, sk.sp_matmat_twin, M, X.n_rows, "sp_matmat"),
            (sk.sp_rmatmat, sk.sp_rmatmat_twin, G, X.n_cols, "sp_rmatmat")):
        kernels.reset_launch_counts()
        got = fn(X, dense)
        assert kernels.launch_counts()[name] == -(-k // sk.MAX_K)
        assert torch.equal(got, fn(X, dense))
        args = (X.values.double(), X.indices, X.row_ids)
        want = twin(*args, dense.double(), n_out)
        mass = twin(args[0].abs(), *args[1:], dense.double().abs(), n_out)
        assert bool(((got.double() - want).abs() <= 1e-5 * mass + 1e-12)
                    .all())
    # empty rows and columns come out zero
    assert bool((sk.sp_matmat(X, M)[::13] == 0).all())
    assert bool((sk.sp_rmatmat(X, G)[-1000:] == 0).all())


def _assert_emulated(X, name, dense):
    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk
    fn = sk.sp_matmat if name == "sp_matmat" else sk.sp_rmatmat
    got = fn(X, dense).cpu().numpy()
    order, plan = ((X.row_order(), X.row_plan()) if name == "sp_matmat"
                   else (X.col_order(), X.col_plan()))
    want = sk.segsum_emulate(order, plan, dense)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("team", [None, 1, 2, 8, 32])
@pytest.mark.parametrize("k", [1, 3, 6, 32, 40])
def test_sparse_kernels_equal_their_emulation_bit_for_bit(cuda, k, team):
    """Both kernels on the skewed matrix (row 11's 100,000 entries and
    column 7's ~55,000 in pieces) under the default plans and under every
    team size with small tiles: the numpy emulation's bits."""
    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk
    X = _skewed_sparse(cuda)
    if team is not None:
        X._row_plan = sk.segment_plan(X.row_order().ptr, team=team,
                                      tile_cost=512)
        X._col_plan = sk.segment_plan(X.col_order().ptr, team=team,
                                      tile_cost=512)
    assert X.row_plan().n_heavy >= 1 and X.col_plan().n_heavy >= 1
    rng = np.random.default_rng(k)
    for name, rows in (("sp_matmat", X.n_cols), ("sp_rmatmat", X.n_rows)):
        dense = torch.as_tensor(rng.normal(size=(rows, k)).astype(
            np.float32), device=cuda)
        _assert_emulated(X, name, dense)


@pytest.mark.parametrize("k", [6, 8])
def test_sparse_kernels_on_unaligned_operands(cuda, k):
    """A dense operand 4 bytes off its 8- and 16-byte alignment (scalar
    row loads) and an entry stream off its 16-byte alignment (4-byte
    staging copies) give the emulation's bits too."""
    X = _skewed_sparse(cuda)
    rng = np.random.default_rng(k)
    for name, rows in (("sp_matmat", X.n_cols), ("sp_rmatmat", X.n_rows)):
        buf = torch.as_tensor(rng.normal(size=rows * k + 1).astype(
            np.float32), device=cuda)
        dense = buf[1:].view(rows, k)
        assert dense.data_ptr() % 8 != 0
        _assert_emulated(X, name, dense)
    for attr in ("_row_order", "_col_order"):
        o = getattr(X, attr)
        v = torch.empty(o.values.numel() + 1, device=cuda)
        g = torch.empty(o.values.numel() + 1, dtype=torch.int32, device=cuda)
        v[1:], g[1:] = o.values, o.gather
        setattr(X, attr, o._replace(values=v[1:], gather=g[1:]))
    for name, rows in (("sp_matmat", X.n_cols), ("sp_rmatmat", X.n_rows)):
        _assert_emulated(X, name, torch.as_tensor(rng.normal(size=(
            rows, k)).astype(np.float32), device=cuda))


def test_sparse_wrappers_on_the_card_take_the_kernels(cuda):
    """A CUDA matrix launches the kernels (no twin), and an empty matrix
    launches nothing and returns zeros."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    X = SparseMatrix.from_coo([0, 2, 2], [1, 0, 1], [1.0, 2.0, 3.0], 4, 2,
                              device=cuda)
    kernels.reset_launch_counts()
    out = X.matvec(torch.ones(2, device=cuda))
    assert out.tolist() == [1.0, 0.0, 5.0, 0.0]
    assert X.rmatvec(torch.ones(4, device=cuda)).tolist() == [2.0, 4.0]
    assert kernels.launch_counts()["sp_matmat"] == 1
    assert kernels.launch_counts()["sp_rmatmat"] == 1
    E = SparseMatrix.from_coo([], [], [], 3, 5, device=cuda)
    assert bool((E.matmat(torch.ones((5, 2), device=cuda)) == 0).all())
    assert kernels.launch_counts()["sp_matmat"] == 1


def test_sparse_path_on_the_card_matches_the_twins(cuda):
    """The sparse-text workflow at 3,000 rows x 100,000 hashes on the card
    and on the CPU twins: the same width, nnz and winner, CV AuPR and train
    AuROC within 1e-4, with both sparse kernels launched on the card."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import sparse_reference as sr
    from transmogrifai_tpu_torch.models import kernels
    facts = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        wf, batch, _ = sr.build(sr.PACKAGES["torch"], 3000, device=device)
        facts[device] = sr.facts(sr.PACKAGES["torch"], wf.train(), batch)
        if device == "cuda":
            launched = kernels.launch_counts()
            assert launched["sp_matmat"] > 0 and launched["sp_rmatmat"] > 0
    a, b = facts["cuda"], facts["cpu"]
    for k in ("width", "nnz", "winner"):
        assert a[k] == b[k], k
    for c, v in b["cv_aupr"].items():
        assert abs(a["cv_aupr"][c] - v) <= 1e-4
    assert abs(a["train_auroc"] - b["train_auroc"]) <= 1e-4


# --------------------------------------------------------------------------
# explanations: the LOCO kernels
# --------------------------------------------------------------------------

def _assert_loco_matches_twin(run, twin, G, k, strategy):
    """The kernel's diff of each group it lists within 1e-5 of the twin's
    max |diff| of the twin's diff of that group, ranks at each place within
    that, no group twice, the same bits on two launches."""
    idx, val = run()
    idx2, val2 = run()
    assert torch.equal(idx, idx2) and torch.equal(val, val2)
    fi, fv = twin(G)
    full = torch.empty_like(fv).scatter_(1, fi.long(), fv)
    tol = 1e-5 * float(fv.abs().max())
    assert float((val - torch.gather(full, 1, idx.long())).abs().max()) <= tol
    rank = {"abs": torch.abs, "positive": lambda d: d,
            "negative": lambda d: -d}[strategy]
    assert float((rank(val) - rank(fv[:, :k])).abs().max()) <= tol
    assert not bool((torch.sort(idx.long(), dim=1).values.diff(dim=1) == 0)
                    .any())
    return idx, fi, fv


@pytest.mark.parametrize("G,k,strategy,link,contiguous", [
    (12, 12, "abs", "logistic", False), (128, 20, "positive", "logistic",
                                         False),
    (1596, 20, "negative", "svc", False), (1596, 1596, "abs", "logistic",
                                           False),
    (12, 12, "abs", "logistic", True), (40, 20, "negative", "logistic",
                                        True), (300, 20, "abs", "svc", True),
    (40, 20, "abs", "regression", True)])
def test_loco_linear_matches_twin(cuda, G, k, strategy, link, contiguous):
    """Groups of uneven sizes, scattered columns (a column's group is not
    its neighbour's) or contiguous ones (transmogrify's layout: the float4
    path) and G up to the meta-less 1,596 with k = G; zeroed columns make
    exact zero diffs, tied with each other: the kernel lists them in the
    twin's order (the lower group first)."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models.linear import LinearPredictionModel
    rng = np.random.default_rng(7)
    N, D = 3000, 1596
    X = rng.normal(size=(N, D)).astype(np.float32)
    cg = np.sort(rng.integers(0, G, size=D)).astype(np.int32)
    cg[:G] = np.arange(G)                               # every group used
    cg = np.sort(cg) if contiguous else rng.permutation(cg)
    zero = np.isin(cg, np.arange(0, G, 3))              # groups all zero
    X[:, zero] = 0.0
    Xd = torch.as_tensor(X, device=cuda)
    cgd = torch.as_tensor(cg, device=cuda)
    model = LinearPredictionModel(fitted={
        "coef": torch.as_tensor(rng.normal(size=D).astype(np.float32) / 40,
                                device=cuda),
        "intercept": torch.tensor([0.3], device=cuda),
        "kind": "binary" if link == "logistic" else link})
    idx, fi, fv = _assert_loco_matches_twin(
        lambda: ik.loco_linear(Xd, model, cgd, G, k, strategy),
        lambda kk: ik.loco_topk_twin(
            Xd, lambda Z: ik.loco_score(model, Z), cgd, G, kk, strategy),
        G, k, strategy)
    if k == G:
        # the all-zero groups tie at exactly 0: the kernel lists them in
        # increasing group order, as the twin's stable sort does
        zg = torch.as_tensor(np.flatnonzero(np.bincount(
            cg[zero], minlength=G) == np.bincount(cg, minlength=G)),
            device=cuda)
        for got in (idx.long(), fi.long()):
            pos = torch.isin(got, zg)
            seq = got[pos].reshape(N, -1)
            assert seq.shape[1] == len(zg)
            assert bool((seq.diff(dim=1) > 0).all())


@pytest.mark.parametrize("link", ["gbt", "forest", "gbt_regression",
                                  "forest_regression"])
def test_loco_tree_matches_twin(cuda, link):
    """A fitted GBT (5 rounds, depth 3) and forest (5 trees, depth 4),
    classifiers and regressors, on 28 features, one group per feature and
    one per pair of features, top-5 and k = G."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.models.trees import TreeEnsembleModel
    rng = np.random.default_rng(8)
    N, D = 5000, 28
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N).astype(np.float32)
    regression = link.endswith("_regression")
    if not regression:
        y = (y > 0).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    est = {"gbt": lambda: pt.OpGBTClassifier(max_iter=5, max_depth=3),
           "forest": lambda: pt.OpRandomForestClassifier(num_trees=5,
                                                         max_depth=4),
           "gbt_regression": lambda: pt.OpGBTRegressor(max_iter=5,
                                                       max_depth=3),
           "forest_regression": lambda: pt.OpRandomForestRegressor(
               num_trees=5, max_depth=4)}[link]()
    fit = est.fit_arrays(Xd, y)
    model = TreeEnsembleModel(fitted=fit)
    for G, per in ((28, 1), (14, 2)):
        cgd = torch.arange(D, device=cuda, dtype=torch.int32) // per
        for k, strategy in ((5, "abs"), (G, "negative")):
            _assert_loco_matches_twin(
                lambda: ik.loco_tree(Xd, model, cgd, G, k, strategy),
                lambda kk: ik.loco_topk_twin(
                    Xd, lambda Z: ik.loco_score(model, Z), cgd, G, kk,
                    strategy), G, k, strategy)


@pytest.mark.parametrize("link", ["gbt", "forest", "gbt_regression",
                                  "forest_regression"])
@pytest.mark.parametrize("D,G,k,strategy", [
    (28, 1, 1, "abs"),              # one group of every column
    (28, 28, 20, "positive"),       # the default grid's groups, top-20
    (100, 100, 40, "abs"),          # two windows of groups, k > 32
    (100, 100, 5, "negative"),      # two windows, X read in place
    (40, 40, 33, "abs")])           # k > 32 in one window
def test_loco_tree_windows_and_long_lists_match_twin(cuda, link, D, G, k,
                                                     strategy):
    """``loco_tree`` at G = 1, a window of 28, past one window of 64
    groups (the top-K list carried across the windows in the output), k
    past 32, each link and strategy, depth-6 trees: the twin's diffs within
    1e-5 of the largest, the same bits twice."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.models.trees import TreeEnsembleModel
    rng = np.random.default_rng(D + G + k)
    N = 3000
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = X[:, 0] + X[:, 1] * X[:, 2] + X[:, D - 1] + rng.normal(size=N).astype(
        np.float32)
    if not link.endswith("_regression"):
        y = (y > 0).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    est = {"gbt": lambda: pt.OpGBTClassifier(max_iter=8, max_depth=6),
           "forest": lambda: pt.OpRandomForestClassifier(num_trees=8,
                                                         max_depth=6),
           "gbt_regression": lambda: pt.OpGBTRegressor(max_iter=8,
                                                       max_depth=6),
           "forest_regression": lambda: pt.OpRandomForestRegressor(
               num_trees=8, max_depth=6)}[link]()
    model = TreeEnsembleModel(fitted=est.fit_arrays(Xd, y))
    cgd = torch.as_tensor(rng.permutation(np.arange(D) % G).astype(np.int32),
                          device=cuda)
    kernels.reset_launch_counts()
    _assert_loco_matches_twin(
        lambda: ik.loco_tree(Xd, model, cgd, G, k, strategy),
        lambda kk: ik.loco_topk_twin(
            Xd, lambda Z: ik.loco_score(model, Z), cgd, G, kk, strategy),
        G, k, strategy)
    assert kernels.launch_counts()["loco_tree"] == 2


def test_loco_stage_on_the_card_takes_the_kernels(cuda):
    """RecordInsightsLOCO on a CUDA batch launches ``loco_linear`` (an LR)
    and gives the maps of the same stage on the CPU twins, up to 1e-5."""
    import json

    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import Feature
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models.linear import (LinearPredictionModel,
                                                       OpLogisticRegression)
    from transmogrifai_tpu_torch.record_insights import RecordInsightsLOCO
    from transmogrifai_tpu_torch.types import OPVector
    from transmogrifai_tpu_torch.vector_meta import (VectorColumnMeta,
                                                     VectorMeta)
    rng = np.random.default_rng(9)
    X = rng.normal(size=(2000, 12)).astype(np.float32)
    y = (X[:, 0] - X[:, 5] + rng.normal(size=2000) > 0).astype(np.float32)
    fit = OpLogisticRegression(max_iter=30).fit_arrays(X, y, device="cpu")
    meta = VectorMeta("v", [VectorColumnMeta(f"p{i // 3}", "Real", index=i)
                            for i in range(12)])
    out = {}
    for dev in ("cuda", "cpu"):
        model = LinearPredictionModel(fitted={
            "coef": fit["coef"].to(dev), "intercept": fit["intercept"].to(dev),
            "kind": "binary"})
        loco = RecordInsightsLOCO(model=model, top_k=4)
        loco.set_input(Feature("v", OPVector, False, None, parents=()))
        kernels.reset_launch_counts()
        out[dev] = loco.transform(ColumnBatch({"v": Column(
            OPVector, torch.as_tensor(X), meta=meta)}, 2000,
            device=dev)).values
        assert kernels.launch_counts()["loco_linear"] == (dev == "cuda")
    for a, b in zip(out["cuda"], out["cpu"]):
        assert list(a) == list(b)
        for name in a:
            assert abs(json.loads(a[name])[0][1]
                       - json.loads(b[name])[0][1]) <= 1e-5


# --------------------------------------------------------------------------
# the repaired faults: any width, any class count
# --------------------------------------------------------------------------

def test_split_kernels_at_1597_features_match_twins(cuda):
    """D = 1,597 (two feature chunks): tree_split within the xgb tolerance,
    tree_split_gini equal to its twin on integer counts, and a cross-chunk
    exact tie (column 100 = column 1,500) taken by feature 100 in both."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import binned
    rng = np.random.default_rng(10)
    N, D, K = 20_000, 1597, 2
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:, 100] = X[:, 1500]
    y = (X[:, 1500] + 0.5 * rng.normal(size=N) > 0).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    _, splits, B = binned(Xd, Xd, 32)
    yd = torch.as_tensor(y, device=cuda)
    rn = torch.zeros((K, N), dtype=torch.int32, device=cuda)
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    p = torch.full((K, N), 0.5, device=cuda)
    xgb = torch.stack([torch.ones_like(p), p - yd, p * (1 - p)],
                      dim=2).contiguous()
    h, t = tk.tree_hist(B, rn, xgb, 0, 1, 32)
    sk = tk.tree_split(h, t, fmask, splits, lane(1.0), lane(0.0), lane(1.0))
    st = tk.tree_split_twin(h, t, fmask, splits, lane(1.0), lane(0.0),
                            lane(1.0))
    assert sk["feature"].tolist() == st["feature"].tolist() == [[100]] * K
    assert torch.allclose(sk["gain"], st["gain"], rtol=1e-5)
    cnt = torch.stack([torch.ones_like(yd), 1 - yd, yd], dim=1)
    gini = cnt[None].expand(K, N, 3).contiguous()
    h, t = tk.tree_hist(B, rn, gini, 0, 1, 32)
    args = (h, t, fmask, None, splits, lane(1.0), lane(0.0))
    gk, gt = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
    for key in ("gain", "feature", "bin", "is_leaf", "threshold"):
        assert torch.equal(gk[key], gt[key]), key
    assert gk["feature"].tolist() == [[100]] * K


@pytest.mark.parametrize("n_classes", [6, 40])
def test_multiclass_forest_kernels_match_twins(cuda, n_classes):
    """C = 6 and 40: tree_hist_deep (2 and 9 statistic chunks) within the
    histogram tolerance, tree_split_gini equal to its twin on integer counts
    (1 and 5 class chunks), a fitted forest's tree_walk (V = C) within
    1e-6, and the decision tree fitted on the card equal to the CPU twins'."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import (OpDecisionTreeClassifier,
                                                      binned)
    rng = np.random.default_rng(11)
    N, D, K, P = 20_000, 8, 2, 128
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.integers(0, n_classes, size=N).astype(np.float32)
    y[: n_classes] = np.arange(n_classes)
    Xd = torch.as_tensor(X, device=cuda)
    _, splits, B = binned(Xd, Xd, 32)
    oh = torch.nn.functional.one_hot(torch.as_tensor(y, device=cuda).long(),
                                     n_classes).float()
    stats = torch.cat([torch.ones((N, 1), device=cuda), oh], dim=1)
    stats = (stats[None] * torch.as_tensor(
        rng.poisson(1.0, size=(K, N, 1)).astype(np.float32),
        device=cuda)).contiguous()
    rn = torch.as_tensor(rng.integers(P - 1, 2 * P - 1, size=(K, N)).astype(
        np.int32), device=cuda)
    h, t = tk.tree_hist(B, rn, stats, P - 1, P, 32)
    ht, tt = tk.tree_hist_twin(B, rn, stats.double(), P - 1, P, 32)
    assert bool(((h.double() - ht).abs() <= 1e-5 + 1e-5 * ht).all())
    assert bool(((t.double() - tt).abs() <= 1e-5 + 1e-5 * tt).all())
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    args = (h, t, fmask, None, splits, lane(2.0), lane(0.0))
    gk, gt = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
    for key in ("gain", "feature", "bin", "is_leaf", "threshold"):
        assert torch.equal(gk[key], gt[key]), key
    fit = OpDecisionTreeClassifier(max_depth=8, min_instances_per_node=5)
    card = fit.fit_arrays(Xd, y)
    host = fit.fit_arrays(torch.as_tensor(X), y, device="cpu")
    for key in ("feature", "is_leaf", "threshold"):
        assert torch.equal(card[key].cpu(), host[key]), key
    walk = (card["feature"], card["threshold"], card["is_leaf"],
            card["leaf"], 9)
    assert card["leaf"].shape[2] == n_classes
    assert float((tk.tree_walk(Xd, *walk, op="mean")
                  - tk.tree_walk_twin(Xd, *walk, 1, "mean")).abs().max()) \
        <= 1e-6


# --------------------------------------------------------------------------
# the regression family: tree_split_variance
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P,D", [(32, 16), (2048, 16), (1, 1597)])
def test_tree_split_variance_matches_twin(cuda, P, D):
    """An RF regressor's level 5 (P = 32) and a depth-12 grid's level 11
    (P = 2048) over 16 features with "onethird" node subsets (5 of 16), and
    a root over 1,597 features (two chunks) whose columns 100 and 1,500 are
    equal and carry an integer label (exact sums: the two histograms are
    equal, the best split an exact cross-chunk tie): against the twin on
    the f64 histogram."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import binned
    rng = np.random.default_rng(12)
    N, K = (20_000 if D > 1000 else 50_000), 4
    X = rng.normal(size=(N, D)).astype(np.float32)
    if D > 1000:
        X[:, 100] = X[:, 1500]
        y = np.round(2 * X[:, 1500] + 0.3 * rng.normal(size=N))
    else:
        y = 2 * X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N)
    y = y.astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    _, splits, B = binned(Xd, Xd, 32)
    w = rng.poisson(1.0, size=(K, N)) * (rng.random((K, N)) > 0.33)
    base = np.stack([np.ones(N), y, y * y], axis=1)
    stats = torch.as_tensor((base[None] * w[:, :, None]).astype(np.float32),
                            device=cuda)
    rn = torch.as_tensor(rng.integers(P - 1, 2 * P - 1, size=(K, N)).astype(
        np.int32), device=cuda)
    mask = None
    if D < 1000:
        m = np.zeros((K, P, D), bool)
        for k in range(K):
            for p in range(P):
                m[k, p, rng.choice(D, D // 3, replace=False)] = True
        mask = torch.as_tensor(m, device=cuda)
    h, t = tk.tree_hist(B, rn, stats, P - 1, P, 32, node_mask=mask)
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    args = (h, t, fmask, mask, splits, lane(10.0), lane(0.001))
    kernels.reset_launch_counts()
    sk = tk.tree_split_variance(*args)
    assert kernels.launch_counts()["tree_split_variance"] == 1
    a64 = (h.double(), t.double(), fmask, mask, splits, lane(10.0).double(),
           lane(0.001).double())
    st = tk.tree_split_variance_twin(*a64)
    tol = 1e-5 * t[..., 2].double() + 1e-6
    fin = torch.isfinite(st["gain"])
    assert torch.equal(fin, torch.isfinite(sk["gain"]))
    assert bool(((sk["gain"].double() - st["gain"]).abs()[fin]
                 <= tol[fin]).all())
    clear = tk.split_gap_variance(h.double(), t.double(), fmask, mask,
                                  lane(10.0).double()) > 2 * tol
    # at 1,597 features the root's best split is the exact tie itself
    assert bool(clear.any()) or D > 1000
    for key in ("feature", "bin", "threshold"):
        assert torch.equal(sk[key][clear], st[key][clear]), key
    leaf_clear = ~fin | ((st["gain"] - 0.001).abs() > tol)
    assert torch.equal(sk["is_leaf"][leaf_clear], st["is_leaf"][leaf_clear])
    if D > 1000:
        assert sk["feature"].tolist() == [[100]] * K


# --------------------------------------------------------------------------
# the multiclass family: fista_softmax and multiclass_confusion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("G,D,F,C", [(8, 16, 1, 4),     # the fold-0 screen
                                     (8, 16, 3, 4),     # the CV block
                                     (8, 16, 1, 40),    # 40 classes
                                     (8, 16, 3, 40),    # lanes in chunks
                                     (2, 1596, 3, 4),   # the wide form
                                     (8, 1596, 3, 4),   # wide, 2 launches
                                     (1, 16, 1, 4),     # one lane
                                     (8, 16, 1, 3),     # iris's 3 classes
                                     (8, 1596, 1, 4),   # the wide screen
                                     (2, 1597, 3, 4),   # unaligned rows
                                     (1, 1596, 1, 40)])  # 40 classes, wide
def test_fista_softmax_matches_twin_and_repeats_bit_for_bit(cuda, G, D, F,
                                                            C):
    """Within 1e-5 of each output's absolute mass of the twin run in f64,
    and the same bits on two launches.  N = 50,001 is no multiple of any
    plan's row tile."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    rng = np.random.default_rng(21)
    N, L = 50_001, F * G
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=cuda)
    W = torch.as_tensor((rng.random((F, N)) > 1 / 3).astype(np.float32),
                        device=cuda)
    y = torch.as_tensor(rng.integers(0, C, N).astype(np.int32), device=cuda)
    sd = 0.3 * min(1.0, (16 / D) ** 0.5)
    V = torch.as_tensor(rng.normal(scale=sd, size=(L, C, D)).astype(
        np.float32), device=cuda)
    muv = torch.as_tensor(rng.normal(size=(L, C)).astype(np.float32),
                          device=cuda)
    b = torch.as_tensor(rng.normal(size=(L, C)).astype(np.float32),
                        device=cuda)
    ws = W.sum(dim=1)[torch.arange(L, device=cuda) // G]
    args = (X, V, muv, b, W, y, ws, G)
    kernels.reset_launch_counts()
    gx, gs = lk.fista_softmax_step(*args)
    assert kernels.launch_counts()["fista_softmax"] == len(list(
        lk.tc_chunks(V, muv, b, ws, G, lk.softmax_launch_plan(D, L, C))))
    gx2, gs2 = lk.fista_softmax_step(*args)
    assert torch.equal(gx, gx2) and torch.equal(gs, gs2)
    a64 = (X.double(), V.double(), muv.double(), b.double(), W.double(), y,
           ws.double(), G)
    g64 = lk.fista_softmax_row_grads(*a64).reshape(L * C, N)
    X64 = X.double()
    want = (g64 @ X64).reshape(L, C, D)
    mass = (g64.abs() @ X64.abs()).reshape(L, C, D)
    assert bool(((gx.double() - want).abs() <= 1e-5 * mass + 1e-12).all())
    assert bool(((gs.double() - g64.sum(dim=1).reshape(L, C)).abs()
                 <= 1e-5 * g64.abs().sum(dim=1).reshape(L, C)
                 + 1e-12).all())


@pytest.mark.parametrize("K,G,C", [(24, 8, 4), (1, 1, 3), (24, 8, 40),
                                   (5, 5, 300), (24, 8, 8), (24, 8, 9),
                                   (24, 8, 14), (24, 8, 15), (1, 1, 4),
                                   (54, 18, 4), (300, 100, 2), (3, 1, 1)])
def test_multiclass_confusion_matches_twin(cuda, K, G, C):
    """Equal to the twin on 0/1 masks (integer sums), within 1e-6 of the
    f64 sums on other weights, and the same bits on two launches, at every
    plan: the thread form (C <= 14; candidates past one block's 256
    threads), the shared form's candidate
    and class chunks; and the bits
    of the numpy emulation of its order (``confusion_emulate``) where that
    fits the host's memory."""
    from transmogrifai_tpu_torch import metrics_kernels as mk
    rng = np.random.default_rng(22)
    N = 100_003
    F = -(-K // G)
    y = torch.as_tensor(rng.integers(0, C, N).astype(np.int32), device=cuda)
    P = torch.as_tensor(np.where(rng.random((N, K)) < 0.7,
                                 y.cpu().numpy()[:, None],
                                 rng.integers(0, C, (N, K))).astype(np.int32),
                        device=cuda)
    W01 = torch.as_tensor((rng.random((F, N)) < 0.5).astype(np.float32),
                          device=cuda)
    assert torch.equal(mk.multiclass_confusion(y, P, W01, G, C),
                       mk.multiclass_confusion_twin(y, P, W01, G, C))
    Wr = torch.as_tensor(rng.random((F, N)).astype(np.float32), device=cuda)
    got = mk.multiclass_confusion(y, P, Wr, G, C)
    assert torch.equal(got, mk.multiclass_confusion(y, P, Wr, G, C))
    want = mk.multiclass_confusion_twin(y, P, Wr.double(), G, C)
    assert bool(((got.double() - want).abs()
                 <= 1e-6 * want.abs().clamp(min=1.0)).all())
    plan = mk.confusion_plan(
        K, C, N, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan.form != "shared" or K * C * C * plan.threads <= 2_000_000:
        emu = mk.confusion_emulate(y.cpu().numpy(), P.cpu().numpy(),
                                   Wr.cpu().numpy(), G, C, plan)
        assert np.array_equal(got.cpu().numpy(), emu)


def test_multiclass_selector_on_the_card_matches_the_twins(cuda):
    """4,000 rows of the bench's multiclass data, the default LR candidates
    and a 10-tree forest with the draws made on the host: the card and the
    CPU twins give the same CV F1 and winner, the LR refit within 1e-4 of
    max |coef|, and both new kernels launch."""
    import importlib
    import os
    import sys
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    mgr = importlib.import_module("multiclass_grid_reference")
    S = importlib.import_module("transmogrifai_tpu_torch.selector")
    T = importlib.import_module("transmogrifai_tpu_torch.models.trees")
    X, y = make_multiclass_data(4000)
    runs = {}
    for dev in ("cuda", "cpu"):
        models = [S._lr_candidates(), S.ModelCandidate(
            T.OpRandomForestClassifier(num_trees=10, max_depth=6,
                                       draw_device="cpu"),
            [{}], "OpRandomForestClassifier")]
        kernels.reset_launch_counts()
        runs[dev] = mgr.train(mgr.PACKAGES["torch"], X, y, models,
                              device=dev)[0]
        if dev == "cuda":
            launches = kernels.launch_counts()
    assert launches["fista_softmax"] > 0
    assert launches["multiclass_confusion"] > 0
    gc, cc = mgr.candidates(runs["cuda"]), mgr.candidates(runs["cpu"])
    assert [(n, p, r) for n, p, _, r in gc] == [(n, p, r) for n, p, _, r in cc]
    assert [v for *_, v, _ in gc] == [v for *_, v, _ in cc]
    bg = runs["cuda"].selected_model.best_model.fitted
    bc = runs["cpu"].selected_model.best_model.fitted
    scale = float(bc["coef"].abs().max())
    assert float((bg["coef"].cpu() - bc["coef"]).abs().max()) <= 1e-4 * scale



# --------------------------------------------------------------------------
# GLMs and the softmax link of LOCO
# --------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["poisson", "gamma"])
@pytest.mark.parametrize("L,G,D,grad", [(12, 4, 16, True),    # the CV block
                                        (96, 32, 16, False),  # one ladder
                                        (1, 1, 16, True),     # the refit
                                        (3, 1, 1596, True),   # wide
                                        (40, 8, 300, False),  # lane chunks
                                        (12, 4, 4_900, True),  # clusters
                                        (96, 32, 16_384, False)])
def test_fista_glm_matches_twin_and_repeats_bit_for_bit(cuda, loss, L, G, D,
                                                        grad):
    """Within 1e-5 of each output's absolute mass of the twin run in f64,
    and the same bits on two launches."""
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    rng = np.random.default_rng(22)
    N, F = 50_001 if D < 4_000 else 5_001, -(-L // G)
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=cuda)
    W = torch.as_tensor((rng.random((F, N)) > 1 / 3).astype(np.float32),
                        device=cuda)
    y = torch.as_tensor((rng.poisson(1.3, N) if loss == "poisson"
                         else rng.gamma(2.0, 0.7, N)).astype(np.float32),
                        device=cuda)
    sd = 0.3 * min(1.0, (16 / D) ** 0.5)
    V = torch.as_tensor(rng.normal(scale=sd, size=(L, D)).astype(np.float32),
                        device=cuda)
    muv = torch.as_tensor(rng.normal(scale=0.1, size=L).astype(np.float32),
                          device=cuda)
    b = torch.as_tensor((0.3 + rng.normal(scale=0.2, size=L)).astype(
        np.float32), device=cuda)
    ws = W.sum(dim=1)[torch.arange(L, device=cuda) // G]
    args = (X, V, muv, b, W, y, ws, G, loss, grad)
    got, again = lk.fista_glm(*args), lk.fista_glm(*args)
    got = got if grad else (got,)
    again = again if grad else (again,)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    lanes = torch.arange(L, device=cuda) // G
    X64 = X.double()
    lin = V.double() @ X64.T - muv.double()[:, None] + b.double()[:, None]
    lw, g = lk.glm_row_terms(lin, y.double(), W.double()[lanes],
                             ws.double()[:, None], loss)
    checks = [(got[-1], lw.sum(dim=1) / ws.double(),
               lw.abs().sum(dim=1) / ws.double())]
    if grad:
        checks += [(got[0], g @ X64, g.abs() @ X64.abs()),
                   (got[1], g.sum(dim=1), g.abs().sum(dim=1))]
    for g32, want, mass in checks:
        assert bool(((g32.double() - want).abs() <= 1e-5 * mass + 1e-12)
                    .all())


@pytest.mark.parametrize("family", ["poisson", "gamma"])
def test_glm_grid_fit_on_the_card_repeats_and_matches_the_cpu(cuda, family):
    """3 folds x 4 reg_params of backtracking FISTA on the card: two runs
    give the same coefficients, ``n_iter`` and halvings bit for bit (fixed
    summation order), within 1e-3 of the CPU twins' coefficients."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import solvers as ps
    from transmogrifai_tpu_torch.synthetic import make_glm_data
    X, y = make_glm_data(20_000, family)
    rng = np.random.default_rng(3)
    W = np.ones((3, len(y)), np.float32)
    for f, idx in enumerate(np.array_split(rng.permutation(len(y)), 3)):
        W[f, idx] = 0.0
    reg = np.array([0.001, 0.01, 0.1, 0.2], np.float32)

    def fit(dev):
        return ps.linear_grid_fit(*(torch.as_tensor(a, device=dev) for a in (
            X, y, W, reg, np.zeros(4, np.float32))), loss=family,
            max_iter=50)

    kernels.reset_launch_counts()
    a, b = fit(cuda), fit(cuda)
    assert kernels.launch_counts()["fista_glm"] > 0
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    cpu = fit("cpu")
    np.testing.assert_allclose(a.coef.cpu().numpy(), cpu.coef.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(a.intercept.cpu().numpy(),
                               cpu.intercept.numpy(), atol=1e-3)


@pytest.mark.parametrize("family", ["poisson", "gamma", "binomial",
                                    "gaussian"])
def test_loco_linear_glm_links_match_twin(cuda, family):
    """A GLM's inverse link of the clipped margin in ``loco_linear``, with
    margins reaching past ±30 on some rows."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models.linear import GLMPredictionModel
    rng = np.random.default_rng(9)
    N, D, G = 20_000, 64, 16
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:50] *= 40.0                                   # past the clip
    Xd = torch.as_tensor(X, device=cuda)
    cg = torch.as_tensor(np.arange(D) % G, dtype=torch.int32, device=cuda)
    model = GLMPredictionModel(fitted={
        "coef": torch.as_tensor(rng.normal(scale=0.1, size=D).astype(
            np.float32), device=cuda),
        "intercept": torch.tensor([0.3], device=cuda), "kind": "glm",
        "family": family})
    _assert_loco_matches_twin(
        lambda: ik.loco_linear(Xd, model, cg, G, 10, "abs"),
        lambda kk: ik.loco_topk_twin(
            Xd, lambda Z: ik.loco_score(model, Z), cg, G, kk, "abs"),
        G, 10, "abs")


def _softmax_model(kind, D, C, rng, device):
    from transmogrifai_tpu_torch.models.linear import (
        LinearPredictionModel, MLPClassificationModel, NaiveBayesModel)

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(scale=scale, size=shape).astype(
            np.float32), device=device)

    if kind == "multinomial":
        return LinearPredictionModel(fitted={
            "coef": t(D, C, scale=2.0 / D ** 0.5), "intercept": t(C),
            "kind": "multinomial", "n_classes": C})
    if kind == "naive_bayes":
        lp = torch.log_softmax(t(C, D), dim=1)
        return NaiveBayesModel(fitted={"log_prob": lp,
                                       "log_prior": torch.log_softmax(
                                           t(C), dim=0),
                                       "kind": "naive_bayes",
                                       "n_classes": C})
    sizes = [D] + ([10] if kind == "mlp" else [6, 5]) + [C]
    fitted = {"kind": "mlp", "n_layers": len(sizes) - 1, "n_classes": C}
    for i in range(len(sizes) - 1):
        fitted[f"W{i}"] = t(sizes[i], sizes[i + 1],
                            scale=(2.0 / sizes[i]) ** 0.5)
        fitted[f"b{i}"] = t(sizes[i + 1], scale=0.1)
    return MLPClassificationModel(fitted=fitted)


def _softmax_diffs_f64(X, model, col_group, G):
    """Every group's diff [N, G] in f64: the model's layers
    (``softmax_layers``) on the masked rows, the last class's softmax."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    relu_in, W1, b1, tail = ik.softmax_layers(model, X.device)
    X64 = X.double()

    def p_last(Z):
        a = (torch.clamp(Z, min=0.0) if relu_in else Z) @ W1.double() \
            + b1.double()
        for W, b in tail:
            a = torch.relu(a) @ W.double() + b.double()
        return torch.softmax(a, dim=-1)[:, -1]

    base = p_last(X64)
    return torch.stack([base - p_last(X64 * (col_group != g).double())
                        for g in range(G)], dim=1)


@pytest.mark.parametrize("kind,C,G,k,strategy,contiguous", [
    ("multinomial", 4, 16, 16, "abs", True),
    ("multinomial", 40, 16, 16, "positive", True),
    ("multinomial", 4, 128, 20, "negative", False),
    ("multinomial", 3, 64, 40, "abs", False),          # k past 32
    ("naive_bayes", 4, 16, 16, "abs", True),
    ("naive_bayes", 5, 30, 7, "abs", False),
    ("mlp", 4, 16, 16, "abs", True),
    ("mlp_deep", 4, 24, 12, "negative", False)])
def test_loco_softmax_matches_twin(cuda, kind, C, G, k, strategy,
                                   contiguous):
    """Groups of uneven sizes, scattered or contiguous, zeroed columns
    (exact zero diffs, tied: the lower group first), k up to past 32.
    Against the f64 diffs: each listed diff and the rank at each place
    within 1e-5 of the largest |diff| plus twice the plain f32 version's
    own largest error — naive Bayes' logits are sums of x·log p over ~48
    columns (~-80 here), whose f32 rounding in any order moves a
    probability by a few 1e-6.  The same bits on two launches."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    rng = np.random.default_rng(11)
    N, D = 20_000, 128 if G > 32 else 48
    X = rng.normal(size=(N, D)).astype(np.float32)
    cg = np.sort(rng.integers(0, G, size=D)).astype(np.int32)
    cg[:G] = np.arange(G)
    cg = np.sort(cg) if contiguous else rng.permutation(cg)
    X[:, np.isin(cg, np.arange(0, G, 5))] = 0.0
    Xd = torch.as_tensor(X, device=cuda)
    cgd = torch.as_tensor(cg, device=cuda)
    model = _softmax_model(kind, D, C, rng, cuda)
    idx, val = ik.loco_softmax(Xd, model, cgd, G, k, strategy)
    idx2, val2 = ik.loco_softmax(Xd, model, cgd, G, k, strategy)
    assert torch.equal(idx, idx2) and torch.equal(val, val2)
    assert not bool((torch.sort(idx.long(), dim=1).values.diff(dim=1) == 0)
                    .any())
    want = _softmax_diffs_f64(Xd, model, cgd, G)
    ti, tv = ik.loco_topk_twin(Xd, lambda Z: ik.loco_score(model, Z), cgd, G,
                               G, strategy)
    twin_err = float((tv.double() - torch.gather(want, 1, ti.long()))
                     .abs().max())
    tol = 1e-5 * float(want.abs().max()) + 2.0 * twin_err
    assert float((val.double() - torch.gather(want, 1, idx.long())).abs()
                 .max()) <= tol
    rank = {"abs": torch.abs, "positive": lambda d: d,
            "negative": lambda d: -d}[strategy]
    best = torch.sort(rank(want), dim=1, descending=True).values[:, :k]
    assert float((rank(val.double()) - best).abs().max()) <= tol


@pytest.mark.parametrize("kind,C,G,k,strategy,D", [
    ("multinomial", 4, 16, 16, "abs", 16),           # the multiclass winner
    ("naive_bayes", 4, 16, 16, "abs", 16),
    ("mlp", 4, 16, 16, "abs", 16),
    ("mlp_deep", 4, 24, 12, "negative", 48),
    ("multinomial", 16, 30, 7, "positive", 48),
    ("multinomial", 3, 64, 40, "abs", 96),           # k past 32
    ("multinomial", 4, 96, 20, "abs", 96)])          # the widest row
def test_loco_softmax_row_form_gives_the_warp_forms_bits(cuda, kind, C, G, k,
                                                         strategy, D,
                                                         monkeypatch):
    """The row form (a row a thread) against the warp form (one warp a row,
    forced by switching the row form off) on the same inputs: the same
    indices and the same diffs bit for bit (the same sums in the same
    order, the same insertion rule), indices written as ``index_dtype(G)``
    by the kernel itself."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    rng = np.random.default_rng(17 + G)
    N = 20_001
    X = rng.normal(size=(N, D)).astype(np.float32)
    cg = rng.permutation(np.arange(D) % G).astype(np.int32)
    X[:, np.isin(cg, np.arange(0, G, 5))] = 0.0
    Xd = torch.as_tensor(X, device=cuda)
    cgd = torch.as_tensor(cg, device=cuda)
    model = _softmax_model(kind, D, C, rng, cuda)
    inp = ik.softmax_kernel_inputs(model, cgd, G, cuda)
    assert ik.loco_softmax_plan(N, D, G, k, inp["H"], C,
                                inp["widths"][1:]).form == "rows"
    ri, rv = ik.loco_softmax(Xd, model, cgd, G, k, strategy)
    assert ri.dtype == ik.index_dtype(G)
    monkeypatch.setattr(ik, "ROW_WIDTH_MAX", 0)
    wi, wv = ik.loco_softmax(Xd, model, cgd, G, k, strategy)
    assert torch.equal(ri, wi) and torch.equal(rv, wv)


# --------------------------------------------------------------------------
# the repaired card-only refusals: the two-pass FISTA form, splits past 32
# bins, wide and deep MLPs in loco_softmax; tree_hist at forest lane counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,loss,N,D,L,G,C,grad", [
    ("step", "logistic", 2000, 27_009, 1, 1, 1, True),    # one lane, past
    ("step", "squared", 2000, 27_009, 6, 2, 1, True),     # 27,008 columns
    ("step", "gram", 2000, 27_009, 3, 1, 1, True),
    ("softmax", "softmax", 20_000, 16, 8, 8, 65, True),   # 65 classes
    ("softmax", "softmax", 20_000, 16, 1, 1, 300, True),
    ("glm", "poisson", 2000, 27_009, 4, 4, 1, True),      # past the
    ("glm", "gamma", 2000, 27_009, 4, 4, 1, True),        # tensor-core
    ("glm", "poisson", 2000, 27_009, 12, 4, 1, True),     # form's width
    ("glm", "gamma", 2000, 27_009, 96, 32, 1, False)])    # a ladder
def test_fista_wide_form_matches_twin_and_repeats_bit_for_bit(
        cuda, kind, loss, N, D, L, G, C, grad):
    """The shapes no tensor-core or one-tile launch holds run the two-pass
    form (``fista_wide``, one launch a call): within 1e-5 of each output's
    absolute mass of the twin run in f64, and the same bits twice."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    rng = np.random.default_rng(31)
    F = -(-L // G)
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=cuda)
    W = torch.as_tensor((rng.random((F, N)) > 1 / 3).astype(np.float32),
                        device=cuda)
    sd = 0.3 * min(1.0, (16 / D) ** 0.5)
    shape = (L, C, D) if kind == "softmax" else (L, D)
    V = torch.as_tensor(rng.normal(scale=sd, size=shape).astype(np.float32),
                        device=cuda)
    muv = torch.as_tensor(rng.normal(scale=0.1, size=shape[:-1]).astype(
        np.float32), device=cuda)
    b = torch.as_tensor((0.3 + rng.normal(scale=0.2, size=shape[:-1]))
                        .astype(np.float32), device=cuda)
    ws = W.sum(dim=1)[torch.arange(L, device=cuda) // G]
    if kind == "softmax":
        y = torch.as_tensor(rng.integers(0, C, N).astype(np.int32),
                            device=cuda)
        run = lambda: lk.fista_softmax_step(X, V, muv, b, W, y, ws, G)
    elif kind == "glm":
        y = torch.as_tensor((rng.poisson(1.3, N) if loss == "poisson"
                             else rng.gamma(2.0, 0.7, N)).astype(np.float32),
                            device=cuda)
        run = lambda: lk.fista_glm(X, V, muv, b, W, y, ws, G, loss, grad)
    else:
        y = torch.as_tensor((rng.random(N) > 0.5).astype(np.float32),
                            device=cuda)
        tgt = None if loss == "gram" else y
        run = lambda: lk.fista_step(X, V, muv, b, W, tgt, ws, G, loss)
    kernels.reset_launch_counts()
    got = run()
    counts = kernels.launch_counts()
    assert counts["fista_wide"] == 1
    assert counts["fista_step"] + counts["fista_softmax"] \
        + counts["fista_glm"] == 0
    again = run()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    X64, lanes = X.double(), torch.arange(L, device=cuda) // G
    if kind == "softmax":
        a64 = (X64, V.double(), muv.double(), b.double(), W.double(), y,
               ws.double(), G)
        g = lk.fista_softmax_row_grads(*a64).reshape(L * C, N)
        checks = [(got[0], (g @ X64).reshape(L, C, D),
                   (g.abs() @ X64.abs()).reshape(L, C, D)),
                  (got[1], g.sum(dim=1).reshape(L, C),
                   g.abs().sum(dim=1).reshape(L, C))]
    else:
        lin = V.double() @ X64.T - muv.double()[:, None] \
            + b.double()[:, None]
        if kind == "glm":
            lw, g = lk.glm_row_terms(lin, y.double(), W.double()[lanes],
                                     ws.double()[:, None], loss)
            checks = [(got[-1], lw.sum(dim=1) / ws.double(),
                       lw.abs().sum(dim=1) / ws.double())]
        else:
            g = lk.loss_grads(lin, W.double()[lanes],
                              None if loss == "gram" else y.double(),
                              ws.double()[:, None], loss)
            checks = []
        if grad:
            checks += [(got[0], g @ X64, g.abs() @ X64.abs()),
                       (got[1], g.sum(dim=1), g.abs().sum(dim=1))]
    for g32, want, mass in checks:
        assert bool(((g32.double() - want).abs() <= 1e-5 * mass + 1e-12)
                    .all())


@pytest.mark.parametrize("n_bins", [64, 127])
def test_split_kernels_past_32_bins_match_twins(cuda, n_bins):
    """64 and 127 bins (two and four bins a warp lane): tree_split within
    the xgb tolerance, tree_split_gini within 1e-6 of wgini(parent) and
    tree_split_variance within 1e-5 of the parent's Σw·y² of their twins,
    the same choices where the runner-up gap is clear, at a level of 4
    nodes over 8 features with 3-of-8 node subsets."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import binned
    rng = np.random.default_rng(40 + n_bins)
    N, D, K, P = 30_000, 8, 3, 4
    X = rng.normal(size=(N, D)).astype(np.float32)
    yr = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=N)).astype(
        np.float32)
    y = (yr > 0.2).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    _, splits, B = binned(Xd, Xd, n_bins)
    assert int(B.max()) >= n_bins - 8
    rn = torch.as_tensor(rng.integers(P - 1, 2 * P - 1, size=(K, N)).astype(
        np.int32), device=cuda)
    m = np.zeros((K, P, D), bool)
    for k in range(K):
        for p in range(P):
            m[k, p, rng.choice(D, 3, replace=False)] = True
    mask = torch.as_tensor(m, device=cuda)
    w = rng.poisson(1.0, size=(K, N)) * (rng.random((K, N)) > 0.33)
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    # xgb: (w, w·g, w·h)
    pm = 1 / (1 + np.exp(-0.3 * rng.normal(size=(K, N))))
    xgb = torch.as_tensor(np.stack([w, w * (pm - y), w * pm * (1 - pm)],
                                   axis=2).astype(np.float32), device=cuda)
    h, t = tk.tree_hist(B, rn, xgb, P - 1, P, n_bins)
    args = (h, t, fmask, splits, lane(10.0), lane(0.0), lane(1.0))
    sk = tk.tree_split(*args)
    st = tk.tree_split_twin(h.double(), t.double(), fmask, splits,
                            *(a.double() for a in args[4:]))
    par = t[..., 1].double() ** 2 / (t[..., 2].double() + 1.0)
    tol = 1e-5 * (st["gain"].abs() + par) + 1e-6
    fin = torch.isfinite(st["gain"])
    assert torch.equal(fin, torch.isfinite(sk["gain"]))
    assert bool(((sk["gain"].double() - st["gain"]).abs()[fin]
                 <= tol[fin]).all())
    clear = tk.split_gap(h.double(), t.double(), fmask, lane(10.0).double(),
                         lane(1.0).double()) > 1e-4 * st["gain"].abs() + tol
    assert bool(clear.any())
    for key in ("feature", "bin", "threshold"):
        assert torch.equal(sk[key][clear], st[key][clear]), key
    # gini: integer counts, exact sums
    gini = torch.as_tensor(np.stack([w, w * (1 - y), w * y], axis=2).astype(
        np.float32), device=cuda)
    h, t = tk.tree_hist(B, rn, gini, P - 1, P, n_bins, node_mask=mask)
    args = (h, t, fmask, mask, splits, lane(10.0), lane(0.0))
    sk, st = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
    scale = tk.wgini(t)
    fin = torch.isfinite(st["gain"])
    assert torch.equal(fin, torch.isfinite(sk["gain"]))
    assert bool(((sk["gain"] - st["gain"]).abs()[fin]
                 <= 1e-6 * scale[fin]).all())
    clear = tk.split_gap_gini(h, t, fmask, mask, lane(10.0)) > 1e-5 * scale
    assert bool(clear.any())
    for key in ("feature", "bin", "is_leaf", "threshold"):
        assert torch.equal(sk[key][clear], st[key][clear]), key
    # variance: (w, w·y, w·y²) against the twin on the f64 histogram
    var = torch.as_tensor(np.stack([w, w * yr, w * yr * yr], axis=2).astype(
        np.float32), device=cuda)
    h, t = tk.tree_hist(B, rn, var, P - 1, P, n_bins, node_mask=mask)
    args = (h, t, fmask, mask, splits, lane(10.0), lane(0.001))
    sk = tk.tree_split_variance(*args)
    st = tk.tree_split_variance_twin(h.double(), t.double(), fmask, mask,
                                     splits, lane(10.0).double(),
                                     lane(0.001).double())
    tol = 1e-5 * t[..., 2].double() + 1e-6
    fin = torch.isfinite(st["gain"])
    assert torch.equal(fin, torch.isfinite(sk["gain"]))
    assert bool(((sk["gain"].double() - st["gain"]).abs()[fin]
                 <= tol[fin]).all())
    clear = tk.split_gap_variance(h.double(), t.double(), fmask, mask,
                                  lane(10.0).double()) > 2 * tol
    assert bool(clear.any())
    for key in ("feature", "bin", "threshold"):
        assert torch.equal(sk[key][clear], st[key][clear]), key


@pytest.mark.parametrize("hidden", [(256, 256), (900,)])
def test_loco_softmax_wide_and_deep_mlps_match_twin(cuda, hidden):
    """An MLP of ``hidden_layers=(256, 256)`` (its tail's weights read from
    device memory) and one of a single hidden layer of 900, 4 classes, 16
    groups: each listed diff within 1e-5 of the largest |diff| plus twice
    the plain f32 version's own largest error of the f64 diffs, the same
    bits twice."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models.linear import MLPClassificationModel
    rng = np.random.default_rng(12)
    N, D, G, C, k = 4_000, 48, 16, 4, 16
    X = rng.normal(size=(N, D)).astype(np.float32)
    cg = rng.permutation(np.arange(D) % G).astype(np.int32)
    Xd = torch.as_tensor(X, device=cuda)
    cgd = torch.as_tensor(cg, device=cuda)
    sizes = [D, *hidden, C]
    fitted = {"kind": "mlp", "n_layers": len(sizes) - 1, "n_classes": C}
    for i in range(len(sizes) - 1):
        fitted[f"W{i}"] = torch.as_tensor(rng.normal(
            scale=(2.0 / sizes[i]) ** 0.5, size=(sizes[i], sizes[i + 1]))
            .astype(np.float32), device=cuda)
        fitted[f"b{i}"] = torch.as_tensor(rng.normal(
            scale=0.1, size=sizes[i + 1]).astype(np.float32), device=cuda)
    model = MLPClassificationModel(fitted=fitted)
    plan = ik.loco_softmax_plan(N, D, G, k, hidden[0], C,
                                tuple(sizes[2:]))
    assert plan.tail_in_smem is (len(hidden) == 1)
    idx, val = ik.loco_softmax(Xd, model, cgd, G, k, "abs")
    idx2, val2 = ik.loco_softmax(Xd, model, cgd, G, k, "abs")
    assert torch.equal(idx, idx2) and torch.equal(val, val2)
    want = _softmax_diffs_f64(Xd, model, cgd, G)
    ti, tv = ik.loco_topk_twin(Xd, lambda Z: ik.loco_score(model, Z), cgd, G,
                               G, "abs")
    twin_err = float((tv.double() - torch.gather(want, 1, ti.long()))
                     .abs().max())
    tol = 1e-5 * float(want.abs().max()) + 2.0 * twin_err
    assert float((val.double() - torch.gather(want, 1, idx.long())).abs()
                 .max()) <= tol
    best = torch.sort(want.abs(), dim=1, descending=True).values[:, :k]
    assert float((val.double().abs() - best).abs().max()) <= tol


@pytest.mark.parametrize("hidden", [(2048,), (64, 2048)])
def test_loco_softmax_slots_in_device_memory_match_twin(cuda, hidden):
    """Layers too wide for one warp's slots in shared memory (the slots in
    the device-memory scratch): 1,000 x 16 rows, 4 classes, one group a
    column, top-5; each listed diff within 1e-5 of the largest |diff| of
    the twin's diff of that group (the kernels' rule: the kernel removes a
    group's first-layer share from the row's dot product, the twin sums the
    masked row, and 2,048 hidden units carry that rounding into the
    logits), the ranks at each place within the same, the same bits
    twice."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models.linear import MLPClassificationModel
    rng = np.random.default_rng(16)
    N, D, C, k = 1_000, 16, 4, 5
    G = D
    Xd = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                         device=cuda)
    cgd = torch.arange(D, dtype=torch.int32, device=cuda)
    sizes = [D, *hidden, C]
    fitted = {"kind": "mlp", "n_layers": len(sizes) - 1, "n_classes": C}
    for i in range(len(sizes) - 1):
        fitted[f"W{i}"] = torch.as_tensor(rng.normal(
            scale=(2.0 / sizes[i]) ** 0.5, size=(sizes[i], sizes[i + 1]))
            .astype(np.float32), device=cuda)
        fitted[f"b{i}"] = torch.as_tensor(rng.normal(
            scale=0.1, size=sizes[i + 1]).astype(np.float32), device=cuda)
    model = MLPClassificationModel(fitted=fitted)
    assert ik.loco_softmax_plan(N, D, G, k, hidden[0], C,
                                tuple(sizes[2:])).scratch_floats > 0
    kernels.reset_launch_counts()
    idx, val = ik.loco_softmax(Xd, model, cgd, G, k, "abs")
    idx2, val2 = ik.loco_softmax(Xd, model, cgd, G, k, "abs")
    assert kernels.launch_counts()["loco_softmax"] == 2
    assert torch.equal(idx, idx2) and torch.equal(val, val2)
    ti, tv = ik.loco_topk_twin(Xd, lambda Z: ik.loco_score(model, Z), cgd, G,
                               G, "abs")
    full = torch.empty((N, G), dtype=torch.float32, device=cuda)
    full.scatter_(1, ti.long(), tv)
    tol = 1e-5 * float(tv.abs().max())
    assert float((val - torch.gather(full, 1, idx.long())).abs().max()) \
        <= tol
    assert float((val.abs() - tv[:, :k].abs()).abs().max()) <= tol


@pytest.mark.parametrize("lanes", [60, 300])
def test_tree_hist_forest_levels_match_twin(cuda, lanes):
    """A forest level of 60 and 300 lanes (P = 32, Poisson x fold weights,
    integer gini counts, 5-of-28 node subsets): the full and the masked
    histogram equal the f64 twin cell for cell, 60 lanes a twin call; the
    masked one equals the full one on the kept cells and is zero elsewhere,
    with the same totals; one launch each."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(60 + lanes)
    N, D, P, nb = 40_000, 28, 32, 32
    B = torch.as_tensor(rng.integers(0, nb, size=(N, D)).astype(np.int8),
                        device=cuda)
    w = rng.poisson(1.0, size=(lanes, N)) * (rng.random((lanes, N)) > 0.33)
    y = rng.random(N) < 0.4
    stats = torch.as_tensor(np.stack([w, w * ~y, w * y], axis=2).astype(
        np.float32), device=cuda)
    rn = torch.as_tensor(rng.integers(25, 63, size=(lanes, N)).astype(
        np.int32), device=cuda)
    m = np.zeros((lanes, P, D), bool)
    for k in range(lanes):
        for p in range(P):
            m[k, p, rng.choice(D, 5, replace=False)] = True
    mask = torch.as_tensor(m, device=cuda)
    kernels.reset_launch_counts()
    full = tk.tree_hist(B, rn, stats, 31, P, nb)
    masked = tk.tree_hist(B, rn, stats, 31, P, nb, node_mask=mask)
    assert kernels.launch_counts()["tree_hist"] == 2
    assert torch.equal(full[1], masked[1])
    assert torch.equal(masked[0], torch.where(mask[..., None, None], full[0],
                                              0.0))
    for a in range(0, lanes, 60):
        sl = slice(a, a + 60)
        for got, nm in ((full, None), (masked, mask[sl])):
            want = tk.tree_hist_twin(B, rn[sl], stats[sl].double(), 31, P,
                                     nb, node_mask=nm)
            assert torch.equal(got[0][sl].double(), want[0])
            assert torch.equal(got[1][sl].double(), want[1])


# --------------------------------------------------------------------------
# tree_hist_deep's partition and group histograms; tree_walk's plans
# --------------------------------------------------------------------------

def _deep_case(cuda, N, D, K, P, S, nb, masked, seed, counts=True):
    """A deep level: bins, Poisson x held-out weights (integer counts, or
    normal statistics), rows over the level with some parked above, and
    5-feature node subsets."""
    rng = np.random.default_rng(seed)
    B = torch.as_tensor(rng.integers(0, nb, size=(N, D)).astype(np.int8),
                        device=cuda)
    w = rng.poisson(1.0, size=(K, N)) * (rng.random((K, N)) > 0.33)
    if counts:
        y = rng.integers(0, S - 1, size=N)
        st = np.concatenate([w[..., None], w[..., None] * np.eye(S - 1)[y]],
                            axis=2)
    else:
        st = rng.normal(size=(K, N, S)) * w[..., None]
    rn = rng.integers(max(0, P - 1 - P // 8), 2 * P - 1, size=(K, N))
    mask = None
    if masked:
        m = np.zeros((K, P, D), bool)
        for k in range(K):
            for p in range(P):
                m[k, p, rng.choice(D, min(5, D), replace=False)] = True
        mask = torch.as_tensor(m, device=cuda)
    return (B, torch.as_tensor(rn.astype(np.int32), device=cuda),
            torch.as_tensor(st.astype(np.float32), device=cuda), mask)


@pytest.mark.parametrize("N,D,K,P,S,nb,masked,groups,counts", [
    (60_000, 28, 40, 1024, 3, 32, True, None, True),    # R = 1: no zero-fill
    (60_000, 28, 1, 512, 3, 32, False, None, False),    # R > 1: skewed rows
    (30_000, 8, 2, 256, 41, 32, False, None, True),     # 40 classes
    (30_000, 8, 2, 2048, 41, 32, True, None, True),     # deep totals too
    (20_000, 4, 1, 256, 300, 127, False, None, True),   # statistic chunks
    (30_000, 28, 3, 512, 3, 32, True, 4, True),         # node windows
    (40_000, 1597, 2, 256, 3, 32, False, None, False),  # feature chunks
])
def test_tree_hist_deep_plans_match_twin(cuda, monkeypatch, N, D, K, P, S,
                                         nb, masked, groups, counts):
    """``tree_hist_deep`` along each branch of ``hist_deep_plan`` and of the
    launch's split (R > 1 where three nodes hold most rows): integer
    counts equal to the f64 twin, other statistics within 1e-5 of each
    cell's mass; cells outside a node's subset 0; totals only as well."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    if groups:
        monkeypatch.setattr(tk, "HIST_DEEP_MAX_GROUPS", groups)
    B, rn, st, mask = _deep_case(cuda, N, D, K, P, S, nb, masked, P + S,
                                 counts)
    if K == 1:              # most rows in three nodes, as in a real level
        monkeypatch.setattr(tk, "HIST_DEEP_MIN_ROWS", 1024)
        rn[:, : N * 3 // 4] = P - 1 + torch.arange(N * 3 // 4,
                                                   device=cuda)[None] % 3
    width = int(mask.sum(dim=2).amax()) if masked else None
    plan = tk.hist_plan(N, D, K, P, nb, S, True, width,
                        8 if tk.hist_scale(st).fixed else 4)
    assert plan["route"] == "deep"
    if groups:
        assert plan["windows"] > 1
    for with_hist in (True, False):
        kernels.reset_launch_counts()
        h, t = tk.tree_hist(B, rn, st, P - 1, P, nb, with_hist,
                            mask if with_hist else None)
        launches = kernels.launch_counts()["tree_hist_deep"]
        if with_hist:
            assert launches == plan["windows"]
        ht, tt = tk.tree_hist_twin(B, rn, st.double(), P - 1, P, nb,
                                   with_hist, mask if with_hist else None)
        if counts:
            assert torch.equal(t.double(), tt)
        else:
            mt = tk.tree_hist_twin(B, rn, st.double().abs(), P - 1, P, nb,
                                   False)[1]
            assert bool(((t.double() - tt).abs() <= 1e-5 + 1e-5 * mt).all())
        if not with_hist:
            continue
        if counts:
            assert torch.equal(h.double(), ht)
        else:
            mh = tk.tree_hist_twin(B, rn, st.double().abs(), P - 1, P, nb,
                                   node_mask=mask)[0]
            assert bool(((h.double() - ht).abs() <= 1e-5 + 1e-5 * mh).all())
        if masked:
            assert bool((h[~mask] == 0).all())


def _walk_trees(cuda, Tr, depth, D, V, seed):
    rng = np.random.default_rng(seed)
    T = 2 ** (depth + 1) - 1
    feat = rng.integers(0, D, (Tr, T)).astype(np.int32)
    thr = rng.normal(scale=0.7, size=(Tr, T)).astype(np.float32)
    leafm = np.zeros((Tr, T), bool)
    leafm[:, 2 ** depth - 1:] = True
    leafm[:, 2] = True
    thr[:, 4] = np.inf
    thr[:, 5] = 1e30
    feat[leafm] = -1
    vals = rng.normal(size=(Tr, T, V)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=cuda)
                 for a in (feat, thr, leafm, vals))


@pytest.mark.parametrize("N,D,Tr,members,depth,V,op", [
    (50_000, 28, 20, 1, 3, 1, "sum"),       # GBT 20 x d3
    (50_000, 28, 20, 1, 6, 2, "mean"),      # RF 20 x d6
    (20_000, 28, 50, 1, 12, 2, "mean"),     # RF member 50 x d12: top levels
    (20_000, 28, 6, 6, 12, 1, "sum"),       # GBT margins: 6 lanes x 1 tree
    (30_000, 16, 60, 3, 6, 6, "sum"),       # V = 6: two leaf chunks
    (5_000, 1597, 20, 2, 5, 2, "mean"),     # wide X: gathered
    (2_000, 28, 8_000, 1, 2, 1, "sum"),     # too many trees to stage
    (777, 28, 20, 1, 6, 2, "mean"),         # a ragged last block
])
def test_tree_walk_plans_match_twin_and_repeat(cuda, N, D, Tr, members,
                                               depth, V, op):
    """``tree_walk`` along each branch of ``walk_plan`` (X staged or
    gathered, trees staged whole, by their top levels or not at all, one
    or two leaf chunks): within 1e-6 of the twin (which sums in the same
    tree order) and the same bits on two launches."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(N + Tr)
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=cuda)
    trees = _walk_trees(cuda, Tr, depth, D, V, depth + Tr)
    a = tk.tree_walk(X, *trees, depth + 1, members, op)
    b = tk.tree_walk(X, *trees, depth + 1, members, op)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a, tk.tree_walk_twin(X, *trees, depth + 1, members, op),
        rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# tree_route in place and the xgb split bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [28, 1597])
@pytest.mark.parametrize("K", [1, 6, 150, 300])
def test_tree_route_in_place_matches_twin(cuda, K, D):
    """``tree_route`` along both branches of ``route_plan`` (B's row tiles
    staged at 28 features, gathered at 1,597) at 1, 6, 150 and 300 lanes
    and a ragged last tile: in place (the same tensor back), equal to the
    twin run on a copy of the ids — rows under leaves, above and below the
    level left as they are — and the same bits on a second launch."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(K + D)
    N = 40_001 if D == 28 else 6_001
    P, off = 32, 31
    B = torch.as_tensor(rng.integers(0, 32, size=(N, D)).astype(np.int8),
                        device=cuda)
    rn = torch.as_tensor(rng.integers(off - 16, off + P + 16, size=(K, N))
                         .astype(np.int32), device=cuda)
    feat = torch.as_tensor(rng.integers(0, D, size=(K, P)).astype(np.int32),
                           device=cuda)
    bin_ = torch.as_tensor(rng.integers(0, 31, size=(K, P)).astype(np.int32),
                           device=cuda)
    leaf = torch.as_tensor(rng.random((K, P)) < 0.2, device=cuda)
    assert tk.route_plan(N, D, K)["stage"] is (D == 28)
    want = tk.tree_route_twin(B, rn, feat, bin_, leaf, off)
    a, b = rn.clone(), rn.clone()
    assert tk.tree_route(B, a, feat, bin_, leaf, off) is a
    tk.tree_route(B, b, feat, bin_, leaf, off)
    assert torch.equal(a, want) and torch.equal(b, want)
    assert bool((want != rn).any()) and bool((want == rn).any())


def _xgb_split_inputs(cuda, rng, K, P, D, NB, N=20_000, dup=(), heavy=0):
    """A level's histograms from rows (``tree_hist`` on the card): bins of
    a normal matrix (column j a copy of column i for each (i, j) in
    ``dup``, the label hanging on the last copy), fractional non-negative
    weights (0, 0.5, 1, 1.25) and margins p of 0.25, 0.5, 0.75 (so every
    cell sums exactly in any order: the copies tie exactly), rows over the
    level's P nodes with a quarter
    of its width parked above (``heavy`` > 0: three quarters of them in
    ``heavy`` nodes, so most nodes hold a few rows or none)."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import binned
    X = rng.normal(size=(N, D)).astype(np.float32)
    for i, j in dup:
        X[:, j] = X[:, i]
    lab = X[:, dup[-1][1]] if dup else X[:, 0]
    y = (lab + 0.5 * rng.normal(size=N) > 0).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    _, splits, B = binned(Xd, Xd, NB)
    off = P - 1
    rn = rng.integers(max(0, off - P // 4 - 1), off + P, size=(K, N))
    if heavy:
        hv = off + rng.choice(P, heavy, replace=False)
        rn = np.where(rng.random((K, N)) < 0.75,
                      hv[rng.integers(0, heavy, size=(K, N))], rn)
    w = rng.choice(np.asarray([0.0, 0.5, 1.0, 1.25], np.float32), size=(K, N))
    p = rng.choice(np.asarray([0.25, 0.5, 0.75], np.float32), size=(K, N))
    st = np.stack([w, w * (p - y), w * p * (1 - p)], axis=2).astype(
        np.float32)
    h, t = tk.tree_hist(B, torch.as_tensor(rn.astype(np.int32), device=cuda),
                        torch.as_tensor(st, device=cuda), off, P, NB)
    return h, t, splits


@pytest.mark.parametrize("K,P,D,NB,dup,heavy", [
    (3, 4, 28, 32, ((3, 20),), 0),          # a depth-3 level, a lane tie
    (6, 2048, 28, 32, (), 8),               # level 11, rows in 8 nodes
    (2, 1, 1597, 32, ((100, 1500),), 0),    # 8 warps a node, a chunk tie
    (2, 2, 40, 32, ((5, 37),), 0),          # two warps a node
    (3, 4, 8, 127, (), 0),                  # 127 bins
    (12, 16, 28, 64, ((0, 27),), 0),        # 64 bins
])
def test_tree_split_bit_equal_to_twin(cuda, K, P, D, NB, dup, heavy):
    """``tree_split`` gives the twin's bits in every output, the same on a
    second launch: exact ties across lanes and across a node's warps go to
    the lowest feature, nodes under 2·min_instances (a lane at 100,000:
    all of its nodes; most nodes of the skewed level) and empty nodes are
    leaves with
    gain -inf, feature 0, bin 0, at 32, 64 and 127 bins and 1,597
    features."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(K * P + D + NB)
    h, t, splits = _xgb_split_inputs(cuda, rng, K, P, D, NB, dup=dup,
                                     heavy=heavy)
    mi = torch.tensor([[1.0, 1e5, 10.0, 100.0][k % 4] for k in range(K)],
                      device=cuda)
    mg = torch.tensor([[0.0, 0.001, 0.1][k % 3] for k in range(K)],
                      device=cuda)
    lam = torch.ones(K, device=cuda)
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    fmask[D // 2] = D < 100
    args = (h, t, fmask, splits, mi, mg, lam)
    a, b, want = tk.tree_split(*args), tk.tree_split(*args), \
        tk.tree_split_twin(*args)
    for key in want:
        assert torch.equal(a[key], want[key]), key
        assert torch.equal(b[key], want[key]), key
    under = t[..., 0] < 2 * mi[:, None]
    assert bool(under.any())
    assert bool(torch.isinf(a["gain"][under]).all())
    assert bool((a["feature"][under] == 0).all())
    assert bool(torch.isfinite(a["gain"]).any())
    for i, j in dup:
        assert not bool((a["feature"] == j).any())
        assert bool((a["feature"] == i).any())


@pytest.mark.parametrize("K,P,D,NB", [(6, 4, 28, 32), (6, 2048, 28, 32),
                                      (2, 64, 5000, 4)])
def test_tree_split_epilogue_matches_the_bookkeeping(cuda, K, P, D, NB):
    """With fit_trees' tree arrays (random gain sums; at 5,000 features the
    gain kernel's threads take 20 groups of 256 features; 2,048 nodes are
    two of its windows) the kernel writes the level's slices and adds the
    split nodes' gains as ``write_level_twin`` does on the CPU from the
    same split: the same bits, twice in a row."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(P + D)
    h, t, splits = _xgb_split_inputs(cuda, rng, K, P, D, NB,
                                     N=20_000 if D < 100 else 2_000,
                                     heavy=8 if P > 64 else 0)
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    args = (h, t, fmask, splits, lane(1.0), lane(0.0), lane(1.0))
    off, T = P - 1, 4 * P - 1
    tree = (torch.full((K, T), -1, dtype=torch.int32, device=cuda),
            torch.full((K, T), float("inf"), device=cuda),
            torch.zeros((K, T), dtype=torch.bool, device=cuda),
            torch.zeros((K, T, 1), device=cuda),
            torch.as_tensor(rng.random((K, D)).astype(np.float32),
                            device=cuda))
    ref = tuple(x.cpu() for x in tree)
    for _ in range(2):
        out = tk.tree_split(*args, tree=tree, offset=off)
        tk.write_level_twin({k: v.cpu() for k, v in out.items()}, ref, off)
        for name, x, r in zip(("feature", "threshold", "is_leaf", "leaf",
                               "gain"), tree, ref):
            assert torch.equal(x.cpu(), r), name
    assert int((~out["is_leaf"]).sum()) > 1


def _gini_split_inputs(cuda, rng, K, P, D, NB, C, sub, n=24):
    """A gini level's histograms built on the card: every node's n rows
    with weights 0, 0.5, 1, 1.25 or 2 (every sum exact in f32, in any
    order) and classes, bins per feature, the totals their sums; a fifth
    of the nodes empty; node subsets of ``sub`` features (None: all)."""
    g = torch.Generator(device=cuda).manual_seed(int(rng.integers(1 << 30)))
    ws = torch.tensor([0.0, 0.5, 1.0, 1.25, 2.0], device=cuda)
    w = ws[torch.randint(0, 5, (K, P, n), generator=g, device=cuda)]
    w = w * (torch.rand((K, P, 1), generator=g, device=cuda) >= 0.2)
    y = torch.randint(0, C, (K, P, n), generator=g, device=cuda)
    st = torch.cat([w[..., None], w[..., None] * torch.nn.functional.one_hot(
        y, C).float()], dim=-1)                         # [K, P, n, S]
    bins = torch.randint(0, NB, (K, P, n, D), generator=g, device=cuda)
    node = torch.arange(K * P, device=cuda).reshape(K, P, 1, 1)
    cell = (node * D + torch.arange(D, device=cuda)) * NB + bins
    hist = torch.zeros((K * P * D * NB, C + 1), device=cuda)
    hist.index_add_(0, cell.reshape(-1), st[:, :, :, None, :].expand(
        K, P, n, D, C + 1).reshape(-1, C + 1))
    tot = st.sum(dim=2)
    splits = torch.sort(torch.randn((D, NB - 1), generator=g, device=cuda),
                        dim=1).values.contiguous()
    mask = None
    if sub is not None:
        keys = torch.rand((K, P, D), generator=g, device=cuda)
        mask = torch.zeros((K, P, D), dtype=torch.bool, device=cuda)
        mask.scatter_(2, torch.topk(keys, sub, dim=2).indices, True)
    return hist.reshape(K, P, D, NB, C + 1), tot.contiguous(), splits, mask


@pytest.mark.parametrize("K,P,D,NB,C,sub", [
    (60, 32, 28, 32, 2, 5),         # a forest level 5: W = 2, 8 bins a lane
    (150, 2048, 28, 32, 2, 5),      # the default grid's RF level 11
    (150, 1, 28, 32, 2, 5),         # the root: 8 warps a node
    (6, 64, 16, 32, 4, 4),          # the multiclass workload's 4 classes
    (3, 4, 28, 32, 40, None),       # 40 classes: 5 class chunks
    (4, 16, 9, 127, 2, None),       # 127 bins
    (2, 2, 1597, 32, 6, 40),        # 1,597 features, 6 classes
    (3, 8, 12, 2, 3, None),         # 2 bins: one split point
])
def test_tree_split_gini_bit_equal_to_twin(cuda, K, P, D, NB, C, sub):
    """``tree_split_gini`` gives the twin's bits in every output — the bin
    prefix in blocks of 16, the class squares in class order — on
    fractional weights, and the same on a second launch, at the measured
    shapes; nodes under 2·min_instances and empty nodes are leaves with
    gain -inf, feature 0, bin 0."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(K + P + D + NB + C)
    h, t, splits, mask = _gini_split_inputs(cuda, rng, K, P, D, NB, C, sub)
    mi = torch.tensor([[1.0, 1e5, 10.0, 0.0][k % 4] for k in range(K)],
                      device=cuda)
    mg = torch.tensor([[0.0, 0.001, 0.1][k % 3] for k in range(K)],
                      device=cuda)
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    fmask[D // 2] = D < 3
    args = (h, t, fmask, mask, splits, mi, mg)
    a, b = tk.tree_split_gini(*args), tk.tree_split_gini(*args)
    for k0 in range(0, K, 16):
        sl = slice(k0, k0 + 16)
        want = tk.tree_split_gini_twin(h[sl], t[sl], fmask,
                                       None if mask is None else mask[sl],
                                       splits, mi[sl], mg[sl])
        for key in want:
            assert torch.equal(a[key][sl], want[key]), key
            assert torch.equal(b[key][sl], want[key]), key
    under = t[..., 0] < 2 * mi[:, None]
    assert bool(under.any())
    assert bool(torch.isinf(a["gain"][under]).all())
    assert bool((a["feature"][under] == 0).all())
    assert bool(torch.isfinite(a["gain"]).any())


@pytest.mark.parametrize("K,P,D,NB,C,sub", [(60, 32, 28, 32, 2, 5),
                                            (150, 2048, 28, 32, 2, 5),
                                            (6, 64, 16, 32, 4, 4),
                                            (2, 64, 300, 32, 40, None)])
def test_tree_split_gini_epilogue_matches_the_bookkeeping(cuda, K, P, D, NB,
                                                          C, sub):
    """With fit_trees' tree arrays (random gain sums; 2,048 nodes are two
    windows of the gain walk) the kernel writes the level's feature,
    threshold, is_leaf and class shares and adds the split nodes' gains as
    ``write_level_twin`` does on the CPU from the same split and totals:
    the same bits, twice in a row."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(P + D + C)
    h, t, splits, mask = _gini_split_inputs(cuda, rng, K, P, D, NB, C, sub)
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    args = (h, t, fmask, mask, splits, lane(1.0), lane(0.0))
    off, T = P - 1, 4 * P - 1
    tree = (torch.full((K, T), -1, dtype=torch.int32, device=cuda),
            torch.full((K, T), float("inf"), device=cuda),
            torch.zeros((K, T), dtype=torch.bool, device=cuda),
            torch.zeros((K, T, C), device=cuda),
            torch.as_tensor(rng.random((K, D)).astype(np.float32),
                            device=cuda))
    ref = tuple(x.cpu() for x in tree)
    for _ in range(2):
        out = tk.tree_split_gini(*args, tree=tree, offset=off)
        tk.write_level_twin({**{k: v.cpu() for k, v in out.items()},
                             "value": tk.gini_leaf(t).cpu()}, ref, off)
        for name, x, r in zip(("feature", "threshold", "is_leaf", "leaf",
                               "gain"), tree, ref):
            assert torch.equal(x.cpu(), r), name
    assert int((~out["is_leaf"]).sum()) > 1


def _variance_split_inputs(cuda, rng, K, P, D, NB, sub, n=40):
    """A variance level built on the card: n rows a node of fractional
    weights w and real labels y, stats (w, w·y, w·y²), bins per feature,
    the totals their sums; a fifth of the nodes empty; node subsets of
    ``sub`` features (None: all)."""
    g = torch.Generator(device=cuda).manual_seed(int(rng.integers(1 << 30)))
    ws = torch.tensor([0.0, 0.5, 1.0, 1.25, 2.0], device=cuda)
    w = ws[torch.randint(0, 5, (K, P, n), generator=g, device=cuda)]
    w = w * (torch.rand((K, P, 1), generator=g, device=cuda) >= 0.2)
    y = 3.0 + 2.0 * torch.randn((K, P, n), generator=g, device=cuda)
    st = torch.stack([w, w * y, w * y * y], dim=-1)          # [K, P, n, 3]
    bins = torch.randint(0, NB, (K, P, n, D), generator=g, device=cuda)
    node = torch.arange(K * P, device=cuda).reshape(K, P, 1, 1)
    cell = (node * D + torch.arange(D, device=cuda)) * NB + bins
    hist = torch.zeros((K * P * D * NB, 3), device=cuda)
    hist.index_add_(0, cell.reshape(-1), st[:, :, :, None, :].expand(
        K, P, n, D, 3).reshape(-1, 3))
    tot = st.sum(dim=2)
    splits = torch.sort(torch.randn((D, NB - 1), generator=g, device=cuda),
                        dim=1).values.contiguous()
    mask = None
    if sub is not None:
        keys = torch.rand((K, P, D), generator=g, device=cuda)
        mask = torch.zeros((K, P, D), dtype=torch.bool, device=cuda)
        mask.scatter_(2, torch.topk(keys, sub, dim=2).indices, True)
    return hist.reshape(K, P, D, NB, 3), tot.contiguous(), splits, mask


@pytest.mark.parametrize("K,P,D,NB,sub", [
    (300, 32, 16, 32, 5),           # an RF regressor's level 5, 300 lanes
    (150, 2048, 16, 32, 5),         # the depth-12 group's level 11
    (150, 1, 16, 32, 5),            # the root: 8 warps a node
    (6, 64, 16, 32, None),          # GBT-like: every feature
    (60, 32, 16, 64, 5),            # max_bins=64
    (4, 16, 9, 127, None),          # 127 bins
    (2, 2, 1597, 32, 40),           # 1,597 features
    (3, 8, 12, 2, None),            # 2 bins: one split point
])
def test_tree_split_variance_bit_equal_to_twin(cuda, K, P, D, NB, sub):
    """``tree_split_variance`` (the gini body with the variance impurity)
    gives the f32 twin's bits in every output — the bin prefix in blocks of
    16, ``_gain_variance``'s order — on fractional weights and real labels,
    and the same on a second launch; nodes under 2·min_instances and empty
    nodes are leaves with gain -inf, feature 0, bin 0."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(K + P + D + NB)
    h, t, splits, mask = _variance_split_inputs(cuda, rng, K, P, D, NB, sub)
    mi = torch.tensor([[1.0, 1e5, 10.0, 0.0][k % 4] for k in range(K)],
                      device=cuda)
    mg = torch.tensor([[0.0, 0.001, 0.1][k % 3] for k in range(K)],
                      device=cuda)
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    fmask[D // 2] = D < 3
    args = (h, t, fmask, mask, splits, mi, mg)
    kernels.reset_launch_counts()
    a, b = tk.tree_split_variance(*args), tk.tree_split_variance(*args)
    assert kernels.launch_counts()["tree_split_variance"] == 2
    for k0 in range(0, K, 16):
        sl = slice(k0, k0 + 16)
        want = tk.tree_split_variance_twin(
            h[sl], t[sl], fmask, None if mask is None else mask[sl], splits,
            mi[sl], mg[sl])
        for key in want:
            assert torch.equal(a[key][sl], want[key]), key
            assert torch.equal(b[key][sl], want[key]), key
    under = t[..., 0] < 2 * mi[:, None]
    assert bool(under.any())
    assert bool(torch.isinf(a["gain"][under]).all())
    assert bool(torch.isfinite(a["gain"]).any())


@pytest.mark.parametrize("K,P,D,NB,sub", [(300, 32, 16, 32, 5),
                                          (150, 2048, 16, 32, 5),
                                          (6, 64, 16, 32, None)])
def test_tree_split_variance_epilogue_matches_the_bookkeeping(cuda, K, P, D,
                                                              NB, sub):
    """With fit_trees' tree arrays the variance kernel writes the level's
    feature, threshold, is_leaf and mean label and adds the split nodes'
    gains as ``write_level_twin`` does on the CPU from the same split and
    totals: the same bits, twice in a row."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rng = np.random.default_rng(P + D + 7)
    h, t, splits, mask = _variance_split_inputs(cuda, rng, K, P, D, NB, sub)
    lane = lambda v: torch.full((K,), v, device=cuda)   # noqa: E731
    fmask = torch.ones(D, dtype=torch.bool, device=cuda)
    args = (h, t, fmask, mask, splits, lane(1.0), lane(0.0))
    off, T = P - 1, 4 * P - 1
    tree = (torch.full((K, T), -1, dtype=torch.int32, device=cuda),
            torch.full((K, T), float("inf"), device=cuda),
            torch.zeros((K, T), dtype=torch.bool, device=cuda),
            torch.zeros((K, T, 1), device=cuda),
            torch.as_tensor(rng.random((K, D)).astype(np.float32),
                            device=cuda))
    ref = tuple(x.cpu() for x in tree)
    for _ in range(2):
        out = tk.tree_split_variance(*args, tree=tree, offset=off)
        tk.write_level_twin({**{k: v.cpu() for k, v in out.items()},
                             "value": tk.variance_leaf(t).cpu()}, ref, off)
        for name, x, r in zip(("feature", "threshold", "is_leaf", "leaf",
                               "gain"), tree, ref):
            assert torch.equal(x.cpu(), r), name
    assert int((~out["is_leaf"]).sum()) > 1


def test_fit_trees_gini_on_the_card_equals_the_cpu(cuda):
    """A depth-9 gini fit of 6 lanes with node subsets (deep levels take
    ``tree_hist_deep``) on the card gives the CPU twins' tree arrays bit
    for bit (integer weights: the histograms are exact in any order), and
    ``fit_trees`` launches one ``tree_split_gini`` a level."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import trees as pt
    rng = np.random.default_rng(9)
    N, D, NB, K, depth = 30_000, 8, 32, 6, 9
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=N) > 0).astype(np.int64)
    splits = pt.build_bin_splits(X, NB)
    w = rng.poisson(1.0, size=(K, N)).astype(np.float32)
    st = np.stack([w, w * (y == 0), w * (y == 1)], axis=2).astype(np.float32)
    masks = [np.argsort(rng.random((K, 1 << lvl, D)), axis=2) < 3
             for lvl in range(depth)]
    kw = dict(max_depth=depth, n_bins=NB, impurity="gini")
    fits = []
    for dev in (cuda, "cpu"):
        B = pt.bin_data(torch.as_tensor(X, device=dev),
                        torch.as_tensor(splits, device=dev))
        kernels.reset_launch_counts()
        fits.append(pt.fit_trees(
            B, torch.as_tensor(splits, device=dev),
            torch.as_tensor(st, device=dev),
            torch.ones(D, dtype=torch.bool, device=dev),
            min_instances=torch.full((K,), 5.0, device=dev),
            min_gain=torch.zeros(K, device=dev),
            node_masks=[torch.as_tensor(m, device=dev) for m in masks], **kw))
        if dev is cuda:
            assert kernels.launch_counts()["tree_split_gini"] == depth
    for a, b, name in zip(*fits, pt.TreeArrays._fields):
        assert torch.equal(a.cpu(), b), name


# --------------------------------------------------------------------------
# save on the card, load on the card and on the CPU
# --------------------------------------------------------------------------

def _bundle_case(case, device):
    """(trained model, fresh batch) of a small port workflow on ``device``:
    the dense GBT winner, the transmog LR or the sparse-text LR."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import sparse_reference as sr
    import transmog_reference as tr
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, ModelCandidate, grid)
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow
    port = "transmogrifai_tpu_torch"
    n = 3000
    if case == "transmog":
        cols, schema = tr.columns(port, n)
        wf, _, _ = tr.build(port, cols, schema, n, device=device)
        return wf.train(), ColumnBatch(tr.columns(port, n, seed=7)[0], n)
    if case == "sparse":
        wf, _, _ = sr.build(port, n, num_hashes=4096, device=device)
        return wf.train(), sr.raw_batch(port, [], n, seed=7)

    def dense(seed):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 6)).astype(np.float32)
        y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
        return ColumnBatch({"y": Column(RealNN, y), **{
            f"x{i}": Column(RealNN, X[:, i]) for i in range(6)}}, n)
    label = FeatureBuilder.RealNN("y").as_response()
    feats = [FeatureBuilder.RealNN(f"x{i}").as_predictor() for i in range(6)]
    sel = BinaryClassificationModelSelector(models=[ModelCandidate(
        OpGBTClassifier(), grid(max_iter=[5], max_depth=[4]),
        "OpGBTClassifier")])
    sel.set_input(label, transmogrify(feats))
    wf = Workflow(device=device).set_input_batch(dense(0))
    return wf.set_result_features(sel.get_output()).train(), dense(1)


def _scores(model, batch):
    (name,) = [f.name for f in model.result_features]
    return dict(model.score(batch)[name].values)


@pytest.mark.parametrize("case", ["dense_gbt", "transmog", "sparse"])
def test_saved_on_the_card_reloads_on_the_card_with_the_same_bits(
        cuda, case, tmp_path):
    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    model, fresh = _bundle_case(case, "cuda")
    want = _scores(model, fresh)
    model.save(str(tmp_path / "m"))
    loaded = WorkflowModel.load(str(tmp_path / "m"))
    assert loaded.device.type == "cuda"
    kernels.reset_launch_counts()
    got = _scores(loaded, fresh)
    need = {"dense_gbt": "tree_walk", "transmog": "hash_counts",
            "sparse": "sp_matmat"}[case]
    assert kernels.launch_counts()[need] >= 1
    (name,) = [f.name for f in loaded.result_features]
    eager = apply_dag(fresh.on("cuda"), loaded.fitted_dag)[name].values
    for k in want:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(eager[k], want[k]), k


@pytest.mark.parametrize("case", ["dense_gbt", "transmog", "sparse"])
def test_saved_on_the_card_loads_on_the_cpu_within_tolerance(cuda, case,
                                                            tmp_path):
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    model, fresh = _bundle_case(case, "cuda")
    want = {k: v.cpu().numpy() for k, v in _scores(model, fresh).items()}
    model.save(str(tmp_path / "m"))
    loaded = WorkflowModel.load(str(tmp_path / "m"), device="cpu")
    got = {k: v.numpy() for k, v in _scores(loaded, fresh).items()}
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-6)
    # a margin: 1e-6 absolute or 16 f32 ulps of the value, as across the
    # packages (tests/test_torch_persistence.py::assert_scores_close)
    raw = want["rawPrediction"]
    gap = np.abs(got["rawPrediction"].astype(np.float64) - raw)
    assert (gap <= np.maximum(1e-6, 16 * np.spacing(np.abs(raw)))).all(), \
        gap.max()


# serves a bundle on the card in a fresh process: argv[1] the checkpoint
# root, argv[2] a JSON file of records; prints the served rows, the columnar
# arrays of the first 16, the launches after warm-up and the engine's facts
_SERVE_FRESH = """
import json, sys, threading
import numpy as np
from transmogrifai_tpu_torch.models import kernels
from transmogrifai_tpu_torch.serving import ScoringEngine, wire
recs = json.load(open(sys.argv[2]))
eng = ScoringEngine(sys.argv[1], max_batch=16)
(name,) = [f.name for f in eng._entry.model.result_features]
kernels.reset_launch_counts()
out = [None] * len(recs)

def client(c):
    for i in range(c, len(recs), 8):
        out[i] = eng.score_record(recs[i], timeout_s=120)[0][name]
threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=300)
arrays, _ = eng.score_columns(wire.decode_batch(
    wire.encode_records(recs[:16]), eng.raw_features), timeout_s=120)
s = eng.stats()
print(json.dumps({
    "device": str(eng.device), "rows": out,
    "columnar": np.asarray(arrays[name + ".prediction"][0]).tolist(),
    "launches": kernels.launch_counts(), "counters": s["counters"],
    "compiled_path_active": s["compiled_path_active"],
    "bad": [e.action for e in eng.failure_log.events
            if e.action in ("degraded", "fallback", "dead_letter")]}))
eng.close()
"""


def test_serving_a_gbt_bundle_on_the_card_builds_nothing_online(cuda,
                                                                 tmp_path):
    """A small GBT bundle served on the card by a fresh process: its
    warm-up is what first loads ``tree_walk``'s library
    (``warmup_builds_total`` at least 1), and after it no kernel or native
    library is built or first loaded (``online_builds_total`` 0); every
    batch goes through the score program (``tree_walk`` launched), and the
    served scores equal the in-memory model's score of the same rows
    (predictions, probabilities within 1e-6)."""
    import json
    import os
    import subprocess
    import sys

    from transmogrifai_tpu_torch.checkpoint import next_version_dir
    model, fresh = _bundle_case("dense_gbt", "cuda")
    root = str(tmp_path / "ckpts")
    model.save(next_version_dir(root))
    want = {k: v.cpu().numpy() for k, v in _scores(model, fresh).items()}
    cols = {k: np.asarray(c.values) for k, c in fresh.items()}
    recs = [{k: float(v[i]) for k, v in cols.items()} for i in range(64)]
    rec_file = tmp_path / "records.json"
    rec_file.write_text(json.dumps(recs))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _SERVE_FRESH, root,
                          str(rec_file)], cwd=repo, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["device"].startswith("cuda")
    for i, r in enumerate(got["rows"]):
        assert r["prediction"] == want["prediction"][i]
        for j in range(2):
            assert abs(r[f"probability_{j}"]
                       - want["probability"][i, j]) <= 1e-6
    np.testing.assert_array_equal(got["columnar"], want["prediction"][:16])
    assert got["launches"]["tree_walk"] > 0
    assert got["counters"]["warmup_builds_total"] >= 1
    assert got["counters"]["online_builds_total"] == 0
    assert got["compiled_path_active"]
    assert got["counters"].get("fallback_batches_total", 0) == 0
    assert not got["bad"]
