"""The port's repaired faults, on the CPU: the selector's candidate-skip seam
(tree families on a ``SparseMatrix``), the launch plans that let
``tree_split`` / ``tree_split_gini`` take any number of features and the
forest kernels any number of classes, and the LOCO kernels' plans.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); here
the plans that size their launches are checked, the first-max rule across
feature chunks is emulated on the twin's gain table, and forests of 6 and
40 classes are held against the JAX package on the twins.

Tolerances: the sparse default selector's LR and SVC CV AuPRs within 1e-4
of the JAX package's (f32 sparse products in another order; the two
families' best AuPRs lie 0.04 apart), the same winner and NaN for every
tree-family row; the decision trees identical in structure with leaves at
rtol 1e-5 on every node a walk reaches, as ``tests/test_torch_forest.py``
and ``tests/test_torch_deep_trees.py`` hold binary ones.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu.models import trees as jt  # noqa: E402
from transmogrifai_tpu_torch import insights_kernels as ik  # noqa: E402
from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402
from transmogrifai_tpu_torch.models import trees as pt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import sparse_reference as sr  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
CPU = torch.device("cpu")


# --------------------------------------------------------------------------
# fault 1: the default selector on a SparseMatrix
# --------------------------------------------------------------------------

def _default_selector_run(pkg, rows=600, hashes=4096):
    F = sr._mod(pkg, "features")
    S = sr._mod(pkg, "selector")
    label = F.FeatureBuilder.RealNN("label").as_response()
    txt = F.FeatureBuilder.Text("txt").as_predictor()
    x0 = F.FeatureBuilder.Real("x0").as_predictor()
    fv = sr._mod(pkg, "ops.transmogrify").transmogrify([txt, x0],
                                                       num_hashes=hashes)
    sel = S.BinaryClassificationModelSelector()
    sel.set_input(label, fv)
    pred = sel.get_output()
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = sr._mod(pkg, "workflow").Workflow(**kw).set_result_features(pred)
    batch = sr.raw_batch(pkg, wf.raw_features, rows)
    return wf.set_input_batch(batch).train()


def _family_rows(summary):
    out = {}
    for r in summary.validation_results:
        out.setdefault(r.model_name, []).append(
            float(next(iter(r.metric_values.values()))))
    return out


@pytest.fixture(scope="module")
def sparse_default_runs():
    return {pkg: _default_selector_run(pkg) for pkg in (JAX, PORT)}


def test_default_selector_on_a_sparse_matrix_skips_the_tree_families(
        sparse_default_runs):
    jm, pm = sparse_default_runs[JAX], sparse_default_runs[PORT]
    assert type(sr.feature_matrix(PORT, pm, pm._input_batch)).__name__ == \
        "SparseMatrix"
    js, ps = jm.selected_model.summary, pm.selected_model.summary
    assert ps.best_model_name == js.best_model_name == "OpLogisticRegression"
    jrows, prows = _family_rows(js), _family_rows(ps)
    for fam in ("OpRandomForestClassifier", "OpGBTClassifier"):
        assert len(prows[fam]) == len(jrows[fam]) == 18
        assert np.isnan(prows[fam]).all() and np.isnan(jrows[fam]).all()
    for fam in ("OpLogisticRegression", "OpLinearSVC"):
        np.testing.assert_allclose(prows[fam], jrows[fam], atol=1e-4)
    # one "skipped" record per tree-family block: fold 0's screen of the
    # full grid, then the survivors on folds 1 and 2
    log = pm.selected_model.failure_log
    skipped = log.by_action("skipped")
    assert {e.stage for e in skipped} == {"OpRandomForestClassifier",
                                          "OpGBTClassifier"}
    assert len(skipped) == 4
    assert all("later slice" in e.cause for e in skipped)


class _Boom:
    """A candidate whose fit raises ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def fit_arrays_grid(self, X, y, W, grid):
        raise self.exc

    def set(self, k, v):
        return self


def _validate(candidates):
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.tuning import OpCrossValidation
    from transmogrifai_tpu_torch.types import OPVector, RealNN
    rng = np.random.default_rng(0)
    X = rng.normal(size=(90, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    batch = ColumnBatch({"y": Column(RealNN, y),
                         "v": Column(OPVector, torch.as_tensor(X))}, 90,
                        device="cpu")
    cv = OpCrossValidation(3, Evaluators.BinaryClassification.auPR())
    return cv.validate(candidates, batch, "y", "v")


def test_skip_seam_skips_only_the_reference_exceptions():
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.resilience import AllCandidatesFailed
    from transmogrifai_tpu_torch.tuning import ModelCandidate
    lr = ModelCandidate(OpLogisticRegression(max_iter=20), [{}], "LR")
    for exc in (NotImplementedError("no sparse"), TypeError("densify")):
        res = _validate([ModelCandidate(_Boom(exc), [{}, {}], "Boom"), lr])
        assert res.best.model_name == "LR"
        boom = [r for r in res.all_results if r.model_name == "Boom"]
        assert all(np.isnan(r.mean_metric) for r in boom)
        assert len(res.failure_log.by_action("skipped")) == 1
    with pytest.raises(ValueError, match="not a skip"):
        _validate([ModelCandidate(_Boom(ValueError("not a skip")), [{}],
                                  "Boom"), lr])
    with pytest.raises(AllCandidatesFailed, match="Boom: NotImplementedError"):
        _validate([ModelCandidate(_Boom(NotImplementedError("x")), [{}],
                                  "Boom")])


# --------------------------------------------------------------------------
# faults 2 and 3: the tree kernels' plans
# --------------------------------------------------------------------------

def test_split_plans_cover_any_width_and_class_count():
    # the gini and variance splits (gini_split_plan; the variance form at
    # C = 2): any width over W warps of fc features, the classes in chunks
    # of the smallest template that holds C
    for D in (28, 1597):
        v = tk.gini_split_plan(3, 4, D, 32, 2)
        assert (v["ct"], v["class_chunks"]) == (2, 1)
        assert v["W"] * v["fc"] >= D
    g6 = tk.gini_split_plan(3, 4, 1597, 32, 6)
    assert (g6["ct"], g6["class_chunks"]) == (8, 1)
    assert g6["W"] * g6["fc"] >= 1597
    g40 = tk.gini_split_plan(3, 4, 28, 32, 40)
    assert (g40["ct"], g40["class_chunks"]) == (8, 5)
    assert [tk.gini_split_plan(3, 4, 28, 32, c)["ct"]
            for c in (2, 3, 4, 5)] == [2, 4, 4, 8]
    # the deep histogram holds all S statistics of a forest of up to 40
    # classes in one block, and splits them only past one slot's room
    for S in (3, 7, 41):
        plan = tk.hist_deep_plan(1_000_000, 28, 150, 2048, 32, S, True, 5)
        assert (plan["Sc"], plan["NSC"]) == (S, 1)
    plan = tk.hist_deep_plan(1000, 4, 1, 256, 127, 300)
    assert (plan["Sc"], plan["NSC"]) == (150, 2)
    with pytest.raises(ValueError):
        tk.gini_split_plan(3, 4, 0, 32, 2)


def test_feature_chunks_keep_the_first_max_at_1597_features():
    """At D = 1,597 a shallow level's node spreads its features over the W
    warps of ``gini_split_plan`` (chunks of fc features).  The best gain
    sits at an exact tie across two chunks (features 100 and 1,500) and
    inside one (1,500 and 1,501): each chunk's first max, combined highest
    gain, then lowest feature, then lowest bin (``split_level.cuh``), picks
    feature 100, as the twin's argmax over the whole table and the JAX
    argmax over feature chunks do.  The variance split takes it too, on a
    histogram whose features 100 and 1,500 are the same."""
    D, NB = 1597, 4
    plan = tk.gini_split_plan(1, 2, D, NB, 2)
    assert plan["W"] > 1 and 100 // plan["fc"] != 1500 // plan["fc"]
    rng = np.random.default_rng(0)
    gains = torch.as_tensor(rng.random((1, 2, D, NB)).astype(np.float32))
    gains[..., NB - 1] = float("-inf")
    gains[0, 0, 100, 2] = gains[0, 0, 1500, 1] = gains[0, 0, 1501, 0] = 5.0
    gains[0, 1, 1500, 1] = gains[0, 1, 1501, 0] = 6.0
    table = gains.reshape(1, 2, D * NB)

    def chunked(g):
        best = [(float("-inf"), 0, 0)] * g.shape[1]
        for c in range(plan["W"]):
            lo, hi = c * plan["fc"], min(D, (c + 1) * plan["fc"])
            sub = g[:, :, lo:hi].reshape(1, g.shape[1], -1)
            cidx = torch.argmax(sub, dim=2)[0]    # the chunk's first max
            for p in range(g.shape[1]):
                cand = (float(sub[0, p, cidx[p]]), lo + int(cidx[p]) // NB,
                        int(cidx[p]) % NB)
                if (cand[0], -cand[1], -cand[2]) > (best[p][0], -best[p][1],
                                                    -best[p][2]):
                    best[p] = cand
        return [b[1] for b in best]

    assert chunked(gains) == [100, 1500]
    assert (torch.argmax(table, dim=2) // NB)[0].tolist() == [100, 1500]
    # the variance split on a histogram where only features 100 and 1,500
    # inform (the same bins: a tie across chunks) and every feature's bins
    # add up to the node's totals
    hist = torch.tensor([10.0, 25.0, 125.0]).repeat(1, 2, D, NB, 1)
    sharp = torch.tensor([[10.0, 0.0, 0.0], [10.0, 0.0, 0.0],
                          [10.0, 50.0, 250.0], [10.0, 50.0, 250.0]])
    hist[:, :, 100] = hist[:, :, 1500] = sharp
    tot = hist[:, :, 0].sum(dim=2).contiguous()
    out = tk.tree_split_variance(
        hist, tot, torch.ones(D, dtype=torch.bool), None,
        torch.zeros((D, NB - 1)), torch.zeros(1), torch.zeros(1))
    vg = tk.split_gains_variance(hist, tot, torch.ones(D, dtype=torch.bool),
                                 None, torch.zeros(1)).reshape(1, 2, D, NB)
    assert out["feature"][0].tolist() == [100, 100] == chunked(vg)
    assert out["bin"][0].tolist() == [1, 1]
    assert not bool(out["is_leaf"].any())


@pytest.fixture(scope="module")
def multiclass():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1500, 6)).astype(np.float32)
    X[:, 4] = np.round(X[:, 4], 1)
    return X, rng


@pytest.mark.parametrize("n_classes", [6, 40])
def test_multiclass_decision_tree_matches_jax(multiclass, n_classes):
    """A 6-class and a 40-class decision tree (S = 7 and 41 statistics: two
    and nine ``tree_hist_deep`` launches, one and five gini class chunks on
    the card) on the twins equal the JAX package's tree, and score V = C
    leaf values per row."""
    X, rng = multiclass
    edges = np.quantile(X[:, 0] + 0.5 * X[:, 1],
                        np.linspace(0, 1, n_classes + 1)[1:-1])
    y = np.digitize(X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=len(X)),
                    edges).astype(np.float32)
    kw = dict(max_depth=5, min_instances_per_node=3)
    ref = jt.OpDecisionTreeClassifier(**kw).fit_arrays(X, y)
    port = pt.OpDecisionTreeClassifier(**kw).fit_arrays(X, y, device="cpu")
    assert port["n_classes"] == n_classes == port["leaf"].shape[2]
    np.testing.assert_array_equal(port["feature"].numpy(),
                                  np.asarray(ref["feature"]))
    np.testing.assert_array_equal(port["is_leaf"].numpy(),
                                  np.asarray(ref["is_leaf"]))
    # leaves on the nodes a walk can reach (every ancestor a split): the
    # JAX fit also writes values below a leaf, which no walk reads
    leaf_flag = port["is_leaf"].numpy()[0]
    reach = np.ones(len(leaf_flag), bool)
    for node in range(1, len(reach)):
        parent = (node - 1) // 2
        reach[node] = reach[parent] and not leaf_flag[parent]
    np.testing.assert_allclose(port["leaf"].numpy()[0][reach],
                               np.asarray(ref["leaf"])[0][reach],
                               rtol=1e-5, atol=1e-7)
    out = pt.TreeEnsembleModel(fitted=port).device_scores(torch.as_tensor(X))
    assert tuple(out["probability"].shape) == (len(X), n_classes)
    assert "scores" not in out


# --------------------------------------------------------------------------
# the LOCO kernels' plans
# --------------------------------------------------------------------------

def test_loco_plans_at_the_transmog_width():
    N, D = 1_000_000, 1596
    for k in (20, 1596):
        # the meta-less G = 1,596: two windows of group slots, 32 KB a block
        p = ik.loco_plan("linear", N, D, 1596, k)
        assert (p.threads, p.group_window, p.smem_bytes) == (256, 1024,
                                                              32 * 1024)
        assert p.blocks == ik.BLOCKS_IN_FLIGHT and not p.wide_groups
    one = ik.loco_plan("linear", N, D, 12, 12)       # raw-parent groups
    assert (one.group_window, one.smem_bytes) == (12, 12 * 4 * 8)
    assert one.wide_groups                            # float4 reads
    assert not ik.loco_plan("linear", 100_000, 512, 128, 20).wide_groups
    assert not ik.loco_plan("linear", N, 1597, 12, 12).wide_groups
    assert ik.loco_plan("linear", 5, D, 12, 12).blocks == 1
    # the tree kernel: a row a thread, 128 a block; the groups' sums in a
    # slab of one window (two sums a group for a forest classifier) beside
    # the block's staged rows of X
    R = ik.TREE_ROWS
    xs = 29 if 4 * R * 29 <= ik.TREE_X_SMEM else 0
    gbt = ik.loco_plan("tree", N, 28, 28, 20)
    assert (gbt.blocks, gbt.threads) == (-(-N // R), R)
    assert (gbt.group_window, gbt.x_stride) == (28, xs)
    assert gbt.smem_bytes == 4 * (28 * (R + 1) + R * xs)
    rf = ik.loco_plan("tree", N, 28, 28, 28, forest=True)
    assert rf.smem_bytes == 4 * (2 * 28 * (R + 1) + R * xs)
    deep = ik.loco_plan("tree", N, 1596, 1596, 1596)
    assert (deep.group_window, deep.x_stride) == (64, 0)   # X in place
    assert deep.smem_bytes == 4 * 64 * (R + 1)
    for bad in ((0, 1), (5, 6)):
        with pytest.raises(ValueError, match="K <= G"):
            ik.loco_plan("linear", N, D, *bad)
