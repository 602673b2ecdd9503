"""Tree classifiers on the hand-written tree kernels (port of the GBT,
random-forest and decision-tree classifier paths of
``transmogrifai_tpu/models/trees.py``; reference: OpGBTClassifier.scala,
OpRandomForestClassifier.scala, OpDecisionTreeClassifier.scala).

Features are quantile-binned once into an int8 matrix ``B [N, D]``; trees
grow level-wise as perfect heaps (feature, threshold, is_leaf, leaf values).
Each level is three kernels — ``tree_hist`` (per-node, per-feature, per-bin
statistics; ``tree_hist_deep`` once a level's nodes outgrow shared memory),
``tree_split`` (xgb gain) or ``tree_split_gini`` (gini gain over each node's
feature subset), both a prefix over bins and a first-max argmax, and
``tree_route`` (rows to children) — run for a batch of (fold × grid-point ×
tree) lanes at once; each boosting round's margin update and every scoring
pass is ``tree_walk``.  The rounds and levels are a plain Python loop, the
same for every depth: it is the counterpart of both the compact and the
unrolled form of the JAX package's ``fit_tree``.

Forests draw their Poisson bootstraps and per-node feature subsets from one
``torch.Generator`` in :func:`forest_draws`.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..columns import device_matrix, to_device_f32
from ..device import tensor_device
from .base import PredictionModel, PredictorEstimator
from .linear import _n_classes
from .tree_kernels import (tree_hist, tree_route, tree_split, tree_split_gini,
                           tree_walk)

MAX_BINS_DEFAULT = 32
# Device bytes a batch of lanes may hold while its trees grow (statistics,
# node ids, the widest level's histogram; on the CPU also the twins'
# temporaries): lanes past it fit in further batches, one after another.
LANE_BUDGET_BYTES = {"cuda": 16 << 30, "cpu": 4 << 30}


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------

def _quantiles_f32(X: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """Per-column 'linear' quantiles in f32 with the arithmetic of
    ``jnp.quantile`` as XLA compiles it: sort, q·(n-1), floor/ceil, then
    ``fma(low, 1-w, high·w)`` (the fused multiply-add is emulated in f64,
    where the f32 product is exact) → [len(qs), D] numpy."""
    n = X.shape[0]
    srt = torch.sort(X, dim=0).values
    q = torch.as_tensor(qs, dtype=torch.float32, device=X.device) * float(n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo = srt[torch.clamp(low, 0, n - 1).long()]
    hi = srt[torch.clamp(high, 0, n - 1).long()]
    out = (lo.double() * lw.double()[:, None]
           + (hi * hw[:, None]).double()).float()
    return out.cpu().numpy()


def build_bin_splits(X, max_bins: int = MAX_BINS_DEFAULT) -> np.ndarray:
    """Per-feature quantile split points → [D, max_bins-1] f32, deduped and
    padded with +inf (≙ ``build_bin_splits``, trees.py:118-139).  A tensor
    is quantiled on its device in f32 (as the JAX package quantiles a
    device array); a numpy matrix in float64 on the host."""
    d = X.shape[1]
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    if isinstance(X, torch.Tensor):
        splits = _quantiles_f32(X.to(torch.float32), qs).T.astype(np.float32)
    else:
        splits = np.quantile(X, qs, axis=0).T.astype(np.float32)
    out = np.full((d, max_bins - 1), np.inf, dtype=np.float32)
    for j in range(d):
        u = np.unique(splits[j])
        u = u[np.isfinite(u)]
        out[j, :len(u)] = u
    return out


def bin_data(X: torch.Tensor, splits: torch.Tensor) -> torch.Tensor:
    """Bin b of x = the number of split points strictly below x → int8
    [N, D] (≙ ``bin_data``, trees.py:142-169: ``sum(X > splits)``).  One
    batched ``searchsorted(..., right=False)`` over the [D, N] columns."""
    if splits.shape[1] >= 127:
        raise ValueError("bin_data: int8 bins need max_bins <= 127")
    b = torch.searchsorted(splits.contiguous(), X.T.contiguous(), right=False)
    return b.T.to(torch.int8).contiguous()


def binned(X, Xd: torch.Tensor, max_bins: int):
    """(splits numpy [D, max_bins-1], splits tensor, B int8 [N, D]): split
    points quantiled from ``X`` as given, bins of its device copy ``Xd``."""
    sp = build_bin_splits(X, max_bins)
    sp_t = torch.as_tensor(sp, device=Xd.device)
    return sp, sp_t, bin_data(Xd, sp_t)


# --------------------------------------------------------------------------
# level-wise tree fit for K lanes
# --------------------------------------------------------------------------

class TreeArrays(NamedTuple):
    feature: torch.Tensor    # [K, T] int32 (split feature; -1 at leaves)
    threshold: torch.Tensor  # [K, T] f32 raw split threshold
    is_leaf: torch.Tensor    # [K, T] bool
    leaf: torch.Tensor       # [K, T, V] f32 leaf values (xgb V = 1, gini V = C)
    gain: torch.Tensor       # [K, D] per-feature gain sum over splits


def _leaf_gini(totals: torch.Tensor) -> torch.Tensor:
    """Class shares of node totals [..., 1+C] → [..., C] (≙ ``_leaf_gini``,
    trees.py:216-217)."""
    return totals[..., 1:] / torch.clamp(totals[..., :1], min=1e-12)


def lane_bytes(n_rows: int, n_feats: int, n_stats: int, n_bins: int,
               max_depth: int, device: torch.device) -> int:
    """Bytes one lane holds while its tree grows: its statistics and node
    ids, each twice (the caller's temporaries while it builds the
    statistics; a route writes new ids beside the old), and its row weight,
    ``4·N·(2·S + 4)``; and the widest level's histogram (2^(depth-1) nodes ×
    D × bins × S f32).  The CPU twins add ~2 histograms (the empty-node
    test, the split's tables at non-empty nodes) and the scatter's indices
    and values (``N·D·(8 + 4·S)``)."""
    hist = 4 * (1 << max(max_depth - 1, 0)) * n_feats * n_bins * n_stats
    rows = 4 * n_rows * (2 * n_stats + 4)
    if device.type == "cuda":
        return rows + hist
    return rows + 3 * hist + n_rows * n_feats * (8 + 4 * n_stats)


def lane_batches(n_lanes: int, per_lane: int,
                 device: torch.device) -> List[slice]:
    """Consecutive lane ranges whose working set stays within
    ``LANE_BUDGET_BYTES`` of the device's type, each of at least one lane,
    as few as that allows and of near-equal sizes."""
    budget = LANE_BUDGET_BYTES.get(device.type, LANE_BUDGET_BYTES["cpu"])
    most = max(1, min(n_lanes, budget // max(per_lane, 1)))
    n_batches = -(-n_lanes // most)
    per = -(-n_lanes // n_batches)
    return [slice(a, min(a + per, n_lanes)) for a in range(0, n_lanes, per)]


def cat_trees(parts: Sequence["TreeArrays"]) -> "TreeArrays":
    """Lane batches' trees joined along the lane axis."""
    if len(parts) == 1:
        return parts[0]
    return TreeArrays(*(torch.cat(a) for a in zip(*parts)))


def fit_trees(B: torch.Tensor, splits: torch.Tensor, stats: torch.Tensor,
              fmask: torch.Tensor, *, max_depth: int, n_bins: int,
              min_instances: torch.Tensor, min_gain: torch.Tensor,
              lam: Optional[torch.Tensor] = None, impurity: str = "xgb",
              node_masks: Optional[Sequence[torch.Tensor]] = None
              ) -> TreeArrays:
    """Grow K trees, one per lane, level by level (≙ ``fit_tree``,
    trees.py:224-250, in both its forms: ``_fit_tree_compact`` :274-416 and,
    past depth 7, ``_fit_tree_unrolled`` :419-585).  All K lanes grow in one
    batch; callers bound K with :func:`lane_batches`.

    B int8 [N, D]; splits f32 [D, n_bins-1]; fmask bool [D];
    min_instances/min_gain f32 [K].  ``impurity`` "xgb": stats f32 [K, N, 3]
    = (w, w·g, w·h), ``lam`` f32 [K], one leaf value per node.  "gini":
    stats f32 [K, N, 1+C] = (w, w·[y=0], .., w·[y=C-1]), C leaf values
    (class shares) per node, and ``node_masks`` per level a bool [K, 2^lvl,
    D] of each node's feature subset (None: every feature).  Returns
    perfect-heap arrays with T = 2^(max_depth+1) - 1 nodes.

    Nodes below a leaf.  Rows whose node became a leaf keep that node id and
    drop out of every later histogram and route (the compact form's rule),
    so every node below a leaf is itself a leaf with feature -1 and all-zero
    leaf values and statistics; its threshold is that of an empty node.  The
    unrolled form instead routes those rows on through the dead node's best
    split and gives the nodes below it leaf values and thresholds from them.
    The two agree on every node a walk can reach (a walk stops at the first
    leaf), which is all that scoring and the per-feature gains read."""
    if impurity not in ("xgb", "gini"):
        raise ValueError(f"fit_trees: impurity {impurity!r}")
    K, N, S = stats.shape
    D = B.shape[1]
    dev = B.device
    T = 2 ** (max_depth + 1) - 1
    V = 1 if impurity == "xgb" else S - 1
    feature = torch.full((K, T), -1, dtype=torch.int32, device=dev)
    threshold = torch.full((K, T), float("inf"), dtype=torch.float32,
                           device=dev)
    is_leaf = torch.zeros((K, T), dtype=torch.bool, device=dev)
    leaf = torch.zeros((K, T, V), dtype=torch.float32, device=dev)
    gain = torch.zeros((K, D), dtype=torch.float32, device=dev)
    row_node = torch.zeros((K, N), dtype=torch.int32, device=dev)
    for lvl in range(max_depth + 1):
        off, P = (1 << lvl) - 1, 1 << lvl
        bottom = lvl == max_depth
        nm = None if node_masks is None or bottom else node_masks[lvl]
        hist, totals = tree_hist(B, row_node, stats, off, P, n_bins,
                                 with_hist=not bottom, node_mask=nm)
        if bottom:
            break
        if impurity == "xgb":
            sp = tree_split(hist, totals, fmask, splits, min_instances,
                            min_gain, lam)
        else:
            sp = tree_split_gini(hist, totals, fmask, nm, splits,
                                 min_instances, min_gain)
        del hist
        row_node = tree_route(B, row_node, sp["feature"], sp["bin"],
                              sp["is_leaf"], off)
        if impurity == "xgb":
            leaf[:, off:off + P, 0] = sp["value"]
        else:
            leaf[:, off:off + P] = _leaf_gini(totals)
        lf = sp["is_leaf"]
        is_leaf[:, off:off + P] = lf
        feature[:, off:off + P] = torch.where(lf, -1, sp["feature"])
        threshold[:, off:off + P] = sp["threshold"]
        gain.scatter_add_(1, sp["feature"].long(),
                          torch.where(lf, 0.0, sp["gain"]))
    # the bottom level is all leaves
    if impurity == "xgb":
        leaf[:, off:, 0] = -(totals[..., 1] / (totals[..., 2] + lam[:, None]))
    else:
        leaf[:, off:] = _leaf_gini(totals)
    is_leaf[:, off:] = True
    return TreeArrays(feature, threshold, is_leaf, leaf, gain)


# --------------------------------------------------------------------------
# ensemble predictors (≙ trees.py:588-665), all on the tree_walk kernel.
# As in the JAX package, ``max_depth`` is the number of walk steps (callers
# pass the trees' depth + 1).
# --------------------------------------------------------------------------

def predict_trees_raw(X, feature, threshold, is_leaf, leaf,
                      max_depth: int) -> torch.Tensor:
    """Reached leaf values per tree → [N, Tr, V]."""
    return tree_walk(X, feature, threshold, is_leaf, leaf, max_depth,
                     members=feature.shape[0])


def predict_trees_sum_grouped(X, feature, threshold, is_leaf, leaf,
                              max_depth: int, members: int) -> torch.Tensor:
    """Leaf sums of ``members`` equal groups of trees → [N, members, V]."""
    return tree_walk(X, feature, threshold, is_leaf, leaf, max_depth,
                     members=members)


def predict_trees_agg(X, feature, threshold, is_leaf, leaf, max_depth: int,
                      op: str = "mean") -> torch.Tensor:
    """Mean (or sum) of the reached leaves over all trees → [N, V]."""
    return tree_walk(X, feature, threshold, is_leaf, leaf, max_depth,
                     op=op)[:, 0]


def _gbt_grid_fit(B, splits, X, y, margins, W, fmask, mis, mgs, lams, etas,
                  *, max_depth: int, n_bins: int, n_rounds: int):
    """All boosting rounds of K (fold × grid-point) GBT candidates at once
    (≙ ``_gbt_grid_scan_fitter`` / ``_gbt_grid_round_body``,
    trees.py:928-970).  Returns (final margins [K, N], per-round TreeArrays
    stacked to [R, K, ...])."""
    N, D = B.shape
    per_lane = lane_bytes(N, D, 3, n_bins, max_depth, B.device)
    rounds = []
    for _ in range(n_rounds):
        p = torch.sigmoid(margins)
        g = p - y
        h = torch.clamp(p * (1 - p), min=1e-6)
        # weight ALL stat columns (incl. count) so zero-weight rows are
        # excluded from min_instances feasibility too
        stats = (torch.stack([torch.ones_like(g), g, h], dim=2)
                 * W[:, :, None]).contiguous()
        tree = cat_trees([
            fit_trees(B, splits, stats[sl], fmask, max_depth=max_depth,
                      n_bins=n_bins, min_instances=mis[sl], min_gain=mgs[sl],
                      lam=lams[sl])
            for sl in lane_batches(stats.shape[0], per_lane, B.device)])
        pred = predict_trees_raw(X, tree.feature, tree.threshold,
                                 tree.is_leaf, tree.leaf,
                                 max_depth + 1)[:, :, 0]           # [N, K]
        margins = margins + etas[:, None] * pred.T
        rounds.append(tree)
    return margins, TreeArrays(*(torch.stack(a) for a in zip(*rounds)))


def _lane_params(vals, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals, np.float32), device=device)


def fit_gbt(X, y, *, n_rounds: int, max_depth: int, max_bins: int,
            min_instances: float, min_gain: float, eta: float, lam: float,
            min_child_weight: float = 0.0, sample_weight=None,
            device=None) -> Dict[str, Any]:
    """Binary GBT (XGBoost-style second order) for one candidate
    (≙ ``fit_gbt``, trees.py:822-862): the grid fitter with one lane."""
    dev = tensor_device(X, device)
    Xd = device_matrix(X, dev)
    N, D = Xd.shape
    splits, sp_t, B = binned(X, Xd, max_bins)
    w0 = (torch.ones((1, N), dtype=torch.float32, device=dev)
          if sample_weight is None
          else to_device_f32(sample_weight, dev)[None, :])
    mi = max(float(min_instances), float(min_child_weight))
    _, rounds = _gbt_grid_fit(
        B, sp_t, Xd, to_device_f32(y, dev),
        torch.zeros((1, N), dtype=torch.float32, device=dev), w0,
        torch.ones(D, dtype=torch.bool, device=dev),
        *(_lane_params([v], dev) for v in (mi, min_gain, lam, eta)),
        max_depth=max_depth, n_bins=max_bins, n_rounds=n_rounds)
    return {"kind": "gbt", "task": "classification", "n_classes": 2,
            "max_depth": max_depth, "eta": eta, "base": 0.0,
            "feature": rounds.feature[:, 0].contiguous(),
            "threshold": rounds.threshold[:, 0].contiguous(),
            "is_leaf": rounds.is_leaf[:, 0].contiguous(),
            "leaf": rounds.leaf[:, 0].contiguous(),
            "feature_gain": rounds.gain[:, 0].sum(dim=0),
            "bin_splits": splits}


# --------------------------------------------------------------------------
# random forests and decision trees (≙ trees.py:736-925, :1085-1265)
# --------------------------------------------------------------------------

def _features_per_node(strategy: str, d: int) -> Optional[int]:
    """Per-node candidate count for a featureSubsetStrategy name; None = all
    (≙ ``_features_per_node``, trees.py:736-742)."""
    if strategy == "all":
        return None
    k = {"sqrt": max(1, int(math.sqrt(d))),
         "onethird": max(1, d // 3)}.get(strategy)
    return None if k is None or k >= d else k


class ForestDraws(NamedTuple):
    # subsampling rate → f32 [n_trees, N] Poisson(rate) row counts; empty
    # when bootstrap is off
    boot: Dict[float, torch.Tensor]
    # per level lvl: bool [n_trees, 2^lvl, D] node feature subsets; None
    # when every node sees every feature
    subsets: Optional[List[torch.Tensor]]


def forest_draws(generator: torch.Generator, *, n_trees: int, n_rows: int,
                 rates: Sequence[float], max_depth: int, fmask: torch.Tensor,
                 features_per_node: Optional[int]) -> ForestDraws:
    """Every random draw of one forest shape group, made in one fixed order
    from ``generator`` on the generator's own device (``generator.device``):
    the same seed on the same device gives the same draws, and so the same
    forest on the CPU; a CUDA generator draws another stream than a CPU
    one.  Per tree index (≙ trees.py:1186-1192, :912-915, :320-325):

    * one Poisson(rate) count per row for each subsampling rate in ``rates``
      (drawn in the order given; pass none to turn bootstrap off);
    * per level and node, uniform scores over the D features, +inf outside
      ``fmask``; the node keeps the ``features_per_node`` lowest (``topk``
      breaks ties, so a subset has exactly that many features).

    Every fold and grid point of the group shares these draws."""
    dev = generator.device
    boot = {float(r): torch.poisson(
        torch.full((n_trees, n_rows), float(r), device=dev),
        generator=generator) for r in rates}
    if features_per_node is None:
        return ForestDraws(boot, None)
    fm = fmask.to(dev)
    D = fm.shape[0]
    subsets = []
    for lvl in range(max_depth):
        scores = torch.rand((n_trees, 1 << lvl, D), generator=generator,
                            device=dev)
        scores = torch.where(fm, scores, float("inf"))
        keep = torch.topk(scores, features_per_node, dim=2,
                          largest=False).indices
        m = torch.zeros(scores.shape, dtype=torch.bool, device=dev)
        subsets.append(m.scatter_(2, keep, True) & fm)
    return ForestDraws(boot, subsets)


def _forest_grid_fit(B, splits, base_stats, fold_w, draws: ForestDraws,
                     lane_rates, mis, mgs, *, n_trees: int, max_depth: int,
                     n_bins: int) -> TreeArrays:
    """Every (fold × grid-point × tree) tree of one forest shape group in
    level loops over lane batches (≙ ``_forest_grid_fitter``,
    trees.py:890-925, whose ``lax.map`` batches bound memory the same way).
    Lane ``(k·Gg + j)·n_trees + t`` fits tree t of grid point j on fold k
    with statistics base × (Poisson draw of tree t at point j's rate × fold
    weight); ``lane_rates`` gives point j's rate (or None: no bootstrap).
    A batch's statistics and node subsets are made when it grows."""
    dev = B.device
    N, D = B.shape
    Gg = len(lane_rates)
    Kc = fold_w.shape[0] * Gg * n_trees
    boot = {r: b.to(dev) for r, b in draws.boot.items()}
    subsets = (None if draws.subsets is None
               else [m.to(dev) for m in draws.subsets])
    fmask = torch.ones(D, dtype=torch.bool, device=dev)
    per_lane = lane_bytes(N, D, base_stats.shape[1], n_bins, max_depth, dev)
    parts = []
    for sl in lane_batches(Kc, per_lane, dev):
        w = torch.empty((sl.stop - sl.start, N), dtype=torch.float32,
                        device=dev)
        for grp in range(sl.start // n_trees, (sl.stop - 1) // n_trees + 1):
            k, j = divmod(grp, Gg)
            lo = max(sl.start, grp * n_trees)
            hi = min(sl.stop, (grp + 1) * n_trees)
            t0, t1 = lo - grp * n_trees, hi - grp * n_trees
            r = lane_rates[j]
            w[lo - sl.start:hi - sl.start] = (
                fold_w[k] if r is None else boot[r][t0:t1] * fold_w[k])
        stats = (base_stats[None] * w[:, :, None]).contiguous()
        del w
        masks = None
        if subsets is not None:
            tree_of_lane = torch.arange(sl.start, sl.stop, device=dev) % n_trees
            masks = [m[tree_of_lane].contiguous() for m in subsets]
        parts.append(fit_trees(B, splits, stats, fmask, max_depth=max_depth,
                               n_bins=n_bins, min_instances=mis[sl],
                               min_gain=mgs[sl], impurity="gini",
                               node_masks=masks))
        del stats, masks
    return cat_trees(parts)


# --------------------------------------------------------------------------
# prediction model + estimator stages
# --------------------------------------------------------------------------

def _walk_agg(X: torch.Tensor, fitted: Dict[str, Any], op: str) -> torch.Tensor:
    """Mean or sum over the fitted trees of the reached leaves → [N, V]."""
    dev = X.device
    leaf = to_device_f32(fitted["leaf"], dev)
    if leaf.ndim == 2:
        leaf = leaf[:, :, None]
    return predict_trees_agg(
        X, torch.as_tensor(fitted["feature"], device=dev,
                           dtype=torch.int32).contiguous(),
        to_device_f32(fitted["threshold"], dev).contiguous(),
        torch.as_tensor(fitted["is_leaf"], device=dev,
                        dtype=torch.bool).contiguous(),
        leaf.contiguous(), int(fitted["max_depth"]) + 1, op=op)


class TreeEnsembleModel(PredictionModel):
    """Fitted GBT or forest classifier (≙ ``TreeEnsembleModel``,
    trees.py:1006-1027, the device path)."""

    def device_scores(self, X, full: bool = False) -> Dict[str, Any]:
        f = self.fitted
        if f["kind"] == "forest":
            prob = _walk_agg(X, f, "mean")                           # [N, C]
            prob = prob / torch.clamp(prob.sum(dim=1, keepdim=True),
                                      min=1e-12)
            out = {"prediction": torch.argmax(prob, dim=1).to(torch.float32),
                   "probability": prob}
            if prob.shape[1] == 2:
                out["scores"] = prob[:, 1]
            if full:
                out["rawPrediction"] = torch.log(torch.clamp(prob, min=1e-12))
            return out
        margin = f["base"] + f["eta"] * _walk_agg(X, f, "sum")[:, 0]
        p1 = torch.sigmoid(margin)
        out = {"prediction": (p1 > 0.5).to(torch.float32), "scores": p1,
               "margin": margin}
        if full:
            out["probability"] = torch.stack([1.0 - p1, p1], dim=1)
            out["rawPrediction"] = torch.stack([-margin, margin], dim=1)
        return out


class _ForestEstimatorBase(PredictorEstimator):
    """Random-forest classifier family (≙ ``_ForestEstimatorBase``,
    trees.py:1085-1240).  ``draw_device`` names the device whose
    ``torch.Generator`` (seeded with ``seed``) makes the draws; by default
    the fit's own device.  Give ``"cpu"`` to make a card fit draw exactly
    what the same fit on the CPU draws."""

    model_cls = TreeEnsembleModel
    default_feature_strategy = "sqrt"

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 max_bins: int = MAX_BINS_DEFAULT,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 subsampling_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", seed: int = 42,
                 bootstrap: bool = True, **kw):
        super().__init__(num_trees=num_trees, max_depth=max_depth,
                         max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain,
                         subsampling_rate=subsampling_rate,
                         feature_subset_strategy=feature_subset_strategy,
                         seed=seed, bootstrap=bootstrap, **kw)

    def _strategy(self, m: Dict[str, Any]) -> str:
        """"auto" → the family's default with several trees, else "all"
        (≙ trees.py:1100-1103)."""
        strategy = m.get("feature_subset_strategy", "auto")
        if strategy == "auto":
            strategy = (self.default_feature_strategy
                        if int(m.get("num_trees", 20)) > 1 else "all")
        return strategy

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        """One forest (≙ ``fit_forest``, trees.py:745-795): the grid fitter
        with one fold whose row weights are ``sample_weight`` (or ones)."""
        dev = tensor_device(X, device)
        N = X.shape[0]
        w = (torch.ones((1, N), dtype=torch.float32, device=dev)
             if sample_weight is None
             else to_device_f32(sample_weight, dev)[None, :])
        return self.fit_arrays_grid(X, y, w, [{}], device=dev)[0][0]

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        """Every (fold × grid-point × tree) fit of a static tree shape
        trains as one lane block over one shared binned matrix (≙
        ``_ForestEstimatorBase.fit_arrays_grid``, trees.py:1119-1240)."""
        dev = tensor_device(X, device)
        Xd = device_matrix(X, dev)
        N, D = Xd.shape
        K, G = len(fold_weights), len(grids)
        out: list = [[None] * G for _ in range(K)]
        n_classes = max(_n_classes(y), 2)
        groups = defaultdict(list)
        for gi, p in enumerate(grids):
            m = {**self._params, **p}
            groups[(int(m.get("num_trees", 20)), int(m.get("max_depth", 5)),
                    int(m.get("max_bins", MAX_BINS_DEFAULT)),
                    self._strategy(m), bool(m.get("bootstrap", True)),
                    int(m.get("seed", 42)))].append(gi)
        yd = to_device_f32(y, dev)
        base_stats = torch.cat(
            [torch.ones((N, 1), dtype=torch.float32, device=dev),
             torch.nn.functional.one_hot(yd.long(), n_classes).to(
                 torch.float32)], dim=1)
        fold_w = to_device_f32(fold_weights, dev)
        fmask = torch.ones(D, dtype=torch.bool, device=dev)
        binned_by: Dict[int, tuple] = {}

        def mval(gi, name, default):
            return float({**self._params, **grids[gi]}.get(name, default))

        for (n_trees, max_depth, max_bins, strategy, bootstrap,
             seed), gidx in groups.items():
            if max_bins not in binned_by:
                binned_by[max_bins] = binned(X, Xd, max_bins)
            splits, sp_t, B = binned_by[max_bins]
            rates = [mval(gi, "subsampling_rate", 1.0) if bootstrap else None
                     for gi in gidx]
            gen = torch.Generator(
                device=self._params.get("draw_device") or dev)
            gen.manual_seed(seed)
            draws = forest_draws(
                gen, n_trees=n_trees, n_rows=N,
                rates=list(dict.fromkeys(r for r in rates if r is not None)),
                max_depth=max_depth, fmask=fmask,
                features_per_node=(_features_per_node(strategy, D)
                                   if n_trees > 1 else None))

            def per_tree(name, default):
                vals = [mval(gi, name, default) for gi in gidx]
                return _lane_params(np.tile(np.repeat(vals, n_trees), K), dev)

            trees = _forest_grid_fit(
                B, sp_t, base_stats, fold_w, draws, rates,
                per_tree("min_instances_per_node", 1),
                per_tree("min_info_gain", 0.0), n_trees=n_trees,
                max_depth=max_depth, n_bins=max_bins)
            for k in range(K):
                for j, gi in enumerate(gidx):
                    s = (k * len(gidx) + j) * n_trees
                    out[k][gi] = {
                        "kind": "forest", "task": "classification",
                        "n_classes": n_classes, "max_depth": max_depth,
                        "feature": trees.feature[s:s + n_trees],
                        "threshold": trees.threshold[s:s + n_trees],
                        "is_leaf": trees.is_leaf[s:s + n_trees],
                        "leaf": trees.leaf[s:s + n_trees],
                        "feature_gain": trees.gain[s:s + n_trees].sum(dim=0),
                        "bin_splits": splits}
        return out


class OpRandomForestClassifier(_ForestEstimatorBase):
    """≙ OpRandomForestClassifier.scala:58."""


class OpDecisionTreeClassifier(_ForestEstimatorBase):
    """≙ OpDecisionTreeClassifier: a single deterministic tree — no
    bootstrap, all features (like Spark's DecisionTreeClassifier)."""

    def __init__(self, max_depth: int = 5, **kw):
        kw.setdefault("num_trees", 1)
        kw.setdefault("feature_subset_strategy", "all")
        kw.setdefault("subsampling_rate", 1.0)
        kw.setdefault("bootstrap", False)
        super().__init__(max_depth=max_depth, **kw)


class OpGBTClassifier(PredictorEstimator):
    """≙ OpGBTClassifier (binary, like Spark's GBTClassifier).  Fits are
    deterministic: no random draws."""

    model_cls = TreeEnsembleModel

    def __init__(self, max_iter: int = 20, max_depth: int = 5,
                 max_bins: int = MAX_BINS_DEFAULT, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, step_size: float = 0.1,
                 reg_lambda: float = 1.0, **kw):
        super().__init__(max_iter=max_iter, max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, step_size=step_size,
                         reg_lambda=reg_lambda, **kw)

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        return fit_gbt(
            X, y, n_rounds=int(self.get("max_iter", 20)),
            max_depth=int(self.get("max_depth", 5)),
            max_bins=int(self.get("max_bins", MAX_BINS_DEFAULT)),
            min_instances=float(self.get("min_instances_per_node", 1)),
            min_gain=float(self.get("min_info_gain", 0.0)),
            eta=float(self.get("step_size", 0.1)),
            lam=float(self.get("reg_lambda", 1.0)),
            min_child_weight=float(self.get("min_child_weight", 0.0)),
            sample_weight=sample_weight, device=device)

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        """Every (fold × grid-point) candidate of a static tree shape trains
        as one lane block over one shared binned matrix (≙
        ``_GBTEstimatorBase.fit_arrays_grid``, trees.py:1336-1397)."""
        dev = tensor_device(X, device)
        Xd = device_matrix(X, dev)
        N, D = Xd.shape
        K, G = len(fold_weights), len(grids)
        out: list = [[None] * G for _ in range(K)]
        groups = defaultdict(list)
        for gi, p in enumerate(grids):
            m = {**self._params, **p}
            groups[(int(m.get("max_iter", 20)), int(m.get("max_depth", 5)),
                    int(m.get("max_bins", MAX_BINS_DEFAULT)))].append(gi)
        yd = to_device_f32(y, dev)
        fold_w = to_device_f32(fold_weights, dev)
        fmask = torch.ones(D, dtype=torch.bool, device=dev)
        binned_by: Dict[int, tuple] = {}

        def mval(gi, name, default):
            return float({**self._params, **grids[gi]}.get(name, default))

        for (n_rounds, max_depth, max_bins), gidx in groups.items():
            if max_bins not in binned_by:
                binned_by[max_bins] = binned(X, Xd, max_bins)
            splits, sp_t, B = binned_by[max_bins]
            Gg = len(gidx)
            Kc = K * Gg                                  # lane kc = k*Gg + j

            def per_cand(vals):
                return np.tile(np.asarray(vals, np.float32), K)

            mis = per_cand([max(mval(gi, "min_instances_per_node", 1),
                                mval(gi, "min_child_weight", 0.0))
                            for gi in gidx])
            mgs = per_cand([mval(gi, "min_info_gain", 0.0) for gi in gidx])
            lams = per_cand([mval(gi, "reg_lambda", 1.0) for gi in gidx])
            etas = per_cand([mval(gi, "step_size", 0.1) for gi in gidx])
            _, rounds = _gbt_grid_fit(
                B, sp_t, Xd, yd,
                torch.zeros((Kc, N), dtype=torch.float32, device=dev),
                fold_w.repeat_interleave(Gg, dim=0).contiguous(), fmask,
                *(_lane_params(a, dev) for a in (mis, mgs, lams, etas)),
                max_depth=max_depth, n_bins=max_bins, n_rounds=n_rounds)
            for k in range(K):
                for j, gi in enumerate(gidx):
                    kc = k * Gg + j
                    out[k][gi] = {
                        "kind": "gbt", "task": "classification",
                        "n_classes": 2, "max_depth": max_depth,
                        "eta": float(etas[kc]), "base": 0.0,
                        "feature": rounds.feature[:, kc].contiguous(),
                        "threshold": rounds.threshold[:, kc].contiguous(),
                        "is_leaf": rounds.is_leaf[:, kc].contiguous(),
                        "leaf": rounds.leaf[:, kc].contiguous(),
                        "feature_gain": rounds.gain[:, kc].sum(dim=0),
                        "bin_splits": splits}
        return out

