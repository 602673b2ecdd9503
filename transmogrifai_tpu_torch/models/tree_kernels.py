"""The tree kernels of the port: wrappers and plain-PyTorch twins (the
dispatch rule and launch counters are in ``kernels.py``).

| kernel          | replaces (transmogrifai_tpu/models/trees.py)                  |
|-----------------|----------------------------------------------------------------|
| tree_hist       | ``_fit_tree_compact`` node_stats + histogram einsums (:313-338) |
| tree_hist_deep  | ``_fit_tree_unrolled``'s segment-sum histograms (:520-531)     |
| tree_split      | ``scan_chunk`` xgb gain/argmax + leaf flag/threshold/value (:339-364) |
| tree_split_gini | ``scan_chunk`` gini gain over per-node subsets (:320-326, :331-366) |
| tree_route      | the routing block (:373-391)                                    |
| tree_walk       | ``_predict_trees_block`` (:668-702)                              |
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .kernels import check as _check, launch, stream as _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "tree_hist": [_P] * 6 + [_L] + [_I] * 9 + [_P],
    "tree_hist_deep": [_P] * 6 + [_L] + [_I] * 8 + [_P],
    "tree_split": [_P] * 13 + [_I, _I, _I, _I, _P],
    "tree_split_gini": [_P] * 12 + [_I, _I, _I, _I, _I, _P],
    "tree_route": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _P],
    "tree_walk": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _I, _I, _P],
}
_HIST_SMEM_TARGET = 99 * 1024     # leaves room for two blocks per SM
_HIST_SMEM_MAX = 227 * 1024       # what one block can hold
_BLOCKS_IN_FLIGHT = 132 * 4       # SMs x resident blocks to aim for


def _launch(name: str, *args) -> None:
    launch(name, _ARGTYPES[name], *args)


# --------------------------------------------------------------------------
# tree_hist
# --------------------------------------------------------------------------

def tree_hist_twin(B, row_node, stats, offset: int, P: int, n_bins: int,
                   with_hist: bool = True, node_mask=None):
    """Plain-PyTorch twin of ``tree_hist`` (see :func:`tree_hist`).  Rows
    outside the level or with all-zero statistics are left out of the
    scatter: adding zero changes no sum."""
    K, N = row_node.shape
    S = stats.shape[2]
    D = B.shape[1]
    p = row_node.long() - offset
    kk, nn = torch.nonzero((p >= 0) & (p < P) & (stats != 0).any(dim=2),
                           as_tuple=True)
    pk = p[kk, nn] + kk * P
    w = stats[kk, nn]                                        # [M, S]
    totals = torch.zeros((K * P, S), dtype=stats.dtype, device=stats.device)
    totals.index_add_(0, pk, w)
    totals = totals.reshape(K, P, S)
    if not with_hist:
        return None, totals
    cell = ((pk[:, None] * D + torch.arange(D, device=p.device))
            * n_bins + B[nn].long())                         # [M, D]
    vals = w[:, None, :].expand(w.shape[0], D, S)
    if node_mask is not None:               # cells outside a subset stay 0
        keep = node_mask.reshape(K * P, D)[pk]
        cell, vals = cell[keep], vals[keep]
    hist = torch.zeros((K * P * D * n_bins, S), dtype=stats.dtype,
                       device=stats.device)
    hist.index_add_(0, cell.reshape(-1), vals.reshape(-1, S))
    return hist.reshape(K, P, D, n_bins, S), totals


def tree_hist(B: torch.Tensor, row_node: torch.Tensor, stats: torch.Tensor,
              offset: int, P: int, n_bins: int, with_hist: bool = True,
              node_mask=None):
    """Histograms of one tree level for K lanes at once.

    B int8 [N, D] bin ids (< n_bins); row_node int32 [K, N] heap node ids;
    stats f32 [K, N, S] per-row statistics.  Rows whose node lies in
    [offset, offset + P) contribute.  Returns (hist f32 [K, P, D, n_bins, S]
    or None when ``with_hist`` is False, totals f32 [K, P, S]).
    ``node_mask`` bool [K, P, D] (each node's feature subset) leaves the
    cells of features outside a node's subset at zero; None keeps every
    feature.  Rows whose statistics are all zero add nothing (exact: adding
    zero changes no sum).  A level whose nodes fit one block's shared memory
    runs ``tree_hist``; a deeper one ``tree_hist_deep``, one pass adding
    into device memory."""
    dev = B.device
    _check("tree_hist B", B, torch.int8, 2, dev)
    _check("tree_hist row_node", row_node, torch.int32, 2, dev)
    _check("tree_hist stats", stats, torch.float32, 3, dev)
    N, D = B.shape
    K, S = row_node.shape[0], stats.shape[2]
    if row_node.shape[1] != N or stats.shape[:2] != (K, N):
        raise ValueError("tree_hist: B, row_node and stats disagree on N/K")
    if node_mask is not None:
        _check("tree_hist node_mask", node_mask, torch.bool, 3, dev)
        if node_mask.shape != (K, P, D):
            raise ValueError("tree_hist: node_mask must be [K, P, D]")
    if dev.type == "cpu":
        return tree_hist_twin(B, row_node, stats, offset, P, n_bins,
                              with_hist, node_mask)
    if dev.type != "cuda":
        raise ValueError(f"tree_hist: unsupported device {dev}")
    totals = torch.zeros((K, P, S), dtype=torch.float32, device=dev)
    mask_ptr = 0 if node_mask is None else node_mask.data_ptr()
    per_cell = n_bins * S * 4
    deep = (P * S * 4 > _HIST_SMEM_MAX if not with_hist
            else 2 * P * per_cell > _HIST_SMEM_TARGET)
    if deep:
        hist = (torch.zeros((K, P, D, n_bins, S), dtype=torch.float32,
                            device=dev) if with_hist else totals)
        grid_x = max(1, min(-(-N // 256), 132 * 16 // K + 1))
        _launch("tree_hist_deep", B.data_ptr(), row_node.data_ptr(),
                stats.data_ptr(), mask_ptr, hist.data_ptr(),
                totals.data_ptr(), N, D, n_bins, S, K, offset, P,
                int(with_hist), grid_x, _stream(B))
        return (hist if with_hist else None), totals
    if not with_hist:
        _launch("tree_hist", B.data_ptr(), row_node.data_ptr(),
                stats.data_ptr(), 0, totals.data_ptr(), totals.data_ptr(), N,
                D, n_bins, S, K, offset, P, D, 0,
                max(1, min(-(-N // 256), _BLOCKS_IN_FLIGHT // K + 1)),
                _stream(B))
        return None, totals
    # a block's histogram covers the level's P nodes x Dc features; wide
    # matrices run as several feature chunks
    Dc = min(D, (_HIST_SMEM_TARGET - P * S * 4) // (P * per_cell))
    n_chunks = -(-D // Dc)
    grid_x = max(1, min(-(-(N * Dc) // 256),
                        _BLOCKS_IN_FLIGHT // (K * n_chunks) + 1))
    hist = torch.zeros((K, P, D, n_bins, S), dtype=torch.float32, device=dev)
    _launch("tree_hist", B.data_ptr(), row_node.data_ptr(), stats.data_ptr(),
            mask_ptr, hist.data_ptr(), totals.data_ptr(), N, D, n_bins, S, K,
            offset, P, Dc, 1, grid_x, _stream(B))
    return hist, totals


# --------------------------------------------------------------------------
# tree_split
# --------------------------------------------------------------------------

def _gain_table(hist, totals, fmask, min_inst, gain_fn,
                node_mask=None) -> torch.Tensor:
    """Gain [K, P, D*NB] of every (feature, bin) split of a level: the bin
    prefix is the left side, parent - prefix the right; -inf where either
    side's count is below min_inst, the feature is outside ``fmask`` or the
    node's subset ``node_mask`` [K, P, D] (None: all), or bin = NB-1."""
    K, P, D, NB, S = hist.shape
    left = torch.cumsum(hist, dim=3)
    parent = totals[:, :, None, None, :]
    right = parent - left
    gains = gain_fn(left, right, parent)
    mi = min_inst[:, None, None, None]
    ok = ((left[..., 0] >= mi) & (right[..., 0] >= mi)
          & fmask.bool()[None, None, :, None]
          & (torch.arange(NB, device=hist.device) < NB - 1))
    if node_mask is not None:
        ok = ok & node_mask.bool()[..., None]
    return torch.where(ok, gains, float("-inf")).reshape(K, P, D * NB)


def _top2_gap(gains: torch.Tensor) -> torch.Tensor:
    top = torch.topk(gains, 2, dim=2).values
    return top[..., 0] - top[..., 1]


def _split_out(best, feat, bin_, splits, min_gain) -> Dict[str, torch.Tensor]:
    NB = splits.shape[1] + 1
    leaf = ~(torch.isfinite(best) & (best > min_gain[:, None]))
    thr = splits[feat.long(), torch.clamp(bin_, 0, NB - 2).long()]
    return {"gain": best, "feature": feat, "bin": bin_, "is_leaf": leaf,
            "threshold": thr}


def _empty_nodes(K, P, S, fmask, node_mask, min_inst, gain_fn, dtype,
                 device):
    """(best, feature, bin) [K, P] of the first max of ``_gain_table`` at
    nodes whose histogram and totals are all zero: every cell of such a
    table is the gain of three zero statistics where the split is allowed
    (0 >= min_inst, the feature in ``fmask`` and the node's subset, bin <
    NB-1) and -inf elsewhere, so the first max is the first allowed cell,
    (first allowed feature, bin 0), or (0, 0) at -inf when none is."""
    D = fmask.shape[0]
    zero = torch.zeros((K, 1, 1, 1, S), dtype=dtype, device=device)
    g0 = gain_fn(zero, zero, zero).reshape(K, 1)
    allowed = fmask.bool()[None, None, :] & (0.0 >= min_inst)[:, None, None]
    if node_mask is not None:
        allowed = allowed & node_mask.bool()
    allowed = allowed.expand(K, P, D)
    any_ok = allowed.any(dim=2)
    best = torch.where(any_ok, g0.expand(K, P), float("-inf"))
    feat = torch.where(any_ok, torch.argmax(allowed.to(torch.int32), dim=2),
                       0).to(torch.int32)
    return best, feat, torch.zeros((K, P), dtype=torch.int32, device=device)


def _split_twin(hist, totals, fmask, node_mask, splits, min_inst, min_gain,
                gain_fn_of) -> Dict[str, torch.Tensor]:
    """The split each (lane, node) takes from its ``_gain_table``: the first
    max over (feature, bin) — lowest feature, then lowest bin — with its
    leaf flag and threshold.  The table is built only at nodes with a
    non-zero histogram or total; the many empty nodes of a deep level take
    the same value in closed form (``_empty_nodes``).  ``gain_fn_of(lanes)``
    is the gain function for those lanes' parameters."""
    K, P, D, NB, S = hist.shape
    live = ((hist.reshape(K, P, -1) != 0).any(dim=2)
            | (totals != 0).any(dim=2))
    best, feat, bin_ = _empty_nodes(
        K, P, S, fmask, node_mask, min_inst,
        gain_fn_of(torch.arange(K, device=hist.device)), hist.dtype,
        hist.device)
    kk, pp = torch.nonzero(live, as_tuple=True)
    if kk.numel():
        table = _gain_table(
            hist[kk, pp][:, None], totals[kk, pp][:, None], fmask,
            min_inst[kk], gain_fn_of(kk),
            None if node_mask is None else node_mask[kk, pp][:, None])
        idx = torch.argmax(table, dim=2)[:, 0]
        best[kk, pp] = torch.gather(table[:, 0], 1, idx[:, None])[:, 0]
        feat[kk, pp] = (idx // NB).to(torch.int32)
        bin_[kk, pp] = (idx % NB).to(torch.int32)
    return _split_out(best, feat, bin_, splits, min_gain)


def _xgb_gain(lam):
    """``_gain_xgb`` with per-lane ``lam`` [K] for tables [K, ...]."""
    lam4 = lam[:, None, None, None]

    def score(s):
        return s[..., 1] ** 2 / (s[..., 2] + lam4)

    return lambda l, r, p: 0.5 * ((score(l) + score(r)) - score(p))


def split_gains(hist, totals, fmask, min_inst, lam) -> torch.Tensor:
    """The twin's gain table [K, P, D*NB]: xgb gain of every (feature, bin)
    split, -inf where the split is not allowed."""
    return _gain_table(hist, totals, fmask, min_inst, _xgb_gain(lam))


def split_gap(hist, totals, fmask, min_inst, lam) -> torch.Tensor:
    """Best minus runner-up gain per (lane, node) [K, P]: the chosen split
    is well defined only where this gap is clear of rounding."""
    return _top2_gap(split_gains(hist, totals, fmask, min_inst, lam))


def tree_split_twin(hist, totals, fmask, splits, min_inst, min_gain, lam):
    """Plain-PyTorch twin of ``tree_split`` (see :func:`tree_split`)."""
    out = _split_twin(hist, totals, fmask, None, splits, min_inst, min_gain,
                      lambda lanes: _xgb_gain(lam[lanes]))
    out["value"] = -(totals[..., 1] / (totals[..., 2] + lam[:, None]))
    return out


def tree_split(hist: torch.Tensor, totals: torch.Tensor, fmask: torch.Tensor,
               splits: torch.Tensor, min_inst: torch.Tensor,
               min_gain: torch.Tensor, lam: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Best xgb split per (lane, node).

    hist f32 [K, P, D, NB, 3] and totals f32 [K, P, 3] of (w, w·g, w·h);
    fmask bool [D]; splits f32 [D, NB-1]; min_inst / min_gain / lam f32 [K].
    The gain is ``_gain_xgb`` over the bin prefix, masked by min_inst on both
    sides, the feature mask and ``bin < NB-1``; the FIRST max over (feature,
    bin) wins.  Returns per-node gain, feature, bin, is_leaf (gain <= min_gain
    or non-finite), threshold ``splits[feature, bin]`` and the ``_leaf_xgb``
    value, each [K, P]."""
    dev = hist.device
    _check("tree_split hist", hist, torch.float32, 5, dev)
    _check("tree_split totals", totals, torch.float32, 3, dev)
    _check("tree_split fmask", fmask, torch.bool, 1, dev)
    _check("tree_split splits", splits, torch.float32, 2, dev)
    for name, t in (("min_inst", min_inst), ("min_gain", min_gain),
                    ("lam", lam)):
        _check(f"tree_split {name}", t, torch.float32, 1, dev)
    K, P, D, NB, S = hist.shape
    if S != 3 or totals.shape != (K, P, 3) or splits.shape != (D, NB - 1):
        raise ValueError("tree_split: shapes of hist/totals/splits disagree")
    if dev.type == "cpu":
        return tree_split_twin(hist, totals, fmask, splits, min_inst,
                               min_gain, lam)
    if dev.type != "cuda":
        raise ValueError(f"tree_split: unsupported device {dev}")
    if NB > 32:
        raise ValueError("tree_split: the kernel takes at most 32 bins")
    out = {"gain": torch.empty((K, P), dtype=torch.float32, device=dev),
           "feature": torch.empty((K, P), dtype=torch.int32, device=dev),
           "bin": torch.empty((K, P), dtype=torch.int32, device=dev),
           "is_leaf": torch.empty((K, P), dtype=torch.bool, device=dev),
           "threshold": torch.empty((K, P), dtype=torch.float32, device=dev),
           "value": torch.empty((K, P), dtype=torch.float32, device=dev)}
    _launch("tree_split", hist.data_ptr(), totals.data_ptr(),
            fmask.data_ptr(), splits.data_ptr(), min_inst.data_ptr(),
            min_gain.data_ptr(), lam.data_ptr(),
            *(out[k].data_ptr() for k in ("gain", "feature", "bin",
                                          "is_leaf", "threshold", "value")),
            K, P, D, NB, _stream(hist))
    return out


# --------------------------------------------------------------------------
# tree_split_gini
# --------------------------------------------------------------------------

def wgini(s: torch.Tensor) -> torch.Tensor:
    """Count-weighted gini impurity of stats ``s [..., 1+C]``: cnt·(1 -
    Σ_c (s_c/cnt)²), cnt = max(s_0, 1e-12), the class squares summed in
    class order (as the kernel does)."""
    cnt = torch.clamp(s[..., 0], min=1e-12)
    q = s[..., 1:] / cnt[..., None]
    sq = q[..., 0] * q[..., 0]
    for c in range(1, q.shape[-1]):
        sq = sq + q[..., c] * q[..., c]
    return cnt * (1.0 - sq)


def gini_gain(left: torch.Tensor, right: torch.Tensor,
              parent: torch.Tensor) -> torch.Tensor:
    """``_gain_gini`` in its f32 order: wgini(parent) - wgini(left) -
    wgini(right)."""
    return (wgini(parent) - wgini(left)) - wgini(right)


def split_gains_gini(hist, totals, fmask, node_mask, min_inst) -> torch.Tensor:
    """The gini twin's gain table [K, P, D*NB]: gain of every (feature, bin)
    split, -inf where min_inst, the tree's feature mask, the node's subset
    (``node_mask`` [K, P, D] or None for all) or ``bin < NB-1`` rule it
    out."""
    return _gain_table(hist, totals, fmask, min_inst, gini_gain, node_mask)


def split_gap_gini(hist, totals, fmask, node_mask, min_inst) -> torch.Tensor:
    """Best minus runner-up gini gain per (lane, node) [K, P]."""
    return _top2_gap(split_gains_gini(hist, totals, fmask, node_mask,
                                      min_inst))


def tree_split_gini_twin(hist, totals, fmask, node_mask, splits, min_inst,
                         min_gain):
    """Plain-PyTorch twin of ``tree_split_gini`` (see
    :func:`tree_split_gini`)."""
    return _split_twin(hist, totals, fmask, node_mask, splits, min_inst,
                       min_gain, lambda lanes: gini_gain)


def tree_split_gini(hist: torch.Tensor, totals: torch.Tensor,
                    fmask: torch.Tensor, node_mask, splits: torch.Tensor,
                    min_inst: torch.Tensor,
                    min_gain: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Best gini split per (lane, node), over each node's feature subset.

    hist f32 [K, P, D, NB, 1+C] and totals f32 [K, P, 1+C] of (w, w·[y=0],
    .., w·[y=C-1]); fmask bool [D] (the tree's features); node_mask bool
    [K, P, D] (each node's drawn subset) or None for all features; splits
    f32 [D, NB-1]; min_inst / min_gain f32 [K].  The gain is ``_gain_gini``
    over the bin prefix, masked by min_inst on the weighted counts of both
    sides, both masks and ``bin < NB-1``; the FIRST max over (feature, bin)
    wins.  Returns per-node gain, feature, bin, is_leaf (gain <= min_gain or
    non-finite) and threshold ``splits[feature, bin]``, each [K, P].  The
    kernel takes C = 2..4 classes and NB <= 32 bins."""
    dev = hist.device
    _check("tree_split_gini hist", hist, torch.float32, 5, dev)
    _check("tree_split_gini totals", totals, torch.float32, 3, dev)
    _check("tree_split_gini fmask", fmask, torch.bool, 1, dev)
    _check("tree_split_gini splits", splits, torch.float32, 2, dev)
    for name, t in (("min_inst", min_inst), ("min_gain", min_gain)):
        _check(f"tree_split_gini {name}", t, torch.float32, 1, dev)
    K, P, D, NB, S = hist.shape
    if (S < 3 or totals.shape != (K, P, S) or splits.shape != (D, NB - 1)
            or fmask.shape != (D,)):
        raise ValueError("tree_split_gini: shapes of hist/totals/splits/fmask "
                         "disagree")
    if node_mask is not None:
        _check("tree_split_gini node_mask", node_mask, torch.bool, 3, dev)
        if node_mask.shape != (K, P, D):
            raise ValueError("tree_split_gini: node_mask must be [K, P, D]")
    if dev.type == "cpu":
        return tree_split_gini_twin(hist, totals, fmask, node_mask, splits,
                                    min_inst, min_gain)
    if dev.type != "cuda":
        raise ValueError(f"tree_split_gini: unsupported device {dev}")
    if NB > 32 or S > 5:
        raise ValueError("tree_split_gini: the kernel takes at most 32 bins "
                         "and 4 classes")
    out = {"gain": torch.empty((K, P), dtype=torch.float32, device=dev),
           "feature": torch.empty((K, P), dtype=torch.int32, device=dev),
           "bin": torch.empty((K, P), dtype=torch.int32, device=dev),
           "is_leaf": torch.empty((K, P), dtype=torch.bool, device=dev),
           "threshold": torch.empty((K, P), dtype=torch.float32, device=dev)}
    _launch("tree_split_gini", hist.data_ptr(), totals.data_ptr(),
            fmask.data_ptr(), 0 if node_mask is None else node_mask.data_ptr(),
            splits.data_ptr(), min_inst.data_ptr(), min_gain.data_ptr(),
            *(out[k].data_ptr() for k in ("gain", "feature", "bin",
                                          "is_leaf", "threshold")),
            K, P, D, NB, S - 1, _stream(hist))
    return out


# --------------------------------------------------------------------------
# tree_route
# --------------------------------------------------------------------------

def tree_route_twin(B, row_node, feat, bin_, leaf, offset: int):
    """Plain-PyTorch twin of ``tree_route`` (see :func:`tree_route`)."""
    P = feat.shape[1]
    p = row_node.long() - offset
    at = (p >= 0) & (p < P)
    pc = torch.where(at, p, 0)
    f = torch.gather(feat.long(), 1, pc)
    b = torch.gather(bin_, 1, pc)
    lf = torch.gather(leaf, 1, pc)
    n = torch.arange(B.shape[0], device=B.device)[None, :]
    go_right = (B[n, f].to(torch.int32) > b).to(torch.int32)
    child = 2 * row_node + 1 + go_right
    return torch.where(at & ~lf, child, row_node)


def tree_route(B: torch.Tensor, row_node: torch.Tensor, feat: torch.Tensor,
               bin_: torch.Tensor, leaf: torch.Tensor, offset: int):
    """Route every (lane, row) of a level to its child: a row at node
    ``offset + p`` whose node did not become a leaf moves to
    ``2*node + 1 + (B[n, feat] > bin)``.  B int8 [N, D]; row_node int32
    [K, N]; feat/bin int32, leaf bool [K, P].  Returns the new row_node."""
    dev = B.device
    _check("tree_route B", B, torch.int8, 2, dev)
    _check("tree_route row_node", row_node, torch.int32, 2, dev)
    _check("tree_route feat", feat, torch.int32, 2, dev)
    _check("tree_route bin", bin_, torch.int32, 2, dev)
    _check("tree_route leaf", leaf, torch.bool, 2, dev)
    N, D = B.shape
    K, P = feat.shape
    if row_node.shape != (K, N) or bin_.shape != (K, P) or leaf.shape != (K, P):
        raise ValueError("tree_route: shapes disagree")
    if dev.type == "cpu":
        return tree_route_twin(B, row_node, feat, bin_, leaf, offset)
    if dev.type != "cuda":
        raise ValueError(f"tree_route: unsupported device {dev}")
    out = torch.empty_like(row_node)
    grid_x = max(1, min(-(-(K * N) // 256), 132 * 16))
    _launch("tree_route", B.data_ptr(), row_node.data_ptr(), feat.data_ptr(),
            bin_.data_ptr(), leaf.data_ptr(), out.data_ptr(), N, D, K, offset,
            P, grid_x, _stream(B))
    return out


# --------------------------------------------------------------------------
# tree_walk
# --------------------------------------------------------------------------

def tree_walk_twin(X, feature, threshold, is_leaf, leaf, steps: int,
                   members: int, op: str = "sum"):
    """Plain-PyTorch twin of ``tree_walk`` (see :func:`tree_walk`)."""
    N = X.shape[0]
    Tr, T = feature.shape
    node = torch.zeros((N, Tr), dtype=torch.long, device=X.device)
    ar = torch.arange(Tr, device=X.device)[None, :]
    for _ in range(steps):
        f = feature[ar, node].long()
        th = threshold[ar, node]
        lf = is_leaf[ar, node]
        xf = torch.gather(X, 1, torch.clamp(f, min=0))
        nxt = 2 * node + 1 + (xf > th).long()
        nxt = torch.where(nxt < T, nxt, node)    # bottom level: stay put
        node = torch.where(lf, node, nxt)
    lv = leaf[ar, node].reshape(N, members, Tr // members, leaf.shape[2])
    acc = lv[:, :, 0]
    for t in range(1, lv.shape[2]):              # the kernel's tree order
        acc = acc + lv[:, :, t]
    return acc / lv.shape[2] if op == "mean" else acc


def tree_walk(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
              is_leaf: torch.Tensor, leaf: torch.Tensor, steps: int,
              members: int = 1, op: str = "sum") -> torch.Tensor:
    """Walk N rows through Tr perfect-heap trees for ``steps`` steps and
    reduce over each member's trees.

    X f32 [N, D]; feature int32, threshold f32, is_leaf bool [Tr, T]; leaf
    f32 [Tr, T, V].  The trees are ``members`` equal groups concatenated
    along Tr.  Returns f32 [N, members, V]: the sum (``op="sum"``) or mean
    (``op="mean"``) of the reached leaves per member."""
    dev = X.device
    _check("tree_walk X", X, torch.float32, 2, dev)
    _check("tree_walk feature", feature, torch.int32, 2, dev)
    _check("tree_walk threshold", threshold, torch.float32, 2, dev)
    _check("tree_walk is_leaf", is_leaf, torch.bool, 2, dev)
    _check("tree_walk leaf", leaf, torch.float32, 3, dev)
    N, D = X.shape
    Tr, T = feature.shape
    V = leaf.shape[2]
    if (threshold.shape != (Tr, T) or is_leaf.shape != (Tr, T)
            or leaf.shape[:2] != (Tr, T) or Tr % members or op not in
            ("sum", "mean")):
        raise ValueError("tree_walk: tree arrays, members or op disagree")
    if dev.type == "cpu":
        return tree_walk_twin(X, feature, threshold, is_leaf, leaf, steps,
                              members, op)
    if dev.type != "cuda":
        raise ValueError(f"tree_walk: unsupported device {dev}")
    if V > 4:
        raise ValueError(f"tree_walk: the kernel takes V <= 4 leaf values, "
                         f"got {V}")
    out = torch.empty((N, members, V), dtype=torch.float32, device=dev)
    _launch("tree_walk", X.data_ptr(), feature.data_ptr(),
            threshold.data_ptr(), is_leaf.data_ptr(), leaf.data_ptr(),
            out.data_ptr(), N, D, Tr // members, T, V, members, steps,
            int(op == "mean"), _stream(X))
    return out
