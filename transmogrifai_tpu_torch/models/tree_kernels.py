"""The tree kernels of the port: wrappers, launch counters and plain-PyTorch
twins.

Each public function here takes tensors and dispatches on their device: on a
CPU tensor it runs the plain-PyTorch twin beside it; on a CUDA tensor it
launches the hand-written kernel from ``csrc/`` (built on first use) or
raises.  There is no fallback from a CUDA tensor to the twin.  Each wrapper
adds one to ``LAUNCHES[<name>]`` where it launches its kernel, and nowhere
else.

| kernel          | replaces (transmogrifai_tpu/models/trees.py)                  |
|-----------------|----------------------------------------------------------------|
| tree_hist       | ``_fit_tree_compact`` node_stats + histogram einsums (:313-338) |
| tree_split      | ``scan_chunk`` xgb gain/argmax + leaf flag/threshold/value (:339-364) |
| tree_split_gini | ``scan_chunk`` gini gain over per-node subsets (:320-326, :331-366) |
| tree_route      | the routing block (:373-391)                                    |
| tree_walk       | ``_predict_trees_block`` (:668-702)                              |
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import cuda_build

LAUNCHES: Dict[str, int] = {"tree_hist": 0, "tree_split": 0,
                            "tree_split_gini": 0, "tree_route": 0,
                            "tree_walk": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "tree_hist": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P],
    "tree_split": [_P] * 13 + [_I, _I, _I, _I, _P],
    "tree_split_gini": [_P] * 12 + [_I, _I, _I, _I, _I, _P],
    "tree_route": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _P],
    "tree_walk": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _I, _I, _P],
}
_HIST_SMEM_TARGET = 99 * 1024     # leaves room for two blocks per SM
_BLOCKS_IN_FLIGHT = 132 * 4       # SMs x resident blocks to aim for


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, *args) -> None:
    fn = getattr(cuda_build.load(name, _ARGTYPES[name]), f"{name}_launch")
    cuda_build.check(name, fn(*args))
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: {t.ndim}-d tensor, expected {ndim}-d")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


# --------------------------------------------------------------------------
# tree_hist
# --------------------------------------------------------------------------

def tree_hist_twin(B, row_node, stats, offset: int, P: int, n_bins: int,
                   with_hist: bool = True):
    """Plain-PyTorch twin of ``tree_hist`` (see :func:`tree_hist`)."""
    K, N = row_node.shape
    S = stats.shape[2]
    D = B.shape[1]
    p = row_node.long() - offset
    at = (p >= 0) & (p < P)
    pk = torch.where(at, p, 0) + torch.arange(K, device=p.device)[:, None] * P
    w = stats * at[..., None].to(stats.dtype)
    totals = torch.zeros((K * P, S), dtype=stats.dtype, device=stats.device)
    totals.index_add_(0, pk.reshape(-1), w.reshape(-1, S))
    totals = totals.reshape(K, P, S)
    if not with_hist:
        return None, totals
    cell = ((pk[:, :, None] * D + torch.arange(D, device=p.device))
            * n_bins + B.long()[None])                       # [K, N, D]
    hist = torch.zeros((K * P * D * n_bins, S), dtype=stats.dtype,
                       device=stats.device)
    hist.index_add_(0, cell.reshape(-1),
                    w[:, :, None, :].expand(K, N, D, S).reshape(-1, S))
    return hist.reshape(K, P, D, n_bins, S), totals


def tree_hist(B: torch.Tensor, row_node: torch.Tensor, stats: torch.Tensor,
              offset: int, P: int, n_bins: int, with_hist: bool = True,
              skip_zero: bool = True):
    """Histograms of one tree level for K lanes at once.

    B int8 [N, D] bin ids (< n_bins); row_node int32 [K, N] heap node ids;
    stats f32 [K, N, S] per-row statistics.  Rows whose node lies in
    [offset, offset + P) contribute.  Returns (hist f32 [K, P, D, n_bins, S]
    or None when ``with_hist`` is False, totals f32 [K, P, S]).
    ``skip_zero`` lets the kernel pass over rows whose statistics are all
    zero (exact: adding zero changes no sum); False adds every row."""
    dev = B.device
    _check("tree_hist B", B, torch.int8, 2, dev)
    _check("tree_hist row_node", row_node, torch.int32, 2, dev)
    _check("tree_hist stats", stats, torch.float32, 3, dev)
    N, D = B.shape
    K, S = row_node.shape[0], stats.shape[2]
    if row_node.shape[1] != N or stats.shape[:2] != (K, N):
        raise ValueError("tree_hist: B, row_node and stats disagree on N/K")
    if dev.type == "cpu":
        return tree_hist_twin(B, row_node, stats, offset, P, n_bins, with_hist)
    if dev.type != "cuda":
        raise ValueError(f"tree_hist: unsupported device {dev}")
    if not with_hist:
        totals = torch.zeros((K, P, S), dtype=torch.float32, device=dev)
        _launch("tree_hist", B.data_ptr(), row_node.data_ptr(),
                stats.data_ptr(), totals.data_ptr(), totals.data_ptr(), N, D,
                n_bins, S, K, offset, P, D, 0,
                max(1, min(-(-N // 256), _BLOCKS_IN_FLIGHT // K + 1)),
                int(skip_zero), _stream(B))
        return None, totals
    # a block's histogram covers Pc nodes x Dc features; deep levels run as
    # several node windows, wide matrices as several feature chunks
    per_cell = n_bins * S * 4
    Pc = min(P, max(1, _HIST_SMEM_TARGET // (2 * per_cell)))
    Dc = min(D, (_HIST_SMEM_TARGET - Pc * S * 4) // (Pc * per_cell))
    n_chunks = -(-D // Dc)
    grid_x = max(1, min(-(-(N * Dc) // 256),
                        _BLOCKS_IN_FLIGHT // (K * n_chunks) + 1))
    hists, totals = [], []
    for p0 in range(0, P, Pc):
        pc = min(Pc, P - p0)
        h = torch.zeros((K, pc, D, n_bins, S), dtype=torch.float32, device=dev)
        t = torch.zeros((K, pc, S), dtype=torch.float32, device=dev)
        _launch("tree_hist", B.data_ptr(), row_node.data_ptr(),
                stats.data_ptr(), h.data_ptr(), t.data_ptr(), N, D, n_bins, S,
                K, offset + p0, pc, Dc, 1, grid_x, int(skip_zero),
                _stream(B))
        hists.append(h)
        totals.append(t)
    if len(hists) == 1:
        return hists[0], totals[0]
    return torch.cat(hists, dim=1), torch.cat(totals, dim=1)


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


def _first_max(gains, splits, min_gain) -> Dict[str, torch.Tensor]:
    """The split each (lane, node) takes from its gain table: the first max
    over (feature, bin) — lowest feature, then lowest bin — its leaf flag
    and threshold."""
    NB = splits.shape[1] + 1
    idx = torch.argmax(gains, dim=2)
    best = torch.gather(gains, 2, idx[..., None])[..., 0]
    feat = (idx // NB).to(torch.int32)
    bin_ = (idx % NB).to(torch.int32)
    leaf = ~(torch.isfinite(best) & (best > min_gain[:, None]))
    thr = splits[feat.long(), torch.clamp(bin_, 0, NB - 2).long()]
    return {"gain": best, "feature": feat, "bin": bin_, "is_leaf": leaf,
            "threshold": thr}


def split_gains(hist, totals, fmask, min_inst, lam) -> torch.Tensor:
    """The twin's gain table [K, P, D*NB]: xgb gain of every (feature, bin)
    split, -inf where the split is not allowed."""
    lam4 = lam[:, None, None, None]

    def score(s):
        return s[..., 1] ** 2 / (s[..., 2] + lam4)

    return _gain_table(hist, totals, fmask, min_inst,
                       lambda l, r, p: 0.5 * ((score(l) + score(r)) - score(p)))


def split_gap(hist, totals, fmask, min_inst, lam) -> torch.Tensor:
    """Best minus runner-up gain per (lane, node) [K, P]: the chosen split
    is well defined only where this gap is clear of rounding."""
    return _top2_gap(split_gains(hist, totals, fmask, min_inst, lam))


def tree_split_twin(hist, totals, fmask, splits, min_inst, min_gain, lam):
    """Plain-PyTorch twin of ``tree_split`` (see :func:`tree_split`)."""
    out = _first_max(split_gains(hist, totals, fmask, min_inst, lam), splits,
                     min_gain)
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
    return _first_max(split_gains_gini(hist, totals, fmask, node_mask,
                                       min_inst), splits, min_gain)


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


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


# kernel → the JAX program it replaces (file:line)
REPLACES = {
    "tree_hist": "transmogrifai_tpu/models/trees.py:313",
    "tree_split": "transmogrifai_tpu/models/trees.py:339",
    "tree_split_gini": "transmogrifai_tpu/models/trees.py:331",
    "tree_route": "transmogrifai_tpu/models/trees.py:373",
    "tree_walk": "transmogrifai_tpu/models/trees.py:668",
}
