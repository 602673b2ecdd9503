"""Masked on-device metrics for the CV loop (port of the binary,
regression and multiclass panels of ``transmogrifai_tpu/metrics_device.py``;
≙ OpBinaryClassificationEvaluator.scala:67-185, OpRegressionEvaluator and
OpMultiClassificationEvaluator semantics).

Every validation metric is a reduction over the FULL row set with a 0/1
validation mask, so folds never change shapes.  Ties are exact: for sorted
scores, ``searchsorted(s, s)`` left/right gives each row's tie group, which
yields midranks for AuROC and threshold grouping for AuPR.  All functions
take a trailing row axis and batch over any leading axes, so one call scores
a whole (fold × grid) panel.
"""

from __future__ import annotations

import torch

from .metrics_kernels import multiclass_confusion


def _sorted_by(scores, *cols, descending=False):
    order = torch.argsort(scores, dim=-1, descending=descending, stable=True)
    return [torch.gather(c, -1, order) for c in (scores, *cols)]


def masked_auroc(y: torch.Tensor, scores: torch.Tensor, w: torch.Tensor):
    """Weighted Mann-Whitney AUC with exact midrank ties over the last axis
    (≙ ``masked_auroc``, metrics_device.py:28).  y, scores, w broadcast to a
    common [..., N]; rows with w=0 are ignored."""
    scores, y, w = torch.broadcast_tensors(scores, y, w)
    ss, yy, ww = _sorted_by(scores.contiguous(), y.contiguous(), w.contiguous())
    wpos = ww * (yy > 0.5)
    wneg = ww * (yy <= 0.5)
    zero = torch.zeros(wneg.shape[:-1] + (1,), dtype=wneg.dtype,
                       device=wneg.device)
    prefix_neg = torch.cat([zero, torch.cumsum(wneg, dim=-1)], dim=-1)
    left = torch.searchsorted(ss, ss, right=False)
    right = torch.searchsorted(ss, ss, right=True)
    below = torch.gather(prefix_neg, -1, left)
    same = torch.gather(prefix_neg, -1, right) - below
    num = torch.sum(wpos * (below + 0.5 * same), dim=-1)
    n_pos = torch.sum(wpos, dim=-1)
    n_neg = torch.sum(wneg, dim=-1)
    return torch.where(n_pos * n_neg > 0,
                       num / torch.clamp(n_pos * n_neg, min=1e-12), 0.0)


def masked_aupr(y: torch.Tensor, scores: torch.Tensor, w: torch.Tensor):
    """Weighted area under the PR curve, MLlib style: threshold-grouped,
    trapezoid over recall with a prepended (0, 1) point
    (≙ ``masked_aupr``, metrics_device.py:49)."""
    scores, y, w = torch.broadcast_tensors(scores, y, w)
    ss, yy, ww = _sorted_by(scores.contiguous(), y.contiguous(),
                            w.contiguous(), descending=True)
    tp_run = torch.cumsum(ww * (yy > 0.5), dim=-1)
    fp_run = torch.cumsum(ww * (yy <= 0.5), dim=-1)
    # every row reads its tie group's LAST cumsum (the threshold boundary)
    neg = -ss
    right = torch.searchsorted(neg, neg, right=True) - 1
    tp = torch.gather(tp_run, -1, right)
    fp = torch.gather(fp_run, -1, right)
    total_pos = tp_run[..., -1:]
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / torch.clamp(total_pos, min=1e-12)
    recall = torch.cat([torch.zeros_like(total_pos), recall], dim=-1)
    precision = torch.cat([torch.ones_like(total_pos), precision], dim=-1)
    area = torch.trapezoid(precision, recall, dim=-1)
    return torch.where(total_pos[..., 0] > 0, area, 0.0)


def masked_auroc_grid(y, S, W):
    """``masked_auroc`` for K score columns: S [N, K], W one shared [N] mask
    or per-candidate [K, N] masks → [K]."""
    return masked_auroc(y, S.T, W)


def masked_aupr_grid(y, S, W):
    """``masked_aupr`` over K score columns (see masked_auroc_grid)."""
    return masked_aupr(y, S.T, W)


def masked_auroc_fold_grid(y, S, W):
    """The (fold × grid) AUC panel: S [N, F, G], W [F, N] → [F, G]."""
    return masked_auroc(y, S.permute(1, 2, 0), W[:, None, :])


def masked_aupr_fold_grid(y, S, W):
    """The (fold × grid) AuPR panel: S [N, F, G], W [F, N] → [F, G]."""
    return masked_aupr(y, S.permute(1, 2, 0), W[:, None, :])


def masked_binary_confusion(y, yhat, w):
    """Weighted [..., 4] (tp, fp, tn, fn) over the last axis: y, yhat
    (hard 0/1 predictions), w broadcast to a common [..., N] (≙
    ``masked_binary_confusion``, metrics_device.py:116-122)."""
    yp = y > 0.5
    hp = yhat > 0.5
    return torch.stack([torch.sum(w * (yp & hp), dim=-1),
                        torch.sum(w * (~yp & hp), dim=-1),
                        torch.sum(w * (~yp & ~hp), dim=-1),
                        torch.sum(w * (yp & ~hp), dim=-1)], dim=-1)


BINARY_CONF_METRICS = ("Precision", "Recall", "F1", "Error")


def binary_conf_metric(conf, metric: str):
    """Precision, Recall, F1 or Error of [..., 4] (tp, fp, tn, fn) counts,
    in f64 in the order the JAX package's evaluator takes them on the host
    (``evaluate_masked``, evaluators.py:241-261): 0 where precision's or
    recall's denominator, or their sum for F1, is 0; Error over
    max(tp + fp + tn + fn, 1)."""
    if metric not in BINARY_CONF_METRICS:
        raise ValueError(f"binary confusion metric {metric!r}")
    tp, fp, tn, fn = conf.double().unbind(-1)
    if metric == "Error":
        return (fp + fn) / torch.clamp(tp + fp + tn + fn, min=1.0)
    precision = torch.where(tp + fp > 0, tp / (tp + fp), 0.0)
    recall = torch.where(tp + fn > 0, tp / (tp + fn), 0.0)
    if metric == "Precision":
        return precision
    if metric == "Recall":
        return recall
    return torch.where(precision + recall > 0,
                       2.0 * precision * recall / (precision + recall), 0.0)


def masked_binary_metric_grid(y, P, W, metric: str):
    """One confusion metric of K hard-prediction columns P [N, K] over W,
    one shared [N] mask or per-candidate [K, N] masks → [K] f64."""
    return binary_conf_metric(masked_binary_confusion(y, P.T, W), metric)


def masked_binary_metric_fold_grid(y, P, W, metric: str):
    """The (fold × grid) confusion-metric panel: P [N, F, G] hard
    predictions, W [F, N] fold masks → [F, G] f64."""
    return binary_conf_metric(masked_binary_confusion(
        y, P.permute(1, 2, 0), W[:, None, :]), metric)


def masked_threshold_confusion(y, scores, w, thresholds):
    """Per-threshold [4, T] weighted (tp, fp, tn, fn): scores bucket into the
    ascending threshold grid, and the counts at a threshold are suffix sums
    of the [T+1]-bin histogram (≙ ``masked_threshold_confusion``)."""
    wpos = w * (y > 0.5)
    wneg = w * (y <= 0.5)
    bins = torch.searchsorted(thresholds, scores.contiguous(), right=True)
    T = thresholds.shape[0]
    pos_hist = torch.zeros(T + 1, dtype=w.dtype, device=w.device)
    neg_hist = torch.zeros(T + 1, dtype=w.dtype, device=w.device)
    pos_hist.index_add_(0, bins, wpos)
    neg_hist.index_add_(0, bins, wneg)
    tp = torch.flip(torch.cumsum(torch.flip(pos_hist, [0]), 0), [0])[1:]
    fp = torch.flip(torch.cumsum(torch.flip(neg_hist, [0]), 0), [0])[1:]
    return torch.stack([tp, fp, torch.sum(wneg) - fp, torch.sum(wpos) - tp])


REG_METRICS = ("RootMeanSquaredError", "MeanSquaredError",
               "MeanAbsoluteError", "R2")


def masked_reg_errors(y: torch.Tensor, yhat: torch.Tensor, w: torch.Tensor):
    """Weighted (mse, mae) over the last axis as one stacked [..., 2]
    tensor (≙ ``masked_reg_errors``, metrics_device.py:124-130)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    err = yhat - y
    return torch.stack([torch.sum(w * err * err, dim=-1) / wsum,
                        torch.sum(w * torch.abs(err), dim=-1) / wsum], dim=-1)


def _masked_reg_metric(y, yhat, w, metric: str):
    """One regression metric over the last axis: RMSE, MSE, MAE, or R² =
    1 - mse / (the masked labels' weighted variance; 0 where that is 0)."""
    if metric not in REG_METRICS:
        raise ValueError(f"regression metric {metric!r}")
    y, yhat, w = torch.broadcast_tensors(y, yhat, w)
    errs = masked_reg_errors(y, yhat, w)
    if metric == "RootMeanSquaredError":
        return torch.sqrt(errs[..., 0])
    if metric == "MeanSquaredError":
        return errs[..., 0]
    if metric == "MeanAbsoluteError":
        return errs[..., 1]
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    ym = torch.sum(w * y, dim=-1, keepdim=True) / wsum[..., None]
    var = torch.sum(w * (y - ym) ** 2, dim=-1) / wsum
    return torch.where(var > 0, 1.0 - errs[..., 0] / torch.where(
        var > 0, var, 1.0), 0.0)


def masked_reg_metric_grid(y, S, W, metric: str):
    """One regression metric of K prediction columns S [N, K] (linear
    regression margins ARE the predictions) over W, one shared [N] mask or
    per-candidate [K, N] masks → [K] (≙ ``masked_reg_metric_grid``,
    metrics_device.py:142-155)."""
    return _masked_reg_metric(y, S.T, W, metric)


def masked_reg_metric_fold_grid(y, S, W, metric: str):
    """The (fold × grid) regression panel: S [N, F, G] predictions, W [F, N]
    fold masks → [F, G] (≙ ``masked_reg_metric_fold_grid``,
    metrics_device.py:158-167)."""
    return _masked_reg_metric(y, S.permute(1, 2, 0), W[:, None, :], metric)


MULTI_METRICS = ("Precision", "Recall", "F1", "Error")


def masked_multiclass_confusion(y, yhat, w, *, n_classes: int):
    """Weighted [C, C] confusion matrix of one prediction column, in f32
    (≙ ``masked_multiclass_confusion``, metrics_device.py:134-141): y, yhat
    [N] class ids (any dtype), w [N] — the ``multiclass_confusion`` kernel
    with one candidate."""
    return multiclass_confusion(
        y.to(torch.int32).contiguous(),
        yhat.to(torch.int32).reshape(-1, 1).contiguous(),
        w.to(torch.float32).reshape(1, -1).contiguous(), 1, n_classes)[0]


def conf_metric(conf, metric: str):
    """Weighted Precision / Recall / F1 / Error of [..., C, C] confusion
    matrices, in f32 with the JAX panel's zero guards (≙ ``_conf_metric``,
    metrics_device.py:177-199) → [...]."""
    if metric not in MULTI_METRICS:
        raise ValueError(f"multiclass metric {metric!r}")
    support = conf.sum(dim=-1)
    tp = torch.diagonal(conf, dim1=-2, dim2=-1)
    if metric == "Error":
        return 1.0 - tp.sum(dim=-1) / torch.clamp(support.sum(dim=-1),
                                                  min=1.0)
    pred_count = conf.sum(dim=-2)
    prec_c = torch.where(pred_count > 0,
                         tp / torch.clamp(pred_count, min=1e-30), 0.0)
    rec_c = torch.where(support > 0, tp / torch.clamp(support, min=1e-30),
                        0.0)
    wts = support / torch.clamp(support.sum(dim=-1, keepdim=True), min=1.0)
    if metric == "Precision":
        x = prec_c
    elif metric == "Recall":
        x = rec_c
    else:
        x = torch.where(prec_c + rec_c > 0, 2.0 * prec_c * rec_c
                        / torch.clamp(prec_c + rec_c, min=1e-30), 0.0)
    # the class-weighted sum in the order XLA's f32 dot takes on the CPU
    # (measured for C <= 8): one fused multiply-add a class for a single
    # matrix or two classes (emulated in f64, where the f32 product is
    # exact), rounded products added class by class for a batch of
    # matrices, so racing ranks see the JAX package's bits
    fused = conf[..., 0, 0].numel() == 1 or conf.shape[-1] == 2
    acc = wts[..., 0] * x[..., 0]
    for c in range(1, conf.shape[-1]):
        if fused:
            acc = (wts[..., c].double() * x[..., c].double()
                   + acc.double()).float()
        else:
            acc = acc + wts[..., c] * x[..., c]
    return acc


def masked_multiclass_metric_grid(y, P, W, *, n_classes: int, metric: str):
    """One multiclass metric of K integer prediction columns P [N, K] over W,
    one shared [N] mask or per-candidate [K, N] masks → [K] (≙
    ``masked_multiclass_metric_grid``, metrics_device.py:202-215).  Classes
    absent from the data add no support, so a generous ``n_classes`` is
    exact."""
    K = P.shape[1]
    Wm = W.reshape(1, -1) if W.ndim == 1 else W
    conf = multiclass_confusion(
        y.to(torch.int32).contiguous(), P.to(torch.int32).contiguous(),
        Wm.to(torch.float32).contiguous(), K if W.ndim == 1 else 1,
        n_classes)
    return conf_metric(conf, metric)


def masked_multiclass_metric_fold_grid(y, P, W, *, n_classes: int,
                                       metric: str):
    """The (fold × grid) multiclass panel: P [N, F, G] integer predictions,
    W [F, N] fold masks → [F, G] (≙ ``masked_multiclass_metric_fold_grid``,
    metrics_device.py:218-230): one ``multiclass_confusion`` launch for
    every (fold, candidate)."""
    N, F, G = P.shape
    conf = multiclass_confusion(
        y.to(torch.int32).contiguous(),
        P.to(torch.int32).reshape(N, F * G).contiguous(),
        W.to(torch.float32).contiguous(), G, n_classes)
    return conf_metric(conf, metric).reshape(F, G)
