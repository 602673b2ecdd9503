"""The multiclass metric panels' kernel: ``multiclass_confusion``, its
wrapper and its plain-PyTorch twin (the dispatch rule and launch counters
are in ``models/kernels.py``).

| kernel               | replaces (transmogrifai_tpu/metrics_device.py)          |
|----------------------|---------------------------------------------------------|
| multiclass_confusion | ``masked_multiclass_confusion`` (:135-141), vmapped by ``masked_multiclass_metric_grid`` / ``_fold_grid`` (:202-230) |

The JAX package forms each candidate's weighted [C, C] confusion matrix as a
one-hot × one-hot matmul; on the card it is a histogram of (label,
prediction) cells, one pass over the rows for a chunk of candidates.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .models.kernels import check as _check, launch, stream as _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_L] + [_I] * 8 + [_P]
_SMEM_MAX = 227 * 1024 - 32 * 32 * 4    # less the kernel's static staging
_WARPS = 8
_N_BLOCKS = 132 * 2


class ConfusionPlan(NamedTuple):
    k_chunk: int      # candidates a block
    c_chunk: int      # true classes a block
    warps: int        # warps a block, each with its own histogram copy
    smem: int         # bytes of histograms a block


def confusion_plan(K: int, C: int) -> ConfusionPlan:
    """How ``multiclass_confusion`` splits K candidates of C classes over
    blocks: every candidate in one block where the warps' histograms fit
    shared memory, else fewer candidates a block, then fewer warps, then
    fewer true classes a block (one class row of C cells always fits for C
    up to ~58,000).  The one place that sizes the kernel's shared memory."""
    if K < 1 or C < 1:
        raise ValueError(f"multiclass_confusion: {K} candidates, {C} classes")
    cell = 4 * C * C
    for warps in (_WARPS, 4, 2, 1):
        kc = min(K, _SMEM_MAX // (warps * cell))
        if kc >= 1:
            return ConfusionPlan(kc, C, warps, warps * kc * cell)
    cc = _SMEM_MAX // (4 * C)
    if cc < 1:
        raise ValueError(f"multiclass_confusion: {C} classes do not fit")
    return ConfusionPlan(1, cc, 1, 4 * cc * C)


def multiclass_confusion_twin(y, P, Wm, G: int, C: int) -> torch.Tensor:
    """Plain-PyTorch twin of :func:`multiclass_confusion`: one weighted
    ``index_add_`` over every (candidate, row)."""
    N, K = P.shape
    k = torch.arange(K, device=P.device)
    cells = (k[:, None] * C + y[None, :].long()) * C + P.T.long()   # [K, N]
    w = Wm[k // G]                                                  # [K, N]
    conf = torch.zeros(K * C * C, dtype=Wm.dtype, device=P.device)
    conf.index_add_(0, cells.reshape(-1), w.reshape(-1))
    return conf.reshape(K, C, C)


def multiclass_confusion(y: torch.Tensor, P: torch.Tensor, Wm: torch.Tensor,
                         G: int, C: int) -> torch.Tensor:
    """Weighted confusion matrices of K candidates: y int32 [N] class ids,
    P int32 [N, K] predictions (each < C), Wm f32 [F, N] row weights,
    candidate k reading row ``k // G`` (one [1, N] mask with G = K for a
    shared one).  Returns conf f32 [K, C, C], ``conf[k, y, ŷ] = Σ w``.  On
    the card the sums run in a fixed order: the same inputs give the same
    bits on every run, for any weights."""
    dev = y.device
    _check("multiclass_confusion y", y, torch.int32, 1, dev)
    _check("multiclass_confusion P", P, torch.int32, 2, dev)
    _check("multiclass_confusion Wm", Wm, torch.float32, 2, dev)
    N, K = P.shape
    if y.shape[0] != N or Wm.shape[1] != N or (K - 1) // G >= Wm.shape[0]:
        raise ValueError("multiclass_confusion: shapes of y/P/Wm and "
                         "candidates disagree")
    if dev.type == "cpu":
        return multiclass_confusion_twin(y, P, Wm, G, C)
    if dev.type != "cuda":
        raise ValueError(f"multiclass_confusion: unsupported device {dev}")
    if N == 0:
        return torch.zeros((K, C, C), dtype=torch.float32, device=dev)
    plan = confusion_plan(K, C)
    nb = max(1, min(_N_BLOCKS, -(-N // (32 * plan.warps))))
    partial = torch.empty((K * C * C, nb), dtype=torch.float32, device=dev)
    out = torch.empty((K, C, C), dtype=torch.float32, device=dev)
    launch("multiclass_confusion", _ARGTYPES, y.data_ptr(), P.data_ptr(),
           Wm.data_ptr(), partial.data_ptr(), out.data_ptr(), N, K, C, G,
           plan.k_chunk, plan.c_chunk, plan.warps, nb, plan.smem, _stream(y))
    return out
