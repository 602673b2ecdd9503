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

import numpy as np
import torch

from .models.kernels import check as _check, launch, stream as _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_L] + [_I] * 10 + [_P]
_SMEM_MAX = 227 * 1024 - 32 * 32 * 4    # less the shared form's staging
_WARPS = 8
_SMEM_SM = 228 * 1024                   # an SM's shared memory
_SMEM_BLOCK = 1024                      # what the card keeps a block
_SHARED_BLOCKS_PER_SM = 2               # the shared form's grid
THREAD_THREADS = 256                    # the thread form's threads a block
# its grid: one wave of this many blocks an SM, or as many as the SM's
# shared memory holds (3 at C = 8, 2 at C = 9, 1 at C = 14); every C runs
# at 64 registers a thread.  On an H100 at 1M x 24: C = 4, 4 blocks 0.055
# ms against 2 blocks' 0.063 (two runs alike); C = 8, 3 blocks 0.072
# against 2 blocks' 0.075 (scripts/confusion_time.py --sweep)
THREAD_BLOCKS_PER_SM = 4
REDUCE_THREADS = 256                    # the block reduction's threads


FORMS = {"thread": 0, "shared": 1}      # the kernel's codes


class ConfusionPlan(NamedTuple):
    form: str         # "thread" (a thread's own cells) or "shared"
                      # (warps' histograms)
    k_chunk: int      # candidates a block
    c_chunk: int      # true classes a block
    threads: int      # threads a block
    rows: int         # the thread form: rows a pass (k_chunk * rows
                      # <= threads)
    blocks: int       # blocks along the rows (the partials' width)
    smem: int         # bytes of shared memory a block


def thread_form_fits(C: int) -> bool:
    """Whether a block of the thread form (``THREAD_THREADS`` threads, 4 C²
    bytes of cells a thread) fits shared memory: C up to 14."""
    return 4 * C * C * THREAD_THREADS <= _SMEM_MAX


def confusion_plan(K: int, C: int, N: int, sms: int) -> ConfusionPlan:
    """How ``multiclass_confusion`` splits K candidates of C classes over N
    rows on a card of ``sms`` SMs; the one place that sizes the launch.

    Where ``thread_form_fits(C)``: the thread form — a block's threads
    cover ``k_chunk`` = min(K, 256) candidates x ``rows`` = 256 // k_chunk
    rows in P's row-major order, one wave of blocks
    (``THREAD_BLOCKS_PER_SM`` an SM, or as many as its shared memory holds;
    fewer where N has fewer passes), a thread's C² cells and the tree over
    rows in shared memory (4 C² bytes a thread).  Larger C: the shared form
    — every candidate in one block where the warps' histograms fit shared
    memory, else fewer candidates a block, then fewer warps, then fewer
    true classes a block (one class row of C cells always fits for C up to
    ~58,000), over ``_SHARED_BLOCKS_PER_SM`` blocks an SM."""
    if K < 1 or C < 1 or N < 0 or sms < 1:
        raise ValueError(f"multiclass_confusion: {K} candidates, {C} "
                         f"classes, {N} rows, {sms} SMs")
    if thread_form_fits(C):
        kc = min(K, THREAD_THREADS)
        rb = THREAD_THREADS // kc
        threads = kc * rb
        smem = 4 * C * C * threads
        bps = min(THREAD_BLOCKS_PER_SM, _SMEM_SM // (smem + _SMEM_BLOCK))
        nb = max(1, min(sms * bps, -(-N // rb)))
        return ConfusionPlan("thread", kc, C, threads, rb, nb, smem)
    nb = max(1, min(sms * _SHARED_BLOCKS_PER_SM, -(-N // (32 * _WARPS))))
    cell = 4 * C * C
    for warps in (_WARPS, 4, 2, 1):
        kc = min(K, _SMEM_MAX // (warps * cell))
        if kc >= 1:
            return ConfusionPlan("shared", kc, C, 32 * warps, 0, nb,
                                 warps * kc * cell)
    cc = _SMEM_MAX // (4 * C)
    if cc < 1:
        raise ValueError(f"multiclass_confusion: {C} classes do not fit")
    return ConfusionPlan("shared", 1, cc, 32, 0, nb, 4 * cc * C)


def _reduce_emulate(partial: np.ndarray) -> np.ndarray:
    """``confusion_reduce_kernel`` in numpy: each row of partial [M, nb]
    summed by ``REDUCE_THREADS`` threads (thread j: j, j + 256, ... in
    order, from 0), then a halving tree over the threads."""
    f32 = np.float32
    M, nb = partial.shape
    T = REDUCE_THREADS
    red = np.zeros((M, T), f32)
    for j0 in range(0, nb, T):
        part = partial[:, j0:j0 + T]
        red[:, :part.shape[1]] += part
    w = T // 2
    while w:
        red[:, :w] += red[:, w:2 * w]
        w //= 2
    return red[:, 0]


def _thread_emulate(y, P, Wm, G, C, plan) -> np.ndarray:
    f32 = np.float32
    N, K = P.shape
    kc, rb, nb = plan.k_chunk, plan.rows, plan.blocks
    CC = C * C
    partial = np.zeros((K * CC, nb), f32)
    step = nb * rb
    first = np.arange(nb)[:, None] * rb + np.arange(rb)[None, :]  # [nb, rb]
    for k0 in range(0, K, kc):
        ks = np.arange(k0, min(K, k0 + kc))
        acc = np.zeros((nb, rb, len(ks), CC), f32)
        for m in range(-(-N // step)):          # a thread's rows, in order
            n = first + m * step
            ok = n < N
            nn = np.where(ok, n, 0)
            a = y[nn][..., None]
            p = P[nn][..., ks]
            valid = ok[..., None] & (a >= 0) & (a < C) & (p >= 0) & (p < C)
            cell = np.where(valid, a * C + p, 0)[..., None]
            w = np.where(valid, Wm[ks // G][:, nn].transpose(1, 2, 0), 0)
            cur = np.take_along_axis(acc, cell, axis=-1)
            np.put_along_axis(acc, cell, cur + w[..., None].astype(f32),
                              axis=-1)
        h = 1
        while h < rb:
            h *= 2
        h //= 2
        while h:                                # the fixed tree over rows
            lo = np.arange(min(h, rb - h))
            acc[:, lo] = acc[:, lo] + acc[:, lo + h]
            h //= 2
        partial[(ks[:, None] * CC + np.arange(CC)).reshape(-1)] = \
            acc[:, 0].reshape(nb, -1).T
    return partial


def _shared_emulate(y, P, Wm, G, C, plan) -> np.ndarray:
    f32 = np.float32
    N, K = P.shape
    warps, nb = plan.threads // 32, plan.blocks
    CC = C * C
    hist = np.zeros((nb, warps, K, CC), f32)
    tw = nb * warps
    first = np.arange(nb)[:, None] * warps + np.arange(warps)[None, :]
    ks = np.arange(K)
    groups = -(-N // 32)
    for m in range(-(-groups // tw)):           # a warp's groups of 32 rows
        s = np.zeros_like(hist)
        for lane in range(32):                  # the group's lanes in order
            n = (first + m * tw) * 32 + lane
            ok = n < N
            nn = np.where(ok, n, 0)
            a = y[nn][..., None]
            p = P[nn]
            w = Wm[ks // G][:, nn].transpose(1, 2, 0)
            valid = (ok[..., None] & (a >= 0) & (a < C) & (w != 0)
                     & (p >= 0) & (p < C))
            cell = np.where(valid, a * C + p, 0)[..., None]
            cur = np.take_along_axis(s, cell, axis=-1)
            np.put_along_axis(s, cell, cur + np.where(valid, w, 0)[
                ..., None].astype(f32), axis=-1)
        hist += s
    blk = np.zeros((nb, K, CC), f32)
    for v in range(warps):                      # the warps' copies in order
        blk += hist[:, v]
    return blk.reshape(nb, K * CC).T.copy()


def confusion_emulate(y, P, Wm, G: int, C: int,
                      plan: ConfusionPlan) -> np.ndarray:
    """The kernel's sums in numpy f32 on the wrapper's own arrays (y int
    [N], P int [N, K], Wm f32 [F, N]) under ``plan`` (``confusion_plan``
    of the card the kernel ran on): the thread form's per-thread row sums in row order,
    its fixed tree over a block's rows, or the shared form's per-warp
    histograms (each 32 rows' group of a cell in lane order, then the warps
    in order); then the blocks in the reduction kernel's order.  Returns
    conf f32 [K, C, C] — the card kernel's bits."""
    y, P, Wm = (np.asarray(a) for a in (y, P, Wm))
    N, K = P.shape
    if N == 0:
        return np.zeros((K, C, C), np.float32)
    Wm = Wm.astype(np.float32)
    partial = (_shared_emulate if plan.form == "shared"
               else _thread_emulate)(y, P, Wm, G, C, plan)
    return _reduce_emulate(partial).reshape(K, C, C)


def multiclass_confusion_twin(y, P, Wm, G: int, C: int) -> torch.Tensor:
    """Plain-PyTorch twin of :func:`multiclass_confusion`: one weighted
    ``index_add_`` over every (candidate, row); labels or predictions
    outside [0, C) add nothing (a one-hot of them is zero)."""
    N, K = P.shape
    k = torch.arange(K, device=P.device)
    yl, pl = y[None, :].long(), P.T.long()                          # [K, N]
    ok = (yl >= 0) & (yl < C) & (pl >= 0) & (pl < C)
    cells = torch.where(ok, (k[:, None] * C + yl) * C + pl, 0)
    w = torch.where(ok, Wm[k // G], 0)                              # [K, N]
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
    plan = confusion_plan(
        K, C, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((K * C * C, plan.blocks), dtype=torch.float32,
                          device=dev)
    out = torch.empty((K, C, C), dtype=torch.float32, device=dev)
    launch("multiclass_confusion", _ARGTYPES, y.data_ptr(), P.data_ptr(),
           Wm.data_ptr(), partial.data_ptr(), out.data_ptr(), N, K, C, G,
           FORMS[plan.form], plan.k_chunk, plan.c_chunk,
           plan.threads, plan.rows, plan.blocks, plan.smem, _stream(y))
    return out
