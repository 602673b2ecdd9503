"""Hashed text → device sparse matrix (port of
``transmogrifai_tpu/sparse/transform.py``).

The text profile's flat bucket stream ``(lens [N], flat [total])`` is
deduplicated on the host — one ``np.unique`` over int64 (row, bucket) keys,
O(tokens log tokens), no ``num_hashes``-sized allocation anywhere — and the
COO triples go to the device as a :class:`~.matrix.SparseMatrix`, so memory
is O(nnz) whatever the hash width.  ``combine_blocks`` stacks sparse and
dense blocks on the device.  Also home to the process-wide sparse stats
(nnz, cells, density of the last matrix built).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .matrix import SparseMatrix

_LOCK = threading.Lock()
_STATS = {"nnz_total": 0, "cells_total": 0, "matrices": 0, "density": 0.0}


def record_sparse_stats(sm: SparseMatrix) -> None:
    """Fold one built matrix into the process-wide sparse stats."""
    with _LOCK:
        _STATS["nnz_total"] += int(sm.nnz)
        _STATS["cells_total"] += int(sm.n_rows) * int(sm.n_cols)
        _STATS["matrices"] += 1
        _STATS["density"] = float(sm.density)


def sparse_stats() -> dict:
    """Snapshot: cumulative nnz/cells plus the last-built matrix density."""
    with _LOCK:
        return dict(_STATS)


def reset_sparse_stats() -> None:
    with _LOCK:
        _STATS.update(nnz_total=0, cells_total=0, matrices=0, density=0.0)


def sparse_from_hash_flat(lens, flat, num_hashes: int, *, binary=False,
                          record=True, device: DeviceLike = None
                          ) -> SparseMatrix:
    """Flat hashed-bucket stream → deduplicated SparseMatrix on ``device``.

    ``lens [N]`` is tokens per row, ``flat [sum(lens)]`` the bucket ids.
    Duplicate (row, bucket) hits count (``binary=False``) or collapse to
    1.0 (``binary=True``); rows without tokens own no entries.  The entries
    come out row-major sorted (the sort ``np.unique`` makes)."""
    lens = np.asarray(lens, dtype=np.int64)
    flat = np.asarray(flat, dtype=np.int64)
    n = len(lens)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    keys, counts = np.unique(rows * num_hashes + flat, return_counts=True)
    out_rows = keys // num_hashes
    out_cols = keys % num_hashes
    vals = (np.ones(len(keys), dtype=np.float32) if binary
            else counts.astype(np.float32))
    sm = SparseMatrix.from_coo(out_rows, out_cols, vals, n, num_hashes,
                               device=device)
    if record:
        record_sparse_stats(sm)
    return sm


def hash_tokens_to_sparse(token_lists, num_hashes: int, *, binary=False,
                          device: DeviceLike = None) -> SparseMatrix:
    """Tokenized rows → SparseMatrix via the shared FNV-1a hasher."""
    from ..ops.text import hash_tokens_flat
    lens, flat = hash_tokens_flat(token_lists, num_hashes)
    return sparse_from_hash_flat(lens, flat, num_hashes, binary=binary,
                                 device=device)


def combine_blocks(blocks, n_rows: int, *, record=True,
                   device: DeviceLike = None) -> SparseMatrix:
    """Stack feature blocks side by side into one SparseMatrix.

    ``blocks`` holds SparseMatrix blocks and dense [n_rows, w] (or [n_rows])
    host arrays or tensors; a dense block contributes its nonzero cells.
    Column offsets follow block order, the dense ``VectorsCombiner``
    layout.  The result lives on ``device``, else on the first sparse
    block's device, else on CUDA."""
    if device is None:
        device = next((b.device for b in blocks
                       if isinstance(b, SparseMatrix)), None)
    dev = resolve_device(device)
    if (len(blocks) == 1 and isinstance(blocks[0], SparseMatrix)
            and blocks[0].n_rows == n_rows and blocks[0].device == dev):
        if record:
            record_sparse_stats(blocks[0])
        return blocks[0]
    rows, cols, vals = [], [], []
    offset = 0
    for blk in blocks:
        if isinstance(blk, SparseMatrix):
            blk = blk.to(dev)
            r, c, v, w, nr = (blk.row_ids, blk.indices, blk.values,
                              blk.n_cols, blk.n_rows)
        else:
            arr = (blk if isinstance(blk, torch.Tensor)
                   else torch.as_tensor(np.asarray(blk, np.float32))).to(
                dev, torch.float32)
            if arr.ndim == 1:
                arr = arr[:, None]
            r, c = torch.nonzero(arr, as_tuple=True)
            v, (nr, w) = arr[r, c], arr.shape
        if nr != n_rows:
            raise ValueError(f"block rows {nr} != batch rows {n_rows}")
        rows.append(r.to(torch.int32))
        cols.append(c.to(torch.int32) + offset)
        vals.append(v)
        offset += w
    if not rows:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return SparseMatrix(empty.float(), empty, empty, n_rows, 0)
    sm = SparseMatrix(torch.cat(vals), torch.cat(cols), torch.cat(rows),
                      n_rows, offset)
    if record:
        record_sparse_stats(sm)
    return sm
