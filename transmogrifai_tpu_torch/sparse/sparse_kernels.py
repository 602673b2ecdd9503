"""The sparse path's kernels: ``sp_matmat`` and ``sp_rmatmat``, their
wrappers and their plain-PyTorch twins (the dispatch rule and launch
counters are in ``models/kernels.py``).

| kernel     | replaces (transmogrifai_tpu/sparse/matrix.py)                       |
|------------|----------------------------------------------------------------------|
| sp_matmat  | ``sp_matmat`` and ``sp_matvec`` (:45-63): take + ``segment_sum``    |
| sp_rmatmat | ``sp_rmatmat`` and ``sp_rmatvec`` (:52-70): take + ``segment_sum``  |

The wrappers take a :class:`~.matrix.SparseMatrix`: on the card they launch
over its row-sorted (``sp_matmat``) or column-sorted (``sp_rmatmat``)
order, on the CPU the twin runs over its flat entries as they are.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.kernels import check as _check, launch, stream as _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_L, _I, _I, _P]
CHUNK = 256          # entries per warp of pass 1 (csrc/sp_segsum.cuh)
MAX_K = 32           # dense columns per launch


def sp_matmat_twin(values, indices, row_ids, m, n_rows: int) -> torch.Tensor:
    """``X @ M`` from flat entries (``values`` [nnz], ``indices`` column
    ids, ``row_ids``) and ``M`` [n_cols, k]: the JAX body transliterated,
    a take of M's rows and an ``index_add_`` over the row ids."""
    prod = values.to(m.dtype)[:, None] * m[indices.long()]
    out = torch.zeros((n_rows, m.shape[1]), dtype=prod.dtype,
                      device=m.device)
    return out.index_add_(0, row_ids.long(), prod)


def sp_rmatmat_twin(values, indices, row_ids, g, n_cols: int) -> torch.Tensor:
    """``X.T @ G`` from flat entries and ``G`` [n_rows, k]: a take of G's
    rows and an ``index_add_`` over the column ids."""
    prod = values.to(g.dtype)[:, None] * g[row_ids.long()]
    out = torch.zeros((n_cols, g.shape[1]), dtype=prod.dtype,
                      device=g.device)
    return out.index_add_(0, indices.long(), prod)


def _launch(name: str, order, dense: torch.Tensor, n_seg: int
            ) -> torch.Tensor:
    """Launch ``name`` over a segment order, 32 dense columns at a time."""
    k = dense.shape[1]
    if k > MAX_K:
        return torch.cat([_launch(name, order, dense[:, j:j + MAX_K]
                                  .contiguous(), n_seg)
                          for j in range(0, k, MAX_K)], dim=1)
    out = torch.zeros((n_seg, k), dtype=torch.float32, device=dense.device)
    nnz = order.values.numel()
    if nnz == 0 or k == 0:
        return out
    n_chunks = -(-nnz // CHUNK)
    head = torch.empty((n_chunks, k), dtype=torch.float32,
                       device=dense.device)
    tail = torch.empty_like(head)
    launch(name, _ARGTYPES, order.values.data_ptr(), order.gather.data_ptr(),
           order.segment.data_ptr(), order.ptr.data_ptr(), dense.data_ptr(),
           out.data_ptr(), head.data_ptr(), tail.data_ptr(), nnz, k, CHUNK,
           _stream(dense))
    return out


def _dense_operand(name: str, X, d: torch.Tensor, rows: int) -> None:
    _check(name, d, torch.float32, 2, X.device)
    if d.shape[0] != rows:
        raise ValueError(f"{name}: {d.shape[0]} rows, expected {rows}")


def sp_matmat(X, m: torch.Tensor) -> torch.Tensor:
    """``X @ M`` → f32 [n_rows, k] for a SparseMatrix ``X`` and a contiguous
    f32 ``M`` [n_cols, k] on X's device.  The card's sums run in a fixed
    order: the same inputs give the same bits on every run."""
    _dense_operand("sp_matmat M", X, m, X.n_cols)
    dev = X.device
    if dev.type == "cpu":
        return sp_matmat_twin(X.values, X.indices, X.row_ids, m, X.n_rows)
    if dev.type != "cuda":
        raise ValueError(f"sp_matmat: unsupported device {dev}")
    return _launch("sp_matmat", X.row_order(), m, X.n_rows)


def sp_rmatmat(X, g: torch.Tensor) -> torch.Tensor:
    """``X.T @ G`` → f32 [n_cols, k] for a SparseMatrix ``X`` and a
    contiguous f32 ``G`` [n_rows, k] on X's device; bit-repeatable on the
    card like :func:`sp_matmat`."""
    _dense_operand("sp_rmatmat G", X, g, X.n_rows)
    dev = X.device
    if dev.type == "cpu":
        return sp_rmatmat_twin(X.values, X.indices, X.row_ids, g, X.n_cols)
    if dev.type != "cuda":
        raise ValueError(f"sp_rmatmat: unsupported device {dev}")
    return _launch("sp_rmatmat", X.col_order(), g, X.n_cols)
