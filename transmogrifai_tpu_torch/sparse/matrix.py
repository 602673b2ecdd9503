"""Flat-COO device matrix for hashed-text features (port of
``transmogrifai_tpu/sparse/matrix.py``).

Layout: three flat tensors on one device — ``values`` f32, ``indices``
int32 (column ids) and ``row_ids`` int32 — one entry each, in any order;
duplicate (row, column) entries add.  The JAX package pads the entry count
to a size ladder so that XLA replays compiled programs across batches;
eager PyTorch compiles nothing per shape, so nothing here is padded
(:func:`nnz_capacity` stays as the pure function).

The products run over two orders built once per matrix with plain torch
ops, on first use: the row-sorted order with ``row_ptr`` [n_rows + 1] feeds
``sp_matmat`` (``X @ M``), the column-sorted order (rows ascending within a
column) with ``col_ptr`` [n_cols + 1] feeds ``sp_rmatmat`` (``X.T @ G``);
both kernels are in ``sparse_kernels.py``, and each order's launch plan
(``segment_plan``, built from its pointers on first use on the card) is
kept beside it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .sparse_kernels import SegmentPlan, segment_plan, sp_matmat, sp_rmatmat

_NNZ_FLOOR = 1024


def nnz_capacity(n, floor=_NNZ_FLOOR):
    """Smallest ladder rung {2^k, 1.5*2^k} >= n, with a floor (≙
    ``nnz_capacity``)."""
    n = max(int(n), 1)
    cap = floor
    while cap < n:
        if (cap * 3) // 2 >= n:
            return (cap * 3) // 2
        cap *= 2
    return cap


class SegmentOrder(NamedTuple):
    """The entries sorted by segment (rows, or columns): segment s owns
    positions ``ptr[s] .. ptr[s+1]-1``; ``gather`` is the other coordinate,
    the row of the dense operand each entry reads."""
    values: torch.Tensor     # f32 [nnz]
    gather: torch.Tensor     # int32 [nnz]
    segment: torch.Tensor    # int32 [nnz], ascending
    ptr: torch.Tensor        # int64 [n_segments + 1]


def _segment_ptr(segment: torch.Tensor, n: int) -> torch.Tensor:
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=segment.device)
    if segment.numel():
        torch.cumsum(torch.bincount(segment, minlength=n), dim=0,
                     out=ptr[1:])
    return ptr


def sp_matvec(X: "SparseMatrix", v: torch.Tensor) -> torch.Tensor:
    """``X @ v`` [n_rows] (``sp_matmat`` with k = 1)."""
    return sp_matmat(X, v.reshape(-1, 1))[:, 0]


def sp_rmatvec(X: "SparseMatrix", u: torch.Tensor) -> torch.Tensor:
    """``X.T @ u`` [n_cols] (``sp_rmatmat`` with k = 1)."""
    return sp_rmatmat(X, u.reshape(-1, 1))[:, 0]


class SparseMatrix:
    """Device-resident flat-COO matrix (see the module docstring)."""

    __slots__ = ("values", "indices", "row_ids", "n_rows", "n_cols",
                 "_row_order", "_col_order", "_row_plan", "_col_plan",
                 "__weakref__")

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 row_ids: torch.Tensor, n_rows: int, n_cols: int):
        self.values = values.to(torch.float32)
        self.indices = indices.to(torch.int32)
        self.row_ids = row_ids.to(torch.int32)
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        if not (self.values.shape == self.indices.shape == self.row_ids.shape
                and self.values.ndim == 1):
            raise ValueError("values/indices/row_ids must share one flat shape")
        if not (self.values.device == self.indices.device
                == self.row_ids.device):
            raise ValueError("values/indices/row_ids must share one device")
        self._row_order: Optional[SegmentOrder] = None
        self._col_order: Optional[SegmentOrder] = None
        self._row_plan: Optional[SegmentPlan] = None
        self._col_plan: Optional[SegmentPlan] = None

    # ---- shape protocol ------------------------------------------------
    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(self.values.numel())

    @property
    def density(self) -> float:
        cells = self.n_rows * self.n_cols
        return float(self.nnz) / cells if cells else 0.0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.indices, self.row_ids))

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self):
        return (f"SparseMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"density={self.density:.2e}, device={self.device})")

    def __array__(self, dtype=None, copy=None):
        raise TypeError(
            "refusing to densify SparseMatrix implicitly "
            f"(shape {self.shape}); call .to_dense() explicitly")

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, n_rows: int, n_cols: int,
                 device: DeviceLike = None) -> "SparseMatrix":
        """From COO triples (host arrays or tensors) onto ``device`` (CUDA
        unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        t = [a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.require(a, requirements="W")) for a in (rows, cols, vals)]
        r, c, v = (a.to(dev, dt) for a, dt in zip(
            t, (torch.int32, torch.int32, torch.float32)))
        if r.numel() and not (
                0 <= int(r.min()) and int(r.max()) < n_rows
                and 0 <= int(c.min()) and int(c.max()) < n_cols):
            raise ValueError(f"COO entries outside a {n_rows} x {n_cols} "
                             "matrix")
        return cls(v, c, r, n_rows, n_cols)

    @classmethod
    def from_dense(cls, x, device: DeviceLike = None) -> "SparseMatrix":
        """Dense [N, D] → SparseMatrix of its nonzero cells."""
        is_t = isinstance(x, torch.Tensor)
        dev = x.device if is_t and device is None else resolve_device(device)
        t = (x if is_t else torch.as_tensor(np.array(x, np.float32))).to(
            dev, torch.float32)
        r, c = torch.nonzero(t, as_tuple=True)
        return cls(t[r, c], c, r, t.shape[0], t.shape[1])

    def to(self, device: DeviceLike) -> "SparseMatrix":
        """The matrix on ``device`` (itself when it is there already)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return SparseMatrix(self.values.to(dev), self.indices.to(dev),
                            self.row_ids.to(dev), self.n_rows, self.n_cols)

    def elementwise(self, fn) -> "SparseMatrix":
        """The same structure with ``fn`` applied to every stored value
        (``fn`` elementwise, so the sorted orders are mapped, not rebuilt,
        and their plans, which depend on the pointers alone, are shared)."""
        ro, co = self.row_order(), self.col_order()
        out = SparseMatrix(fn(self.values), self.indices, self.row_ids,
                           self.n_rows, self.n_cols)
        out._row_order = ro._replace(values=fn(ro.values))
        out._col_order = co._replace(values=fn(co.values))
        if self.device.type == "cuda":
            self.row_plan(), self.col_plan()
        out._row_plan, out._col_plan = self._row_plan, self._col_plan
        return out

    # ---- the sorted orders ---------------------------------------------
    def row_order(self) -> SegmentOrder:
        """Entries sorted by row (stable), gathering column ids."""
        if self._row_order is None:
            rows, vals, cols = self.row_ids, self.values, self.indices
            if rows.numel() > 1 and not bool((rows[1:] >= rows[:-1]).all()):
                perm = torch.argsort(rows, stable=True)
                rows, vals, cols = rows[perm], vals[perm], cols[perm]
            self._row_order = SegmentOrder(vals, cols, rows,
                                           _segment_ptr(rows, self.n_rows))
        return self._row_order

    def col_order(self) -> SegmentOrder:
        """Entries sorted by column, rows ascending within a column,
        gathering row ids."""
        if self._col_order is None:
            ro = self.row_order()
            perm = torch.argsort(ro.gather, stable=True)
            cols = ro.gather[perm]
            self._col_order = SegmentOrder(ro.values[perm],
                                           ro.segment[perm], cols,
                                           _segment_ptr(cols, self.n_cols))
        return self._col_order

    def row_plan(self) -> SegmentPlan:
        """The kernels' plan of the row order (``segment_plan``), built once."""
        if self._row_plan is None:
            self._row_plan = segment_plan(self.row_order().ptr)
        return self._row_plan

    def col_plan(self) -> SegmentPlan:
        """The kernels' plan of the column order, built once."""
        if self._col_plan is None:
            self._col_plan = segment_plan(self.col_order().ptr)
        return self._col_plan

    # ---- device linear algebra ------------------------------------------
    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return sp_matvec(self, v)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return sp_rmatvec(self, u)

    def matmat(self, m: torch.Tensor) -> torch.Tensor:
        return sp_matmat(self, m)

    def rmatmat(self, g: torch.Tensor) -> torch.Tensor:
        return sp_rmatmat(self, g)

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.matvec(other) if other.ndim == 1 else self.matmat(other)

    def to_dense(self) -> torch.Tensor:
        """The dense [n_rows, n_cols] tensor (tests and small data)."""
        out = torch.zeros((self.n_rows, self.n_cols), dtype=torch.float32,
                          device=self.device)
        return out.index_put_((self.row_ids.long(), self.indices.long()),
                              self.values, accumulate=True)

    # ---- rows -----------------------------------------------------------
    def pad_rows(self, n_rows: int) -> "SparseMatrix":
        """Grow to ``n_rows`` with empty rows (pads own no entries)."""
        if n_rows < self.n_rows:
            raise ValueError(f"pad_rows {n_rows} < n_rows {self.n_rows}")
        if n_rows == self.n_rows:
            return self
        return SparseMatrix(self.values, self.indices, self.row_ids, n_rows,
                            self.n_cols)

    def host_coo(self):
        """The entries as host numpy (rows, cols, vals)."""
        return (self.row_ids.cpu().numpy(), self.indices.cpu().numpy(),
                self.values.cpu().numpy())

    def take_rows(self, idx) -> "SparseMatrix":
        """Row subset in ``idx``'s order (duplicates allowed), gathered on
        the device from the row-sorted order."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_rows):
            raise IndexError(f"take_rows: rows outside [0, {self.n_rows})")
        ro = self.row_order()
        dev = self.device
        it = torch.as_tensor(idx, device=dev)
        starts = ro.ptr[it]
        counts = ro.ptr[it + 1] - starts
        new_rows = torch.repeat_interleave(
            torch.arange(len(idx), dtype=torch.int32, device=dev), counts)
        first = torch.cumsum(counts, dim=0) - counts
        pos = (torch.repeat_interleave(starts - first, counts)
               + torch.arange(new_rows.numel(), device=dev))
        return SparseMatrix(ro.values[pos], ro.gather[pos], new_rows,
                            len(idx), self.n_cols)

    def dense_rows(self, idx) -> np.ndarray:
        """A small row subset densified as host numpy [len(idx), n_cols]."""
        return self.take_rows(idx).to_dense().cpu().numpy()
