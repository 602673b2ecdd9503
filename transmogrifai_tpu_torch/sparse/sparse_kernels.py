"""The sparse path's kernels: ``sp_matmat`` and ``sp_rmatmat``, their
wrappers, their plain-PyTorch twins, the launch plan of a segment order and
a numpy emulation of the kernels' summation order (the dispatch rule and
launch counters are in ``models/kernels.py``).

| kernel     | replaces (transmogrifai_tpu/sparse/matrix.py)                       |
|------------|----------------------------------------------------------------------|
| sp_matmat  | ``sp_matmat`` and ``sp_matvec`` (:45-63): take + ``segment_sum``    |
| sp_rmatmat | ``sp_rmatmat`` and ``sp_rmatvec`` (:52-70): take + ``segment_sum``  |

The wrappers take a :class:`~.matrix.SparseMatrix`: on the card they launch
over its row-sorted (``sp_matmat``) or column-sorted (``sp_rmatmat``)
order and that order's :class:`SegmentPlan`, on the CPU the twin runs over
its flat entries as they are.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.kernels import check as _check, launch, stream as _stream

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P] + [_I] * 5 + [_P]
MAX_K = 32           # dense columns per launch
PIECE = 512          # entries of a heavy segment's piece (csrc/sp_segsum.cuh)
LANE_ENTRIES = 16    # a light segment's median length over its team's lanes
LIGHT_CAP = 1024     # the light bound T at most (32 entries a lane of a warp)
TILE_COST = 2048     # a tile's entries plus segments at most, past the last
_MAX_ENTRIES = 2 ** 31 - 1 - PIECE   # int32 offsets, a piece past the last


class SegmentPlan(NamedTuple):
    """How the kernels cut one segment order (``csrc/sp_segsum.cuh``),
    from its pointers alone: segments of at most ``light_max`` entries are
    light and go in tiles of contiguous light segments, a team of ``team``
    lanes a segment; longer ones are heavy and go in pieces of ``PIECE``
    entries, a warp a piece, and those of more than one piece are listed in
    ``finish``, whose partials a second launch adds in piece order."""
    team: int                # lanes a light segment, a power of two <= 32
    light_max: int           # T
    stage: int               # entries a shared-memory ring slot holds
    pstage: int              # pointers a ring slot holds
    ptr: torch.Tensor        # int32 [n_seg + 1]
    tiles: torch.Tensor      # int32 [n_tiles, 2]: first segment, end segment
    pieces: torch.Tensor     # int32 [n_pieces, 2]: segment, first entry
    finish: torch.Tensor     # int32 [n_finish, 2]: segment, first piece
    n_heavy: int

    def summary(self) -> dict:
        return {"team": self.team, "light_max": self.light_max,
                "stage": self.stage, "light": self.ptr.numel() - 1
                - self.n_heavy, "heavy": self.n_heavy,
                "tiles": self.tiles.shape[0], "pieces": self.pieces.shape[0],
                "finish": self.finish.shape[0]}


def segment_plan(ptr: torch.Tensor, team: Optional[int] = None,
                 tile_cost: int = TILE_COST) -> SegmentPlan:
    """The plan of the segment order with pointers ``ptr`` [n_seg + 1], on
    ptr's device.  ``team``: the lanes a light segment (default: the
    smallest power of two with at most ``LANE_ENTRIES`` of the median
    non-empty segment's entries a lane); a segment of more than
    ``min(32·team, LIGHT_CAP)`` entries is heavy.  A tile starts where the
    running sum of its light segments' (entries + 1) crosses a multiple of
    ``tile_cost`` or a heavy segment intervenes, so it stages at most
    ``tile_cost + T - 1`` entries and ``tile_cost`` segments' pointers.  Refuses orders of more than 2^31 - 513
    entries or segments (the plan's offsets are int32)."""
    n = ptr.numel() - 1
    nnz = int(ptr[-1])
    if nnz > _MAX_ENTRIES or n > _MAX_ENTRIES:
        raise ValueError(f"segment_plan: {nnz} entries in {n} segments; the "
                         f"sparse kernels take at most {_MAX_ENTRIES} of each")
    dev = ptr.device
    lens = ptr[1:] - ptr[:-1]
    if team is None:
        used = lens[lens > 0]
        med = int(used.median()) if used.numel() else 1
        team = 1
        while team < 32 and team * LANE_ENTRIES < med:
            team *= 2
    if team not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"segment_plan: team {team} is not a power of two "
                         "<= 32")
    light_max = min(32 * team, LIGHT_CAP)
    heavy = lens > light_max
    cost = torch.where(heavy, 0, lens + 1)
    q = (torch.cumsum(cost, 0) - cost) // tile_cost
    brk = torch.ones_like(heavy)
    brk[1:] = heavy[:-1] | (q[1:] != q[:-1])
    start = ~heavy & brk
    starts = torch.nonzero(start).flatten()
    bounds = torch.cat([torch.nonzero(start | heavy).flatten(),
                        torch.tensor([n], device=dev)])
    ends = bounds[torch.searchsorted(bounds, starts) + 1]
    hs = torch.nonzero(heavy).flatten()
    n_pc = (lens[hs] + PIECE - 1) // PIECE
    first = torch.cumsum(n_pc, 0) - n_pc
    seg = torch.repeat_interleave(hs, n_pc)
    local = (torch.arange(seg.numel(), device=dev)
             - torch.repeat_interleave(first, n_pc))
    multi = n_pc > 1
    i32 = torch.int32
    return SegmentPlan(
        team, light_max, (tile_cost + light_max + 5) // 4 * 4,
        (tile_cost + 4) // 4 * 4, ptr.to(i32),
        torch.stack([starts, ends], 1).to(i32),
        torch.stack([seg, ptr[seg] + local * PIECE], 1).to(i32),
        torch.stack([hs[multi], first[multi]], 1).to(i32), int(hs.numel()))


def lane_layout(k: int, team: int) -> tuple:
    """(vw, cgl) of a launch at ``k`` <= 32 dense columns for a plan of
    ``team`` entry slots a light segment: a row's columns go in groups of
    vw (4 if k % 4 == 0, 2 if k % 2 == 0, else 1) dealt over cgl lanes, as
    many as the groups need (a power of two) and as fit a warp beside the
    team's slots.  A heavy piece's warp and the finish pass take 32 / cgl
    entry slots."""
    vw = 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1
    cgl = 1
    while cgl * vw < k and cgl * team < 32:
        cgl *= 2
    return vw, cgl


def _team_tree(acc: np.ndarray) -> np.ndarray:
    """acc [m, lanes, k] f32 → [m, k]: the kernel's xor-shuffle tree."""
    lanes = np.arange(acc.shape[1])
    off = acc.shape[1] // 2
    while off:
        acc = acc + acc[:, lanes ^ off]
        off //= 2
    return acc[:, 0]


def _lane_sums(prod: np.ndarray, slot: np.ndarray, step: np.ndarray,
               n_slots: int) -> np.ndarray:
    """Each slot's serial f32 sum of its rows of ``prod`` in ``step`` order
    (a slot has at most one row a step)."""
    acc = np.zeros((n_slots, prod.shape[1]), np.float32)
    order = np.argsort(step, kind="stable")
    cuts = np.searchsorted(step[order], np.arange(int(step.max(initial=-1))
                                                  + 2))
    for a, b in zip(cuts[:-1], cuts[1:]):
        sel = order[a:b]
        acc[slot[sel]] = acc[slot[sel]] + prod[sel]
    return acc


def segsum_emulate(order, plan: SegmentPlan, dense) -> np.ndarray:
    """What the kernels compute for ``order`` (a ``SegmentOrder``) under
    ``plan`` against ``dense`` [*, k], in numpy f32 and in the kernels'
    order, so it equals their output bit for bit.  Each product is rounded.
    A light segment's entry slot l (of the plan's team) adds entries l, l +
    team, ... and an xor tree combines the slots; in each launch of up to
    32 columns (``lane_layout``), a heavy segment's piece is 32 / cgl slots
    over its PIECE entries, and a segment of several pieces adds their
    partials as 32 / cgl slots over the pieces."""
    val = order.values.detach().cpu().numpy().astype(np.float32)
    gix = order.gather.detach().cpu().numpy().astype(np.int64)
    ptr = order.ptr.detach().cpu().numpy().astype(np.int64)
    d = np.asarray(dense.detach().cpu().numpy()
                   if isinstance(dense, torch.Tensor) else dense, np.float32)
    n = ptr.size - 1
    lens = np.diff(ptr)
    seg = np.repeat(np.arange(n), lens)
    local = np.arange(val.size) - ptr[seg]
    heavy = lens > plan.light_max
    light, hs = np.flatnonzero(~heavy), np.flatnonzero(heavy)
    rank, hrank = np.cumsum(~heavy) - 1, np.cumsum(heavy) - 1
    n_pc = -(-lens[hs] // PIECE)
    first = np.zeros(hs.size + 1, np.int64)
    np.cumsum(n_pc, out=first[1:])
    out = np.zeros((n, d.shape[1]), np.float32)
    for j in range(0, d.shape[1], MAX_K):
        dk = d[:, j:j + MAX_K]
        k = dk.shape[1]
        TS, W = plan.team, 32 // lane_layout(k, plan.team)[1]
        prod = val[:, None] * dk[gix]
        e = np.flatnonzero(~heavy[seg])
        acc = _lane_sums(prod[e], rank[seg[e]] * TS + local[e] % TS,
                         local[e] // TS, light.size * TS)
        out[light, j:j + k] = _team_tree(acc.reshape(light.size, TS, k))
        if not hs.size:
            continue
        e = np.flatnonzero(heavy[seg])
        piece = first[hrank[seg[e]]] + local[e] // PIECE
        w = local[e] % PIECE
        acc = _lane_sums(prod[e], piece * W + w % W, w // W, first[-1] * W)
        part = _team_tree(acc.reshape(-1, W, k))
        one = n_pc == 1
        out[hs[one], j:j + k] = part[first[:-1][one]]
        for h in np.flatnonzero(~one):
            q = np.arange(n_pc[h])
            acc = _lane_sums(part[first[h]:first[h + 1]], q % W, q // W, W)
            out[hs[h], j:j + k] = _team_tree(acc[None])[0]
    return out


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


def _launch(name: str, order, plan: SegmentPlan, dense: torch.Tensor,
            n_seg: int) -> torch.Tensor:
    """Launch ``name`` over a segment order and its plan, 32 dense columns
    at a time; every row of the output is written by the kernel."""
    k = dense.shape[1]
    if k > MAX_K:
        return torch.cat([_launch(name, order, plan, dense[:, j:j + MAX_K]
                                  .contiguous(), n_seg)
                          for j in range(0, k, MAX_K)], dim=1)
    nnz = order.values.numel()
    if nnz == 0 or k == 0:
        return torch.zeros((n_seg, k), dtype=torch.float32,
                           device=dense.device)
    out = torch.empty((n_seg, k), dtype=torch.float32, device=dense.device)
    cgl = lane_layout(k, plan.team)[1]
    n_fin = plan.finish.shape[0]
    partial = (torch.empty((plan.pieces.shape[0], k), dtype=torch.float32,
                           device=dense.device) if n_fin else out)
    launch(name, _ARGTYPES, order.values.data_ptr(), order.gather.data_ptr(),
           plan.ptr.data_ptr(), plan.tiles.data_ptr(), plan.tiles.shape[0],
           plan.pieces.data_ptr(), plan.pieces.shape[0],
           plan.finish.data_ptr(), n_fin, dense.data_ptr(), out.data_ptr(),
           partial.data_ptr(), k, cgl, plan.team, plan.stage, plan.pstage,
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
    return _launch("sp_matmat", X.row_order(), X.row_plan(), m, X.n_rows)


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
    return _launch("sp_rmatmat", X.col_order(), X.col_plan(), g, X.n_cols)
