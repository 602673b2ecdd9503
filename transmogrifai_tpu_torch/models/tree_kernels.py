"""The tree kernels of the port: wrappers and plain-PyTorch twins (the
dispatch rule and launch counters are in ``kernels.py``).

| kernel          | replaces (transmogrifai_tpu/models/trees.py)                  |
|-----------------|----------------------------------------------------------------|
| tree_hist       | ``_fit_tree_compact`` node_stats + histogram einsums (:313-338) |
| tree_hist_deep  | ``_fit_tree_unrolled``'s segment-sum histograms (:520-531)     |
| tree_split      | ``scan_chunk`` xgb gain/argmax/leaf/threshold/value, level writes (:339-381) |
| tree_split_gini | ``scan_chunk`` gini gain over per-node subsets, level writes (:320-326, :331-381) |
| tree_split_variance | ``scan_chunk`` variance gain over per-node subsets, level writes (:186-191, :212-213, :331-381) |
| tree_route      | the routing block (:373-391)                                    |
| tree_walk       | ``_predict_trees_block`` (:668-702)                              |
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import cuda_build
from .kernels import check as _check, launch, stream as _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "tree_hist": [_P] * 9 + [_L] + [_I] * 11 + [_L] + [_I] * 4 + [_P],
    "tree_hist_deep": [_P] * 11 + [_L] + [_I] * 22 + [_P],
    "tree_split": [_P] * 18 + [_I] * 11 + [_P],
    "tree_split_gini": [_P] * 17 + [_I] * 15 + [_P],
    "tree_split_variance": [_P] * 17 + [_I] * 15 + [_P],
    "tree_route": [_P] * 6 + [_L] + [_I] * 9 + [_P],
    "tree_walk": [_P] * 7 + [_L] + [_I] * 13 + [_P],
}
_HIST_SMEM_TARGET = 99 * 1024     # the deep route's rule: 2 histograms a SM
_HIST_SMEM_MAX = 227 * 1024       # what one block can hold
HIST_THREADS = 512                # tree_hist's threads a block
HIST_SMEM_BUDGET = 113 * 1024     # a block's share of the SM: two a SM
HIST_QUEUE = 64                   # csrc/tree_hist.cu: rows queued a warp
HIST_MIN_ROWS = 2048              # rows a block at least (its flush's share)
HIST_BLOCKS = 132 * 2 * 4         # four waves of two blocks on 132 SMs
SMS = 132                         # the H100's SMs
SPLIT_THREADS = 256
SPLIT_TARGET_WARPS = SMS * 16     # warps an xgb split launch aims to fill
SPLIT_SLICE = 800                 # csrc/tree_split.cu: floats a warp's staging slice
ROUTE_THREADS = 256               # tree_route's threads a block
ROUTE_SMEM = 16 * 1024            # the most bytes of B rows a route block stages
ROUTE_LANES = 32                  # the most lanes a route block routes
ROUTE_MIN_BLOCKS = SMS * 2        # route blocks a launch aims for at least
GINI_CLASS_CHUNKS = (2, 4, 8)     # tree_split_gini's class-chunk templates
GINI_LANE_BINS = (16, 8, 6, 4)    # tree_split_gini's bins a lane (templates)
GINI_WARP_WORDS = 3616            # a gini warp's slices and lists (8 warps,
                                  # 113 KB: two blocks a SM)
HIST_DEEP_SEG = 8192              # rows a tree_hist_deep partition block sorts
HIST_DEEP_THREADS = 384           # tree_hist_deep's threads a block (two a SM)
HIST_DEEP_MIN_ROWS = 16384        # rows a split tree_hist_deep block takes at least
HIST_DEEP_MAX_GROUPS = 2048       # node groups a partition holds (int16 ids)
WALK_THREADS = 256                # tree_walk's threads (rows) a block
WALK_SMEM = 113 * 1024            # a walk block's share of the SM: two a SM
WALK_X_SMEM = 64 * 1024           # the most bytes of X rows a walk block stages
WALK_TOP = 15                     # the most nodes a tree a walk block stages


_PARTITION_ARGTYPES = [_P] * 7 + [_L] + [_I] * 9 + [_P]
FIXED_POINT_BITS = 62             # max|v|·2^e·N stays within 2^62
INTEGER_SUM_LIMIT = 1 << 23       # integer cells: f32 sums of magnitudes
                                  # below it (a cell's sum below 2^24)


def _launch(name: str, *args) -> None:
    launch(name, _ARGTYPES[name], *args)


def _deep_partition(*args) -> None:
    """``csrc/tree_hist_deep.cu``'s first stage (the partition), which the
    ``tree_hist_deep`` launch after it counts."""
    fn = cuda_build.load("tree_hist_deep", _ARGTYPES["tree_hist_deep"]) \
        .tree_hist_deep_partition
    fn.argtypes, fn.restype = _PARTITION_ARGTYPES, ctypes.c_int
    cuda_build.check("tree_hist_deep", fn(*args))


def _split_warps(K: int, P: int, D: int) -> int:
    """W, the warps a node of a warp-per-node split: doubling up to 8 while
    each keeps a feature and the level's K·P·W warps fall short of
    ``SPLIT_TARGET_WARPS`` (shallow levels)."""
    W = 1
    while W < 8 and 2 * W <= D and K * P * W < SPLIT_TARGET_WARPS:
        W *= 2
    return W


def xgb_split_plan(K: int, P: int, D: int, n_bins: int) -> dict:
    """How ``tree_split`` (``csrc/tree_split.cu``) launches one xgb level of
    K lanes x P nodes over D features and ``n_bins`` bins — the one place
    that sizes it.  A warp owns a (lane, node), its lanes a feature each
    (32 at a time); where K·P warps fall short of ``SPLIT_TARGET_WARPS``
    (shallow levels) a node's features spread over W warps (doubling up to
    8 while each keeps a feature), each a chunk of ``fc`` features, whose
    winners combine in feature order.  A block is 256 threads, 8 / W
    nodes.  A warp stages ``sb`` bins of its (at most 32) features at a
    time at the odd stride 3·sb + 1: 8, or 32 where it holds at most 8
    features (a slice of ``SPLIT_SLICE`` floats either way); ``smem``:
    dynamic shared memory, each warp's two slices.  Any K <= 65,535, P >=
    1, D >= 1 and 2 <= NB <= 127 has a plan (other shapes raise
    ``ValueError``)."""
    if min(K, P, D) < 1 or K > 65535 or not 2 <= n_bins <= 127:
        raise ValueError(f"xgb_split_plan: K={K} (1 .. 65,535) P={P} D={D} "
                         f"NB={n_bins} (2 .. 127)")
    W = _split_warps(K, P, D)
    per_block = SPLIT_THREADS // 32 // W
    fc = -(-D // W)
    sb = 32 if fc <= 8 else 8
    return {"W": W, "fc": fc, "sb": sb, "threads": SPLIT_THREADS,
            "nodes_per_block": per_block, "blocks": -(-P // per_block) * K,
            "smem": 4 * 2 * SPLIT_SLICE * (SPLIT_THREADS // 32)}



def _gini_cost(NB: int, SP: int, HB: int, nf: int, FPS: int,
               n_cc: int) -> int:
    """The plan's cost of one node's scan: its stages (feature groups x
    class chunks), each a walk of the bins before a lane's own (additions,
    about 2 instructions a statistic) and of its HB bins (two IEEE
    divisions a class a side: about 14 a statistic)."""
    stages = -(-nf // FPS) * n_cc
    return stages * (2 * SP * max(0, NB - 1 - HB) + 14 * SP * HB)


def gini_split_plan(K: int, P: int, D: int, n_bins: int, C: int,
                    width: Optional[int] = None) -> dict:
    """How ``tree_split_gini`` and ``tree_split_variance`` (one body,
    ``csrc/split_node.cuh``) launch one level of K lanes x P nodes over D
    features, ``n_bins`` bins and C classes (the variance split: C = 2, its
    two statistics after the count) (``width``: the most features any
    node's subset holds, None without subsets) — the one place that sizes
    them.  A warp owns a (lane,
    node), W warps one where the level is shallow (as
    :func:`xgb_split_plan`), each a chunk of ``fc`` features; it compacts
    the features its node may split on into groups of ``FPS`` and stages a
    group's bins 0 .. NB-2 (the count and ``ct`` classes a bin: the
    smallest of ``GINI_CLASS_CHUNKS`` that holds C, else 8 a stage) at a row
    stride ``FST`` = 1 mod 32.  Lane l scans ``hb`` bins of feature l // ipf
    (``ipf`` = ⌈(NB-1)/hb⌉ lanes a feature, FPS·ipf <= 32; 6 bins a lane put
    a 5-feature subset of 32 bins on 30 lanes, and were measured fastest
    there): ``hb`` of ``GINI_LANE_BINS`` is the one whose node scan costs least
    (:func:`_gini_cost` at min(width, fc) features; the larger on a tie).
    A block is 256 threads, 8 / W nodes; ``smem``: each warp's two slices
    of FPS rows and two lists of FPS features, at most ``GINI_WARP_WORDS``
    words a warp.  Any K <= 65,535, P >= 1, D >= 1, 2 <= NB <= 127 and C
    >= 2 has a plan (other shapes raise ``ValueError``)."""
    if (min(K, P, D) < 1 or K > 65535 or not 2 <= n_bins <= 127 or C < 2):
        raise ValueError(f"gini_split_plan: K={K} (1 .. 65,535) P={P} D={D} "
                         f"NB={n_bins} (2 .. 127) C={C} (>= 2)")
    W = _split_warps(K, P, D)
    fc = -(-D // W)
    nf = max(1, min(fc, D if width is None else width))
    ct = next((t for t in GINI_CLASS_CHUNKS if t >= C), GINI_CLASS_CHUNKS[-1])
    n_cc = -(-C // ct)
    SP = 1 + min(ct, C)
    FST = (n_bins - 1) * SP
    FST += (1 - FST) % 32
    cap = max(1, (GINI_WARP_WORDS // 2) // (FST + 1))
    best = None
    for hb in GINI_LANE_BINS:
        ipf = -(-(n_bins - 1) // hb)
        FPS = max(1, min(32 // ipf, nf, cap))
        cost = _gini_cost(n_bins, SP, hb, nf, FPS, n_cc)
        if best is None or cost < best[0]:
            best = (cost, hb, ipf, FPS)
    _, hb, ipf, FPS = best
    warps = SPLIT_THREADS // 32
    return {"W": W, "fc": fc, "ct": ct, "class_chunks": n_cc, "hb": hb,
            "ipf": ipf, "FPS": FPS, "FST": FST, "threads": SPLIT_THREADS,
            "nodes_per_block": warps // W,
            "blocks": -(-P // (warps // W)) * K,
            "smem": 4 * warps * (2 * FPS * FST + 2 * FPS)}



# --------------------------------------------------------------------------
# tree_hist
# --------------------------------------------------------------------------

def _hist_smem(Pg: int, Wc: int, n_bins: int, S: int, threads: int,
               with_hist: bool, cell_bytes: int = 4) -> int:
    """Shared-memory bytes of one ``tree_hist`` block (``csrc/tree_hist.cu``'s
    ``hist_smem`` adds the same terms): the group's cells [Pg, Wc, NB, S]
    and totals [Pg, S] (f32, or 8-byte fixed point), each warp's queue of
    (row, node), the nodes' slot counts and the statistics' exponents
    (int32), the slots' features (int16)."""
    cells = (Pg * Wc * n_bins * S if with_hist else 0) + Pg * S
    ints = threads // 32 * 2 * HIST_QUEUE + Pg + S
    return cell_bytes * cells + 4 * ints + 2 * Pg * Wc


def hist_plan(N: int, D: int, K: int, P: int, n_bins: int, S: int,
              with_hist: bool = True, width: Optional[int] = None,
              cell_bytes: int = 4) -> dict:
    """How ``tree_hist`` launches one level of K lanes (N rows, D features,
    P nodes, S statistics; ``width`` the most features any node's subset
    holds, None without a node mask; ``cell_bytes`` 4 for f32 or int32
    cells, 8 for fixed point: :func:`hist_scale`).  The deep route
    (``tree_hist_deep``, sized by :func:`hist_deep_plan`) where two copies
    of the level's P·NB·S histogram cells would not fit
    ``_HIST_SMEM_TARGET`` (totals only: where P·S do not fit a block);
    else ``tree_hist`` blocks of ``HIST_THREADS`` threads, each
    holding Pg nodes x Wc slots x NB bins x S in ``HIST_SMEM_BUDGET`` (two
    blocks an SM): a node's slots are the features of its subset (at most
    ``width``) or all D, in feature chunks of Dc only where one node's
    slots would not fit; the fewest node groups NG that fit; then enough row
    ranges R of RB rows that K·NG·NC·R blocks fill ``HIST_BLOCKS`` (never
    fewer than ``SMS``), each of at least ``HIST_MIN_ROWS`` rows and 8·Pg·NB
    where the card stays full without them (so a block's flush of its
    cells stays small beside its rows).  The one place that sizes the
    launch."""
    if min(N, D, K, P, n_bins, S) < 1:
        raise ValueError(f"hist_plan: N={N} D={D} K={K} P={P} "
                         f"NB={n_bins} S={S}")
    cb = cell_bytes
    if (P * S * cb > _HIST_SMEM_MAX if not with_hist
            else 2 * P * n_bins * S * cb > _HIST_SMEM_TARGET):
        return hist_deep_plan(N, D, K, P, n_bins, S, with_hist, width, cb)
    threads = HIST_THREADS
    if with_hist:
        W = D if width is None else max(1, min(width, D))
        Dc = min(D, 32767)
        while _hist_smem(1, min(W, Dc), n_bins, S, threads, True, cb) \
                > HIST_SMEM_BUDGET and Dc > 1:
            Dc = -(-Dc // 2)
        Wc = min(W, Dc)
    else:
        Dc, Wc = D, 0
    NC = -(-D // Dc)
    Pg = P
    while _hist_smem(Pg, Wc, n_bins, S, threads, with_hist, cb) \
            > HIST_SMEM_BUDGET and Pg > 1:
        Pg = -(-Pg // 2)
    NG = -(-P // Pg)
    Pg = -(-P // NG)
    lanes = K * NG * NC
    rows_min = max(HIST_MIN_ROWS, 8 * Pg * n_bins if with_hist else 0)
    R = -(-HIST_BLOCKS // lanes)
    R = min(R, max(1, N // rows_min))
    R = max(R, -(-SMS // lanes))
    R = max(1, min(R, -(-N // 64), 65535))
    RB = -(-N // R)
    R = -(-N // RB)
    return {"route": "shared", "threads": threads, "Pg": Pg, "NG": NG,
            "Dc": Dc, "NC": NC, "Wc": Wc, "RB": RB, "R": R,
            "blocks": lanes * R,
            "smem": _hist_smem(Pg, Wc, n_bins, S, threads, with_hist, cb)}


def _deep_smem(Pg: int, Wc: int, SS: int, Sc: int, with_hist: bool,
               cell_bytes: int = 4) -> int:
    """Shared-memory bytes of one ``tree_hist_deep`` histogram block
    (``csrc/tree_hist_deep.cu``'s ``deep_smem`` adds the same terms): the
    group's cells [Pg, Wc, SS] (a slot's NB x Sc cells at stride SS) and
    totals [Pg, Sc] (int32, or 8-byte fixed point), the nodes' slot counts
    and the statistics' exponents (int32) and the slots' features
    (int16)."""
    cells = (Pg * Wc * SS if with_hist else 0) + Pg * Sc
    return (cell_bytes * cells + 4 * (Pg + Sc)
            + (2 * Pg * Wc if with_hist else 0))


def _slot_stride(n_bins: int, Sc: int) -> int:
    """A slot's stride in ``tree_hist_deep``'s cells: NB·Sc, made odd so
    that the same bin of different slots falls in different banks."""
    return n_bins * Sc | 1


def _part_smem(NG: int, SEG: int) -> int:
    """Shared-memory bytes of one ``tree_hist_deep`` partition block: the
    groups' counters, a scan's warp sums and a segment's rows' group and
    node (int32), and the rows in place order (int16)."""
    return 4 * (NG + 32 + SEG) + 2 * SEG


def hist_deep_plan(N: int, D: int, K: int, P: int, n_bins: int, S: int,
                   with_hist: bool = True, width: Optional[int] = None,
                   cell_bytes: int = 4) -> dict:
    """How ``tree_hist_deep`` launches one deep level of K lanes (N rows, D
    features, P nodes, S statistics; ``width`` the most features any node's
    subset holds, None without a node mask; ``cell_bytes`` 4 for int32
    cells, 8 for fixed point).  The one place that sizes it:

    - a block holds Sc of the S statistics (all of them unless one slot of
      NB·S cells would not fit ``HIST_SMEM_BUDGET``: then NSC near-equal
      chunks), Wc slots a node at an odd stride SS >= NB·Sc (the subset's
      width, or a feature chunk of Dc features where one node's slots would
      not fit; NC chunks) and the most nodes Pg that fit the budget (two
      blocks an SM);
    - a window of Pw = Pg·``HIST_DEEP_MAX_GROUPS`` nodes at most a launch
      (``windows`` launches; one up to 2,048 nodes), NG node groups of Pg;
    - the partition sorts segments of ``HIST_DEEP_SEG`` rows (``nseg`` of
      them; ``psmem`` bytes a block) into records — row indices int32
      [K, N], nodes within the group int16 [K, N], a copy of the
      statistics f32 [K, N, S] — and int2 [K, NG, nseg] runs
      (``partition_bytes``);
    - the wrapper reads back the largest group (one wait for the card) and
      lets R blocks share each group's segments where that group
      holds more than max(``min_rows``, live rows / ``target_blocks``)
      rows — the rows of a real deep level sit in a few nodes — and then
      zeroes the window's cells for those blocks' atomics; with R = 1 each
      block writes its nodes' cells whole and nothing is zeroed
      (:func:`hist_deep_split`).

    Any K <= 65,535, S >= 1, NB <= 127, D >= 1, P >= 1 and N < 2^31 has a
    plan (larger shapes raise ``ValueError``)."""
    if min(N, D, K, P, n_bins, S) < 1:
        raise ValueError(f"hist_deep_plan: N={N} D={D} K={K} P={P} "
                         f"NB={n_bins} S={S}")
    if K > 65535 or N >= 1 << 31 or (with_hist and n_bins > 127):
        raise ValueError(f"hist_deep_plan: K={K} (at most 65,535), N={N} "
                         f"(below 2^31), NB={n_bins} (at most 127)")
    budget = HIST_SMEM_BUDGET
    W = D if width is None else max(1, min(width, D))
    Sc = S
    cb = cell_bytes
    while (_deep_smem(1, 1 if with_hist else 0, _slot_stride(n_bins, Sc), Sc,
                      with_hist, cb) > budget and Sc > 1):
        Sc = -(-Sc // 2)
    NSC = -(-S // Sc)
    Sc = -(-S // NSC)
    SS = _slot_stride(n_bins, Sc)
    if with_hist:
        Dc = min(D, 32767)
        while _deep_smem(1, min(W, Dc), SS, Sc, True, cb) > budget \
                and Dc > 1:
            Dc = -(-Dc // 2)
        Wc, NC = min(W, Dc), -(-D // Dc)
    else:
        Dc, Wc, NC = D, 0, 1
    Pg = max(1, min(P, 32768,
                    budget // _deep_smem(1, Wc, SS, Sc, with_hist, cb)))
    Pw = min(P, Pg * HIST_DEEP_MAX_GROUPS)
    NG = -(-Pw // Pg)
    Pg = -(-Pw // NG)
    SEG = HIST_DEEP_SEG
    nseg = -(-N // SEG)
    return {"route": "deep", "threads": HIST_DEEP_THREADS, "Pg": Pg,
            "NG": NG, "Dc": Dc, "NC": NC, "Wc": Wc, "SS": SS, "Sc": Sc,
            "NSC": NSC, "Pw": Pw, "windows": -(-P // Pw), "SEG": SEG,
            "nseg": nseg, "min_rows": HIST_DEEP_MIN_ROWS,
            "target_blocks": HIST_BLOCKS, "blocks": K * NG * NC * NSC,
            "smem": _deep_smem(Pg, Wc, SS, Sc, with_hist, cb),
            "psmem": _part_smem(NG, SEG),
            "partition_bytes": (6 + 4 * S) * K * N + 8 * K * NG * nseg}


def hist_deep_split(plan: dict, max_rows: int, live_rows: int) -> int:
    """R, the ``tree_hist_deep`` blocks that share each node group's
    segments, from the partition's largest group (``max_rows``) and all
    its live rows: the largest group's rows over max(``min_rows``, live
    rows / ``target_blocks``), at most ``nseg`` and 65,535."""
    part = max(plan["min_rows"], live_rows // plan["target_blocks"])
    R = -(-max_rows // part) if max_rows > part else 1
    return min(R, plan["nseg"], 65535)


def deep_partition_bytes(N: int, D: int, P: int, n_bins: int,
                         S: int, cell_bytes: int = 4) -> int:
    """Device bytes a lane's ``tree_hist_deep`` partition takes at a level
    of P nodes (every feature: the most node groups), 0 where the level
    does not take the deep route."""
    plan = hist_plan(N, D, 1, P, n_bins, S, cell_bytes=cell_bytes)
    return plan["partition_bytes"] if plan["route"] == "deep" else 0


class HistScale(NamedTuple):
    """How ``tree_hist`` sums a fit's statistics (:func:`hist_scale`)."""
    exponent: torch.Tensor   # int32 [K, S]: each statistic's scale 2^e
    fixed: bool              # fixed point (else integer cells)


def hist_scale(stats: torch.Tensor) -> HistScale:
    """The cells of a fit's histograms, read once a fit from its statistics
    f32 [K, N, S] (a tree's statistics do not change between its levels;
    one wait for the card).

    Every statistic an integer and every (lane, statistic)'s sum of
    magnitudes below ``INTEGER_SUM_LIMIT`` (2^23, summed in f32: far
    inside the 2^24 that keeps an f32 cell's integer sums exact) — a
    classification forest's counts: integer cells (f32 in ``tree_hist``,
    int32 in ``tree_hist_deep``), exact in any order.  Otherwise fixed point: each
    (lane, statistic) gets the exponent e = 62 - L - E, where 2^L >= N and
    the largest magnitude is below 2^E (``torch.frexp``; e = 0 for an
    all-zero statistic), so that N rows of values rounded to integers
    v·2^e sum within 2^62 in 64-bit cells, and each value loses only its
    bits below 2^-e (about 2^-42 of the largest at 1M rows).  A statistic
    that is not finite raises ``ValueError``."""
    K, N, S = stats.shape
    L = max(N - 1, 0).bit_length()
    amax = torch.zeros((K, S), dtype=stats.dtype, device=stats.device)
    total = torch.zeros((K, S), dtype=stats.dtype, device=stats.device)
    frac = torch.zeros((), dtype=torch.bool, device=stats.device)
    step = max(1, (64 << 20) // max(N * S, 1))      # lanes a pass: 256 MB
    for a in range(0, K, step):
        chunk = stats[a:a + step]
        if N:
            lo, hi = torch.aminmax(chunk, dim=1)
            amax[a:a + step] = torch.maximum(hi, -lo)
        total[a:a + step] = chunk.abs().sum(dim=1)
        frac |= (chunk != torch.round(chunk)).any()
    bad, integer = torch.stack([
        ~torch.isfinite(amax).all(),
        ~frac & (total < INTEGER_SUM_LIMIT).all()]).tolist()
    if bad:
        raise ValueError("tree_hist: a statistic is not finite (NaN or "
                         "infinite): no fixed-point scale can hold it")
    E = torch.frexp(amax).exponent
    ex = torch.where(amax > 0, FIXED_POINT_BITS - L - E, 0).to(torch.int32)
    return HistScale(ex.contiguous(), not integer)


def fixed_point_sums(values: torch.Tensor, exponent: torch.Tensor
                     ) -> torch.Tensor:
    """``values`` [..., S] rounded to the integers v·2^e of their
    statistic's ``exponent`` [S] (exact in f64, rounded once to nearest
    even): int64, as the kernels' cells add them (``csrc/tree_hist.cuh``,
    ``Cell<fixed_t>::of``)."""
    scale = torch.ldexp(torch.ones((), dtype=torch.float64),
                        exponent.to(torch.float64))
    return torch.round(values.double() * scale).to(torch.int64)


def fixed_point_f32(sums: torch.Tensor, exponent: torch.Tensor
                    ) -> torch.Tensor:
    """int64 sums [..., S] as f32: rounded once to f32, times 2^-e (exact
    in f64; ``fixed_f32``)."""
    scale = torch.ldexp(torch.ones((), dtype=torch.float64),
                        -exponent.to(torch.float64))
    return (sums.to(torch.float32).double() * scale).to(torch.float32)


def tree_hist_fixed_twin(B, row_node, stats, offset: int, P: int,
                         n_bins: int, with_hist: bool = True,
                         node_mask=None, scale: Optional[HistScale] = None):
    """The kernels' fixed-point sums emulated on the wrapper's arrays: each
    live row's statistics rounded to v·2^e (:func:`hist_scale`'s
    exponents), the integers summed exactly (int64 ``index_add_``: the
    same in any order), each sum converted to f32 once — the bits
    ``tree_hist`` and ``tree_hist_deep`` give a fixed-point launch."""
    scale = hist_scale(stats) if scale is None else scale
    K = row_node.shape[0]
    ex = scale.exponent
    q = fixed_point_sums(stats, ex[:, None, :])
    hist, totals = tree_hist_twin(B, row_node, q, offset, P, n_bins,
                                  with_hist, node_mask)
    totals = fixed_point_f32(totals, ex[:, None, :])
    if hist is not None:
        hist = fixed_point_f32(hist, ex.reshape(K, 1, 1, 1, -1))
    return hist, totals


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
              node_mask=None, scale: Optional[HistScale] = None):
    """Histograms of one tree level for K lanes at once.

    B int8 [N, D] bin ids (< n_bins); row_node int32 [K, N] heap node ids;
    stats f32 [K, N, S] per-row statistics.  Rows whose node lies in
    [offset, offset + P) contribute.  Returns (hist f32 [K, P, D, n_bins, S]
    or None when ``with_hist`` is False, totals f32 [K, P, S]).
    ``node_mask`` bool [K, P, D] (each node's feature subset) leaves the
    cells of features outside a node's subset at zero; None keeps every
    feature.  Rows whose statistics are all zero add nothing (exact: adding
    zero changes no sum).  ``scale``: the fit's :func:`hist_scale`, read
    here where it is None.  On the card the sums are exact integers —
    integer statistics' own, or fixed point (:func:`tree_hist_fixed_twin`
    gives their bits) — so a launch repeats bit for bit whatever the order
    of its atomics.  :func:`hist_plan` sizes the launch, with node
    subsets slots for the most features any node's subset holds (counted
    here: one wait for the card): a level whose nodes fit shared memory
    runs ``tree_hist``; a deeper one ``tree_hist_deep`` (rows partitioned
    by node group, each group's cells in shared memory; the sums are
    zero-filled only where :func:`hist_deep_split` gives a group's rows to
    several blocks: one wait for the card)."""
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
    if N >= 1 << 31:
        raise ValueError("tree_hist: at most 2^31 - 1 rows")
    scale = hist_scale(stats) if scale is None else scale
    if scale.exponent.shape != (K, S) or scale.exponent.device != dev:
        raise ValueError("tree_hist: scale must be the statistics' [K, S] "
                         "exponents on their device")
    fixed = scale.fixed
    ex_ptr = scale.exponent.data_ptr() if fixed else 0
    width = (int(node_mask.sum(dim=2).amax())
             if node_mask is not None and with_hist else None)
    plan = hist_plan(N, D, K, P, n_bins, S, with_hist, width,
                     8 if fixed else 4)
    totals = torch.zeros((K, P, S), dtype=torch.float32, device=dev)
    tot64 = (torch.zeros((K, P, S), dtype=torch.int64, device=dev)
             if fixed else None)
    mask_ptr = 0 if node_mask is None or not with_hist \
        else node_mask.data_ptr()
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    if plan["route"] == "deep":
        hist = totals
        if with_hist:
            hist = torch.empty((K, P, D, n_bins, S), dtype=torch.float32,
                               device=dev)
        hist64 = None
        idx = torch.empty((K, N), dtype=torch.int32, device=dev)
        pl = torch.empty((K, N), dtype=torch.int16, device=dev)
        ss = torch.empty((K, N, S), dtype=torch.float32, device=dev)
        runs = torch.empty((K, plan["NG"], plan["nseg"], 2),
                           dtype=torch.int32, device=dev)
        stat = torch.empty(2, dtype=torch.int64, device=dev)
        for wlo in range(0, P, plan["Pw"]):
            Pn = min(plan["Pw"], P - wlo)
            _deep_partition(row_node.data_ptr(), stats.data_ptr(),
                            idx.data_ptr(), pl.data_ptr(), ss.data_ptr(),
                            runs.data_ptr(), stat.data_ptr(), N, S, K,
                            offset + wlo, Pn, plan["Pg"], plan["NG"],
                            plan["SEG"], plan["nseg"], plan["psmem"],
                            _stream(B))
            R = hist_deep_split(plan, *stat.tolist())
            if fixed and with_hist and R > 1 and hist64 is None:
                hist64 = torch.empty((K, P, D, n_bins, S), dtype=torch.int64,
                                     device=dev)
            _launch("tree_hist_deep", B.data_ptr(), mask_ptr, idx.data_ptr(),
                    pl.data_ptr(), ss.data_ptr(), runs.data_ptr(), ex_ptr,
                    hist.data_ptr(), totals.data_ptr(), ptr(hist64),
                    ptr(tot64), N, D, n_bins, S, K, P, wlo, Pn,
                    *(plan[k] for k in ("Pg", "NG", "Dc", "NC", "Wc", "SS",
                                        "Sc", "NSC", "SEG", "nseg")),
                    R, plan["threads"], plan["smem"], int(with_hist),
                    int(wlo + Pn == P), _stream(B))
        return (hist if with_hist else None), totals
    if fixed:
        hist = (torch.empty((K, P, D, n_bins, S), dtype=torch.float32,
                            device=dev) if with_hist else totals)
        hist64 = (torch.zeros((K, P, D, n_bins, S), dtype=torch.int64,
                              device=dev) if with_hist else None)
    else:
        hist = (torch.zeros((K, P, D, n_bins, S), dtype=torch.float32,
                            device=dev) if with_hist else totals)
        hist64 = None
    _launch("tree_hist", B.data_ptr(), row_node.data_ptr(), stats.data_ptr(),
            mask_ptr, ex_ptr, hist.data_ptr(), totals.data_ptr(),
            ptr(hist64), ptr(tot64), N, D, n_bins, S, K, offset, P,
            plan["Pg"], plan["NG"], plan["Dc"], plan["NC"], plan["Wc"],
            plan["RB"], plan["R"], plan["threads"], plan["smem"],
            int(with_hist), _stream(B))
    return (hist if with_hist else None), totals


# --------------------------------------------------------------------------
# tree_split
# --------------------------------------------------------------------------

def block_prefix(hist: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix over bins (dim 3 of [K, P, D, NB, S]) in the
    order XLA:CPU adds the JAX package's ``jnp.cumsum`` over bins
    (trees.py:339, :537): serial f32 sums within blocks of 16 bins, each
    block's sums then adding the serial sum of the blocks before it (0 for
    the first).  ``csrc/tree_split.cu`` adds in this order."""
    K, P, D, NB, S = hist.shape
    nb = -(-NB // 16)
    v = torch.nn.functional.pad(hist, (0, 0, 0, 16 * nb - NB)).reshape(
        K, P, D, nb, 16, S)
    inner = [v[:, :, :, :, 0]]
    for b in range(1, 16):
        inner.append(inner[-1] + v[:, :, :, :, b])
    pre = [torch.zeros_like(inner[0][:, :, :, 0])]
    for i in range(1, nb):
        pre.append(pre[-1] + inner[-1][:, :, :, i - 1])
    out = torch.stack(inner, dim=4) + torch.stack(pre, dim=3)[:, :, :, :, None]
    return out.reshape(K, P, D, 16 * nb, S)[:, :, :, :NB]


def _gain_table(hist, totals, fmask, min_inst, gain_fn, node_mask=None,
                prefix=None) -> torch.Tensor:
    """Gain [K, P, D*NB] of every (feature, bin) split of a level: the bin
    prefix is the left side, parent - prefix the right; -inf where either
    side's count is below min_inst, the feature is outside ``fmask`` or the
    node's subset ``node_mask`` [K, P, D] (None: all), or bin = NB-1.
    ``prefix`` (None: ``torch.cumsum`` over bins) computes the left side."""
    K, P, D, NB, S = hist.shape
    left = torch.cumsum(hist, dim=3) if prefix is None else prefix(hist)
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
                gain_fn_of, prefix=None) -> Dict[str, torch.Tensor]:
    """The split each (lane, node) takes from its ``_gain_table``: the first
    max over (feature, bin) — lowest feature, then lowest bin — with its
    leaf flag and threshold.  A node whose count total is not at least
    2·min_inst is a leaf, gain -inf, feature 0, bin 0, without a table: no
    split can leave min_inst on both sides (counts are non-negative; a left
    count c >= mi > pc/2 makes pc - c exact, and below mi), so the full
    table would be -inf throughout.  The table is built only at the other
    nodes with a non-zero histogram or total; the many empty nodes of a
    deep level take the same value in closed form (``_empty_nodes``).
    ``gain_fn_of(lanes)`` is the gain function for those lanes'
    parameters; ``prefix`` the bin prefix (``_gain_table``)."""
    K, P, D, NB, S = hist.shape
    can = totals[..., 0] >= 2 * min_inst[:, None]
    live = ((hist.reshape(K, P, -1) != 0).any(dim=2)
            | (totals != 0).any(dim=2))
    best, feat, bin_ = _empty_nodes(
        K, P, S, fmask, node_mask, min_inst,
        gain_fn_of(torch.arange(K, device=hist.device)), hist.dtype,
        hist.device)
    best = torch.where(can, best, float("-inf"))
    feat = torch.where(can, feat, 0)
    kk, pp = torch.nonzero(live & can, as_tuple=True)
    if kk.numel():
        table = _gain_table(
            hist[kk, pp][:, None], totals[kk, pp][:, None], fmask,
            min_inst[kk], gain_fn_of(kk),
            None if node_mask is None else node_mask[kk, pp][:, None], prefix)
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
    split over the kernel's bin prefix (``block_prefix``), -inf where the
    split is not allowed."""
    return _gain_table(hist, totals, fmask, min_inst, _xgb_gain(lam),
                       prefix=block_prefix)


def split_gap(hist, totals, fmask, min_inst, lam) -> torch.Tensor:
    """Best minus runner-up gain per (lane, node) [K, P]: the chosen split
    is well defined only where this gap is clear of rounding."""
    return _top2_gap(split_gains(hist, totals, fmask, min_inst, lam))


def tree_split_twin(hist, totals, fmask, splits, min_inst, min_gain, lam):
    """Plain-PyTorch twin of ``tree_split`` (see :func:`tree_split`): the
    bin prefix in the JAX package's order (``block_prefix``, as the kernel
    adds it) and ``_gain_xgb``'s f32 expression, so that the kernel gives
    the same bits."""
    out = _split_twin(hist, totals, fmask, None, splits, min_inst, min_gain,
                      lambda lanes: _xgb_gain(lam[lanes]), block_prefix)
    out["value"] = -(totals[..., 1] / (totals[..., 2] + lam[:, None]))
    return out


def write_level_twin(out: Dict[str, torch.Tensor], tree, offset: int) -> None:
    """Plain-PyTorch twin of ``tree_split``'s and ``tree_split_gini``'s
    epilogue: the level's slices [:, offset:offset+P] of the tree arrays
    ``tree`` = (feature int32, threshold f32, is_leaf bool [K, T], leaf f32
    [K, T, V], gain f32 [K, D]) from the split ``out`` — feature -1 at a
    leaf, the leaf values ``out["value"]`` ([K, P] for V = 1, else [K, P,
    V]) — and each split node's gain added into gain[k, feature] in node
    order (a CPU ``scatter_add_`` adds in index order; a leaf adds 0.0)."""
    feature, threshold, is_leaf, leaf, gain = tree
    P = out["feature"].shape[1]
    lf = out["is_leaf"]
    value = out["value"]
    leaf[:, offset:offset + P] = value if value.ndim == 3 else value[..., None]
    is_leaf[:, offset:offset + P] = lf
    feature[:, offset:offset + P] = torch.where(lf, -1, out["feature"])
    threshold[:, offset:offset + P] = out["threshold"]
    gain.scatter_add_(1, out["feature"].long(),
                      torch.where(lf, 0.0, out["gain"]))


def tree_split(hist: torch.Tensor, totals: torch.Tensor, fmask: torch.Tensor,
               splits: torch.Tensor, min_inst: torch.Tensor,
               min_gain: torch.Tensor, lam: torch.Tensor, tree=None,
               offset: int = 0) -> Dict[str, torch.Tensor]:
    """Best xgb split per (lane, node).

    hist f32 [K, P, D, NB, 3] and totals f32 [K, P, 3] of (w, w·g, w·h),
    counts w non-negative; fmask bool [D]; splits f32 [D, NB-1]; min_inst /
    min_gain / lam f32 [K].  The gain is ``_gain_xgb`` over the bin prefix,
    masked by min_inst on both sides, the feature mask and ``bin < NB-1``;
    the FIRST max over (feature, bin) wins.  A node whose count total is
    below 2·min_inst is a leaf (gain -inf, feature 0, bin 0) without a read
    of its histogram.  Returns per-node gain, feature, bin, is_leaf (gain <=
    min_gain or non-finite), threshold ``splits[feature, bin]`` and the
    ``_leaf_xgb`` value, each [K, P], the same bits as
    :func:`tree_split_twin`.  ``tree`` = fit_trees' (feature, threshold,
    is_leaf, leaf [K, T, 1], gain [K, D]): the level's slices at ``offset``
    are written and the split nodes' gains added in node order as
    :func:`write_level_twin` does (on the card the kernel writes the slices
    and a second kernel of the same call adds the gains).
    :func:`xgb_split_plan` sizes the launch."""
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
    if tree is not None:
        _check_tree("tree_split", tree, K, D, P, 1, offset, dev)
    if dev.type == "cpu":
        out = tree_split_twin(hist, totals, fmask, splits, min_inst,
                              min_gain, lam)
        if tree is not None:
            write_level_twin(out, tree, offset)
        return out
    if dev.type != "cuda":
        raise ValueError(f"tree_split: unsupported device {dev}")
    plan = xgb_split_plan(K, P, D, NB)
    out = {"gain": torch.empty((K, P), dtype=torch.float32, device=dev),
           "feature": torch.empty((K, P), dtype=torch.int32, device=dev),
           "bin": torch.empty((K, P), dtype=torch.int32, device=dev),
           "is_leaf": torch.empty((K, P), dtype=torch.bool, device=dev),
           "threshold": torch.empty((K, P), dtype=torch.float32, device=dev),
           "value": torch.empty((K, P), dtype=torch.float32, device=dev)}
    level = [t.data_ptr() for t in tree] if tree is not None else [0] * 5
    _launch("tree_split", hist.data_ptr(), totals.data_ptr(),
            fmask.data_ptr(), splits.data_ptr(), min_inst.data_ptr(),
            min_gain.data_ptr(), lam.data_ptr(),
            *(out[k].data_ptr() for k in ("gain", "feature", "bin",
                                          "is_leaf", "threshold", "value")),
            *level, K, P, D, NB, plan["W"], plan["fc"], plan["sb"],
            plan["threads"], tree[0].shape[1] if tree is not None else 0,
            offset, plan["smem"], _stream(hist))
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
    split over the kernel's bin prefix (``block_prefix``), -inf where
    min_inst, the tree's feature mask, the node's subset (``node_mask`` [K,
    P, D] or None for all) or ``bin < NB-1`` rule it out."""
    return _gain_table(hist, totals, fmask, min_inst, gini_gain, node_mask,
                       block_prefix)


def split_gap_gini(hist, totals, fmask, node_mask, min_inst) -> torch.Tensor:
    """Best minus runner-up gini gain per (lane, node) [K, P]."""
    return _top2_gap(split_gains_gini(hist, totals, fmask, node_mask,
                                      min_inst))


def gini_leaf(totals: torch.Tensor) -> torch.Tensor:
    """Class shares of node totals [..., 1+C] → [..., C] (≙ ``_leaf_gini``,
    trees.py:216-217), the division the kernel's epilogue makes."""
    return totals[..., 1:] / torch.clamp(totals[..., :1], min=1e-12)


def tree_split_gini_twin(hist, totals, fmask, node_mask, splits, min_inst,
                         min_gain):
    """Plain-PyTorch twin of ``tree_split_gini`` (see
    :func:`tree_split_gini`): the bin prefix in the JAX package's order
    (``block_prefix``, as the kernel adds it) and ``_gain_gini``'s f32
    expression, so that the kernel gives the same bits."""
    return _split_twin(hist, totals, fmask, node_mask, splits, min_inst,
                       min_gain, lambda lanes: gini_gain, block_prefix)


def _check_tree(name: str, tree, K: int, D: int, P: int, V: int, offset: int,
                dev) -> None:
    """fit_trees' level arrays ``tree`` = (feature int32, threshold f32,
    is_leaf bool [K, T], leaf f32 [K, T, V], gain f32 [K, D]) with the
    level's P nodes at ``offset`` inside them."""
    if len(tree) != 5:
        raise ValueError(f"{name}: tree = (feature, threshold, is_leaf, leaf, "
                         "gain)")
    for part, t, dt, nd in zip(
            ("feature", "threshold", "is_leaf", "leaf", "gain"), tree,
            (torch.int32, torch.float32, torch.bool, torch.float32,
             torch.float32), (2, 2, 2, 3, 2)):
        _check(f"{name} tree {part}", t, dt, nd, dev)
    T = tree[0].shape[1]
    if (any(t.shape[:2] != (K, T) for t in tree[:4])
            or tree[3].shape[2] != V or tree[4].shape != (K, D)
            or not 0 <= offset <= T - P):
        raise ValueError(f"{name}: tree arrays [K, T] / [K, T, {V}] / [K, D] "
                         f"with offset + P <= T (K={K} D={D} P={P} "
                         f"offset={offset})")


def tree_split_gini(hist: torch.Tensor, totals: torch.Tensor,
                    fmask: torch.Tensor, node_mask, splits: torch.Tensor,
                    min_inst: torch.Tensor, min_gain: torch.Tensor,
                    tree=None, offset: int = 0,
                    width: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Best gini split per (lane, node), over each node's feature subset.

    hist f32 [K, P, D, NB, 1+C] and totals f32 [K, P, 1+C] of (w, w·[y=0],
    .., w·[y=C-1]), counts w non-negative; fmask bool [D] (the tree's
    features); node_mask bool [K, P, D] (each node's drawn subset) or None
    for all features; splits f32 [D, NB-1]; min_inst / min_gain f32 [K].
    The gain is ``_gain_gini`` over the bin prefix (added in the JAX
    package's order, :func:`block_prefix`), masked by min_inst on the
    weighted counts of both sides, both masks and ``bin < NB-1``; the FIRST
    max over (feature, bin) wins.  A node whose count total is below
    2·min_inst is a leaf (gain -inf, feature 0, bin 0) without a read of
    its histogram.  Returns per-node gain, feature, bin, is_leaf (gain <=
    min_gain or non-finite) and threshold ``splits[feature, bin]``, each
    [K, P], the same bits as :func:`tree_split_gini_twin`, for any C >= 2
    and NB <= 127.  ``tree`` = fit_trees' (feature, threshold, is_leaf,
    leaf [K, T, C], gain [K, D]): the level's slices at ``offset`` — the
    leaf values the class shares of the node's totals (:func:`gini_leaf`)
    — are written and the split nodes' gains added in node order, as
    :func:`write_level_twin` does (on the card the kernel's epilogue and a
    second kernel of the same call).  :func:`gini_split_plan` sizes the
    launch; ``width`` is the most features any node's subset holds (None:
    counted here, one wait for the card)."""
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
    if tree is not None:
        _check_tree("tree_split_gini", tree, K, D, P, S - 1, offset, dev)
    if dev.type == "cpu":
        out = tree_split_gini_twin(hist, totals, fmask, node_mask, splits,
                                   min_inst, min_gain)
        if tree is not None:
            write_level_twin({**out, "value": gini_leaf(totals)}, tree,
                             offset)
        return out
    if dev.type != "cuda":
        raise ValueError(f"tree_split_gini: unsupported device {dev}")
    if NB > 127:
        raise ValueError("tree_split_gini: at most 127 bins (int8 bin ids)")
    if node_mask is not None and width is None:
        width = int(node_mask.sum(dim=2).amax())
    plan = gini_split_plan(K, P, D, NB, S - 1, width)
    out = {"gain": torch.empty((K, P), dtype=torch.float32, device=dev),
           "feature": torch.empty((K, P), dtype=torch.int32, device=dev),
           "bin": torch.empty((K, P), dtype=torch.int32, device=dev),
           "is_leaf": torch.empty((K, P), dtype=torch.bool, device=dev),
           "threshold": torch.empty((K, P), dtype=torch.float32, device=dev)}
    level = [t.data_ptr() for t in tree] if tree is not None else [0] * 5
    _launch("tree_split_gini", hist.data_ptr(), totals.data_ptr(),
            fmask.data_ptr(), 0 if node_mask is None else node_mask.data_ptr(),
            splits.data_ptr(), min_inst.data_ptr(), min_gain.data_ptr(),
            *(out[k].data_ptr() for k in ("gain", "feature", "bin",
                                          "is_leaf", "threshold")),
            *level, K, P, D, NB, S - 1, plan["ct"], plan["hb"], plan["W"],
            plan["fc"], plan["FPS"], plan["FST"], plan["threads"],
            tree[0].shape[1] if tree is not None else 0, offset,
            plan["smem"], _stream(hist))
    return out


# --------------------------------------------------------------------------
# tree_split_variance
# --------------------------------------------------------------------------

def sse(s: torch.Tensor) -> torch.Tensor:
    """Sum of squared errors of stats ``s [..., 3]`` = (w, w·y, w·y²):
    s₂ - s₁²/cnt, cnt = max(s₀, 1e-12), in that f32 order (as the kernel
    computes it)."""
    return s[..., 2] - (s[..., 1] * s[..., 1]) / torch.clamp(s[..., 0],
                                                             min=1e-12)


def variance_gain(left: torch.Tensor, right: torch.Tensor,
                  parent: torch.Tensor) -> torch.Tensor:
    """``_gain_variance`` in its f32 order: sse(parent) - sse(left) -
    sse(right)."""
    return (sse(parent) - sse(left)) - sse(right)


def split_gains_variance(hist, totals, fmask, node_mask,
                         min_inst) -> torch.Tensor:
    """The variance twin's gain table [K, P, D*NB] over the kernel's bin
    prefix (``block_prefix``; see :func:`split_gains_gini`)."""
    return _gain_table(hist, totals, fmask, min_inst, variance_gain,
                       node_mask, block_prefix)


def split_gap_variance(hist, totals, fmask, node_mask,
                       min_inst) -> torch.Tensor:
    """Best minus runner-up variance gain per (lane, node) [K, P]."""
    return _top2_gap(split_gains_variance(hist, totals, fmask, node_mask,
                                          min_inst))


def tree_split_variance_twin(hist, totals, fmask, node_mask, splits,
                             min_inst, min_gain):
    """Plain-PyTorch twin of ``tree_split_variance`` (see
    :func:`tree_split_variance`): the bin prefix in the JAX package's order
    (``block_prefix``, as the kernel adds it) and ``_gain_variance``'s f32
    expression, so that the kernel gives the same bits."""
    return _split_twin(hist, totals, fmask, node_mask, splits, min_inst,
                       min_gain, lambda lanes: variance_gain, block_prefix)


def variance_leaf(totals: torch.Tensor) -> torch.Tensor:
    """Mean label of node totals [..., 3] → [..., 1] (≙ ``_leaf_variance``,
    trees.py:212-213), the division the kernel's epilogue makes."""
    return totals[..., 1:2] / torch.clamp(totals[..., 0:1], min=1e-12)


def tree_split_variance(hist: torch.Tensor, totals: torch.Tensor,
                        fmask: torch.Tensor, node_mask, splits: torch.Tensor,
                        min_inst: torch.Tensor, min_gain: torch.Tensor,
                        tree=None, offset: int = 0,
                        width: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Best variance (regression) split per (lane, node), over each node's
    feature subset.

    hist f32 [K, P, D, NB, 3] and totals f32 [K, P, 3] of (w, w·y, w·y²),
    counts w non-negative; fmask bool [D] (the tree's features); node_mask
    bool [K, P, D] (each node's drawn subset) or None for all features;
    splits f32 [D, NB-1]; min_inst / min_gain f32 [K].  The gain is
    ``_gain_variance`` over the bin prefix (added in the JAX package's
    order, :func:`block_prefix`), masked by min_inst on the weighted counts
    of both sides, both masks and ``bin < NB-1``; the FIRST max over
    (feature, bin) wins.  A node whose count total is below 2·min_inst is a
    leaf (gain -inf, feature 0, bin 0) without a read of its histogram.
    Returns per-node gain, feature, bin, is_leaf (gain <= min_gain or
    non-finite) and threshold ``splits[feature, bin]``, each [K, P], the
    same bits as :func:`tree_split_variance_twin`, for NB <= 127.  ``tree``
    = fit_trees' (feature, threshold, is_leaf, leaf [K, T, 1], gain [K,
    D]): the level's slices at ``offset`` — the leaf value the mean label
    of the node's totals (:func:`variance_leaf`) — are written and the split
    nodes' gains added in node order, as :func:`write_level_twin` does.  On
    the card the gini split's body (``csrc/split_node.cuh``) with the
    variance impurity, sized by :func:`gini_split_plan` at C = 2; ``width``
    is the most features any node's subset holds (None: counted here, one
    wait for the card)."""
    dev = hist.device
    _check("tree_split_variance hist", hist, torch.float32, 5, dev)
    _check("tree_split_variance totals", totals, torch.float32, 3, dev)
    _check("tree_split_variance fmask", fmask, torch.bool, 1, dev)
    _check("tree_split_variance splits", splits, torch.float32, 2, dev)
    for name, t in (("min_inst", min_inst), ("min_gain", min_gain)):
        _check(f"tree_split_variance {name}", t, torch.float32, 1, dev)
    K, P, D, NB, S = hist.shape
    if (S != 3 or totals.shape != (K, P, 3) or splits.shape != (D, NB - 1)
            or fmask.shape != (D,)):
        raise ValueError("tree_split_variance: shapes of hist/totals/splits/"
                         "fmask disagree")
    if node_mask is not None:
        _check("tree_split_variance node_mask", node_mask, torch.bool, 3, dev)
        if node_mask.shape != (K, P, D):
            raise ValueError("tree_split_variance: node_mask must be "
                             "[K, P, D]")
    if tree is not None:
        _check_tree("tree_split_variance", tree, K, D, P, 1, offset, dev)
    if dev.type == "cpu":
        out = tree_split_variance_twin(hist, totals, fmask, node_mask,
                                       splits, min_inst, min_gain)
        if tree is not None:
            write_level_twin({**out, "value": variance_leaf(totals)}, tree,
                             offset)
        return out
    if dev.type != "cuda":
        raise ValueError(f"tree_split_variance: unsupported device {dev}")
    if NB > 127:
        raise ValueError("tree_split_variance: at most 127 bins (int8 bin "
                         "ids)")
    if node_mask is not None and width is None:
        width = int(node_mask.sum(dim=2).amax())
    plan = gini_split_plan(K, P, D, NB, 2, width)
    out = {"gain": torch.empty((K, P), dtype=torch.float32, device=dev),
           "feature": torch.empty((K, P), dtype=torch.int32, device=dev),
           "bin": torch.empty((K, P), dtype=torch.int32, device=dev),
           "is_leaf": torch.empty((K, P), dtype=torch.bool, device=dev),
           "threshold": torch.empty((K, P), dtype=torch.float32, device=dev)}
    level = [t.data_ptr() for t in tree] if tree is not None else [0] * 5
    _launch("tree_split_variance", hist.data_ptr(), totals.data_ptr(),
            fmask.data_ptr(), 0 if node_mask is None else node_mask.data_ptr(),
            splits.data_ptr(), min_inst.data_ptr(), min_gain.data_ptr(),
            *(out[k].data_ptr() for k in ("gain", "feature", "bin",
                                          "is_leaf", "threshold")),
            *level, K, P, D, NB, 2, plan["ct"], plan["hb"], plan["W"],
            plan["fc"], plan["FPS"], plan["FST"], plan["threads"],
            tree[0].shape[1] if tree is not None else 0, offset,
            plan["smem"], _stream(hist))
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


def route_plan(N: int, D: int, K: int) -> dict:
    """How ``tree_route`` (``csrc/tree_route.cu``) launches N rows x K lanes
    over D features — the one place that sizes it.  Blocks of
    ``ROUTE_THREADS`` threads take ``rows`` = threads x ``rpt`` rows (a row
    tile, x) and ``kc`` lanes (a lane chunk, y).  Where a tile of B's rows
    fits ``ROUTE_SMEM`` (rpt 4, 2 or 1: D up to 64) the block stages it in
    shared memory (``stage``, ``smem`` bytes) and routes its lanes from
    there, so B is read once a lane chunk (``ny`` times in all); a wider B
    is gathered a byte a routed row from device memory.  The budget is
    small so that L1 keeps the resident blocks' lanes' split codes.  Lane
    chunks hold ``ROUTE_LANES`` lanes at most, fewer where the row tiles
    alone leave the launch under ``ROUTE_MIN_BLOCKS`` blocks.  Any N < 2^31, D >= 1 and
    K <= 65,535 x ``ROUTE_LANES`` has a plan (others raise
    ``ValueError``)."""
    if min(N, D, K) < 1 or N >= 1 << 31 or K > 65535 * ROUTE_LANES:
        raise ValueError(f"route_plan: N={N} (below 2^31) D={D} K={K}")
    threads = ROUTE_THREADS
    rpt = next((r for r in (4, 2, 1) if threads * r * D <= ROUTE_SMEM), 0)
    stage = rpt > 0
    rpt = rpt or 4
    rows = threads * rpt
    nx = -(-N // rows)
    ny = -(-K // ROUTE_LANES)
    kc = -(-K // ny)
    want = min(K, -(-ROUTE_MIN_BLOCKS // nx))
    if want > ny:
        kc = max(1, K // want)
    ny = -(-K // kc)
    return {"threads": threads, "rpt": rpt, "rows": rows, "stage": stage,
            "smem": rows * D if stage else 0, "kc": kc, "nx": nx, "ny": ny,
            "blocks": nx * ny}


def tree_route(B: torch.Tensor, row_node: torch.Tensor, feat: torch.Tensor,
               bin_: torch.Tensor, leaf: torch.Tensor, offset: int):
    """Route every (lane, row) of a level to its child, IN PLACE: a row at
    node ``offset + p`` whose node did not become a leaf moves to
    ``2*node + 1 + (B[n, feat] > bin)``; every other id is left as it is
    (on the card only the moved ids are written).  B int8 [N, D]; row_node
    int32 [K, N]; feat/bin int32, leaf bool [K, P].  Returns ``row_node``
    itself, routed: a caller that needs the old ids passes a copy.  On a
    CPU tensor the twin's ids are copied back into it.  The kernel packs
    each node's split into one int32 code first (a [K, P] scratch);
    :func:`route_plan` sizes the launch."""
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
        return row_node.copy_(tree_route_twin(B, row_node, feat, bin_, leaf,
                                              offset))
    if dev.type != "cuda":
        raise ValueError(f"tree_route: unsupported device {dev}")
    plan = route_plan(N, D, K)
    code = torch.empty(K * P, dtype=torch.int32, device=dev)
    _launch("tree_route", B.data_ptr(), row_node.data_ptr(), feat.data_ptr(),
            bin_.data_ptr(), leaf.data_ptr(), code.data_ptr(), N, D, K,
            offset, P, plan["threads"], plan["rpt"], int(plan["stage"]),
            plan["kc"], plan["smem"], _stream(B))
    return row_node


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


def walk_plan(N: int, D: int, Tm: int, T: int, V: int, M: int) -> dict:
    """How ``tree_walk`` launches N rows (D features) through M members of
    Tm trees of T heap nodes and V leaf values — the one place that sizes
    it.  A block of ``WALK_THREADS`` threads walks one row a thread; where
    ``threads`` x D floats (row stride ``Dp``, odd) fit ``WALK_X_SMEM``
    it stages the block's rows of X in shared memory (``x_smem``), else it
    gathers from device memory (wide X).  It stages the top ``top`` nodes
    of every tree of its member (whole levels: 2^sl - 1 of them, or all T),
    at most ``WALK_TOP`` (measured: staging more loses more in blocks an
    SM than it saves) and what fits the rest of ``WALK_SMEM``; the walk's
    first ``sl`` steps read them, deeper ones the read-only path."""
    if min(N, D, Tm, T, V, M) < 1 or M > 65535:
        raise ValueError(f"walk_plan: N={N} D={D} Tm={Tm} T={T} V={V} M={M}")
    threads = WALK_THREADS
    Dp = D | 1
    x_smem = threads * Dp * 4 <= WALK_X_SMEM
    room = WALK_SMEM - (threads * Dp * 4 if x_smem else 0)
    top = 0
    while top < T:
        nxt = min(T, 2 * top + 1)
        if nxt > WALK_TOP or 8 * Tm * nxt > room:
            break
        top = nxt
    smem = 8 * Tm * top + (4 * threads * Dp if x_smem else 0)
    return {"threads": threads, "top": top,
            "sl": (top + 1).bit_length() - 1, "x_smem": x_smem, "Dp": Dp,
            "smem": smem, "blocks": -(-N // threads) * M}


def pack_nodes(feature: torch.Tensor, threshold: torch.Tensor,
               is_leaf: torch.Tensor) -> torch.Tensor:
    """The walk's 8-byte nodes, as ``csrc/tree_walk.cu`` packs them once a
    call: int32 [..., 2] of (feature — -1 at a leaf, a negative feature of
    a split read as 0, as the twin's gather clamps it —, the threshold's
    f32 bits)."""
    f = torch.where(is_leaf, -1, torch.clamp(feature, min=0))
    return torch.stack([f.to(torch.int32),
                        threshold.contiguous().view(torch.int32)], dim=-1)


def unpack_nodes(packed: torch.Tensor):
    """(feature, threshold, is_leaf) of :func:`pack_nodes`' nodes (a leaf's
    feature reads -1)."""
    f = packed[..., 0]
    return f, packed[..., 1].contiguous().view(torch.float32), f < 0


def tree_walk(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
              is_leaf: torch.Tensor, leaf: torch.Tensor, steps: int,
              members: int = 1, op: str = "sum") -> torch.Tensor:
    """Walk N rows through Tr perfect-heap trees for ``steps`` steps and
    reduce over each member's trees.

    X f32 [N, D]; feature int32, threshold f32, is_leaf bool [Tr, T]; leaf
    f32 [Tr, T, V].  The trees are ``members`` equal groups concatenated
    along Tr.  Returns f32 [N, members, V]: the sum (``op="sum"``) or mean
    (``op="mean"``) of the reached leaves per member, summed in tree order.
    Any V: the kernel walks once per 4 leaf values.  :func:`walk_plan`
    sizes the launch; the kernel packs the nodes (:func:`pack_nodes`) once
    a call."""
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
    plan = walk_plan(N, D, Tr // members, T, V, members)
    out = torch.empty((N, members, V), dtype=torch.float32, device=dev)
    packed = torch.empty((Tr * T, 2), dtype=torch.int32, device=dev)
    _launch("tree_walk", X.data_ptr(), feature.data_ptr(),
            threshold.data_ptr(), is_leaf.data_ptr(), leaf.data_ptr(),
            packed.data_ptr(), out.data_ptr(), N, D, Tr // members, T, V,
            members, steps, int(op == "mean"), plan["threads"],
            plan["top"], plan["sl"], int(plan["x_smem"]), plan["Dp"],
            plan["smem"], _stream(X))
    return out
