#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``transmogrifai_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device and build — CUDA must be present; prints the card's name and power
   limit and builds every kernel of ``transmogrifai_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
2. kernels — each kernel runs at the dense main path's shapes (1,000,000 x
   28) against its plain-PyTorch twin on the same inputs, with its time, the
   twin's time, its bound and (where one PyTorch call computes the same
   function) that call's time: the GBT shapes (3 CV lanes, a depth-3 level)
   and the forest shapes (60 lanes = 3 folds x 20 trees, Poisson-weighted
   gini statistics, per-node feature subsets, levels 0 and 5 of a depth-6
   tree, walks of 20 depth-6 trees);
3. main path — the dense binary workload of ``bench.run_dense``: 28 RealNN
   features → transmogrify → sanity_check →
   BinaryClassificationModelSelector (3-fold CV with racing over logistic
   regression x4, a random forest of 20 depth-6 trees and GBT 20 rounds x
   depth 3) → train, evaluate (AuROC) and score on the card, with every
   kernel's launch count read around that run; the same workflow at 20,000
   rows is then run on the card (forest draws made on the card, and made on
   the host) and on the CPU twins (draws on the host), and held to the JAX
   package's forest CV AuPR at that size.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` table, the one before that the
card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS, N_FEATS, N_BINS, N_FOLDS = 1_000_000, 28, 32, 3
N_TREES, RF_DEPTH = 20, 6         # the bench's forest candidate
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
# The JAX package's forest at 20,000 rows (make_data seed 0, RF seed 42,
# CPU): CV AuPR 0.7068 (BENCH_STANDING.json run 0), winner LR.  The port's
# forest draws other random numbers, so its CV AuPR must land within
# RF_CV_AUPR_TOL = max(0.01, 3 x the JAX package's spread of that AuPR over
# 5 RF seeds), measured by `python tests/test_torch_forest.py` (PERF.md).
JAX_20K_RF_CV_AUPR = 0.7068
JAX_20K_WINNER = "OpLogisticRegression"
RF_CV_AUPR_TOL = 0.0306            # 3 x 0.0102, the JAX package's spread
                                   # over RF seeds 42, 0, 1, 2, 3


def make_data(n: int, d: int = N_FEATS, seed: int = 0):
    """HIGGS-difficulty synthetic (a copy of ``bench.make_data``): linear
    signal damped to sqrt(d) scale plus mild interactions, unit noise —
    best-model AuROC lands near 0.80."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32) / np.sqrt(d)
    logits = (X @ w + 0.35 * (X[:, 0] * X[:, 1]) - 0.25 * (X[:, 2] ** 2)
              + 0.1 + 0.3 * np.sin(2 * X[:, 3]))
    y = (logits + rng.normal(size=n).astype(np.float32) > 0).astype(np.float32)
    return X, y


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: each kernel against its twin at the main path's shapes
# --------------------------------------------------------------------------

def kernel_inputs(device, n: int, seed: int = 1):
    """Inputs of one depth-3 GBT level for 3 CV lanes: the bench matrix, its
    bins, fold-weighted (w, w·g, w·h) statistics from random margins, and
    rows spread over the level's 4 nodes (some already at leaves above)."""
    import torch

    from transmogrifai_tpu_torch.models.trees import binned
    from transmogrifai_tpu_torch.tuning import OpCrossValidation

    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    splits, sp_t, B = binned(Xd, Xd, N_BINS)
    rng = np.random.default_rng(seed)
    W = np.zeros((N_FOLDS, n), np.float32)
    for f, (tr, _) in enumerate(OpCrossValidation(N_FOLDS).splits(y)):
        W[f, tr] = 1.0
    margin = rng.normal(scale=0.5, size=(N_FOLDS, n)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-margin))
    g, h = p - y[None], np.maximum(p * (1 - p), 1e-6)
    stats = np.stack([np.ones_like(g), g, h], axis=2) * W[:, :, None]
    row_node = rng.integers(1, 7, size=(N_FOLDS, n)).astype(np.int32)
    return {"X": Xd, "y": y, "B": B, "splits": sp_t,
            "stats": torch.as_tensor(stats, device=device),
            "row_node": torch.as_tensor(row_node, device=device),
            "offset": 3, "P": 4}


def _random_trees(device, n_trees: int, depth: int, d: int, seed: int = 2,
                  classes: int = 0):
    """``n_trees`` perfect-heap trees of ``depth`` with a leaf above the
    bottom level in every tree and +inf thresholds under it; one leaf value
    per node, or with ``classes`` the class shares of a gini leaf."""
    import torch
    rng = np.random.default_rng(seed)
    T = 2 ** (depth + 1) - 1
    feature = rng.integers(0, d, size=(n_trees, T)).astype(np.int32)
    threshold = rng.normal(scale=0.7, size=(n_trees, T)).astype(np.float32)
    is_leaf = np.zeros((n_trees, T), bool)
    is_leaf[:, 2 ** depth - 1:] = True
    is_leaf[:, 2] = True                       # an early leaf
    threshold[:, 5:7] = np.inf                 # never taken
    feature[is_leaf] = -1
    if classes:
        leaf = rng.random((n_trees, T, classes)).astype(np.float32)
        leaf /= leaf.sum(axis=2, keepdims=True)
    else:
        leaf = rng.normal(scale=0.1, size=(n_trees, T, 1)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (feature, threshold, is_leaf, leaf))


def check_kernels(device, n: int = N_ROWS, reps: int = 20):
    """Each kernel vs its twin on the same inputs; returns one row per
    kernel for the ``kernels`` line (launches filled in later)."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk

    inp = kernel_inputs(device, n)
    B, stats, row_node = inp["B"], inp["stats"], inp["row_node"]
    off, P = inp["offset"], inp["P"]
    K, D = row_node.shape[0], B.shape[1]
    S = stats.shape[2]
    rows = []

    # tree_hist at every level shape of the depth-3 fit: P = 1, 2, 4 with
    # the histogram, then the bottom level's P = 8 totals only; the P = 4
    # level is the one timed below
    rng = np.random.default_rng(3)
    hist = tot = None
    hist_err = 0.0
    for lo, P_l, with_hist in ((0, 1, True), (1, 2, True), (off, P, True),
                               (7, 8, False)):
        rn = (row_node if lo == off else torch.as_tensor(
            rng.integers(max(0, lo - 2), lo + P_l, size=(K, n)).astype(
                np.int32), device=device))
        h, t, e = _check_hist(tk, B, rn, stats, lo, P_l, with_hist)
        hist_err = max(hist_err, e)
        if lo == off:
            hist, tot = h, t
    cells = row_node.long() - off
    in_level = (cells >= 0) & (cells < P)
    at = int(in_level.sum())
    flat_idx = ((torch.where(in_level, cells, 0)[:, :, None]
                 + torch.arange(K, device=device)[:, None, None] * P) * D
                + torch.arange(D, device=device)) * N_BINS + B.long()[None]
    flat_idx = flat_idx.reshape(-1)
    vals = (stats * in_level[..., None])[:, :, None, :].expand(
        K, n, D, S).reshape(-1, S).contiguous()
    lib_out = torch.zeros((K * P * D * N_BINS, S), device=device)
    bt, by = bound(B.numel() + 4 * row_node.numel() + 4 * stats.numel()
                   + 4 * (hist.numel() + tot.numel()), at * D * S)
    rows.append({
        "name": "tree_hist", "max_abs_err": hist_err,
        "ms": time_ms(lambda: tk.tree_hist(B, row_node, stats, off, P,
                                           N_BINS), reps),
        "plain_ms": time_ms(lambda: tk.tree_hist_twin(B, row_node, stats, off,
                                                      P, N_BINS), 3),
        "bound_ms": bt, "bound_by": by,
        "library_ms": time_ms(lambda: lib_out.index_put_(
            (flat_idx,), vals, accumulate=True), 3)})

    # tree_split on the kernel's histogram: gains within 1e-5 of the terms
    # they are a difference of (|gain| + the parent's G²/(H+λ)); the chosen
    # (feature, bin) must agree wherever best and runner-up differ by more
    # than 1e-4 relative
    fmask = torch.ones(D, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, dtype=torch.float32, device=device)
    args = (hist, tot, fmask, inp["splits"], lane(10.0), lane(0.0), lane(1.0))
    sk = tk.tree_split(*args)
    st = tk.tree_split_twin(*args)
    fin = torch.isfinite(st["gain"])
    if not torch.equal(fin, torch.isfinite(sk["gain"])):
        raise AssertionError("tree_split: finite gains differ from the twin")
    gerr = torch.where(fin, (sk["gain"] - st["gain"]).abs(), 0.0)
    scale = st["gain"].abs() + tot[..., 1] ** 2 / (tot[..., 2] + 1.0)
    if bool((gerr > 1e-5 * torch.where(fin, scale, 0.0) + 1e-6).any()):
        raise AssertionError("tree_split gains disagree with the twin")
    gap = tk.split_gap(hist, tot, fmask, args[4], args[6])
    clear = gap > 1e-4 * st["gain"].abs()
    same = (sk["feature"] == st["feature"]) & (sk["bin"] == st["bin"])
    if bool((clear & ~same).any()):
        raise AssertionError("tree_split picked another split than the twin")
    bt, by = bound(4 * (hist.numel() + tot.numel()) + D + 4 * inp["splits"].numel()
                   + 21 * K * P, 10 * hist.numel() // S)
    rows.append({
        "name": "tree_split", "max_abs_err": float(gerr.max()),
        "ms": time_ms(lambda: tk.tree_split(*args), reps),
        "plain_ms": time_ms(lambda: tk.tree_split_twin(*args), reps),
        "bound_ms": bt, "bound_by": by, "library_ms": None})

    # tree_route: integer work, exact
    feat, bin_, leaf = st["feature"], st["bin"], st["is_leaf"].clone()
    leaf[:, 1] = True                     # a node that stops splitting
    rk = tk.tree_route(B, row_node, feat, bin_, leaf, off)
    rt = tk.tree_route_twin(B, row_node, feat, bin_, leaf, off)
    if not torch.equal(rk, rt):
        raise AssertionError("tree_route disagrees with its twin")
    bt, by = bound(8 * row_node.numel() + at, at)
    rows.append({
        "name": "tree_route", "max_abs_err": float((rk - rt).abs().max()),
        "ms": time_ms(lambda: tk.tree_route(B, row_node, feat, bin_, leaf,
                                            off), reps),
        "plain_ms": time_ms(lambda: tk.tree_route_twin(B, row_node, feat,
                                                       bin_, leaf, off), reps),
        "bound_ms": bt, "bound_by": by, "library_ms": None})

    # tree_walk at the main path's three shapes, each walked depth+1 steps:
    # a boosting round's margin update (3 lanes x 1 tree), the CV panel (3
    # members x 20 trees) and the final model (20 trees, the timed one);
    # both sum the trees in the same order
    X = inp["X"]
    werr = 0.0
    for n_trees, members in ((3, 3), (60, 3), (20, 1)):
        trees = _random_trees(device, n_trees, 3, D)
        wk = tk.tree_walk(X, *trees, 4, members)
        wt = tk.tree_walk_twin(X, *trees, 4, members)
        e = float((wk - wt).abs().max())
        if e > 1e-6:
            raise AssertionError(f"tree_walk disagrees with its twin at "
                                 f"{n_trees} trees x {members} members: {e}")
        werr = max(werr, e)
    used = int(torch.unique(trees[0][trees[0] >= 0]).numel())
    bt, by = bound(4 * n * used + 4 * n + sum(4 * t.numel() for t in trees),
                   n * 20 * 5)
    rows.append({
        "name": "tree_walk", "max_abs_err": werr,
        "ms": time_ms(lambda: tk.tree_walk(X, *trees, 4), reps),
        "plain_ms": time_ms(lambda: tk.tree_walk_twin(X, *trees, 4, 1), 3),
        "bound_ms": bt, "bound_by": by, "library_ms": None})
    for r in rows:
        r["route"] = "cuda"
        r["source"] = f"transmogrifai_tpu_torch/csrc/{r['name']}.cu"
        r["replaces"] = tk.REPLACES[r["name"]]
    return rows


def _fold_weights(y: np.ndarray) -> np.ndarray:
    from transmogrifai_tpu_torch.tuning import OpCrossValidation
    W = np.zeros((N_FOLDS, len(y)), np.float32)
    for f, (tr, _) in enumerate(OpCrossValidation(N_FOLDS).splits(y)):
        W[f, tr] = 1.0
    return W


def forest_inputs(device, n: int, seed: int = 4):
    """Inputs of the main path's forest fit: 60 lanes (3 folds x 20 trees,
    lane = fold*20 + tree) of gini statistics (w, w·[y=0], w·[y=1]) with
    w = Poisson(1) draw x fold weight, the per-node subsets of the forest's
    draws, and rows spread over level 5's 32 nodes (offset 31), some parked
    at level-4 leaves."""
    import torch

    from transmogrifai_tpu_torch.models.trees import binned, forest_draws

    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    D = B.shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    dr = forest_draws(gen, n_trees=N_TREES, n_rows=n, rates=[1.0],
                      max_depth=RF_DEPTH,
                      fmask=torch.ones(D, dtype=torch.bool, device=device),
                      features_per_node=int(np.sqrt(D)))
    W = torch.as_tensor(_fold_weights(y), device=device)
    K = N_FOLDS * N_TREES
    bw = (W[:, None, :] * dr.boot[1.0][None]).reshape(K, n)
    yd = torch.as_tensor(y, device=device)
    base = torch.stack([torch.ones_like(yd), 1.0 - yd, yd], dim=1)
    stats = (base[None] * bw[:, :, None]).contiguous()
    tree_of_lane = torch.arange(K, device=device) % N_TREES
    rng = np.random.default_rng(seed)
    row_node = torch.as_tensor(
        rng.integers(25, 63, size=(K, n)).astype(np.int32), device=device)
    return {"X": Xd, "B": B, "splits": sp_t, "stats": stats,
            "row_node": row_node,
            "masks": [m[tree_of_lane].contiguous() for m in dr.subsets]}


def check_forest_kernels(device, n: int = N_ROWS, reps: int = 10):
    """The forest's kernels at the main path's forest shapes.  Returns the
    ``tree_split_gini`` row of the kernels line and a dict of the other
    kernels' forest-shape checks and times (printed on their own line)."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk

    from transmogrifai_tpu_torch.models.trees import forest_draws

    inp = forest_inputs(device, n)
    B, stats, row_node = inp["B"], inp["stats"], inp["row_node"]
    K, D = row_node.shape[0], B.shape[1]
    S = stats.shape[2]
    off, P = 31, 32
    facts = {"forest_draws_s": {}}

    # the forest's draws at the main path's shape, by a host generator and
    # by one on the card (host clock, one call each after a warm-up)
    for where in ("cpu", device):
        def draw():
            gen = torch.Generator(device=where).manual_seed(0)
            forest_draws(gen, n_trees=N_TREES, n_rows=n, rates=[1.0],
                         max_depth=RF_DEPTH,
                         fmask=torch.ones(D, dtype=torch.bool, device=where),
                         features_per_node=int(np.sqrt(D)))
            if where != "cpu":
                torch.cuda.synchronize()
        draw()
        t0 = time.perf_counter()
        draw()
        facts["forest_draws_s"][str(where)] = time.perf_counter() - t0

    # tree_hist at level 5: the 60-lane kernel call against the twin run in
    # f64 one lane at a time (the 60-lane twin needs > 50 GB); the kernel
    # passing over zero-weight rows must give the same histogram as the one
    # adding them (the integer counts are exact in f32 either way)
    hist, tot = tk.tree_hist(B, row_node, stats, off, P, N_BINS)
    hist_all, tot_all = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                                     skip_zero=False)
    if not (torch.equal(hist, hist_all) and torch.equal(tot, tot_all)):
        raise AssertionError("tree_hist: skipping zero rows changed a sum")
    err = 0.0
    for k in range(K):
        ht, tt = tk.tree_hist_twin(B, row_node[k:k + 1], stats[k:k + 1].double(),
                                   off, P, N_BINS)
        e_h = (hist[k:k + 1].double() - ht).abs()
        e_t = (tot[k:k + 1].double() - tt).abs()
        # statistics are >= 0, so the twin's sums are the cells' mass
        if bool((e_h > 1e-5 + 1e-5 * ht).any() or (e_t > 1e-5 + 1e-5 * tt).any()):
            raise AssertionError(f"tree_hist (forest level 5, lane {k}) "
                                 "disagrees with its twin")
        err = max(err, float(e_h.max()), float(e_t.max()))
    at = row_node - off
    in_level = (at >= 0) & (at < P)
    live = int((in_level & (stats[..., 0] != 0)).sum())
    bt, _ = bound(B.numel() + 4 * row_node.numel() + 4 * stats.numel()
                  + 4 * (hist.numel() + tot.numel()), live * D * S)
    facts["tree_hist"] = {
        "lanes": K, "P": P, "max_abs_err": err,
        "rows_in_level": int(in_level.sum()), "rows_nonzero": live,
        "ms_skip_zero": time_ms(lambda: tk.tree_hist(
            B, row_node, stats, off, P, N_BINS), reps),
        "ms_all_rows": time_ms(lambda: tk.tree_hist(
            B, row_node, stats, off, P, N_BINS, skip_zero=False), reps),
        "bound_ms": bt}

    # tree_split_gini at levels 0 (P = 1) and 5 (P = 32) with the forest's
    # per-node subsets; gains within 1e-6 of wgini(parent), the terms they
    # are a difference of; choices equal where best - runner-up > 1e-5 of it
    fmask = torch.ones(D, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, dtype=torch.float32, device=device)
    h0, t0 = tk.tree_hist(B, torch.zeros_like(row_node), stats, 0, 1, N_BINS)
    gerr = 0.0
    for h, t, m in ((h0, t0, inp["masks"][0]), (hist, tot, inp["masks"][5])):
        args = (h, t, fmask, m, inp["splits"], lane(10.0), lane(0.0))
        sk, st = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
        fin = torch.isfinite(st["gain"])
        if not torch.equal(fin, torch.isfinite(sk["gain"])):
            raise AssertionError("tree_split_gini: finite gains differ")
        scale = tk.wgini(t)
        e = torch.where(fin, (sk["gain"] - st["gain"]).abs(), 0.0)
        if bool((e > 1e-6 * scale).any()):
            raise AssertionError("tree_split_gini gains disagree with the twin")
        gap = tk.split_gap_gini(h, t, fmask, m, args[5])
        clear = gap > 1e-5 * scale
        same = ((sk["feature"] == st["feature"]) & (sk["bin"] == st["bin"])
                & (sk["is_leaf"] == st["is_leaf"])
                & (sk["threshold"] == st["threshold"]))
        if bool((clear & ~same).any()):
            raise AssertionError("tree_split_gini picked another split than "
                                 "the twin")
        gerr = max(gerr, float(e.max()))
    m5 = inp["masks"][5]
    read = int(m5.sum()) * N_BINS * S * 4        # histograms of kept features
    bt, by = bound(read + 4 * tot.numel() + m5.numel() + D
                   + 4 * inp["splits"].numel() + 8 * K + 17 * K * P,
                   23 * int(m5.sum()) * N_BINS)
    args = (hist, tot, fmask, m5, inp["splits"], lane(10.0), lane(0.0))
    row = {"name": "tree_split_gini", "max_abs_err": gerr,
           "ms": time_ms(lambda: tk.tree_split_gini(*args), reps),
           "plain_ms": time_ms(lambda: tk.tree_split_gini_twin(*args), reps),
           "bound_ms": bt, "bound_by": by, "library_ms": None}

    # tree_route at level 5 of 60 lanes: exact
    sp = tk.tree_split_gini_twin(*args)
    rk = tk.tree_route(B, row_node, sp["feature"], sp["bin"], sp["is_leaf"], off)
    rt = tk.tree_route_twin(B, row_node, sp["feature"], sp["bin"],
                            sp["is_leaf"], off)
    if not torch.equal(rk, rt):
        raise AssertionError("tree_route (forest level 5) disagrees with its twin")
    facts["tree_route"] = {"lanes": K, "P": P, "ms": time_ms(
        lambda: tk.tree_route(B, row_node, sp["feature"], sp["bin"],
                              sp["is_leaf"], off), reps),
        "bound_ms": bound(8 * row_node.numel() + int(in_level.sum()),
                          int(in_level.sum()))[0]}

    # tree_walk at the forest's shapes, V = 2 class shares, 7 steps: the
    # model's mean over 20 trees and the CV panel's 3 members x 20 trees sum
    X = inp["X"]
    werr = 0.0
    for n_trees, members, op in ((N_TREES, 1, "mean"),
                                 (N_FOLDS * N_TREES, N_FOLDS, "sum")):
        trees = _random_trees(device, n_trees, RF_DEPTH, D, classes=2)
        wk = tk.tree_walk(X, *trees, RF_DEPTH + 1, members, op)
        wt = tk.tree_walk_twin(X, *trees, RF_DEPTH + 1, members, op)
        e = float((wk - wt).abs().max())
        if e > 1e-6:
            raise AssertionError(f"tree_walk disagrees with its twin at "
                                 f"{n_trees} trees x {members} members ({op})")
        werr = max(werr, e)
        if members == 1:
            used = int(torch.unique(trees[0][trees[0] >= 0]).numel())
            facts["tree_walk"] = {
                "trees": n_trees, "V": 2, "op": op, "ms": time_ms(
                    lambda: tk.tree_walk(X, *trees, RF_DEPTH + 1, 1, op),
                    reps),
                "bound_ms": bound(4 * n * used + 8 * n
                                  + sum(t.numel() * t.element_size()
                                        for t in trees),
                                  n * n_trees * (RF_DEPTH + 2))[0]}
    facts["tree_walk"]["max_abs_err"] = werr
    row.update(route="cuda",
               source="transmogrifai_tpu_torch/csrc/tree_split_gini.cu",
               replaces=tk.REPLACES["tree_split_gini"])
    return row, facts


def _check_hist(tk, B, row_node, stats, off: int, P: int, with_hist: bool):
    """``tree_hist`` against its twin at one level; returns (hist, totals,
    max abs error).  A node total sums ~10^5 f32 values, where any f32 order
    (the twin's serial adds included) drifts by more than 1e-5 of the sum;
    so the kernel is held to the twin run in f64 on the same inputs, within
    1e-5 of each cell's absolute mass (plus 1e-5 absolute)."""
    hist, tot = tk.tree_hist(B, row_node, stats, off, P, N_BINS, with_hist)
    s64 = stats.double()
    hist_t, tot_t = tk.tree_hist_twin(B, row_node, s64, off, P, N_BINS,
                                      with_hist)
    mass, mass_tot = tk.tree_hist_twin(B, row_node, s64.abs(), off, P, N_BINS,
                                       with_hist)
    err_tot = (tot.double() - tot_t).abs()
    bad_tot = int((err_tot > 1e-5 + 1e-5 * mass_tot).sum())
    err, bad = float(err_tot.max()), 0
    if with_hist:
        err_h = (hist.double() - hist_t).abs()
        bad = int((err_h > 1e-5 + 1e-5 * mass).sum())
        err = max(err, float(err_h.max()))
    if bad or bad_tot:
        raise AssertionError(f"tree_hist (offset {off}, P {P}) disagrees with "
                             f"its twin in {bad} histogram cells and "
                             f"{bad_tot} node totals")
    return hist, tot, err


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def build_workflow(X, y, device, draw_device=None):
    """The dense workload of ``bench.run_dense``: LR reg_param x4
    (elastic_net 0.1, max_iter 50) + RF (20 trees, depth 6, min_instances
    10, "auto" subsets, bootstrap) + GBT (20 rounds, depth 3, min_instances
    10), 3-fold CV ranked by AuPR.  ``draw_device`` is where the forest's
    generator draws (default: the fit's device)."""
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import (OpGBTClassifier,
                                                      OpRandomForestClassifier)
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, ModelCandidate, grid)
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow

    D = X.shape[1]
    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    checked = label.sanity_check(transmogrify(feats), remove_bad_features=True)
    selector = BinaryClassificationModelSelector(models=[
        ModelCandidate(OpLogisticRegression(),
                       grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                            elastic_net_param=[0.1], max_iter=[50]),
                       "OpLogisticRegression"),
        ModelCandidate(OpRandomForestClassifier(draw_device=draw_device),
                       grid(num_trees=[N_TREES], max_depth=[RF_DEPTH],
                            min_instances_per_node=[10]),
                       "OpRandomForestClassifier"),
        ModelCandidate(OpGBTClassifier(),
                       grid(max_iter=[20], max_depth=[3],
                            min_instances_per_node=[10]),
                       "OpGBTClassifier")])
    selector.set_input(label, checked)
    pred = selector.get_output()
    cols = {"label": Column(RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = Column(RealNN, X[:, i])
    batch = ColumnBatch(cols, len(y))
    return Workflow(device=device).set_input_batch(batch).set_result_features(pred), batch


def run_main_path(device, n: int, draw_device=None):
    """Train, evaluate and score; returns the run's facts."""
    import torch

    from transmogrifai_tpu_torch.evaluators import Evaluators
    X, y = make_data(n)
    wf, batch = build_workflow(X, y, device, draw_device)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    auroc = float(model.evaluate(Evaluators.BinaryClassification.auROC(),
                                 batch=batch)["AuROC"])
    scored = model.score(batch)
    pred = next(iter(scored.items()))[1].values
    p = pred["probability"]
    if tuple(p.shape) != (n, 2) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"scores: shape {tuple(p.shape)} or non-finite")
    summ = model.selected_model.summary
    fam = {}
    for r in summ.validation_results:
        v = next(iter(r.metric_values.values()))
        if r.model_name not in fam or v > fam[r.model_name]:
            fam[r.model_name] = float(v)
    return {"train_wall_s": wall, "best_model": summ.best_model_name,
            "family_cv_metrics": fam, "train_auroc": auroc,
            "phase_seconds": model.phase_seconds,
            "selector_seconds": model.selected_model.selector_seconds}


def check_small_runs() -> dict:
    """The workflow at 20,000 rows: on the card with the forest's draws made
    on the card (the main path's default) and made on the host, and on the
    CPU twins with host draws.  Host draws on both devices give the same
    forest up to float rounding, so every family agrees within 1e-3; card
    draws are another stream, held statistically: each run's forest CV AuPR
    within RF_CV_AUPR_TOL of the JAX package's and the JAX package's
    winner."""
    runs = {"card_card_draws": run_main_path("cuda", 20_000),
            "card_host_draws": run_main_path("cuda", 20_000, "cpu"),
            "cpu_host_draws": run_main_path("cpu", 20_000, "cpu")}
    for name, r in runs.items():
        rf = r["family_cv_metrics"]["OpRandomForestClassifier"]
        if abs(rf - JAX_20K_RF_CV_AUPR) > RF_CV_AUPR_TOL:
            raise AssertionError(f"small run {name}: forest CV AuPR {rf} is "
                                 f"more than {RF_CV_AUPR_TOL} from the JAX "
                                 f"package's {JAX_20K_RF_CV_AUPR}")
        if r["best_model"] != JAX_20K_WINNER:
            raise AssertionError(f"small run {name}: winner {r['best_model']}"
                                 f", the JAX package's is {JAX_20K_WINNER}")
    gpu, cpu = runs["card_host_draws"], runs["cpu_host_draws"]
    for fam, v in cpu["family_cv_metrics"].items():
        if abs(gpu["family_cv_metrics"][fam] - v) > 1e-3:
            raise AssertionError(f"small run: {fam} CV metric "
                                 f"{gpu['family_cv_metrics'][fam]} on the card "
                                 f"vs {v} on the CPU (same draws)")
    if abs(gpu["train_auroc"] - cpu["train_auroc"]) > 1e-3:
        raise AssertionError("small run: train AuROC differs card vs CPU")
    return {name: {"family_cv_metrics": r["family_cv_metrics"],
                   "best_model": r["best_model"],
                   "train_auroc": r["train_auroc"]}
            for name, r in runs.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.models import tree_kernels as tk

    # phase 1: device and build
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all(verbose=True)
    print(f"build_s: {time.perf_counter() - t0:.3f}", flush=True)

    # phase 2: kernels vs twins
    rows = check_kernels("cuda")
    gini_row, forest_facts = check_forest_kernels("cuda")
    rows.insert(2, gini_row)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    print("forest shapes: " + json.dumps(forest_facts), flush=True)
    torch.cuda.empty_cache()

    # phase 3: the main path, launches counted around it alone
    tk.reset_launch_counts()
    facts = run_main_path("cuda", N_ROWS)
    launches = tk.launch_counts()
    print(f"main path {N_ROWS}x{N_FEATS}: " + json.dumps(facts), flush=True)
    print("kernel launches: " + json.dumps(launches), flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if facts["train_auroc"] <= 0.7:
        raise AssertionError(f"train AuROC {facts['train_auroc']} <= 0.7")
    torch.cuda.empty_cache()

    # the same workflow at 20,000 rows: card vs CPU twins vs the JAX package
    print("small runs (20000 rows): " + json.dumps(check_small_runs()),
          flush=True)

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
