#!/usr/bin/env python3
"""Time the split kernels, and the bench set's train wall, on one NVIDIA
card: ``tree_split`` at a depth-3 GBT level (3 lanes, P = 4) and at the
default grid's GBT level 11 (6 lanes, P = 2048) on synthetic full
histograms, and at level 11 as the grid's GBT sends it (6 and 12 lanes,
three quarters of each lane's rows in 8 nodes: ``chip_smoke.
gbt_level_inputs`` and ``tree_hist``, min_instances 10 and 100 by grid
point); ``tree_split_gini`` at a forest level 5 (60 lanes, P = 32) and at
the default grid's RF level 11 (150 and 300 lanes, P = 2048), all with
5-of-28 node subsets and binary counts, and at level 5 with 4 classes (4
features a node, as the multiclass workload's 16 give) and with 40
classes; ``tree_split_variance`` at the regression RF's level 5 (300
lanes, P = 32), level 11 of its depth-12 group (150 lanes, P = 2048), both
with 5-of-16 node subsets, and at level 5 with ``max_bins=64`` (60 lanes);
then ``chip_smoke.run_main_path`` (the bench set: LR x4, RF, GBT with
3-fold CV) at 1,000,000 x 28.

    python3 scripts/split_kernel_time.py [--root DIR] [--reps R]
        [--rows N] [--train-reps T] [--kernel-times]
        [--kernel xgb|gini|variance]

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the inputs and the trains come from
this script's ``chip_smoke.py``), so that two versions can be compared on
one card: run each in its own process, in the order A B B A.  A version whose wrapper refuses a shape reports its
``ValueError`` for it.  The histograms are synthetic (a seeded generator
on the card, the same in every process): integer counts and class counts
for gini, (count, w·g, w·h) for xgb, (count, w·y, w·y²) for variance,
every bin of every node filled, the
parent totals the sums over one feature's bins.  Times are CUDA events
over ``--reps`` calls after a warm-up: ``ms`` of the wrapper called from
Python (at small shapes the host's launch path, not the kernel, sets it)
and ``graph_ms`` of one replay of the call captured in a CUDA graph (the
kernel alone); ``--kernel-times`` adds ``kernel_ms``, the device ms a call
spends in the split's kernels by the profiler
(``chip_smoke.kernel_device_ms``).  Where the version's ``tree_split``
writes fit_trees' tree arrays (``tree=``), the xgb shapes are also timed
in that form (``epilogue``).  Each gini shape is also timed as fit_trees'
whole level after its histogram (``_level``, one CUDA-graph replay, and
its kernels' device ms): with a ``tree_split_gini`` that writes the tree
arrays, that call; with one that does not, its dict form and the torch
ops fit_trees then ran on the level (leaf values, is_leaf, feature,
threshold, the gain ``scatter_add_``).  The variance shapes likewise.  ``--kernel`` times one family of
shapes only (default: both).
``--train-reps 0`` skips the trains; else the first train is a warm-up.
Prints one JSON line: the card's name and power limit, the root, each
shape's times, and the train walls.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, NB = 28, 32


def time_ms(fn, reps: int) -> float:
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


def graph_ms(fn, reps: int) -> float:
    """Mean ms of one replay of ``fn`` captured in a CUDA graph: the
    kernel with no Python between launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, reps)


def split_inputs(K: int, P: int, C: int, subset: int, gen, d: int = D,
                 nb: int = NB, variance: bool = False):
    """A level's histogram [K, P, d, nb, S] with its totals, the split
    points, and (``subset`` > 0) each node's drawn features: gini
    statistics (count, class counts) with C classes, xgb ones with C = 0,
    variance ones (count, w·y, w·y²) with ``variance``."""
    import torch
    dev = "cuda"
    D, NB = d, nb
    if variance:
        cnt = torch.randint(0, 40, (K, P, D, NB, 1), generator=gen,
                            device=dev).float()
        m = torch.randn((K, P, D, NB, 1), generator=gen, device=dev)
        v = torch.rand((K, P, D, NB, 1), generator=gen, device=dev)
        hist = torch.cat([cnt, cnt * m, cnt * (m * m + v)], dim=4)
    elif C:
        cls = torch.randint(0, 40, (K, P, D, NB, C), generator=gen,
                            device=dev).float()
        hist = torch.cat([cls.sum(dim=4, keepdim=True), cls], dim=4)
    else:
        cnt = torch.randint(0, 40, (K, P, D, NB, 1), generator=gen,
                            device=dev).float()
        g = torch.randn((K, P, D, NB, 1), generator=gen, device=dev) * cnt
        h = torch.rand((K, P, D, NB, 1), generator=gen, device=dev) * cnt
        hist = torch.cat([cnt, g, h], dim=4)
    hist = hist.contiguous()
    totals = hist[:, :, 0].sum(dim=2).contiguous()
    splits = torch.sort(torch.randn((D, NB - 1), generator=gen, device=dev),
                        dim=1).values.contiguous()
    mask = None
    if subset:
        keys = torch.rand((K, P, D), generator=gen, device=dev)
        mask = torch.zeros((K, P, D), dtype=torch.bool, device=dev)
        mask.scatter_(2, torch.topk(keys, subset, dim=2).indices, True)
    return hist, totals, splits, mask


def _tree(K: int, P: int, V: int, D: int = D):
    """fit_trees' arrays for a level of P nodes at offset P - 1."""
    import torch
    T = 4 * P - 1
    return (torch.full((K, T), -1, dtype=torch.int32, device="cuda"),
            torch.full((K, T), float("inf"), device="cuda"),
            torch.zeros((K, T), dtype=torch.bool, device="cuda"),
            torch.zeros((K, T, V), device="cuda"),
            torch.zeros((K, D), device="cuda"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--train-reps", type=int, default=2)
    ap.add_argument("--kernel-times", action="store_true")
    ap.add_argument("--kernel", choices=("xgb", "gini", "variance"),
                    default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("split_kernel_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    epilogue = "tree" in inspect.signature(tk.tree_split).parameters
    gini_params = inspect.signature(tk.tree_split_gini).parameters
    gini_tree = "tree" in gini_params
    var_params = inspect.signature(tk.tree_split_variance).parameters

    gen = torch.Generator(device="cuda").manual_seed(0)
    fmask = torch.ones(D, dtype=torch.bool, device="cuda")
    out, graph, kernel = {}, {}, {}

    def timed(name, run, key):
        out[name] = time_ms(run, args.reps)
        graph[name] = graph_ms(run, args.reps)
        if args.kernel_times:
            kernel[name] = chip_smoke.kernel_device_ms(run, args.reps, key)

    def xgb(name, hist, tot, sp, mi, mg, lam):
        K, P = tot.shape[:2]
        timed(name, lambda: tk.tree_split(hist, tot, fmask, sp, mi, mg, lam),
              "tree_split")
        if epilogue:
            tree = _tree(K, P, 1)
            run = lambda: tk.tree_split(                  # noqa: E731
                hist, tot, fmask, sp, mi, mg, lam, tree=tree, offset=P - 1)
            graph[name + "_epilogue"] = graph_ms(run, args.reps)
            if args.kernel_times:
                kernel[name + "_epilogue"] = chip_smoke.kernel_device_ms(
                    run, args.reps, "tree_split")

    if args.kernel in (None, "xgb"):
        for name, K, P in (("tree_split_gbt_level_3_lanes_P4", 3, 4),
                           ("tree_split_gbt_level11_6_lanes", 6, 2048)):
            hist, tot, sp, _ = split_inputs(K, P, 0, 0, gen)
            one, ten, zero = (torch.full((K,), v, device="cuda")
                              for v in (1.0, 10.0, 0.0))
            xgb(name, hist, tot, sp, ten, zero, one)
            del hist, tot
        data = chip_smoke.bench_binned("cuda", args.rows)
        for K in (6, 12):
            inp = chip_smoke.gbt_level_inputs("cuda", args.rows, K, 11,
                                              data=data)
            hist, tot = tk.tree_hist(inp["B"], inp["row_node"], inp["stats"],
                                     inp["offset"], inp["P"], NB)
            mi = torch.tensor([(10.0, 100.0)[k % 6 // 3] for k in range(K)],
                              device="cuda")
            mg = torch.tensor([(0.001, 0.01, 0.1)[k % 3] for k in range(K)],
                              device="cuda")
            xgb(f"tree_split_gbt_level11_{K}_lanes_skewed", hist, tot,
                data[1], mi, mg, torch.ones(K, device="cuda"))
            del inp, hist, tot
        del data
        torch.cuda.empty_cache()
    if args.kernel in (None, "gini"):
        for name, K, P, C, sub in (
                ("tree_split_gini_level5_60_lanes", 60, 32, 2, 5),
                ("tree_split_gini_rf_level11_150_lanes", 150, 2048, 2, 5),
                ("tree_split_gini_rf_level11_300_lanes", 300, 2048, 2, 5),
                ("tree_split_gini_level5_60_lanes_4_classes", 60, 32, 4, 4),
                ("tree_split_gini_level5_60_lanes_40_classes", 60, 32, 40,
                 5)):
            hist, tot, sp, mask = split_inputs(K, P, C, sub, gen)
            ten, zero = (torch.full((K,), v, device="cuda")
                         for v in (10.0, 0.0))
            a = (hist, tot, fmask, mask, sp, ten, zero)
            # the subsets' width as fit_trees passes it (no wait in a graph)
            kw = {"width": sub} if "width" in gini_params else {}
            try:
                timed(name, lambda: tk.tree_split_gini(*a, **kw),
                      "tree_split_gini")
            except ValueError as e:      # a version whose wrapper refuses C
                out[name] = graph[name] = f"ValueError: {e}"
                continue
            tree = _tree(K, P, C)
            if gini_tree:
                level = lambda: tk.tree_split_gini(       # noqa: E731
                    *a, tree=tree, offset=P - 1, **kw)
            else:
                def level():
                    feature, threshold, is_leaf, leaf, gain = tree
                    spl = tk.tree_split_gini(*a)
                    off = P - 1
                    leaf[:, off:off + P] = tot[..., 1:] / torch.clamp(
                        tot[..., :1], min=1e-12)
                    lf = spl["is_leaf"]
                    is_leaf[:, off:off + P] = lf
                    feature[:, off:off + P] = torch.where(lf, -1,
                                                          spl["feature"])
                    threshold[:, off:off + P] = spl["threshold"]
                    gain.scatter_add_(1, spl["feature"].long(),
                                      torch.where(lf, 0.0, spl["gain"]))
            graph[name + "_level"] = graph_ms(level, args.reps)
            if args.kernel_times:
                kms = chip_smoke.kernel_ms(level, args.reps)
                kernel[name + "_level"] = {
                    "split_ms": chip_smoke._device_ms(kms, "tree_split_gini"),
                    "all_ms": sum(kms.values()), "kernels": len(kms)}
            del hist, tot, mask, tree
            torch.cuda.empty_cache()
    if args.kernel in (None, "variance"):
        for name, K, P, nb in (
                ("tree_split_variance_level5_300_lanes", 300, 32, NB),
                ("tree_split_variance_level11_150_lanes", 150, 2048, NB),
                ("tree_split_variance_level5_60_lanes_64_bins", 60, 32, 64)):
            d, sub = 16, 5
            hist, tot, sp, mask = split_inputs(K, P, 0, sub, gen, d, nb,
                                               variance=True)
            ten, zero = (torch.full((K,), v, device="cuda")
                         for v in (10.0, 0.001))
            fm = torch.ones(d, dtype=torch.bool, device="cuda")
            a = (hist, tot, fm, mask, sp, ten, zero)
            kw = {"width": sub} if "width" in var_params else {}
            timed(name, lambda: tk.tree_split_variance(*a, **kw),
                  "tree_split_variance")
            tree = _tree(K, P, 1, d)
            if "tree" in var_params:
                level = lambda: tk.tree_split_variance(   # noqa: E731
                    *a, tree=tree, offset=P - 1, **kw)
            else:
                def level():
                    feature, threshold, is_leaf, leaf, gain = tree
                    spl = tk.tree_split_variance(*a)
                    off = P - 1
                    leaf[:, off:off + P] = tot[..., 1:2] / torch.clamp(
                        tot[..., 0:1], min=1e-12)
                    lf = spl["is_leaf"]
                    is_leaf[:, off:off + P] = lf
                    feature[:, off:off + P] = torch.where(lf, -1,
                                                          spl["feature"])
                    threshold[:, off:off + P] = spl["threshold"]
                    gain.scatter_add_(1, spl["feature"].long(),
                                      torch.where(lf, 0.0, spl["gain"]))
            graph[name + "_level"] = graph_ms(level, args.reps)
            if args.kernel_times:
                kms = chip_smoke.kernel_ms(level, args.reps)
                kernel[name + "_level"] = {
                    "split_ms": chip_smoke._device_ms(
                        kms, "tree_split_variance"),
                    "all_ms": sum(kms.values()), "kernels": len(kms)}
            del hist, tot, mask, tree
            torch.cuda.empty_cache()
    walls = []
    if args.train_reps:
        chip_smoke.run_main_path("cuda", args.rows)         # warm-up
        walls = [chip_smoke.run_main_path("cuda", args.rows)["train_wall_s"]
                 for _ in range(args.train_reps)]
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(),
                      "root": args.root, "ms": out, "graph_ms": graph,
                      "kernel_ms": kernel,
                      "rows": args.rows, "bench_set_train_wall_s": walls}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
