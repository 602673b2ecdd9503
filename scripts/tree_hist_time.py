#!/usr/bin/env python3
"""Time ``tree_hist`` and ``tree_hist_deep`` on one NVIDIA card at the
levels the main path launches them, and profile the default grid's forest
and GBT cross-validation.

    python3 scripts/tree_hist_time.py [--root DIR] [--rows N] [--reps R]
        [--lanes 60,300] [--levels 0,2,4,5] [--deep 8,9,10,11]
        [--deep-lanes 150,300] [--gbt-lanes 6,12] [--profile] [--walls]

Shapes (``chip_smoke.forest_level_inputs``, ``chip_smoke.kernel_inputs``):
a forest level of each ``--lanes`` count at P = 1, 4, 16 and 32 nodes with
the nodes' 5-of-28 feature subsets (what the forest's fit passes), level 5
once more with every feature, and the GBT level (3 lanes, P = 4); with
``--deep``, the deep levels (``tree_hist_deep``): a forest level of each
``--deep-lanes`` count at each ``--deep`` level with 5-of-28 subsets, and
the GBT's ``--gbt-lanes`` at the deepest of them with every feature
(``chip_smoke.gbt_level_inputs``).  An empty ``--lanes`` skips the
shallow forest levels.  Each shape is held to the f64 twin lane by lane,
then timed beside its bound, the twin's time and ``index_put_``'s
(``chip_smoke.hist_case``; a deep level that disagrees is timed all the
same and its line says so: the parent of a change may miss the rule);
``--kernel-times`` adds each kernel's device ms a call
(``chip_smoke.kernel_ms``), the GBT level's too.  A checkout whose
``tree_hist`` takes the fit's fixed-point scale (``hist_scale``) is timed
with it read once before, as ``fit_trees`` calls it.  ``--profile`` trains the default grid at
``--rows`` once and runs ``torch.profiler`` windows over its forest and
its GBT candidates' cross-validation on the model's own vector
(``chip_smoke.profile_lr_cv``: device-busy share, top kernels; the
forest window also every kernel of the gini split, ``by_kernel``).  ``--walls`` times one more train of the default grid, the
multiclass default grid and the regression default grid, each with its
per-family CV seconds.

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in), so that two versions can be compared
on one card: run each in its own process, in the order A B B A.  Prints one
JSON line per shape and, last, one JSON object with the card's name and
power limit and every result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lanes", default="60,300")
    ap.add_argument("--levels", default="0,2,4,5")
    ap.add_argument("--deep", default="")
    ap.add_argument("--deep-lanes", default="150,300")
    ap.add_argument("--gbt-lanes", default="6,12")
    ap.add_argument("--kernel-times", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--walls", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tree_hist_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    if args.profile or args.walls:   # the trains need every kernel
        from transmogrifai_tpu_torch import cuda_build
        cuda_build.build_all()
    out = {"card": cs.nvidia_smi_line(), "root": args.root,
           "rows": args.rows, "shapes": []}

    def record(tag, r):
        r["shape"] = tag
        out["shapes"].append(r)
        print(json.dumps(r), flush=True)

    g = cs.kernel_inputs("cuda", args.rows)
    r = cs.hist_case(tk, g["B"], g["row_node"], g["stats"], g["offset"],
                     g["P"], reps=20)
    if args.kernel_times:
        fit = ({"scale": tk.hist_scale(g["stats"])}
               if hasattr(tk, "hist_scale") else {})
        r["kernel_ms"] = cs.kernel_ms(lambda: tk.tree_hist(
            g["B"], g["row_node"], g["stats"], g["offset"], g["P"],
            cs.N_BINS, **fit), 20)
    record("gbt level", r)
    del g
    torch.cuda.empty_cache()
    ints = lambda v: [int(x) for x in v.split(",") if x]   # noqa: E731
    for lanes in ints(args.lanes):
        for level in ints(args.levels):
            inp = cs.forest_level_inputs("cuda", args.rows, lanes, level)
            args_ = (tk, inp["B"], inp["row_node"], inp["stats"],
                     inp["offset"], inp["P"])
            record(f"forest level {level}, {lanes} lanes, subsets",
                   cs.hist_case(*args_, node_mask=inp["mask"],
                                reps=args.reps))
            if level == 5:
                record(f"forest level 5, {lanes} lanes, all features",
                       cs.hist_case(*args_, reps=args.reps))
            del inp, args_
            torch.cuda.empty_cache()
    def deep_case(inp):
        args_ = (tk, inp["B"], inp["row_node"], inp["stats"], inp["offset"],
                 inp["P"], inp["mask"])
        try:
            r = cs.hist_case(*args_, args.reps)
        except AssertionError as e:   # timed all the same, and marked
            r = cs.hist_case(*args_, args.reps, check=False)
            r["disagrees_with_twin"] = str(e)
        if args.kernel_times:
            fit = ({"scale": tk.hist_scale(inp["stats"])}
                   if hasattr(tk, "hist_scale") else {})
            r["kernel_ms"] = cs.kernel_ms(lambda: tk.tree_hist(
                *args_[1:6], cs.N_BINS, node_mask=inp["mask"], **fit),
                args.reps)
        return r

    deep = ints(args.deep)
    data = cs.bench_binned("cuda", args.rows) if deep else None
    for lanes in ints(args.deep_lanes) if deep else ():
        for level in deep:
            inp = cs.forest_level_inputs("cuda", args.rows, lanes, level,
                                         data=data)
            record(f"forest level {level}, {lanes} lanes, subsets",
                   deep_case(inp))
            del inp
            torch.cuda.empty_cache()
    for lanes in ints(args.gbt_lanes) if deep else ():
        inp = cs.gbt_level_inputs("cuda", args.rows, lanes, max(deep),
                                  data=data)
        record(f"gbt level {max(deep)}, {lanes} lanes", deep_case(inp))
        del inp
        torch.cuda.empty_cache()
    del data
    if args.profile or args.walls:
        from transmogrifai_tpu_torch import selector as S
        facts, model, batch = cs.run_default_grid("cuda", args.rows,
                                                  with_model=True)
        out["default_grid_warmup"] = {
            k: facts[k] for k in ("train_wall_s", "selector_seconds")}
        if args.profile:
            out["profile_rf_cv"] = cs.profile_lr_cv(
                model, batch, S.BinaryClassificationModelSelector(
                    models=[S._rf_classifier()]), top=10,
                kernels=("tree_split_gini",))
            print("profile_rf_cv: " + json.dumps(out["profile_rf_cv"]),
                  flush=True)
            out["profile_gbt_cv"] = cs.profile_lr_cv(
                model, batch, S.BinaryClassificationModelSelector(
                    models=[S._gbt_classifier()]), top=10)
            print("profile_gbt_cv: " + json.dumps(out["profile_gbt_cv"]),
                  flush=True)
        del model, batch
        torch.cuda.empty_cache()
    if args.walls:
        r = cs.run_default_grid("cuda", args.rows)
        out["default_grid"] = {k: r[k] for k in ("train_wall_s",
                                                 "selector_seconds")}
        from transmogrifai_tpu_torch.synthetic import make_multiclass_data
        X, y = make_multiclass_data(args.rows, cs.MC_FEATS)
        for _ in range(2):          # the first is a warm-up
            r, _, _ = cs.run_multiclass("cuda", X, y, "default")
        out["multiclass"] = {k: r.get(k) for k in ("train_wall_s",
                                                   "selector_seconds")}
        del X, y
        for _ in range(2):
            r, _, _ = cs.run_regression("cuda", args.rows)
        out["regression"] = {k: r.get(k) for k in ("train_wall_s",
                                                   "selector_seconds")}
        print("walls: " + json.dumps({k: out[k] for k in (
            "default_grid", "multiclass", "regression")}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
