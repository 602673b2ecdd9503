#!/usr/bin/env python3
"""Time ``tree_hist`` on one NVIDIA card at the levels the main path
launches it, and profile the default grid's forest cross-validation.

    python3 scripts/tree_hist_time.py [--root DIR] [--rows N] [--reps R]
        [--lanes 60,300] [--profile] [--walls]

Shapes (``chip_smoke.forest_level_inputs``, ``chip_smoke.kernel_inputs``):
a forest level of each ``--lanes`` count at P = 1, 4, 16 and 32 nodes with
the nodes' 5-of-28 feature subsets (what the forest's fit passes), level 5
once more with every feature, and the GBT level (3 lanes, P = 4).  Each
shape is held to the f64 twin lane by lane, then timed beside its bound,
the twin's time and ``index_put_``'s (``chip_smoke.hist_case``).
``--profile`` trains the default grid at ``--rows`` once and runs a
``torch.profiler`` window over its forest candidates' cross-validation on
the model's own vector (``chip_smoke.profile_lr_cv``: device-busy share,
top kernels).  ``--walls`` times one more train of the default grid, the
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
    record("gbt level", cs.hist_case(tk, g["B"], g["row_node"], g["stats"],
                                     g["offset"], g["P"], reps=20))
    del g
    torch.cuda.empty_cache()
    for lanes in (int(v) for v in args.lanes.split(",")):
        for level in (int(v) for v in args.levels.split(",")):
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
    if args.profile or args.walls:
        from transmogrifai_tpu_torch import selector as S
        facts, model, batch = cs.run_default_grid("cuda", args.rows,
                                                  with_model=True)
        out["default_grid_warmup"] = {
            k: facts[k] for k in ("train_wall_s", "selector_seconds")}
        if args.profile:
            out["profile_rf_cv"] = cs.profile_lr_cv(
                model, batch, S.BinaryClassificationModelSelector(
                    models=[S._rf_classifier()]), top=10)
            print("profile_rf_cv: " + json.dumps(out["profile_rf_cv"]),
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
