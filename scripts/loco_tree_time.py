#!/usr/bin/env python3
"""Time ``loco_tree`` on one NVIDIA card at the shapes the explanation path
launches it: the default grid's winner (a GBT; ``BinaryClassificationModel
Selector()`` trained on ``chip_smoke.make_data``'s rows, one group a
feature) and the bench set's forest (20 trees of depth 6, fitted here on
the same checked vector), both at ``--rows`` x 28 with G = 28, top-20
(``RecordInsightsLOCO``'s default).  ``scripts/bench_loco.py`` explains a
logistic regression (``loco_linear``), so it has no shape here.

    python3 scripts/loco_tree_time.py [--root DIR] [--rows N] [--reps R]
        [--sweep]

Each shape is held to the twin first (``chip_smoke.check_loco_tree``: the
diffs within 1e-5 of the largest, the same bits on two launches, the bound
from the walks the function needs), then timed: ``ms`` by CUDA events over
``--reps`` calls and ``kernel_ms``, the device ms a call spends in the
kernel by the profiler (``chip_smoke.kernel_device_ms``).  ``--sweep`` (a
version whose ``insights_kernels`` has ``TREE_ROWS``) times each shape
again under other plans: 128 or 256 rows a block, the block's rows of X
staged or read in place.

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the data and the trains come from
this script's ``chip_smoke.py``), so that two versions can be compared on
one card: run each in its own process, in the order A B B A.  Prints one
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
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("loco_tree_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.models.trees import (OpRandomForestClassifier,
                                                      TreeEnsembleModel)
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    facts, model, batch = cs.run_default_grid("cuda", args.rows,
                                              with_model=True)
    sel = model.selected_model
    vec_f = sel.input_features[1]
    scored = apply_dag(batch.on("cuda"), model.fitted_dag[:-1])
    X = scored[vec_f.name].values.contiguous()
    label = batch[sel.input_features[0].name]
    rf = TreeEnsembleModel(fitted=OpRandomForestClassifier(
        num_trees=cs.N_TREES, max_depth=cs.RF_DEPTH,
        min_instances_per_node=10).fit_arrays(
            X, np.asarray(label.values, np.float32)))
    G = X.shape[1]
    cg = torch.arange(G, device="cuda", dtype=torch.int32)
    out = {"card": cs.nvidia_smi_line(), "root": args.root, "rows": args.rows,
           "winner": facts["best_model"], "shapes": []}
    for name, m in (("default_grid_winner", sel.best_model), ("rf", rf)):
        f = m.fitted
        r = cs.check_loco_tree(X, m, cg, G, reps=args.reps)
        r.update(shape=name, kind=f["kind"], trees=int(f["feature"].shape[0]),
                 depth=int(f["max_depth"]),
                 kernel_ms=cs.kernel_device_ms(
                     lambda: ik.loco_tree(X, m, cg, G, cs.LOCO_K), args.reps,
                     "loco_tree"))
        out["shapes"].append(r)
        print(json.dumps(r), flush=True)
    if args.sweep and hasattr(ik, "TREE_ROWS"):
        keep = (ik.TREE_ROWS, ik.TREE_X_SMEM)
        out["sweep"] = []
        for rows, x_smem in ((128, 0), (128, 32 * 1024), (256, 0),
                             (256, 64 * 1024)):
            ik.TREE_ROWS, ik.TREE_X_SMEM = rows, x_smem
            for name, m in (("default_grid_winner", sel.best_model),
                            ("rf", rf)):
                r = {"shape": name, "rows": rows, "x_smem": x_smem,
                     "kernel_ms": cs.kernel_device_ms(
                         lambda: ik.loco_tree(X, m, cg, G, cs.LOCO_K),
                         args.reps, "loco_tree")}
                out["sweep"].append(r)
                print("sweep " + json.dumps(r), flush=True)
        ik.TREE_ROWS, ik.TREE_X_SMEM = keep
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
