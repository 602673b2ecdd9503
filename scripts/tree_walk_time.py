#!/usr/bin/env python3
"""Time ``tree_walk`` on one NVIDIA card at the shapes the main path
launches it.

    python3 scripts/tree_walk_time.py [--root DIR] [--rows N] [--reps R]
        [--sweep]

Shapes (random perfect-heap trees, ``chip_smoke._random_trees``, at the
bench matrix of ``--rows`` x 28): the GBT's 20 trees of depth 3 (sum,
V = 1), the bench forest's 20 trees of depth 6 (mean, V = 2), a depth-12
forest member of 50 trees (mean, V = 2), a depth-12 GBT's margin update
(12 lanes of one tree each) and the forest's CV panel (3 members x 20
trees of depth 6).  Each is held to the twin within 1e-6 and to its own
bits on a second launch, then timed beside its bound and the twin's time
(``chip_smoke.walk_case``); ``--kernel-times`` adds each kernel's device
ms a call (``chip_smoke.kernel_ms``: the events' time can be the host's).  ``--sweep`` (a tree whose ``tree_kernels``
has ``walk_plan``) times every shape again under other plans: threads a
block, and the top levels staged capped at 0, 3, 7, 15 or 63 nodes a
tree.

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in), so that two versions can be compared
on one card: run each in its own process, in the order A B B A.  Prints one
JSON line per shape and, last, one JSON object with the card's name and
power limit and every result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, trees, members, depth, classes (0: one value), op)
SHAPES = (("gbt 20 x d3", 20, 1, 3, 0, "sum"),
          ("rf 20 x d6", 20, 1, 6, 2, "mean"),
          ("rf member 50 x d12", 50, 1, 12, 2, "mean"),
          ("gbt margins 12 lanes x d12", 12, 12, 12, 0, "sum"),
          ("rf cv panel 3 x 20 x d6", 60, 3, 6, 2, "sum"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernel-times", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tree_walk_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    X, _ = cs.make_data(args.rows)
    X = torch.as_tensor(X, device="cuda")
    out = {"card": cs.nvidia_smi_line(), "root": args.root,
           "rows": args.rows, "shapes": []}
    trees = {s[0]: cs._random_trees("cuda", s[1], s[3], X.shape[1],
                                    classes=s[4]) for s in SHAPES}
    for name, _, members, depth, _, op in SHAPES:
        r = cs.walk_case(tk, X, trees[name], depth + 1, members, op,
                         reps=args.reps, plain_reps=2)
        r["shape"] = name
        if args.kernel_times:
            r["kernel_ms"] = cs.kernel_ms(lambda: tk.tree_walk(
                X, *trees[name], depth + 1, members, op), args.reps)
        if hasattr(tk, "walk_plan"):
            t = trees[name][0]
            r["plan"] = tk.walk_plan(args.rows, X.shape[1],
                                     t.shape[0] // members, t.shape[1],
                                     trees[name][3].shape[2], members)
        out["shapes"].append(r)
        print(json.dumps(r), flush=True)
    if args.sweep and hasattr(tk, "walk_plan"):
        keep = {k: getattr(tk, k) for k in ("WALK_THREADS", "WALK_TOP")}
        out["sweep"] = []
        for threads, top in itertools.product((128, 256), (0, 3, 7, 15, 63)):
            tk.WALK_THREADS, tk.WALK_TOP = threads, top
            for name, _, members, depth, _, op in SHAPES:
                r = cs.walk_case(tk, X, trees[name], depth + 1, members, op,
                                 reps=args.reps, plain_reps=0)
                r["kernel_ms"] = sum(cs.kernel_ms(lambda: tk.tree_walk(
                    X, *trees[name], depth + 1, members, op), 5).values())
                r.update(shape=name, threads=threads, top_cap=top)
                out["sweep"].append(r)
                print("sweep " + json.dumps(r), flush=True)
        for k, v in keep.items():
            setattr(tk, k, v)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
