#!/usr/bin/env python3
"""Time ``tree_route`` on one NVIDIA card at the shapes the default grid
launches it.

    python3 scripts/tree_route_time.py [--root DIR] [--rows N] [--reps R]
        [--forest-lanes 150,300] [--forest-levels 5,11]
        [--gbt-lanes 6,12] [--gbt-levels 2,11] [--sweep]

Shapes (the bench matrix of ``--rows`` x 28, binned at 32 bins): a forest
batch of each ``--forest-lanes`` count at each ``--forest-levels`` level
(rows spread over the level, a fifth of its width parked at leaves above)
and the GBT's ``--gbt-lanes`` at each ``--gbt-levels`` level (three
quarters of each lane's rows in 8 nodes at the deep ones:
``chip_smoke.gbt_level_inputs``), each node's split drawn from a seeded
generator (a seventh of the nodes leaves), drawn in the order
``chip_smoke.check_route_split_levels`` draws them.  Each shape runs through
``chip_smoke.route_case``: the route on copies of the ids against the twin
(exact) and against itself, timed from a restored copy with a 64 MB
buffer written between (``ms``: CUDA events, restore and route less the
restore alone; ``kernel_ms``: the route kernel's device ms by the
profiler), beside its bound and the twin's time.  A version that routes
out of place (returns new ids) is timed the same way.  ``--sweep`` (a
version with ``route_plan``) times the forest shapes again under other
plans: B tiles of at most 8, 16, 32 or 48 KB a block and lane chunks of
at most 8 or 32 lanes (``ROUTE_SMEM``, ``ROUTE_LANES``).

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the inputs come from this script's
``chip_smoke.py``), so that two versions can be compared on one card: run
each in its own process, in the order A B B A.  Prints one JSON line per
shape and, last, one JSON object with the card's name and power limit
and every result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--forest-lanes", default="150,300")
    ap.add_argument("--forest-levels", default="5,11")
    ap.add_argument("--gbt-lanes", default="6,12")
    ap.add_argument("--gbt-levels", default="2,11")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tree_route_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    ints = lambda v: [int(x) for x in v.split(",") if x]   # noqa: E731
    data = cs.bench_binned("cuda", args.rows)
    B = data[2]
    D = B.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {"card": cs.nvidia_smi_line(), "root": args.root,
           "rows": args.rows, "shapes": []}
    cases = ([("forest", k, lvl) for k in ints(args.forest_lanes)
              for lvl in ints(args.forest_levels)]
             + [("gbt", k, lvl) for k in ints(args.gbt_lanes)
                for lvl in ints(args.gbt_levels)])
    for kind, lanes, level in cases:
        off, P = (1 << level) - 1, 1 << level
        if kind == "forest":
            row_node = torch.randint(max(0, off - max(1, P // 5)), off + P,
                                     (lanes, args.rows), generator=gen,
                                     device="cuda", dtype=torch.int32)
        else:
            row_node = cs.gbt_level_inputs("cuda", args.rows, lanes, level,
                                           data=data)["row_node"]
        feat = torch.randint(0, D, (lanes, P), generator=gen, device="cuda",
                             dtype=torch.int32)
        bin_ = torch.randint(0, cs.N_BINS - 1, (lanes, P), generator=gen,
                             device="cuda", dtype=torch.int32)
        leaf = torch.rand((lanes, P), generator=gen, device="cuda") < 1 / 7
        r = cs.route_case(tk, B, row_node, feat, bin_, leaf, off, args.reps)
        r["shape"] = f"{kind} level {level}, {lanes} lanes"
        out["shapes"].append(r)
        print(json.dumps(r), flush=True)
        if args.sweep and kind == "forest" and hasattr(tk, "route_plan"):
            keep = (tk.ROUTE_SMEM, tk.ROUTE_LANES)
            for smem, chunk in itertools.product((8, 16, 32, 48), (8, 32)):
                tk.ROUTE_SMEM, tk.ROUTE_LANES = smem * 1024, chunk
                work = row_node.clone()

                def run():
                    work.copy_(row_node)
                    tk.tree_route(B, work, feat, bin_, leaf, off)
                w = {"shape": r["shape"], "smem_kb": smem, "lanes": chunk,
                     "plan": tk.route_plan(args.rows, D, lanes),
                     "kernel_ms": cs._device_ms(cs.kernel_ms(run, 5),
                                                "tree_route")}
                out.setdefault("sweep", []).append(w)
                print("sweep " + json.dumps(w), flush=True)
            tk.ROUTE_SMEM, tk.ROUTE_LANES = keep
        del row_node, feat, bin_, leaf
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
