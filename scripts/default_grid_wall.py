#!/usr/bin/env python3
"""Train wall of the default binary model grid —
``BinaryClassificationModelSelector()`` with no ``models=`` (LR x8, RF x18,
GBT x18, LinearSVC x4) — on the dense workload of ``chip_smoke.py`` at
1,000,000 x 28 on one NVIDIA card.

    python3 scripts/default_grid_wall.py [--root DIR] [--rows N] [--reps R]

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in), so that two versions can be compared
on one card: run each in its own process, in the order A B B A.  The first
train is a warm-up (kernel builds, allocator); each of the next ``--reps``
prints its train wall and per-family CV seconds.  The last line is one JSON
object: the card's name and power limit, the walls and the peak device
memory.
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
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("default_grid_wall: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    chip_smoke.run_default_grid("cuda", args.rows)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.reps):
        r = chip_smoke.run_default_grid("cuda", args.rows)
        walls.append(r["train_wall_s"])
        print(json.dumps({k: r[k] for k in ("train_wall_s", "best_model",
                                            "selector_seconds")}),
              flush=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(),
                      "root": args.root, "rows": args.rows,
                      "train_wall_s": walls,
                      "peak_device_memory_gb":
                          torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
