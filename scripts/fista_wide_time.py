#!/usr/bin/env python3
"""Time ``fista_step`` at the transmogrified width on one NVIDIA card: the
selector's CV block (3 folds x 2 logistic lanes), the refit's one lane and
the power iteration's 3 "gram" lanes, on a random [rows, features] f32
matrix with 3-fold weights.

    python3 scripts/fista_wide_time.py [--root DIR] [--rows N]
        [--features D] [--reps R]

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in), so that two versions can be compared
on one card: run each in its own process, in the order A B B A.  Times are
CUDA events over ``--reps`` launches after a warm-up.  Prints one JSON line:
the card's name and power limit, the root and each shape's ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--features", type=int, default=1596)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fista_wide_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from transmogrifai_tpu_torch.models import linear_kernels as lk

    n, d = args.rows, args.features
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((n, d), generator=g, device="cuda")
    y = (torch.rand(n, generator=g, device="cuda") > 0.5).float()
    fold = torch.randint(0, 3, (n,), generator=g, device="cuda")
    W3 = (fold[None, :] != torch.arange(3, device="cuda")[:, None]).float()
    out = {}
    for name, W, G, loss in (("cv_logistic_6", W3, 2, "logistic"),
                             ("refit_logistic_1", torch.ones_like(W3[:1]), 1,
                              "logistic"),
                             ("gram_3", W3, 1, "gram")):
        L = W.shape[0] * G
        V = torch.randn((L, d), generator=g, device="cuda") * 0.01
        args_ = (X, V, torch.zeros(L, device="cuda"),
                 torch.zeros(L, device="cuda"), W,
                 None if loss == "gram" else y,
                 W.sum(dim=1)[torch.arange(L, device="cuda") // G], G, loss)
        lk.fista_step(*args_)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            lk.fista_step(*args_)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / args.reps
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "root": args.root, "rows": n,
                      "features": d, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
