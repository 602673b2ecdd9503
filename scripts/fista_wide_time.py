#!/usr/bin/env python3
"""Time the two FISTA gradient forms side by side on one NVIDIA card: the
tensor-core form (``csrc/fista_tc.cuh``, through ``fista_step`` and
``fista_softmax_step``, as their plans launch it) and the feature-chunked
two-pass form (``csrc/fista_wide.cu``, launched directly), on the same
inputs, over a range of lane counts.

    python3 scripts/fista_wide_time.py [--reps R]

The groups (3 folds, lane l reading fold l // ceil(L / 3)):

    fista_step logistic, 1,000,000 x 1,596 random columns (the
        transmogrified width), L = 4 .. 96 lanes;
    fista_softmax, 200,000 x 1,596, 4 classes, L = 1 .. 16 lanes;
    fista_step logistic, 1,000,000 x 800 and x 4,000, L = 6 .. 24.

Times are CUDA events over ``--reps`` launches after a warm-up
(``chip_smoke.time_ms``).  Each form is held to its f64 twin elsewhere
(``chip_smoke.py``, ``tests/test_torch_cuda.py``); here the two forms'
outputs are only compared with each other, within 1e-4 of the largest
|output|, as a guard that both ran the same function.  Prints the card's
name and power limit, then one JSON line a shape and a last JSON line
with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = ((1_000_000, 1596, 1, (4, 6, 8, 12, 16, 24, 32, 48, 64, 96)),
          (200_000, 1596, 4, (1, 2, 3, 4, 6, 8, 12, 16)),
          (1_000_000, 800, 1, (6, 8, 12, 16, 24)),
          (1_000_000, 4000, 1, (6, 8, 12, 16, 24)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fista_wide_time: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    print(cs.nvidia_smi_line(), flush=True)
    cuda_build.build_all(["fista_step", "fista_softmax", "fista_wide"])
    dev = "cuda"
    rng = np.random.default_rng(0)
    out = []
    for N, D, C, lane_counts in GROUPS:
        X = torch.randn((N, D), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        for L in lane_counts:
            G = -(-L // 3)
            W = torch.as_tensor((rng.random((-(-L // G), N)) > 1 / 3)
                                .astype(np.float32), device=dev)
            shape = (L, C, D) if C > 1 else (L, D)
            V = torch.as_tensor(rng.normal(scale=0.3 / np.sqrt(D), size=shape)
                                .astype(np.float32), device=dev)
            muv = torch.zeros(shape[:-1], device=dev)
            b = torch.zeros(shape[:-1], device=dev)
            ws = W.sum(dim=1)[torch.arange(L, device=dev) // G]
            if C > 1:
                y = torch.as_tensor(rng.integers(0, C, N).astype(np.int32),
                                    device=dev)
                plan = lk.softmax_launch_plan(D, L, C)
                tc = lambda: lk.fista_softmax_step(  # noqa: E731
                    X, V, muv, b, W, y, ws, G)
                loss = "softmax"
            else:
                y = torch.as_tensor((rng.random(N) > 0.5).astype(np.float32),
                                    device=dev)
                plan = lk.launch_plan(D, L)
                tc = lambda: lk.fista_step(  # noqa: E731
                    X, V, muv, b, W, y, ws, G, "logistic")
                loss = "logistic"
            wp = lk.wide_plan(D, L, C)
            two = lambda: lk.wide_outputs(lk._wide_run(  # noqa: E731
                X, V, muv, b, W, y, ws, G, C, loss, wp), D, L, C)[:2]
            for a, c in zip(tc(), two()):
                gap = float((a - c).abs().max())
                if gap > 1e-4 * float(a.abs().max()):
                    raise AssertionError(f"N={N} D={D} C={C} L={L}: the two "
                                         f"forms differ by {gap}")
            r = {"N": N, "D": D, "C": C, "L": L, "cols": L * C,
                 "plan": plan["form"], "tc_ms": cs.time_ms(tc, args.reps),
                 "two_pass_ms": cs.time_ms(two, args.reps)}
            print(json.dumps(r), flush=True)
            out.append(r)
        del X
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.nvidia_smi_line(), "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
