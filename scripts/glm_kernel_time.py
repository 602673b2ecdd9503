#!/usr/bin/env python3
"""Time ``fista_glm`` on one NVIDIA card at the GLM workloads' shapes, and
the GLM trains, each kernel call held to its f64 twin (within 1e-5 of each
output's absolute mass) and to its own bits on a second launch
(``chip_smoke._glm_case``).

    python3 scripts/glm_kernel_time.py [--root DIR] [--reps R] [--rows N]
        [--trains T] [--no-faults]

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the inputs, checks and trains come
from this script's ``chip_smoke.py``), so that two versions can be compared
on one card: run each in its own process, in the order A B B A.  The cases,
for poisson and gamma on ``make_glm_data(rows)`` (16 columns, the
workload's 3 folds): the gradient form at 3 folds x 4 lanes (the CV block)
and the value form at 3 x 4 lanes x 8 trial steps (one backtracking
ladder, ``solvers.LADDER``); unless ``--no-faults``, the gradient form at
the fault widths (``rows`` x 4,900 poisson, 5,000 x 16,384 gamma, random
columns, 12 lanes).  ``ms`` are CUDA events over ``--reps`` calls after a
warm-up, ``kernel_ms`` the calls' kernels' device ms by the profiler.
Then each family's workload (``chip_smoke.run_glm``: GLM x4 and LinReg x8,
3-fold CV, the refit) is trained ``--trains`` times after a warm-up: the
train wall, the selector's CV and refit walls, the refit's ``n_iter`` and
halvings; and one ``torch.profiler`` window over the poisson GLM's CV
(``chip_smoke.profile_glm_cv``: the device-busy share, ``fista_glm``'s
device ms and calls by form, the ladder passes).  Prints one JSON line:
the card's name and power limit, the root and every number.
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
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trains", type=int, default=2)
    ap.add_argument("--no-faults", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("glm_kernel_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.models.solvers import (LADDER,
                                                        standardize_moments)
    from transmogrifai_tpu_torch.synthetic import make_glm_data
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    rng = np.random.default_rng(30)
    cases, trains = {}, {}
    for family in ("poisson", "gamma"):
        X, y = make_glm_data(args.rows, family)
        Xd = torch.as_tensor(X, device="cuda")
        yd = torch.as_tensor(y, device="cuda")
        W = torch.as_tensor(cs._fold_weights(y), device="cuda")
        mean, scale = standardize_moments(Xd, W, center=True)
        for form, G, grad in (("grad_12", 4, True),
                              ("value_96", 4 * LADDER, False)):
            cases[f"{family}_{form}"] = cs._glm_case(
                Xd, W, yd, mean, scale, family, G, rng, args.reps, grad)
        del Xd, yd, W
        torch.cuda.empty_cache()
    if not args.no_faults:
        for n, d, loss in ((args.rows, 4_900, "poisson"),
                           (5_000, 16_384, "gamma")):
            gen = torch.Generator(device="cuda").manual_seed(d)
            X = torch.randn((n, d), generator=gen, device="cuda")
            y = (rng.random(n) > 0.5).astype(np.float32)
            W = torch.as_tensor(cs._fold_weights(y), device="cuda")
            yg = torch.as_tensor((rng.poisson(1.3, n) if loss == "poisson"
                                  else rng.gamma(2.0, 0.7, n)).astype(
                                      np.float32), device="cuda")
            mean, scale = standardize_moments(X, W, center=True)
            cases[f"{loss}_grad_12_width_{d}"] = cs._glm_case(
                X, W, yg, mean, scale, loss, 4, rng, max(2, args.reps // 2),
                True)
            del X, W, yg, mean, scale
            torch.cuda.empty_cache()
    profile = None
    if args.trains:
        for family in ("poisson", "gamma"):
            facts, model, batch = cs.run_glm("cuda", args.rows, family,
                                             fresh=False)       # warm-up
            runs = []
            for _ in range(args.trains):
                del model, batch
                facts, model, batch = cs.run_glm("cuda", args.rows, family,
                                                 fresh=False)
                runs.append({k: facts[k] for k in (
                    "train_wall_s", "selector_seconds", "phase_seconds",
                    "refit_n_iter", "refit_halvings", "best_model",
                    "family_best_cv_rmse")})
            trains[family] = runs
            if family == "poisson":
                profile = cs.profile_glm_cv(model, batch, family)
            del model, batch
            torch.cuda.empty_cache()
    print(json.dumps({"card": cs.nvidia_smi_line(), "root": args.root,
                      "rows": args.rows, "cases": cases, "trains": trains,
                      "profile_glm_poisson_cv": profile}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
