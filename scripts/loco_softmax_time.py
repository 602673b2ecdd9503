#!/usr/bin/env python3
"""Time ``loco_softmax`` on one NVIDIA card at the shapes the explanation
path and ``chip_smoke.py`` launch it.

    python3 scripts/loco_softmax_time.py [--root DIR] [--rows N] [--reps R]
        [--only NAMES] [--widths D,...] [--sweep]

Shapes (one group a column unless named): the multiclass winner (a 4-class
softmax logistic regression fitted on ``--rows`` x 16 rows of
``make_multiclass_data``, G = 16, top-16), naive Bayes and the 16-10-4 MLP
fitted there, a 40-class softmax LR with random coefficients (sd 0.5) on
the same rows, ``scripts/bench_loco.py``'s 100,000 x 512 with 128 groups of
4 columns at top-20 and top-40 (a 4-class LR fitted there, 20 iterations),
and MLPs of random weights past the row form: ``hidden_layers=(256, 256)``
and (900,) at 100,000 x 16 (top-16), (2048,) at 1,000 x 16 (top-5).
``--only`` takes a comma-separated subset of the names; ``--widths
32,64,...`` adds a random 4-class LR at 100,000 x D for each D, groups of
4 scattered columns, top-20.

Each shape is held to the twin first (``chip_smoke.check_loco_softmax``:
each listed diff within 1e-5 of the largest |diff| of the twin's diff of
that group, the ranks likewise, no group twice, the same bits on two
launches), then timed: ``ms`` by CUDA events over ``--reps`` calls,
``kernel_ms`` the device ms a call spends in ``loco_softmax``'s kernels by
the profiler (``chip_smoke.kernel_device_ms``) and ``device_ms`` in every
kernel of the call (the parent's index conversion too).  ``--sweep`` (a
version whose ``insights_kernels`` has ``ROW_WIDTH_MAX``) times each shape
again under the other form: the row form switched off (the warp form), and
the row form at 32 and 64 rows a block.

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the data and the models come from
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
NAMES = ("loco_softmax_kernel", "loco_softmax_rows_kernel")
SHAPES = ("winner", "naive_bayes", "mlp", "classes_40", "bench_loco_k20",
          "bench_loco_k40", "mlp_256_256", "mlp_900", "mlp_2048")


def _mlp(rng, sizes, device):
    import torch

    from transmogrifai_tpu_torch.models.linear import MLPClassificationModel
    fitted = {"kind": "mlp", "n_layers": len(sizes) - 1,
              "n_classes": sizes[-1]}
    for i in range(len(sizes) - 1):
        fitted[f"W{i}"] = torch.as_tensor(rng.normal(
            scale=(2.0 / sizes[i]) ** 0.5, size=(sizes[i], sizes[i + 1]))
            .astype("float32"), device=device)
        fitted[f"b{i}"] = torch.as_tensor(rng.normal(
            scale=0.1, size=sizes[i + 1]).astype("float32"), device=device)
    return MLPClassificationModel(fitted=fitted)


def _cases(cs, rows: int, only):
    """(name, X, model, col_group, G, k) for each shape, built lazily."""
    import numpy as np
    import torch

    from transmogrifai_tpu_torch.models.linear import (
        LinearPredictionModel, OpLogisticRegression,
        OpMultilayerPerceptronClassifier, OpNaiveBayes)
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    dev = "cuda"
    rng = np.random.default_rng(31)
    X, y = make_multiclass_data(rows, cs.MC_FEATS)
    Xd = torch.as_tensor(X, device=dev)
    D = Xd.shape[1]
    cg = torch.arange(D, device=dev, dtype=torch.int32)
    fits = {"winner": OpLogisticRegression, "naive_bayes": OpNaiveBayes,
            "mlp": OpMultilayerPerceptronClassifier}
    for name, est in fits.items():
        if name in only:
            e = est()
            m = e.model_cls(fitted=e.fit_arrays(Xd, y, device=dev))
            yield name, Xd, m, cg, D, D
    if "classes_40" in only:
        yield "classes_40", Xd, LinearPredictionModel(fitted={
            "kind": "multinomial", "n_classes": 40,
            "coef": torch.as_tensor(rng.normal(scale=0.5, size=(D, 40))
                                    .astype(np.float32), device=dev),
            "intercept": torch.as_tensor(rng.normal(size=40).astype(
                np.float32), device=dev)}), cg, D, D
    n, d, g = cs.BENCH_LOCO
    if only & {"bench_loco_k20", "bench_loco_k40"}:
        Xb = rng.normal(size=(n, d)).astype(np.float32)
        yb = np.argmax(Xb @ rng.normal(size=(d, cs.MC_CLASSES)),
                       axis=1).astype(np.float32)
        lr = LinearPredictionModel(fitted=OpLogisticRegression(
            max_iter=20).fit_arrays(Xb, yb, device=dev))
        Xb = torch.as_tensor(Xb, device=dev)
        cg_b = torch.arange(d, device=dev, dtype=torch.int32) // (d // g)
        for k in (20, 40):
            if f"bench_loco_k{k}" in only:
                yield f"bench_loco_k{k}", Xb, lr, cg_b, g, k
        del Xb
    for name, hidden, nr, k in (("mlp_256_256", (256, 256), 100_000, 16),
                                ("mlp_900", (900,), 100_000, 16),
                                ("mlp_2048", (2048,), 1_000, 5)):
        if name in only:
            Xm = Xd[:nr].contiguous()
            yield name, Xm, _mlp(rng, [D, *hidden, cs.MC_CLASSES], dev), \
                cg, D, k


def _width_cases(widths):
    """A 4-class softmax LR of random coefficients (sd 2 / sqrt(D)) at
    100,000 x D, groups of 4 columns (scattered), top-20: the row form's
    cost against the warp form's as the row widens."""
    import numpy as np
    import torch

    from transmogrifai_tpu_torch.models.linear import LinearPredictionModel
    rng = np.random.default_rng(41)
    for D in widths:
        X = torch.as_tensor(rng.normal(size=(100_000, D)).astype(np.float32),
                            device="cuda")
        G = max(1, D // 4)
        cg = torch.as_tensor(rng.permutation(np.arange(D) % G).astype(
            np.int32), device="cuda")
        m = LinearPredictionModel(fitted={
            "kind": "multinomial", "n_classes": 4,
            "coef": torch.as_tensor(rng.normal(scale=2.0 / D ** 0.5,
                                               size=(D, 4)).astype(
                np.float32), device="cuda"),
            "intercept": torch.as_tensor(rng.normal(size=4).astype(
                np.float32), device="cuda")})
        yield f"lr_d{D}", X, m, cg, G, min(20, G)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", default=",".join(SHAPES))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--widths", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("loco_softmax_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch import insights_kernels as ik
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    out = {"card": cs.nvidia_smi_line(), "root": args.root, "rows": args.rows,
           "shapes": []}
    only = set(args.only.split(","))
    sweep = args.sweep and hasattr(ik, "ROW_WIDTH_MAX")
    widths = [int(w) for w in args.widths.split(",") if w]
    for name, X, m, cg, G, k in list(_cases(cs, args.rows, only)) + list(
            _width_cases(widths)):
        run = (lambda: ik.loco_softmax(X, m, cg, G, k))
        r = {"shape": name, **cs.check_loco_softmax(X, m, cg, G, k,
                                                     reps=args.reps)}
        r["kernel_ms"] = cs.kernel_device_ms(run, args.reps, *NAMES)
        r["device_ms"] = sum(cs.kernel_ms(run, args.reps).values())
        if sweep:
            keep = (ik.ROW_WIDTH_MAX, ik.ROW_ROWS)
            r["sweep"] = {}
            for label, width, rows in (("warps", 0, keep[1]),
                                       ("rows_64", keep[0], (64, 32)),
                                       ("rows_32", keep[0], (32,))):
                ik.ROW_WIDTH_MAX, ik.ROW_ROWS = width, rows
                r["sweep"][label] = cs.kernel_device_ms(run, args.reps,
                                                        *NAMES)
            ik.ROW_WIDTH_MAX, ik.ROW_ROWS = keep
        out["shapes"].append(r)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
