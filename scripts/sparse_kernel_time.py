#!/usr/bin/env python3
"""Time the sparse products ``sp_matmat`` (X @ M, row order) and
``sp_rmatmat`` (X^T @ G, column order) on one NVIDIA card: on the sparse
workload's own 1,000,000 x 100,003 feature matrix (``bench.
run_text_sparse``'s text stage, built through its workflow by
``chip_smoke.sparse_matrix_of``) at k = 1, 3, 6 dense columns (scoring and
the refit, the column moments' 3 folds, the CV block's 6 lanes), and on
``chip_smoke.skewed_coo`` (a column holding every row, a row of 100,000
entries, empty rows and columns, duplicates) at k = 1, 6, 32.

    python3 scripts/sparse_kernel_time.py [--root DIR] [--reps R]
        [--rows N] [--walls] [--sweep]

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the inputs come from this script's
``chip_smoke.py``), so that two versions can be compared on one card: run
each in its own process, in the order A B B A.  Each case is first held to
its twin run in f64 (within 1e-5 of each output's absolute mass) and to
the same bits on two calls.  Times: ``ms``, CUDA events over ``--reps``
wrapper calls after a warm-up (the host's launch path included);
``graph_ms``, one replay of the call captured in a CUDA graph (no Python
between launches); ``device_ms``, the device time a call spends in all its
kernels by the profiler (memsets included), with ``kernels`` by name.
``--walls`` trains, evaluates and scores the workload at ``--rows`` and
profiles its LR cross-validation (device-busy share, the sparse kernels'
device ms and launches).  ``--sweep`` (a version with ``segment_plan``)
times other plans of the run's matrix at k = 6 and 1 by graph replay:
team sizes and tile costs.  Prints one JSON line:
the card's name and power limit, the root, the plans and the times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# both versions' kernel identifiers in a profile: this design's, the
# fixed-chunk scan's
SPARSE_IDS = ("segsum_kernel", "finish_kernel", "chunk_kernel",
              "carry_kernel")


def graph_ms(fn, reps: int) -> float:
    """Mean ms of one replay of ``fn`` captured in a CUDA graph."""
    import torch

    import chip_smoke
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return chip_smoke.time_ms(g.replay, reps)


def held(X, name: str, fn, dense) -> float:
    """``fn(X, dense)`` against the f64 twin and against a second call;
    returns the largest absolute error."""
    import torch

    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk
    twin, n = ((sk.sp_matmat_twin, X.n_rows) if name == "sp_matmat"
               else (sk.sp_rmatmat_twin, X.n_cols))
    got = fn(X, dense)
    if not torch.equal(got, fn(X, dense)):
        raise AssertionError(f"{name}: two calls differ")
    args = (X.values.double(), X.indices, X.row_ids)
    want = twin(*args, dense.double(), n)
    mass = twin(args[0].abs(), *args[1:], dense.double().abs(), n)
    e = (got.double() - want).abs()
    if bool((e > 1e-5 * mass + 1e-12).any()):
        raise AssertionError(f"{name} (k={dense.shape[1]}) disagrees with "
                             "its f64 twin")
    return float(e.max())


def case(X, k: int, reps: int, seed: int) -> dict:
    import torch

    import chip_smoke
    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk
    rng = np.random.default_rng(seed)
    out = {}
    for name, fn, rows in (("sp_matmat", sk.sp_matmat, X.n_cols),
                           ("sp_rmatmat", sk.sp_rmatmat, X.n_rows)):
        dense = torch.as_tensor(rng.normal(size=(rows, k)).astype(
            np.float32), device="cuda")
        err = held(X, name, fn, dense)
        run = (lambda f, d: lambda: f(X, d))(fn, dense)
        by = chip_smoke.kernel_ms(run, reps)
        out[name] = {"max_abs_err": err, "ms": chip_smoke.time_ms(run, reps),
                     "graph_ms": graph_ms(run, reps),
                     "device_ms": sum(by.values()),
                     "kernels": {chip_smoke._kernel_id(n): v
                                 for n, v in by.items()}}
    return out


def sweep(X, reps: int) -> list:
    """Other plans of ``X``'s two orders at k = 6 and 1 (team sizes, tile
    costs), by graph replay, each held to the f64 twin."""
    import torch

    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk
    rng = np.random.default_rng(5)
    rows = []
    for name, fn, n, attr, teams in (
            ("sp_matmat", sk.sp_matmat, X.n_cols, "_row_plan", (1, 2, 4)),
            ("sp_rmatmat", sk.sp_rmatmat, X.n_rows, "_col_plan",
             (8, 16, 32))):
        order = X.row_order() if attr == "_row_plan" else X.col_order()
        default = getattr(X, attr)
        for k in (6, 1):
            dense = torch.as_tensor(rng.normal(size=(n, k)).astype(
                np.float32), device="cuda")
            for team in teams:
                for cost in (1024, 2048, 4096):
                    setattr(X, attr, sk.segment_plan(order.ptr, team=team,
                                                     tile_cost=cost))
                    held(X, name, fn, dense)
                    rows.append({"name": name, "k": k, "team": team,
                                 "tile_cost": cost,
                                 "graph_ms": graph_ms(lambda: fn(X, dense),
                                                      reps)})
        setattr(X, attr, default)
    return rows


def walls(rows: int, cols, score_cols) -> dict:
    """The workload's train, CV, refit and score walls and a profiler
    window over its LR cross-validation."""
    import chip_smoke
    from transmogrifai_tpu_torch import selector as S
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    facts, model, batch = chip_smoke.run_sparse("cuda", rows, cols,
                                                score_cols)
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        OpLogisticRegression(),
        S.grid(reg_param=list(chip_smoke._sparse_ref().REG_PARAMS),
               max_iter=[50]), "OpLogisticRegression")])
    prof = chip_smoke.profile_lr_cv(model, batch, sel, kernels=SPARSE_IDS)
    by = prof.pop("by_kernel")
    prof["sparse_kernels"] = {
        ns: {"device_ms": sum(v["ms"] for k, v in by.items()
                              if f"{ns}::" in k),
             "launches": sum(v["count"] for k, v in by.items()
                             if f"{ns}::" in k)}
        for ns in ("sp_matmat", "sp_rmatmat", "spseg")}
    keep = ("width", "nnz", "train_auroc", "train_wall_s",
            "selector_seconds", "score_wall_s")
    return {"run": {k: facts[k] for k in keep if k in facts},
            "profile_cv": prof}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sparse_kernel_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    from transmogrifai_tpu_torch.synthetic import make_sparse_text_columns
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    cols, _ = make_sparse_text_columns(args.rows)
    X, _ = chip_smoke.sparse_matrix_of(cols)
    skew = SparseMatrix.from_coo(*chip_smoke.skewed_coo(), device="cuda")
    res = {"card": chip_smoke.nvidia_smi_line(),
           "root": os.path.abspath(args.root), "nnz": X.nnz,
           "skewed_nnz": skew.nnz}
    for k in (1, 3, 6):
        res[f"run k={k}"] = case(X, k, args.reps, 10 + k)
    for k in (1, 6, 32):
        res[f"skewed k={k}"] = case(skew, k, args.reps, 20 + k)
    if hasattr(X, "row_plan"):
        res["plans"] = {f"{m} {o}": getattr(Y, f"{o}_plan")().summary()
                        for m, Y in (("run", X), ("skewed", skew))
                        for o in ("row", "col")}
        if args.sweep:
            res["sweep"] = sweep(X, args.reps)
    del skew
    if args.walls:
        del X
        torch.cuda.empty_cache()
        score_cols, _ = make_sparse_text_columns(args.rows, seed=7)
        res["walls"] = walls(args.rows, cols, score_cols)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
