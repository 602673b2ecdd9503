#!/usr/bin/env python3
"""Time ``multiclass_confusion`` on one NVIDIA card at the CV panel's
shapes and at the shapes the multiclass train launches it.

    python3 scripts/confusion_time.py [--root DIR] [--rows N] [--reps R]
        [--no-train] [--sweep]

The CV panel: ``--rows`` x 24 candidates (3 folds x 8, candidate k reading
fold k // 8, ``chip_smoke.check_confusion_kernel``'s inputs) at
``chip_smoke.CONFUSION_CLASSES``.  The train (unless ``--no-train``): the multiclass default grid
(``chip_smoke.run_multiclass``) trained at ``--rows`` x 16 with every
``multiclass_confusion`` call recorded by (N, K candidates, G, C) and its
launches counted; each distinct shape is then timed on the train's own
arrays.  Each shape is first held to the twin (equal where the weights are
0 or 1, else within 1e-6 of the f64 sums), then timed: ``ms`` by CUDA
events over ``--reps`` calls, ``kernel_ms`` the device ms a call spends in
the kernel's own kernels by the profiler (``chip_smoke.kernel_device_ms``:
the thread or shared form's partials and the block reduction) and
``device_ms`` every kernel of the call.  ``--sweep`` (this checkout's
``metrics_kernels`` only) times the CV shapes and the train's again under
other grids: both forms at 1, 2, 3, 4, 8 or 16 blocks an SM (the thread
form no more than its shared memory holds).

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` is timed
(default: the one this script is in; the data, the train and the checks
come from this script's ``chip_smoke.py``), so that two versions can be
compared on one card: run each in its own process, in the order A B B A.
Prints one JSON line per shape and, last, one JSON object with the card's
name and power limit and every result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("confusion_thread_kernel", "confusion_partials_kernel",
         "confusion_reduce_kernel")


def _all_ms(cs, fn, reps: int) -> float:
    """Device ms a call spends in all its kernels (one profiler window)."""
    return sum(cs.kernel_ms(fn, reps).values())


def _case(cs, mk, y, P, Wm, G: int, C: int, reps: int) -> dict:
    import torch
    conf = mk.multiclass_confusion(y, P, Wm, G, C)
    if not torch.equal(conf, mk.multiclass_confusion(y, P, Wm, G, C)):
        raise AssertionError("multiclass_confusion: two launches differ")
    if bool(((Wm == 0) | (Wm == 1)).all()):
        if not torch.equal(conf, mk.multiclass_confusion_twin(y, P, Wm, G,
                                                              C)):
            raise AssertionError("multiclass_confusion differs from its "
                                 "twin on 0/1 weights")
    else:
        want = mk.multiclass_confusion_twin(y, P, Wm.double(), G, C)
        rel = float(((conf.double() - want).abs()
                     / want.abs().clamp(min=1.0)).max())
        if rel > 1e-6:
            raise AssertionError(f"multiclass_confusion: {rel} of the f64 "
                                 "sums")
    N, K = P.shape
    run = lambda: mk.multiclass_confusion(y, P, Wm, G, C)  # noqa: E731
    bt, by = cs.bound(4 * N * K + 4 * N + 4 * N * Wm.shape[0]
                      + 4 * K * C * C, 2 * N * K)
    # earlier versions plan from (K, C) or (K, C, N)
    full = (K, C, N, torch.cuda.get_device_properties(0).multi_processor_count)
    plan = mk.confusion_plan(*full[:mk.confusion_plan.__code__.co_argcount])
    return {"rows": N, "candidates": K, "G": G, "classes": C,
            "plan": plan._asdict(), "ms": cs.time_ms(run, reps),
            "kernel_ms": cs.kernel_device_ms(run, reps, *NAMES),
            "device_ms": _all_ms(cs, run, reps), "bound_ms": bt,
            "bound_by": by}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("confusion_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch import metrics_device as md
    from transmogrifai_tpu_torch import metrics_kernels as mk
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    out = {"card": cs.nvidia_smi_line(), "root": args.root, "rows": args.rows,
           "cv": [], "train": []}
    n = args.rows
    X, y = make_multiclass_data(n, cs.MC_FEATS)
    rng = np.random.default_rng(17)
    K, G = 3 * 8, 8
    cv = {}
    for C in cs.CONFUSION_CLASSES:
        yc = y if C == cs.MC_CLASSES else rng.integers(0, C, n).astype(
            np.float32)
        P = np.where(rng.random((n, K)) < 0.8, yc[:, None].astype(np.int32),
                     rng.integers(0, C, (n, K))).astype(np.int32)
        cv[C] = (torch.as_tensor(yc.astype(np.int32), device="cuda"),
                 torch.as_tensor(P, device="cuda"),
                 torch.as_tensor(1.0 - cs._fold_weights(yc), device="cuda"))
        r = {"shape": f"cv C={C}", **_case(cs, mk, *cv[C], G, C, args.reps)}
        out["cv"].append(r)
        print(json.dumps(r), flush=True)
    if not args.no_train:
        calls = []
        real = md.multiclass_confusion

        def recorded(yy, PP, WW, GG, CC):
            calls.append((yy, PP, WW, GG, CC))
            return real(yy, PP, WW, GG, CC)

        md.multiclass_confusion = recorded
        kernels.reset_launch_counts()
        try:
            facts, _, _ = cs.run_multiclass("cuda", X, y, "default")
        finally:
            md.multiclass_confusion = real
        launches = kernels.launch_counts()["multiclass_confusion"]
        shapes = {}
        for c in calls:
            key = (c[1].shape[0], c[1].shape[1], c[3], c[4])
            shapes.setdefault(key, [c, 0])[1] += 1
        out["train_launches"] = launches
        out["train_wall_s"] = facts["train_wall_s"]
        train = sorted(shapes.items())
        for (N, KK, GG, CC), (c, count) in train:
            r = {"shape": f"train N={N} K={KK} G={GG} C={CC}",
                 "calls": count, **_case(cs, mk, c[0], c[1], c[2], GG, CC,
                                         args.reps)}
            out["train"].append(r)
            print(json.dumps(r), flush=True)
        print(json.dumps({"train_launches": launches,
                          "train_wall_s": facts["train_wall_s"]}),
              flush=True)
    if args.sweep:
        keep = (mk.THREAD_BLOCKS_PER_SM, mk._SHARED_BLOCKS_PER_SM)
        out["sweep"] = []
        cases = {f"cv C={C}": (*cv[C], G, C) for C in cv}
        if not args.no_train:
            cases.update({f"train N={N} K={KK} G={GG} C={CC}": c
                          for (N, KK, GG, CC), (c, _) in train})
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for bps in (1, 2, 3, 4, 8, 16):
            mk.THREAD_BLOCKS_PER_SM = mk._SHARED_BLOCKS_PER_SM = bps
            for name, c in cases.items():
                plan = mk.confusion_plan(c[1].shape[1], c[4],
                                         c[1].shape[0], sms)
                run = (lambda c=c: mk.multiclass_confusion(*c))
                r = {"shape": name, "form": plan.form,
                     "blocks_per_sm": bps, "blocks": plan.blocks,
                     "kernel_ms": cs.kernel_device_ms(run, args.reps,
                                                      *NAMES)}
                out["sweep"].append(r)
                print("sweep " + json.dumps(r), flush=True)
        mk.THREAD_BLOCKS_PER_SM, mk._SHARED_BLOCKS_PER_SM = keep
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
