#!/usr/bin/env python3
"""Time ``fista_step`` and ``fista_softmax`` on one NVIDIA card at the
shapes of the linear families' main paths, each checked against its f64
twin (within 1e-5 of each output's absolute mass) and for the same bits on
two launches, beside the cuBLAS pair that computes the same function.

    python3 scripts/fista_tc_time.py [--root DIR] [--cases a,b,...]
        [--reps R] [--profile] [--sweep]

``--root`` is a checkout whose ``transmogrifai_tpu_torch`` and
``chip_smoke.py`` are used (default: the one this script is in), so that
two versions can be compared on one card: run each in its own process, in
the order A B B A.  The cases (1,000,000 rows unless named):

    step_wide_cv6     fista_step, 1,596 random columns, 3 folds x 2 logistic
                      lanes (the transmog selector's CV block)
    step_wide_screen8 the same X, fold 0 x 8 logistic lanes (the default
                      selector's fold-0 screen)
    step_wide_24      the same X, 3 folds x 8 squared lanes (racing off)
    step_narrow_24    fista_step on make_data's 28 columns, 3 folds x 8
                      logistic lanes (racing off)
    sm_screen         fista_softmax on the multiclass data's 16 columns,
                      fold 0 x 8 lanes of 4 classes
    sm_cv24           the same X, 3 folds x 8 lanes of 4 classes
    sm_40             the same X, fold 0 x 8 lanes of 40 classes
    sm_wide           fista_softmax, 200,000 x 1,596 random columns, 3
                      folds x 2 lanes of 4 classes

Times are CUDA events over ``--reps`` launches after a warm-up
(``chip_smoke.time_ms``).  ``--profile`` adds each case's device time by
kernel name over three calls (``torch.profiler``), so the wrapper's host
time shows beside the kernels'.  ``--sweep`` times the wide cases again
under other launch plans of ``csrc/fista_tc.cuh`` (cluster size, rows a
tile, stages), each held to the default plan's result within 1e-5 of its
absolute mass.  Prints one JSON line: the card's name and power limit, the
root and each case's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("step_wide_cv6", "step_wide_screen8", "step_wide_24",
         "step_narrow_24", "sm_screen", "sm_cv24", "sm_40", "sm_wide")


def _step_args(X, W, y, mean, scale, loss, G):
    """``fista_step``'s arguments for F x G lanes with fixed coefficients."""
    import torch

    from transmogrifai_tpu_torch.models.solvers import loss_target
    L = W.shape[0] * G
    lanes = torch.arange(L, device=X.device) // G
    g = torch.Generator(device=X.device).manual_seed(7)
    sd = 0.3 * min(1.0, (28 / X.shape[1]) ** 0.5)
    V = (torch.randn((L, X.shape[1]), generator=g, device=X.device) * sd
         / scale[lanes]).contiguous()
    b = torch.zeros(L, device=X.device)
    return (X, V, (mean[lanes] * V).sum(dim=1), b, W, loss_target(loss, y),
            W.sum(dim=1)[lanes], G, loss)


def _step(X, W, y, mean, scale, loss, G):
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    return lk.fista_step(*_step_args(X, W, y, mean, scale, loss, G))


def _profile(fn) -> dict:
    """Device ms a call by kernel name over three calls, and the calls'
    host wall (ms a call)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name[:60]] = by.get(e.name[:60], 0.0) + \
                e.time_range.elapsed_us() / 3e3
    return {"wall_ms": wall, "device_ms": by}


def _sweep(X, W, y, mean, scale, loss, G, reps) -> dict:
    """``fista_step`` under other plans (CS, TR, S), each held to the
    default plan's result within 1e-5 of its absolute mass."""
    import torch

    import chip_smoke as cs
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    a = _step_args(X, W, y, mean, scale, loss, G)
    Xd, V, muv, b, Wd, yd, ws = a[:7]
    L, D = V.shape
    ref = lk._tc_run("fista_step", Xd, V, muv, b, Wd, yd, ws, G, 1,
                     lk.LOSSES[loss], lk.launch_plan(D, L))
    mass = None
    out = {}
    for CS, TR, S in ((2, 16, 2), (4, 16, 1), (4, 16, 2), (4, 32, 2),
                      (8, 16, 2), (8, 32, 2), (8, 64, 2)):
        DS = -(-(-(-D // CS)) // 8) * 8
        lay = lk._tc_layout(TR, CS, DS, S, -(-L // 8) * 8, 1, 1)
        if lay["smem"] > lk._SMEM_MAX:
            continue
        plan = lk._tc_plan_dict(L, -(-L // 8) * 8, TR, CS, DS, S, 1, 1, lay)

        def run():
            return lk._tc_run("fista_step", Xd, V, muv, b, Wd, yd, ws, G, 1,
                              lk.LOSSES[loss], plan)
        got = run()
        if mass is None:
            g64 = lk.fista_row_grads(Xd[:200_000].double(), V.double(),
                                     muv.double(), b.double(),
                                     Wd[:, :200_000].double(),
                                     yd[:200_000].double(), ws.double(), G,
                                     loss)
            mass = float((g64.abs() @ Xd[:200_000].abs().double()).max()) * 5
        err = float((got - ref).abs().max())
        out[f"CS{CS}_TR{TR}_S{S}"] = {"ms": cs.time_ms(run, reps),
                                      "smem": lay["smem"],
                                      "max_diff_to_default": err,
                                      "within": err <= 1e-5 * mass}
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fista_tc_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from transmogrifai_tpu_torch.models.solvers import standardize_moments
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data

    cases = args.cases.split(",")
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        raise SystemExit(f"fista_tc_time: unknown cases {unknown}")
    n, reps, dev = cs.N_ROWS, args.reps, "cuda"
    rng = np.random.default_rng(31)
    out = {}
    _, yb = cs.make_data(n)
    W = torch.as_tensor(cs._fold_weights(yb), device=dev)
    yd = torch.as_tensor(yb, device=dev)
    if any(c.startswith("step_wide") for c in cases):
        gen = torch.Generator(device=dev).manual_seed(31)
        Xw = torch.randn((n, cs.TRANSMOG_WIDTH), generator=gen, device=dev)
        mean, scale = standardize_moments(Xw, W, center=True)
        for name, Wc, loss, G in (("step_wide_cv6", W, "logistic", 2),
                                  ("step_wide_screen8", W[:1], "logistic", 8),
                                  ("step_wide_24", W, "squared", 8)):
            if name in cases:
                m, s = (mean, scale) if Wc.shape[0] == 3 else (mean[:1],
                                                               scale[:1])
                out[name] = cs._fista_case(Xw, Wc, yd, m, s, loss, G, rng,
                                           reps)
                if args.profile:
                    out[name]["profile"] = _profile(
                        lambda: _step(Xw, Wc, yd, m, s, loss, G))
                if args.sweep and name != "step_wide_screen8":
                    out[name]["sweep"] = _sweep(Xw, Wc, yd, m, s, loss, G,
                                                reps)
        del Xw, mean, scale
        torch.cuda.empty_cache()
    if "step_narrow_24" in cases:
        X, _ = cs.make_data(n)
        Xd = torch.as_tensor(X, device=dev)
        mean, scale = standardize_moments(Xd, W, center=True)
        out["step_narrow_24"] = cs._fista_case(Xd, W, yd, mean, scale,
                                               "logistic", 8, rng, reps)
        if args.profile:
            out["step_narrow_24"]["profile"] = _profile(
                lambda: _step(Xd, W, yd, mean, scale, "logistic", 8))
        del Xd
    if any(c.startswith("sm_") for c in cases):
        X, y = make_multiclass_data(n, cs.MC_FEATS)
        Wm = torch.as_tensor(cs._fold_weights(y), device=dev)
        Xd = torch.as_tensor(X, device=dev)
        yi = torch.as_tensor(y, device=dev).to(torch.int32)
        mean, scale = standardize_moments(Xd, Wm, center=True)
        if "sm_screen" in cases:
            out["sm_screen"] = cs._softmax_case(
                Xd, Wm[:1], yi, mean[:1], scale[:1], 8, cs.MC_CLASSES, rng,
                reps)
        if "sm_cv24" in cases:
            out["sm_cv24"] = cs._softmax_case(Xd, Wm, yi, mean, scale, 8,
                                              cs.MC_CLASSES, rng, reps)
            if args.profile:
                from transmogrifai_tpu_torch.models import linear_kernels
                L = 24
                V = torch.randn((L, 4, Xd.shape[1]), device=dev) * 0.1
                z = torch.zeros((L, 4), device=dev)
                ws = Wm.sum(dim=1)[torch.arange(L, device=dev) // 8]
                out["sm_cv24"]["profile"] = _profile(
                    lambda: linear_kernels.fista_softmax_step(
                        Xd, V, z, z, Wm, yi, ws, 8))
        if "sm_40" in cases:
            y40 = torch.as_tensor(rng.integers(0, 40, n).astype(np.int32),
                                  device=dev)
            out["sm_40"] = cs._softmax_case(Xd, Wm[:1], y40, mean[:1],
                                            scale[:1], 8, 40, rng, reps)
        del Xd
        if "sm_wide" in cases:
            wn, wd = cs.MC_WIDE
            gen = torch.Generator(device=dev).manual_seed(32)
            Xw = torch.randn((wn, wd), generator=gen, device=dev)
            Ww = torch.as_tensor(cs._fold_weights(y[:wn]), device=dev)
            mean, scale = standardize_moments(Xw, Ww, center=True)
            out["sm_wide"] = cs._softmax_case(Xw, Ww, yi[:wn], mean, scale,
                                              2, cs.MC_CLASSES, rng, reps)
    for r in out.values():
        r["ratio_to_library"] = r["ms"] / r["library_ms"]
    print(json.dumps({"card": cs.nvidia_smi_line(), "root": args.root,
                      "reps": reps, "cases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
