#!/usr/bin/env python3
"""Time ``hash_counts`` on one NVIDIA card: the transmog path's shape (the
text1 column's token stream of ``chip_smoke``'s transmog data, 1M rows x
512 hashes and its null column, packed wire) and, past one row's
shared-memory tile, 60,000 and 100,003 hashes over a few thousand rows of
random ids (unpacked wire).

    python3 scripts/hash_counts_time.py [--root DIR] [--reps R]
        [--rows N] [--wide-rows M]

Each shape is held to the twin (integer counts: equal), then timed by CUDA
events over ``--reps`` calls and by the profiler's device ms a call
(``chip_smoke.kernel_ms``, every kernel of the call).  ``--root`` is a
checkout whose ``transmogrifai_tpu_torch`` is timed (default: the one this
script is in), so that two versions can be compared on one card: run each
in its own process, in the order A B B A; a version whose wrapper refuses
a width reports its ``ValueError``.  Prints one JSON object with the
card's name and power limit and every result.
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
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--wide-rows", type=int, default=4_000)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hash_counts_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch.ops import text_kernels as tk
    from transmogrifai_tpu_torch.ops.text_profile import scan_strings
    from transmogrifai_tpu_torch.synthetic import make_transmog_columns
    print(f"package: {os.path.dirname(transmogrifai_tpu_torch.__file__)}",
          flush=True)
    out = {"card": cs.nvidia_smi_line(), "root": args.root, "shapes": {}}

    def case(name, ids, off, null, H, packed):
        n = off.shape[0] - 1
        got = tk.hash_counts(ids, off, null, H, packed=packed)
        want = torch.empty_like(got)
        tk.hash_counts_twin(ids, off, null, H, want, 0, packed)
        if not torch.equal(got, want):
            raise AssertionError(f"hash_counts {name}: not the twin's counts")
        del got, want
        run = lambda: tk.hash_counts(ids, off, null, H,   # noqa: E731
                                     packed=packed)
        r = {"rows": n, "hashes": H, "ms": cs.time_ms(run, args.reps),
             "kernel_ms": sum(cs.kernel_ms(run, args.reps).values()),
             "bytes": 4 * n * (H + 1) + 8 * (n + 1) + 4 * ids.numel() + n}
        out["shapes"][name] = r
        print(name, json.dumps(r), flush=True)

    cols, _ = make_transmog_columns(args.rows)
    prof = scan_strings(cols["text1"].values)
    ids, off = prof.device_ids(512, torch.device("cuda"))
    null = torch.as_tensor(prof.null, device="cuda")
    case("transmog_text1_512", ids, off, null, 512, True)
    del ids, off, null, prof, cols

    rng = np.random.default_rng(16)
    for H in (60_000, 100_003):
        n = args.wide_rows
        lens = rng.integers(0, 40, size=n)
        flat = rng.integers(0, H, size=int(lens.sum())).astype(np.int32)
        ids = torch.as_tensor(flat, device="cuda")
        off = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                              dtype=torch.int64, device="cuda")
        null = torch.as_tensor(lens == 0, device="cuda")
        try:
            case(f"wide_{H}", ids, off, null, H, False)
        except ValueError as e:          # a version that refuses the width
            out["shapes"][f"wide_{H}"] = f"ValueError: {e}"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
