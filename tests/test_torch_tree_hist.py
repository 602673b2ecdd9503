"""``tree_hist``'s launch plan and a numpy emulation of its kernel's
indexing (``csrc/tree_hist.cu``), held to the plain twin.

The kernel runs only on the card; what can go wrong on the host side of it —
the plan's sizes, the block decode, the compacted slots of a node's feature
subset, the row ranges and the flush into [K, P, D, NB, S] — is emulated
here on the wrapper's own arrays with the kernel's index arithmetic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402

N_1M, D_BENCH = 1_000_000, 28
SMEM_MAX = 227 * 1024


@pytest.mark.parametrize("n_bins", [32, 64, 127])
@pytest.mark.parametrize("K", [3, 60, 225, 300])
def test_hist_plan_fits_every_level(K, n_bins):
    """Every level P = 1 .. 2^11 of K lanes at 1M x 28 (S = 3, with and
    without 5-feature node subsets, histograms and totals only) takes the
    deep route or a plan whose block fits shared memory and whose grid has
    at least one block an SM; the cells cover every node and feature."""
    for lvl in range(12):
        P = 1 << lvl
        for with_hist in (True, False):
            for width in ((None, 5) if with_hist else (None,)):
                plan = tk.hist_plan(N_1M, D_BENCH, K, P, n_bins, 3,
                                    with_hist, width)
                if plan["route"] == "deep":
                    assert 2 * P * n_bins * 3 * 4 > tk._HIST_SMEM_TARGET \
                        or not with_hist
                    assert plan["blocks"] >= tk.SMS
                    continue
                assert plan["smem"] <= SMEM_MAX
                assert plan["smem"] <= tk.HIST_SMEM_BUDGET
                assert plan["blocks"] >= tk.SMS, (K, P, n_bins, plan)
                assert plan["Pg"] * plan["NG"] >= P
                assert plan["Dc"] * plan["NC"] >= D_BENCH
                assert plan["RB"] * plan["R"] >= N_1M
                assert plan["R"] <= 65535
                if with_hist:
                    want = D_BENCH if width is None else width
                    assert plan["Wc"] >= min(want, plan["Dc"])


def test_hist_plan_keeps_a_forest_level_in_one_node_group():
    """RF level 5 (32 nodes, 5-of-28 subsets) at 60 and 300 lanes: one node
    group and one feature chunk, so each row's node id and statistics are
    read once a lane; row ranges fill the card (a 300-lane level does not
    collapse to one block a lane)."""
    for K in (60, 300):
        plan = tk.hist_plan(N_1M, D_BENCH, K, 32, 32, 3, True, 5)
        assert (plan["NG"], plan["NC"], plan["Wc"]) == (1, 1, 5)
        assert plan["blocks"] >= tk.HIST_BLOCKS
        assert plan["R"] > 1


def emulate_tree_hist(B, row_node, stats, offset, P, n_bins, with_hist,
                      node_mask, plan):
    """The kernel of ``csrc/tree_hist.cu`` block by block in numpy, with its
    index arithmetic: block decode, each node's slots, the rows a block
    scans, and the flush of its cells and totals (a node's total from its
    first slot's bins, or its rows one by one where it has no slot)."""
    N, D = B.shape
    K, _, S = stats.shape
    Pg, NG, Dc, NC, Wc = (plan[k] for k in ("Pg", "NG", "Dc", "NC", "Wc"))
    RB, R = plan["RB"], plan["R"]
    hist = np.zeros(K * P * D * n_bins * S, np.float64)
    totals = np.zeros(K * P * S, np.float64)
    masked = node_mask is not None and with_hist
    for bx in range(K * NG * NC):
        g, c, k = bx % NG, (bx // NG) % NC, bx // (NG * NC)
        p0, d0 = g * Pg, c * Dc
        dc = min(Dc, D - d0) if with_hist else 0
        cnt = np.full(Pg, dc, np.int64)
        flist = np.zeros((Pg, max(Wc, 1)), np.int64)
        if masked:
            for p in range(Pg):
                on = (np.nonzero(node_mask[k, p0 + p, d0:d0 + dc])[0]
                      if p0 + p < P else np.zeros(0, np.int64))
                cnt[p] = min(len(on), Wc)
                flist[p, :cnt[p]] = on[:Wc]
        for by in range(R):
            cells = np.zeros(Pg * Wc * n_bins * S if with_hist else 0)
            tot = np.zeros(Pg * S)
            r0, r1 = by * RB, min(N, by * RB + RB)
            n = np.arange(r0, r1)
            node = row_node[k, n].astype(np.int64) - offset - p0
            live = ((node >= 0) & (node < Pg) & (p0 + node < P)
                    & (stats[k, n] != 0).any(axis=1))
            nn, p = n[live], node[live]
            s = stats[k, nn].astype(np.float64)
            js = np.arange(S)
            slots = cnt[p] if with_hist else np.zeros_like(p)
            if c == 0:      # rows of a node with no slot here, one by one
                np.add.at(tot, (p * S)[:, None][slots == 0] + js,
                          s[slots == 0])
            for t in range(Wc if with_hist else 0):
                on = cnt[p] > t
                if not on.any():
                    continue
                d = d0 + (flist[p[on], t] if masked else t)
                b = B[nn[on], d].astype(np.int64)
                i = ((p[on] * Wc + t) * n_bins + b) * S
                np.add.at(cells, i[:, None] + js, s[on])
            per_node = Wc * n_bins * S
            i = np.nonzero(cells)[0]
            p = i // per_node
            rest = i - p * per_node
            t = rest // (n_bins * S)
            bj = rest - t * n_bins * S
            d = d0 + (flist[p, t] if masked else t)
            np.add.at(hist, ((k * P + p0 + p) * D + d) * n_bins * S + bj,
                      cells[i])
            if c == 0:      # else the sum over the first slot's bins
                for i in range(Pg * S):
                    p, j = divmod(i, S)
                    v = tot[i]
                    if with_hist and cnt[p] > 0:
                        v += cells[(p * Wc * n_bins + np.arange(n_bins))
                                   * S + j].sum()
                    totals[(k * P + p0) * S + i] += v
    return (hist.reshape(K, P, D, n_bins, S) if with_hist else None,
            totals.reshape(K, P, S))


def _level(N, D, K, P, n_bins, kind, seed):
    rng = np.random.default_rng(seed)
    B = rng.integers(0, n_bins, size=(N, D)).astype(np.int8)
    off = P - 1
    row_node = rng.integers(max(0, off - max(1, P // 4)), off + P,
                            size=(K, N)).astype(np.int32)
    if kind == "forest":       # Poisson x fold weights x class indicators
        w = rng.poisson(1.0, size=(K, N)) * (rng.random((K, N)) < 2 / 3)
        y = rng.integers(0, 2, size=N)
        stats = np.stack([w, w * (y == 0), w * (y == 1)], axis=2)
    else:                      # GBT: fold weight, w·g, w·h
        w = (rng.random((K, N)) < 2 / 3).astype(np.float64)
        gr = rng.normal(size=(K, N))
        stats = np.stack([w, w * gr, w * np.abs(gr) * 0.25], axis=2)
    mask = np.zeros((K, P, D), bool)
    for k in range(K):
        for p in range(P):
            mask[k, p, rng.choice(D, size=min(5, D), replace=False)] = True
    return B, row_node, stats.astype(np.float32), off, mask


@pytest.mark.parametrize("budget", [113 * 1024, 12 * 1024])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P,kind,D", [(1, "gbt", 28), (4, "gbt", 30),
                                      (8, "forest", 28), (32, "forest", 28),
                                      (32, "forest", 13)])
def test_kernel_emulation_matches_twin(P, kind, D, masked, budget,
                                       monkeypatch):
    """The emulated kernel equals ``tree_hist_twin`` on integer counts and
    lies within 1e-5 of each cell's mass on GBT statistics — with the
    plan's own sizes and, at a 12 KB budget, with several node groups and
    feature chunks; histograms and totals only."""
    monkeypatch.setattr(tk, "HIST_SMEM_BUDGET", budget)
    N, K, n_bins = 3000, 3, 32
    B, row_node, stats, off, mask = _level(N, D, K, P, n_bins, kind, P + D)
    nm = mask if masked else None
    for with_hist in (True, False):
        width = int(mask.sum(axis=2).max()) if masked else None
        plan = tk.hist_plan(N, D, K, P, n_bins, 3, with_hist, width)
        assert plan["route"] == "shared"
        if budget < 20_000 and with_hist and (P > 1 or not masked):
            assert plan["NG"] > 1 or plan["NC"] > 1
        h_e, t_e = emulate_tree_hist(B, row_node, stats, off, P, n_bins,
                                     with_hist, nm, plan)
        h_t, t_t = tk.tree_hist_twin(
            torch.as_tensor(B), torch.as_tensor(row_node),
            torch.as_tensor(stats, dtype=torch.float64), off, P, n_bins,
            with_hist, None if nm is None else torch.as_tensor(nm))
        mass_h, mass_t = tk.tree_hist_twin(
            torch.as_tensor(B), torch.as_tensor(row_node),
            torch.as_tensor(np.abs(stats), dtype=torch.float64), off, P,
            n_bins, with_hist, None if nm is None else torch.as_tensor(nm))
        np.testing.assert_array_less(np.abs(t_e - t_t.numpy()),
                                     1e-5 + 1e-5 * mass_t.numpy())
        if with_hist:
            np.testing.assert_array_less(np.abs(h_e - h_t.numpy()),
                                         1e-5 + 1e-5 * mass_h.numpy())
            if kind == "forest":
                np.testing.assert_array_equal(h_e, h_t.numpy())
