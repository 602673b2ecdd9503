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
    at least one block an SM; the cells cover every node and feature.  The
    deep route's grid is its blocks times the split the wrapper reads from
    the partition (``hist_deep_split``), here for a full level: every row
    live, spread evenly over the nodes."""
    for lvl in range(12):
        P = 1 << lvl
        for with_hist in (True, False):
            for width in ((None, 5) if with_hist else (None,)):
                plan = tk.hist_plan(N_1M, D_BENCH, K, P, n_bins, 3,
                                    with_hist, width)
                if plan["route"] == "deep":
                    assert 2 * P * n_bins * 3 * 4 > tk._HIST_SMEM_TARGET \
                        or not with_hist
                    R = tk.hist_deep_split(plan, -(-N_1M // plan["NG"]),
                                           K * N_1M)
                    assert plan["blocks"] * R >= tk.SMS, (K, P, plan, R)
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


# --------------------------------------------------------------------------
# tree_hist_deep: the plan and an emulation of the partition and the group
# histograms (csrc/tree_hist_deep.cu)
# --------------------------------------------------------------------------

def _check_deep_plan(plan, N, D, K, P, n_bins, S, with_hist, width):
    assert plan["route"] == "deep"
    assert plan["SS"] >= n_bins * plan["Sc"] and plan["SS"] % 2 == 1
    assert plan["smem"] == tk._deep_smem(plan["Pg"], plan["Wc"], plan["SS"],
                                         plan["Sc"], with_hist)
    assert plan["smem"] <= tk.HIST_SMEM_BUDGET <= SMEM_MAX
    assert plan["psmem"] == tk._part_smem(plan["NG"], plan["SEG"])
    assert plan["psmem"] <= SMEM_MAX
    assert plan["NG"] <= tk.HIST_DEEP_MAX_GROUPS
    assert plan["Pg"] * plan["NG"] >= plan["Pw"]
    assert plan["Pw"] * plan["windows"] >= P
    assert plan["Sc"] * plan["NSC"] >= S and plan["Sc"] <= S
    assert plan["SEG"] * plan["nseg"] >= N
    assert plan["blocks"] == K * plan["NG"] * plan["NC"] * plan["NSC"]
    assert plan["blocks"] < 2 ** 31
    assert plan["min_rows"] >= 1 and plan["target_blocks"] >= 1
    assert 1 <= tk.hist_deep_split(plan, N, N) <= min(plan["nseg"], 65535)
    assert plan["partition_bytes"] == (6 + 4 * S) * K * N + \
        8 * K * plan["NG"] * plan["nseg"]
    assert 1 <= plan["Pg"] <= 32768
    if with_hist:
        assert plan["Dc"] * plan["NC"] >= D and 1 <= plan["Dc"] <= 32767
        want = D if width is None else width
        assert plan["Wc"] >= min(want, plan["Dc"])


@pytest.mark.parametrize("S", [3, 5, 7, 41])
@pytest.mark.parametrize("K", [1, 6, 12, 150, 225, 300])
def test_hist_deep_plan_fits_levels_8_to_11(K, S):
    """Levels 8-11 (P = 256 .. 2048) at 1M rows, NB in {32, 64, 127}, D in
    {28, 1,597}, with node subsets (5 of 28, 39 of 1,597) and without,
    histograms and totals only: every plan fits its block's shared memory,
    covers every node, feature and statistic, and fills the card."""
    for n_bins in (32, 64, 127):
        for D, sub in ((28, 5), (1597, 39)):
            for lvl in range(8, 12):
                P = 1 << lvl
                for with_hist, width in ((True, None), (True, sub),
                                         (False, None)):
                    plan = tk.hist_deep_plan(N_1M, D, K, P, n_bins, S,
                                             with_hist, width)
                    _check_deep_plan(plan, N_1M, D, K, P, n_bins, S,
                                     with_hist, width)


def test_hist_deep_plan_takes_every_shape_the_one_pass_route_took():
    """The one-pass kernel took any K <= 65,535, S >= 1, NB <= 127, D, P
    and N < 2^31; so does the plan (past 2,048 groups in windows of
    nodes)."""
    for N, D, K, P, n_bins, S, with_hist in (
            (2 ** 31 - 1, 28, 1, 2048, 32, 3, True),
            (1000, 1597, 65535, 256, 127, 3, True),
            (1000, 1597, 2, 1 << 16, 127, 3, True),
            (1000, 1, 1, 256, 127, 5000, True),
            (1000, 1597, 3, 2048, 127, 300, True),
            (1000, 2, 1, 1 << 20, 2, 100_000, False),
            (5, 1, 1, 1, 2, 1, False)):
        plan = tk.hist_deep_plan(N, D, K, P, n_bins, S, with_hist)
        _check_deep_plan(plan, N, D, K, P, n_bins, S, with_hist, None)
    assert tk.hist_deep_plan(1000, 1597, 2, 1 << 16, 127, 3)["windows"] > 1
    assert tk.hist_deep_plan(1000, 1, 1, 256, 127, 5000)["NSC"] > 1


def test_hist_deep_plan_owns_the_forest_and_gbt_levels():
    """At the default grid's deep levels a block holds ~55 forest nodes
    (5-of-28 subsets) or ~10 GBT nodes (every feature).  Where the rows
    spread over the level (a forest batch, its groups at most twice the
    mean) one block owns each group at levels 10-11 (R = 1: no zero-fill,
    no atomics into device memory) and 2-3 share one of levels 8-9's few
    large groups; where they sit in a few nodes, as in a real deep GBT
    level, R blocks share the heavy groups, each with about a block's
    share of the live rows."""
    for K in (150, 225, 300):
        for lvl in range(8, 12):
            plan = tk.hist_deep_plan(N_1M, 28, K, 1 << lvl, 32, 3, True, 5)
            assert plan["Pg"] >= 50, plan
            live = K * 420_000
            R = tk.hist_deep_split(plan, live // (K * plan["NG"]) * 2, live)
            assert R == 1 if lvl >= 10 else R <= 3, (lvl, R)
    for K in (6, 12):
        plan = tk.hist_deep_plan(N_1M, 28, K, 2048, 32, 3)
        assert plan["Pg"] >= 9, plan
        live = K * 560_000
        assert tk.hist_deep_split(plan, live // (K * plan["NG"]), live) == 1
        R = tk.hist_deep_split(plan, 300_000, live)
        assert R > 1 and -(-300_000 // R) <= max(plan["min_rows"],
                                                 live // plan["target_blocks"])
    plan = tk.hist_deep_plan(50_000, 28, 1, 2048, 32, 3)
    assert tk.hist_deep_split(plan, 10 ** 9, 10 ** 9) == plan["nseg"]


def emulate_tree_hist_deep(B, row_node, stats, offset, P, n_bins, with_hist,
                           node_mask, plan):
    """The two kernels of ``csrc/tree_hist_deep.cu`` in numpy, with their
    index arithmetic: each window's partition (segments of SEG rows, a live
    row's group node // Pg, counts, scan, runs (count, start) and the rows'
    records — index, node within the group, a copy of the statistics —
    scattered into the segment's range, here in reverse order since the
    order within a group is free; each lane's integer flag), R read from
    the runs (the window's cells zeroed where R > 1), then the blocks
    (lane, group, feature chunk, statistic chunk, segment range)
    adding their runs' records into their nodes' slots (odd slot stride SS;
    integer cells for an integer lane) and writing every cell of their
    nodes where R = 1 (the histogram starts as NaN: a cell no block writes
    shows) or adding the non-zero ones into a zeroed histogram, and the
    node totals from the first slot's bins."""
    N, D = B.shape
    K, _, S = stats.shape
    keys = ("Pg", "NG", "Dc", "NC", "Wc", "SS", "Sc", "NSC", "Pw", "SEG",
            "nseg")
    Pg, NG, Dc, NC, Wc, SS, Sc, NSC, Pw, SEG, nseg = (plan[k] for k in keys)
    NC = NC if with_hist else 1
    masked = node_mask is not None and with_hist
    hist = np.full(K * P * D * n_bins * S, np.nan)
    totals = np.zeros(K * P * S)
    for wlo in range(0, P, Pw):
        Pn, first = min(Pw, P - wlo), offset + wlo
        idx = np.full((K, N), -1, np.int64)         # the records
        pl = np.full((K, N), -1, np.int64)
        ss = np.full((K, N, S), np.nan, np.float32)
        runs = np.zeros((K, NG, nseg, 2), np.int64)
        # a lane whose statistics (in the window) are all integers below
        # 2^24 (and N x the largest below 2^31) adds into integer cells
        ints = np.zeros(K, bool)
        for k in range(K):
            node = row_node[k].astype(np.int64) - first
            v = stats[k][(node >= 0) & (node < Pn)].astype(np.float64)
            ints[k] = bool((v == np.rint(v)).all()
                           and (np.abs(v) < 2 ** 24).all()
                           and N * (np.abs(v).max() if v.size else 0) < 2 ** 31)
        for k in range(K):
            for b in range(nseg):
                n0 = b * SEG
                rows = min(SEG, N - n0)
                node = row_node[k, n0:n0 + rows].astype(np.int64) - first
                live = ((node >= 0) & (node < Pn)
                        & (stats[k, n0:n0 + rows] != 0).any(axis=1))
                code = np.where(live, node // Pg, -1)
                cnt = np.bincount(code[live], minlength=NG)
                start = np.cumsum(cnt) - cnt
                runs[k, :, b, 0], runs[k, :, b, 1] = cnt, start
                for g in np.nonzero(cnt)[0]:
                    at = slice(n0 + start[g], n0 + start[g] + cnt[g])
                    rows_g = n0 + np.nonzero(code == g)[0][::-1]
                    idx[k, at] = rows_g
                    pl[k, at] = row_node[k, rows_g] - first - g * Pg
                    ss[k, at] = stats[k, rows_g]
        # R from the runs, as the launch reads them back
        rows_g = runs[..., 0].sum(axis=2)
        R = tk.hist_deep_split(plan, int(rows_g.max()), int(rows_g.sum()))
        if R > 1 and with_hist:         # the window's cells zeroed
            cells_w = hist.reshape(K, P, -1)
            cells_w[:, wlo:wlo + Pn] = 0.0
        for bx in range(K * NG * NC * NSC):
            g, c = bx % NG, bx // NG % NC
            q, k = bx // (NG * NC) % NSC, bx // (NG * NC * NSC)
            p0 = g * Pg
            pn = min(Pg, Pn - p0)
            if pn <= 0:
                continue
            d0, s_lo = c * Dc, q * Sc
            dc = min(Dc, D - d0) if with_hist else 0
            sc = min(Sc, S - s_lo)
            node0 = k * P + wlo + p0
            cnt_s = np.full(Pg, dc, np.int64)
            flist = np.zeros((Pg, max(Wc, 1)), np.int64)
            if masked:
                for p in range(Pg):
                    on = (np.nonzero(node_mask[k, wlo + p0 + p, d0:d0 + dc])[0]
                          if p < pn else np.zeros(0, np.int64))
                    cnt_s[p] = min(len(on), Wc)
                    flist[p, :cnt_s[p]] = on[:Wc]
            cell_t = np.int64 if ints[k] else np.float64
            for r in range(R):
                cells = np.zeros(Pg * Wc * SS if with_hist else 0, cell_t)
                tot = np.zeros(Pg * sc, cell_t)
                at = np.concatenate(
                    [np.arange(b * SEG + runs[k, g, b, 1],
                               b * SEG + runs[k, g, b, 1] + runs[k, g, b, 0])
                     for b in range(r * nseg // R, (r + 1) * nseg // R)]
                    + [np.zeros(0, np.int64)]).astype(np.int64)
                nn, p = idx[k, at], pl[k, at]
                assert ((p >= 0) & (p < pn)).all()
                s = ss[k, at, s_lo:s_lo + sc].astype(cell_t)
                js = np.arange(sc)
                slots = cnt_s[p] if with_hist else np.zeros_like(p)
                if c == 0:
                    np.add.at(tot, (p * sc)[:, None][slots == 0] + js,
                              s[slots == 0])
                for t in range(Wc if with_hist else 0):
                    on = slots > t
                    d = d0 + (flist[p[on], t] if masked else t)
                    i = ((p[on] * Wc + t) * SS
                         + B[nn[on], d].astype(np.int64) * sc)
                    np.add.at(cells, i[:, None] + js, s[on])
                NBS = n_bins * sc
                e = np.arange(NBS)
                o = e // sc * S + e % sc
                if with_hist:
                    slot = np.tile(np.arange(dc), (pn, 1))
                    if masked:
                        slot[:] = -1
                        for pp in range(pn):
                            slot[pp, flist[pp, :cnt_s[pp]]] = \
                                np.arange(cnt_s[pp])
                    pp = np.arange(pn)[:, None]
                    v = np.where(slot[..., None] >= 0, cells[
                        ((pp * Wc + np.maximum(slot, 0)) * SS)[..., None]
                        + e].astype(np.float64), 0.0)
                    dst = (((node0 + pp) * D + d0 + np.arange(dc))
                           * n_bins * S)[..., None] + s_lo + o
                    if R == 1:
                        hist[dst] = v
                    else:
                        keep = (slot[..., None] >= 0) & (v != 0)
                        np.add.at(hist, dst[keep], v[keep])
                if c == 0:
                    for pp in range(pn):
                        v = tot[pp * sc:(pp + 1) * sc].copy()
                        if with_hist and cnt_s[pp] > 0:
                            v += cells[pp * Wc * SS + np.arange(n_bins)[
                                :, None] * sc + js].sum(axis=0)
                        totals[(node0 + pp) * S + s_lo + js] += v
    return (hist.reshape(K, P, D, n_bins, S) if with_hist else None,
            totals.reshape(K, P, S))


@pytest.mark.parametrize("budget,seg,groups,min_rows", [
    (113 * 1024, 512, 2048, 16384),     # the card's sizes, small segments
    (6 * 1024, 256, 2048, 8),           # several groups and R > 1
    (6 * 1024, 700, 3, 16384),          # node windows
    (1200, 512, 2048, 16384),           # feature and statistic chunks
])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P,kind,D,K", [(256, "forest", 28, 3),
                                        (512, "gbt", 30, 2),
                                        (256, "forest", 13, 1)])
def test_deep_emulation_matches_twin(P, kind, D, K, masked, budget, seg,
                                     groups, min_rows, monkeypatch):
    """The emulated deep kernels equal ``tree_hist_twin`` on integer counts
    and lie within 1e-5 of each cell's mass on GBT statistics — with the
    plan's own sizes and with budgets, segments, group caps and split
    sizes that force node groups, R > 1, windows, feature chunks and
    statistic chunks; histograms and totals only.  Every cell is written
    (none left NaN)."""
    monkeypatch.setattr(tk, "HIST_SMEM_BUDGET", budget)
    monkeypatch.setattr(tk, "HIST_DEEP_SEG", seg)
    monkeypatch.setattr(tk, "HIST_DEEP_MAX_GROUPS", groups)
    monkeypatch.setattr(tk, "HIST_DEEP_MIN_ROWS", min_rows)
    N, n_bins = (800 if budget < 2000 else 3000), 32
    B, row_node, stats, off, mask = _level(N, D, K, P, n_bins, kind, P + D)
    if budget < 2000:            # more statistics than a slot holds
        stats = np.concatenate([stats] + [stats[..., 1:] * (i + 2)
                                          for i in range(8)], axis=2)
    S = stats.shape[2]
    nm = mask if masked else None
    for with_hist in (True, False):
        width = int(mask.sum(axis=2).max()) if masked else None
        plan = tk.hist_deep_plan(N, D, K, P, n_bins, S, with_hist, width)
        if budget < 20_000 and with_hist:
            assert plan["NG"] > 1
        if groups < 10 and with_hist:
            assert plan["windows"] > 1
        if budget < 2000 and with_hist:
            assert plan["NSC"] > 1 and (masked or plan["NC"] > 1)
        h_e, t_e = emulate_tree_hist_deep(B, row_node, stats, off, P, n_bins,
                                          with_hist, nm, plan)
        args = (torch.as_tensor(B), torch.as_tensor(row_node))
        tm = None if nm is None or not with_hist else torch.as_tensor(nm)
        h_t, t_t = tk.tree_hist_twin(
            *args, torch.as_tensor(stats, dtype=torch.float64), off, P,
            n_bins, with_hist, tm)
        mass_h, mass_t = tk.tree_hist_twin(
            *args, torch.as_tensor(np.abs(stats), dtype=torch.float64), off,
            P, n_bins, with_hist, tm)
        np.testing.assert_array_less(np.abs(t_e - t_t.numpy()),
                                     1e-5 + 1e-5 * mass_t.numpy())
        if with_hist:
            assert not np.isnan(h_e).any()
            np.testing.assert_array_less(np.abs(h_e - h_t.numpy()),
                                         1e-5 + 1e-5 * mass_h.numpy())
            if kind == "forest":
                np.testing.assert_array_equal(h_e, h_t.numpy())
            if masked:
                assert (h_e[~mask] == 0).all()


def _c_entry_points():
    """Each ``extern "C"`` function of the tree kernels' ``csrc/*.cu`` files:
    name → the ctypes type of each parameter."""
    import ctypes
    import pathlib
    import re
    kinds = {"p": ctypes.c_void_p, "l": ctypes.c_longlong, "i": ctypes.c_int}
    csrc = pathlib.Path(tk.__file__).parents[1] / "csrc"
    found = {}
    for path in sorted(csrc.glob("tree_*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       path.read_text()):
            found[name] = [kinds["p" if "*" in a else
                                 "l" if "long long" in a else "i"]
                           for a in params.split(",")]
    return found


@pytest.mark.parametrize("entry", [
    "tree_hist_launch", "tree_hist_deep_partition", "tree_hist_deep_launch",
    "tree_split_launch", "tree_split_gini_launch",
    "tree_split_variance_launch", "tree_route_launch", "tree_walk_launch"])
def test_argtypes_match_the_c_entry_points(entry):
    """The ctypes signature each wrapper gives a kernel's C entry point is
    the one in its source, parameter by parameter (a missing or extra
    argument would only show on the card, where it cannot launch)."""
    want = (tk._PARTITION_ARGTYPES if entry == "tree_hist_deep_partition"
            else tk._ARGTYPES[entry[:-len("_launch")]])
    assert _c_entry_points()[entry] == want
