"""Fixed-point tree histograms: the scale rule (``hist_scale``), the CPU
emulation of the kernels' quantise-sum-convert (``tree_hist_fixed_twin``)
and the plans of 8-byte cells; on the card (marker ``cuda``), the kernels
against that emulation bit for bit.

``tree_hist`` and ``tree_hist_deep`` add a GBT's or a regression forest's
float statistics as integers v·2^e in 64-bit cells, so their sums do not
depend on the order of the atomics.  Tolerances: the emulation gives the
same bits under any row permutation and lies within 1e-5 of each cell's
absolute mass (+1e-5) of the twin run in f64; the kernels give the
emulation's bits exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu_torch.models import tree_kernels as tk  # noqa: E402

N_BINS = 32


def _gbt_level(N, D, K, P, seed, masked=False):
    """One level's arrays: bins, node ids over the level and a few rows
    parked above it, (w, w·g, w·h) with fold weights 0/1, node subsets."""
    rng = np.random.default_rng(seed)
    off = P - 1
    B = rng.integers(0, N_BINS, size=(N, D)).astype(np.int8)
    row_node = rng.integers(max(off - 2, 0), off + P,
                            size=(K, N)).astype(np.int32)
    p = 1.0 / (1.0 + np.exp(-rng.normal(size=(K, N))))
    y = rng.integers(0, 2, size=N)
    w = (rng.random((K, N)) < 0.67).astype(np.float32)
    stats = np.stack([w, w * (p - y), w * np.maximum(p * (1 - p), 1e-6)],
                     axis=2).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((K, P, D), bool)
        for k in range(K):
            for q in range(P):
                mask[k, q, rng.choice(D, size=min(5, D), replace=False)] = True
    return B, row_node, stats, off, mask


def _t(a):
    return None if a is None else torch.as_tensor(a)


# --------------------------------------------------------------------------
# the scale rule
# --------------------------------------------------------------------------

def test_scale_exponent_keeps_every_sum_within_2_62():
    """e = 62 - L - E for each (lane, statistic), 2^L >= N and the largest
    magnitude below 2^E; N rows all at the largest magnitude, each sign,
    sum within 2^62 and an all-zero statistic takes e = 0."""
    N = 1000
    stats = np.zeros((2, N, 3), np.float32)
    stats[0, :, 0] = 3.0                        # below 2^2
    stats[0, :, 1] = -0.7                       # below 2^0
    stats[1, :, 0] = 2.5e-3
    stats[1, :, 1] = 1e6
    sc = tk.hist_scale(torch.as_tensor(stats))
    L = (N - 1).bit_length()
    assert L == 10
    want = [[62 - L - 2, 62 - L - 0, 0], [62 - L + 8, 62 - L - 20, 0]]
    assert sc.exponent.tolist() == want
    assert sc.exponent.dtype == torch.int32 and sc.fixed
    q = tk.fixed_point_sums(torch.as_tensor(stats), sc.exponent[:, None, :])
    sums = q.sum(dim=1)
    assert int(sums.abs().max()) <= 1 << 62
    assert int(sums[0, 0]) == N * 3 * 2 ** (62 - L - 2)


def test_scale_keeps_integer_cells_for_counts_below_the_limit():
    """Integer statistics whose per-lane sums stay below
    ``INTEGER_SUM_LIMIT`` (2^23) keep integer cells; a fractional value,
    or integer sums past it, take fixed point."""
    rng = np.random.default_rng(1)
    counts = rng.poisson(1.0, size=(4, 5000, 3)).astype(np.float32)
    assert not tk.hist_scale(torch.as_tensor(counts)).fixed
    frac = counts.copy()
    frac[2, 17, 1] = 0.5
    assert tk.hist_scale(torch.as_tensor(frac)).fixed
    big = counts.copy()
    big[1, :, 0] = 2000.0                       # 1e7 > 2^23 in one lane
    assert tk.hist_scale(torch.as_tensor(big)).fixed


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_scale_raises_on_a_statistic_that_is_not_finite(bad):
    stats = np.ones((2, 50, 3), np.float32)
    stats[1, 7, 2] = bad
    with pytest.raises(ValueError, match="not finite"):
        tk.hist_scale(torch.as_tensor(stats))
    with pytest.raises(ValueError, match="not finite"):
        tk.tree_hist_fixed_twin(torch.zeros((50, 2), dtype=torch.int8),
                                torch.zeros((2, 50), dtype=torch.int32),
                                torch.as_tensor(stats), 0, 1, N_BINS)


def test_scale_of_an_all_zero_lane_and_of_tiny_values():
    """A lane of zeros sums to zeros; values near f32's smallest normals
    keep their bits (e up to 62 - L + 126: 2^e is formed in f64)."""
    stats = np.zeros((2, 64, 2), np.float32)
    stats[1, :, 0] = np.float32(3e-38)
    stats[1, ::2, 1] = np.float32(-1.5e-30)
    st = torch.as_tensor(stats)
    sc = tk.hist_scale(st)
    assert sc.exponent[0].tolist() == [0, 0]
    B = torch.zeros((64, 1), dtype=torch.int8)
    rn = torch.zeros((2, 64), dtype=torch.int32)
    h, t = tk.tree_hist_fixed_twin(B, rn, st, 0, 1, N_BINS, scale=sc)
    assert not bool(t[0].any()) and not bool(h[0].any())
    assert float(t[1, 0, 0]) == float(np.float32(3e-38) * 64)
    assert float(t[1, 0, 1]) == float(np.float32(-1.5e-30) * 32)


def test_fixed_point_rounds_once_to_nearest_even():
    """v·2^e rounded half to even, as ``__double2ll_rn``; the sum's f32 is
    rounded once and scaled exactly."""
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 0.25, 0.75])
    q = tk.fixed_point_sums(v, torch.tensor(0, dtype=torch.int32))
    assert q.tolist() == [0, 2, 2, 0, -2, 0, 1]
    big = torch.tensor([(1 << 40) + 1], dtype=torch.int64)
    f = tk.fixed_point_f32(big, torch.tensor(10, dtype=torch.int32))
    assert float(f) == float(np.float32((1 << 40) + 1) / 1024)


# --------------------------------------------------------------------------
# the emulation: order-free bits, within 1e-5 of mass of the f64 twin
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("P,D,K", [(1, 28, 3), (4, 28, 3), (16, 13, 6),
                                   (128, 7, 2)])
def test_fixed_twin_gives_the_same_bits_in_any_row_order(P, D, K, with_hist,
                                                         masked):
    N = 3000
    B, rn, st, off, mask = _gbt_level(N, D, K, P, P + D, masked)
    args = dict(with_hist=with_hist, node_mask=_t(mask))
    h0, t0 = tk.tree_hist_fixed_twin(_t(B), _t(rn), _t(st), off, P, N_BINS,
                                     **args)
    for seed in (0, 1):
        perm = np.random.default_rng(seed).permutation(N)
        h1, t1 = tk.tree_hist_fixed_twin(_t(B[perm]), _t(rn[:, perm]),
                                         _t(st[:, perm]), off, P, N_BINS,
                                         **args)
        assert torch.equal(t0, t1)
        if with_hist:
            assert torch.equal(h0, h1)
    assert t0.dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P,D,K", [(1, 28, 3), (4, 28, 3), (32, 28, 2),
                                   (256, 5, 2)])
def test_fixed_twin_lies_within_1e5_of_mass_of_the_f64_twin(P, D, K,
                                                           masked):
    N = 4000
    B, rn, st, off, mask = _gbt_level(N, D, K, P, 7 * P + D, masked)
    nm = _t(mask)
    h, t = tk.tree_hist_fixed_twin(_t(B), _t(rn), _t(st), off, P, N_BINS,
                                   node_mask=nm)
    s64 = torch.as_tensor(st, dtype=torch.float64)
    ht, tt = tk.tree_hist_twin(_t(B), _t(rn), s64, off, P, N_BINS,
                               node_mask=nm)
    mh, mt = tk.tree_hist_twin(_t(B), _t(rn), s64.abs(), off, P, N_BINS,
                               node_mask=nm)
    assert bool(((t.double() - tt).abs() <= 1e-5 + 1e-5 * mt).all())
    assert bool(((h.double() - ht).abs() <= 1e-5 + 1e-5 * mh).all())
    if masked:
        assert not bool(h[~nm].any())


def test_fixed_twin_keeps_integer_counts_exact():
    """Integer counts through fixed point sum to the f32 twin's exact
    bits."""
    rng = np.random.default_rng(5)
    N, D, K, P = 2000, 6, 3, 8
    B = rng.integers(0, N_BINS, size=(N, D)).astype(np.int8)
    rn = rng.integers(7, 15, size=(K, N)).astype(np.int32)
    st = rng.poisson(1.0, size=(K, N, 3)).astype(np.float32)
    sc = tk.hist_scale(_t(st))
    assert not sc.fixed
    h, t = tk.tree_hist_fixed_twin(_t(B), _t(rn), _t(st), 7, P, N_BINS,
                                   scale=sc._replace(fixed=True))
    ht, tt = tk.tree_hist_twin(_t(B), _t(rn), _t(st), 7, P, N_BINS)
    assert torch.equal(h, ht) and torch.equal(t, tt)


# --------------------------------------------------------------------------
# the plans of 8-byte cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 6, 12, 60, 300])
def test_fixed_point_plans_fit_every_gbt_level(K):
    """Every level P = 1 .. 2^11 of K lanes at 1M x 28 (S = 3, NB = 32)
    with 8-byte cells: the shared route's block holds its cells within the
    budget; the deep route takes every level from P = 128 (two copies of
    the level's 8-byte cells past 99 KB), one level earlier than 4-byte
    cells."""
    N, D = 1_000_000, 28
    for lvl in range(12):
        P = 1 << lvl
        plan = tk.hist_plan(N, D, K, P, N_BINS, 3, True, None, 8)
        if plan["route"] == "deep":
            assert P >= 128
            assert plan["smem"] == tk._deep_smem(
                plan["Pg"], plan["Wc"], plan["SS"], plan["Sc"], True, 8)
            assert plan["smem"] <= tk.HIST_SMEM_BUDGET
            assert plan["Pg"] * plan["NG"] >= min(P, plan["Pw"])
            continue
        assert P <= 64
        assert plan["smem"] == tk._hist_smem(
            plan["Pg"], plan["Wc"], N_BINS, 3, plan["threads"], True, 8)
        assert plan["smem"] <= tk.HIST_SMEM_BUDGET
        assert plan["Pg"] * plan["NG"] >= P and plan["blocks"] >= tk.SMS
    assert tk.hist_plan(N, D, K, 128, N_BINS, 3)["route"] == "shared"


def test_smem_terms_count_the_exponents_and_cell_bytes():
    assert tk._hist_smem(4, 28, 32, 3, 512, True, 8) - \
        tk._hist_smem(4, 28, 32, 3, 512, True, 4) == 4 * (4 * 28 * 32 * 3
                                                          + 4 * 3)
    assert tk._deep_smem(10, 28, 97, 3, True, 8) - \
        tk._deep_smem(10, 28, 97, 3, True, 4) == 4 * (10 * 28 * 97 + 10 * 3)
    assert tk._hist_smem(1, 1, 2, 5, 32, True) == \
        4 * (1 * 1 * 2 * 5 + 5) + 4 * (2 * tk.HIST_QUEUE + 1 + 5) + 2


# --------------------------------------------------------------------------
# on the card: the kernels give the emulation's bits
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P,skew", [(4, False), (64, False), (128, False),
                                    (2048, False), (2048, True)])
def test_kernels_give_the_emulations_bits_in_any_row_order(cuda, P, skew):
    """``tree_hist`` (P <= 64) and ``tree_hist_deep`` (P >= 128 with 8-byte
    cells; skewed: most rows in 8 nodes, so several blocks share a group)
    on GBT statistics: the emulation's bits, twice and with the rows
    permuted."""
    N, D, K = 200_000, 28, 3
    B, rn, st, off, _ = _gbt_level(N, D, K, P, P)
    if skew:
        rng = np.random.default_rng(3)
        hot = rng.random((K, N)) < 0.75
        rn[hot] = off + rng.integers(0, 8, size=int(hot.sum()))
    args = [torch.as_tensor(a, device=cuda) for a in (B, rn, st)]
    sc = tk.hist_scale(args[2])
    assert sc.fixed
    want = tk.tree_hist_fixed_twin(*args, off, P, N_BINS, scale=sc)
    for _ in range(2):
        got = tk.tree_hist(*args, off, P, N_BINS, scale=sc)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    perm = torch.as_tensor(np.random.default_rng(4).permutation(N),
                           device=cuda)
    got = tk.tree_hist(args[0][perm].contiguous(),
                       args[1][:, perm].contiguous(),
                       args[2][:, perm].contiguous(), off, P, N_BINS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
