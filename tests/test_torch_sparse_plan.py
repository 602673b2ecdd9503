"""The sparse kernels' launch plan and summation order, on the CPU.

``segment_plan`` cuts a segment order (``SparseMatrix.row_order()`` or
``col_order()``) for ``csrc/sp_segsum.cuh``: light segments in tiles of
contiguous segments that fit a shared-memory stage, a team of lanes a
segment; heavy ones in pieces of ``PIECE`` entries.  ``segsum_emulate`` is
the kernels' arithmetic in numpy (each product rounded, a team lane's
serial sum, the xor tree, pieces and their partials in order); the card
tests hold the kernels to it bit for bit.

Tolerances: the plan's tables exactly; the emulation against the twin run
in f64 within 1e-5 of each output's absolute mass (f32 sums in another
order), empty rows and columns exactly zero; the f32 twins against the JAX
package's ``sp_matmat`` / ``sp_rmatmat`` likewise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.sparse import matrix as jm  # noqa: E402
from transmogrifai_tpu_torch.sparse import sparse_kernels as sk  # noqa: E402
from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix  # noqa: E402

CPU = "cpu"


def _ptr(lens):
    ptr = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    return torch.as_tensor(ptr)


def _lengths(case: str, seed: int = 0) -> np.ndarray:
    """Segment lengths: "rows" ~9 entries (every 13th empty), "columns" ~270
    (used hash columns, three in four empty) plus one holding every row,
    "skewed"
    ``chip_smoke.skewed_coo``'s pattern scaled down (~9-entry rows, one of
    5,000 entries, every 13th empty), "mixed" every length up to 2,000."""
    rng = np.random.default_rng(seed)
    if case == "rows":
        lens = rng.poisson(9, 5_000)
        lens[::13] = 0
    elif case == "columns":
        lens = rng.poisson(270, 3_000) * (rng.random(3_000) > 0.74)
        lens[1_234] = int(lens.sum())
    elif case == "skewed":
        lens = rng.poisson(9, 4_000)
        lens[11] = 5_000
        lens[::13] = 0
    else:
        lens = rng.permutation(np.arange(2_001))
    return lens


def _skewed(seed=8, n=3_001, d=6_007):
    """COO triples like ``chip_smoke.skewed_coo`` at a small size: ~9
    random entries a row (duplicates possible), column 7 holding every
    non-empty row, row 11 holding 3,000 entries, every 13th row empty and
    the last 100 columns empty; entries in no particular order."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 9)
    c = rng.integers(0, d - 100, r.size)
    r = np.concatenate([r, np.arange(n), np.full(3_000, 11)])
    c = np.concatenate([c, np.full(n, 7), rng.permutation(d - 100)[:3_000]])
    keep = r % 13 != 0
    r, c = r[keep], c[keep]
    perm = rng.permutation(r.size)
    return (r[perm], c[perm], rng.normal(size=r.size).astype(np.float32),
            n, d)


def _check_plan(plan, ptr, tile_cost):
    p = ptr.numpy()
    lens = np.diff(p)
    n, T = lens.size, plan.light_max
    heavy = lens > T
    assert plan.n_heavy == int(heavy.sum())
    assert plan.ptr.dtype == torch.int32
    np.testing.assert_array_equal(plan.ptr.numpy(), p)
    covered = np.zeros(int(p[-1]), np.int64)
    seen = np.zeros(n, np.int64)
    tiles = plan.tiles.numpy()
    assert (tiles[:, 0] < tiles[:, 1]).all()
    assert (np.diff(tiles[:, 0]) > 0).all()          # in segment order
    for s0, s1 in tiles:
        assert not heavy[s0:s1].any()
        seen[s0:s1] += 1
        a, b = p[s0], p[s1]
        covered[a:b] += 1
        assert b - a <= tile_cost + T - 1
        assert b - (a & ~3) <= plan.stage          # fits a ring slot
        assert s1 - s0 + 1 <= plan.pstage
    assert plan.stage % 4 == 0 and plan.pstage % 4 == 0
    pieces = plan.pieces.numpy()
    for s, e0 in pieces:
        assert heavy[s]
        e1 = min(e0 + sk.PIECE, p[s + 1])
        assert p[s] <= e0 < e1
        covered[e0:e1] += 1
    seen[np.unique(pieces[:, 0])] += 1
    # every entry and every segment exactly once
    assert (covered == 1).all()
    assert (seen == 1).all()
    hs = np.flatnonzero(heavy)
    n_pc = -(-lens[hs] // sk.PIECE)
    first = np.concatenate([[0], np.cumsum(n_pc)[:-1]])
    multi = n_pc > 1
    np.testing.assert_array_equal(plan.finish.numpy(),
                                  np.stack([hs[multi], first[multi]], 1)
                                  .reshape(-1, 2))
    np.testing.assert_array_equal(pieces[first, 0] if hs.size else [], hs)


@pytest.mark.parametrize("case", ["rows", "columns", "skewed", "mixed"])
@pytest.mark.parametrize("team", [None, 1, 4, 32])
@pytest.mark.parametrize("tile_cost", [64, sk.TILE_COST])
def test_plan_covers_every_entry_once(case, team, tile_cost):
    ptr = _ptr(_lengths(case))
    plan = sk.segment_plan(ptr, team=team, tile_cost=tile_cost)
    if team is not None:
        assert plan.team == team
    assert plan.light_max == min(32 * plan.team, sk.LIGHT_CAP)
    _check_plan(plan, ptr, tile_cost)


@pytest.mark.parametrize("case,team", [("rows", 1), ("columns", 32),
                                       ("skewed", 1)])
def test_plan_team_follows_the_lengths(case, team):
    """Rows of ~9 entries get a lane each (at most LANE_ENTRIES a lane),
    hash columns of ~270 a warp; the one full column is heavy."""
    lens = _lengths(case)
    plan = sk.segment_plan(_ptr(lens))
    assert plan.team == team
    assert plan.n_heavy == int((lens > plan.light_max).sum())
    if case != "rows":
        assert plan.n_heavy >= 1 and plan.finish.shape[0] >= 1
    summary = plan.summary()
    assert summary["light"] + summary["heavy"] == lens.size


def test_plan_of_the_row_and_column_orders():
    X = SparseMatrix.from_coo(*_skewed(), device=CPU)
    rows, cols = X.row_order(), X.col_order()
    for order in (rows, cols):
        plan = sk.segment_plan(order.ptr)
        _check_plan(plan, order.ptr, sk.TILE_COST)
    # row 11 and column 7 are the heavy segments
    assert sk.segment_plan(rows.ptr).pieces[:, 0].unique().tolist() == [11]
    assert 7 in sk.segment_plan(cols.ptr).pieces[:, 0].tolist()


def test_plan_edges_and_refusals():
    empty = sk.segment_plan(torch.zeros(4, dtype=torch.int64))
    assert empty.tiles.tolist() == [[0, 3]] and empty.pieces.numel() == 0
    none = sk.segment_plan(torch.zeros(1, dtype=torch.int64))
    assert none.tiles.numel() == 0 and none.n_heavy == 0
    one = sk.segment_plan(_ptr([100_000]))
    assert one.tiles.numel() == 0 and one.pieces.shape[0] == 196
    assert one.finish.tolist() == [[0, 0]]
    with pytest.raises(ValueError, match="at most"):
        sk.segment_plan(torch.tensor([0, 2 ** 31], dtype=torch.int64))
    with pytest.raises(ValueError, match="power of two"):
        sk.segment_plan(_ptr([3, 4]), team=3)


def test_plans_are_cached_and_shared_by_mapped_orders():
    X = SparseMatrix.from_coo(*_skewed(), device=CPU)
    assert X.row_plan() is X.row_plan() and X.col_plan() is X.col_plan()
    Y = X.elementwise(torch.square)
    assert Y.row_plan() is X.row_plan() and Y.col_plan() is X.col_plan()


def _twin(X, op, dense):
    args = (X.values.double(), X.indices, X.row_ids)
    twin = sk.sp_matmat_twin if op == "row" else sk.sp_rmatmat_twin
    n = X.n_rows if op == "row" else X.n_cols
    want = twin(*args, dense.double(), n).numpy()
    mass = twin(args[0].abs(), *args[1:], dense.double().abs(), n).numpy()
    return want, mass


@pytest.mark.parametrize("op", ["row", "col"])
@pytest.mark.parametrize("k", [1, 3, 6, 32, 40])
def test_emulation_matches_the_f64_twin(op, k):
    X = SparseMatrix.from_coo(*_skewed(), device=CPU)
    order = X.row_order() if op == "row" else X.col_order()
    plan = sk.segment_plan(order.ptr)
    rng = np.random.default_rng(k)
    dense = torch.as_tensor(rng.normal(size=(
        X.n_cols if op == "row" else X.n_rows, k)).astype(np.float32))
    got = sk.segsum_emulate(order, plan, dense)
    want, mass = _twin(X, op, dense)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got - want) <= 1e-5 * mass + 1e-12).all()
    if op == "row":
        assert (got[::13] == 0).all()           # empty rows
    else:
        assert (got[-100:] == 0).all()          # empty columns


@pytest.mark.parametrize("team", [1, 2, 8, 16, 32])
def test_emulation_under_other_plans(team):
    """Every team size, small tiles and short pieces' heavy segments: the
    same sums within the tolerance, and bits that depend on the plan's team
    alone."""
    X = SparseMatrix.from_coo(*_skewed(seed=3), device=CPU)
    order = X.col_order()
    dense = torch.as_tensor(np.random.default_rng(0).normal(
        size=(X.n_rows, 6)).astype(np.float32))
    plan = sk.segment_plan(order.ptr, team=team, tile_cost=96)
    got = sk.segsum_emulate(order, plan, dense)
    want, mass = _twin(X, "col", dense)
    assert (np.abs(got - want) <= 1e-5 * mass + 1e-12).all()
    again = sk.segsum_emulate(order, sk.segment_plan(order.ptr, team=team),
                              dense)
    np.testing.assert_array_equal(got.view(np.uint32), again.view(np.uint32))


@pytest.mark.parametrize("k", [1, 3])
def test_emulation_of_one_segment_adds_its_pieces_in_order(k):
    """One heavy segment of 40 pieces (a one-lane team: a row's columns on
    lanes of their own): a piece's slot l (of 32 / cgl: 32 at k = 1, 8 at
    k = 3, whose three columns take 4 lanes a row) adds entries l, l +
    slots, ..., and the finish pass's slot l the partials l, l + slots, ...
    (40 partials: past a warp's 32 at k = 1)."""
    rng = np.random.default_rng(1)
    n = 40 * sk.PIECE - 7
    X = SparseMatrix.from_coo(np.zeros(n, np.int64), rng.integers(0, 50, n),
                              rng.normal(size=n).astype(np.float32), 1, 50,
                              device=CPU)
    order = X.row_order()
    plan = sk.segment_plan(order.ptr, team=1)
    m = torch.as_tensor(rng.normal(size=(50, k)).astype(np.float32))
    got = sk.segsum_emulate(order, plan, m)
    W = 32 // sk.lane_layout(k, plan.team)[1]
    assert W == (32 if k == 1 else 8)
    prod = order.values.numpy()[:, None] * m.numpy()[order.gather.numpy()]
    part = np.zeros((40, W, k), np.float32)
    for e in range(n):
        p, w = divmod(e, sk.PIECE)
        part[p, w % W] = part[p, w % W] + prod[e]
    slots = np.zeros((W, k), np.float32)
    for q, v in enumerate(sk._team_tree(part)):
        slots[q % W] = slots[q % W] + v
    np.testing.assert_array_equal(got[0], sk._team_tree(slots[None])[0])


@pytest.mark.parametrize("op", ["matmat", "rmatmat"])
@pytest.mark.parametrize("k", [1, 6, 32])
def test_twins_match_the_jax_package(op, k):
    r, c, v, n, d = _skewed(seed=5)
    X = SparseMatrix.from_coo(r, c, v, n, d, device=CPU)
    J = jm.SparseMatrix.from_coo(r, c, v, n, d)
    rng = np.random.default_rng(k + 1)
    dense = rng.normal(size=(d if op == "matmat" else n, k)).astype(
        np.float32)
    if op == "matmat":
        got = sk.sp_matmat(X, torch.as_tensor(dense)).numpy()
        ref = jm.sp_matmat(J.values, J.indices, J.row_ids, jnp.asarray(dense),
                           n_rows=n)
    else:
        got = sk.sp_rmatmat(X, torch.as_tensor(dense)).numpy()
        ref = jm.sp_rmatmat(J.values, J.indices, J.row_ids,
                            jnp.asarray(dense), n_cols=d)
    _, mass = _twin(X, "row" if op == "matmat" else "col",
                    torch.as_tensor(dense))
    assert (np.abs(got - np.asarray(ref)) <= 1e-5 * mass + 1e-12).all()


@pytest.mark.parametrize("k,team,layout", [
    (1, 32, (1, 1)), (1, 1, (1, 1)), (3, 32, (1, 1)), (3, 1, (1, 4)),
    (6, 1, (2, 4)), (6, 32, (2, 1)), (6, 16, (2, 2)), (8, 4, (4, 2)),
    (32, 1, (4, 8)), (32, 8, (4, 4)), (31, 2, (1, 16)), (30, 1, (2, 16))])
def test_lane_layout_deals_a_row_over_the_lanes_beside_the_slots(k, team,
                                                                 layout):
    vw, cgl = sk.lane_layout(k, team)
    assert (vw, cgl) == layout
    assert k % vw == 0 and cgl * team <= 32
