"""The repository's synthetic workloads, for the port: the same values for the
same seed as ``bench.make_transmog_columns`` and
``bench.make_sparse_text_columns``, built with fewer Python objects per row.

Transmogrification rows are of mixed raw kinds: 3 free-text columns (20-30% null; 2 words of a
40-word set, then 4-8 or 3-5 tokens of a 50,000-word vocabulary), 2
PickLists (20 and 50 levels, 10% and 20% null), a RealMap with keys a, b, c
(each 80% present) and 4 Reals with 20% nulls; the binary label depends on
cat1, r0 and the map's key a.

Sparse-text rows hold 8 tokens of a label-dependent half of a 30,000-word
vocabulary and one dense Real.

Regression rows (``bench.run_selector_smoke``'s regression half) hold 16
standard-normal features and a label that is their weighted sum plus noise
of sd 0.3.

Multiclass rows (its multiclass half) hold one of 4 class labels and 16
features drawn around that class's centre (centres of sd 2.5, unit noise).

More-kinds rows (``make_kinds_columns``) hold 2 Dates (one 5% null), a
DateTime, a DateList of 0-3 past dates, 2 MultiPickLists of 1-4 of 10
options, a Geolocation (5% null), 8 Reals (5% null each) and a RealMap of
20 keys (each 30% present); the binary label depends on the DateTime's hour
of day, option o3 of the first MultiPickList, the latitude and a step of
r0 at 0.5.

GLM rows (insurance claim frequency and severity) hold 16 standard-normal
features and a label with log link: a count y ~ Poisson(exp(0.3 + X w)) or
a strictly positive amount y ~ Gamma(shape 2, scale exp(0.3 + X w) / 2),
with w ~ N(0, 0.2²) drawn once from its own seed, so that every batch
follows the same model.
"""

from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

from .columns import Column, text_column
from .types import (Date, DateList, DateTime, FeatureType, Geolocation,
                    MultiPickList, PickList, Real, RealMap, RealNN, Text)

TRANSMOG_SCHEMA: Dict[str, Type[FeatureType]] = {
    "label": RealNN, "text1": Text, "text2": Text, "text3": Text,
    "cat1": PickList, "cat2": PickList, "rmap": RealMap,
    "r0": Real, "r1": Real, "r2": Real, "r3": Real}


def make_transmog_columns(n: int, seed: int = 1
                          ) -> Tuple[Dict[str, Column], Dict[str, type]]:
    """(columns by name, schema) of ``n`` rows.  The random draws are those
    of ``bench.make_transmog_columns`` in the same order."""
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(50_000)]
    common = [f"word{i}" for i in range(40)]

    def text_col(p_null=0.2, lo=4, hi=9):
        lens = rng.integers(lo, hi, size=n)
        toks = rng.integers(0, len(vocab), size=(n, hi)).tolist()
        salt = rng.integers(0, len(common), size=(n, 2)).tolist()
        null = (rng.random(n) < p_null).tolist()
        out = np.empty(n, dtype=object)
        for i, (ln, t, s, nl) in enumerate(zip(lens.tolist(), toks, salt,
                                                null)):
            if not nl:
                out[i] = " ".join([common[s[0]], common[s[1]]]
                                  + [vocab[j] for j in t[:ln]])
        return out

    t1 = text_col()
    t2 = text_col()
    t3 = text_col(p_null=0.3, lo=3, hi=6)

    cats1 = np.asarray([f"c{i}" for i in range(20)], dtype=object)
    cats2 = np.asarray([f"k{i}" for i in range(50)], dtype=object)
    c1_idx = rng.integers(0, len(cats1), size=n)
    c1 = cats1[c1_idx]
    c1[rng.random(n) < 0.1] = None
    c2 = cats2[rng.integers(0, len(cats2), size=n)]
    c2[rng.random(n) < 0.2] = None

    rvals = rng.normal(size=(n, 4)).astype(np.float32)
    rnull = rng.random((n, 4)) < 0.2

    mvals = rng.normal(size=(n, 3)).astype(np.float32)
    mkeys = ("a", "b", "c")
    mpresent = rng.random((n, 3)) < 0.8
    rmap = np.empty(n, dtype=object)
    for i, (vs, ps) in enumerate(zip(mvals.astype(np.float64).tolist(),
                                     mpresent.tolist())):
        rmap[i] = {k: v for k, v, p in zip(mkeys, vs, ps) if p}

    logits = (0.8 * (c1_idx % 3 == 0).astype(np.float32)
              + np.where(rnull[:, 0], 0.0, rvals[:, 0])
              + 0.5 * np.where(mpresent[:, 0], mvals[:, 0], 0.0))
    y = (logits + rng.normal(size=n).astype(np.float32) > 0.4).astype(
        np.float32)

    cols = {
        "label": Column(RealNN, y),
        "text1": text_column(Text, t1),
        "text2": text_column(Text, t2),
        "text3": text_column(Text, t3),
        "cat1": text_column(PickList, c1),
        "cat2": text_column(PickList, c2),
        "rmap": Column(RealMap, rmap),
    }
    for j in range(4):
        cols[f"r{j}"] = Column(Real, np.where(rnull[:, j], np.float32(np.nan),
                                              rvals[:, j]),
                               mask=~rnull[:, j])
    return cols, dict(TRANSMOG_SCHEMA)


SPARSE_TEXT_SCHEMA: Dict[str, Type[FeatureType]] = {
    "label": RealNN, "txt": Text, "x0": Real}


def make_sparse_text_columns(n: int, vocab_size: int = 30_000, seed: int = 3
                             ) -> Tuple[Dict[str, Column], Dict[str, type]]:
    """(columns by name, schema) of ``n`` rows: a 0/1 label, ``txt`` — 8
    tokens of ``pos0..pos{half-1}`` on positive rows and ``neg...`` on
    negative ones — and one dense Real ``x0``.  The random draws are those of
    ``bench.make_sparse_text_columns`` in the same order."""
    rng = np.random.default_rng(seed)
    half = vocab_size // 2
    vocab = [f"pos{i}" for i in range(half)] + [f"neg{i}" for i in range(half)]
    y = rng.integers(0, 2, n)
    pos = rng.integers(0, half, size=(n, 8))
    neg = rng.integers(0, half, size=(n, 8)) + half
    ids = np.where(y[:, None] == 1, pos, neg).tolist()
    x0 = rng.normal(size=n).astype(np.float32)
    txt = np.empty(n, dtype=object)
    txt[:] = [" ".join(map(vocab.__getitem__, row)) for row in ids]
    cols = {"label": Column(RealNN, y.astype(np.float32)),
            "txt": Column(Text, txt),
            "x0": Column(Real, x0, mask=np.ones(n, dtype=bool))}
    return cols, dict(SPARSE_TEXT_SCHEMA)


MULTI_CLASSES = 4          # bench.run_selector_smoke's C


def _multiclass_draws(rng, n: int, d: int) -> Tuple[np.ndarray, np.ndarray]:
    """The bench's multiclass draws from ``rng``, in its order: labels,
    class centres (× 2.5), rows (bench.py:1171-1174)."""
    ym = rng.integers(0, MULTI_CLASSES, n)
    centers = rng.normal(size=(MULTI_CLASSES, d)) * 2.5
    Xm = (centers[ym] + rng.normal(size=(n, d))).astype(np.float32)
    return Xm, ym


def make_multiclass_data(n: int, d: int = 16, seed: int = 11
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, d] f32, y [n] f32 class ids 0..3) of
    ``bench.run_selector_smoke``'s multiclass workload, bit for bit."""
    X, y = _multiclass_draws(np.random.default_rng(seed), n, d)
    return X, y.astype(np.float32)


def make_regression_data(n: int, d: int = 16, seed: int = 11
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, d] f32, y [n] f32) of ``bench.run_selector_smoke``'s
    regression workload: ``y = X @ w + 0.3 * noise``.  The bench draws its
    multiclass data from the same generator first, so those draws are made
    here too, in the bench's order, and dropped."""
    rng = np.random.default_rng(seed)
    _multiclass_draws(rng, n, d)
    w = rng.normal(size=d).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = X @ w + 0.3 * rng.normal(size=n).astype(np.float32)
    return X, y.astype(np.float32)


GLM_INTERCEPT = 0.3        # the true intercept of the GLM rows
GLM_COEF_SEED = 20         # the true coefficients' draw


def glm_true_coef(d: int = 16) -> np.ndarray:
    """The GLM rows' true coefficients w ~ N(0, 0.2²) [d] f32."""
    return np.random.default_rng(GLM_COEF_SEED).normal(
        scale=0.2, size=d).astype(np.float32)


def make_glm_data(n: int, family: str, d: int = 16, seed: int = 21
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, d] f32, y [n] f32) of the GLM rows: X ~ N(0, 1); for
    ``family`` "poisson" y ~ Poisson(mu), for "gamma" y ~ Gamma(shape 2,
    scale mu / 2) (mean mu, never 0), mu = exp(0.3 + X w) with w =
    :func:`glm_true_coef`."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    mu = np.exp(GLM_INTERCEPT + X.astype(np.float64) @ glm_true_coef(d))
    if family == "poisson":
        y = rng.poisson(mu)
    elif family == "gamma":
        y = rng.gamma(2.0, mu / 2.0)
    else:
        raise ValueError(f"make_glm_data: family {family!r}")
    return X, y.astype(np.float32)


KINDS_SCHEMA: Dict[str, Type[FeatureType]] = {
    "label": RealNN, "d1": Date, "d2": Date, "dt": DateTime, "dl": DateList,
    "mpl1": MultiPickList, "mpl2": MultiPickList, "geo": Geolocation,
    **{f"r{j}": Real for j in range(8)}, "rmap": RealMap}
KINDS_BASE_MS = 1_500_000_000_000
_DAY_MS = 86_400_000


def make_kinds_columns(n: int, seed: int = 17
                       ) -> Tuple[Dict[str, Column], Dict[str, type]]:
    """(columns by name, schema) of ``n`` more-kinds rows (the module
    docstring): dates as int64 epoch milliseconds, lists, sets and maps as
    host objects."""
    rng = np.random.default_rng(seed)
    day = rng.integers(0, 365, size=(3, n)).astype(np.int64)
    ms = rng.integers(0, 3_600_000, size=(3, n)).astype(np.int64)
    hour = rng.integers(0, 24, size=(3, n)).astype(np.int64)
    dates = KINDS_BASE_MS + day * _DAY_MS + hour * 3_600_000 + ms
    d1_null = rng.random(n) < 0.05

    n_dl = rng.integers(0, 4, size=n)
    dl_days = rng.integers(1, 400, size=(n, 3)).astype(np.int64)
    dl = np.empty(n, dtype=object)
    dl[:] = [ds[:k] for k, ds in zip(
        n_dl.tolist(), (KINDS_BASE_MS - dl_days * _DAY_MS).tolist())]

    opts = np.asarray([f"o{j}" for j in range(10)], dtype=object)

    def mpl():
        k = rng.integers(1, 5, size=n)
        order = np.argsort(rng.random((n, 10)), axis=1)[:, :4]
        out = np.empty(n, dtype=object)
        out[:] = [set(o[:kk]) for kk, o in zip(k.tolist(),
                                               opts[order].tolist())]
        return out, (order == 3) & (np.arange(4)[None, :] < k[:, None])

    mpl1, has_o3 = mpl()
    mpl2, _ = mpl()

    lat = rng.uniform(-60.0, 60.0, size=n)
    lon = rng.uniform(-180.0, 180.0, size=n)
    acc = rng.uniform(1.0, 10.0, size=n)
    geo_null = rng.random(n) < 0.05
    geo = np.empty(n, dtype=object)
    for i, (a, b, c, nl) in enumerate(zip(lat.tolist(), lon.tolist(),
                                         acc.tolist(), geo_null.tolist())):
        geo[i] = None if nl else [a, b, c]

    rvals = rng.normal(size=(n, 8)).astype(np.float32)
    rnull = rng.random((n, 8)) < 0.05
    mvals = rng.normal(size=(n, 20))
    mpresent = rng.random((n, 20)) < 0.3
    keys = [f"k{j:02d}" for j in range(20)]
    rows, cols = np.nonzero(mpresent)           # row-major: each row's keys
    ks = np.asarray(keys, dtype=object)[cols].tolist()   # in key order
    vs = mvals[rows, cols].tolist()
    ends = np.searchsorted(rows, np.arange(n + 1)).tolist()
    rmap = np.empty(n, dtype=object)
    rmap[:] = [dict(zip(ks[a:b], vs[a:b]))
               for a, b in zip(ends[:-1], ends[1:])]

    logits = (1.5 * np.sin(2 * np.pi * hour[2] / 24.0)
              + 1.2 * has_o3.any(axis=1)
              + 0.03 * np.where(geo_null, 0.0, lat)
              + 1.5 * (np.where(rnull[:, 0], 0.0, rvals[:, 0]) > 0.5)
              + 0.5 * np.where(mpresent[:, 0], mvals[:, 0], 0.0) - 1.0)
    y = (logits + rng.normal(size=n) > 0).astype(np.float32)

    cols = {
        "label": Column(RealNN, y),
        "d1": Column(Date, np.where(d1_null, 0, dates[0]), mask=~d1_null),
        "d2": Column(Date, dates[1], mask=np.ones(n, bool)),
        "dt": Column(DateTime, dates[2], mask=np.ones(n, bool)),
        "dl": Column(DateList, dl),
        "mpl1": Column(MultiPickList, mpl1),
        "mpl2": Column(MultiPickList, mpl2),
        "geo": Column(Geolocation, geo),
        "rmap": Column(RealMap, rmap),
    }
    for j in range(8):
        cols[f"r{j}"] = Column(Real, np.where(rnull[:, j], np.float32(np.nan),
                                              rvals[:, j]),
                               mask=~rnull[:, j])
    return cols, dict(KINDS_SCHEMA)
