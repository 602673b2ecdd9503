"""The port's date, geolocation and multi-pick-list stages against the JAX
package, on the CPU: each stage fitted and applied in both packages to the
same rows (``synthetic.make_kinds_columns``, 3,000 rows, and edge rows:
nulls, empty lists and sets, epoch dates).  Tolerances: the dates' sin /
cos within 1e-6 (the two frameworks' f32 sin and cos); every other output,
every fitted parameter and all vector metadata exactly equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

from transmogrifai_tpu_torch.synthetic import make_kinds_columns  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
N = 3000


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _edge_rows(cols):
    """The first rows made edge cases: null dates (and the epoch), empty
    date lists and sets, a missing location."""
    c = {k: v for k, v in cols.items()}
    c["d1"].mask[:3] = False
    c["d1"].values[:3] = 0
    c["d2"].values[3] = 0
    c["dl"].values[:4] = [[], [0], [5, 5], []]
    c["mpl1"].values[:3] = [set(), None, {"zz"}]
    c["geo"].values[:2] = [None, [0.0, 0.0, 0.0]]
    return c


@pytest.fixture(scope="module")
def batches():
    cols, schema = make_kinds_columns(N, seed=5)
    cols = _edge_rows(cols)
    out = {}
    for pkg in (JAX, PORT):
        C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
        pc = {k: C.Column(getattr(TY, v.kind.__name__), v.values, mask=v.mask)
              for k, v in cols.items()}
        out[pkg] = (C.ColumnBatch(pc, N, device="cpu") if pkg == PORT
                    else C.ColumnBatch(pc, N))
    return out, schema


def _fit_apply(pkg, batch, schema, cls_path, names, **kw):
    F = _mod(pkg, "features")
    mod, cls = cls_path.rsplit(".", 1)
    st = getattr(_mod(pkg, mod), cls)(**kw)
    feats = [F.FeatureBuilder(n, getattr(_mod(pkg, "types"),
                                         schema[n].__name__)).as_predictor()
             for n in names]
    st.set_input(*feats)
    model = st.fit(batch) if hasattr(st, "fit") else st
    return model, model.transform(batch)


STAGES = [
    ("ops.dates.DateToUnitCircleVectorizer", ["d1", "d2", "dt"], {}, 1e-6),
    ("ops.dates.DateToUnitCircleVectorizer", ["d1"],
     {"periods": ["HourOfDay"], "track_nulls": False}, 1e-6),
    ("ops.dates.DateListVectorizer", ["dl"], {}, 0),
    ("ops.dates.DateListVectorizer", ["dl"], {"pivot": "SinceFirst"}, 0),
    ("ops.dates.DateListVectorizer", ["dl"], {"pivot": "ModeDay"}, 0),
    ("ops.dates.DateListVectorizer", ["dl"], {"pivot": "ModeMonth"}, 0),
    ("ops.dates.DateListVectorizer", ["dl"], {"pivot": "ModeHour"}, 0),
    ("ops.geo.GeolocationVectorizer", ["geo"], {}, 0),
    ("ops.geo.GeolocationVectorizer", ["geo"],
     {"fill_mode": "zero", "track_nulls": False}, 0),
    ("ops.collections.MultiPickListVectorizer", ["mpl1", "mpl2"], {}, 0),
    ("ops.collections.MultiPickListVectorizer", ["mpl1"],
     {"top_k": 4, "min_support": 200, "track_other": False}, 0),
]


@pytest.mark.parametrize("cls_path,names,kw,tol", STAGES)
def test_stage_output_and_metadata_match_jax(batches, cls_path, names, kw,
                                             tol):
    (b, schema) = batches
    (jm, jo), (pm, po) = (_fit_apply(pkg, b[pkg], schema, cls_path, names,
                                     **kw) for pkg in (JAX, PORT))
    assert type(pm).__name__ == type(jm).__name__
    got, want = _np(po.values), _np(jo.values)
    assert got.dtype == np.float32 and got.shape == want.shape
    if tol:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)
    assert po.meta.column_names() == jo.meta.column_names()
    assert po.meta.to_json()["columns"] == jo.meta.to_json()["columns"]
    if "fills" in jm.fitted:
        np.testing.assert_array_equal(pm.fitted["fills"],
                                      np.asarray(jm.fitted["fills"]))
    if "vocabs" in jm.fitted:
        assert pm.fitted["vocabs"] == jm.fitted["vocabs"]


@pytest.mark.parametrize("period", ["HourOfDay", "DayOfWeek", "DayOfMonth",
                                    "DayOfYear", "WeekOfYear",
                                    "MonthOfYear"])
def test_time_period_matches_jax(batches, period):
    (b, schema) = batches
    outs = [_fit_apply(pkg, b[pkg], schema,
                       "ops.dates.TimePeriodTransformer", ["d1"],
                       period=period)[1] for pkg in (JAX, PORT)]
    np.testing.assert_array_equal(_np(outs[1].values), _np(outs[0].values))
    assert outs[1].values.dtype == np.int64
    np.testing.assert_array_equal(outs[1].mask, np.asarray(outs[0].mask))


def test_period_fraction_keeps_int64_milliseconds():
    from transmogrifai_tpu.ops.dates import _period_fraction as jf
    from transmogrifai_tpu_torch.ops.dates import _period_fraction as pf
    ms = np.asarray([0, 1, 86_399_999, 1_500_000_000_123, 2 ** 45 + 7,
                     -86_400_000], np.int64)
    for p in ("HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear"):
        np.testing.assert_array_equal(pf(ms, p), jf(ms, p))
    with pytest.raises(ValueError):
        pf(ms, "Fortnight")


def test_geolocation_takes_an_n_by_3_column():
    """The [N, 3] array form with a mask, as JAX ``_geo_arrays`` takes it."""
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.random(50) > 0.2
    outs = []
    for pkg in (JAX, PORT):
        C, TY, F = (_mod(pkg, m) for m in ("columns", "types", "features"))
        col = C.Column(TY.Geolocation, arr, mask=mask)
        b = (C.ColumnBatch({"g": col}, 50, device="cpu") if pkg == PORT
             else C.ColumnBatch({"g": col}, 50))
        st = _mod(pkg, "ops.geo").GeolocationVectorizer()
        st.set_input(F.FeatureBuilder("g", TY.Geolocation).as_predictor())
        outs.append(_np(st.fit(b).transform(b).values))
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("kind", ["Date", "DateTime", "DateList",
                                  "DateTimeList", "MultiPickList",
                                  "Geolocation"])
def test_transmogrify_routes_the_kind_as_jax(kind):
    """``transmogrify`` gives each kind the JAX package's stage."""
    stages = []
    for pkg in (JAX, PORT):
        F, TY = _mod(pkg, "features"), _mod(pkg, "types")
        f = F.FeatureBuilder("x", getattr(TY, kind)).as_predictor()
        out = _mod(pkg, "ops.transmogrify").transmogrify([f])
        stages.append(type(out.parents[0].origin_stage).__name__)
    assert stages[1] == stages[0]
