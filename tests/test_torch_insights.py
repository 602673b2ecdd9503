"""Parity of the PyTorch port's explanations with the JAX package, on the CPU.

On a CPU tensor the LOCO kernel wrappers (``insights_kernels.loco_linear``
and ``loco_tree``) run their plain twin, ``loco_topk_twin``; these tests
hold it, ``RecordInsightsLOCO``, ``RecordInsightsCorr`` and
``WorkflowModel.summary`` against the JAX package on the same numpy inputs,
with the models fitted by the JAX package and carried across by
``convert``.

Tolerances: LOCO diffs within 1e-6 absolute (f32 forwards summed in another
order; the scores are probabilities or margins of order 1), group indices
equal wherever the rank gap exceeds 1e-6, the payloads equal as parsed JSON
up to those diffs, and the payload strings equal bit for bit for the same
(index, diff) input; Corr's fitted values and importances at rtol 1e-5
(f32 moments and products in another order); the summary's keys equal and
its numbers at rtol 1e-5.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu import record_insights as jri  # noqa: E402
from transmogrifai_tpu.columns import Column as JColumn  # noqa: E402
from transmogrifai_tpu.columns import ColumnBatch as JBatch  # noqa: E402
from transmogrifai_tpu.features import Feature as JFeature  # noqa: E402
from transmogrifai_tpu.models import linear as jlin  # noqa: E402
from transmogrifai_tpu.models import trees as jtrees  # noqa: E402
from transmogrifai_tpu.types import OPVector as JOPVector  # noqa: E402
from transmogrifai_tpu.types import RealNN as JRealNN  # noqa: E402
from transmogrifai_tpu.vector_meta import VectorColumnMeta as JVCM  # noqa: E402
from transmogrifai_tpu.vector_meta import VectorMeta as JVM  # noqa: E402
from transmogrifai_tpu_torch import convert  # noqa: E402
from transmogrifai_tpu_torch import insights_kernels as ik  # noqa: E402
from transmogrifai_tpu_torch import record_insights as pri  # noqa: E402
from transmogrifai_tpu_torch.columns import Column, ColumnBatch  # noqa: E402
from transmogrifai_tpu_torch.features import Feature  # noqa: E402
from transmogrifai_tpu_torch.types import OPVector, RealNN  # noqa: E402
from transmogrifai_tpu_torch.vector_meta import (  # noqa: E402
    VectorColumnMeta, VectorMeta, group_key)

CPU = torch.device("cpu")
N = 600
TOL = 1e-6
# (parent, type, descriptor) per column: date circles and a period
# descriptor split "ts" per period; the rest group by raw parent
COLUMNS = ([("ts", "Date", "sin(DayOfWeek)"), ("ts", "Date", "cos(DayOfWeek)"),
            ("ts", "Date", "sin(HourOfDay)"), ("ts", "Date", "cos(HourOfDay)"),
            ("ts", "Date", "DayOfMonth_x")]
           + [(f"r{i // 2}", "Real", None) for i in range(8)]
           + [("c", "PickList", None)] * 3)
D = len(COLUMNS)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:, -3:] = (rng.random((N, 3)) < 0.3).astype(np.float32)   # indicators
    X[:, 7] = 0.0                                   # a group of zeros on
    X[::3, 8] = 0.0                                 # some rows: exact ties
    w = rng.normal(size=D).astype(np.float32) / np.sqrt(D)
    logits = X @ w + 0.5 * X[:, 0] * X[:, 5]
    y = ((logits + rng.normal(size=N)) > 0).astype(np.float32)
    return X, y


def _metas(name="v"):
    jm = JVM(name, [JVCM(p, t, index=i, descriptor_value=dsc)
                    for i, (p, t, dsc) in enumerate(COLUMNS)])
    pm = VectorMeta(name, [VectorColumnMeta(p, t, index=i,
                                            descriptor_value=dsc)
                           for i, (p, t, dsc) in enumerate(COLUMNS)])
    return jm, pm


def _jax_fit(name, X, y):
    est = {"lr": lambda: jlin.OpLogisticRegression(max_iter=50,
                                                   reg_param=0.01),
           "svc": lambda: jlin.OpLinearSVC(max_iter=50, reg_param=0.01),
           "gbt": lambda: jtrees.OpGBTClassifier(max_iter=5, max_depth=3),
           "rf": lambda: jtrees.OpRandomForestClassifier(num_trees=5,
                                                         max_depth=4)}[name]()
    label = JFeature("label", JRealNN, True, None, parents=())
    vec = JFeature("v", JOPVector, False, None, parents=())
    est.set_input(label, vec)
    batch = JBatch({"label": JColumn(JRealNN, y),
                    "v": JColumn(JOPVector, X)}, len(y))
    return est.fit(batch)


def _port_model(jax_model):
    return convert.prediction_model(
        {"model": type(jax_model).__name__,
         "fitted": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                    for k, v in jax_model.fitted.items()}}, CPU)


@pytest.fixture(scope="module")
def models():
    X, y = _data()
    out = {}
    for name in ("lr", "svc", "gbt", "rf"):
        jm = _jax_fit(name, X, y)
        out[name] = (jm, _port_model(jm))
    return X, y, out


def _jax_loco(model, X, meta, **kw):
    vec = JFeature("v", JOPVector, False, None, parents=())
    loco = jri.RecordInsightsLOCO(model=model, **kw)
    loco.set_input(vec)
    return loco.transform(JBatch({"v": JColumn(JOPVector, X, meta=meta)},
                                 len(X))).values


def _port_loco(model, X, meta, **kw):
    vec = Feature("v", OPVector, False, None, parents=())
    loco = pri.RecordInsightsLOCO(model=model, **kw)
    loco.set_input(vec)
    return loco.transform(ColumnBatch(
        {"v": Column(OPVector, torch.as_tensor(X), meta=meta)}, len(X),
        device="cpu")).values


def _rank(v, strategy):
    return {"abs": abs(v), "positive": v, "negative": -v}[strategy]


def _pairs(row):
    return [(k, json.loads(v)) for k, v in row.items()]


def assert_loco_close(want, got, strategy, tol=TOL):
    """Row by row: the same number of (group, diff) pairs; at each position
    the same group unless the two ranks there lie within ``tol`` (a near-tie
    the f32 order may swap); the diffs of every group both list within
    ``tol``; each payload parses to [[name, diff]]."""
    assert len(want) == len(got)
    for rw, rg in zip(want, got):
        pw, pg = _pairs(rw), _pairs(rg)
        assert len(pw) == len(pg)
        for (nw, jw), (ng, jg) in zip(pw, pg):
            assert jw[0][0] == nw and jg[0][0] == ng
            vw, vg = jw[0][1], jg[0][1]
            if nw != ng:
                assert abs(_rank(vw, strategy) - _rank(vg, strategy)) <= tol
        dw, dg = dict((n, p[0][1]) for n, p in pw), dict(
            (n, p[0][1]) for n, p in pg)
        for n in set(dw) & set(dg):
            assert abs(dw[n] - dg[n]) <= tol, (n, dw[n], dg[n])


@pytest.mark.parametrize("strategy", ["abs", "positive", "negative"])
@pytest.mark.parametrize("name", ["lr", "svc", "gbt", "rf"])
def test_loco_matches_jax_by_group(models, name, strategy):
    X, _, ms = models
    jm, pm = _metas()
    want = _jax_loco(ms[name][0], X, jm, top_k=3, strategy=strategy)
    got = _port_loco(ms[name][1], X, pm, top_k=3, strategy=strategy)
    assert_loco_close(want, got, strategy)
    assert all(len(r) == 3 for r in got)


@pytest.mark.parametrize("name", ["lr", "svc", "gbt", "rf"])
def test_loco_matches_jax_metaless_and_k_equal_g(models, name):
    """The meta-less fallback (one group per column, ``f_<i>``) at k = G,
    and the grouped run at a top_k past G (clamped to G)."""
    X, _, ms = models
    want = _jax_loco(ms[name][0], X, None, top_k=D)
    got = _port_loco(ms[name][1], X, None, top_k=D)
    assert_loco_close(want, got, "abs")
    assert set(got[0]) == {f"f_{i}" for i in range(D)}
    jm, pm = _metas()
    want = _jax_loco(ms[name][0], X, jm, top_k=100, strategy="positive")
    got = _port_loco(ms[name][1], X, pm, top_k=100, strategy="positive")
    assert_loco_close(want, got, "positive")
    assert len(got[0]) == len(pri.loco_groups(pm, D))


def test_loco_groups_split_date_periods_like_jax():
    jm, pm = _metas()
    want = jri.RecordInsightsLOCO()._groups(jm, D)
    got = pri.loco_groups(pm, D)
    assert got == want
    assert list(got)[:3] == ["ts_DayOfWeek", "ts_HourOfDay", "ts_DayOfMonth"]
    assert [group_key(c) for c in pm.columns] == [
        jri._group_key(c) for c in jm.columns]
    assert pri.loco_groups(None, 3) == jri.RecordInsightsLOCO()._groups(
        None, 3)
    with pytest.raises(ValueError, match="meta"):
        pri.loco_groups(pm, D + 1)


def test_loco_ties_resolve_to_the_lower_group(models):
    """Column 7 is all zero, so group r1 (columns 7, 8) moves nothing on the
    rows where column 8 is zero too: its diff is exactly 0, tied with every
    other zero diff; both packages list the lower group index first."""
    X, _, ms = models
    Xz = X.copy()
    Xz[:, 9:13] = 0.0                       # r2 and r3 all zero: more ties
    jm, pm = _metas()
    want = _jax_loco(ms["lr"][0], Xz, jm, top_k=pri.loco_groups(pm, D)
                     .__len__())
    got = _port_loco(ms["lr"][1], Xz, pm, top_k=len(pri.loco_groups(pm, D)))
    for rw, rg in zip(want, got):
        assert list(rw) == list(rg)


def test_twin_index_dtype_and_kernel_wrappers_on_cpu(models):
    X, _, ms = models
    Xt = torch.as_tensor(X)
    cg = ik.col_group_of(list(pri.loco_groups(_metas()[1], D).values()), D,
                         CPU)
    G = int(cg.max()) + 1
    idx, val = ik.model_loco(ms["lr"][1], Xt, cg, G, 3, "abs")
    assert idx.dtype == torch.int16 and val.dtype == torch.float32
    assert tuple(idx.shape) == (N, 3)
    assert ik.index_dtype(0x7FFF) == torch.int16
    assert ik.index_dtype(0x8000) == torch.int32
    with pytest.raises(ValueError, match="k <= G"):
        ik.model_loco(ms["lr"][1], Xt, cg, G, G + 1, "abs")
    with pytest.raises(ValueError, match="overlap"):
        ik.col_group_of([[0, 1], [1, 2]], 3, CPU)
    with pytest.raises(ValueError, match="leave columns out"):
        ik.col_group_of([[0]], 2, CPU)


class _HostLR:
    """A host-only model (numpy, no ``device_scores``) for the host path."""

    def __init__(self, coef, b):
        self.coef, self.b = np.asarray(coef, np.float64), float(b)

    def predict_arrays(self, X):
        p = 1.0 / (1.0 + np.exp(-(np.asarray(X, np.float64) @ self.coef
                                  + self.b)))
        return {"prediction": (p > 0.5).astype(np.float64),
                "probability": np.stack([1 - p, p], axis=1)}


def test_host_only_model_takes_the_host_loop_like_jax(models):
    X, _, ms = models
    lr = ms["lr"][0]
    host = _HostLR(np.asarray(lr.fitted["coef"]),
                   np.asarray(lr.fitted["intercept"]).reshape(-1)[0])
    jm, pm = _metas()
    want = _jax_loco(host, X, jm, top_k=4, strategy="negative")
    got = _port_loco(host, X, pm, top_k=4, strategy="negative")
    for rw, rg in zip(want, got):
        assert rw == rg                      # the same float64 host loop


def test_sparse_vector_raises_like_jax():
    from transmogrifai_tpu.sparse.matrix import SparseMatrix as JSparse
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    rows, cols = np.array([0, 1, 2]), np.array([0, 2, 1])
    vals = np.ones(3, np.float32)
    X, y = _data()
    jm = _jax_fit("lr", X[:, :3].copy(), y)
    pm = _port_model(jm)
    vec = JFeature("v", JOPVector, False, None, parents=())
    jloco = jri.RecordInsightsLOCO(model=jm)
    jloco.set_input(vec)
    with pytest.raises(TypeError, match="refusing to densify"):
        jloco.transform(JBatch({"v": JColumn(
            JOPVector, JSparse.from_coo(rows, cols, vals, 3, 3))}, 3))
    ploco = pri.RecordInsightsLOCO(model=pm)
    ploco.set_input(Feature("v", OPVector, False, None, parents=()))
    with pytest.raises(TypeError, match="refusing to densify"):
        ploco.transform(ColumnBatch({"v": Column(
            OPVector, SparseMatrix.from_coo(rows, cols, vals, 3, 3,
                                            device="cpu"))}, 3,
            device="cpu"))


@pytest.mark.parametrize("native", [True, False])
def test_assemble_maps_strings_bit_for_bit(native, monkeypatch):
    """The same (index, diff) input gives the JAX package's payload strings:
    the C formatter against the JAX package's C formatter, the numpy
    formatter against its numpy formatter; names that need escaping and
    non-finite diffs take ``json.dumps`` in both."""
    import transmogrifai_tpu.native as jnative
    rng = np.random.default_rng(5)
    n, k, g = 200, 4, 9
    idx = rng.integers(0, g, size=(n, k))
    val = rng.normal(size=(n, k)) * 10.0 ** rng.integers(-9, 3, size=(n, k))
    names = [f"feat_{i}" for i in range(g)]
    if not native:
        monkeypatch.setenv("TRANSMOGRIFAI_NATIVE", "0")
    jnative._CACHE.clear()
    try:
        want = jri._assemble_maps(idx, val, names, n)
    finally:
        jnative._CACHE.clear()
    got = pri._assemble_maps(idx, val, names, n, native=native)
    assert list(got) == list(want)
    odd = names[:-1] + ['q"uote\\']
    val[0, 0] = np.nan
    assert list(pri._assemble_maps(idx, val, odd, n, native=native)) == \
        list(jri._assemble_maps(idx, val, odd, n))


# --------------------------------------------------------------------------
# RecordInsightsCorr
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corr_inputs():
    X, y = _data(seed=3)
    rng = np.random.default_rng(4)
    p1 = 1.0 / (1.0 + np.exp(-(X[:, 0] - X[:, 5] + 0.3 * rng.normal(size=N))))
    P = np.stack([1 - p1, p1], axis=1).astype(np.float32)
    X[:, 12] = 1.0                                  # zero variance: s2 = 0
    return X, P


def _corr_stage(pkg, X, P, meta, **kw):
    if pkg == "jax":
        pred = JFeature("p", JOPVector, False, None, parents=())
        vec = JFeature("v", JOPVector, False, None, parents=())
        est = jri.RecordInsightsCorr(**kw)
        est.set_input(pred, vec)
        batch = JBatch({"p": JColumn(JOPVector, P),
                        "v": JColumn(JOPVector, X, meta=meta)}, len(X))
    else:
        pred = Feature("p", OPVector, False, None, parents=())
        vec = Feature("v", OPVector, False, None, parents=())
        est = pri.RecordInsightsCorr(**kw)
        est.set_input(pred, vec)
        batch = ColumnBatch({"p": Column(OPVector, torch.as_tensor(P)),
                             "v": Column(OPVector, torch.as_tensor(X),
                                         meta=meta)}, len(X), device="cpu")
    model = est.fit(batch)
    return model, model.transform(batch).values


@pytest.mark.parametrize("norm_type", ["minmax", "znorm", "minmax_centered"])
@pytest.mark.parametrize("corr_type", ["pearson", "spearman"])
def test_corr_matches_jax(corr_inputs, norm_type, corr_type):
    X, P = corr_inputs
    jm, pm = _metas()
    kw = dict(top_k=4, norm_type=norm_type, correlation_type=corr_type)
    jmodel, want = _corr_stage("jax", X, P, jm, **kw)
    pmodel, got = _corr_stage("port", X, P, pm, **kw)
    for key in ("corr", "s1", "s2"):
        np.testing.assert_allclose(pmodel.fitted[key],
                                   np.asarray(jmodel.fitted[key]),
                                   rtol=1e-5, atol=1e-6)
    assert pmodel.fitted["offset"] == jmodel.fitted["offset"]
    for rw, rg in zip(want, got):
        aw = {k: json.loads(v) for k, v in rw.items()}
        ag = {k: json.loads(v) for k, v in rg.items()}
        for name in set(aw) & set(ag):
            assert [p for p, _ in aw[name]] == [p for p, _ in ag[name]]
            np.testing.assert_allclose([v for _, v in ag[name]],
                                       [v for _, v in aw[name]],
                                       rtol=1e-5, atol=1e-6)
        # a name on one side only: a near-tie at the K-th place
        for name in set(aw) ^ set(ag):
            pairs = aw.get(name) or ag.get(name)
            assert all(abs(v) <= max(abs(w) for ps in aw.values()
                                     for _, w in ps) for _, v in pairs)


def test_corr_model_converts_and_transforms_like_jax(corr_inputs):
    """A JAX-fitted RecordInsightsCorrModel carried across by ``convert``
    emits the JAX package's maps."""
    X, P = corr_inputs
    jm, pm = _metas()
    jmodel, want = _corr_stage("jax", X, P, jm, top_k=3)
    pred = Feature("p", OPVector, False, None, parents=())
    vec = Feature("v", OPVector, False, None, parents=())
    est = pri.RecordInsightsCorr(top_k=3)
    est.set_input(pred, vec)
    model = convert.fitted_stage(est, {"stage": "RecordInsightsCorrModel",
                                       **{k: np.asarray(v) for k, v in
                                          jmodel.fitted.items()}}, CPU)
    got = model.transform(ColumnBatch(
        {"v": Column(OPVector, torch.as_tensor(X), meta=pm)}, len(X),
        device="cpu")).values
    for rw, rg in zip(want, got):
        assert list(rw) == list(rg)
        for k in rw:
            np.testing.assert_allclose(
                [v for _, v in json.loads(rg[k])],
                [v for _, v in json.loads(rw[k])], rtol=1e-5, atol=1e-7)


def test_loco_stage_converts_with_its_model(models):
    X, _, ms = models
    jm, pm = _metas()
    loco = pri.RecordInsightsLOCO(top_k=2, strategy="positive")
    loco.set_input(Feature("v", OPVector, False, None, parents=()))
    jmodel = ms["gbt"][0]
    stage = convert.fitted_stage(loco, {
        "stage": "RecordInsightsLOCO", "model": type(jmodel).__name__,
        "fitted": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                   for k, v in jmodel.fitted.items()}}, CPU)
    got = stage.transform(ColumnBatch(
        {"v": Column(OPVector, torch.as_tensor(X), meta=pm)}, len(X),
        device="cpu")).values
    assert_loco_close(_jax_loco(jmodel, X, jm, top_k=2, strategy="positive"),
                      got, "positive")


# --------------------------------------------------------------------------
# ModelInsights / WorkflowModel.summary
# --------------------------------------------------------------------------

def _summary_workflow(pkg, X, y):
    if pkg == "jax":
        from transmogrifai_tpu.columns import Column as C
        from transmogrifai_tpu.columns import ColumnBatch as B
        from transmogrifai_tpu.features import FeatureBuilder as FB
        from transmogrifai_tpu.models.linear import OpLogisticRegression as LR
        from transmogrifai_tpu.ops.transmogrify import transmogrify
        from transmogrifai_tpu.selector import (
            BinaryClassificationModelSelector as Sel, ModelCandidate, grid)
        from transmogrifai_tpu.types import RealNN as R
        from transmogrifai_tpu.workflow import Workflow
        kw = {}
    else:
        from transmogrifai_tpu_torch.columns import Column as C
        from transmogrifai_tpu_torch.columns import ColumnBatch as B
        from transmogrifai_tpu_torch.features import FeatureBuilder as FB
        from transmogrifai_tpu_torch.models.linear import \
            OpLogisticRegression as LR
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.selector import (
            BinaryClassificationModelSelector as Sel, ModelCandidate, grid)
        from transmogrifai_tpu_torch.types import RealNN as R
        from transmogrifai_tpu_torch.workflow import Workflow
        kw = {"device": "cpu"}
    d = X.shape[1]
    label = FB.RealNN("label").as_response()
    feats = [FB.RealNN(f"x{i}").as_predictor() for i in range(d)]
    checked = label.sanity_check(transmogrify(feats), remove_bad_features=True)
    sel = Sel(models=[ModelCandidate(LR(), grid(reg_param=[0.01, 0.1],
                                                max_iter=[50]),
                                     "OpLogisticRegression")])
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": C(R, y), **{f"x{i}": C(R, X[:, i]) for i in range(d)}}
    wf = Workflow(**kw)
    batch = B(cols, len(y))
    return wf.set_input_batch(batch).set_result_features(pred).train()


def _assert_json_close(got, want, path="summary"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def test_summary_matches_jax():
    X, y = _data(seed=6)
    X = X[:, :6].copy()
    jmodel = _summary_workflow("jax", X, y)
    pmodel = _summary_workflow("port", X, y)
    want, got = jmodel.summary(), pmodel.summary()
    assert set(got) == set(want)
    # stage uids differ between the packages: compare the stage echo by
    # class name and parameters
    stages = [(s["className"], s["params"]) for s in got.pop(
        "stageInfo").values() if isinstance(s, dict)]
    jstages = [(s["className"], s["params"]) for s in want.pop(
        "stageInfo").values() if isinstance(s, dict)]
    assert sorted(c for c, _ in stages) == sorted(c for c, _ in jstages)
    got["selectedModelInfo"].pop("bestModelUID")
    want["selectedModelInfo"].pop("bestModelUID")
    # the JAX package fits families on a thread pool; the port in turn
    assert got["selectedModelInfo"]["validationParameters"].pop(
        "parallelism") == 1
    want["selectedModelInfo"]["validationParameters"].pop("parallelism")
    _assert_json_close(got, want)
    text = pmodel.summary_pretty()
    assert "Selected model: OpLogisticRegression" in text
    assert "Top Model Contributions" in text


def test_naive_bayes_contributions_name_the_slice():
    """Naive Bayes contributions arrived with the multiclass slice: the
    spread of each column's class log-probabilities, as the JAX package
    computes it (insights.py:286-288)."""
    from transmogrifai_tpu import insights as jins
    from transmogrifai_tpu_torch.insights import _model_contributions
    lp = np.log(np.random.default_rng(3).dirichlet(np.ones(3), size=2))

    class _Sel:
        best_model = type("NB", (), {"fitted": {"log_prob": lp}})

    assert _model_contributions(_Sel()) == jins._model_contributions(_Sel())


def test_loco_multiclass_forest_explains_the_last_class_like_jax():
    """A forest of 4 classes has no ``scores``: both packages explain its
    ``probability[:, -1]``."""
    X, _ = _data(seed=9)
    rng = np.random.default_rng(9)
    y = rng.integers(0, 4, size=N).astype(np.float32)
    y[X[:, 5] > 0.8] = 3.0
    est = jtrees.OpRandomForestClassifier(num_trees=4, max_depth=4)
    est.set_input(JFeature("label", JRealNN, True, None, parents=()),
                  JFeature("v", JOPVector, False, None, parents=()))
    jm = est.fit(JBatch({"label": JColumn(JRealNN, y),
                         "v": JColumn(JOPVector, X)}, N))
    pm = _port_model(jm)
    assert pm.fitted["leaf"].shape[2] == 4
    jmeta, pmeta = _metas()
    assert_loco_close(_jax_loco(jm, X, jmeta, top_k=4),
                      _port_loco(pm, X, pmeta, top_k=4), "abs")
