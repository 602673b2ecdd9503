"""The train-time sanitizers in the port against the JAX package, on the
CPU (``sanitizer.py``; ≙ ClosureUtils.checkSerializable at
OpWorkflow.scala:277-335 and ``jax_debug_nans``): a clean workflow trains
under all three checks in both packages; the same impure stage raises
``PurityError`` in both, the same unserializable param raises in both, and
a stage that makes NaN raises ``FloatingPointError`` under ``nan_check``
in both (``jnp.log`` on the JAX side, ``torch.log`` on the port's) and
trains without the check in both.  The port's guard restores autograd's
anomaly mode on exit."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _columns(pkg, n=120, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    C, T = _mod(pkg, "columns"), _mod(pkg, "types")
    cols = {"y": C.Column(T.RealNN, y)}
    for j in range(d):
        cols[f"x{j}"] = C.Column(T.Real, X[:, j], np.ones(n, bool))
    return C.ColumnBatch(cols, n)


def _workflow(pkg, extra=None):
    """Real x3 → transmogrify → sanity_check → LR selector, and, with
    ``extra``, a side result feature made by ``extra(feature)``."""
    F, S = _mod(pkg, "features"), _mod(pkg, "selector")
    label = F.FeatureBuilder.RealNN("y").as_response()
    preds = [F.FeatureBuilder.Real(f"x{j}").as_predictor() for j in range(3)]
    checked = label.sanity_check(
        _mod(pkg, "ops.transmogrify").transmogrify(preds),
        remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        _mod(pkg, "models.linear").OpLogisticRegression(),
        S.grid(reg_param=[0.01]), "LR")])
    sel.set_input(label, checked)
    results = [sel.get_output()]
    if extra is not None:
        results.append(extra(preds[0]))
    kw = {"device": "cpu"} if pkg == PORT else {}
    return (_mod(pkg, "workflow").Workflow(**kw)
            .set_input_batch(_columns(pkg)).set_result_features(*results))


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_a_clean_workflow_trains_under_all_three_checks(pkg):
    model = _workflow(pkg).with_sanitizers(
        nan_check=True, purity_check=True, serialization_check=True).train()
    assert model.score() is not None
    if pkg == PORT:
        assert "purity_audit" in model.phase_seconds
        assert not torch.is_anomaly_enabled()


def _impure(pkg):
    T, C = _mod(pkg, "types"), _mod(pkg, "columns")
    state = {"n": 0}

    def impure(col):
        state["n"] += 1
        return C.Column(T.RealNN, np.asarray(col.values) + state["n"])
    return impure


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_the_same_impure_stage_raises_purity_error(pkg):
    T, C = _mod(pkg, "types"), _mod(pkg, "columns")
    San = _mod(pkg, "sanitizer")
    f = _mod(pkg, "features").FeatureBuilder.Real("x").as_predictor()
    lam = _mod(pkg, "stages.base").LambdaTransformer(
        _impure(pkg), T.RealNN, name="Impure")
    lam.set_input(f)
    lam.get_output()
    batch = C.ColumnBatch({"x": C.column_from_values(T.Real, [1.0, 2.0])}, 2)
    with pytest.raises(San.PurityError, match="impure"):
        San.audit_stage_purity(lam, batch)


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_an_impure_stage_fails_the_train_audit(pkg):
    T = _mod(pkg, "types")

    def extra(f):
        lam = _mod(pkg, "stages.base").LambdaTransformer(
            _impure(pkg), T.RealNN, name="Impure")
        return lam.set_input(f).get_output()
    with pytest.raises(_mod(pkg, "sanitizer").PurityError, match="Impure"):
        _workflow(pkg, extra).with_sanitizers(purity_check=True).train()


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_the_same_unserializable_param_raises(pkg):
    T, San = _mod(pkg, "types"), _mod(pkg, "sanitizer")
    f = _mod(pkg, "features").FeatureBuilder.Real("x").as_predictor()
    lam = _mod(pkg, "stages.base").LambdaTransformer(
        lambda c: c, T.RealNN, name="Bad", unserializable=object())
    lam.set_input(f)
    with pytest.raises(San.PurityError, match="serialize"):
        San.audit_stage_serialization([lam])


def _nan_maker(pkg):
    """A stage whose output is log(x - 10): NaN on every row."""
    T, C = _mod(pkg, "types"), _mod(pkg, "columns")
    if pkg == JAX:
        import jax.numpy as jnp

        def fn(col):
            return C.Column(T.RealNN, jnp.log(jnp.asarray(col.values) - 10.0))
    else:
        def fn(col):
            v = torch.as_tensor(np.asarray(col.values))
            return C.Column(T.RealNN, torch.log(v - 10.0))

    def extra(f):
        lam = _mod(pkg, "stages.base").LambdaTransformer(
            fn, T.RealNN, name="MakesNaN")
        return lam.set_input(f).get_output()
    return extra


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_a_stage_that_makes_nan_raises_under_nan_check(pkg):
    with pytest.raises(FloatingPointError):
        _workflow(pkg, _nan_maker(pkg)).with_sanitizers(
            nan_check=True, purity_check=False,
            serialization_check=False).train()
    if pkg == PORT:
        assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_the_same_stage_trains_without_the_check(pkg):
    model = _workflow(pkg, _nan_maker(pkg)).train()
    assert model.selected_model.summary.best_model_name == "LR"


def test_nan_guard_restores_the_anomaly_mode():
    from transmogrifai_tpu_torch.sanitizer import nan_guard
    for prev in (False, True):
        torch.autograd.set_detect_anomaly(prev)
        try:
            with nan_guard(True) as check:
                assert torch.is_anomaly_enabled() and callable(check)
            assert torch.is_anomaly_enabled() == prev
            with nan_guard(False) as check:
                assert check is None
                assert torch.is_anomaly_enabled() == prev
        finally:
            torch.autograd.set_detect_anomaly(False)


def test_the_nan_check_reads_present_positions_and_fitted_state():
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.sanitizer import check_stage_nans
    from transmogrifai_tpu_torch.stages.base import TransformerModel
    from transmogrifai_tpu_torch.types import Real
    from transmogrifai_tpu_torch.features import FeatureBuilder
    f = FeatureBuilder.Real("x").as_predictor()
    st = TransformerModel()
    st.set_input(f)
    out = st.get_output().name
    vals = torch.tensor([1.0, float("nan"), 3.0])
    absent = ColumnBatch({out: Column(Real, vals,
                                      np.array([True, False, True]))}, 3)
    check_stage_nans(st, absent)                       # NaN where absent
    present = ColumnBatch({out: Column(Real, vals, np.ones(3, bool))}, 3)
    with pytest.raises(FloatingPointError, match=out):
        check_stage_nans(st, present)
    st.fitted = {"coef": np.array([0.0, np.nan]), "n": 3}
    with pytest.raises(FloatingPointError, match="fitted.coef"):
        check_stage_nans(st, absent)
    st.fitted = {"coef": np.array([0.0, np.inf])}      # NaN only, not inf
    check_stage_nans(st, absent)


def test_outputs_compare_nan_equal_and_sparse_by_parts():
    from transmogrifai_tpu_torch.columns import Column
    from transmogrifai_tpu_torch.sanitizer import _outputs_equal
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    from transmogrifai_tpu_torch.types import OPVector, Prediction, Real
    a = torch.tensor([1.0, float("nan")])
    assert _outputs_equal(Column(Real, a), Column(Real, a.clone()))
    assert not _outputs_equal(Column(Real, a),
                              Column(Real, torch.tensor([1.0, 2.0])))
    p = {"prediction": torch.tensor([0.0, 1.0]),
         "probability": torch.rand(2, 2)}
    assert _outputs_equal(Column(Prediction, p),
                          Column(Prediction, {k: v.clone()
                                              for k, v in p.items()}))

    def sp(v):
        return SparseMatrix(torch.tensor(v), torch.tensor([0, 2]),
                            torch.tensor([0, 1]), 2, 3)
    assert _outputs_equal(Column(OPVector, sp([1.0, 2.0])),
                          Column(OPVector, sp([1.0, 2.0])))
    assert not _outputs_equal(Column(OPVector, sp([1.0, 2.0])),
                              Column(OPVector, sp([1.0, 2.5])))
    txt = np.array(["a", None], dtype=object)
    assert _outputs_equal(Column(Real, txt), Column(Real, txt.copy()))
