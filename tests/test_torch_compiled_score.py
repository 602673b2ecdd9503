"""The port's compiled score path (``transmogrifai_tpu_torch/compiled.py``),
the counterpart of ``tests/test_compiled_score.py``, on the CPU.

``ScoreProgram`` partitions the fitted DAG into host stages and device
segments and must give ``apply_dag``'s bits (exact equality) at batches of
1, 7 and 500 rows, on a small mixed workflow (Reals and a PickList through
transmogrify, SanityChecker, an LR selector) and on reloaded bundles of the
dense, transmog, sparse, regression and multiclass workflows.  The lean call
drops the intermediates (and frees them); ``keep_intermediate`` returns
them.  A stage that raises inside a device segment raises to the caller and
runs once: the port has no demotion.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_persistence as tp  # noqa: E402
from test_torch_persistence import bundle_root  # noqa: E402,F401
from transmogrifai_tpu_torch import compiled  # noqa: E402
from transmogrifai_tpu_torch import types as T  # noqa: E402
from transmogrifai_tpu_torch.columns import (Column, ColumnBatch,  # noqa: E402
                                             numeric_column, text_column)
from transmogrifai_tpu_torch.compiled import ScoreProgram  # noqa: E402
from transmogrifai_tpu_torch.dag import apply_dag  # noqa: E402
from transmogrifai_tpu_torch.evaluators import Evaluators  # noqa: E402
from transmogrifai_tpu_torch.features import FeatureBuilder  # noqa: E402
from transmogrifai_tpu_torch.models.linear import \
    OpLogisticRegression  # noqa: E402
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify  # noqa: E402
from transmogrifai_tpu_torch.selector import (  # noqa: E402
    BinaryClassificationModelSelector, ModelCandidate, grid)
from transmogrifai_tpu_torch.stages.base import Transformer  # noqa: E402
from transmogrifai_tpu_torch.workflow import (Workflow,  # noqa: E402
                                              WorkflowModel)

N, D = 600, 5


def _mixed_batch(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] > 0).astype(np.float32)
    cols = {"y": Column(T.RealNN, y)}
    for j in range(D):
        vals = [None if rng.random() < 0.05 else float(v) for v in X[:, j]]
        cols[f"x{j}"] = numeric_column(T.Real, vals)
    cols["cat"] = text_column(T.PickList,
                              ["a" if v > 0 else "b" for v in X[:, 2]])
    return ColumnBatch(cols, n)


@pytest.fixture(scope="module")
def mixed():
    label = FeatureBuilder.RealNN("y").as_response()
    preds = [FeatureBuilder.Real(f"x{j}").as_predictor() for j in range(D)]
    preds.append(FeatureBuilder.PickList("cat").as_predictor())
    checked = label.sanity_check(transmogrify(preds),
                                 remove_bad_features=True)
    sel = BinaryClassificationModelSelector(models=[
        ModelCandidate(OpLogisticRegression(), grid(reg_param=[0.01]),
                       "OpLogisticRegression")])
    sel.set_input(label, checked)
    pred = sel.get_output()
    wf = Workflow(device="cpu").set_input_batch(_mixed_batch())
    return wf.set_result_features(pred).train(), pred


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(tp._np(a[k]), tp._np(b[k]), err_msg=k)


def test_device_segment_holds_the_vectorizers_and_the_model_chain(mixed):
    model, _ = mixed
    segments = model.score_program()._partition(_mixed_batch(10))
    assert [is_dev for is_dev, _ in segments] == [True]
    names = {s.operation_name for s in segments[0][1]}
    assert {"RealVectorizerModel", "OneHotModel", "VectorsCombiner",
            "SanityCheckerModel", "SelectedModel"} <= names


def test_host_stages_run_before_device_stages_within_a_layer(mixed):
    model, _ = mixed

    class HostOp(Transformer):
        is_device_op = False
        out_kind = T.Text

        def transform(self, batch):
            return text_column(T.Text, ["z"] * len(batch))

    host = HostOp()
    host.set_input(model.raw_features[0])
    layer0 = list(model.fitted_dag[0]) + [host]
    prog = ScoreProgram([layer0] + list(model.fitted_dag[1:]), [])
    assert prog.stages[0] is host
    assert all(s.is_device_op or s.supports_staging for s in prog.stages[1:])


CASES = ["dense_gbt", "transmog", "sparse", "regression_rf", "multiclass_mlp"]


@pytest.mark.parametrize("n", [1, 7, 500])
def test_score_program_gives_apply_dag_bits_on_the_mixed_model(mixed, n):
    model, pred = mixed
    batch = _mixed_batch(n, seed=3).on("cpu")
    eager = apply_dag(batch, model.fitted_dag)[pred.name].values
    got = model.score(batch=batch)
    assert list(got.names()) == [pred.name]
    _assert_same_bits(got[pred.name].values, eager)
    assert len(got[pred.name].values["prediction"]) == n


@pytest.mark.parametrize("n", [1, 7, 500])
@pytest.mark.parametrize("case", CASES)
def test_score_program_gives_apply_dag_bits_on_reloaded_bundles(
        bundle_root, case, n):  # noqa: F811
    path, _ = tp.trained_bundle(bundle_root, case, tp.PORT)
    model = WorkflowModel.load(path, device="cpu")
    fresh = tp.CASES[case][1](tp.PORT, model)
    batch = fresh.take_rows(np.arange(n) % len(fresh)).on("cpu")
    eager = tp.prediction_values(model, apply_dag(batch, model.fitted_dag))
    _assert_same_bits(tp.prediction_values(model, model.score(batch=batch)),
                      eager)


def test_keep_intermediate_returns_the_intermediates(mixed):
    model, pred = mixed
    batch = _mixed_batch(50, seed=1)
    lean = model.score_program()(batch.on("cpu"))
    full = model.score_program()(batch.on("cpu"), keep_intermediate=True)
    made = {f.name for s in model.stages for f in s.output_features}
    assert made <= set(full.names())
    assert set(lean.names()) == set(batch.names()) | {pred.name}
    kept = model.score(batch=batch, keep_intermediate_features=True)
    assert made <= set(kept.names())
    raw = model.score(batch=batch, keep_raw_features=True)
    assert set(raw.names()) == {f.name for f in model.raw_features} \
        | {pred.name}


def test_the_lean_call_frees_an_intermediate_block(mixed):
    model, _ = mixed
    combiner = next(s for s in model.stages
                    if s.operation_name == "VectorsCombiner")
    refs = []
    orig = combiner.transform

    def watched(batch):
        col = orig(batch)
        refs.append(weakref.ref(col.values))
        return col

    combiner.transform = watched
    try:
        out = model.score_program()(_mixed_batch(50).on("cpu"))
        gc.collect()
        assert refs[-1]() is None
        full = model.score_program()(_mixed_batch(50).on("cpu"),
                                     keep_intermediate=True)
        gc.collect()
        assert refs[-1]() is not None
    finally:
        del combiner.transform
    del out, full


def test_frontier_columns_upload_once_and_the_callers_stay_on_the_host(
        mixed, monkeypatch):
    model, _ = mixed
    uploads = []
    real = compiled.to_device_f32

    def counted(values, device):
        uploads.append(values)
        return real(values, device)

    monkeypatch.setattr(compiled, "to_device_f32", counted)
    batch = _mixed_batch(20).on("cpu")
    model.score(batch=batch)
    # x0..x4 (the real vectorizer) and y (checker, selector); not the
    # PickList, which the one-hot stage lowers on the host
    assert len(uploads) == D + 1
    assert all(isinstance(v, np.ndarray) for v in uploads)
    assert all(isinstance(c.values, np.ndarray) for _, c in batch.items())


def test_a_stage_raising_in_a_device_segment_raises_once(mixed):
    model, pred = mixed
    calls = []

    class Boom(Transformer):
        out_kind = T.RealNN

        def transform(self, batch):
            calls.append(len(batch))
            raise RuntimeError("boom inside the segment")

    boom = Boom()
    boom.set_input(model.selected_model.input_features[1])
    prog = ScoreProgram(list(model.fitted_dag) + [[boom]],
                        [boom.get_output().name, pred.name])
    assert all(is_dev for is_dev, _ in prog._partition(_mixed_batch(5)))
    with pytest.raises(RuntimeError, match="boom inside the segment"):
        prog(_mixed_batch(30).on("cpu"))
    assert calls == [30]
    assert not hasattr(prog, "_demoted")


def test_evaluate_error_messages(mixed):
    model, _ = mixed
    ev = Evaluators.BinaryClassification.auROC()
    batch = _mixed_batch(100)
    with pytest.raises(ValueError, match="response column 'y'"):
        model.evaluate(ev, batch=batch.drop(["y"]))
    with pytest.raises(ValueError, match="column 'x1' required by the DAG"):
        model.evaluate(ev, batch=batch.drop(["x1"]))
    got = model.evaluate(ev, batch=batch)
    label = next(f for f in model.raw_features if f.is_response)
    assert model.evaluate(ev, label_feature=label, batch=batch) == got
    scored, ev2 = model.score_and_evaluate(ev, batch=batch)
    assert ev2 == got and len(scored) == 100
    assert 0.5 < got["AuROC"] <= 1.0


def test_score_and_compute_data_up_to(mixed):
    model, pred = mixed
    batch = _mixed_batch(40)
    checked_f = model.selected_model.input_features[1]
    upto = model.compute_data_up_to(checked_f, batch=batch)
    assert checked_f.name in upto and pred.name not in upto
    fn = model.score_fn()
    _assert_same_bits(fn(batch)[pred.name].values,
                      model.score(batch=batch)[pred.name].values)
