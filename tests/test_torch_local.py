"""Local scoring in the port (``transmogrifai_tpu_torch/local.py``), on the
CPU, held to the JAX package's ``transmogrifai_tpu/local.py``.

For bundles of the dense (LR, GBT and forest winners), transmog, sparse,
regression and multiclass workflows:

* a bundle trained by the JAX package is loaded in both packages, and both
  ``score_function``s score the same 50 records one at a time (records
  with null and missing values among them in the transmog and regression
  cases); the port's is held to the JAX package's and to the port's batch
  ``score`` of those records;
* a bundle trained by the port: ``score_function`` record by record gives
  what ``score`` gives on the batch;
* records without the label score (its monoid zero) the same as with it,
  in both packages.

Tolerances (``test_torch_persistence.assert_scores_close``): a classifier's
``prediction`` equal, probabilities within 1e-6 absolute, margins, raw
predictions and a regressor's prediction within 1e-6 absolute or 16 f32
ulps of the value, whichever is larger."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_persistence as tp  # noqa: E402
from test_torch_persistence import bundle_root  # noqa: E402,F401
from transmogrifai_tpu_torch import local  # noqa: E402
from transmogrifai_tpu_torch.workflow import WorkflowModel  # noqa: E402

RECORDS = 50
CASES = ["dense_lr", "dense_gbt", "dense_rf", "transmog", "sparse",
         "regression_gbt", "multiclass_lr"]


def records_of(batch, n):
    """The first ``n`` rows of a port ColumnBatch as record dicts (a masked
    value is ``None``)."""
    out = [{} for _ in range(n)]
    for name, col in batch.items():
        vals = np.asarray(col.values)
        mask = None if col.mask is None else np.asarray(col.mask)
        for i in range(n):
            if col.is_host_object():
                out[i][name] = vals[i]
            elif mask is not None and not mask[i]:
                out[i][name] = None
            else:
                out[i][name] = vals[i].item()
    return out


def local_scores(score, name, records):
    """``score`` applied record by record, its Prediction maps gathered into
    the arrays ``prediction_values`` gives for a batch."""
    rows = [score(r)[name] for r in records]
    got = {"prediction": np.float32([r["prediction"] for r in rows])}
    for base in ("probability", "rawPrediction"):
        width = sum(1 for k in rows[0] if k.startswith(base + "_"))
        if width:
            got[base] = np.float32([[r[f"{base}_{j}"] for j in range(width)]
                                    for r in rows])
    return got


def _both(path):
    """The bundle at ``path`` loaded in the port (CPU) and in the JAX
    package, and the name of its one result feature."""
    from transmogrifai_tpu.workflow import WorkflowModel as JaxModel
    port, ref = WorkflowModel.load(path, device="cpu"), JaxModel.load(path)
    (name,) = [f.name for f in port.result_features]
    assert [f.name for f in ref.result_features] == [name]
    return port, ref, name


@pytest.mark.parametrize("case", CASES)
def test_record_by_record_equals_the_batch_score(bundle_root, case):  # noqa: F811
    path, _ = tp.trained_bundle(bundle_root, case, tp.PORT)
    model = WorkflowModel.load(path, device="cpu")
    fresh = tp.CASES[case][1](tp.PORT, model)
    batch = fresh.take_rows(np.arange(RECORDS))
    want = tp.prediction_values(model, model.score(batch=batch))
    (name,) = [f.name for f in model.result_features]
    got = local_scores(local.score_function(model), name,
                       records_of(batch, RECORDS))
    tp.assert_scores_close(got, want, regression=case.startswith("regr"))


@pytest.mark.parametrize("case", CASES)
def test_record_by_record_equals_the_jax_package(bundle_root, case):  # noqa: F811
    from transmogrifai_tpu import local as jax_local
    path, _ = tp.trained_bundle(bundle_root, case, tp.JAX)
    port, ref, name = _both(path)
    batch = tp.CASES[case][1](tp.PORT, port).take_rows(np.arange(RECORDS))
    records = records_of(batch, RECORDS)
    got = local_scores(local.score_function(port), name, records)
    want = local_scores(jax_local.score_function(ref), name, records)
    regression = case.startswith("regr")
    tp.assert_scores_close(got, want, regression=regression)
    tp.assert_scores_close(
        got, tp.prediction_values(port, port.score(batch=batch)),
        regression=regression)


@pytest.mark.parametrize("case", ["dense_gbt", "transmog"])
def test_unlabelled_records_score(bundle_root, case):  # noqa: F811
    """Without its label a record scores as with it: the label's monoid zero
    in both packages, and the two packages agree."""
    from transmogrifai_tpu import local as jax_local
    path, _ = tp.trained_bundle(bundle_root, case, tp.JAX)
    port, ref, name = _both(path)
    (label,) = [f.name for f in port.raw_features if f.is_response]
    batch = tp.CASES[case][1](tp.PORT, port).take_rows(np.arange(5))
    records = records_of(batch, 5)
    unlabelled = [{k: v for k, v in r.items() if k != label}
                  for r in records]
    for model, lib in ((port, local), (ref, jax_local)):
        score = lib.score_function(model)
        tp.assert_scores_equal(local_scores(score, name, unlabelled),
                               local_scores(score, name, records))
        assert all(isinstance(v, float)
                   for r in unlabelled for v in score(r)[name].values())
    tp.assert_scores_close(
        local_scores(local.score_function(port), name, unlabelled),
        local_scores(jax_local.score_function(ref), name, unlabelled))
