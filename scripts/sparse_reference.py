"""Numbers of the sparse hashed-text workload (``bench.run_text_sparse``) in
either package: 8-token rows over a 30,000-word vocabulary whose halves
follow the label, plus one dense Real → ``transmogrify([txt, x0],
num_hashes=100_000)`` (the SmartTextVectorizer goes sparse) →
``BinaryClassificationModelSelector`` over ``OpLogisticRegression`` with
``reg_param`` in {0.01, 0.1} and ``max_iter`` 50, 3-fold CV.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/sparse_reference.py \\
        --package jax --rows 3000
    PYTHONPATH=. python scripts/sparse_reference.py --package torch \\
        --device cpu --rows 3000

Prints one JSON line: the feature width, the feature matrix's nnz and
density, each candidate's CV AuPR, the winner, the train AuROC and the
train wall seconds.  The JAX package reads the bench's records
(``bench.make_sparse_text_columns``) through its record reader; the port
reads its own copy of the columns (``transmogrifai_tpu_torch.synthetic``),
which holds the same values.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}
REG_PARAMS = (0.01, 0.1)
NUM_HASHES = 100_000


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def raw_batch(pkg: str, raw_features, n: int, seed: int = 3):
    """The workload's raw ``n``-row batch in package ``pkg``: the JAX
    package reads the bench's records, the port its own columns."""
    if pkg == PACKAGES["jax"]:
        sys.path.insert(0, ROOT)
        from bench import make_sparse_text_columns
        from transmogrifai_tpu.readers.base import DataReader
        records, _ = make_sparse_text_columns(n, seed=seed)
        return DataReader(records=records).generate_batch(raw_features)
    from transmogrifai_tpu_torch.synthetic import make_sparse_text_columns
    cols, _ = make_sparse_text_columns(n, seed=seed)
    return _mod(pkg, "columns").ColumnBatch(cols, n)


def build(pkg: str, n: int, num_hashes: int = NUM_HASHES, batch=None,
          **wf_kw):
    """(workflow, batch, prediction feature) of the workload, on ``batch``
    when one is given (made beforehand), else on a new ``n``-row batch."""
    F, S = _mod(pkg, "features"), _mod(pkg, "selector")
    label = F.FeatureBuilder.RealNN("label").as_response()
    txt = F.FeatureBuilder.Text("txt").as_predictor()
    x0 = F.FeatureBuilder.Real("x0").as_predictor()
    fv = _mod(pkg, "ops.transmogrify").transmogrify([txt, x0],
                                                    num_hashes=num_hashes)
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        _mod(pkg, "models.linear").OpLogisticRegression(),
        S.grid(reg_param=list(REG_PARAMS), max_iter=[50]),
        "OpLogisticRegression")])
    sel.set_input(label, fv)
    pred = sel.get_output()
    wf = _mod(pkg, "workflow").Workflow(**wf_kw).set_result_features(pred)
    b = raw_batch(pkg, wf.raw_features, n) if batch is None else batch
    return wf.set_input_batch(b), b, pred


def feature_matrix(pkg: str, model, batch):
    """The selector's input: the fitted DAG up to the selector applied to
    ``batch`` (a SparseMatrix here)."""
    dag = _mod(pkg, "dag")
    if pkg == PACKAGES["torch"]:
        batch = batch.on(model.device)
    sel = model.selected_model
    scored = dag.apply_dag(batch, [[s for s in layer if s is not sel]
                                   for layer in model.fitted_dag])
    return scored[sel.input_features[1].name].values


def facts(pkg: str, model, batch) -> dict:
    """The numbers the port is held to: width, nnz and density of the
    feature matrix, CV AuPR per candidate, winner, train AuROC."""
    summ = model.selected_model.summary
    ev = _mod(pkg, "evaluators").Evaluators.BinaryClassification.auROC()
    X = feature_matrix(pkg, model, batch)
    best = max(summ.validation_results,
               key=lambda r: float(next(iter(r.metric_values.values()))))
    return {
        "width": int(X.shape[1]), "nnz": int(X.nnz),
        "density": float(X.density),
        "cv_aupr": {f"reg_param={r.params['reg_param']}":
                    float(next(iter(r.metric_values.values())))
                    for r in summ.validation_results},
        "winner": f"reg_param={best.params['reg_param']}",
        "train_auroc": float(model.evaluate(ev, batch=batch)["AuROC"]),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--rows", type=int, default=3_000)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch package only)")
    a = ap.parse_args()
    pkg = PACKAGES[a.package]
    wf_kw = {"device": a.device} if a.package == "torch" else {}
    wf, b, _ = build(pkg, a.rows, **wf_kw)
    t0 = time.perf_counter()
    model = wf.train()
    wall = time.perf_counter() - t0
    out = {"package": pkg, "rows": a.rows, **facts(pkg, model, b),
           "train_wall_s": wall}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
