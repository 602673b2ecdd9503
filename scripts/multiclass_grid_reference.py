"""CV numbers of the multiclass model grids in either package, on iris
(``data/iris/iris.csv``: 150 rows, 4 features, 3 classes) or on
``bench.run_selector_smoke``'s multiclass workload (16 RealNN features
around 4 class centres, ``default_rng(11)``):
``MultiClassificationModelSelector()`` with no ``models=`` (softmax LR x8,
RF x18; 3-fold CV on F1, racing, ``DataCutter``), its ``compact_models()``
(LR reg_param 0.01 / 0.1 and a 20-tree depth-6 forest) or the default LR
candidates alone (``--grid lr``).

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/multiclass_grid_reference.py \\
        --package jax --data iris --grid default
    PYTHONPATH=. python scripts/multiclass_grid_reference.py --package torch \\
        --device cpu --data bench --rows 4000 --grid lr
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/multiclass_grid_reference.py \\
        --package jax --data iris --grid default --rf-seeds 42,0,1,2,3

Prints one JSON line: every candidate's CV F1 (the fold mean; a raced-out
point's is its fold-0 screen), the best CV F1 per family over the points
that ran every fold, the winner and its params, the refit's train F1 and,
when the winner is linear, its coefficients [D, C] and intercepts [C].
With ``--rf-seeds`` it trains the grid's RF family alone once per forest
seed instead and prints the seeds' best CV F1 and their spread (max - min).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from transmogrifai_tpu_torch.synthetic import make_multiclass_data  # noqa: E402

PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}
RF = "OpRandomForestClassifier"
LR = "OpLogisticRegression"
IRIS = os.path.join(ROOT, "data", "iris", "iris.csv")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def iris() -> tuple:
    """(X [150, 4] f32, y [150] f32): the four measurements and the class
    ids of the sorted species names."""
    rows = [line.strip().split(",") for line in open(IRIS) if line.strip()]
    X = np.asarray([[float(v) for v in r[1:5]] for r in rows], np.float32)
    names = sorted({r[5] for r in rows})
    y = np.asarray([names.index(r[5]) for r in rows], np.float32)
    return X, y


def data(name: str, rows: int) -> tuple:
    return iris() if name == "iris" else make_multiclass_data(rows)


def grid_models(pkg: str, grid: str):
    """The candidates of ``grid``: None for the default grid."""
    S = _mod(pkg, "selector")
    if grid == "default":
        return None
    if grid == "lr":
        return [S._lr_candidates()]
    return S.MultiClassificationModelSelector.compact_models()


def rf_candidate(pkg: str, grid: str):
    S = _mod(pkg, "selector")
    if grid == "default":
        return S._rf_classifier()
    return next(c for c in S.MultiClassificationModelSelector.compact_models()
                if c.model_name == RF)


def train(pkg: str, X, y, models=None, **wf_kw):
    """Train the multiclass workflow (RealNN features → transmogrify →
    MultiClassificationModelSelector); returns (model, batch, wall s)."""
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    D = X.shape[1]
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    sel = S.MultiClassificationModelSelector(models=models)
    sel.set_input(label, fv)
    pred = sel.get_output()
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    batch = C.ColumnBatch(cols, len(y))
    wf = _mod(pkg, "workflow").Workflow(**wf_kw).set_input_batch(batch)
    t0 = time.perf_counter()
    model = wf.set_result_features(pred).train()
    return model, batch, time.perf_counter() - t0


def candidates(model) -> list:
    """[model name, params, CV F1, raced out] of every candidate."""
    return [[r.model_name, dict(r.params),
             float(next(iter(r.metric_values.values()))), bool(r.raced_out)]
            for r in model.selected_model.summary.validation_results]


def family_best(model) -> dict:
    """Best CV F1 per family over the points that ran every fold."""
    best: dict = {}
    for name, _, v, raced in candidates(model):
        if not raced and np.isfinite(v) and v > best.get(name, -np.inf):
            best[name] = v
    return best


def _host(a) -> list:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64).tolist()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--data", choices=("iris", "bench"), default="iris")
    ap.add_argument("--rows", type=int, default=4000,
                    help="rows of the bench data")
    ap.add_argument("--grid", choices=("default", "compact", "lr"),
                    default="default")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch package only)")
    ap.add_argument("--rf-seeds", default="",
                    help="comma-separated forest seeds: train the grid's RF "
                         "family alone once per seed")
    a = ap.parse_args()
    pkg = PACKAGES[a.package]
    wf_kw = {"device": a.device} if a.package == "torch" else {}
    X, y = data(a.data, a.rows)
    out = {"package": pkg, "data": a.data, "rows": len(y),
           "features": X.shape[1], "grid": a.grid}
    if a.rf_seeds:
        seeds = [int(s) for s in a.rf_seeds.split(",")]
        vals = []
        for seed in seeds:
            cand = rf_candidate(pkg, a.grid)
            cand.estimator.set("seed", seed)
            model, _, _ = train(pkg, X, y, [cand], **wf_kw)
            vals.append(family_best(model)[RF])
        out.update(rf_seeds=seeds, rf_best_cv_f1=vals,
                   spread=max(vals) - min(vals))
    else:
        model, batch, wall = train(pkg, X, y, grid_models(pkg, a.grid),
                                   **wf_kw)
        ev = _mod(pkg, "evaluators").Evaluators.MultiClassification.f1()
        m = model.evaluate(ev, batch=batch)
        summ = model.selected_model.summary
        best = model.selected_model.best_model
        out.update(candidates=candidates(model),
                   family_best_cv_f1=family_best(model),
                   winner=summ.best_model_name,
                   winner_params=next(
                       r.params for r in summ.validation_results
                       if r.model_name == summ.best_model_name
                       and not r.raced_out
                       and float(next(iter(r.metric_values.values())))
                       == model.selected_model.fitted["best_metric"]),
                   train_f1=float(m["F1"]), train_wall_s=wall)
        if "coef" in best.fitted:
            out.update(coef=_host(best.fitted["coef"]),
                       intercept=_host(best.fitted["intercept"]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
