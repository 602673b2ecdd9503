"""CV numbers of the regression model grids on ``bench.run_selector_smoke``'s
regression workload (16 RealNN features, ``y = X @ w + 0.3 * noise``,
``default_rng(11)``) in either package: ``RegressionModelSelector()`` with
no ``models=`` (LinReg x8, RF regressor x18, GBT regressor x18; 3-fold CV on
RMSE, racing) or its ``compact_models()`` (ridge reg_param 0.01 / 0.1 and a
20-tree depth-6 RF regressor).

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/regression_grid_reference.py \\
        --package jax --rows 4000 --grid default
    PYTHONPATH=. python scripts/regression_grid_reference.py --package torch \\
        --device cpu --rows 4000 --grid compact
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/regression_grid_reference.py \\
        --package jax --rows 4000 --grid default --rf-seeds 42,0,1,2,3

Prints one JSON line: every candidate's CV RMSE (the fold mean; a raced-out
point's is its fold-0 screen), the best CV RMSE per family over the points
that ran every fold, the winner, and the refit's train RMSE and R² with the
train wall.  With ``--rf-seeds`` it trains the grid's RF regressor family
alone once per forest seed instead and prints the seeds' best CV RMSE and
their spread (max - min).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from transmogrifai_tpu_torch.synthetic import make_regression_data  # noqa: E402

PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}
RF = "OpRandomForestRegressor"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def grid_models(pkg: str, grid: str):
    """The candidates of ``grid``: None for the default grid, else the
    selector's compact models."""
    if grid == "default":
        return None
    return _mod(pkg, "selector").RegressionModelSelector.compact_models()


def rf_candidate(pkg: str, grid: str):
    S = _mod(pkg, "selector")
    if grid == "default":
        return S._rf_regressor()
    return next(c for c in S.RegressionModelSelector.compact_models()
                if c.model_name == RF)


def train(pkg: str, X, y, models=None, **wf_kw):
    """Train the bench's regression workflow (RealNN features →
    transmogrify → RegressionModelSelector); returns (model, batch, wall
    seconds)."""
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    D = X.shape[1]
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    sel = S.RegressionModelSelector(models=models)
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
    """[model name, params, CV RMSE, raced out] of every candidate."""
    return [[r.model_name, dict(r.params),
             float(next(iter(r.metric_values.values()))), bool(r.raced_out)]
            for r in model.selected_model.summary.validation_results]


def family_best(model) -> dict:
    """Least CV RMSE per family over the points that ran every fold."""
    best: dict = {}
    for name, _, v, raced in candidates(model):
        if not raced and np.isfinite(v) and v < best.get(name, np.inf):
            best[name] = v
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--grid", choices=("default", "compact"),
                    default="default")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch package only)")
    ap.add_argument("--rf-seeds", default="",
                    help="comma-separated forest seeds: train the grid's RF "
                         "regressor family alone once per seed")
    a = ap.parse_args()
    pkg = PACKAGES[a.package]
    wf_kw = {"device": a.device} if a.package == "torch" else {}
    X, y = make_regression_data(a.rows)
    out = {"package": pkg, "rows": a.rows, "features": X.shape[1],
           "grid": a.grid}
    if a.rf_seeds:
        seeds = [int(s) for s in a.rf_seeds.split(",")]
        vals = []
        for seed in seeds:
            cand = rf_candidate(pkg, a.grid)
            cand.estimator.set("seed", seed)
            model, _, _ = train(pkg, X, y, [cand], **wf_kw)
            vals.append(family_best(model)[RF])
        out.update(rf_seeds=seeds, rf_best_cv_rmse=vals,
                   spread=max(vals) - min(vals))
    else:
        model, batch, wall = train(pkg, X, y, grid_models(pkg, a.grid),
                                   **wf_kw)
        ev = _mod(pkg, "evaluators").Evaluators.Regression.rmse()
        m = model.evaluate(ev, batch=batch)
        out.update(candidates=candidates(model),
                   family_best_cv_rmse=family_best(model),
                   winner=model.selected_model.summary.best_model_name,
                   train_rmse=float(m["RootMeanSquaredError"]),
                   train_r2=float(m["R2"]), train_wall_s=wall)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
