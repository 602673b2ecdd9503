"""CV numbers of the GLM workloads in either package: insurance claim
frequency (poisson) and severity (gamma) rows of ``synthetic.make_glm_data``
(16 RealNN features, log link, true intercept 0.3 and coefficients
``glm_true_coef``) through ``RegressionModelSelector`` with two candidate
families: ``OpGeneralizedLinearRegression(family=...)`` over the default
``reg_param`` grid (0.001, 0.01, 0.1, 0.2; 50 iterations) and the default
``OpLinearRegression`` grid (x8); 3-fold CV on RMSE with racing.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/glm_grid_reference.py \\
        --package jax --family poisson --rows 1000000
    PYTHONPATH=. python scripts/glm_grid_reference.py --package torch \\
        --device cpu --family gamma --rows 4000

Prints one JSON line: every candidate's CV RMSE (the fold mean; a raced-out
point's is its fold-0 screen), the best CV RMSE per family over the points
that ran every fold, the winner and its params, the refit's train RMSE, its
coefficients' and intercept's largest distance from the truth (a GLM
winner), and the train wall.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from regression_grid_reference import candidates, family_best  # noqa: E402
from transmogrifai_tpu_torch.synthetic import (  # noqa: E402
    GLM_INTERCEPT, glm_true_coef, make_glm_data)

PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}
GLM = "OpGeneralizedLinearRegression"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def glm_models(pkg: str, family: str) -> list:
    """The GLM family over the default regularisation grid, then the
    default LinReg candidates."""
    S = _mod(pkg, "selector")
    lin = _mod(pkg, "models.linear")
    p = S.DefaultSelectorParams
    return [S.ModelCandidate(
        lin.OpGeneralizedLinearRegression(family=family),
        S.grid(reg_param=p.REGULARIZATION, max_iter=p.MAX_ITER_LIN), GLM),
        S._linreg_candidates()]


def batch_of(pkg: str, X, y):
    """The raw columns: ``label`` and RealNN ``f0..f{d-1}``."""
    C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(X.shape[1]):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    return C.ColumnBatch(cols, len(y))


def train(pkg: str, X, y, family: str, **wf_kw):
    """Train the GLM workload's workflow (RealNN features → transmogrify →
    RegressionModelSelector); returns (model, batch, prediction feature,
    wall seconds)."""
    F, S = _mod(pkg, "features"), _mod(pkg, "selector")
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor()
             for i in range(X.shape[1])]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(feats)
    sel = S.RegressionModelSelector(models=glm_models(pkg, family))
    sel.set_input(label, fv)
    pred = sel.get_output()
    batch = batch_of(pkg, X, y)
    wf = _mod(pkg, "workflow").Workflow(**wf_kw).set_input_batch(batch)
    t0 = time.perf_counter()
    model = wf.set_result_features(pred).train()
    return model, batch, pred, time.perf_counter() - t0


def winner_params(model) -> dict:
    """The params of the first candidate with the least CV RMSE over the
    points that ran every fold."""
    rows = [(v, i) for i, (_, _, v, raced) in enumerate(candidates(model))
            if not raced and np.isfinite(v)]
    return candidates(model)[min(rows)[1]][1]


def coef_errors(fitted, d: int) -> dict:
    """The largest |coef - w| and |intercept - 0.3| of a fitted GLM."""
    coef = np.asarray(fitted["coef"], np.float64).reshape(-1)
    inter = float(np.asarray(fitted["intercept"], np.float64).reshape(-1)[0])
    return {"coef_max_abs_err": float(np.abs(coef - glm_true_coef(d)).max()),
            "intercept_abs_err": abs(inter - GLM_INTERCEPT)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--family", choices=("poisson", "gamma"),
                    default="poisson")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch package only)")
    a = ap.parse_args()
    pkg = PACKAGES[a.package]
    wf_kw = {"device": a.device} if a.package == "torch" else {}
    X, y = make_glm_data(a.rows, a.family)
    model, batch, _, wall = train(pkg, X, y, a.family, **wf_kw)
    ev = _mod(pkg, "evaluators").Evaluators.Regression.rmse()
    m = model.evaluate(ev, batch=batch)
    summ = model.selected_model.summary
    best = model.selected_model.best_model
    out = {"package": pkg, "family": a.family, "rows": a.rows,
           "candidates": candidates(model),
           "family_best_cv_rmse": family_best(model),
           "winner": summ.best_model_name,
           "winner_params": winner_params(model),
           "train_rmse": float(m["RootMeanSquaredError"]),
           "train_wall_s": wall}
    if best.fitted.get("kind") == "glm":
        out.update(coef_errors(best.fitted, X.shape[1]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
