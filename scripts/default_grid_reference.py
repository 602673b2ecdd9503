"""CV numbers of the default binary model grid — what
``BinaryClassificationModelSelector()`` runs with no ``models=`` (LR x8,
RF x18, GBT x18, LinearSVC x4; 3-fold CV ranked by AuPR, racing) — on the
dense workload of ``bench.run_dense`` (``bench.make_data``, seed 0, 28
RealNN features), in either package.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/default_grid_reference.py \
        --package jax --rows 5000
    PYTHONPATH=. python scripts/default_grid_reference.py --package torch \
        --device cpu --rows 5000
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/default_grid_reference.py \
        --package jax --rows 5000 --rf-seeds 42,0,1,2,3

Prints one JSON line: per family the best CV AuPR over the grid points that
ran every fold (racing's fold-0 screen values excluded), the winner, the
train AuROC and the wall seconds.  With ``--rf-seeds`` it trains the default
RF family alone once per forest seed instead (the racing and folds are per
family, so the forest's numbers are those of the full grid) and prints the
seeds' best CV AuPR, their spread and standard deviation.
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

from bench import make_data  # noqa: E402

PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def train(pkg: str, X, y, models=None, **wf_kw):
    """Train the dense workflow with ``BinaryClassificationModelSelector``
    (the default grid when ``models`` is None); returns (model, batch,
    wall seconds)."""
    C, F = _mod(pkg, "columns"), _mod(pkg, "features")
    S, TY = _mod(pkg, "selector"), _mod(pkg, "types")
    D = X.shape[1]
    label = F.FeatureBuilder.RealNN("label").as_response()
    feats = [F.FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    checked = label.sanity_check(_mod(pkg, "ops.transmogrify").transmogrify(
        feats), remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(models=models)
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    batch = C.ColumnBatch(cols, len(y))
    wf = _mod(pkg, "workflow").Workflow(**wf_kw).set_input_batch(batch)
    t0 = time.perf_counter()
    model = wf.set_result_features(pred).train()
    return model, batch, time.perf_counter() - t0


def family_best(model) -> dict:
    """Best CV AuPR per family over the grid points that ran every fold."""
    best: dict = {}
    for r in model.selected_model.summary.validation_results:
        if r.raced_out:
            continue
        v = float(next(iter(r.metric_values.values())))
        if np.isfinite(v) and v > best.get(r.model_name, -np.inf):
            best[r.model_name] = v
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--rows", type=int, default=5000)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch package only)")
    ap.add_argument("--rf-seeds", default="",
                    help="comma-separated forest seeds: train the default "
                         "RF family alone once per seed")
    a = ap.parse_args()
    pkg = PACKAGES[a.package]
    wf_kw = {"device": a.device} if a.package == "torch" else {}
    X, y = make_data(a.rows, 28)
    out = {"package": pkg, "rows": a.rows, "features": 28}
    if a.rf_seeds:
        S = _mod(pkg, "selector")
        seeds = [int(s) for s in a.rf_seeds.split(",")]
        vals, walls = [], []
        for seed in seeds:
            cand = S._rf_classifier()
            cand.estimator.set("seed", seed)
            model, _, wall = train(pkg, X, y, [cand], **wf_kw)
            vals.append(family_best(model)["OpRandomForestClassifier"])
            walls.append(wall)
        out.update(rf_seeds=seeds, rf_best_cv_aupr=vals,
                   spread=max(vals) - min(vals),
                   sd=float(np.std(vals, ddof=1)) if len(vals) > 1 else None,
                   wall_s=walls)
    else:
        model, batch, wall = train(pkg, X, y, **wf_kw)
        ev = _mod(pkg, "evaluators").Evaluators.BinaryClassification.auROC()
        summ = model.selected_model.summary
        out.update(family_best_cv_aupr=family_best(model),
                   winner=summ.best_model_name,
                   train_auroc=float(model.evaluate(ev, batch=batch)["AuROC"]),
                   train_wall_s=wall)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
