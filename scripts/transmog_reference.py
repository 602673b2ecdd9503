"""Numbers of the transmogrification workload (``bench.run_transmog``) in
either package: the repository's mixed raw columns (3 free-text columns, 2
PickLists, a RealMap, 4 Reals with nulls) → ``transmogrify`` →
``sanity_check(remove_bad_features=True)`` →
``BinaryClassificationModelSelector`` over ``OpLogisticRegression`` with
``reg_param`` in {0.01, 0.1} and ``max_iter`` 50, with the RawFeatureFilter
on (``min_fill_rate=0.01``).

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/transmog_reference.py \
        --package jax --rows 20000
    PYTHONPATH=. python scripts/transmog_reference.py --package torch \
        --device cpu --rows 20000

Prints one JSON line: the checked width, the columns the SanityChecker
dropped, its Cramér's V per indicator group, each candidate's CV AuPR, the
winner, the train AuROC and the train wall seconds.  The JAX package's data
come from ``bench.make_transmog_columns``, the port's from its own copy
(``transmogrifai_tpu_torch.synthetic``), which gives the same values.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}
REG_PARAMS = (0.01, 0.1)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def columns(pkg: str, n: int, seed: int = 1):
    """(columns, schema) of the workload in package ``pkg``."""
    if pkg == PACKAGES["jax"]:
        sys.path.insert(0, ROOT)
        from bench import make_transmog_columns
    else:
        from transmogrifai_tpu_torch.synthetic import make_transmog_columns
    return make_transmog_columns(n, seed=seed)


def build(pkg: str, cols, schema, n: int, **wf_kw):
    """(workflow, batch, prediction feature) of the workload."""
    F, S = _mod(pkg, "features"), _mod(pkg, "selector")
    label, predictors = F.features_from_schema(schema, response="label")
    fv = _mod(pkg, "ops.transmogrify").transmogrify(predictors)
    checked = label.sanity_check(fv, remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        _mod(pkg, "models.linear").OpLogisticRegression(),
        S.grid(reg_param=list(REG_PARAMS), max_iter=[50]),
        "OpLogisticRegression")])
    sel.set_input(label, checked)
    pred = sel.get_output()
    batch = _mod(pkg, "columns").ColumnBatch(cols, n)
    wf = (_mod(pkg, "workflow").Workflow(**wf_kw).set_input_batch(batch)
          .set_result_features(pred).with_raw_feature_filter(
              min_fill_rate=0.01))
    return wf, batch, pred


def sanity_summary(model):
    return next(s for s in model.stages
                if type(s).__name__ == "SanityCheckerModel").summary


def facts(pkg: str, model, batch) -> dict:
    """The numbers the port is held to: checked width, dropped columns,
    Cramér's V per group (NaN as None), CV AuPR per candidate, winner,
    train AuROC."""
    summ = model.selected_model.summary
    sc = sanity_summary(model)
    ev = _mod(pkg, "evaluators").Evaluators.BinaryClassification.auROC()
    coef = model.selected_model.best_model.fitted["coef"]
    return {
        "width": int(coef.shape[0]),
        "dropped": sorted(sc.dropped),
        "cramers_v": {g: (None if math.isnan(v) else float(v))
                      for g, v in sc.cramers_v_by_group.items()},
        "cv_aupr": {f"reg_param={r.params['reg_param']}":
                    float(next(iter(r.metric_values.values())))
                    for r in summ.validation_results},
        "winner": f"reg_param={_winner(summ)}",
        "train_auroc": float(model.evaluate(ev, batch=batch)["AuROC"]),
    }


def _winner(summ) -> float:
    """The winning grid point's reg_param (the first of the best)."""
    best = max(summ.validation_results,
               key=lambda r: float(next(iter(r.metric_values.values()))))
    return best.params["reg_param"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch package only)")
    a = ap.parse_args()
    pkg = PACKAGES[a.package]
    wf_kw = {"device": a.device} if a.package == "torch" else {}
    cols, schema = columns(pkg, a.rows)
    wf, batch, _ = build(pkg, cols, schema, a.rows, **wf_kw)
    t0 = time.perf_counter()
    model = wf.train()
    wall = time.perf_counter() - t0
    out = {"package": pkg, "rows": a.rows, **facts(pkg, model, batch),
           "train_wall_s": wall}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
