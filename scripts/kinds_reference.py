"""Numbers of the more-kinds workload in either package: the rows of
``transmogrifai_tpu_torch.synthetic.make_kinds_columns`` (2 Dates, a
DateTime, a DateList, 2 MultiPickLists, a Geolocation, 8 Reals, a RealMap
of 20 keys) → the Reals r0-r3 through ``auto_bucketize(label)``, the
RealMap through ``DecisionTreeNumericMapBucketizer``, r4 through a
fixed-split ``bucketize`` and the DateTime through
``to_time_period("HourOfDay")`` → ``transmogrify`` →
``sanity_check(remove_bad_features=True)`` →
``BinaryClassificationModelSelector(model_types_to_use=
["OpLogisticRegression", "OpGBTClassifier"])`` over the default
candidates, 3-fold CV.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/kinds_reference.py \\
        --package jax --rows 20000
    PYTHONPATH=. python scripts/kinds_reference.py --package torch \\
        --device cpu --rows 20000

The map bucketizer tracks no nulls here (``--map-track-nulls`` turns it
on): with null tracking the JAX package's model writes each split key's
null column twice and its SanityChecker raises ``IndexError``.  Prints
one JSON line: the checked width, each candidate's CV AuPR, the winner,
the train AuROC and the train wall seconds.  Both packages read the same
values (numpy draws from ``--seed``).
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
PACKAGES = {"jax": "transmogrifai_tpu", "torch": "transmogrifai_tpu_torch"}
FAMILIES = ("OpLogisticRegression", "OpGBTClassifier")
FIXED_SPLITS = (-np.inf, -1.0, 0.0, 1.0, np.inf)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def batch(pkg: str, n: int, seed: int = 17, device=None):
    """(batch, schema) of ``n`` rows in package ``pkg`` (the port's batch
    on ``device``)."""
    from transmogrifai_tpu_torch.synthetic import make_kinds_columns
    cols, schema = make_kinds_columns(n, seed=seed)
    C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
    pc = {k: C.Column(getattr(TY, v.kind.__name__), v.values, mask=v.mask)
          for k, v in cols.items()}
    if pkg == PACKAGES["torch"]:
        return C.ColumnBatch(pc, n, device=device), schema
    return C.ColumnBatch(pc, n), schema


def build(pkg: str, b, schema, map_track_nulls: bool = True, device=None,
          **sel_kw):
    """(workflow, prediction feature, checked vector feature) of the
    workload over batch ``b``; ``sel_kw`` go to the selector
    (``model_types_to_use`` defaults to LR and GBT)."""
    F, S, TY = (_mod(pkg, m) for m in ("features", "selector", "types"))
    bk = _mod(pkg, "ops.bucketizers")
    raw = {n: F.FeatureBuilder(n, getattr(TY, k.__name__))
           for n, k in schema.items()}
    label = raw.pop("label").as_response()
    feats = {n: f.as_predictor() for n, f in raw.items()}
    extra = [feats[f"r{j}"].auto_bucketize(label) for j in range(4)]
    mb = bk.DecisionTreeNumericMapBucketizer(track_nulls=map_track_nulls)
    mb.set_input(label, feats["rmap"])
    extra += [mb.get_output(), feats["r4"].bucketize(list(FIXED_SPLITS)),
              feats["dt"].to_time_period("HourOfDay")]
    fv = _mod(pkg, "ops.transmogrify").transmogrify(
        list(feats.values()) + extra)
    checked = label.sanity_check(fv, remove_bad_features=True)
    sel_kw.setdefault("model_types_to_use", list(FAMILIES))
    sel = S.BinaryClassificationModelSelector(**sel_kw)
    sel.set_input(label, checked)
    pred = sel.get_output()
    kw = {"device": device} if pkg == PACKAGES["torch"] else {}
    wf = _mod(pkg, "workflow").Workflow(**kw).set_input_batch(b)
    return wf.set_result_features(pred), pred, checked


def facts(pkg: str, model, b, checked) -> dict:
    """The numbers the card's run is held to."""
    ev = _mod(pkg, "evaluators").Evaluators.BinaryClassification.auROC()
    summ = model.selected_model.summary
    vec = model.score(b, keep_intermediate_features=True)[checked.name]
    return {
        "checked_width": len(vec.meta.columns),
        "cv_aupr": [[r.model_name, json.dumps(r.params, sort_keys=True),
                     float(r.metric_values["AuPR"])]
                    for r in summ.validation_results],
        "winner": summ.best_model_name,
        "validation_type": summ.validation_type,
        "train_auroc": float(model.evaluate(ev, batch=b)["AuROC"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=sorted(PACKAGES), default="jax")
    ap.add_argument("--device", default=None)
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--map-track-nulls", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    pkg = PACKAGES[a.package]
    b, schema = batch(pkg, a.rows, a.seed, a.device)
    wf, _, checked = build(pkg, b, schema, a.map_track_nulls, a.device)
    t0 = time.perf_counter()
    model = wf.train()
    wall = time.perf_counter() - t0
    print(json.dumps({"package": pkg, "rows": a.rows,
                      **facts(pkg, model, b, checked),
                      "train_wall_s": wall}))


if __name__ == "__main__":
    main()
