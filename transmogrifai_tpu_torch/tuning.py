"""Cross-validation with successive-halving racing (port of the single-device
dense path of ``transmogrifai_tpu/tuning.py``; reference: OpValidator.scala:91,
OpCrossValidation.scala:42).

ONE device-resident data matrix serves every fold: folds are per-row weight
masks, so each candidate family trains its whole (fold × grid) block as one
batched lane program (``fit_arrays_grid``) and is scored by one masked
metric panel.  Racing screens a family's full grid on fold 0, keeps the top
``max(min_survivors, ceil(G/eta))`` points and fits only those on the other
folds.  A ``SparseMatrix`` feature matrix stays sparse throughout (its
margins are ``sp_matmat`` products).  A family that cannot fit the
matrix (trees on a ``SparseMatrix``: ``NotImplementedError`` or
``TypeError``) is skipped as the JAX package skips it (tuning.py:1395-1407,
:1462-1466): its block gets NaN metrics and a "skipped" record in the
result's ``FailureLog``, and ``AllCandidatesFailed`` is raised only when no
candidate has a finite metric.  A family with no batched panel (naive
Bayes, the MLP) is scored candidate by candidate on its ``device_scores``.
A splitter that reweights the training folds (``DataCutter`` dropping
labels) does so through ``validation_prepare_weights`` on the training
weights only; the validation masks stay.  The sweep checkpoint, the
preemption boundaries, the fault-injection seams and workflow-level CV's
in-fold groups are the JAX package's (see ``OpValidator.validate``); its
mesh, memory-governor, supervisor, AOT and telemetry seams have no
counterpart here.
"""

from __future__ import annotations

import copy
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .columns import ColumnBatch, device_matrix, to_device_f32
from .evaluators import OpEvaluatorBase
from .models.trees import predict_trees_sum_grouped
from .resilience import (SKIPPABLE, AllCandidatesFailed, FailureLog,
                         InjectedFault, maybe_inject)
from .sparse.matrix import SparseMatrix

_NO_FOLD = 255      # assignment of a row that is in no validation fold


def device_wall_clock(device: torch.device) -> float:
    """The host clock once ``device`` has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _fold_masks_from_assignment(assign: torch.Tensor, n_folds: int):
    """[N] uint8 validation-fold assignment → (train weights [F, N],
    validation masks [F, N]) f32 (≙ ``_fold_masks_from_assignment``,
    tuning.py:366-385)."""
    f = torch.arange(n_folds, device=assign.device)[:, None]
    a = assign.to(torch.int32)[None, :]
    return (a != f).to(torch.float32), (a == f).to(torch.float32)


def _grid_margins(X, C: torch.Tensor, b: torch.Tensor):
    """[N, K] linear margins of K candidates (≙ ``_grid_margins``,
    tuning.py:286-300); one ``sp_matmat`` for a ``SparseMatrix`` X
    (tuning.py:566-571)."""
    if isinstance(X, SparseMatrix):
        return X.matmat(C.T.contiguous()) + b[None, :]
    return X @ C.T + b[None, :]


def _multinomial_pred_grid(X, C3: torch.Tensor, B: torch.Tensor):
    """[N, K] int32 class predictions of K multinomial candidates (coef
    stack C3 [K, D, C], intercepts B [K, C]): one matmul to the [N, K, C]
    margins and the first largest of each (≙ ``_multinomial_pred_grid``,
    tuning.py:306-330; softmax is monotone, so the margins' argmax is each
    model's prediction)."""
    K, D, C = C3.shape
    m = (X @ C3.permute(1, 0, 2).reshape(D, K * C)).reshape(-1, K, C) + B[None]
    return torch.argmax(m, dim=-1).to(torch.int32)


@dataclass
class SplitterSummary:
    """≙ SplitterSummary: the splitter's name and what it prepared."""
    splitter: str = ""
    info: Dict[str, Any] = field(default_factory=dict)


class Splitter:
    """≙ tuning/Splitter.scala (tuning.py:64-89): an optional test holdout,
    reserved before any CV, and the per-class preparation hooks: before the
    sweep (``pre_validation_prepare``), on the training folds' weights
    (``validation_prepare_weights``) and before the refit
    (``validation_prepare``)."""

    def __init__(self, seed: int = 42, reserve_test_fraction: float = 0.0):
        self.seed = int(seed)
        self.reserve_test_fraction = float(reserve_test_fraction)
        self.summary: Optional[SplitterSummary] = None

    def split(self, batch: ColumnBatch) -> Tuple[ColumnBatch, ColumnBatch]:
        """(train, holdout) rows by the JAX package's permutation draw."""
        n = len(batch)
        perm = np.random.default_rng(self.seed).permutation(n)
        n_test = int(round(n * self.reserve_test_fraction))
        return batch.take_rows(perm[n_test:]), batch.take_rows(perm[:n_test])

    def pre_validation_prepare(self, batch: ColumnBatch,
                               label: str) -> ColumnBatch:
        self.summary = SplitterSummary(type(self).__name__)
        return batch

    def validation_prepare(self, batch: ColumnBatch,
                           label: str) -> ColumnBatch:
        return batch

    def validation_prepare_weights(self, y: np.ndarray,
                                   w: np.ndarray) -> np.ndarray:
        """The training weights of one fold (0 == excluded) as the
        splitter prepares them; ``w`` itself when it changes nothing."""
        return w


class DataSplitter(Splitter):
    """≙ DataSplitter: plain random split, no rebalancing."""


class DataCutter(Splitter):
    """≙ DataCutter.scala (tuning.py:237-283): for a multiclass label, keep
    at most ``max_label_categories`` labels, each with a fraction of the
    rows of at least ``min_label_fraction`` (the most frequent first, ties
    by label); rows of the other labels leave the training folds and the
    refit, and the summary lists both."""

    def __init__(self, max_label_categories: int = 100,
                 min_label_fraction: float = 0.0, seed: int = 42,
                 reserve_test_fraction: float = 0.0):
        super().__init__(seed, reserve_test_fraction)
        self.max_label_categories = int(max_label_categories)
        self.min_label_fraction = float(min_label_fraction)
        self.labels_kept: List[float] = []
        self.labels_dropped: List[float] = []

    def pre_validation_prepare(self, batch, label):
        y = _host_labels(batch, label)
        vals, counts = np.unique(y, return_counts=True)
        frac = counts / max(len(y), 1)
        order = np.argsort(-counts, kind="mergesort")
        keep = [v for i, v in zip(order, vals[order])
                if frac[i] >= self.min_label_fraction
                ][:self.max_label_categories]
        keep_set = set(keep)
        self.labels_kept = sorted(keep_set)
        self.labels_dropped = sorted(set(vals.tolist()) - keep_set)
        self.summary = SplitterSummary("DataCutter", {
            "labelsKept": self.labels_kept,
            "labelsDropped": self.labels_dropped})
        return batch

    def validation_prepare(self, batch, label):
        if not self.labels_dropped:
            return batch
        mask = np.isin(_host_labels(batch, label),
                       np.asarray(self.labels_kept))
        return batch.take_rows(np.flatnonzero(mask))

    def validation_prepare_weights(self, y, w):
        if not self.labels_dropped:
            return w
        mask = np.isin(y, np.asarray(self.labels_kept))
        return np.where(mask, w, 0.0).astype(w.dtype)


def _host_labels(batch: ColumnBatch, label: str) -> np.ndarray:
    v = batch[label].values
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


@dataclass
class ModelCandidate:
    """One estimator + its hyper-parameter grid."""
    estimator: Any
    grid: List[Dict[str, Any]] = field(default_factory=lambda: [{}])
    name: Optional[str] = None

    @property
    def model_name(self) -> str:
        return self.name or type(self.estimator).__name__


@dataclass
class ValidatedCandidate:
    model_name: str
    params: Dict[str, Any]
    metric_values: List[float]
    candidate_index: int = 0
    # pruned by racing after the fold-0 screen: metric_values holds the
    # fold-0 metric only and the point never competes for best
    raced_out: bool = False

    @property
    def mean_metric(self) -> float:
        vals = [v for v in self.metric_values if np.isfinite(v)]
        return float(np.mean(vals)) if vals else float("nan")


@dataclass
class ValidationResult:
    best: ModelCandidate
    best_params: Dict[str, Any]
    best_metric: float
    all_results: List[ValidatedCandidate]
    validation_type: str
    metric_name: str
    is_larger_better: bool
    # wall seconds per candidate family: its fits and CV metric panels
    family_seconds: Dict[str, float] = field(default_factory=dict)
    # the families skipped because they could not fit the matrix
    failure_log: FailureLog = field(default_factory=FailureLog)


class OpValidator:
    """Base validator (≙ OpValidator.scala:91)."""

    validation_type = "validator"

    def __init__(self, evaluator: OpEvaluatorBase, seed: int = 42,
                 stratify: bool = False, racing: bool = True,
                 racing_eta: float = 3.0, racing_min_survivors: int = 2):
        self.evaluator = evaluator
        self.seed = int(seed)
        self.stratify = bool(stratify)
        self.racing = bool(racing)
        self.racing_eta = max(float(racing_eta), 1.0 + 1e-9)
        self.racing_min_survivors = max(int(racing_min_survivors), 1)

    def splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def _stratified_perm(self, y: np.ndarray, rng) -> np.ndarray:
        """Interleave per-class shuffled indices so every contiguous cut is
        label-balanced (≙ stratifyKFolds, OpCrossValidation.scala:184)."""
        iters = []
        for v in np.unique(y):
            idx = np.flatnonzero(y == v)
            rng.shuffle(idx)
            iters.append(iter(idx))
        out = []
        while iters:
            nxt = []
            for it in iters:
                try:
                    out.append(next(it))
                    nxt.append(it)
                except StopIteration:
                    pass
            iters = nxt
        return np.asarray(out, dtype=np.int64)

    def _survivor_count(self, G: int) -> int:
        return max(self.racing_min_survivors, int(np.ceil(G / self.racing_eta)))

    # -- scoring ------------------------------------------------------------
    def _linear_panel(self, fitted_grid, X, y, masks) -> np.ndarray:
        """(fold × grid) metrics of a linear family: one margin matmul and
        one masked metric panel (≙ ``_record_grid_metrics_batched``,
        tuning.py:505-580).  AUC metrics are rank-invariant, so raw margins
        stand in for the sigmoid scores of logistic lanes; an SVC scores on
        its margin anyway; a linear regression's margins ARE its
        predictions (tuning.py:574-581).  An evaluator that ranks
        predictions gets class ids: a multinomial family's from
        ``_multinomial_pred_grid``, a binary one's ``margin > 0``."""
        F, G = len(fitted_grid), len(fitted_grid[0])
        fits = [fitted_grid[f][g] for f in range(F) for g in range(G)]
        kinds = {fit["kind"] for fit in fits}
        if kinds == {"multinomial"}:
            if self.evaluator.grid_panel_input != "predictions":
                raise NotImplementedError(
                    "a multinomial family needs an evaluator that ranks "
                    "class predictions")
            if isinstance(X, SparseMatrix):
                raise TypeError("multinomial panels take a dense matrix")
            S = _multinomial_pred_grid(
                X, torch.stack([fit["coef"] for fit in fits]),
                torch.stack([fit["intercept"].reshape(-1) for fit in fits]))
        else:
            S = _grid_margins(
                X, torch.stack([fit["coef"] for fit in fits]),
                torch.stack([fit["intercept"].reshape(-1)[0]
                             for fit in fits]))
            if (self.evaluator.grid_panel_input == "predictions"
                    and kinds <= {"binary", "svc"}):
                S = (S > 0).to(torch.int32)
        return self.evaluator.evaluate_masked_fold_grid(
            y, S.reshape(S.shape[0], F, G), masks).cpu().numpy()

    def _tree_panel(self, fitted_grid, X, y, masks) -> np.ndarray:
        """(fold × grid) metrics of a GBT or forest family (≙
        ``_record_tree_grid_metrics``, tuning.py:618-700): per (fold, kind,
        tree shape) group the members' tree stacks concatenate and ONE walk
        sums each member's leaves.  A forest scores on its class-1 leaf sum,
        as the JAX package ranks it (f32 rounding makes ties differ between
        that sum and the normalised mean, and AUC sees ties); a GBT on
        sigmoid(base + eta·sum) in f32, exactly as the per-candidate path
        scores it (f32 saturation makes tie groups that the raw sums would
        not).  Regressors give their predictions as they are
        (tuning.py:644-646, :671-689): a forest's leaf sum over its trees,
        a GBT's base + eta·sum.  An evaluator that ranks predictions gets
        class ids (tuning.py:664-670, :683-685): a classifier forest's first
        largest summed class mass, a GBT's ``margin > 0``."""
        F, G = len(fitted_grid), len(fitted_grid[0])
        out = np.full((F, G), np.nan)
        predictions = self.evaluator.grid_panel_input == "predictions"
        groups = defaultdict(list)
        for f in range(F):
            for g in range(G):
                fit = fitted_grid[f][g]
                groups[(f, fit["kind"], tuple(fit["feature"].shape),
                        int(fit["max_depth"]))].append((g, fit))
        for (f, kind, shape, md), members in groups.items():
            cat = {k: torch.cat([m[k] for _, m in members])
                   for k in ("feature", "threshold", "is_leaf", "leaf")}
            sums = predict_trees_sum_grouped(
                X, cat["feature"], cat["threshold"], cat["is_leaf"],
                cat["leaf"], md + 1, len(members))             # [N, K, V]
            regression = members[0][1].get("task") == "regression"
            if kind == "forest":
                if regression:
                    S = sums[..., 0] / float(shape[0])
                elif predictions:
                    S = torch.argmax(sums, dim=-1).to(torch.int32)
                else:
                    S = sums[..., 1]
            else:
                eta = torch.tensor([m["eta"] for _, m in members],
                                   dtype=torch.float32, device=X.device)
                base = torch.tensor([m["base"] for _, m in members],
                                    dtype=torch.float32, device=X.device)
                S = base[None, :] + eta[None, :] * sums[..., 0]
                if not regression:
                    S = ((S > 0).to(torch.int32) if predictions
                         else torch.sigmoid(S))
            vals = self.evaluator.evaluate_masked_grid(y, S, masks[f])
            for j, (g, _) in enumerate(members):
                out[f, g] = float(vals[j])
        return out

    def _candidate_panel(self, cand, grid, fitted_grid, X, y,
                         masks) -> np.ndarray:
        """(fold × grid) metrics one candidate at a time, for a family with
        no batched panel: each fitted model's ``device_scores`` through the
        evaluator's ``evaluate_masked`` (≙ ``device_metric``,
        tuning.py:910-922)."""
        est = cand.estimator
        out = np.full((len(fitted_grid), len(grid)), np.nan)
        for f, row in enumerate(fitted_grid):
            for g, fit in enumerate(row):
                model = est.model_cls(fitted=fit,
                                      **{**est._params, **grid[g]})
                out[f, g] = self.evaluator.evaluate_masked(
                    y, model.device_scores(X), masks[f])
        return out

    def _panel(self, cand, grid, fitted_grid, X, y, masks) -> np.ndarray:
        kinds = {fit["kind"] for row in fitted_grid for fit in row}
        if (kinds <= {"binary", "svc"} or kinds == {"regression"}
                or kinds == {"multinomial"}):
            return self._linear_panel(fitted_grid, X, y, masks)
        if kinds <= {"forest", "gbt"}:
            return self._tree_panel(fitted_grid, X, y, masks)
        return self._candidate_panel(cand, grid, fitted_grid, X, y, masks)

    # -- main entry -----------------------------------------------------------
    def validate(self, candidates: Sequence[ModelCandidate], batch: ColumnBatch,
                 label: str, features: str,
                 splitter: Optional[Splitter] = None, *,
                 in_fold_dag: Optional[List[List[Any]]] = None,
                 sweep=None, log: Optional[FailureLog] = None
                 ) -> ValidationResult:
        """Run the CV grid over ``batch`` on ``batch.device`` (≙
        ``_validate_impl``'s single-device path, with racing at
        tuning.py:819-875 and :1433-1620).  ``splitter`` prepares each
        training fold's weights (tuning.py:1162-1180).

        ``log`` is the train's ``FailureLog`` (a new one when None).
        ``sweep`` is a ``checkpoint.SweepCheckpoint``: a family whose
        signature it holds is replayed, recorded "resumed" (tuning.py:
        855-895), and every family completed here is flushed to it, an
        unraced one after round A with its fitted grid, a raced one after
        round B without (:1006-1027, :1526-1634); a failed flush is
        recorded "degraded" and the sweep goes on.  At each family's round-A
        and round-B boundary a requested stop (``shutdown_requested``,
        sticky) wins over starting it, and once the completed families are
        flushed ``TrainingPreempted`` is raised.  ``in_fold_dag`` is the
        workflow-CV 'during' DAG: each fold is its own group, whose feature
        matrix comes from a deep copy of the DAG fit on the fold's training
        rows and applied to every row, one fold's matrix resident at a
        time (:951-970); such a sweep runs unraced, with a "degraded"
        record, and takes no checkpoint (:829-841, :868)."""
        from .checkpoint import TrainingPreempted, shutdown_requested
        log = log if log is not None else FailureLog()
        dev = batch.device
        y_all = np.asarray(batch[label].values, dtype=np.float64)
        splits = self.splits(y_all)
        F = len(splits)
        race_path_ok = not in_fold_dag and F >= 2
        if self.racing and not race_path_ok:
            reason = ("in-fold DAG refits feature stages per fold"
                      if in_fold_dag else
                      "single train/validation split (racing needs >= 2 "
                      "folds)")
            log.record("validator", "degraded", f"racing disabled: {reason}",
                       point="selector.racing",
                       validation_type=self.validation_type)
        raced = [self.racing and race_path_ok
                 and self._survivor_count(len(c.grid)) < len(c.grid)
                 for c in candidates]
        results: Dict[Tuple[int, int], ValidatedCandidate] = {}
        seconds: Dict[str, float] = defaultdict(float)

        if in_fold_dag:
            sweep = None
        sigs: List[str] = []
        replayed = set()
        if sweep is not None:
            for ci, cand in enumerate(candidates):
                racing = ({"enabled": True, "eta": self.racing_eta,
                           "minSurvivors": self.racing_min_survivors}
                          if raced[ci] else {"enabled": False})
                sig = sweep.candidate_signature(cand.model_name, ci,
                                                cand.grid, racing=racing)
                sigs.append(sig)
                stored = sweep.results_for(sig)
                if stored is None:
                    continue
                replayed.add(ci)
                for gi, r in enumerate(stored):
                    results[(ci, gi)] = ValidatedCandidate(
                        cand.model_name, dict(r.get("params") or {}),
                        [float(v) for v in (r.get("metricValues") or [])],
                        candidate_index=ci,
                        raced_out=bool(r.get("racedOut", False)))
                log.record(cand.model_name, "resumed",
                           f"replayed {len(stored)} grid point(s) from "
                           "sweep checkpoint", point="checkpoint.load",
                           candidate_index=ci)
        live = [ci for ci in range(len(candidates)) if ci not in replayed]
        preempted: List[str] = []

        def record(cand, ci, gi, params, metric):
            key = (ci, gi)
            if key not in results:
                results[key] = ValidatedCandidate(
                    cand.model_name, dict(params), [], candidate_index=ci)
            results[key].metric_values.append(float(metric))

        def checkpoint_family(ci, cand, fitted_grid):
            entry = [{"params": r.params, "metricValues": r.metric_values,
                      "racedOut": r.raced_out}
                     for r in (results.get((ci, gi))
                               for gi in range(len(cand.grid)))
                     if r is not None]
            try:
                sweep.record_candidate(sigs[ci], cand.model_name, ci, entry,
                                       fitted_grid=fitted_grid)
                sweep.flush()
            except Exception as e:  # noqa: BLE001 — durability only
                log.record(cand.model_name, "degraded", e,
                           point="checkpoint.save",
                           fallback="sweep continues unpersisted")

        def fold_groups():
            """(feature matrix, fold splits) groups: one matrix for every
            fold, or with ``in_fold_dag`` one per fold, made from that
            fold's refit of the DAG."""
            if not live:
                return
            if not in_fold_dag:
                yield device_matrix(batch[features].values, dev), splits
                return
            from .dag import apply_dag, fit_dag
            # the DAG's own inputs only: take_rows copies every column
            made = {f.name for layer in in_fold_dag for s in layer
                    for f in s.output_features}
            inputs = batch.select(sorted(
                ({f.name for layer in in_fold_dag for s in layer
                  for f in s.input_features} | {label, features}) - made))
            for tr_idx, va_idx in splits:
                dag_copy = [[copy.deepcopy(s) for s in layer]
                            for layer in in_fold_dag]
                # nothing of the training rows' batch outlives the fit
                fitted_dag = fit_dag(inputs.take_rows(tr_idx), dag_copy)[1]
                yield (device_matrix(apply_dag(inputs, fitted_dag)[features]
                                     .values, dev), [(tr_idx, va_idx)])

        y = to_device_f32(np.asarray(batch[label].values, np.float32), dev)
        for X, fsplits in fold_groups():
            W, VA = self._fold_masks(fsplits, len(y_all), y_all, splitter,
                                     dev)
            Fg = len(fsplits)

            def fit_and_score(cand, ci, grid, f0, n_folds, grid_index):
                t0 = device_wall_clock(dev)
                try:
                    maybe_inject("selector.candidate_fit",
                                 key=cand.model_name)
                    fitted = cand.estimator.fit_arrays_grid(
                        X, y, W[f0:f0 + n_folds], grid)
                except SKIPPABLE as e:
                    # the family cannot fit this matrix: NaN rows, one record
                    log.record(cand.model_name, "skipped", e,
                               point="selector.candidate_fit",
                               folds=list(range(f0, f0 + n_folds)),
                               grid_indices=list(grid_index))
                    fitted = None
                panel = np.full((n_folds, len(grid)), np.nan)
                if fitted is not None:
                    try:
                        maybe_inject("selector.candidate_metric",
                                     key=cand.model_name)
                        panel = self._panel(cand, grid, fitted, X, y,
                                            VA[f0:f0 + n_folds])
                    except InjectedFault as e:
                        log.record(cand.model_name, "skipped", e,
                                   point="selector.candidate_metric",
                                   folds=list(range(f0, f0 + n_folds)))
                for f in range(n_folds):
                    for j, params in enumerate(grid):
                        record(cand, ci, grid_index[j], params, panel[f, j])
                seconds[cand.model_name] += device_wall_clock(dev) - t0
                return fitted

            # round A: raced families screen the full grid on fold 0;
            # unraced families run their full CV block and are checkpointed
            for ci, cand in enumerate(candidates):
                if ci in replayed:
                    continue
                if shutdown_requested(key=cand.model_name):
                    preempted.append(cand.model_name)
                    continue
                fitted = fit_and_score(cand, ci, cand.grid, 0,
                                       1 if raced[ci] else Fg,
                                       list(range(len(cand.grid))))
                if sweep is not None and not raced[ci]:
                    checkpoint_family(ci, cand, fitted)
                del fitted

            # round B: rank each raced family's fold-0 screen in the
            # evaluator's direction (ties and NaNs break by grid position),
            # prune past the survivor floor, fit + score the survivors on
            # the remaining folds
            sign = 1.0 if self.evaluator.is_larger_better else -1.0
            for ci, cand in enumerate(candidates):
                if not raced[ci] or ci in replayed \
                        or cand.model_name in preempted:
                    continue
                G = len(cand.grid)

                def keyf(gi):
                    v = results[(ci, gi)].metric_values[0]
                    return sign * v if np.isfinite(v) else -np.inf

                order = sorted(range(G), key=lambda gi: (-keyf(gi), gi))
                S = self._survivor_count(G)
                for gi in order[S:]:
                    results[(ci, gi)].raced_out = True
                if shutdown_requested(key=cand.model_name):
                    preempted.append(cand.model_name)
                    continue
                survivors = sorted(order[:S])
                fit_and_score(cand, ci, [dict(cand.grid[g])
                                         for g in survivors],
                              1, F - 1, survivors)
                if sweep is not None:
                    checkpoint_family(ci, cand, None)
            del X, W, VA

        if preempted:
            raise TrainingPreempted(
                "selector sweep stopped before candidate(s) "
                + ", ".join(sorted(set(preempted))),
                resume_from=sweep.path if sweep is not None else None)

        all_results = list(results.values())
        sign = 1.0 if self.evaluator.is_larger_better else -1.0
        scored = [(sign * r.mean_metric, r) for r in all_results
                  if np.isfinite(r.mean_metric) and not r.raced_out]
        if not scored:
            causes = {e.stage: e.cause for e in log.events
                      if e.point.startswith("selector.") and e.cause}
            for cand in candidates:
                causes.setdefault(cand.model_name,
                                  "no finite validation metric")
            raise AllCandidatesFailed(
                "all model candidates failed validation", causes)
        _, best_res = max(scored, key=lambda t: t[0])
        best_est = copy.deepcopy(candidates[best_res.candidate_index].estimator)
        for k, v in best_res.params.items():
            best_est.set(k, v)
        return ValidationResult(
            best=ModelCandidate(best_est, [dict(best_res.params)],
                                best_res.model_name),
            best_params=dict(best_res.params),
            best_metric=best_res.mean_metric,
            all_results=all_results,
            validation_type=self.validation_type,
            metric_name=self.evaluator.default_metric,
            is_larger_better=self.evaluator.is_larger_better,
            family_seconds=dict(seconds), failure_log=log)

    def _fold_masks(self, splits, n: int, y_all: np.ndarray,
                    splitter: Optional[Splitter], dev):
        """(training weights [F, N], validation masks [F, N]) of ``splits``
        from one uint8 fold assignment, the training weights prepared by
        ``splitter`` when it reweights them."""
        F = len(splits)
        assign = np.full(n, _NO_FOLD, np.uint8)
        for f, (_, va_idx) in enumerate(splits):
            assign[va_idx] = f
        W, VA = _fold_masks_from_assignment(
            torch.as_tensor(assign, device=dev), F)
        if splitter is not None and (
                type(splitter).validation_prepare_weights
                is not Splitter.validation_prepare_weights):
            rows = [(assign != f).astype(np.float32) for f in range(F)]
            prepared = [splitter.validation_prepare_weights(y_all, w)
                        for w in rows]
            if any(p is not w for p, w in zip(prepared, rows)):
                W = torch.as_tensor(np.stack(prepared), dtype=torch.float32,
                                    device=dev)
        return W, VA


class OpCrossValidation(OpValidator):
    """k-fold CV (≙ OpCrossValidation.scala:42); default 3 folds."""

    validation_type = "CrossValidation"

    def __init__(self, num_folds: int = 3,
                 evaluator: Optional[OpEvaluatorBase] = None, seed: int = 42,
                 stratify: bool = False, **kw):
        super().__init__(evaluator, seed, stratify, **kw)
        self.num_folds = int(num_folds)

    def splits(self, y: np.ndarray):
        """The JAX package's permutation draw (tuning.py:1688-1699), so the
        folds match it bit for bit."""
        n = len(y)
        rng = np.random.default_rng(self.seed)
        perm = self._stratified_perm(y, rng) if self.stratify else rng.permutation(n)
        folds = np.array_split(perm, self.num_folds)
        return [(np.concatenate([folds[j] for j in range(self.num_folds)
                                 if j != i]), folds[i])
                for i in range(self.num_folds)]


class OpTrainValidationSplit(OpValidator):
    """One train / validation split (≙ OpTrainValidationSplit.scala);
    default 75 / 25.  The JAX package's permutation draw (tuning.py:
    1710-1717), so the split matches it bit for bit.  A single split runs
    unraced ("degraded" at ``selector.racing``: racing needs two folds)."""

    validation_type = "TrainValidationSplit"

    def __init__(self, train_ratio: float = 0.75,
                 evaluator: Optional[OpEvaluatorBase] = None, seed: int = 42,
                 stratify: bool = False, **kw):
        super().__init__(evaluator, seed, stratify, **kw)
        self.train_ratio = float(train_ratio)

    def splits(self, y: np.ndarray):
        n = len(y)
        rng = np.random.default_rng(self.seed)
        perm = self._stratified_perm(y, rng) if self.stratify else rng.permutation(n)
        n_tr = int(round(n * self.train_ratio))
        return [(perm[:n_tr], perm[n_tr:])]
