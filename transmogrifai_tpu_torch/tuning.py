"""Cross-validation with successive-halving racing (port of the single-device
dense path of ``transmogrifai_tpu/tuning.py``; reference: OpValidator.scala:91,
OpCrossValidation.scala:42).

ONE device-resident data matrix serves every fold: folds are per-row weight
masks, so each candidate family trains its whole (fold × grid) block as one
batched lane program (``fit_arrays_grid``) and is scored by one masked
metric panel.  Racing screens a family's full grid on fold 0, keeps the top
``max(min_survivors, ceil(G/eta))`` points and fits only those on the other
folds.  The JAX package's mesh, memory-governor, supervisor, checkpoint,
AOT and telemetry seams have no counterpart here.
"""

from __future__ import annotations

import copy
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .columns import ColumnBatch, to_device_f32
from .evaluators import OpEvaluatorBase
from .models.trees import predict_trees_sum_grouped

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


def _grid_margins(X: torch.Tensor, C: torch.Tensor, b: torch.Tensor):
    """[N, K] linear margins of K candidates (≙ ``_grid_margins``,
    tuning.py:286-300)."""
    return X @ C.T + b[None, :]


class Splitter:
    """≙ tuning/Splitter.scala (tuning.py:64-89): an optional test holdout,
    reserved before any CV.  The reference's per-class preparation hooks
    come with the balancers that use them."""

    def __init__(self, seed: int = 42, reserve_test_fraction: float = 0.0):
        self.seed = int(seed)
        self.reserve_test_fraction = float(reserve_test_fraction)

    def split(self, batch: ColumnBatch) -> Tuple[ColumnBatch, ColumnBatch]:
        """(train, holdout) rows by the JAX package's permutation draw."""
        n = len(batch)
        perm = np.random.default_rng(self.seed).permutation(n)
        n_test = int(round(n * self.reserve_test_fraction))
        return batch.take_rows(perm[n_test:]), batch.take_rows(perm[:n_test])


class DataSplitter(Splitter):
    """≙ DataSplitter: plain random split, no rebalancing."""


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
        its margin anyway."""
        F, G = len(fitted_grid), len(fitted_grid[0])
        C = torch.stack([fitted_grid[f][g]["coef"]
                         for f in range(F) for g in range(G)])
        b = torch.stack([fitted_grid[f][g]["intercept"].reshape(-1)[0]
                         for f in range(F) for g in range(G)])
        S = _grid_margins(X, C, b)
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
        not)."""
        F, G = len(fitted_grid), len(fitted_grid[0])
        out = np.full((F, G), np.nan)
        groups = defaultdict(list)
        for f in range(F):
            for g in range(G):
                fit = fitted_grid[f][g]
                groups[(f, fit["kind"], tuple(fit["feature"].shape),
                        int(fit["max_depth"]))].append((g, fit))
        for (f, kind, _shape, md), members in groups.items():
            cat = {k: torch.cat([m[k] for _, m in members])
                   for k in ("feature", "threshold", "is_leaf", "leaf")}
            sums = predict_trees_sum_grouped(
                X, cat["feature"], cat["threshold"], cat["is_leaf"],
                cat["leaf"], md + 1, len(members))             # [N, K, V]
            if kind == "forest":
                S = sums[..., 1]
            else:
                eta = torch.tensor([m["eta"] for _, m in members],
                                   dtype=torch.float32, device=X.device)
                base = torch.tensor([m["base"] for _, m in members],
                                    dtype=torch.float32, device=X.device)
                S = torch.sigmoid(base[None, :] + eta[None, :] * sums[..., 0])
            vals = self.evaluator.evaluate_masked_grid(y, S, masks[f])
            for j, (g, _) in enumerate(members):
                out[f, g] = float(vals[j])
        return out

    def _panel(self, fitted_grid, X, y, masks) -> np.ndarray:
        kinds = {fit["kind"] for row in fitted_grid for fit in row}
        if kinds <= {"binary", "svc"}:
            return self._linear_panel(fitted_grid, X, y, masks)
        if kinds <= {"forest", "gbt"}:
            return self._tree_panel(fitted_grid, X, y, masks)
        raise NotImplementedError(f"no CV metric panel for model kinds {kinds}")

    # -- main entry -----------------------------------------------------------
    def validate(self, candidates: Sequence[ModelCandidate], batch: ColumnBatch,
                 label: str, features: str) -> ValidationResult:
        """Run the CV grid over ``batch`` on ``batch.device`` (≙ the
        single-device dense path of ``_validate_impl``, with racing at
        tuning.py:819-875 and :1433-1620)."""
        dev = batch.device
        y_all = np.asarray(batch[label].values, dtype=np.float64)
        splits = self.splits(y_all)
        F = len(splits)
        X = to_device_f32(batch[features].values, dev).contiguous()
        y = to_device_f32(np.asarray(batch[label].values, np.float32), dev)
        assign = np.full(len(y_all), _NO_FOLD, np.uint8)
        for f, (_, va_idx) in enumerate(splits):
            assign[va_idx] = f
        W, VA = _fold_masks_from_assignment(torch.as_tensor(assign, device=dev), F)

        raced = [self.racing and F >= 2
                 and self._survivor_count(len(c.grid)) < len(c.grid)
                 for c in candidates]
        results: Dict[Tuple[int, int], ValidatedCandidate] = {}
        seconds: Dict[str, float] = defaultdict(float)

        def record(cand, ci, gi, params, metric):
            key = (ci, gi)
            if key not in results:
                results[key] = ValidatedCandidate(
                    cand.model_name, dict(params), [], candidate_index=ci)
            results[key].metric_values.append(float(metric))

        def fit_and_score(cand, ci, grid, f0, n_folds, grid_index):
            t0 = device_wall_clock(dev)
            fitted = cand.estimator.fit_arrays_grid(
                X, y, W[f0:f0 + n_folds], grid)
            panel = self._panel(fitted, X, y, VA[f0:f0 + n_folds])
            for f in range(n_folds):
                for j, params in enumerate(grid):
                    record(cand, ci, grid_index[j], params, panel[f, j])
            seconds[cand.model_name] += device_wall_clock(dev) - t0

        # round A: raced families screen the full grid on fold 0; unraced
        # families run their full CV block
        for ci, cand in enumerate(candidates):
            fit_and_score(cand, ci, cand.grid, 0, 1 if raced[ci] else F,
                          list(range(len(cand.grid))))

        # round B: rank each raced family's fold-0 screen in the evaluator's
        # direction (ties and NaNs break by grid position), prune past the
        # survivor floor, fit + score the survivors on the remaining folds
        sign = 1.0 if self.evaluator.is_larger_better else -1.0
        for ci, cand in enumerate(candidates):
            if not raced[ci]:
                continue
            G = len(cand.grid)

            def keyf(gi):
                v = results[(ci, gi)].metric_values[0]
                return sign * v if np.isfinite(v) else -np.inf

            order = sorted(range(G), key=lambda gi: (-keyf(gi), gi))
            S = self._survivor_count(G)
            for gi in order[S:]:
                results[(ci, gi)].raced_out = True
            survivors = sorted(order[:S])
            fit_and_score(cand, ci, [dict(cand.grid[g]) for g in survivors],
                          1, F - 1, survivors)

        all_results = list(results.values())
        scored = [(sign * r.mean_metric, r) for r in all_results
                  if np.isfinite(r.mean_metric) and not r.raced_out]
        if not scored:
            raise RuntimeError("all model candidates failed validation")
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
            family_seconds=dict(seconds))


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
