"""Per-row explanations (port of ``transmogrifai_tpu/record_insights.py``;
reference: core/src/main/scala/com/salesforce/op/stages/impl/insights/
RecordInsightsLOCO.scala:100-240 and RecordInsightsCorr.scala:56-225).

``RecordInsightsLOCO`` (leave one covariate out) re-scores each row with each
raw-feature group's columns zeroed and reports the K groups whose removal
moves the score most.  On the card a linear model runs the
``loco_linear`` kernel, a tree ensemble ``loco_tree`` and a model scored by
its softmax (multinomial LR, naive Bayes, the MLP) ``loco_softmax``
(``insights_kernels.py``), each reading X once and keeping every row's top K
as it goes; on the CPU they run their plain twin.  A model with no
``device_scores`` (host-only) takes the numpy loop ``_host_topk``.  Only the
[N, K] (group, diff) pairs reach the host, where ``_assemble_maps`` formats
the reference's RecordInsightsParser payloads.

``RecordInsightsCorr`` correlates each feature with each score column at fit
time and, per row, reports the K features of largest |normalised value x
correlation|: a reduction, a matrix product and a per-row top-K, in plain
PyTorch on the batch's device.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .columns import Column, ColumnBatch, device_matrix, to_device_f32
from .sparse.matrix import SparseMatrix
from .stages.base import Estimator, Transformer, TransformerModel
from .types import OPVector, TextMap
from .vector_meta import VectorMeta, group_key


def loco_groups(meta: Optional[VectorMeta], d: int) -> Dict[str, List[int]]:
    """Group name -> column indices: one group per :func:`group_key` when
    the vector meta covers the matrix, one per column (``f_<i>``) when there
    is none (≙ ``RecordInsightsLOCO._groups``, record_insights.py:68-80)."""
    if meta is not None and meta.size == d:
        out: Dict[str, List[int]] = {}
        for c in meta.columns:
            out.setdefault(group_key(c), []).append(c.index)
        return out
    if meta is not None:
        raise ValueError(
            f"RecordInsightsLOCO: vector meta covers {meta.size} columns "
            f"but the matrix has {d}")
    return {f"f_{i}": [i] for i in range(d)}


def _has_device_scores(model) -> bool:
    from .models.base import PredictionModel
    from .selector import SelectedModel
    if isinstance(model, SelectedModel):
        model = model.best_model
    fn = getattr(type(model), "device_scores", None)
    return fn is not None and fn is not PredictionModel.device_scores


class RecordInsightsLOCO(Transformer):
    """Inputs: (features OPVector); ``model`` is the fitted model stage to
    explain.  Output: a TextMap per row of group name -> ``[["name",
    diff]]`` JSON (the reference's RecordInsightsParser format), for the
    ``top_k`` groups (clamped to [1, G]) ranked by ``strategy``: "abs"
    (|diff|), "positive" (diff) or "negative" (-diff), where diff = base
    score - the score with the group's columns zeroed.  The score is the
    model's ``scores`` (logistic p1, SVC margin, GBT p1, binary forest p1),
    else ``probability[:, -1]``, else ``prediction`` (a regressor's: never
    a sigmoid of it)."""

    in_kinds = (OPVector,)
    out_kind = TextMap
    # the kernels write on the device; the maps are host strings
    is_device_op = False

    def __init__(self, model=None, top_k: int = 20, strategy: str = "abs",
                 **params):
        super().__init__(top_k=top_k, strategy=strategy, **params)
        self.model = model

    # -- scoring ------------------------------------------------------------
    def _host_score(self, X: np.ndarray) -> np.ndarray:
        pred = self.model.predict_arrays(X)
        prob = pred.get("probability")
        if prob is not None:
            p = np.asarray(prob)
            return p[:, -1] if p.ndim == 2 else p
        return np.asarray(pred["prediction"], dtype=np.float64)

    def _device_topk(self, X: torch.Tensor, groups: Sequence[Sequence[int]],
                     k: int, strategy: str) -> Tuple[np.ndarray, np.ndarray]:
        """The model's LOCO kernel (the twin on the CPU) → host [N, K]
        (group index int64, diff float64)."""
        from .insights_kernels import col_group_of, model_loco
        cg = col_group_of(groups, X.shape[1], X.device)
        idx, val = model_loco(self.model, X, cg, len(groups), k, strategy)
        return (idx.cpu().numpy().astype(np.int64),
                val.cpu().numpy().astype(np.float64))

    def _host_topk(self, X: np.ndarray, masks: np.ndarray, k: int,
                   strategy: str) -> Tuple[np.ndarray, np.ndarray]:
        """≙ ``_host_topk`` (record_insights.py:171-191), for models without
        ``device_scores``."""
        base = self._host_score(X)
        G = masks.shape[0]
        Dn = np.empty((len(X), G), np.float64)
        for g in range(G):
            Dn[:, g] = base - self._host_score(X * masks[g][None, :])
        if strategy == "positive":
            rank = Dn
        elif strategy == "negative":
            rank = -Dn
        else:
            rank = np.abs(Dn)
        part = np.argpartition(-rank, k - 1, axis=1)[:, :k]
        sub = np.take_along_axis(rank, part, axis=1)
        order = np.argsort(-sub, axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1)
        val = np.take_along_axis(Dn, idx, axis=1)
        return idx, val

    # -- stage --------------------------------------------------------------
    def transform(self, batch: ColumnBatch) -> Column:
        (vec_f,) = self.input_features
        col = batch[vec_f.name]
        xv = col.values
        if isinstance(xv, SparseMatrix):
            # the JAX package densifies the vector for its masked forwards
            # and its SparseMatrix refuses (columns.to_device_f32 ->
            # SparseMatrix.__array__): the same TypeError here
            raise TypeError(
                "refusing to densify SparseMatrix implicitly "
                f"(shape {xv.shape}); call .to_dense() explicitly")
        n, d = int(xv.shape[0]), int(xv.shape[1])
        groups = loco_groups(col.meta, d)
        names = list(groups)
        G = len(names)
        k = max(1, min(int(self.get("top_k", 20)), G))
        strategy = self.get("strategy", "abs")
        if strategy not in ("abs", "positive", "negative"):
            raise ValueError(f"RecordInsightsLOCO: strategy {strategy!r}")
        if _has_device_scores(self.model):
            X = device_matrix(xv, batch.device)
            idx, val = self._device_topk(X, list(groups.values()), k,
                                         strategy)
        else:
            masks = np.ones((G, d), np.float32)
            for gi, cols in enumerate(groups.values()):
                masks[gi, cols] = 0.0
            X = (xv.cpu().numpy() if isinstance(xv, torch.Tensor)
                 else np.asarray(xv, dtype=np.float32))
            idx, val = self._host_topk(X.astype(np.float32), masks, k,
                                       strategy)
        return Column(TextMap, _assemble_maps(idx, val, names, n))


def _assemble_maps(idx: np.ndarray, val: np.ndarray, names: Sequence[str],
                   n: int, native: bool = True) -> np.ndarray:
    """[N, K] (group index, diff) → object array of per-row {name:
    '[["name", diff]]'} maps, the JAX package's strings bit for bit
    (record_insights.py:217-262).  With json-safe names and finite diffs
    the native formatter (``native/locofmt.cpp``) does it in one C pass;
    ``native=False`` asks for the numpy formatter, which the JAX package
    takes where its native build is missing."""
    clean = (all(_json_plain(p) for p in names)
             and bool(np.isfinite(val).all()))
    if clean and native:
        from .native import load
        return load("locofmt").assemble(
            np.ascontiguousarray(idx, np.int64),
            np.ascontiguousarray(val, np.float64), list(names))
    names_u = np.asarray(names)                            # unicode [G]
    nm = names_u[idx]                                      # [N, K]
    if not clean:
        payload = np.frompyfunc(_entry_json, 2, 1)(nm, val)
    else:
        val_str = val.astype(np.str_)                      # full-width repr
        payload = np.char.add(
            np.char.add(np.char.add('[["', nm), '", '),
            np.char.add(val_str, "]]"))
    out = np.empty(n, dtype=object)
    out[:] = [dict(zip(a, b))
              for a, b in zip(nm.tolist(), payload.tolist())]
    return out


def _json_plain(name: str) -> bool:
    """True when the name needs no JSON escaping."""
    return '"' not in name and "\\" not in name and name.isprintable()


def _entry_json(name: str, diff: float) -> str:
    """``[[name, diff]]`` — the reference's RecordInsightsParser payload."""
    diff = float(diff)
    if not _json_plain(name) or not np.isfinite(diff):
        return json.dumps([[name, diff]])
    return f'[["{name}", {diff}]]'


# --------------------------------------------------------------------------
# RecordInsightsCorr (≙ record_insights.py:270-429)
# --------------------------------------------------------------------------

def corr_fit(X: torch.Tensor, P: torch.Tensor, spearman: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature min / max / mean / var (ddof=1) [4, D] and the [P, D]
    correlation of every feature with every score column (Pearson, or
    Spearman on average ranks), the denominator clamped at 1e-12 (≙ the
    fit program, record_insights.py:277-302)."""
    Xf = X.to(torch.float32)
    Pf = P.to(torch.float32)
    stats = torch.stack([Xf.amin(dim=0), Xf.amax(dim=0), Xf.mean(dim=0),
                         Xf.var(dim=0, unbiased=True)])
    if spearman:
        from .preparators.sanity_checker import _rank_transform
        Xs, Ps = _rank_transform(Xf), _rank_transform(Pf)
    else:
        Xs, Ps = Xf, Pf
    Xc = Xs - Xs.mean(dim=0)
    Pc = Ps - Ps.mean(dim=0)
    xsd = torch.sqrt(torch.sum(Xc * Xc, dim=0))
    psd = torch.sqrt(torch.sum(Pc * Pc, dim=0))
    corr = torch.matmul(Pc.T, Xc) / torch.clamp(psd[:, None] * xsd[None, :],
                                                 min=1e-12)
    return stats, corr


def _scores_matrix(col: Column, device) -> torch.Tensor:
    """[N, P] score columns of an OPVector or Prediction column (the
    probability, else the prediction)."""
    vals = col.values
    if isinstance(vals, dict):
        v = vals.get("probability", vals.get("prediction"))
    else:
        v = vals
    v = to_device_f32(v, device)
    return v if v.ndim == 2 else v[:, None]


class RecordInsightsCorr(Estimator):
    """Correlation-based record insights (≙ RecordInsightsCorr.scala:56).

    Inputs: (prediction OPVector/Prediction, features OPVector).  Fit
    computes the [P, D] score-feature correlations and the normaliser's
    moments; the model's transform emits per row the top-K features by
    |normalised value x correlation| for each score column, as a TextMap of
    name -> ``[[scoreIndex, importance], ...]``.  ``norm_type`` in
    {minmax, znorm, minmax_centered}, ``correlation_type`` in {pearson,
    spearman}."""

    out_kind = TextMap

    def __init__(self, top_k: int = 20, norm_type: str = "minmax",
                 correlation_type: str = "pearson", **params):
        super().__init__(top_k=top_k, norm_type=norm_type,
                         correlation_type=correlation_type, **params)

    def fit(self, batch: ColumnBatch) -> "RecordInsightsCorrModel":
        pred_f, vec_f = self.input_features
        dev = batch.device
        X = device_matrix(batch[vec_f.name].values, dev)
        P = _scores_matrix(batch[pred_f.name], dev)
        spearman = self.get("correlation_type", "pearson") == "spearman"
        stats, corr = corr_fit(X, P, spearman)
        mn, mx, mean, var = stats.cpu().numpy().astype(np.float64)
        norm_type = self.get("norm_type", "minmax")
        if norm_type == "minmax":
            s1, s2, offset = mn, mx - mn, 0.0
        elif norm_type == "znorm":
            s1, s2, offset = mean, np.sqrt(var), 0.0
        elif norm_type == "minmax_centered":
            s1, s2, offset = mn, (mx - mn) / 2.0, 1.0
        else:
            raise ValueError(f"unknown norm_type {norm_type!r}")
        model = RecordInsightsCorrModel(fitted={
            "corr": corr.cpu().numpy().astype(np.float64), "s1": s1,
            "s2": s2, "offset": float(offset)},
            top_k=int(self.get("top_k", 20)))
        return self._finalize_model(model)


# rows of the [rows, D] importance block one top-K pass holds
CORR_ROW_CHUNK = 1 << 18


def corr_topk(X: torch.Tensor, corr: torch.Tensor, s1: torch.Tensor,
              s2: torch.Tensor, offset: float, k: int,
              row_chunk: int = CORR_ROW_CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per score column p and row: the k features of largest |Xn * c_p|
    (Xn the normalised row; 0 where s2 = 0), ties to the lower feature as
    ``lax.top_k`` breaks them (a stable sort: ``torch.topk`` leaves tie
    order open), over row chunks so that one [rows, D] block is live at a
    time (≙ record_insights.py:310-331).  Returns (idx int64, importance
    f32), each [P, N, k]."""
    N = X.shape[0]
    Pn = corr.shape[0]
    idx = torch.empty((Pn, N, k), dtype=torch.int64, device=X.device)
    val = torch.empty((Pn, N, k), dtype=torch.float32, device=X.device)
    zero = s2 == 0.0
    for r0 in range(0, N, row_chunk):
        Xb = X[r0:r0 + row_chunk].to(torch.float32)
        Xn = torch.where(zero, 0.0,
                         (Xb - s1) / torch.where(zero, 1.0, s2) - offset)
        for p in range(Pn):
            imp = Xn * corr[p][None, :]
            top = torch.sort(imp.abs(), dim=1, descending=True,
                             stable=True).indices[:, :k]
            idx[p, r0:r0 + row_chunk] = top
            val[p, r0:r0 + row_chunk] = torch.gather(imp, 1, top)
    return idx, val


class RecordInsightsCorrModel(TransformerModel):
    """The fitted correlations and normaliser: ``fitted`` holds ``corr``
    [P, D], ``s1``, ``s2`` [D] and ``offset``."""

    out_kind = TextMap
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        _, vec_f = self.input_features
        col = batch[vec_f.name]
        dev = batch.device
        X = device_matrix(col.values, dev)
        n, d = int(X.shape[0]), int(X.shape[1])
        meta = col.meta
        names = (meta.column_names() if meta is not None and meta.size == d
                 else [f"f_{i}" for i in range(d)])
        k = max(1, min(int(self.get("top_k", 20)), d))
        f = self.fitted

        def dev32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        idx, val = corr_topk(X, dev32(f["corr"]), dev32(f["s1"]),
                             dev32(f["s2"]), float(np.float32(f["offset"])),
                             k)
        return Column(TextMap, _assemble_corr(idx.cpu().numpy(),
                                              val.cpu().numpy(), names, n))


def _json_floats(v: np.ndarray) -> np.ndarray:
    """``json.dumps``' text of each float64: the shortest repr (numpy's
    float64 ``str`` is Python's ``repr``), NaN and +-Infinity spelled as
    json spells them."""
    out = v.astype(np.str_)
    if not np.isfinite(v).all():
        out = np.where(np.isnan(v), "NaN", out)
        out = np.where(np.isposinf(v), "Infinity", out)
        out = np.where(np.isneginf(v), "-Infinity", out)
    return out


def _assemble_corr(idx: np.ndarray, val: np.ndarray, names: Sequence[str],
                   n: int) -> np.ndarray:
    """[P, N, K] (feature, importance) → per-row {name: '[[p, v], ...]'}
    maps, the JAX package's ``json.dumps`` strings bit for bit
    (record_insights.py:412-429): a name's pairs in score-column order,
    names in order of first appearance (column 0's K, then the new ones of
    column 1, ...).  The strings are built with numpy's string ops, every
    entry of a name carrying the name's whole payload, so that each row's
    dict is one ``dict(zip(...))``: a repeated key keeps its first place
    and takes the same payload again."""
    val = val.astype(np.float64)
    P, N, K = idx.shape
    pair = np.char.add(np.char.add(np.asarray([f"[{p}, " for p in range(P)])
                                   [:, None, None], _json_floats(val)), "]")
    payload = []
    for p in range(P):
        text = pair[p]
        for q in range(p + 1, P):
            eq = idx[p][:, :, None] == idx[q][:, None, :]        # [N, K, K]
            later = np.take_along_axis(pair[q], eq.argmax(axis=2), axis=1)
            text = np.where(eq.any(axis=2),
                            np.char.add(np.char.add(text, ", "), later), text)
        text = np.char.add(np.char.add("[", text), "]")
        # an entry seen in an earlier column takes its first entry's payload
        for q in range(p - 1, -1, -1):
            eq = idx[p][:, :, None] == idx[q][:, None, :]
            first = np.take_along_axis(payload[q], eq.argmax(axis=2), axis=1)
            text = np.where(eq.any(axis=2), first, text)
        payload.append(text)
    keys = np.asarray(names)[idx].transpose(1, 0, 2).reshape(N, P * K)
    texts = np.stack(payload, axis=1).reshape(N, P * K)
    out = np.empty(n, dtype=object)
    out[:] = [dict(zip(a, b)) for a, b in zip(keys.tolist(), texts.tolist())]
    return out
