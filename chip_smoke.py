#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``transmogrifai_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device and build — CUDA must be present; prints the card's name and power
   limit, builds every kernel of ``transmogrifai_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and, beside them, the four native
   host helpers (``native/textprof.cpp``, ``fasttok.cpp``, ``mapprof.cpp``,
   ``locofmt.cpp``, one ``g++`` each), and fails if any of them does not
   build or load;
2. kernels — each kernel runs at the main paths' shapes (1,000,000 x 28)
   against its plain-PyTorch twin on the same inputs, with its time, the
   twin's time, its bound and (where one PyTorch call computes the same
   function) that call's time: the GBT shapes (3 CV lanes, a depth-3 level),
   the forest shapes (60 lanes = 3 folds x 20 trees, Poisson-weighted gini
   statistics, per-node feature subsets, levels 0 and 5 of a depth-6 tree,
   walks of 20 depth-6 trees), ``fista_step`` at the default grid's linear
   shapes (3 folds x 8 logistic lanes, 3 folds x 4 squared-hinge lanes, the
   power iteration's 3 lanes; the xgb ``tree_split`` held to its twin's
   bits, ``tree_route`` exact), ``tree_hist_deep`` (rows partitioned by
   node group) at level 11 of depth-12 trees (a 50-tree forest member with
   node subsets; GBT statistics) and ``tree_walk`` through depth-12
   members; every ``tree_walk`` shape is held to its twin within 1e-6 and
   to its own bits on a second launch; ``tree_hist`` and ``tree_hist_deep``
   on GBT statistics (fixed point) are held to the emulation's bits
   (``tree_hist_fixed_twin``), to their own on a second launch and with
   the rows permuted;
3. bench set — the dense binary workload of ``bench.run_dense``: 28 RealNN
   features → transmogrify → sanity_check →
   BinaryClassificationModelSelector (3-fold CV with racing over logistic
   regression x4, a random forest of 20 depth-6 trees and GBT 20 rounds x
   depth 3) → train, evaluate (AuROC) and score on the card, with every
   kernel's launch count read around that run; the same workflow at 20,000
   rows is then run on the card (forest draws made on the card, and made on
   the host) and on the CPU twins (draws on the host), and held to the JAX
   package's forest CV AuPR at that size;
4. default grid — ``BinaryClassificationModelSelector()`` with no
   ``models=`` (LR x8, RF x18 and GBT x18 up to depth 12, LinearSVC x4) on
   the same workload at 1,000,000 x 28: train, evaluate and score on the
   card, with its train wall, per-family CV wall and best CV AuPR, winner,
   train AuROC, peak device memory and every kernel's launches read around
   that run (and its ``tree_hist`` calls tallied by lanes and nodes); a
   ``torch.profiler`` window over its forest candidates' cross-validation
   and one over its GBT candidates' (device-busy share, top kernels);
   ``tree_hist`` at the forests' largest lane batch (300 lanes) at levels
   0, 2, 4 and 5 with node subsets and level 5 with every feature, and
   ``tree_hist_deep`` at the deep levels the grid launches (a 150-lane
   forest batch at levels 8-11 and 300 lanes at level 11 with subsets,
   the GBT's 6 and 12 lanes at level 11), against the f64 twin;
   ``tree_route`` and ``tree_split`` at the grid's shapes
   (``check_route_split_levels``: the route at forest batches of 150 and
   300 lanes at levels 5 and 11 and at the GBT's 6 and 12 lanes at levels
   2 and 11; the split at a depth-3 GBT level and at level 11 with three
   quarters of the rows in 8 nodes), the route exact against its twin on
   copies of the ids (it routes in place), the split bit for bit with its
   epilogue's tree arrays against the twin's bookkeeping, each timed by
   CUDA events and by the profiler (``kernel_ms``); then at
   5,000 rows on the card
   (forest draws made on the host) and on the CPU twins, held to the JAX
   package's default-grid run at that size;
5. transmogrification — the workload of ``bench.run_transmog`` at
   1,000,000 rows (the port's copy of ``bench.make_transmog_columns``: 3
   free texts, 2 PickLists, a RealMap, 4 Reals with nulls, built before the
   clock starts): ``hash_counts`` on text1's token stream at 1M x 512
   against its twin (equal); then RawFeatureFilter → transmogrify →
   sanity_check → LR selector (``reg_param`` 0.01, 0.1) trained,
   evaluated and scored on a fresh seed-7 batch, with its train wall,
   phase seconds, checked width (1,596), Cramér's V, CV AuPR, train AuROC,
   peak device memory, score rows/s and every kernel's launches read
   around it; ``fista_step`` at the checked width (6 CV lanes, the default
   selector's 8-lane fold-0 screen, the refit's 1 lane, the power
   iteration's 3) on that run's own matrix against its f64 twin; a
   ``torch.profiler`` window over the LR cross-validation on that matrix
   (device-busy share, top kernels by device time); and the workflow at
   20,000 rows on the card and the CPU twins, held to the JAX package's
   numbers at that size;
6. sparse hashed text — the workload of ``bench.run_text_sparse`` at
   1,000,000 rows (the port's copy of ``bench.make_sparse_text_columns``:
   8 label-dependent tokens of a 30,000-word vocabulary and one dense Real,
   built before the clock starts): ``sp_matmat`` and ``sp_rmatmat`` on the
   run's own 1M x 100,003 matrix at k = 1, 3, 6 and on a skewed synthetic
   matrix at k = 1, 6, 32 against their f64 twins, bit-repeatable and
   equal bit for bit to the numpy emulation of their order, with each
   order's plan (team, light and heavy segments, tiles, pieces);
   then transmogrify (100,000 hashes: a SparseMatrix) → LR selector
   (``reg_param`` 0.01, 0.1) trained, evaluated and scored on a fresh seed-7
   batch, with its train wall, phase seconds, nnz and density, width
   (100,003), CV AuPR, train AuROC (> 0.99), peak device memory (< 4 GB),
   score rows/s and both sparse kernels' launches; a ``torch.profiler``
   window over its LR cross-validation (device-busy share, each sparse
   kernel's device ms, kernel launches and wrapper calls); and the
   workflow at 3,000 rows on the card and the CPU twins, held to the JAX
   package's numbers at that size;
7. explanations — ``RecordInsightsLOCO`` (top-20) through its transform on
   the transmog LR winner over its own 1M x 1,596 checked vector (grouped
   by raw parent), on the default grid's winner (a GBT) over its 1M x 28
   vector and on the bench set's forest fitted on that vector (one group
   per feature), with both LOCO kernels' launches read around those three
   transforms; ``loco_linear`` against its twin on that
   vector and at ``scripts/bench_loco.py``'s 100,000 x 512 (128 groups and
   the meta-less 512, with the cuBLAS yardstick; the other strategies, the
   SVC link and k = G), ``loco_tree`` on the GBT and the forest, each
   bit-repeatable; the repaired faults: GBT and forest fits and both split
   kernels at 1,597 features (a cross-chunk tie to the first feature), a
   6-class forest fitted and scored with ``tree_hist_deep``,
   ``tree_split_gini`` and ``tree_walk`` against their twins, and
   ``BinaryClassificationModelSelector()`` on the sparse 1M batch skipping
   the tree families; then ``RecordInsightsCorr`` fitted on the
   default-grid model at 1M x 28 and applied to its first ``CORR_ROWS``,
   and ``WorkflowModel.summary()``;
8. regression — ``tree_split_variance`` against its f32 twin's bits and
   its twin on f64 histograms at the RF regressor's level 5 (300 lanes, "onethird" node
   subsets), level 11 of its depth-12 group and at 1,597 features (a
   cross-chunk exact tie; a decision-tree regressor fitted there), and
   ``fista_step`` with the squared loss (3 folds x 8 lanes at 1M x 16, the
   wide form at 1M x 1,596) against its f64 twin; then
   ``bench.run_selector_smoke``'s regression workload (the port's copy of
   its generator, seed 11: 16 RealNN features, y = X @ w + 0.3 noise) at
   1,000,000 rows: ``RegressionModelSelector()`` with no ``models=`` (LinReg
   x8, RF regressor x18, GBT regressor x18) trained, evaluated (RMSE, R² >
   0.9) and scored on a fresh 1M batch, with its train wall, phase and
   family seconds, per-family best CV RMSE, peak device memory (< 80 GB)
   and every kernel's launches read around it; ``RecordInsightsLOCO`` on
   its winner (kernel against twin) and its ``summary()``; the compact grid
   (ridge x2 + a 20-tree RF regressor) at 1M; and both grids at 4,000 rows
   on the card held to the JAX package's numbers (``REG_REF``);
9. multiclass — ``fista_softmax`` against its f64 twin (the fold-0
   screen's 8 lanes and 3 folds x 8 lanes of 4 classes and 8 lanes of 40
   at 1M x 16, the wide form at 200,000 x 1,596) and
   ``multiclass_confusion`` against its twin (1M rows x 24 candidates of 4,
   8, 9, 14, 15 and 40 classes, both sides of its thread form's limit:
   equal on 0/1 masks, 1e-6 on other weights; up to 15 classes on 200,003
   rows also the bits of its numpy emulation), each bit-repeatable; then
   ``bench.run_selector_smoke``'s multiclass workload
   (the port's copy of its generator, seed 11: 16 RealNN features around 4
   class centres) at 1,000,000 rows: ``MultiClassificationModelSelector()``
   with no ``models=`` (softmax LR x8, RF x18, ``DataCutter``) trained,
   evaluated (F1 > 0.9) and scored on a fresh 1M batch (seed 12), with its
   train wall, phase and family seconds, per-family best CV F1, peak device
   memory (< 80 GB) and every kernel's launches read around it, and
   ``multiclass_confusion`` held to its twin at each shape that train
   launched it, on seeded arrays of that shape; a
   ``torch.profiler`` window over its LR cross-validation (the default LR
   grid); the compact grid, and naive Bayes with the MLP, at 1M; and iris (default and
   compact grids) and the default LR candidates at 4,000 bench rows on the
   card held to the JAX package's numbers (``MC_REF``, ``MC_BENCH_REF``);
10. GLMs — ``fista_glm`` against its f64 twin on each GLM workload's 1M x
   16 matrix (the gradient form at 3 folds x 4 lanes, the value-only form
   at one backtracking ladder's 96 trial lanes; bit-repeatable) and the CV
   block fitted twice (coefficients, n_iter and step halvings equal); then
   the insurance claim frequency (poisson) and severity (gamma) workloads
   of ``scripts/glm_grid_reference.py`` at 1,000,000 rows:
   ``RegressionModelSelector`` over ``OpGeneralizedLinearRegression`` x4
   and LinReg x8 trained, evaluated and scored on a fresh 1M batch (seed
   22), with the launches and peak memory read around each, held to the
   JAX package's winner and best GLM CV RMSE (``GLM_REF``) and to the true
   coefficients (0.02); a ``torch.profiler`` window over the poisson GLM's
   CV (``profile_glm_cv``: device-busy share, ``fista_glm``'s device ms by
   kernel, its calls and launches by form, the ladder passes);
   ``RecordInsightsLOCO`` on each winner (the exp link of ``loco_linear``,
   kernel against twin);
11. softmax explanations — ``RecordInsightsLOCO`` (top-20 of 16 groups) on
   phase 9's multiclass winner (softmax LR) over its 1M x 16 vector, maps
   included, with the launches read around the transform, and
   ``loco_softmax`` against its twin there (and against the f64 diffs),
   on naive Bayes and the MLP fitted at 1M, on a 40-class model at 1M x 16,
   at ``scripts/bench_loco.py``'s 100,000 x 512 with 128 groups (top-20
   and top-40) and on 16- and 17-class models (both sides of the row
   form's widest layer), each row-form case also bit for bit against the
   warp form on the same inputs;
12. the repaired card-only refusals — the two-pass FISTA form
   (``fista_wide``) through the wrappers at the shapes no tensor-core
   launch holds (``fista_step`` and ``fista_glm`` at 2,000 x 27,009,
   ``fista_softmax`` with 65 classes) and ``fista_glm`` on the tensor-core
   form's clusters at 4,900 and 16,384 features, which its old one-tile
   form refused, against the f64 twins, ``loco_softmax`` on MLPs of
   ``hidden_layers=(256, 256)`` and (900,), the three split kernels at 64
   and 127 bins against their twins; then the estimators a user calls at
   those shapes, on the card and the CPU twins — ``OpLogisticRegression``
   at 2,000 x 27,009 and with 65 classes, a poisson
   ``OpGeneralizedLinearRegression`` at 20,000 x 4,900, each tree family
   at ``max_bins=64`` — with the launches read around the card fits alone;
   the two-pass form is also held and timed beside the tensor-core form at
   phase 8's wide 24-lane shape and phase 9's wide softmax shape (not on
   any path: 0 launches);
13. queue 3's repairs and the LOCO walk — ``hash_counts`` at 60,000 and
   100,003 hashes (column windows: the twin's counts exactly),
   ``loco_softmax`` on an MLP of ``hidden_layers=(2048,)`` at 1,000 x 16
   (its slots in device memory), ``loco_tree`` at G = 1, 28 and 100 (two
   group windows) under each link and strategy and at k = 40, against
   their twins, and the binary selector's default LR grid ranked by F1 at
   1M x 28 (its winner printed, the launches read around its train);
14. save, load and score — run on each of the default grid's, the
   transmog, the sparse, the regression and the multiclass models right
   after the phase that trained it (while it and its fresh 1M batch are
   alive): ``save`` to a temp directory (seconds, bundle bytes),
   ``WorkflowModel.load`` on the card (seconds), the fresh batch scored
   through the reloaded model's ``ScoreProgram`` and through the eager
   ``apply_dag``, each required to give the in-memory model's bits (rows/s
   and peak device memory of both), the kernels' launches read around the
   ``ScoreProgram`` score alone (``tree_walk`` for a tree winner,
   ``hash_counts`` for transmog, ``sp_matmat`` for sparse must launch);
   on the default grid's model also ``local.score_function``'s median ms a
   record over 200 records (each held to the batch's row) and
   ``ScoreProgram``'s ms at 1, 64 and 4,096 rows;
15. serving — the port's HTTP server (``serving.start_server``) on phase
   14's default-grid bundle, copied under a checkpoint root as version 1
   (warm-up seconds, the padding ladder, ``warmup_builds_total``): 16
   clients x 200 one-record JSON requests of fresh rows (p50 / p99,
   requests/s, the batches and rows ``/metrics`` counted, so the mean
   coalesced batch, the engine's batch latency, ``tree_walk``'s
   launches); columnar requests of 1,024 rows on a second server with
   ``max_batch=1024`` (rows/s, p50 / p99); every reply held to the
   reloaded model's score of the same rows (predictions equal,
   probabilities within 1e-6, the version a ``ckpt-`` of the root); 8
   clients x 50 requests with the model saved as version 2 and
   ``reload_now()`` called halfway (every request answered; the replies
   tagged by version); 422 with the JAX package's violation kinds for a
   NaN and for a string in a numeric field, 400 for a malformed columnar
   body, 429 + ``Retry-After`` past ``queue_bound=2``; the transmog and
   sparse bundles served one columnar request each (1,024 and 64 rows;
   ``hash_counts`` and ``sp_matmat`` must launch), and one sparse
   ``ScoreProgram`` pass of 64 rows split into host and device ms
   (``sparse_pass_split``, with the combiner's metadata rebuilt and kept);
   the version-1 root
   served again by a fresh process (``SERVE_FRESH_CHILD``: 16 clients x
   25 JSON requests, 4 columnar ones of 64 rows), whose warm-up must load
   ``tree_walk``'s library (``warmup_builds_total`` >= 1), as no process
   that trained first can show.  It fails on any
   kernel or native build after warm-up (``online_builds_total``), a
   demoted engine or a "degraded" / "fallback" / "dead_letter" event,
   and prints a ``serving:`` line.  The script's own wall time is
   printed before the card's line;
16. training control — the bench set resumed after a preemption (every
   family, a GBT fit again too, held to the uninterrupted train bit for
   bit), the default grid's ``OpGBTClassifier`` and the regression default
   grid's ``OpGBTRegressor`` and ``OpRandomForestRegressor`` each trained
   twice at 1M rows with the same CV metric and tree-array bits (the tree
   histograms sum float statistics in fixed point), workflow CV, the
   sanitizers and the train-time screen;
17. more feature kinds — ``scripts/kinds_reference.py``'s workflow at
   1,000,000 rows of ``synthetic.make_kinds_columns`` (Dates, a DateTime
   and its ``to_time_period``, a DateList, two MultiPickLists, a
   Geolocation, Reals through ``auto_bucketize`` and a fixed ``bucketize``,
   a RealMap through ``DecisionTreeNumericMapBucketizer``) → transmogrify
   → sanity_check → the binary selector with ``model_types_to_use`` LR and
   GBT (3-fold CV): the train wall and its stages' seconds, the
   bucketizers' fit seconds with their ``tree_hist`` / ``tree_split_gini``
   / ``tree_route`` launches counted around them alone, their splits equal
   to the port's CPU fit of each column and map key, exactly the two
   families, train AuROC > 0.7, the peak; the same workflow with
   ``use_train_validation_split`` (LR only: ``TrainValidationSplit``,
   trainRatio 0.75, racing "degraded"); the calibrators and scalers on a
   RealNN score column, the card's batch against its CPU copy; phase 14's
   checks on its bundle and a fresh 1M batch; and the workflow at
   ``KINDS_REF_ROWS`` held to the JAX package's CPU run (``KINDS_REF``).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` table (launches: the default
grid's train for the dense rows, the transmog run for ``hash_counts`` and
the two wide ``fista_step`` rows (6 CV lanes, the 8-lane screen), the sparse run for ``sp_matmat`` and
``sp_rmatmat``, the three LOCO transforms for ``loco_linear`` and
``loco_tree``, the regression default grid's train for
``tree_split_variance`` and the two squared-loss ``fista_step`` rows, the
multiclass default grid's train for ``fista_softmax`` and
``multiclass_confusion``, the poisson workload's train and score for the two
``fista_glm`` rows, its LOCO transform for ``loco_linear``'s exp-link row,
the multiclass LOCO transform for the ``loco_softmax`` rows, phase 12's
estimator fits for the ``fista_wide`` rows, the two fault-width
``fista_glm`` rows and the 64-bin split rows; the ``tree_walk``,
``hash_counts`` and ``sp_matmat`` rows add phase 14's reloaded scores'
and phase 15's served traffic's launches of that kernel, and every row
phases 16's and 17's launches), the one before that the card's name and
power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS, N_FEATS, N_BINS, N_FOLDS = 1_000_000, 28, 32, 3
N_TREES, RF_DEPTH = 20, 6         # the bench's forest candidate
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
# The JAX package's forest at 20,000 rows (make_data seed 0, RF seed 42,
# CPU): CV AuPR 0.7068 (BENCH_STANDING.json run 0), winner LR.  The port's
# forest draws other random numbers, so its CV AuPR must land within
# RF_CV_AUPR_TOL = max(0.01, 3 x the JAX package's spread of that AuPR over
# 5 RF seeds), measured by `python tests/test_torch_forest.py` (PERF.md).
JAX_20K_RF_CV_AUPR = 0.7068
JAX_20K_WINNER = "OpLogisticRegression"
RF_CV_AUPR_TOL = 0.0306            # 3 x 0.0102, the JAX package's spread
                                   # over RF seeds 42, 0, 1, 2, 3
# The JAX package's default grid at 5,000 rows (make_data seed 0, CPU;
# `PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/default_grid_reference.py
# --package jax --rows 5000`): each family's best CV AuPR and the winner.
# LR, SVC and GBT must land within 1e-3; the forest within REF_RF_TOL =
# max(0.01, 3 x the JAX package's spread of its RF family's best CV AuPR
# over forest seeds 42, 0, 1, 2, 3 at that size, `... --rf-seeds
# 42,0,1,2,3`: 0.78718, 0.79143, 0.79176, 0.78737, 0.78722; PERF.md).
REF_ROWS = 5_000
REF_CV_AUPR = {"OpLogisticRegression": 0.8241474231084188,
               "OpRandomForestClassifier": 0.7871793905893961,
               "OpGBTClassifier": 0.7698188424110413,
               "OpLinearSVC": 0.8240175445874532}
REF_WINNER = "OpLogisticRegression"
REF_RF_TOL = 0.0137                # 3 x 0.00458, the JAX package's spread
DEEP = 12                          # the default grid's deepest trees
PORT = "transmogrifai_tpu_torch"
TRANSMOG_HASHES = 512              # SmartTextVectorizer's default width
TRANSMOG_WIDTH = 1596              # the JAX package's checked width
# The JAX package's transmogrification workflow at 20,000 rows
# (bench.make_transmog_columns seed 1, CPU;
# `PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/transmog_reference.py
# --package jax --rows 20000`): the port must give the same checked width,
# dropped columns and winner, Cramér's V within 1e-5, each candidate's CV
# AuPR and the train AuROC within 1e-4.
TRANSMOG_REF_ROWS = 20_000
TRANSMOG_REF = {
    "width": 1596, "dropped": ["cat1_OTHER_20"],
    "cramers_v": {"cat1": 0.2112401887961123, "cat2": 0.03364347564720542,
                  "rmap(a)": None, "rmap(b)": None, "rmap(c)": None,
                  "r0": None, "r1": None, "r2": None, "r3": None,
                  "text1": None, "text2": None, "text3": None},
    "cv_aupr": {"reg_param=0.01": 0.7792084813117981,
                "reg_param=0.1": 0.7779407501220703},
    "winner": "reg_param=0.01", "train_auroc": 0.8733430504798889}
SPARSE_HASHES = 100_000            # bench.run_text_sparse's hash width
SPARSE_WIDTH = 100_003             # the hashes, txt's null, x0 and its null
SPARSE_PEAK_GB = 4.0               # 1% of the 400 GB dense equivalent
# The JAX package's sparse-text workflow at 3,000 rows
# (bench.make_sparse_text_columns seed 3, CPU;
# `PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/sparse_reference.py
# --package jax --rows 3000`): the port must give the same width, nnz and
# winner, each candidate's CV AuPR and the train AuROC within
# SPARSE_REF_TOL.  The two candidates' AuPRs lie 2.5e-5 apart, so the
# tolerance sits well below that gap (and well above the ~1e-7 f32
# disagreement of the two packages).
SPARSE_REF_ROWS = 3_000
SPARSE_REF_TOL = 1e-6
SPARSE_REF = {
    "width": 100003, "nnz": 26993,
    "cv_aupr": {"reg_param=0.01": 0.9983513156572977,
                "reg_param=0.1": 0.9983265399932861},
    "winner": "reg_param=0.01", "train_auroc": 1.0}


def make_data(n: int, d: int = N_FEATS, seed: int = 0):
    """HIGGS-difficulty synthetic (a copy of ``bench.make_data``): linear
    signal damped to sqrt(d) scale plus mild interactions, unit noise —
    best-model AuROC lands near 0.80."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32) / np.sqrt(d)
    logits = (X @ w + 0.35 * (X[:, 0] * X[:, 1]) - 0.25 * (X[:, 2] ** 2)
              + 0.1 + 0.3 * np.sin(2 * X[:, 3]))
    y = (logits + rng.normal(size=n).astype(np.float32) > 0).astype(np.float32)
    return X, y


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of ``fn`` spends in each kernel, by name, from a
    ``torch.profiler`` window over ``reps`` calls after one warm-up call
    (CUDA events around the calls measure the host's enqueue as well where
    it is the slower).  The window is the profiler's second step: the first
    (``reps`` calls more, traced and dropped) is its warm-up — a window
    opened right after an earlier one was seen to miss its first calls'
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name[:60]] = by.get(e.name[:60], 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
    return by


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_tf32_bound(bytes_moved: float, ops: float) -> float:
    """The least ms for f32 work done on TF32 tensor cores in split TF32
    (three products for each): bytes at 3.35 TB/s or 3 x ops at 495
    TFLOP/s, the larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3


# --------------------------------------------------------------------------
# phase 2: each kernel against its twin at the main path's shapes
# --------------------------------------------------------------------------

def kernel_inputs(device, n: int, seed: int = 1):
    """Inputs of one depth-3 GBT level for 3 CV lanes: the bench matrix, its
    bins, fold-weighted (w, w·g, w·h) statistics from random margins, and
    rows spread over the level's 4 nodes (some already at leaves above)."""
    import torch

    from transmogrifai_tpu_torch.models.trees import binned
    from transmogrifai_tpu_torch.tuning import OpCrossValidation

    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    splits, sp_t, B = binned(Xd, Xd, N_BINS)
    rng = np.random.default_rng(seed)
    W = np.zeros((N_FOLDS, n), np.float32)
    for f, (tr, _) in enumerate(OpCrossValidation(N_FOLDS).splits(y)):
        W[f, tr] = 1.0
    margin = rng.normal(scale=0.5, size=(N_FOLDS, n)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-margin))
    g, h = p - y[None], np.maximum(p * (1 - p), 1e-6)
    stats = np.stack([np.ones_like(g), g, h], axis=2) * W[:, :, None]
    row_node = rng.integers(1, 7, size=(N_FOLDS, n)).astype(np.int32)
    return {"X": Xd, "y": y, "B": B, "splits": sp_t,
            "stats": torch.as_tensor(stats, device=device),
            "row_node": torch.as_tensor(row_node, device=device),
            "offset": 3, "P": 4}


def _random_trees(device, n_trees: int, depth: int, d: int, seed: int = 2,
                  classes: int = 0):
    """``n_trees`` perfect-heap trees of ``depth`` with a leaf above the
    bottom level in every tree and +inf thresholds under it; one leaf value
    per node, or with ``classes`` the class shares of a gini leaf."""
    import torch
    rng = np.random.default_rng(seed)
    T = 2 ** (depth + 1) - 1
    feature = rng.integers(0, d, size=(n_trees, T)).astype(np.int32)
    threshold = rng.normal(scale=0.7, size=(n_trees, T)).astype(np.float32)
    is_leaf = np.zeros((n_trees, T), bool)
    is_leaf[:, 2 ** depth - 1:] = True
    is_leaf[:, 2] = True                       # an early leaf
    threshold[:, 5:7] = np.inf                 # never taken
    feature[is_leaf] = -1
    if classes:
        leaf = rng.random((n_trees, T, classes)).astype(np.float32)
        leaf /= leaf.sum(axis=2, keepdims=True)
    else:
        leaf = rng.normal(scale=0.1, size=(n_trees, T, 1)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (feature, threshold, is_leaf, leaf))


def walk_case(tk, X, trees, steps: int, members: int = 1, op: str = "sum",
              reps: int = 10, plain_reps: int = 3) -> dict:
    """``tree_walk`` at one shape: within 1e-6 of its twin (which sums the
    trees in the same order) and the same bits on two launches; with
    ``reps`` also timed beside its bound (X's used columns read once, the
    output written once, the trees read once; a compare a row, tree and
    step) and the twin's time."""
    import torch
    a = tk.tree_walk(X, *trees, steps, members, op)
    b = tk.tree_walk(X, *trees, steps, members, op)
    Tr, V = trees[0].shape[0], trees[3].shape[2]
    if not torch.equal(a, b):
        raise AssertionError(f"tree_walk ({Tr} trees x {members} members) "
                             "differs between two launches")
    err = float((a - tk.tree_walk_twin(X, *trees, steps, members, op))
                .abs().max())
    if err > 1e-6:
        raise AssertionError(f"tree_walk disagrees with its twin at {Tr} "
                             f"trees x {members} members ({op}): {err}")
    case = {"trees": Tr, "members": members, "V": V, "op": op,
            "steps": steps, "max_abs_err": err, "same_bits_twice": True}
    if reps:
        n = X.shape[0]
        used = int(torch.unique(trees[0][trees[0] >= 0]).numel())
        bt, by = bound(4 * n * used + 4 * n * members * V
                       + sum(t.numel() * t.element_size() for t in trees),
                       n * Tr * (steps + 1))
        case.update(
            ms=time_ms(lambda: tk.tree_walk(X, *trees, steps, members, op),
                       reps),
            plain_ms=time_ms(lambda: tk.tree_walk_twin(
                X, *trees, steps, members, op), plain_reps)
            if plain_reps else None,
            bound_ms=bt, bound_by=by, library_ms=None)
    return case


def check_kernels(device, n: int = N_ROWS, reps: int = 20):
    """Each kernel vs its twin on the same inputs; returns one row per
    kernel for the ``kernels`` line (launches filled in later)."""
    import torch

    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk

    inp = kernel_inputs(device, n)
    B, stats, row_node = inp["B"], inp["stats"], inp["row_node"]
    off, P = inp["offset"], inp["P"]
    K, D = row_node.shape[0], B.shape[1]
    S = stats.shape[2]
    rows = []

    # tree_hist at every level shape of the depth-3 fit: P = 1, 2, 4 with
    # the histogram, then the bottom level's P = 8 totals only; the P = 4
    # level is the one timed below
    rng = np.random.default_rng(3)
    hist = tot = None
    hist_err = 0.0
    for lo, P_l, with_hist in ((0, 1, True), (1, 2, True), (off, P, True),
                               (7, 8, False)):
        rn = (row_node if lo == off else torch.as_tensor(
            rng.integers(max(0, lo - 2), lo + P_l, size=(K, n)).astype(
                np.int32), device=device))
        h, t, e = _check_hist(tk, B, rn, stats, lo, P_l, with_hist)
        hist_err = max(hist_err, e)
        if lo == off:
            hist, tot = h, t
    cells = row_node.long() - off
    in_level = (cells >= 0) & (cells < P)
    at = int(in_level.sum())
    flat_idx = ((torch.where(in_level, cells, 0)[:, :, None]
                 + torch.arange(K, device=device)[:, None, None] * P) * D
                + torch.arange(D, device=device)) * N_BINS + B.long()[None]
    flat_idx = flat_idx.reshape(-1)
    vals = (stats * in_level[..., None])[:, :, None, :].expand(
        K, n, D, S).reshape(-1, S).contiguous()
    lib_out = torch.zeros((K * P * D * N_BINS, S), device=device)
    bt, by = bound(B.numel() + 4 * row_node.numel() + 4 * stats.numel()
                   + 4 * (hist.numel() + tot.numel()), at * D * S)
    print("tree_hist fixed point (GBT level): "
          + json.dumps(fixed_point_case(tk, B, row_node, stats, off, P)),
          flush=True)
    rows.append({
        "name": "tree_hist", "max_abs_err": hist_err,
        "ms": time_ms(lambda sc=tk.hist_scale(stats): tk.tree_hist(
            B, row_node, stats, off, P, N_BINS, scale=sc), reps),
        "plain_ms": time_ms(lambda: tk.tree_hist_twin(B, row_node, stats, off,
                                                      P, N_BINS), 3),
        "bound_ms": bt, "bound_by": by,
        "library_ms": time_ms(lambda: lib_out.index_put_(
            (flat_idx,), vals, accumulate=True), 3)})

    # tree_split on the kernel's histogram: the twin's bits (split_case)
    fmask = torch.ones(D, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, dtype=torch.float32, device=device)
    args = (hist, tot, fmask, inp["splits"], lane(10.0), lane(0.0), lane(1.0))
    rows.append({"name": "tree_split",
                 **split_case(tk, *args, reps=reps, plain_reps=reps)})
    st = tk.tree_split_twin(*args)

    # tree_route: integer work, exact (route_case: in place, on copies)
    feat, bin_, leaf = st["feature"], st["bin"], st["is_leaf"].clone()
    leaf[:, 1] = True                     # a node that stops splitting
    rows.append({"name": "tree_route",
                 **route_case(tk, B, row_node, feat, bin_, leaf, off, reps,
                              plain_reps=reps)})

    # tree_walk at the main path's three shapes, each walked depth+1 steps:
    # a boosting round's margin update (3 lanes x 1 tree), the CV panel (3
    # members x 20 trees) and the final model (20 trees, the timed one);
    # both sum the trees in the same order, the same bits twice
    X = inp["X"]
    for n_trees, members in ((3, 3), (60, 3), (20, 1)):
        trees = _random_trees(device, n_trees, 3, D)
        case = walk_case(tk, X, trees, 4, members,
                         reps=reps if members == 1 else 0)
    rows.append({"name": "tree_walk", **{k: case[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}})
    for r in rows:
        r["route"] = "cuda"
        r["source"] = f"transmogrifai_tpu_torch/csrc/{r['name']}.cu"
        r["replaces"] = kernels.REPLACES[r["name"]]
    return rows


def _fold_weights(y: np.ndarray) -> np.ndarray:
    from transmogrifai_tpu_torch.tuning import OpCrossValidation
    W = np.zeros((N_FOLDS, len(y)), np.float32)
    for f, (tr, _) in enumerate(OpCrossValidation(N_FOLDS).splits(y)):
        W[f, tr] = 1.0
    return W


def forest_inputs(device, n: int, seed: int = 4):
    """Inputs of the main path's forest fit: 60 lanes (3 folds x 20 trees,
    lane = fold*20 + tree) of gini statistics (w, w·[y=0], w·[y=1]) with
    w = Poisson(1) draw x fold weight, the per-node subsets of the forest's
    draws, and rows spread over level 5's 32 nodes (offset 31), some parked
    at level-4 leaves."""
    import torch

    from transmogrifai_tpu_torch.models.trees import binned, forest_draws

    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    D = B.shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    dr = forest_draws(gen, n_trees=N_TREES, n_rows=n, rates=[1.0],
                      max_depth=RF_DEPTH,
                      fmask=torch.ones(D, dtype=torch.bool, device=device),
                      features_per_node=int(np.sqrt(D)))
    W = torch.as_tensor(_fold_weights(y), device=device)
    K = N_FOLDS * N_TREES
    bw = (W[:, None, :] * dr.boot[1.0][None]).reshape(K, n)
    yd = torch.as_tensor(y, device=device)
    base = torch.stack([torch.ones_like(yd), 1.0 - yd, yd], dim=1)
    stats = (base[None] * bw[:, :, None]).contiguous()
    tree_of_lane = torch.arange(K, device=device) % N_TREES
    rng = np.random.default_rng(seed)
    row_node = torch.as_tensor(
        rng.integers(25, 63, size=(K, n)).astype(np.int32), device=device)
    return {"X": Xd, "B": B, "splits": sp_t, "stats": stats,
            "row_node": row_node,
            "masks": [m[tree_of_lane].contiguous() for m in dr.subsets]}


def check_forest_kernels(device, n: int = N_ROWS, reps: int = 10):
    """The forest's kernels at the main path's forest shapes.  Returns the
    ``tree_split_gini`` row of the kernels line (level 5) and a dict of the
    forest-shape checks and times (printed on their own line)."""
    import torch

    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import forest_draws

    inp = forest_inputs(device, n)
    B, stats, row_node = inp["B"], inp["stats"], inp["row_node"]
    K, D = row_node.shape[0], B.shape[1]
    S = stats.shape[2]
    off, P = 31, 32
    facts = {"forest_draws_s": {}}

    # the forest's draws at the main path's shape, by a host generator and
    # by one on the card (host clock, one call each after a warm-up)
    for where in ("cpu", device):
        def draw():
            gen = torch.Generator(device=where).manual_seed(0)
            forest_draws(gen, n_trees=N_TREES, n_rows=n, rates=[1.0],
                         max_depth=RF_DEPTH,
                         fmask=torch.ones(D, dtype=torch.bool, device=where),
                         features_per_node=int(np.sqrt(D)))
            if where != "cpu":
                torch.cuda.synchronize()
        draw()
        t0 = time.perf_counter()
        draw()
        facts["forest_draws_s"][str(where)] = time.perf_counter() - t0

    # tree_hist at level 5, 60 lanes, with the nodes' feature subsets (what
    # the forest's fit passes) and with every feature: against the f64 twin,
    # the masked histogram equal to the full one on the kept cells, times
    m5 = inp["masks"][5]
    facts["tree_hist"] = hist_case(tk, B, row_node, stats, off, P, m5, reps)
    facts["tree_hist_all_features"] = hist_case(tk, B, row_node, stats, off,
                                                P, None, reps)
    hist_m, tot_m = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                                 node_mask=m5)

    # tree_split_gini at levels 0 (P = 1) and 5 (P = 32, the masked
    # histogram) with the forest's per-node subsets: the twin's bits, the
    # epilogue's arrays, times (gini_split_case)
    fmask = torch.ones(D, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, dtype=torch.float32, device=device)
    h0, t0 = tk.tree_hist(B, torch.zeros_like(row_node), stats, 0, 1, N_BINS,
                          node_mask=inp["masks"][0])
    facts["tree_split_gini_level_0"] = gini_split_case(
        tk, h0, t0, fmask, inp["masks"][0], inp["splits"], lane(10.0),
        lane(0.0), reps)
    del h0, t0
    hist, tot = hist_m, tot_m
    args = (hist, tot, fmask, m5, inp["splits"], lane(10.0), lane(0.0))
    facts["tree_split_gini_level_5"] = gini_split_case(tk, *args, reps)
    row = {"name": "tree_split_gini",
           **{k: facts["tree_split_gini_level_5"][k] for k in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")}}

    # tree_route at level 5 of 60 lanes: exact (route_case)
    sp = tk.tree_split_gini_twin(*args)
    facts["tree_route"] = route_case(tk, B, row_node, sp["feature"],
                                     sp["bin"], sp["is_leaf"], off, reps)

    # tree_walk at the forest's shapes, V = 2 class shares, 7 steps: the
    # model's mean over 20 trees (timed) and the CV panel's 3 members x 20
    # trees sum
    X = inp["X"]
    for n_trees, members, op in ((N_FOLDS * N_TREES, N_FOLDS, "sum"),
                                 (N_TREES, 1, "mean")):
        trees = _random_trees(device, n_trees, RF_DEPTH, D, classes=2)
        facts["tree_walk"] = walk_case(tk, X, trees, RF_DEPTH + 1, members,
                                       op, reps=reps if members == 1 else 0)
    row.update(route="cuda",
               source="transmogrifai_tpu_torch/csrc/tree_split_gini.cu",
               replaces=kernels.REPLACES["tree_split_gini"])
    return row, facts


def _check_hist(tk, B, row_node, stats, off: int, P: int, with_hist: bool):
    """``tree_hist`` against its twin at one level; returns (hist, totals,
    max abs error).  A node total sums ~10^5 f32 values, where any f32 order
    (the twin's serial adds included) drifts by more than 1e-5 of the sum;
    so the kernel is held to the twin run in f64 on the same inputs, within
    1e-5 of each cell's absolute mass (plus 1e-5 absolute)."""
    hist, tot = tk.tree_hist(B, row_node, stats, off, P, N_BINS, with_hist)
    s64 = stats.double()
    hist_t, tot_t = tk.tree_hist_twin(B, row_node, s64, off, P, N_BINS,
                                      with_hist)
    mass, mass_tot = tk.tree_hist_twin(B, row_node, s64.abs(), off, P, N_BINS,
                                       with_hist)
    err_tot = (tot.double() - tot_t).abs()
    bad_tot = int((err_tot > 1e-5 + 1e-5 * mass_tot).sum())
    err, bad = float(err_tot.max()), 0
    if with_hist:
        err_h = (hist.double() - hist_t).abs()
        bad = int((err_h > 1e-5 + 1e-5 * mass).sum())
        err = max(err, float(err_h.max()))
    if bad or bad_tot:
        raise AssertionError(f"tree_hist (offset {off}, P {P}) disagrees with "
                             f"its twin in {bad} histogram cells and "
                             f"{bad_tot} node totals")
    return hist, tot, err


def fixed_point_case(tk, B, row_node, stats, off: int, P: int,
                     node_mask=None, seed: int = 0) -> dict:
    """``tree_hist`` on float statistics (fixed point: ``hist_scale``) at
    one level, held bit for bit to itself on a second launch, to a launch
    with the rows permuted and, lane by lane, to the CPU rule's emulation
    (``tree_hist_fixed_twin``: each value rounded to v·2^e, exact integer
    sums, one conversion to f32).  Returns the route and what held."""
    import torch
    scale = tk.hist_scale(stats)
    if not scale.fixed:
        raise AssertionError("fixed_point_case: integer statistics")
    K = row_node.shape[0]
    h1, t1 = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                          node_mask=node_mask, scale=scale)
    h2, t2 = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                          node_mask=node_mask, scale=scale)
    if not (torch.equal(h1, h2) and torch.equal(t1, t2)):
        raise AssertionError(f"tree_hist ({K} lanes, P {P}): two launches "
                             "on the same inputs differ in their bits")
    del h2, t2
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(
        B.shape[0]), device=B.device)
    h3, t3 = tk.tree_hist(B[perm].contiguous(),
                          row_node[:, perm].contiguous(),
                          stats[:, perm].contiguous(), off, P, N_BINS,
                          node_mask=node_mask)
    if not (torch.equal(h1, h3) and torch.equal(t1, t3)):
        raise AssertionError(f"tree_hist ({K} lanes, P {P}): the rows "
                             "permuted change the bits")
    del h3, t3, perm
    for k in range(K):
        sl = slice(k, k + 1)
        he, te = tk.tree_hist_fixed_twin(
            B, row_node[sl], stats[sl], off, P, N_BINS,
            node_mask=None if node_mask is None else node_mask[sl],
            scale=scale._replace(exponent=scale.exponent[sl]))
        if not (torch.equal(h1[sl], he) and torch.equal(t1[sl], te)):
            raise AssertionError(f"tree_hist ({K} lanes, P {P}, lane {k}): "
                                 "not the fixed-point emulation's bits")
        del he, te
    plan = tk.hist_plan(B.shape[0], B.shape[1], K, P, N_BINS,
                        stats.shape[2], True, None, 8)
    return {"lanes": K, "P": P, "route": plan["route"],
            "same_bits_twice": True, "same_bits_rows_permuted": True,
            "emulation_bits": True}


def _check_split(tk, hist, tot, fmask, node_mask, splits, min_inst,
                 min_gain, lam=None, chunk: int = 16) -> float:
    """``tree_split`` (``lam`` given: xgb statistics) or ``tree_split_gini``
    (``lam`` None, ``node_mask`` the nodes' subsets or None) on all lanes
    at once against its twin on the same histogram, ``chunk`` lanes at a
    time (a deep level's gain tables take ~10x its histogram).  Each kernel
    adds the bin prefix in the twin's order and rounds as it does, so it
    must give the twin's bits in every output, and its own bits on a second
    launch.  Returns 0.0 (the largest gain error)."""
    import torch
    K = hist.shape[0]
    if lam is None:
        name = "tree_split_gini"
        args = (hist, tot, fmask, node_mask, splits, min_inst, min_gain)
        out, again = tk.tree_split_gini(*args), tk.tree_split_gini(*args)
    else:
        name = "tree_split"
        args = (hist, tot, fmask, splits, min_inst, min_gain, lam)
        out, again = tk.tree_split(*args), tk.tree_split(*args)
    for a in range(0, K, chunk):
        sl = slice(a, min(a + chunk, K))
        if lam is None:
            st = tk.tree_split_gini_twin(
                hist[sl], tot[sl], fmask,
                None if node_mask is None else node_mask[sl], splits,
                min_inst[sl], min_gain[sl])
        else:
            st = tk.tree_split_twin(hist[sl], tot[sl], fmask, splits,
                                    min_inst[sl], min_gain[sl], lam[sl])
        for key, v in st.items():
            if not (torch.equal(out[key][sl], v)
                    and torch.equal(again[key][sl], v)):
                raise AssertionError(
                    f"{name} (P {hist.shape[1]}, lanes {a}..): {key} "
                    "differs from the twin's bits")
    return 0.0


def _epilogue_tree(K: int, T: int, D: int, V: int, device, seed: int):
    """fit_trees' level arrays for an epilogue check: empty heaps of T
    nodes with V leaf values and random gain sums (seeded)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.full((K, T), -1, dtype=torch.int32, device=device),
            torch.full((K, T), float("inf"), device=device),
            torch.zeros((K, T), dtype=torch.bool, device=device),
            torch.zeros((K, T, V), device=device),
            torch.rand((K, D), generator=gen, device=device))


def gini_split_case(tk, hist, tot, fmask, mask, splits, mi, mg,
                    reps: int = 10, plain_lanes=None) -> dict:
    """``tree_split_gini`` at one level: the twin's bits and its own on a
    second launch (``_check_split``); the epilogue's tree arrays (feature,
    threshold, is_leaf, the class shares and the gain sums, at offset P - 1
    of [K, 4P - 1] heaps) equal to ``write_level_twin``'s run on the CPU;
    ``ms`` by CUDA events and ``kernel_ms`` by the profiler for the dict
    form, ``epilogue_kernel_ms`` for fit_trees' form (the split and its
    gain walk), the twin's time (on the first ``plain_lanes`` lanes beside
    the kernel's on the same, where the twin's tables of every lane would
    not fit).  The bound reads bins 0 .. NB-2 of the subset features'
    histograms of the nodes that can split (count total >= 2·min_instances:
    the kernel reads no other) once, every node's count total, those
    nodes' other totals and mask rows, the split points, and writes 17
    bytes a node; 6C + 2S + 10 operations a (node, feature, bin) read."""
    import torch
    K, P, D, NB, S = hist.shape
    C = S - 1
    err = _check_split(tk, hist, tot, fmask, mask, splits, mi, mg)
    off, T = P - 1, 4 * P - 1
    tree = _epilogue_tree(K, T, D, C, hist.device, P)
    ref = tuple(t.cpu() for t in tree)
    out = tk.tree_split_gini(hist, tot, fmask, mask, splits, mi, mg,
                             tree=tree, offset=off)
    tk.write_level_twin({**{k: v.cpu() for k, v in out.items()},
                         "value": tk.gini_leaf(tot).cpu()}, ref, off)
    for name, a, b in zip(("feature", "threshold", "is_leaf", "leaf",
                           "gain"), tree, ref):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"tree_split_gini epilogue (P {P}): {name} "
                                 "differs from the twin's bookkeeping")
    can = tot[..., 0] >= 2 * mi[:, None]
    keep = fmask[None, None, :] if mask is None else (mask & fmask)
    kept = int((keep.expand(K, P, D).sum(dim=2) * can).sum())
    n_can = int(can.sum())
    bt, by = bound(4 * kept * (NB - 1) * S + 4 * K * P
                   + n_can * (4 * C + (D if mask is not None else 0)) + D
                   + 4 * splits.numel() + 8 * K + 17 * K * P,
                   (6 * C + 2 * S + 10) * kept * (NB - 1))
    args = (hist, tot, fmask, mask, splits, mi, mg)
    width = None if mask is None else int(mask.sum(dim=2).amax())
    # timed as fit_trees calls it: the subsets' width given
    run = lambda: tk.tree_split_gini(*args, width=width)  # noqa: E731
    dict_ms = kernel_device_ms(run, reps, "tree_split_gini")
    epi_ms = kernel_device_ms(lambda: tk.tree_split_gini(
        *args, tree=tree, offset=off, width=width), reps, "tree_split_gini")
    case = {"lanes": K, "P": P, "classes": C, "nodes_that_can_split": n_can,
            "max_abs_err": err, "same_bits_as_twin": True,
            "epilogue_equal": True, "ms": time_ms(run, reps),
            "kernel_ms": dict_ms["ms"], "kernel_ms_windows": dict_ms,
            "epilogue_kernel_ms": epi_ms["ms"],
            "bound_ms": bt, "bound_by": by, "library_ms": None,
            "plan": tk.gini_split_plan(K, P, D, NB, C, width)}
    if plain_lanes is None:
        case["plain_ms"] = time_ms(lambda: tk.tree_split_gini_twin(*args), 2)
    else:
        sl = slice(0, plain_lanes)
        part = (hist[sl], tot[sl], fmask, None if mask is None else mask[sl],
                splits, mi[sl], mg[sl])
        case[f"ms_{plain_lanes}_lanes"] = time_ms(
            lambda: tk.tree_split_gini(*part, width=width), reps)
        case[f"plain_ms_{plain_lanes}_lanes"] = time_ms(
            lambda: tk.tree_split_gini_twin(*part), 2)
    return case


# each kernel's own kernels, by the identifier of their names in a profile
KERNEL_IDS = {
    "tree_route": ("tree_route_pack_kernel", "tree_route_kernel"),
    "tree_split": ("tree_split_kernel", "tree_split_gain_kernel"),
    "tree_split_gini": ("tree_split_gini_kernel", "tree_split_gain_kernel"),
    "tree_split_variance": ("tree_split_variance_kernel",
                            "tree_split_gain_kernel"),
    "loco_tree": ("loco_tree_kernel",),
    # both forms' partials and the block reduction
    "multiclass_confusion": ("confusion_thread_kernel",
                             "confusion_partials_kernel",
                             "confusion_reduce_kernel"),
    "loco_softmax": ("loco_softmax_rows_kernel", "loco_softmax_kernel"),
    # the tensor-core form's, and the earlier one-tile form's
    "fista_glm": ("fista_glm_kernel", "fista_glm_reduce",
                  "glm_reduce_kernel"),
    "fista_wide_kernels": ("wide_margin_kernel", "wide_loss_kernel",
                           "wide_xtg_kernel", "wide_reduce_kernel"),
    # both sparse kernels' (their namespace, sp_matmat:: or sp_rmatmat::,
    # tells them apart in a profile)
    "sp_segsum": ("segsum_kernel", "finish_kernel")}


def _kernel_id(name: str) -> str:
    """The identifier of a kernel's name in a profile: ``k`` of a demangled
    ``void ns::k<8>(float const*, ...)`` or of a mangled ``_Z1k...``."""
    import re
    m = re.match(r"_Z(\d+)", name)
    if m:
        n = int(m.group(1))
        return name[m.end():m.end() + n]
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split()[-1].split("::")[-1] if head.strip() \
        else name


def _device_ms(kms: dict, *names: str):
    """The device ms a call spent in the kernels ``names`` (``kernel_ms``'s
    table; a name is a kernel's identifier or a key of ``KERNEL_IDS``,
    which stands for that kernel's own kernels); None where the window
    holds none of them.  Matched by identifier, not by a prefix: the xgb
    split's ``tree_split_kernel`` is not the gini split's."""
    ids = {i for n in names for i in KERNEL_IDS.get(n, (n,))}
    found = [v for k, v in kms.items() if _kernel_id(k) in ids]
    return sum(found) if found else None


def kernel_device_ms(fn, reps: int, *names: str, tries: int = 3) -> dict:
    """``_device_ms`` of ``kernel_ms(fn, reps)`` from the first of up to
    ``tries`` profiler windows that shows the kernels ``names``: ``ms``,
    ``windows`` (how many it took) and, where none did, ``seen`` (the
    kernels the last window held) — a window that misses a call's kernels
    is then visible in the result."""
    for w in range(1, tries + 1):
        kms = kernel_ms(fn, reps)
        ms = _device_ms(kms, *names)
        if ms is not None:
            return {"ms": ms, "windows": w}
    return {"ms": None, "windows": tries,
            "seen": sorted({_kernel_id(k) for k in kms})}


def route_case(tk, B, row_node, feat, bin_, leaf, off: int, reps: int = 5,
               plain_reps: int = 2, lane_chunk: int = 50) -> dict:
    """``tree_route`` at one shape.  The kernel routes in place, so it runs
    on copies of ``row_node``: equal to the twin (integer work, exact;
    ``lane_chunk`` lanes a twin call) and to itself on a second launch.
    Timed from a restored copy with a 64 MB buffer written between (the
    ids come cold from device memory, as after the level's histogram and
    split): ``ms`` by CUDA events (restore and route, less the restore
    alone) and ``kernel_ms`` by the profiler (the route kernel alone).  The
    bound reads every id once, writes each moved id once and reads B's
    bytes that the moved rows need once (each (row, feature) pair counted
    once); one compare a moved row."""
    import torch
    K, N = row_node.shape
    D = B.shape[1]
    got = tk.tree_route(B, row_node.clone(), feat, bin_, leaf, off)
    again = tk.tree_route(B, row_node.clone(), feat, bin_, leaf, off)
    if not torch.equal(got, again):
        raise AssertionError(f"tree_route ({K} lanes, offset {off}): two "
                             "launches differ")
    need = torch.zeros(N * D, dtype=torch.bool, device=B.device)
    moved = 0
    for a in range(0, K, lane_chunk):
        sl = slice(a, min(a + lane_chunk, K))
        want = tk.tree_route_twin(B, row_node[sl], feat[sl], bin_[sl],
                                  leaf[sl], off)
        if not torch.equal(got[sl], want):
            raise AssertionError(f"tree_route ({K} lanes, offset {off}, "
                                 f"lanes {a}..) disagrees with its twin")
        kk, nn = torch.nonzero(want != row_node[sl], as_tuple=True)
        moved += kk.numel()
        p = row_node[sl][kk, nn].long() - off
        need[nn * D + feat[sl][kk, p].long()] = True
        del want, kk, nn, p
    del got, again
    bt, by = bound(4 * K * N + 4 * moved + int(need.sum()), moved)
    del need
    work = row_node.clone()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=B.device)

    def restore():
        work.copy_(row_node)
        flush.zero_()

    def run():
        restore()
        tk.tree_route(B, work, feat, bin_, leaf, off)

    case = {"lanes": K, "P": feat.shape[1], "moved": moved,
            "max_abs_err": 0.0, "same_bits_twice": True,
            "ms": max(0.0, time_ms(run, reps) - time_ms(restore, reps)),
            "kernel_ms": _device_ms(kernel_ms(run, reps), "tree_route"),
            "plain_ms": time_ms(lambda: tk.tree_route_twin(
                B, row_node, feat, bin_, leaf, off), plain_reps),
            "bound_ms": bt, "bound_by": by, "library_ms": None}
    if hasattr(tk, "route_plan"):
        case["plan"] = tk.route_plan(N, D, K)
    return case


def split_case(tk, hist, tot, fmask, splits, mi, mg, lam, reps: int = 10,
               plain_reps: int = 2) -> dict:
    """``tree_split`` (xgb) at one level: the twin's bits and its own on a
    second launch (``_check_split``); the epilogue's tree arrays — from
    random gain sums, at offset P - 1 of [K, 4P - 1] heaps — equal to
    ``write_level_twin``'s run on the CPU (its ``scatter_add_`` adds in
    node order); ``ms`` by CUDA events and ``kernel_ms`` by the profiler
    (``kernel_device_ms``: the first of up to three windows that shows the
    split's kernels) for the dict form, ``epilogue_kernel_ms`` for
    fit_trees' form, the twin's time.  The bound reads the histograms of the nodes that can
    split (count total >= 2·min_instances; the kernel reads no other)
    once, the totals, mask and split points once, and writes 21 bytes a
    node; ten operations a (node, feature, bin) read."""
    import torch
    K, P, D, NB, _ = hist.shape
    err = _check_split(tk, hist, tot, fmask, None, splits, mi, mg, lam)
    off, T = P - 1, 4 * P - 1
    tree = _epilogue_tree(K, T, D, 1, hist.device, P)
    ref = tuple(t.cpu() for t in tree)
    out = tk.tree_split(hist, tot, fmask, splits, mi, mg, lam, tree=tree,
                        offset=off)
    tk.write_level_twin({k: v.cpu() for k, v in out.items()}, ref, off)
    for name, a, b in zip(("feature", "threshold", "is_leaf", "leaf",
                           "gain"), tree, ref):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"tree_split epilogue (P {P}): {name} "
                                 "differs from the twin's bookkeeping")
    can = int((tot[..., 0] >= 2 * mi[:, None]).sum())
    bt, by = bound(4 * can * D * NB * 3 + 12 * K * P + D
                   + 4 * splits.numel() + 12 * K + 21 * K * P,
                   10 * can * D * NB)
    args = (hist, tot, fmask, splits, mi, mg, lam)
    run = lambda: tk.tree_split(*args)                   # noqa: E731
    dict_ms = kernel_device_ms(run, reps, "tree_split")
    case = {"lanes": K, "P": P, "nodes_that_can_split": can,
            "max_abs_err": err, "same_bits_as_twin": True,
            "epilogue_equal": True,
            "ms": time_ms(run, reps),
            "kernel_ms": dict_ms["ms"], "kernel_ms_windows": dict_ms,
            "epilogue_kernel_ms": kernel_device_ms(
                lambda: tk.tree_split(*args, tree=tree, offset=off), reps,
                "tree_split")["ms"],
            "plain_ms": time_ms(lambda: tk.tree_split_twin(*args),
                                plain_reps),
            "bound_ms": bt, "bound_by": by, "library_ms": None}
    if hasattr(tk, "xgb_split_plan"):
        case["plan"] = tk.xgb_split_plan(K, P, D, NB)
    return case


def _two_pass(run, refs, reps: int, what: str) -> dict:
    """The two-pass form (``fista_wide``) of a FISTA case on the same
    inputs: each output within 1e-5 of its f64 absolute mass, the same bits
    twice, and its time."""
    import torch
    got, again = run(), run()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{what}, two-pass form: two launches differ")
    err = 0.0
    for g, (want, mass) in zip(got, refs):
        e = (g.double() - want).abs()
        if bool((e > 1e-5 * mass + 1e-12).any()):
            raise AssertionError(f"{what}, two-pass form: disagrees with "
                                 "its f64 twin")
        err = max(err, float(e.max()))
    return {"max_abs_err": err, "ms": time_ms(run, reps)}


def _fista_case(Xd, W, yd, mean, scale, loss: str, G: int, rng,
                reps: int, chunk: int = 131_072,
                two_pass: bool = False) -> dict:
    """``fista_step`` for F x G lanes (F = W's folds) with random
    coefficients (margins of the dense case's size), against its twin run
    in f64: each output within 1e-5 of
    its absolute mass (sum over rows of |x|·|g|: the kernel's tile and block
    sums add in another order than cuBLAS), and two launches bit for bit.
    The f64 reference is summed over row chunks of ``chunk`` rows, so a
    wide matrix needs no f64 copy of itself.  ``two_pass``: the same held
    and timed in the two-pass form too (``two_pass`` of the result).
    Returns the case's row."""
    import torch

    from transmogrifai_tpu_torch.models import linear_kernels as lk
    from transmogrifai_tpu_torch.models.solvers import loss_target

    device = Xd.device
    n, D = Xd.shape
    L = W.shape[0] * G
    lanes = torch.arange(L, device=device) // G
    # coefficients of sd 0.3 on the dense 28 columns, shrunk on a wider
    # matrix so margins keep the same size (not a saturated sigmoid, whose
    # f32 gradient carries no relative precision)
    sd = 0.3 * min(1.0, (N_FEATS / D) ** 0.5)
    coef = torch.as_tensor(rng.normal(scale=sd, size=(L, D)).astype(
        np.float32), device=device)
    V = (coef / scale[lanes]).contiguous()
    b = (torch.zeros(L, device=device) if loss == "gram" else
         torch.as_tensor(rng.normal(scale=0.2, size=L).astype(np.float32),
                         device=device))
    args = (Xd, V, (mean[lanes] * V).sum(dim=1), b, W,
            None if loss == "gram" else loss_target(loss, yd),
            W.sum(dim=1)[lanes], G, loss)
    gx, gs = lk.fista_step(*args)
    gx2, gs2 = lk.fista_step(*args)
    if not (torch.equal(gx, gx2) and torch.equal(gs, gs2)):
        raise AssertionError(f"fista_step ({loss}, D={D}): two launches "
                             "differ")
    want = torch.zeros((L, D), dtype=torch.float64, device=device)
    mass = torch.zeros_like(want)
    gsum = torch.zeros(L, dtype=torch.float64, device=device)
    gabs = torch.zeros_like(gsum)
    V64, muv64, b64, ws64 = (a.double() for a in (V, args[2], b, args[6]))
    for r0 in range(0, n, chunk):
        sl = slice(r0, min(n, r0 + chunk))
        x64 = Xd[sl].double()
        g64 = lk.fista_row_grads(
            x64, V64, muv64, b64, W[:, sl].double(),
            None if args[5] is None else args[5][sl].double(), ws64, G, loss)
        want += g64 @ x64
        mass += g64.abs() @ x64.abs()
        gsum += g64.sum(dim=1)
        gabs += g64.abs().sum(dim=1)
    err = 0.0
    for got, w, m in ((gx, want, mass), (gs, gsum, gabs)):
        e = (got.double() - w).abs()
        if bool((e > 1e-5 * m + 1e-12).any()):
            raise AssertionError(f"fista_step ({loss}, D={D}, {L} lanes) "
                                 "disagrees with its f64 twin")
        err = max(err, float(e.max()))
    two = None
    if two_pass:
        plan = lk.wide_plan(D, L)
        two = _two_pass(lambda: lk.wide_outputs(lk._wide_run(
            Xd, V, args[2], b, W, Xd if args[5] is None else args[5],
            args[6], G, 1, loss, plan), D, L)[:2],
            ((want, mass), (gsum, gabs)), reps,
            f"fista_step ({loss}, D={D}, {L} lanes)")
    g32 = lk.fista_row_grads(*args)
    folds = len(set(lanes.tolist()))
    nbytes = (4 * Xd.numel() + 4 * n * folds
              + (0 if loss == "gram" else 4 * n) + 4 * (2 * L * D + 4 * L))
    bt, by = bound(nbytes, 4 * n * D * L + 8 * n * L)
    return {"name": "fista_step", "lanes": L, "loss": loss, "features": D,
            "two_pass": two,
            "form": lk.launch_plan(D, L)["form"], "max_abs_err": err,
            "split_tf32_bound_ms": split_tf32_bound(nbytes, 4 * n * D * L),
            "ms": time_ms(lambda: lk.fista_step(*args), reps),
            "plain_ms": time_ms(lambda: lk.fista_step_twin(*args), reps),
            "bound_ms": bt, "bound_by": by,
            # the twin's cuBLAS pair of products: margins, then X^T g
            "library_ms": time_ms(lambda: (V @ Xd.T, g32 @ Xd), reps)}


def _fista_row(r: dict) -> dict:
    """A ``_fista_case`` result as a row of the ``kernels`` line."""
    from transmogrifai_tpu_torch.models import kernels
    row = {k: v for k, v in r.items()
           if k not in ("lanes", "loss", "features", "form",
                        "split_tf32_bound_ms", "two_pass")}
    row.update(route="cuda",
               source="transmogrifai_tpu_torch/csrc/fista_step.cu",
               replaces=kernels.REPLACES["fista_step"])
    return row


def check_linear_kernel(device, n: int = N_ROWS, reps: int = 20):
    """``fista_step`` against its twin at the default grid's linear shapes:
    3 folds x 8 logistic lanes (LR), 3 folds x 4 squared-hinge lanes (SVC)
    and the power iteration's 3 "gram" lanes, with random coefficients
    (``_fista_case``).  Returns the logistic row of the ``kernels`` line and
    the other shapes' numbers."""
    import torch

    from transmogrifai_tpu_torch.models.solvers import standardize_moments

    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    W = torch.as_tensor(_fold_weights(y), device=device)
    yd = torch.as_tensor(y, device=device)
    mean, scale = standardize_moments(Xd, W, center=True)
    rng = np.random.default_rng(5)
    out = {loss: _fista_case(Xd, W, yd, mean, scale, loss, G, rng, reps)
           for loss, G in (("logistic", 8), ("squared_hinge", 4),
                           ("gram", 1))}
    return _fista_row(out["logistic"]), out


def check_deep_kernels(device, n: int = N_ROWS, reps: int = 5):
    """The default grid's depth-12 shapes, level 11 (P = 2048, offset 2047)
    at the grid's own lane batches.  The forest: one fold-0 batch of the RF
    depth-12 group (6 grid points x 50 trees, split by ``lane_batches``
    under the card's budget; Poisson(1) x fold weight gini statistics,
    5-of-28 node subsets, each lane its grid point's min_instances and
    min_info_gain, rows spread over the level with some parked above).  The
    GBT: its 6 depth-12 lanes (xgb statistics, every feature).  For each,
    ``tree_hist_deep`` with each lane held to the twin run in f64 within
    1e-5 of each cell's mass; the split kernel on that histogram against
    its twin (rules: ``_check_split``); for the forest also ``tree_route``
    (exact).  The timed ``tree_hist_deep`` row is 8 of the forest lanes,
    kernel, twin and ``index_put_`` on the same inputs.  Then ``tree_walk``
    through a 50-tree depth-12 forest member (8,191 nodes a tree: read from
    device memory) and a 20-tree depth-12 GBT model."""
    import itertools

    import torch

    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import (binned, forest_draws,
                                                      lane_batches, lane_bytes)

    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    D = B.shape[1]
    off, P, n_trees = (1 << (DEEP - 1)) - 1, 1 << (DEEP - 1), 50
    dev = torch.device(device)
    first = lane_batches(6 * n_trees, lane_bytes(n, D, 3, N_BINS, DEEP, dev),
                         dev)[0]
    K = first.stop - first.start
    gen = torch.Generator(device=device).manual_seed(7)
    dr = forest_draws(gen, n_trees=n_trees, n_rows=n, rates=[1.0],
                      max_depth=DEEP,
                      fmask=torch.ones(D, dtype=torch.bool, device=device),
                      features_per_node=int(np.sqrt(D)))
    W = torch.as_tensor(_fold_weights(y), device=device)
    yd = torch.as_tensor(y, device=device)
    base = torch.stack([torch.ones_like(yd), 1.0 - yd, yd], dim=1)
    tree_of_lane = torch.arange(K, device=device) % n_trees
    stats = (base[None] * (dr.boot[1.0][tree_of_lane] * W[0])[:, :, None]
             ).contiguous()
    rng = np.random.default_rng(8)
    row_node = torch.as_tensor(rng.integers(off - 64, off + P, size=(K, n))
                               .astype(np.int32), device=device)
    mask = dr.subsets[DEEP - 1][tree_of_lane].contiguous()
    points = list(itertools.product((10.0, 100.0), (0.001, 0.01, 0.1)))
    mi = torch.tensor([points[k // n_trees][0] for k in range(K)],
                      dtype=torch.float32, device=device)
    mg = torch.tensor([points[k // n_trees][1] for k in range(K)],
                      dtype=torch.float32, device=device)
    fmask = torch.ones(D, dtype=torch.bool, device=device)
    facts = {"forest_lanes": K}

    def lane_check(name, h, t, st, rn, m):
        err = 0.0
        for k in range(h.shape[0]):
            ht, tt = tk.tree_hist_twin(
                B, rn[k:k + 1], st[k:k + 1].double(), off, P, N_BINS,
                node_mask=None if m is None else m[k:k + 1])
            mass, mt = tk.tree_hist_twin(
                B, rn[k:k + 1], st[k:k + 1].double().abs(), off, P, N_BINS,
                node_mask=None if m is None else m[k:k + 1])
            e_h = (h[k:k + 1].double() - ht).abs()
            e_t = (t[k:k + 1].double() - tt).abs()
            if bool((e_h > 1e-5 + 1e-5 * mass).any()
                    or (e_t > 1e-5 + 1e-5 * mt).any()):
                raise AssertionError(f"tree_hist_deep ({name}, lane {k}) "
                                     "disagrees with its twin")
            err = max(err, float(e_h.max()), float(e_t.max()))
        return err

    kernels.reset_launch_counts()
    hist, tot = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                             node_mask=mask)
    if device == "cuda" and kernels.launch_counts()["tree_hist_deep"] != 1:
        raise AssertionError("level 11 did not run tree_hist_deep")
    err = lane_check("forest", hist, tot, stats, row_node, mask)
    facts["forest_hist_ms"] = time_ms(lambda sc=tk.hist_scale(stats):
                                      tk.tree_hist(B, row_node, stats, off,
                                                   P, N_BINS, node_mask=mask,
                                                   scale=sc), reps)
    # the twin's gain tables at 150 x 2048 nodes take tens of GB: it is
    # timed on the first 16 lanes, beside the kernel on the same
    facts["forest_split_gini"] = gini_split_case(
        tk, hist, tot, fmask, mask, sp_t, mi, mg, reps, plain_lanes=16)
    sp = tk.tree_split_gini(hist, tot, fmask, mask, sp_t, mi, mg)
    del hist, tot
    leaf = sp["is_leaf"].clone()
    leaf[:, ::7] = True                   # more nodes that stop splitting
    facts["forest_route"] = route_case(tk, B, row_node, sp["feature"],
                                       sp["bin"], leaf, off, reps)
    del sp, leaf

    # GBT level 11: its 6 lanes of fold-weighted (w, w·g, w·h), no subsets
    margin = rng.normal(scale=0.5, size=(6, n)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-margin))
    wg = np.repeat(_fold_weights(y), 2, axis=0)
    gstats = torch.as_tensor(
        (np.stack([np.ones_like(p), p - y[None], np.maximum(p * (1 - p), 1e-6)],
                  axis=2) * wg[:, :, None]).astype(np.float32), device=device)
    grn = row_node[:6].contiguous()
    h, t = tk.tree_hist(B, grn, gstats, off, P, N_BINS)
    err = max(err, lane_check("gbt", h, t, gstats, grn, None))
    facts["gbt_fixed_point"] = fixed_point_case(tk, B, grn, gstats, off, P)
    facts["gbt_6_lanes_ms"] = time_ms(lambda sc=tk.hist_scale(gstats):
                                      tk.tree_hist(B, grn, gstats, off, P,
                                                   N_BINS, scale=sc), reps)
    gmi, gmg, glam = (torch.tensor(v, dtype=torch.float32, device=device)
                      for v in zip(*((a, b, 1.0) for a, b in points)))
    facts["gbt_split"] = split_case(tk, h, t, fmask, sp_t, gmi, gmg, glam,
                                    reps)
    facts["split_max_abs_err"] = facts["gbt_split"]["max_abs_err"]
    del h, t

    # the timed row: 8 forest lanes, kernel / twin / index_put_
    k8 = 8
    rn8, st8, m8 = (row_node[:k8].contiguous(), stats[:k8].contiguous(),
                    mask[:k8].contiguous())
    pl = rn8.long() - off
    kk, nn = torch.nonzero((pl >= 0) & (pl < P) & (st8 != 0).any(dim=2),
                           as_tuple=True)
    pk = pl[kk, nn] + kk * P
    cell = ((pk[:, None] * D + torch.arange(D, device=device)) * N_BINS
            + B[nn].long())
    keep = m8.reshape(k8 * P, D)[pk]
    flat, vals = cell[keep], st8[kk, nn][:, None, :].expand(
        kk.numel(), D, 3)[keep].contiguous()
    lib_out = torch.zeros((k8 * P * D * N_BINS, 3), device=device)
    live_cells = int(keep.sum())
    bt, by = bound(4 * rn8.numel() + 4 * st8.numel() + m8.numel()
                   + live_cells + 4 * k8 * P * D * N_BINS * 3
                   + 4 * k8 * P * 3, live_cells * 3 + kk.numel() * 3)
    row = {"name": "tree_hist_deep", "route": "cuda",
           "source": "transmogrifai_tpu_torch/csrc/tree_hist_deep.cu",
           "replaces": kernels.REPLACES["tree_hist_deep"], "max_abs_err": err,
           "ms": time_ms(lambda sc=tk.hist_scale(st8): tk.tree_hist(
               B, rn8, st8, off, P, N_BINS, node_mask=m8, scale=sc), reps),
           "plain_ms": time_ms(lambda: tk.tree_hist_twin(
               B, rn8, st8, off, P, N_BINS, node_mask=m8), 3),
           "bound_ms": bt, "bound_by": by,
           "library_ms": time_ms(lambda: lib_out.index_put_(
               (flat,), vals, accumulate=True), 3)}
    facts.update(live_rows_8_lanes=int(kk.numel()), live_cells_8_lanes=live_cells)
    del dr, stats, row_node, mask, lib_out, flat, vals, cell
    torch.cuda.empty_cache()

    # tree_walk at depth 12: a forest member (mean of 50 trees, V = 2) and
    # a GBT model (sum of 20 trees), 13 steps
    for n_trees, classes, op in ((50, 2, "mean"), (20, 0, "sum")):
        trees = _random_trees(device, n_trees, DEEP, D, classes=classes)
        facts[f"tree_walk_{n_trees}_trees_depth_{DEEP}"] = walk_case(
            tk, Xd, trees, DEEP + 1, 1, op, reps=reps, plain_reps=2)
    return row, facts


HIST_LANE_CHUNK = 60               # lanes a call of the twin or index_put_


def bench_binned(device, n: int, n_bins: int = N_BINS) -> tuple:
    """The bench matrix of ``make_data(n)`` binned at ``n_bins`` on the
    card: (y, the bins' split values, B [n, D] uint8)."""
    import torch

    from transmogrifai_tpu_torch.models.trees import binned
    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    _, sp_t, B = binned(Xd, Xd, n_bins)
    return y, sp_t, B


def forest_level_inputs(device, n: int, lanes: int, level: int,
                        seed: int = 5, data=None) -> dict:
    """Inputs of one forest level for ``lanes`` lanes (3 folds x lanes/3
    trees, lane = fold * lanes/3 + tree), as the default grid's forest
    batches launch it (``trees.lane_batches`` sizes them; phase 4's tally
    shows batches of 150, 200 and 300 lanes): gini statistics (w, w·[y=0],
    w·[y=1]) with w = Poisson(1) draw x fold weight, the nodes' 5-of-28
    feature subsets, and rows spread over the level's P = 2^level nodes (a
    fifth of a level's width parked at leaves above it).  ``data``: the
    ``bench_binned(device, n)`` to reuse (else made here)."""
    import torch

    from transmogrifai_tpu_torch.models.trees import forest_draws

    y, _, B = data if data is not None else bench_binned(device, n)
    D = B.shape[1]
    trees = lanes // N_FOLDS
    gen = torch.Generator(device=device).manual_seed(seed)
    dr = forest_draws(gen, n_trees=trees, n_rows=n, rates=[1.0],
                      max_depth=level + 1,
                      fmask=torch.ones(D, dtype=torch.bool, device=device),
                      features_per_node=int(np.sqrt(D)))
    W = torch.as_tensor(_fold_weights(y), device=device)
    bw = (W[:, None, :] * dr.boot[1.0][None]).reshape(lanes, n)
    yd = torch.as_tensor(y, device=device)
    base = torch.stack([torch.ones_like(yd), 1.0 - yd, yd], dim=1)
    stats = (base[None] * bw[:, :, None]).contiguous()
    del bw
    off, P = (1 << level) - 1, 1 << level
    rng = np.random.default_rng(seed)
    row_node = torch.as_tensor(
        rng.integers(max(0, off - max(1, P // 5)), off + P,
                     size=(lanes, n)).astype(np.int32), device=device)
    tree_of_lane = torch.arange(lanes, device=device) % trees
    return {"B": B, "stats": stats, "row_node": row_node, "offset": off,
            "P": P, "mask": dr.subsets[level][tree_of_lane].contiguous()}


def hist_case(tk, B, row_node, stats, off: int, P: int, node_mask=None,
              reps: int = 5, check: bool = True) -> dict:
    """``tree_hist`` at one level: against its f64 twin (integer counts
    equal, 10 lanes a twin call; other statistics lane by lane, each cell
    within 1e-5 of its mass, plus 1e-5), with a node mask the masked
    histogram equal to the full one on the kept cells and zero elsewhere
    (counts: exact), then timed (CUDA events) beside its bound (``B`` read
    once, each lane's node ids and statistics read once, the histogram and
    totals written once; f32 adds of the live rows' cells), the twin's time
    and the time of ``index_put_(accumulate=True)`` on the live (row,
    feature) elements with the indices precomputed — both in calls of
    ``HIST_LANE_CHUNK`` lanes, summed, where more lanes would not fit.  The
    kernel is timed as ``fit_trees`` calls it: the statistics' scale
    (``hist_scale``) read once before."""
    import torch
    K, N = row_node.shape
    D, S = B.shape[1], stats.shape[2]
    # the fit's scale, read once a fit_trees call (a checkout without
    # fixed-point histograms has none)
    fit = ({"scale": tk.hist_scale(stats)} if hasattr(tk, "hist_scale")
           else {})
    hist, tot = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                             node_mask=node_mask, **fit)
    err = 0.0
    if check:
        if node_mask is not None:
            full, tot_f = tk.tree_hist(B, row_node, stats, off, P, N_BINS)
            if not (torch.equal(tot, tot_f) and torch.equal(
                    hist, torch.where(node_mask[..., None, None], full,
                                      0.0))):
                raise AssertionError(
                    f"tree_hist ({K} lanes, P {P}): the node mask changed a "
                    "kept cell or a total, or kept a masked one")
            del full
        # integer counts (a forest's) are exact in f32: equal to the f64
        # twin, 10 lanes a call; else within 1e-5 of each cell's mass
        exact = bool((stats == stats.round()).all())
        step = 10 if exact else 1
        for a in range(0, K, step):
            sl = slice(a, min(a + step, K))
            nm = None if node_mask is None else node_mask[sl]
            ht, tt = tk.tree_hist_twin(B, row_node[sl], stats[sl].double(),
                                       off, P, N_BINS, node_mask=nm)
            e_h = (hist[sl].double() - ht).abs()
            e_t = (tot[sl].double() - tt).abs()
            if exact:
                bad = bool(e_h.any() or e_t.any())
            else:
                mh, mt = tk.tree_hist_twin(
                    B, row_node[sl], stats[sl].double().abs(), off, P,
                    N_BINS, node_mask=nm)
                bad = bool((e_h > 1e-5 + 1e-5 * mh).any()
                           or (e_t > 1e-5 + 1e-5 * mt).any())
            if bad:
                raise AssertionError(
                    f"tree_hist ({K} lanes, P {P}, lanes {a}.., "
                    f"{'masked' if node_mask is not None else 'all'}) "
                    "disagrees with its f64 twin")
            err = max(err, float(e_h.max()), float(e_t.max()))
            del ht, tt, e_h, e_t
    at = row_node.long() - off
    in_level = (at >= 0) & (at < P)
    live = in_level & (stats != 0).any(dim=2)
    per_node = torch.zeros((K, P), device=B.device).scatter_add_(
        1, at.clamp(0, P - 1), live.float())
    width = node_mask.sum(dim=2) if node_mask is not None else D
    cells = int((per_node * width).sum())
    bt, by = bound(B.numel() + 4 * row_node.numel() + 4 * stats.numel()
                   + 4 * (hist.numel() + tot.numel()), cells * S)
    del hist, tot
    chunks = [slice(a, min(a + HIST_LANE_CHUNK, K))
              for a in range(0, K, HIST_LANE_CHUNK)]

    def library(sl):
        kk, nn = torch.nonzero(live[sl], as_tuple=True)
        pk = at[sl][kk, nn] + kk * P
        flat = ((pk[:, None] * D + torch.arange(D, device=B.device))
                * N_BINS + B[nn].long())
        vals = stats[sl][kk, nn][:, None, :].expand(kk.numel(), D, S)
        if node_mask is not None:
            keep = node_mask[sl].reshape(-1, D)[pk]
            flat, vals = flat[keep], vals[keep]
        else:
            flat, vals = flat.reshape(-1), vals.reshape(-1, S)
        out = torch.zeros(((sl.stop - sl.start) * P * D * N_BINS, S),
                          device=B.device)
        return time_ms(lambda: out.index_put_((flat,), vals,
                                              accumulate=True), 2)

    lib = sum(library(sl) for sl in chunks)
    plain = sum(time_ms(lambda sl=sl: tk.tree_hist_twin(
        B, row_node[sl], stats[sl], off, P, N_BINS,
        node_mask=None if node_mask is None else node_mask[sl]), 1)
        for sl in chunks)
    return {"lanes": K, "P": P, "masked": node_mask is not None,
            "rows_live": int(live.sum()), "cells": cells,
            "max_abs_err": err,
            "ms": time_ms(lambda: tk.tree_hist(B, row_node, stats, off, P,
                                               N_BINS, node_mask=node_mask,
                                               **fit), reps),
            "plain_ms": plain, "bound_ms": bt, "bound_by": by,
            "library_ms": lib}


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def build_workflow(X, y, device, draw_device=None):
    """The dense workload of ``bench.run_dense``: LR reg_param x4
    (elastic_net 0.1, max_iter 50) + RF (20 trees, depth 6, min_instances
    10, "auto" subsets, bootstrap) + GBT (20 rounds, depth 3, min_instances
    10), 3-fold CV ranked by AuPR.  ``draw_device`` is where the forest's
    generator draws (default: the fit's device)."""
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import (OpGBTClassifier,
                                                      OpRandomForestClassifier)
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, ModelCandidate, grid)
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow

    D = X.shape[1]
    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    checked = label.sanity_check(transmogrify(feats), remove_bad_features=True)
    selector = BinaryClassificationModelSelector(models=[
        ModelCandidate(OpLogisticRegression(),
                       grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                            elastic_net_param=[0.1], max_iter=[50]),
                       "OpLogisticRegression"),
        ModelCandidate(OpRandomForestClassifier(draw_device=draw_device),
                       grid(num_trees=[N_TREES], max_depth=[RF_DEPTH],
                            min_instances_per_node=[10]),
                       "OpRandomForestClassifier"),
        ModelCandidate(OpGBTClassifier(),
                       grid(max_iter=[20], max_depth=[3],
                            min_instances_per_node=[10]),
                       "OpGBTClassifier")])
    selector.set_input(label, checked)
    pred = selector.get_output()
    cols = {"label": Column(RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = Column(RealNN, X[:, i])
    batch = ColumnBatch(cols, len(y))
    return Workflow(device=device).set_input_batch(batch).set_result_features(pred), batch


def run_main_path(device, n: int, draw_device=None):
    """Train, evaluate and score; returns the run's facts."""
    import torch

    from transmogrifai_tpu_torch.evaluators import Evaluators
    X, y = make_data(n)
    wf, batch = build_workflow(X, y, device, draw_device)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    auroc = float(model.evaluate(Evaluators.BinaryClassification.auROC(),
                                 batch=batch)["AuROC"])
    scored = model.score(batch)
    pred = next(iter(scored.items()))[1].values
    p = pred["probability"]
    if tuple(p.shape) != (n, 2) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"scores: shape {tuple(p.shape)} or non-finite")
    summ = model.selected_model.summary
    fam = {}
    for r in summ.validation_results:
        v = next(iter(r.metric_values.values()))
        if r.model_name not in fam or v > fam[r.model_name]:
            fam[r.model_name] = float(v)
    return {"train_wall_s": wall, "best_model": summ.best_model_name,
            "family_cv_metrics": fam, "train_auroc": auroc,
            "phase_seconds": model.phase_seconds,
            "selector_seconds": model.selected_model.selector_seconds}


def check_small_runs() -> dict:
    """The workflow at 20,000 rows: on the card with the forest's draws made
    on the card (the main path's default) and made on the host, and on the
    CPU twins with host draws.  Host draws on both devices give the same
    forest up to float rounding, so every family agrees within 1e-3; card
    draws are another stream, held statistically: each run's forest CV AuPR
    within RF_CV_AUPR_TOL of the JAX package's and the JAX package's
    winner."""
    runs = {"card_card_draws": run_main_path("cuda", 20_000),
            "card_host_draws": run_main_path("cuda", 20_000, "cpu"),
            "cpu_host_draws": run_main_path("cpu", 20_000, "cpu")}
    for name, r in runs.items():
        rf = r["family_cv_metrics"]["OpRandomForestClassifier"]
        if abs(rf - JAX_20K_RF_CV_AUPR) > RF_CV_AUPR_TOL:
            raise AssertionError(f"small run {name}: forest CV AuPR {rf} is "
                                 f"more than {RF_CV_AUPR_TOL} from the JAX "
                                 f"package's {JAX_20K_RF_CV_AUPR}")
        if r["best_model"] != JAX_20K_WINNER:
            raise AssertionError(f"small run {name}: winner {r['best_model']}"
                                 f", the JAX package's is {JAX_20K_WINNER}")
    gpu, cpu = runs["card_host_draws"], runs["cpu_host_draws"]
    for fam, v in cpu["family_cv_metrics"].items():
        if abs(gpu["family_cv_metrics"][fam] - v) > 1e-3:
            raise AssertionError(f"small run: {fam} CV metric "
                                 f"{gpu['family_cv_metrics'][fam]} on the card "
                                 f"vs {v} on the CPU (same draws)")
    if abs(gpu["train_auroc"] - cpu["train_auroc"]) > 1e-3:
        raise AssertionError("small run: train AuROC differs card vs CPU")
    return {name: {"family_cv_metrics": r["family_cv_metrics"],
                   "best_model": r["best_model"],
                   "train_auroc": r["train_auroc"]}
            for name, r in runs.items()}


def _family_best(summary) -> dict:
    """Best CV AuPR per family over the grid points that ran every fold."""
    best = {}
    for r in summary.validation_results:
        v = float(next(iter(r.metric_values.values())))
        if not r.raced_out and np.isfinite(v) and v > best.get(r.model_name,
                                                               -np.inf):
            best[r.model_name] = v
    return best


def run_default_grid(device, n: int, draw_device=None,
                     with_model: bool = False):
    """``BinaryClassificationModelSelector()`` with no ``models=`` on the
    dense workload: train, evaluate (AuROC) and score; returns the run's
    facts (and, ``with_model``, the fitted model and its batch).
    ``draw_device`` is where the forest family's generator draws (default:
    the fit's device)."""
    import torch

    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow

    X, y = make_data(n)
    D = X.shape[1]
    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    checked = label.sanity_check(transmogrify(feats), remove_bad_features=True)
    selector = BinaryClassificationModelSelector()
    if draw_device is not None:
        for cand in selector.models:
            if cand.model_name == "OpRandomForestClassifier":
                cand.estimator.set("draw_device", draw_device)
    selector.set_input(label, checked)
    pred = selector.get_output()
    cols = {"label": Column(RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = Column(RealNN, X[:, i])
    batch = ColumnBatch(cols, n)
    wf = Workflow(device=device).set_input_batch(batch).set_result_features(
        pred)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    auroc = float(model.evaluate(Evaluators.BinaryClassification.auROC(),
                                 batch=batch)["AuROC"])
    scored = model.score(batch)[pred.name].values
    p = scored["rawPrediction"] if "probability" not in scored else \
        scored["probability"]
    if tuple(p.shape) != (n, 2) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"scores: shape {tuple(p.shape)} or non-finite")
    summ = model.selected_model.summary
    facts = {"train_wall_s": wall, "best_model": summ.best_model_name,
             "family_cv_metrics": _family_best(summ), "train_auroc": auroc,
             "phase_seconds": model.phase_seconds,
             "selector_seconds": model.selected_model.selector_seconds}
    return (facts, model, batch) if with_model else facts


def check_reference_runs() -> dict:
    """The default grid at REF_ROWS rows on the card (forest draws on the
    host) and on the CPU twins (host draws), each held to the JAX package's
    run at that size: LR, SVC and GBT best CV AuPR within 1e-3, the forest
    within REF_RF_TOL, the same winner; card and CPU within 1e-3 of each
    other in every family (the same draws)."""
    runs = {"card_host_draws": run_default_grid("cuda", REF_ROWS, "cpu"),
            "cpu_host_draws": run_default_grid("cpu", REF_ROWS, "cpu")}
    for name, r in runs.items():
        for fam, want in REF_CV_AUPR.items():
            tol = (REF_RF_TOL if fam == "OpRandomForestClassifier" else 1e-3)
            got = r["family_cv_metrics"][fam]
            if abs(got - want) > tol:
                raise AssertionError(f"reference run {name}: {fam} best CV "
                                     f"AuPR {got}, the JAX package's {want} "
                                     f"(tolerance {tol})")
        if r["best_model"] != REF_WINNER:
            raise AssertionError(f"reference run {name}: winner "
                                 f"{r['best_model']}, the JAX package's is "
                                 f"{REF_WINNER}")
    gpu, cpu = runs["card_host_draws"], runs["cpu_host_draws"]
    for fam, v in cpu["family_cv_metrics"].items():
        if abs(gpu["family_cv_metrics"][fam] - v) > 1e-3:
            raise AssertionError(f"reference run: {fam} best CV AuPR "
                                 f"{gpu['family_cv_metrics'][fam]} on the "
                                 f"card vs {v} on the CPU (same draws)")
    return {name: {k: r[k] for k in ("family_cv_metrics", "best_model",
                                     "train_auroc", "train_wall_s")}
            for name, r in runs.items()}


# --------------------------------------------------------------------------
# phase 5: the transmogrification path
# --------------------------------------------------------------------------

def _transmog_ref():
    """``scripts/transmog_reference.py``: the workload's workflow and the
    numbers it is held to, shared with the tests and the JAX-side run."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import transmog_reference
    return transmog_reference


def check_text_kernel(col, device="cuda", reps: int = 20) -> dict:
    """``hash_counts`` on a text column's real token stream at
    ``num_hashes`` = 512 (the packed wire, the null column, the [N, 513]
    block SmartTextVectorizer writes), equal to its twin run on the card;
    with the ``index_put_(accumulate=True)`` library time on the unpacked
    ids.  ``col`` is profiled here, on its own Column instance."""
    import torch

    from transmogrifai_tpu_torch.columns import Column
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.ops import text_kernels as tk
    from transmogrifai_tpu_torch.ops.text_profile import column_profile

    H = TRANSMOG_HASHES
    prof = column_profile(Column(col.kind, col.values))
    ids, off = prof.device_ids(H, torch.device(device))
    null = torch.as_tensor(prof.null, device=device).to(torch.uint8)
    n = off.shape[0] - 1
    out = torch.empty((n, H + 1), device=device)
    twin = torch.empty_like(out)
    tk.hash_counts(ids, off, null, H, out=out)
    tk.hash_counts_twin(ids, off, null, H, twin)
    if not torch.equal(out, twin):
        raise AssertionError("hash_counts disagrees with its twin")
    tokens = int(off[-1])
    if float(out[:, :H].sum()) != float(tokens):
        raise AssertionError("hash_counts lost or invented tokens")
    flat = tk.unpack_ids3(ids)[:tokens]
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   off[1:] - off[:-1])
    lib = torch.zeros((n, H), device=device)
    one = torch.ones((), device=device)
    bt, by = bound(4 * out.numel() + 4 * ids.numel() + 8 * off.numel()
                   + null.numel(), tokens)
    return {"name": "hash_counts", "route": "cuda",
            "source": "transmogrifai_tpu_torch/csrc/hash_counts.cu",
            "replaces": kernels.REPLACES["hash_counts"], "max_abs_err": 0.0,
            "ms": time_ms(lambda: tk.hash_counts(ids, off, null, H, out=out),
                          reps),
            "plain_ms": time_ms(lambda: tk.hash_counts_twin(
                ids, off, null, H, twin), 5),
            "bound_ms": bt, "bound_by": by,
            "library_ms": time_ms(lambda: lib.index_put_(
                (rows, flat), one, accumulate=True), 5),
            "rows": n, "tokens": tokens}


def check_wide_fista(model, batch, device="cuda", reps: int = 5):
    """``fista_step`` at the transmogrified width on the main path's own
    checked matrix (the fitted DAG up to the selector, applied to the train
    batch): 3 folds x 2 logistic lanes (the CV block), the refit's one lane
    and the power iteration's 3 "gram" lanes (``_fista_case``).  Returns the
    CV shape's row and every shape's numbers."""
    import torch

    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.models.solvers import standardize_moments

    sel = model.selected_model
    label_f, vec_f = sel.input_features
    scored = apply_dag(batch.on(device), model.fitted_dag[:-1])
    Xd = scored[vec_f.name].values.contiguous()
    del scored
    y = np.asarray(batch[label_f.name].values, np.float32)
    yd = torch.as_tensor(y, device=device)
    W = torch.as_tensor(_fold_weights(y), device=device)
    rng = np.random.default_rng(6)
    out = {}
    for name, Wc, loss, G in (("cv_logistic", W, "logistic", 2),
                              ("screen_logistic", W[:1], "logistic", 8),
                              ("refit_logistic", torch.ones_like(W[:1]),
                               "logistic", 1),
                              ("gram", W, "gram", 1)):
        mean, scale = standardize_moments(Xd, Wc, center=True)
        out[name] = _fista_case(Xd, Wc, yd, mean, scale, loss, G, rng, reps)
        del mean, scale
        torch.cuda.empty_cache()
    return [_fista_row(out["cv_logistic"]),
            _fista_row(out["screen_logistic"])], out


def transmog_lr_selector():
    """The transmog workload's selector (LR over ``REG_PARAMS``), fresh."""
    from transmogrifai_tpu_torch import selector as S
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    return S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        OpLogisticRegression(),
        S.grid(reg_param=list(_transmog_ref().REG_PARAMS), max_iter=[50]),
        "OpLogisticRegression")])


def profile_lr_cv(model, batch, selector, device="cuda", top: int = 8,
                  around=None, kernels=()):
    """A ``torch.profiler`` window over one LR cross-validation on a main
    path's own vector: ``selector``'s validator over its candidates (racing
    as the selector runs it) on the output of ``model``'s fitted DAG up to
    its selector, after a warm-up run.  Returns the window's host wall, the
    same CV's wall unprofiled, the device-busy seconds (the union of the
    kernels' intervals) and share of the window, the kernel launches and
    the top kernels by device time; with ``kernels`` (``_device_ms``
    names) also every kernel of theirs by full name (``by_kernel``: ms and
    count); ``around`` (a context manager) is entered around the profiled
    run alone."""
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transmogrifai_tpu_torch.dag import apply_dag
    label_f, vec_f = model.selected_model.input_features
    scored = apply_dag(batch.on(device), model.fitted_dag[:-1])

    def run():
        selector.validator.validate(selector.models, scored, label_f.name,
                                    vec_f.name, splitter=selector.splitter)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    plain = time.perf_counter() - t0
    with around if around is not None else contextlib.nullcontext(), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    spans, by = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        d = by.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.elapsed_us()
        d[1] += 1
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e6
    ranked = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    ids = {i for n in kernels for i in KERNEL_IDS.get(n, (n,))}
    return {"unprofiled_wall_s": plain, "window_wall_s": wall,
            "device_events": len(spans), "device_busy_s": busy,
            "device_busy_share": busy / wall if spans else None,
            "top_kernels": [{"name": k[:90], "ms": v[0] / 1e3, "count": v[1]}
                            for k, v in ranked],
            "by_kernel": {k[:90]: {"ms": v[0] / 1e3, "count": v[1]}
                          for k, v in by.items() if _kernel_id(k) in ids}}


def profile_glm_cv(model, batch, family: str, device="cuda") -> dict:
    """``profile_lr_cv`` over a GLM workload's GLM cross-validation (the
    family over the default reg_params, 3 folds, racing) on its own
    vector: the device-busy share, ``fista_glm``'s device ms by kernel
    (``by_kernel``: ``fista_glm_kernel<NT, ...>`` with NT column tiles of 8
    — here the 12-lane gradient form is NT = 2, a ladder's 96 trial lanes
    the value form's NT = 8 and NT = 4 launches), and the wrapper's calls
    in the window by form with their launches, and the ladder passes (one
    value call each: ``FistaLoop._backtrack`` waits for the card once a
    pass)."""
    import contextlib

    from transmogrifai_tpu_torch import selector as S
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import linear_kernels as lk
    from transmogrifai_tpu_torch.models import solvers
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import glm_grid_reference as ggr
    calls = {"gradient": 0, "value": 0}
    launches = {"gradient": 0, "value": 0}
    real = lk.fista_glm

    def counted(*a, **kw):
        form = "gradient" if kw.get("grad", a[9] if len(a) > 9 else True) \
            else "value"
        before = kernels.LAUNCHES["fista_glm"]
        out = real(*a, **kw)
        calls[form] += 1
        launches[form] += kernels.LAUNCHES["fista_glm"] - before
        return out

    @contextlib.contextmanager
    def patched():
        lk.fista_glm = solvers.fista_glm = counted
        try:
            yield
        finally:
            lk.fista_glm = solvers.fista_glm = real

    sel = S.RegressionModelSelector(models=ggr.glm_models(PORT, family)[:1])
    out = profile_lr_cv(model, batch, sel, device, top=8, around=patched(),
                        kernels=("fista_glm", "fista_tc_kernel"))
    out.update(fista_glm_calls=calls, fista_glm_launches=launches,
               ladder_passes=calls["value"],
               fista_glm_device_ms=sum(
                   v["ms"] for k, v in out["by_kernel"].items()
                   if _kernel_id(k) in KERNEL_IDS["fista_glm"]))
    return out


def run_transmog(device, cols, schema, n: int, score_cols=None) -> tuple:
    """The transmogrification workflow (``bench.run_transmog``): train,
    evaluate (AuROC) and, given ``score_cols``, score that fresh batch with
    its predictions materialised.  Returns (facts, model, batch)."""
    import torch

    tr = _transmog_ref()
    wf, batch, pred = tr.build(PORT, cols, schema, n, device=device)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    facts = {"train_wall_s": time.perf_counter() - t0,
             **tr.facts(PORT, model, batch),
             "phase_seconds": model.phase_seconds,
             "rff_dropped": [f.name for f in model.blacklisted]}
    if score_cols is not None:
        from transmogrifai_tpu_torch.columns import ColumnBatch
        fresh = ColumnBatch(score_cols, n)
        t0 = time.perf_counter()
        p = model.score(fresh)[pred.name].values["probability"]
        float(p[:8].sum())                   # materialised on the host
        wall = time.perf_counter() - t0
        if tuple(p.shape) != (n, 2) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"transmog scores: shape {tuple(p.shape)} "
                                 "or non-finite")
        facts.update(score_wall_s=wall, score_rows_per_s=n / wall)
        del p
    return facts, model, batch


def check_transmog_reference() -> dict:
    """The workflow at TRANSMOG_REF_ROWS rows on the card and on the CPU
    twins, each held to the JAX package's run at that size (constants
    above): the same checked width, dropped columns and winner, Cramér's V
    per group within 1e-5, each candidate's CV AuPR and the train AuROC
    within 1e-4."""
    from transmogrifai_tpu_torch.synthetic import make_transmog_columns

    runs = {}
    for device in ("cuda", "cpu"):
        cols, schema = make_transmog_columns(TRANSMOG_REF_ROWS)
        runs[device], _, _ = run_transmog(device, cols, schema,
                                          TRANSMOG_REF_ROWS)
    ref = TRANSMOG_REF
    for device, r in runs.items():
        bad = []
        if r["width"] != ref["width"] or r["dropped"] != ref["dropped"]:
            bad.append(f"width {r['width']} / dropped {r['dropped']}")
        if r["winner"] != ref["winner"]:
            bad.append(f"winner {r['winner']}")
        if r["cramers_v"].keys() != ref["cramers_v"].keys():
            bad.append(f"Cramér's V groups {sorted(r['cramers_v'])}")
        for g, v in ref["cramers_v"].items():
            got = r["cramers_v"].get(g)
            if (got is None) != (v is None) or (
                    v is not None and abs(got - v) > 1e-5):
                bad.append(f"Cramér's V of {g}: {got}")
        for c, v in ref["cv_aupr"].items():
            if abs(r["cv_aupr"][c] - v) > 1e-4:
                bad.append(f"CV AuPR of {c}: {r['cv_aupr'][c]}")
        if abs(r["train_auroc"] - ref["train_auroc"]) > 1e-4:
            bad.append(f"train AuROC {r['train_auroc']}")
        if bad:
            raise AssertionError(f"transmog reference run on {device} "
                                 f"differs from the JAX package's: {bad}")
    return {d: {k: r[k] for k in ("width", "cv_aupr", "winner",
                                  "train_auroc", "train_wall_s")}
            for d, r in runs.items()}


# --------------------------------------------------------------------------
# phase 6: the sparse hashed-text path
# --------------------------------------------------------------------------

def _sparse_ref():
    """``scripts/sparse_reference.py``: the workload's workflow and the
    numbers it is held to, shared with the tests and the JAX-side run."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import sparse_reference
    return sparse_reference


def skewed_coo(n: int = 200_003, d: int = 110_003, seed: int = 8):
    """COO triples of the sparse kernels' hazards: ~9 random entries a row
    (duplicates possible), column 7 holding every row but the empty ones
    (every 13th), row 11 holding 100,000 entries, and empty columns (the
    last 1,000)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 9)
    c = rng.integers(0, d - 1000, r.size)
    r = np.concatenate([r, np.arange(n), np.full(100_000, 11)])
    c = np.concatenate([c, np.full(n, 7), rng.permutation(d - 1000)[:100_000]])
    keep = r % 13 != 0
    r, c = r[keep], c[keep]
    return r, c, rng.normal(size=r.size).astype(np.float32), n, d


def _sparse_case(X, k: int, rng, reps: int = 0) -> dict:
    """``sp_matmat`` and ``sp_rmatmat`` on ``X`` at ``k`` dense columns
    against their twins run in f64: each output within 1e-5 of its absolute
    mass, two launches bit for bit, and on the card the bits of the numpy
    emulation of the kernels' order (``segsum_emulate``).  With ``reps``,
    the times (kernel by CUDA events and its device ms by the profiler,
    the f32 twin, ``torch.sparse.mm`` on a CSR tensor) and the bound."""
    import torch

    from transmogrifai_tpu_torch.sparse import sparse_kernels as sk

    dev = X.device
    M = torch.as_tensor(rng.normal(size=(X.n_cols, k)).astype(np.float32),
                        device=dev)
    G = torch.as_tensor(rng.normal(size=(X.n_rows, k)).astype(np.float32),
                        device=dev)
    out = {}
    for name, fn, twin, dense, n_out in (
            ("sp_matmat", sk.sp_matmat, sk.sp_matmat_twin, M, X.n_rows),
            ("sp_rmatmat", sk.sp_rmatmat, sk.sp_rmatmat_twin, G, X.n_cols)):
        got, again = fn(X, dense), fn(X, dense)
        if not torch.equal(got, again):
            raise AssertionError(f"{name} (k={k}): two launches differ")
        order, plan = ((X.row_order(), X.row_plan()) if name == "sp_matmat"
                       else (X.col_order(), X.col_plan()))
        if dev.type == "cuda" and not np.array_equal(
                got.cpu().numpy().view(np.uint32),
                sk.segsum_emulate(order, plan, dense).view(np.uint32)):
            raise AssertionError(f"{name} (k={k}, nnz={X.nnz}) differs from "
                                 "the emulation of its order")
        args = (X.values.double(), X.indices, X.row_ids)
        want = twin(*args, dense.double(), n_out)
        mass = twin(args[0].abs(), *args[1:], dense.double().abs(), n_out)
        e = (got.double() - want).abs()
        if bool((e > 1e-5 * mass + 1e-12).any()):
            raise AssertionError(f"{name} (k={k}, nnz={X.nnz}) disagrees "
                                 "with its f64 twin")
        row = {"k": k, "max_abs_err": float(e.max()) if e.numel() else 0.0}
        if reps:
            csr = torch.sparse_csr_tensor(order.ptr, order.gather.long(),
                                          order.values,
                                          size=(n_out, dense.shape[0]))
            # values and gather index per entry, the pointers (4 bytes
            # each: nnz < 2^31), the dense operand and the output, each
            # once; 2 operations an entry and column
            bt, by = bound(8 * X.nnz + 4 * (n_out + 1) + 4 * dense.numel()
                           + 4 * n_out * k, 2 * X.nnz * k)
            row.update(
                ms=time_ms(lambda: fn(X, dense), reps),
                device_ms=kernel_device_ms(lambda: fn(X, dense), reps,
                                           "sp_segsum")["ms"],
                plain_ms=time_ms(lambda: twin(X.values, X.indices, X.row_ids,
                                              dense, n_out), reps),
                bound_ms=bt, bound_by=by,
                library_ms=time_ms(lambda: torch.sparse.mm(csr, dense),
                                   reps))
        out[name] = row
    return out


def sparse_matrix_of(cols, device="cuda"):
    """The workload's feature matrix of ``cols`` and the host split of its
    text stage: transmogrify([txt, x0]) at 100,000 hashes fitted and
    applied through its own workflow, on copies of the columns (so their
    text profiles are not cached on the columns that the timed run trains
    on).  The split times the native text scan, then the host dedupe and
    upload of the hashed tokens (``sparse_from_hash_flat``) alone, then the
    workflow, whose SmartTextVectorizer reuses the scan."""
    import torch

    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.text_profile import column_profile
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.sparse.transform import sparse_from_hash_flat
    from transmogrifai_tpu_torch.workflow import Workflow

    copies = {k: Column(c.kind, c.values, c.mask) for k, c in cols.items()}
    t0 = time.perf_counter()
    prof = column_profile(copies["txt"])
    t1 = time.perf_counter()
    sparse_from_hash_flat(*prof.buckets(SPARSE_HASHES), SPARSE_HASHES,
                          record=False, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    fv = transmogrify([FeatureBuilder.Text("txt").as_predictor(),
                       FeatureBuilder.Real("x0").as_predictor()],
                      num_hashes=SPARSE_HASHES)
    batch = ColumnBatch(copies, len(cols["txt"]))
    model = (Workflow(device=device).set_input_batch(batch)
             .set_result_features(fv).train())
    split = {"text_scan_s": t1 - t0, "dedupe_and_upload_s": t2 - t1,
             "phase_seconds_after_scan": model.phase_seconds}
    return model.score()[fv.name].values, split


def check_sparse_kernels(X, reps: int = 20):
    """Both sparse kernels on the 1M run's own matrix ``X`` at k = 1, 3, 6
    (the refit's and scoring's one lane, the power iteration's 3 folds, the
    CV block's 6 lanes) and on ``skewed_coo`` at k = 1, 6, 32, each timed
    beside its bound, its twin and ``torch.sparse.mm`` (``_sparse_case``).  Returns the two rows of the ``kernels`` line and
    every case's numbers, with each order's plan (``SegmentPlan.summary``:
    team, light and heavy segments, tiles, pieces)."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix

    rng = np.random.default_rng(9)
    facts = {f"run k={k}": _sparse_case(X, k, rng, reps) for k in (1, 3, 6)}
    skew = SparseMatrix.from_coo(*skewed_coo(), device=X.device)
    facts.update({f"skewed k={k}": _sparse_case(skew, k, rng, reps)
                  for k in (1, 6, 32)})
    plans = {f"{m} {o}": getattr(Y, f"{o}_plan")().summary()
             for m, Y in (("run", X), ("skewed", skew))
             for o in ("row", "col")}
    rows = []
    for name in ("sp_matmat", "sp_rmatmat"):
        r = dict(facts["run k=6"][name])
        r["max_abs_err"] = max(f[name]["max_abs_err"] for f in facts.values())
        del r["k"]
        r.update(name=name, route="cuda",
                 source=f"transmogrifai_tpu_torch/csrc/{name}.cu",
                 replaces=kernels.REPLACES[name])
        rows.append(r)
    return rows, {"nnz": X.nnz, "skewed_nnz": skew.nnz, "plans": plans,
                  **facts}


def run_sparse(device, n: int, cols=None, score_cols=None) -> tuple:
    """The sparse-text workflow (``bench.run_text_sparse``): train, evaluate
    (AuROC) and, given ``score_cols``, score that fresh batch with its
    predictions materialised.  Returns (facts, model, batch)."""
    import torch

    from transmogrifai_tpu_torch.columns import ColumnBatch

    sr = _sparse_ref()
    wf, batch, pred = sr.build(
        PORT, n, batch=None if cols is None else ColumnBatch(cols, n),
        device=device)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    facts = {"train_wall_s": time.perf_counter() - t0,
             **sr.facts(PORT, model, batch),
             "phase_seconds": model.phase_seconds,
             "selector_seconds": model.selected_model.selector_seconds}
    if score_cols is not None:
        fresh = ColumnBatch(score_cols, n)
        t0 = time.perf_counter()
        p = model.score(fresh)[pred.name].values["probability"]
        float(p[:8].sum())                   # materialised on the host
        wall = time.perf_counter() - t0
        if tuple(p.shape) != (n, 2) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"sparse scores: shape {tuple(p.shape)} or "
                                 "non-finite")
        facts.update(score_wall_s=wall, score_rows_per_s=n / wall)
        del p
    return facts, model, batch


def profile_sparse_cv(model, batch, device="cuda") -> dict:
    """``profile_lr_cv`` over the sparse workload's LR cross-validation (2
    reg_params x 3 folds, racing) on its own 1M x 100,003 matrix: the
    device-busy share, and each sparse kernel's device ms and kernel
    launches in the window (``by_kernel`` grouped by namespace) beside its
    wrapper's calls."""
    import contextlib

    from transmogrifai_tpu_torch import selector as S
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    names = ("sp_matmat", "sp_rmatmat")
    calls = {}

    @contextlib.contextmanager
    def counted():
        before = {n: kernels.LAUNCHES[n] for n in names}
        yield
        calls.update({n: kernels.LAUNCHES[n] - before[n] for n in names})

    sel = S.BinaryClassificationModelSelector(models=[S.ModelCandidate(
        OpLogisticRegression(),
        S.grid(reg_param=list(_sparse_ref().REG_PARAMS), max_iter=[50]),
        "OpLogisticRegression")])
    out = profile_lr_cv(model, batch, sel, device, around=counted(),
                        kernels=("sp_segsum",))
    out["sparse_kernels"] = {
        n: {"device_ms": sum(v["ms"] for k, v in out["by_kernel"].items()
                             if f"{n}::" in k),
            "kernel_launches": sum(v["count"] for k, v in
                                   out["by_kernel"].items() if f"{n}::" in k),
            "wrapper_calls": calls.get(n)} for n in names}
    return out


def check_sparse_reference() -> dict:
    """The workflow at SPARSE_REF_ROWS rows on the card and on the CPU
    twins, each held to the JAX package's run at that size (SPARSE_REF):
    the same width, nnz and winner, each candidate's CV AuPR and the train
    AuROC within SPARSE_REF_TOL."""
    ref, tol = SPARSE_REF, SPARSE_REF_TOL
    runs = {}
    for device in ("cuda", "cpu"):
        r, _, _ = run_sparse(device, SPARSE_REF_ROWS)
        bad = [f"{k} {r[k]}" for k in ("width", "nnz", "winner")
               if r[k] != ref[k]]
        bad += [f"CV AuPR of {c}: {r['cv_aupr'].get(c)}"
                for c, v in ref["cv_aupr"].items()
                if not abs(r["cv_aupr"].get(c, np.inf) - v) <= tol]
        if not abs(r["train_auroc"] - ref["train_auroc"]) <= tol:
            bad.append(f"train AuROC {r['train_auroc']}")
        if bad:
            raise AssertionError(f"sparse reference run on {device} differs "
                                 f"from the JAX package's: {bad}")
        runs[device] = {k: r[k] for k in ("width", "nnz", "cv_aupr",
                                          "winner", "train_auroc",
                                          "train_wall_s")}
    return runs


# --------------------------------------------------------------------------
# phase 7: explanations
# --------------------------------------------------------------------------

LOCO_K = 20                        # RecordInsightsLOCO's default top_k
THRESHOLD_ROWS = 200_000           # loco_softmax's checks at its threshold
LOCO_TOL = 1e-5                    # kernel vs twin, of the twin's max|diff|
BENCH_LOCO = (100_000, 512, 128)   # scripts/bench_loco.py's rows, cols, groups


def _loco_case(run, twin, G: int, k: int, strategy: str, reps: int,
               in_bytes: float, ops: float, library=None) -> dict:
    """A LOCO kernel call ``run()`` against ``twin(k)`` (the plain version
    on the same inputs): the kernel's diff of each group it lists within
    LOCO_TOL x max|diff| of the twin's diff of that group, the ranks at
    each of the K places within that of the twin's (so the groups agree
    wherever the twin's rank gap exceeds it), no group listed twice, and
    the same bits on two launches.  Its bound counts ``in_bytes`` read and
    the outputs written in the types the call returns (the indices in
    ``index_dtype(G)``).  Returns its numbers."""
    import torch

    from transmogrifai_tpu_torch.insights_kernels import _rank
    idx, val = run()
    idx2, val2 = run()
    if not (torch.equal(idx, idx2) and torch.equal(val, val2)):
        raise AssertionError("LOCO kernel: two launches differ")
    fi, fv = twin(G)                                  # every group, sorted
    full = torch.empty_like(fv).scatter_(1, fi.long(), fv)
    tol = LOCO_TOL * float(fv.abs().max())
    ki = idx.long()
    err = float((val - torch.gather(full, 1, ki)).abs().max())
    gap = float((_rank(val, strategy) - _rank(fv[:, :k], strategy))
                .abs().max())
    dup = bool((torch.sort(ki, dim=1).values.diff(dim=1) == 0).any())
    if err > tol or gap > tol or dup:
        raise AssertionError(f"LOCO kernel disagrees with its twin: diff err "
                             f"{err}, rank err {gap}, tolerance {tol}, "
                             f"duplicate groups {dup}")
    out_bytes = (idx.numel() * idx.element_size()
                 + val.numel() * val.element_size())
    bt, by = bound(in_bytes + out_bytes, ops)
    return {"max_abs_err": err, "max_abs_diff": float(fv.abs().max()),
            "ms": time_ms(run, reps), "plain_ms": time_ms(lambda: twin(k), 1),
            "bound_ms": bt, "bound_by": by,
            "library_ms": None if library is None else time_ms(library, 3),
            "G": G, "k": k}


def _linear_library(X, model, col_group, G: int, k: int):
    """The library yardstick of ``loco_linear``: the group contributions as
    one cuBLAS product ``X @ (w ⊙ onehot[D, G])``, then the model's link
    (the sigmoid, the identity, a GLM's inverse link of the clipped
    margin), the diffs and ``torch.topk``."""
    import torch

    from transmogrifai_tpu_torch.insights_kernels import linear_link
    coef = torch.as_tensor(model.fitted["coef"], dtype=torch.float32,
                           device=X.device).reshape(-1)
    b = float(torch.as_tensor(model.fitted["intercept"]).reshape(-1)[0])
    W = torch.zeros((X.shape[1], G), device=X.device)
    W[torch.arange(X.shape[1], device=X.device), col_group.long()] = coef

    def clip(m):
        return torch.clamp(m, -30.0, 30.0)

    link = {"logistic": torch.sigmoid, "identity": lambda m: m,
            "clipped_exp": lambda m: torch.exp(clip(m)),
            "clipped_logistic": lambda m: torch.sigmoid(clip(m)),
            "clipped_identity": clip}[linear_link(model.fitted)]

    def run():
        m = X @ coef + b
        diffs = link(m)[:, None] - link(m[:, None] - X @ W)
        return torch.topk(diffs.abs(), k, dim=1)
    return run


def check_loco_linear(X, model, col_group, G: int, k: int = LOCO_K,
                      strategy: str = "abs", reps: int = 10,
                      library: bool = False) -> dict:
    """``loco_linear`` on X against its twin (``_loco_case``)."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    N, D = X.shape
    return _loco_case(
        lambda: ik.loco_linear(X, model, col_group, G, k, strategy),
        lambda kk: ik.loco_topk_twin(
            X, lambda Z: ik.loco_score(model, Z), col_group, G, kk,
            strategy), G, k, strategy, reps,
        4 * N * D, 4 * N * D,
        _linear_library(X, model, col_group, G, k) if library else None)


def _loco_walk_steps(X, trees: dict, col_group, G: int) -> int:
    """Split nodes that LOCO's walks must pass on this run's data: every
    row's unmasked walk through every tree, and for each group g only the
    trees whose unmasked walk reads a feature of g, walked again from the
    first node that reads one (above it the masked walk is the unmasked
    walk, and a tree that never reads g keeps its leaf)."""
    import torch
    feat, thr, leaf = trees["feature"], trees["threshold"], trees["is_leaf"]
    Tr, T = feat.shape
    cg = col_group.long()
    ar = torch.arange(Tr, device=X.device)[None, :]
    steps = 0
    for g in [-1] + list(range(G)):                  # -1: the unmasked walk
        node = torch.zeros((X.shape[0], Tr), dtype=torch.long,
                           device=X.device)
        counted = torch.full_like(node, g < 0, dtype=torch.bool)
        for _ in range(trees["steps"]):
            live = ~leaf[ar, node]
            f = torch.clamp(feat[ar, node].long(), min=0)
            masked = cg[f] == g
            counted |= live & masked
            steps += int((live & counted).sum())
            xf = torch.where(masked, 0.0, torch.gather(X, 1, f))
            nxt = 2 * node + 1 + (xf > thr[ar, node]).long()
            node = torch.where(live & (nxt < T), nxt, node)
    return steps


def check_loco_tree(X, model, col_group, G: int, k: int = LOCO_K,
                    strategy: str = "abs", reps: int = 5) -> dict:
    """``loco_tree`` on X against its twin (``_loco_case``); its bound counts
    X read once, the output written once, and a compare per split node of
    the walks the function needs (``_loco_walk_steps``)."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    N, D = X.shape
    return _loco_case(
        lambda: ik.loco_tree(X, model, col_group, G, k, strategy),
        lambda kk: ik.loco_topk_twin(
            X, lambda Z: ik.loco_score(model, Z), col_group, G, kk,
            strategy), G, k, strategy, reps,
        4 * N * D,
        _loco_walk_steps(X, ik.tree_inputs(model.fitted, X.device),
                         col_group, G))


def _loco_stage(model, vec_f, batch, k: int = LOCO_K) -> tuple:
    """``RecordInsightsLOCO(model, top_k=k)`` on ``batch``'s ``vec_f``
    column through its transform (the user's entry point), maps included;
    returns (maps, wall seconds)."""
    from transmogrifai_tpu_torch.record_insights import RecordInsightsLOCO
    loco = RecordInsightsLOCO(model=model, top_k=k)
    loco.set_input(vec_f)
    t0 = time.perf_counter()
    maps = loco.transform(batch).values
    return maps, time.perf_counter() - t0


def _check_maps(maps, n: int, k: int, names) -> None:
    row = maps[n // 2]
    if len(maps) != n or len(row) != k or not set(row) <= set(names):
        raise AssertionError(f"LOCO maps: {len(maps)} rows, a row of "
                             f"{len(row)} groups")
    for name, payload in row.items():
        pair = json.loads(payload)
        if pair[0][0] != name or not np.isfinite(pair[0][1]):
            raise AssertionError(f"LOCO payload {payload!r}")


def run_insights_main_path(tm_model, tm_batch, grid_model, grid_batch,
                           device="cuda") -> tuple:
    """The explanation path: ``RecordInsightsLOCO`` (top-20) through its
    transform on the transmog LR winner over its own 1M x 1,596 checked
    vector (grouped by raw parent), on the default grid's winner over its
    own 1M x 28 checked vector (one group per raw feature), and on the
    bench set's forest (20 trees, depth 6), fitted here on that vector.
    Returns (facts, the launch counts of the three transforms alone, the
    inputs of the kernel checks)."""
    import torch

    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models.trees import (OpRandomForestClassifier,
                                                      TreeEnsembleModel)
    from transmogrifai_tpu_torch.record_insights import loco_groups

    def checked(model, batch):
        sel = model.selected_model
        vec_f = sel.input_features[1]
        scored = apply_dag(batch.on(device), model.fitted_dag[:-1])
        return sel, vec_f, scored.select([vec_f.name])

    tm_sel, tm_f, tm_in = checked(tm_model, tm_batch)
    gd_sel, gd_f, gd_in = checked(grid_model, grid_batch)
    label = grid_batch[grid_model.selected_model.input_features[0].name]
    t0 = time.perf_counter()
    rf = TreeEnsembleModel(fitted=OpRandomForestClassifier(
        num_trees=N_TREES, max_depth=RF_DEPTH,
        min_instances_per_node=10).fit_arrays(
            gd_in[gd_f.name].values, np.asarray(label.values, np.float32)))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    kernels.reset_launch_counts()
    maps_tm, wall_tm = _loco_stage(tm_sel, tm_f, tm_in)
    maps_gd, wall_gd = _loco_stage(gd_sel, gd_f, gd_in)
    maps_rf, wall_rf = _loco_stage(rf, gd_f, gd_in)
    launches = kernels.launch_counts()
    tm_vec, gd_vec = tm_in[tm_f.name], gd_in[gd_f.name]
    names_tm = list(loco_groups(tm_vec.meta, tm_vec.values.shape[1]))
    names_gd = list(loco_groups(gd_vec.meta, gd_vec.values.shape[1]))
    _check_maps(maps_tm, N_ROWS, min(LOCO_K, len(names_tm)), names_tm)
    _check_maps(maps_gd, N_ROWS, min(LOCO_K, len(names_gd)), names_gd)
    _check_maps(maps_rf, N_ROWS, min(LOCO_K, len(names_gd)), names_gd)
    facts = {"transmog_groups": len(names_tm),
             "transmog_width": int(tm_vec.values.shape[1]),
             "default_grid_winner": type(gd_sel.best_model).__name__,
             "default_grid_winner_kind": gd_sel.best_model.fitted.get("kind"),
             "default_grid_groups": len(names_gd),
             "loco_wall_s": {"transmog_lr": wall_tm,
                             "default_grid_winner": wall_gd, "rf": wall_rf},
             "loco_rows_per_s": {"transmog_lr": N_ROWS / wall_tm,
                                 "default_grid_winner": N_ROWS / wall_gd,
                                 "rf": N_ROWS / wall_rf},
             "rf_fit_s": fit_s, "row0_transmog": maps_tm[0],
             "row0_default_grid": maps_gd[0]}
    return facts, launches, {"tm": (tm_vec, tm_sel), "dense": gd_vec,
                             "winner": gd_sel.best_model, "rf": rf}


def check_insights_kernels(inputs, device="cuda") -> tuple:
    """Both LOCO kernels against their twins: ``loco_linear`` on the
    transmog LR winner's 1M x 1,596 vector (top-20 of its raw-parent
    groups) and at ``scripts/bench_loco.py``'s shape (100,000 x 512, 128
    groups and the meta-less 512, top-20, logistic, an LR fitted there;
    with the cuBLAS library yardstick), and once each with the "positive"
    and "negative" strategies and an SVC link; ``loco_tree`` on the default
    grid's winner (a GBT) and the forest at 1M x 28 (28 groups, top-20).
    Returns the two rows of the ``kernels`` line (``loco_tree``'s timed on
    the winner) and every case's numbers."""
    import torch

    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models.linear import (LinearPredictionModel,
                                                       OpLogisticRegression)
    from transmogrifai_tpu_torch.record_insights import loco_groups

    vec, sel = inputs["tm"]
    Xt = vec.values.contiguous()
    groups = list(loco_groups(vec.meta, Xt.shape[1]).values())
    G = len(groups)
    cg = ik.col_group_of(groups, Xt.shape[1], device)
    facts = {"transmog": check_loco_linear(Xt, sel.best_model, cg, G,
                                           min(LOCO_K, G), library=True)}
    del Xt
    torch.cuda.empty_cache()

    n, d, g = BENCH_LOCO
    rng = np.random.default_rng(0)
    Xb = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d).astype(np.float32)
    yb = (Xb @ beta > 0).astype(np.float32)
    fit = OpLogisticRegression(max_iter=20).fit_arrays(Xb, yb, device=device)
    Xb = torch.as_tensor(Xb, device=device)
    lr = LinearPredictionModel(fitted=fit)
    svc = LinearPredictionModel(fitted={**fit, "kind": "svc"})
    per = d // g
    cg_b = torch.arange(d, device=device, dtype=torch.int32) // per
    facts["bench_loco_g128"] = check_loco_linear(Xb, lr, cg_b, g,
                                                 library=True)
    cg_m = torch.arange(d, device=device, dtype=torch.int32)
    facts["bench_loco_metaless_g512"] = check_loco_linear(Xb, lr, cg_m, d,
                                                          library=True)
    facts["bench_loco_positive"] = check_loco_linear(
        Xb, lr, cg_b, g, strategy="positive", reps=2)
    facts["bench_loco_negative_svc"] = check_loco_linear(
        Xb, svc, cg_b, g, strategy="negative", reps=2)
    facts["bench_loco_k_equal_g"] = check_loco_linear(Xb[:20_000], lr, cg_b,
                                                      g, k=g, reps=2)
    del Xb
    Xd = inputs["dense"].values.contiguous()
    Gd = Xd.shape[1]
    cg_d = torch.arange(Gd, device=device, dtype=torch.int32)
    win = inputs["winner"]
    check = check_loco_linear if "coef" in win.fitted else check_loco_tree
    facts["default_grid_winner"] = check(Xd, win, cg_d, Gd)
    facts["rf"] = check_loco_tree(Xd, inputs["rf"], cg_d, Gd)
    tree_cases = ["rf"] + (["default_grid_winner"] if check is check_loco_tree
                           else [])
    rows = []
    for name, case in (("loco_linear", facts["transmog"]),
                       ("loco_tree", facts[tree_cases[-1]])):
        keep = [c for k, c in facts.items()
                if (k in tree_cases) == (name == "loco_tree")]
        rows.append({**{k: case[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
                     "max_abs_err": max(c["max_abs_err"] for c in keep),
                     "name": name, "route": "cuda",
                     "source": f"transmogrifai_tpu_torch/csrc/{name}.cu",
                     "replaces": kernels.REPLACES[name]})
    return rows, facts


WIDE_D = 1597                      # the transmog width before the checker
WIDE_ROWS = 50_000                 # the f64 histogram twin's N x D cells
FAULT_ROWS = 200_000


def check_wide_trees(device="cuda", n: int = WIDE_ROWS) -> dict:
    """Queue 3's fault 2 pinned on the card: a GBT and a forest fit at
    1,597 features (two feature chunks of the split kernels), and
    ``tree_split`` / ``tree_split_gini`` against their twins on a level of
    that width.  Column 100 is a copy of column 1,500, on which the label
    hangs, so the best split is an exact tie across the two chunks: the
    kernels, their twins and the fits must all take feature 100, the first
    max (on first-round xgb statistics and on integer counts, which sum
    exactly whatever the atomics' order).  The gini kernel rounds as its
    twin does, so on integer counts its gains and choices must equal the
    twin's everywhere."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import (OpGBTClassifier,
                                                      OpRandomForestClassifier,
                                                      binned)
    rng = np.random.default_rng(12)
    X = rng.normal(size=(n, WIDE_D)).astype(np.float32)
    X[:, 100] = X[:, 1500]
    y = (X[:, 1500] + 0.3 * X[:, 3] + 0.5 * rng.normal(size=n) > 0).astype(
        np.float32)
    Xd = torch.as_tensor(X, device=device)
    del X
    t0 = time.perf_counter()
    gbt = OpGBTClassifier(max_iter=2, max_depth=3,
                          min_instances_per_node=10).fit_arrays(Xd, y)
    rf = OpRandomForestClassifier(num_trees=3, max_depth=3,
                                  min_instances_per_node=10).fit_arrays(Xd, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if int(gbt["feature"][0, 0]) != 100:
        raise AssertionError(f"wide GBT: root split on feature "
                             f"{int(gbt['feature'][0, 0])}, not 100")
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    del Xd
    yd = torch.as_tensor(y, device=device)
    K, P, off = 3, 2, 1
    row_node = torch.as_tensor(rng.integers(1, 3, size=(K, n)).astype(
        np.int32), device=device)
    row_node[:, :n // 4] = 0                     # a leaf parked above
    p = torch.sigmoid(torch.as_tensor(rng.normal(size=(K, n)).astype(
        np.float32), device=device))
    g, h = p - yd, p * (1 - p)
    xgb = torch.stack([torch.ones_like(g), g, h], dim=2).contiguous()
    fmask = torch.ones(WIDE_D, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, device=device)   # noqa: E731
    hist, tot, _ = _check_hist(tk, B, row_node, xgb, off, P, True)
    split_args = (hist, tot, fmask, sp_t, lane(10.0), lane(0.0), lane(1.0))
    err_x = _check_split(tk, hist, tot, fmask, None, sp_t, lane(10.0),
                         lane(0.0), lane(1.0))
    # the chunked split's time at this width (K = 3 lanes, P = 2 nodes):
    # its bound reads the level's histogram once
    timing = {"ms": time_ms(lambda: tk.tree_split(*split_args), 20),
              "plain_ms": time_ms(lambda: tk.tree_split_twin(*split_args), 3),
              "bound_ms": bound(4 * hist.numel() + 4 * tot.numel(), 0)[0]}
    del hist, split_args
    cnt = torch.stack([torch.ones_like(yd), 1 - yd, yd], dim=1)
    gini = (cnt[None] * torch.poisson(torch.ones((K, n), device=device))
            [:, :, None]).contiguous()
    hist, tot = tk.tree_hist(B, row_node, gini, off, P, N_BINS)
    args = (hist, tot, fmask, None, sp_t, lane(10.0), lane(0.0))
    sk, st = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
    for key in ("gain", "feature", "bin", "is_leaf", "threshold"):
        if not torch.equal(sk[key], st[key]):
            raise AssertionError(f"tree_split_gini at D = {WIDE_D}: {key} "
                                 "differs from the twin")
    # the root of every lane: the cross-chunk tie must go to feature 100.
    # The xgb statistics of a first round (p = 0.5: g = 0.5 - y, h = 0.25)
    # sum exactly in any order, so the two columns' histograms are equal
    # and the tie is exact (random p would make the atomics' order decide)
    rn = torch.zeros((K, n), dtype=torch.int32, device=device)
    g0 = (0.5 - yd)[None].expand(K, n)
    xgb0 = torch.stack([torch.ones_like(g0), g0, torch.full_like(g0, 0.25)],
                       dim=2).contiguous()
    hx, tx = tk.tree_hist(B, rn, xgb0, 0, 1, N_BINS)
    root_x = tk.tree_split(hx, tx, fmask, sp_t, lane(10.0), lane(0.0),
                           lane(1.0))["feature"]
    hg, tg = tk.tree_hist(B, rn, gini, 0, 1, N_BINS)
    root_g = tk.tree_split_gini(hg, tg, fmask, None, sp_t, lane(10.0),
                                lane(0.0))["feature"]
    if bool((root_x != 100).any() or (root_g != 100).any()):
        raise AssertionError(f"wide split roots {root_x.tolist()} (xgb), "
                             f"{root_g.tolist()} (gini): the cross-chunk tie "
                             "did not go to feature 100")
    return {"rows": n, "width": WIDE_D, "fit_s": fit_s,
            "gini_split_plan": tk.gini_split_plan(3, 2, WIDE_D, N_BINS, 2),
            "xgb_split_plan": tk.xgb_split_plan(3, 2, WIDE_D, N_BINS),
            "gbt_root_feature": int(gbt["feature"][0, 0]),
            "rf_features_used": sorted({int(f) for f in rf["feature"].flatten()
                                        if f >= 0}),
            "tree_split_max_abs_err": err_x, "tree_split_1597": timing,
            "tree_split_gini": "equal to twin"}


MULTI_CLASSES = 6


def check_multiclass_forest(device="cuda", n: int = FAULT_ROWS) -> dict:
    """Queue 3's fault 3 pinned on the card: a 6-class forest (4 trees,
    depth 8: levels 6 and 7 take ``tree_hist_deep``, all 7 statistics in
    one launch) fitted and scored on the card, and ``tree_hist_deep``
    (level 6, 4 lanes of Poisson-weighted class counts), ``tree_split_gini``
    (equal to its twin on those integer counts) and ``tree_walk`` (V = 6,
    within 1e-6) against their twins."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import (OpRandomForestClassifier,
                                                      TreeEnsembleModel,
                                                      binned)
    X, _ = make_data(n)
    rng = np.random.default_rng(13)
    z = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n)
    y = np.digitize(z, np.quantile(z, np.linspace(0, 1, MULTI_CLASSES + 1)
                                   [1:-1])).astype(np.float32)
    Xd = torch.as_tensor(X, device=device)
    t0 = time.perf_counter()
    fit = OpRandomForestClassifier(num_trees=4, max_depth=8,
                                   min_instances_per_node=5).fit_arrays(Xd, y)
    prob = TreeEnsembleModel(fitted=fit).device_scores(Xd)["probability"]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if tuple(prob.shape) != (n, MULTI_CLASSES) or not bool(
            torch.isfinite(prob).all()):
        raise AssertionError("6-class forest scores: bad shape or values")
    walk = (fit["feature"], fit["threshold"], fit["is_leaf"], fit["leaf"], 9)
    wk = tk.tree_walk(Xd, *walk, op="mean")
    wt = tk.tree_walk_twin(Xd, *walk, members=1, op="mean")
    err_w = float((wk - wt).abs().max())
    if err_w > 1e-6:
        raise AssertionError(f"tree_walk V = 6 differs from its twin: {err_w}")
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    del Xd
    K, off, P = 4, 63, 64
    yd = torch.as_tensor(y, device=device).long()
    cnt = torch.cat([torch.ones((n, 1), device=device),
                     torch.nn.functional.one_hot(yd, MULTI_CLASSES).float()],
                    dim=1)
    stats = (cnt[None] * torch.poisson(torch.ones((K, n), device=device))
             [:, :, None]).contiguous()
    row_node = torch.as_tensor(rng.integers(50, 127, size=(K, n)).astype(
        np.int32), device=device)
    hist, tot, err_h = _check_hist(tk, B, row_node, stats, off, P, True)
    fmask = torch.ones(N_FEATS, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, device=device)   # noqa: E731
    args = (hist, tot, fmask, None, sp_t, lane(5.0), lane(0.0))
    sk, st = tk.tree_split_gini(*args), tk.tree_split_gini_twin(*args)
    for key in ("gain", "feature", "bin", "is_leaf", "threshold"):
        if not torch.equal(sk[key], st[key]):
            raise AssertionError(f"tree_split_gini at C = {MULTI_CLASSES}: "
                                 f"{key} differs from the twin")
    return {"rows": n, "classes": MULTI_CLASSES, "fit_and_score_s": fit_s,
            "hist_deep_plan": tk.hist_plan(n, N_FEATS, K, P, N_BINS,
                                           MULTI_CLASSES + 1),
            "gini_plan": tk.gini_split_plan(K, P, N_FEATS, N_BINS,
                                            MULTI_CLASSES),
            "tree_hist_deep_max_abs_err": err_h,
            "tree_split_gini": "equal to twin", "tree_walk_max_abs_err": err_w}


def check_sparse_default_selector(cols, device="cuda") -> dict:
    """Queue 3's fault 1 pinned on the card: ``BinaryClassificationModel
    Selector()`` with no ``models=`` on the sparse workload's 1M batch (a
    SparseMatrix of 100,003 columns) trains, skipping the forest and GBT
    families (NaN rows, four "skipped" records) and picking among LR and
    SVC."""
    import torch

    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.workflow import Workflow

    label = FeatureBuilder.RealNN("label").as_response()
    fv = transmogrify([FeatureBuilder.Text("txt").as_predictor(),
                       FeatureBuilder.Real("x0").as_predictor()],
                      num_hashes=SPARSE_HASHES)
    sel = BinaryClassificationModelSelector()
    sel.set_input(label, fv)
    pred = sel.get_output()
    copies = {k: Column(c.kind, c.values, c.mask) for k, c in cols.items()}
    n = len(cols["txt"])
    t0 = time.perf_counter()
    model = (Workflow(device=device).set_input_batch(ColumnBatch(copies, n))
             .set_result_features(pred).train())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summ = model.selected_model.summary
    fam = {}
    for r in summ.validation_results:
        fam.setdefault(r.model_name, []).append(
            float(next(iter(r.metric_values.values()))))
    skipped = model.selected_model.failure_log.by_action("skipped")
    trees = ("OpRandomForestClassifier", "OpGBTClassifier")
    if (summ.best_model_name not in ("OpLogisticRegression", "OpLinearSVC")
            or not all(np.isnan(fam[t]).all() for t in trees)
            or not np.isfinite(fam["OpLogisticRegression"]).any()
            or len(skipped) != 4):
        raise AssertionError(f"sparse default selector: winner "
                             f"{summ.best_model_name}, rows {fam}, "
                             f"{len(skipped)} skipped records")
    return {"rows": n, "train_wall_s": wall,
            "winner": summ.best_model_name,
            "best_cv_aupr": {k: max((v for v in vals if np.isfinite(v)),
                                    default=None) for k, vals in fam.items()},
            "skipped_records": len(skipped)}


CORR_ROWS = 100_000                # rows RecordInsightsCorr's host maps take


def run_corr_and_summary(model, batch, device="cuda") -> dict:
    """``RecordInsightsCorr`` (top-20, min-max, Pearson) fitted on the
    default-grid model's predictions and checked vector at 1M x 28 and
    transformed over the first ``CORR_ROWS`` of the same rows (its maps
    are host strings, ~130 us a row: the whole 1M took 134 s of the time
    limit), then ``WorkflowModel.summary()`` and
    ``summary_pretty()`` of that model."""
    import torch

    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.record_insights import RecordInsightsCorr
    sel = model.selected_model
    pred_f, vec_f = sel.get_output(), sel.input_features[1]
    scored = apply_dag(batch.on(device), model.fitted_dag)
    est = RecordInsightsCorr(top_k=LOCO_K)
    est.set_input(pred_f, vec_f)
    t0 = time.perf_counter()
    corr = est.fit(scored)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = min(len(batch), CORR_ROWS)
    maps = corr.transform(scored.take_rows(np.arange(n))).values
    t2 = time.perf_counter()
    row = maps[n // 2]
    if len(maps) != n or not row or not all(
            np.isfinite(v) for pairs in row.values()
            for _, v in json.loads(pairs)):
        raise AssertionError("RecordInsightsCorr maps: bad rows")
    if not np.isfinite(corr.fitted["corr"]).all():
        raise AssertionError("RecordInsightsCorr: non-finite correlations")
    t3 = time.perf_counter()
    summ = model.summary()
    pretty = model.summary_pretty()
    t4 = time.perf_counter()
    if (summ["selectedModelInfo"]["bestModelName"]
            != sel.summary.best_model_name or len(summ["features"]) != N_FEATS
            or "Top Model Contributions" not in pretty):
        raise AssertionError("summary: wrong winner, features or rendering")
    top = summ["features"][0]
    return {"corr_fit_s": t1 - t0, "corr_transform_s": t2 - t1,
            "corr_shape": list(corr.fitted["corr"].shape),
            "corr_row": row, "summary_s": t4 - t3,
            "summary_best_model": summ["selectedModelInfo"]["bestModelName"],
            "summary_features": len(summ["features"]),
            "summary_top_feature": top["featureName"],
            "summary_top_contribution": max(
                abs(c["contribution"] or 0.0)
                for c in top["derivedFeatures"])}


# --------------------------------------------------------------------------
# phase 8: the regression family
# --------------------------------------------------------------------------

REG_FEATS = 16                     # bench.run_selector_smoke's width
REG_SCORE_SEED = 12                # the fresh batch scored after training
REG_R2_MIN = 0.9                   # noise sd 0.3 against a signal sd ~4
REG_PEAK_GB = 80.0                 # the card's memory
# The JAX package's regression grids at 4,000 rows (bench.run_selector_smoke's
# generator, seed 11, CPU; `PYTHONPATH=. JAX_PLATFORMS=cpu python
# scripts/regression_grid_reference.py --package jax --rows 4000 --grid
# default`, and `--grid compact`): every LinReg / ridge and GBT candidate's
# CV RMSE by its (reg_param[, elastic_net_param]) or (max_depth,
# min_instances_per_node, min_info_gain) — a raced-out point's is its fold-0
# screen — the forest family's best CV RMSE, the winner and the refit's
# train RMSE.  The card must give the same winner, LinReg and ridge within
# 1e-4 relative, GBT 1e-3, and the forest within "rf_tol" = 3 x the JAX
# package's spread of that best over forest seeds 42, 0, 1, 2, 3 (`...
# --rf-seeds 42,0,1,2,3`; the port's forests draw from torch generators).
REG_REF_ROWS = 4_000
REG_REF = {
    "default": {
        "winner": "OpLinearRegression", "train_rmse": 0.30047889474137374,
        "rf_best": 1.8878767887751262, "rf_tol": 0.0301,   # 3 x 0.010046
        "OpLinearRegression": {
            (0.001, 0.1): 0.3016411562760671,
            (0.001, 0.5): 0.3016478419303894,
            (0.01, 0.1): 0.30883121490478516,
            (0.01, 0.5): 0.30374061067899066,
            (0.1, 0.1): 0.4457322955131531,
            (0.1, 0.5): 0.4638878405094147,
            (0.2, 0.1): 0.6695189476013184,
            (0.2, 0.5): 0.7313461303710938},
        "OpGBTRegressor": {
            (3, 10, 0.001): 2.4364514350891113,
            (3, 10, 0.01): 2.4364514350891113,
            (3, 10, 0.1): 2.4364514350891113,
            (3, 100, 0.001): 2.444828987121582,
            (3, 100, 0.01): 2.444828987121582,
            (3, 100, 0.1): 2.444828987121582,
            (6, 10, 0.001): 1.9986782471338909,
            (6, 10, 0.01): 1.9986782471338909,
            (6, 10, 0.1): 1.9986782471338909,
            (6, 100, 0.001): 2.16001296043396,
            (6, 100, 0.01): 2.16001296043396,
            (6, 100, 0.1): 2.16001296043396,
            (12, 10, 0.001): 1.8654568990071614,
            (12, 10, 0.01): 1.8660812377929688,
            (12, 10, 0.1): 1.8661386966705322,
            (12, 100, 0.001): 2.134227991104126,
            (12, 100, 0.01): 2.134227991104126,
            (12, 100, 0.1): 2.134227991104126}},
    "compact": {
        "winner": "OpLinearRegression", "train_rmse": 0.30235740818056006,
        "rf_best": 2.2065558433532715, "rf_tol": 0.0715,   # 3 x 0.02384
        "OpLinearRegression": {(0.01,): 0.30345796545346576,
                               (0.1,): 0.43391429384549457}}}
REG_TOL = {"OpLinearRegression": 1e-4, "OpGBTRegressor": 1e-3}


def _reg_key(params: dict) -> tuple:
    """A candidate's grid point without the values its family shares."""
    return tuple(v for k, v in params.items()
                 if k not in ("max_iter", "max_bins", "num_trees"))


def _reg_candidates(summary) -> list:
    return [[r.model_name, _reg_key(r.params),
             float(r.metric_values["RootMeanSquaredError"]), r.raced_out]
            for r in summary.validation_results]


def _reg_family_best(cands) -> dict:
    best = {}
    for name, _, v, raced in cands:
        if not raced and np.isfinite(v) and v < best.get(name, np.inf):
            best[name] = v
    return best


def regression_workflow(n: int, grid: str, device, seed: int = 11):
    """``bench.run_selector_smoke``'s regression workflow: 16 RealNN
    features → transmogrify → ``RegressionModelSelector`` with no
    ``models=`` (``grid`` "default") or its ``compact_models()``.  Returns
    (workflow, batch, prediction feature)."""
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import RegressionModelSelector
    from transmogrifai_tpu_torch.synthetic import make_regression_data
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow

    X, y = make_regression_data(n, REG_FEATS, seed)
    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor()
             for i in range(REG_FEATS)]
    sel = RegressionModelSelector(
        models=None if grid == "default"
        else RegressionModelSelector.compact_models())
    sel.set_input(label, transmogrify(feats))
    pred = sel.get_output()
    cols = {"label": Column(RealNN, y)}
    for i in range(REG_FEATS):
        cols[f"f{i}"] = Column(RealNN, X[:, i])
    batch = ColumnBatch(cols, n)
    wf = Workflow(device=device).set_input_batch(batch)
    return wf.set_result_features(pred), batch, pred


def run_regression(device, n: int, grid: str = "default",
                   score: bool = True) -> tuple:
    """Train the regression workflow, evaluate it on its train rows (RMSE,
    R²) and, with ``score``, score a fresh batch of ``n`` rows (seed
    REG_SCORE_SEED).  Returns (facts, model, batch)."""
    import torch

    from transmogrifai_tpu_torch.evaluators import Evaluators
    wf, batch, pred = regression_workflow(n, grid, device)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = model.evaluate(Evaluators.Regression.rmse(), batch=batch)
    summ = model.selected_model.summary
    cands = _reg_candidates(summ)
    facts = {"train_wall_s": wall, "best_model": summ.best_model_name,
             "family_best_cv_rmse": _reg_family_best(cands),
             "train_rmse": float(m["RootMeanSquaredError"]),
             "train_r2": float(m["R2"]),
             "phase_seconds": model.phase_seconds,
             "selector_seconds": model.selected_model.selector_seconds,
             "candidates": cands}
    if score:
        _, fresh, _ = regression_workflow(n, grid, device, REG_SCORE_SEED)
        t0 = time.perf_counter()
        p = model.score(fresh)[pred.name].values["prediction"]
        if device == "cuda":
            torch.cuda.synchronize()
        facts["score_rows_per_s"] = n / (time.perf_counter() - t0)
        if tuple(p.shape) != (n,) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"regression scores: shape "
                                 f"{tuple(p.shape)} or non-finite")
    return facts, model, batch


def check_regression_reference(device="cuda") -> dict:
    """Both grids at REG_REF_ROWS rows on the card against the JAX
    package's numbers (REG_REF)."""
    out = {}
    for grid, ref in REG_REF.items():
        facts, _, _ = run_regression(device, REG_REF_ROWS, grid, False)
        if facts["best_model"] != ref["winner"]:
            raise AssertionError(f"regression reference ({grid}): winner "
                                 f"{facts['best_model']}, the JAX package's "
                                 f"is {ref['winner']}")
        seen = 0
        for name, key, v, _ in facts["candidates"]:
            if name in REG_TOL:
                want = ref[name][key]
                if abs(v - want) > REG_TOL[name] * abs(want):
                    raise AssertionError(
                        f"regression reference ({grid}): {name} {key} CV "
                        f"RMSE {v}, the JAX package's {want}")
                seen += 1
        if seen != sum(len(ref[f]) for f in REG_TOL if f in ref):
            raise AssertionError(f"regression reference ({grid}): "
                                 f"{seen} candidates held to the JAX package")
        rf = facts["family_best_cv_rmse"]["OpRandomForestRegressor"]
        if abs(rf - ref["rf_best"]) > ref["rf_tol"]:
            raise AssertionError(f"regression reference ({grid}): forest CV "
                                 f"RMSE {rf}, the JAX package's "
                                 f"{ref['rf_best']} (tolerance "
                                 f"{ref['rf_tol']})")
        if abs(facts["train_rmse"] - ref["train_rmse"]) \
                > 1e-4 * ref["train_rmse"]:
            raise AssertionError(f"regression reference ({grid}): train RMSE "
                                 f"{facts['train_rmse']}, the JAX package's "
                                 f"{ref['train_rmse']}")
        out[grid] = {k: facts[k] for k in ("best_model", "family_best_cv_rmse",
                                           "train_rmse", "train_wall_s")}
    return out


def _check_split_variance(tk, hist, tot, fmask, node_mask, splits, min_inst,
                          min_gain, chunk: int = 16) -> float:
    """``tree_split_variance`` on all lanes at once against its twin run on
    the f64 histogram, ``chunk`` lanes at a time.  Gains within 1e-5 of the
    parent's Σw·y² (+1e-6), the terms each gain is a difference of; the
    chosen feature, bin and threshold equal wherever the f64 best and
    runner-up differ by more than twice that; the leaf flag wherever the
    f64 gain is non-finite or further than it from the lane's min_gain.
    The kernel also gives the f32 twin's bits in every output.  Returns
    the largest gain error."""
    import torch
    out = tk.tree_split_variance(hist, tot, fmask, node_mask, splits,
                                 min_inst, min_gain)
    K, err = hist.shape[0], 0.0
    for a in range(0, K, chunk):
        sl = slice(a, min(a + chunk, K))
        m = None if node_mask is None else node_mask[sl]
        f32 = tk.tree_split_variance_twin(hist[sl], tot[sl], fmask, m,
                                          splits, min_inst[sl],
                                          min_gain[sl])
        for key, v in f32.items():
            if not torch.equal(out[key][sl], v):
                raise AssertionError(f"tree_split_variance (P "
                                     f"{hist.shape[1]}, lanes {a}..): {key} "
                                     "differs from the f32 twin's bits")
        del f32
        h, t = hist[sl].double(), tot[sl].double()
        mi, mg = min_inst[sl].double(), min_gain[sl].double()
        st = tk.tree_split_variance_twin(h, t, fmask, m, splits, mi, mg)
        tol = 1e-5 * t[..., 2].abs() + 1e-6
        sk = {k: v[sl] for k, v in out.items()}
        fin = torch.isfinite(st["gain"])
        if not torch.equal(fin, torch.isfinite(sk["gain"])):
            raise AssertionError(f"tree_split_variance (P {h.shape[1]}, lanes "
                                 f"{a}..): finite gains differ from the twin")
        e = torch.where(fin, (sk["gain"].double() - st["gain"]).abs(), 0.0)
        if bool((e > tol).any()):
            raise AssertionError(f"tree_split_variance (P {h.shape[1]}, lanes "
                                 f"{a}..): gains disagree with the twin")
        gap = tk.split_gap_variance(h, t, fmask, m, mi)
        same = ((sk["feature"] == st["feature"]) & (sk["bin"] == st["bin"])
                & (sk["threshold"] == st["threshold"]))
        if bool(((gap > 2 * tol) & ~same).any()):
            raise AssertionError(f"tree_split_variance (P {h.shape[1]}, lanes "
                                 f"{a}..): another split than the twin's")
        leaf_clear = ~fin | ((st["gain"] - mg[:, None]).abs() > tol)
        if bool((leaf_clear & (sk["is_leaf"] != st["is_leaf"])).any()):
            raise AssertionError(f"tree_split_variance (P {h.shape[1]}, lanes "
                                 f"{a}..): leaf flags disagree with the twin")
        err = max(err, float(e.max()))
    return err


def regression_forest_inputs(device, n: int, depth: int, seed: int = 13):
    """Fold 0 of the default grid's RF regressor group of depth ``depth``
    (6 grid points x 50 trees; "onethird" of 16 = 5 features a node) at the
    first lane batch ``lane_batches`` gives it on the card: (1, y, y²) x
    Poisson(1) draw x fold weight per lane, the draws' node subsets, each
    lane its grid point's min_instances and min_info_gain."""
    import itertools

    import torch

    from transmogrifai_tpu_torch.models.trees import (binned, forest_draws,
                                                      lane_batches,
                                                      lane_bytes)
    from transmogrifai_tpu_torch.synthetic import make_regression_data
    X, y = make_regression_data(n, REG_FEATS)
    Xd = torch.as_tensor(X, device=device)
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    dev = torch.device(device)
    n_trees = 50
    first = lane_batches(6 * n_trees, lane_bytes(n, REG_FEATS, 3, N_BINS,
                                                  depth, dev), dev)[0]
    K = first.stop - first.start
    gen = torch.Generator(device=device).manual_seed(seed)
    dr = forest_draws(gen, n_trees=n_trees, n_rows=n, rates=[1.0],
                      max_depth=depth,
                      fmask=torch.ones(REG_FEATS, dtype=torch.bool,
                                       device=device),
                      features_per_node=REG_FEATS // 3)
    W = torch.as_tensor(_fold_weights(y), device=device)
    yd = torch.as_tensor(y, device=device)
    base = torch.stack([torch.ones_like(yd), yd, yd * yd], dim=1)
    tree_of_lane = torch.arange(K, device=device) % n_trees
    stats = (base[None] * (dr.boot[1.0][tree_of_lane] * W[0])[:, :, None]
             ).contiguous()
    points = list(itertools.product((10.0, 100.0), (0.001, 0.01, 0.1)))
    lane = lambda i: torch.tensor([points[k // n_trees][i] for k in range(K)],
                                  dtype=torch.float32, device=device)
    return {"X": Xd, "B": B, "splits": sp_t, "stats": stats,
            "masks": [m[tree_of_lane].contiguous() for m in dr.subsets],
            "min_inst": lane(0), "min_gain": lane(1), "lanes": K}


def check_variance_split(device="cuda", n: int = N_ROWS, reps: int = 10):
    """``tree_split_variance`` against its twin (``_check_split_variance``)
    at the regression path's shapes: the RF regressor's level 5 (P = 32;
    the depth-6 group's fold-0 lanes, node subsets), level 11 of its depth-12
    group (P = 2048), and a root and level 1 at 1,597 features (two feature
    chunks; column 100 a copy of column 1,500, on which an integer label
    hangs, so the two columns' histograms are equal and the best split an
    exact cross-chunk tie, taken by feature 100; a decision-tree regressor
    fitted there splits its root on 100 too).  Returns the kernels line's
    row (level 5) and the other shapes' numbers."""
    import torch

    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import (OpDecisionTreeRegressor,
                                                      binned)
    facts = {}
    fmask = torch.ones(REG_FEATS, dtype=torch.bool, device=device)
    row = None
    for depth, lvl in ((RF_DEPTH, 5), (DEEP, DEEP - 1)):
        inp = regression_forest_inputs(device, n, depth)
        B, stats, K = inp["B"], inp["stats"], inp["lanes"]
        off, P = (1 << lvl) - 1, 1 << lvl
        rng = np.random.default_rng(lvl)
        row_node = torch.as_tensor(rng.integers(max(off - 6, 0), off + P,
                                                size=(K, n)).astype(np.int32),
                                   device=device)
        mask = inp["masks"][lvl]
        hist, tot = tk.tree_hist(B, row_node, stats, off, P, N_BINS,
                                 node_mask=mask)
        del row_node
        args = (hist, tot, fmask, mask, inp["splits"], inp["min_inst"],
                inp["min_gain"])
        err = _check_split_variance(tk, *args)
        kept = int(mask.sum())
        bt, by = bound(kept * N_BINS * 3 * 4 + 4 * tot.numel() + mask.numel()
                       + REG_FEATS + 4 * inp["splits"].numel() + 8 * K
                       + 17 * K * P, 20 * kept * N_BINS)
        # the twin's gain tables at level 11 take GBs for all lanes: there
        # it is timed on the first 16, beside the kernel on the same
        sub = args if lvl < 8 else tuple(
            a[:16] if isinstance(a, torch.Tensor) and a.shape[0] == K else a
            for a in args)
        # the subsets' width as fit_trees passes it (no wait for the card
        # inside the timed call)
        width = int(mask.sum(dim=2).amax())
        run = lambda: tk.tree_split_variance(*args, width=width)  # noqa
        case = {"lanes": K, "P": P, "max_abs_err": err,
                "ms": time_ms(run, reps),
                "device_ms": kernel_device_ms(run, reps,
                                              "tree_split_variance")["ms"],
                "plain_lanes": sub[0].shape[0],
                "plain_ms": time_ms(
                    lambda: tk.tree_split_variance_twin(*sub), 2),
                "ms_plain_lanes": time_ms(
                    lambda: tk.tree_split_variance(*sub, width=width), reps),
                "bound_ms": bt, "bound_by": by}
        facts[f"level_{lvl}"] = case
        if row is None:
            row = {"name": "tree_split_variance", "route": "cuda",
                   "source": "transmogrifai_tpu_torch/csrc/"
                             "tree_split_variance.cu",
                   "replaces": kernels.REPLACES["tree_split_variance"],
                   "library_ms": None,
                   **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")}}
        del hist, tot, inp, stats, mask, args
        torch.cuda.empty_cache()
    row["max_abs_err"] = max(c["max_abs_err"] for c in facts.values())

    # 1,597 features: two chunks, an exact cross-chunk tie
    wn = WIDE_ROWS
    rng = np.random.default_rng(14)
    X = rng.normal(size=(wn, WIDE_D)).astype(np.float32)
    X[:, 100] = X[:, 1500]
    y = np.round(2 * X[:, 1500] + 0.3 * rng.normal(size=wn)).astype(
        np.float32)
    Xd = torch.as_tensor(X, device=device)
    del X
    dt = OpDecisionTreeRegressor(max_depth=3,
                                 min_instances_per_node=10).fit_arrays(Xd, y)
    if int(dt["feature"][0, 0]) != 100:
        raise AssertionError(f"wide regression tree: root split on feature "
                             f"{int(dt['feature'][0, 0])}, not 100")
    _, sp_t, B = binned(Xd, Xd, N_BINS)
    del Xd
    K = 3
    yd = torch.as_tensor(y, device=device)
    w = torch.poisson(torch.ones((K, wn), device=device))
    st = (torch.stack([torch.ones_like(yd), yd, yd * yd], dim=1)[None]
          * w[:, :, None]).contiguous()
    wf = torch.ones(WIDE_D, dtype=torch.bool, device=device)
    lane = lambda v: torch.full((K,), v, device=device)   # noqa: E731
    errs = []
    for off, P in ((0, 1), (1, 2)):
        rn = torch.as_tensor(rng.integers(off, off + P, size=(K, wn)).astype(
            np.int32), device=device)
        h, t = tk.tree_hist(B, rn, st, off, P, N_BINS)
        errs.append(_check_split_variance(tk, h, t, wf, None, sp_t,
                                          lane(10.0), lane(0.0)))
        if off == 0:
            root = tk.tree_split_variance(h, t, wf, None, sp_t, lane(10.0),
                                          lane(0.0))["feature"]
            if bool((root != 100).any()):
                raise AssertionError(f"tree_split_variance at D = {WIDE_D}: "
                                     f"roots {root.tolist()}, not 100")
    facts["width_1597"] = {"rows": wn, "max_abs_err": max(errs),
                           "dt_root_feature": int(dt["feature"][0, 0]),
                           "plan": tk.gini_split_plan(K, 1, WIDE_D, N_BINS,
                                                      2)}
    row["max_abs_err"] = max(row["max_abs_err"], max(errs))
    return row, facts


def check_fista_squared(device="cuda", n: int = N_ROWS, reps: int = 10):
    """``fista_step`` with the squared loss against its f64 twin
    (``_fista_case``): the LinReg CV block (3 folds x 8 lanes) on the
    regression workload's 1M x 16 matrix, and the wide two-pass form on a
    1M x 1,596 matrix (24 lanes in one launch).  Returns the two rows of the
    kernels line and their numbers."""
    import torch

    from transmogrifai_tpu_torch.models.solvers import standardize_moments
    from transmogrifai_tpu_torch.synthetic import make_regression_data
    X, y = make_regression_data(n, REG_FEATS)
    rng = np.random.default_rng(15)
    W = torch.as_tensor(_fold_weights(y), device=device)
    out = {}
    Xd = torch.as_tensor(X, device=device)
    yd = torch.as_tensor(y, device=device)
    mean, scale = standardize_moments(Xd, W, center=True)
    out["narrow"] = _fista_case(Xd, W, yd, mean, scale, "squared", 8, rng,
                                reps)
    del Xd, mean, scale
    gen = torch.Generator(device=device).manual_seed(15)
    Xw = torch.randn((n, TRANSMOG_WIDTH), generator=gen, device=device)
    mean, scale = standardize_moments(Xw, W, center=True)
    out["wide"] = _fista_case(Xw, W, yd, mean, scale, "squared", 8, rng,
                              max(2, reps // 4), two_pass=True)
    del Xw
    torch.cuda.empty_cache()
    return [_fista_row(out["narrow"]), _fista_row(out["wide"])], out


def run_regression_insights(model, batch, device="cuda") -> dict:
    """``RecordInsightsLOCO`` (top-16: every raw feature) through its
    transform on the regression winner over its own 1M x 16 vector, its
    kernel against the twin on that vector (``run_loco_stage`` with
    ``check_loco_linear`` / ``check_loco_tree``: 1e-5 of the max |diff|),
    the diffs of a regression's prediction (a sigmoid would keep them
    inside (-1, 1)), and ``WorkflowModel.summary()``.  Returns the facts
    and the launches of the transform alone."""
    import torch
    sel = model.selected_model
    check = (check_loco_linear if "coef" in sel.best_model.fitted
             else check_loco_tree)
    facts, launches = run_loco_stage(model, batch, check, device)
    if facts["loco_kernel"]["max_abs_diff"] <= 1.0:
        raise AssertionError(f"regression LOCO: max |diff| "
                             f"{facts['loco_kernel']['max_abs_diff']}: not "
                             "the prediction's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summ = model.summary()
    t1 = time.perf_counter()
    info = summ["selectedModelInfo"]
    # the workflow has no SanityChecker, so (as in the JAX package) the
    # summary lists no per-feature insights
    if (info["bestModelName"] != sel.summary.best_model_name
            or info["problemType"] != "Regression"):
        raise AssertionError("regression summary: wrong winner or problem "
                             "type")
    return {**facts, "summary_s": t1 - t0}, launches


# --------------------------------------------------------------------------
# phase 9: the multiclass family
# --------------------------------------------------------------------------

MC_FEATS = 16                      # bench.run_selector_smoke's width
MC_CLASSES = 4
MC_SCORE_SEED = 12                 # the fresh batch scored after training
MC_F1_MIN = 0.9                    # 4 centres of sd 2.5 against unit noise
MC_PEAK_GB = 80.0                  # the card's memory
MC_WIDE = (200_000, TRANSMOG_WIDTH)   # the wide form's check: rows, width
# The JAX package's multiclass grids on iris (data/iris/iris.csv, CPU;
# `PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/multiclass_grid_reference.py
# --package jax --data iris --grid default`, and `--grid compact`): every LR
# candidate's CV F1 by its (reg_param[, elastic_net_param]) — a raced-out
# point's is its fold-0 screen — the forest family's best CV F1, the winner
# and the refit's train F1.  The card must give the same winner, every LR
# candidate's CV F1 equal, and the forest within "rf_tol" = 3 x the JAX
# package's spread of that best over forest seeds 42, 0, 1, 2, 3 (`...
# --rf-seeds 42,0,1,2,3`; the port's forests draw from torch generators).
MC_REF = {
    "default": {
        "winner": "OpLogisticRegression", "train_f1": 0.9733226623982926,
        "rf_best": 0.9270751476287842, "rf_tol": 0.0587,   # 3 x 0.019537
        "OpLogisticRegression": {
            (0.001, 0.1): 0.9663655757904053,
            (0.001, 0.5): 0.9663655757904053,
            (0.01, 0.1): 0.9595350424448649,
            (0.01, 0.5): 0.9600000381469727,
            (0.1, 0.1): 0.8794078826904297,
            (0.1, 0.5): 0.8794078826904297,
            (0.2, 0.1): 0.8794078826904297,
            (0.2, 0.5): 0.8794078826904297}},
    "compact": {
        "winner": "OpLogisticRegression", "train_f1": 0.96,
        "rf_best": 0.9462923804918925, "rf_tol": 0.0401,   # 3 x 0.013345
        "OpLogisticRegression": {(0.01,): 0.9595350424448649,
                                 (0.1,): 0.9067966739336649}}}
# The JAX package's default LR candidates on the bench's multiclass data at
# 4,000 rows (`... --package jax --data bench --rows 4000 --grid lr`):
# every candidate's CV F1 is 1.0, the winner (0.001, 0.1), and its refit's
# coefficients [16, 4] and intercepts [4], which the card must give within
# 1e-3 of max |coef|.
MC_BENCH_ROWS = 4_000
MC_BENCH_REF = {
    "winner": (0.001, 0.1),
    "coef": [
        [0.18828359246253967, -0.12894241511821747, -0.19695013761520386, 0.13760961592197418],
        [0.2203100323677063, 0.1293533891439438, 0.00644611706957221, -0.375114768743515],
        [0.11392915993928909, 0.2827840745449066, -0.008963901549577713, -0.38774874806404114],
        [0.34343263506889343, -0.06565540283918381, 0.007963654585182667, -0.28562140464782715],
        [0.1240682452917099, -0.3166394531726837, 0.10282047092914581, 0.08276592940092087],
        [-0.23676671087741852, -0.21577449142932892, 0.1849386990070343, 0.2676023542881012],
        [0.02062372677028179, -0.131395161151886, 0.4063716232776642, -0.29559850692749023],
        [-0.33725646138191223, 0.17817917466163635, -0.048424988985061646, 0.20750115811824799],
        [-0.004209570121020079, -0.33227041363716125, -0.057813867926597595, 0.41437140107154846],
        [-0.07230577617883682, -0.37961065769195557, 0.3318261206150055, 0.12009069323539734],
        [-0.0, 0.09132836014032364, -0.3601132035255432, 0.262184202671051],
        [-0.3583819270133972, 0.11226556450128555, 0.21315494179725647, 0.01938129961490631],
        [0.3183816373348236, -0.2620977759361267, -0.0019053388386964798, -0.04310864955186844],
        [-0.009855832904577255, 0.13430793583393097, 0.28159284591674805, -0.40604761242866516],
        [-0.30656495690345764, 0.07334978133440018, -0.04320095479488373, 0.27641621232032776],
        [0.0727837011218071, 0.2047126442193985, -0.3114890158176422, 0.025327926501631737]],
    "intercept": [-0.956790566444397, 0.9071950912475586, -0.20493905246257782,
                  0.2457958459854126]}


def _softmax_case(Xd, W, yi, mean, scale, G: int, C: int, rng, reps: int,
                  chunk: int = 131_072, two_pass: bool = False) -> dict:
    """``fista_softmax_step`` for F x G lanes of C classes (F = W's folds)
    with random coefficients, against its twin run in f64: each output
    within 1e-5 of its absolute mass (sum over rows of |x|·|g|), and two
    launches bit for bit.  The f64 reference is summed over row chunks.
    ``two_pass``: the same held and timed in the two-pass form too.
    Returns the case's facts (a row of the kernels line without its
    names)."""
    import torch

    from transmogrifai_tpu_torch.models import linear_kernels as lk

    device = Xd.device
    n, D = Xd.shape
    L = W.shape[0] * G
    lanes = torch.arange(L, device=device) // G
    # margins of a few units: sd 0.3 on 28 unit columns, shrunk by width
    sd = 0.3 * min(1.0, (N_FEATS / D) ** 0.5) / float(scale.mean())
    V = torch.as_tensor(rng.normal(scale=sd, size=(L, C, D)).astype(
        np.float32), device=device)
    b = torch.as_tensor(rng.normal(scale=0.2, size=(L, C)).astype(
        np.float32), device=device)
    muv = (mean[lanes][:, None, :] * V).sum(dim=-1)
    args = (Xd, V, muv, b, W, yi, W.sum(dim=1)[lanes], G)
    gx, gs = lk.fista_softmax_step(*args)
    gx2, gs2 = lk.fista_softmax_step(*args)
    if not (torch.equal(gx, gx2) and torch.equal(gs, gs2)):
        raise AssertionError(f"fista_softmax (C={C}, D={D}): two launches "
                             "differ")
    want = torch.zeros((L, C, D), dtype=torch.float64, device=device)
    mass = torch.zeros_like(want)
    gsum = torch.zeros((L, C), dtype=torch.float64, device=device)
    gabs = torch.zeros_like(gsum)
    V64, muv64, b64, ws64 = (a.double() for a in (V, muv, b, args[6]))
    for r0 in range(0, n, chunk):
        sl = slice(r0, min(n, r0 + chunk))
        x64 = Xd[sl].double()
        g64 = lk.fista_softmax_row_grads(x64, V64, muv64, b64,
                                         W[:, sl].double(), yi[sl], ws64, G)
        want += (g64.reshape(L * C, -1) @ x64).reshape(L, C, D)
        mass += (g64.abs().reshape(L * C, -1) @ x64.abs()).reshape(L, C, D)
        gsum += g64.sum(dim=2)
        gabs += g64.abs().sum(dim=2)
    err = 0.0
    for got, w, m in ((gx, want, mass), (gs, gsum, gabs)):
        e = (got.double() - w).abs()
        if bool((e > 1e-5 * m + 1e-12).any()):
            raise AssertionError(f"fista_softmax (C={C}, D={D}, {L} lanes) "
                                 "disagrees with its f64 twin")
        err = max(err, float(e.max()))
    J = L * C
    two = None
    if two_pass:
        plan = lk.wide_plan(D, L, C)
        two = _two_pass(lambda: lk.wide_outputs(lk._wide_run(
            *args[:7], G, C, "softmax", plan), D, L, C)[:2],
            ((want, mass), (gsum, gabs)), max(2, reps // 2),
            f"fista_softmax (C={C}, D={D}, {L} lanes)")

    def cublas_pair():      # margins, softmax, Xᵀg: timed only
        m = (V.reshape(J, D) @ Xd.T).reshape(L, C, n)
        return torch.softmax(m, dim=1).reshape(J, n) @ Xd

    folds = len(set(lanes.tolist()))
    nbytes = 4 * Xd.numel() + 4 * n * folds + 4 * n + 4 * (2 * J * D + 3 * J
                                                          + L)
    bt, by = bound(nbytes, 4 * n * D * J)
    return {"lanes": L, "classes": C, "features": D, "rows": n,
            "form": lk.softmax_launch_plan(D, L, C)["form"], "two_pass": two,
            "split_tf32_bound_ms": split_tf32_bound(nbytes, 4 * n * D * J),
            "max_abs_err": err,
            "ms": time_ms(lambda: lk.fista_softmax_step(*args), reps),
            "plain_ms": time_ms(lambda: lk.fista_softmax_step_twin(*args),
                                max(2, reps // 4)),
            "bound_ms": bt, "bound_by": by,
            "library_ms": time_ms(cublas_pair, max(2, reps // 4))}


def _kernel_row(name: str, case: dict) -> dict:
    from transmogrifai_tpu_torch.models import kernels
    return {"name": name, "route": "cuda",
            "source": f"transmogrifai_tpu_torch/csrc/{name}.cu",
            "replaces": kernels.REPLACES[name],
            **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}


def check_softmax_kernel(device="cuda", n: int = N_ROWS, reps: int = 10):
    """``fista_softmax_step`` against its f64 twin (``_softmax_case``) on
    the multiclass workload's 1M x 16 matrix: the fold-0 screen's 8 lanes
    and the 3 folds x 8 lanes of 4 classes, 8 lanes of 40 classes, and the
    wide two-pass form on a random 200,000 x 1,596 matrix (3 folds x 2
    lanes of 4 classes).  Returns the two rows of the kernels line (the
    8-lane screen, the wide form) and every case's numbers."""
    import torch

    from transmogrifai_tpu_torch.models.solvers import standardize_moments
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    X, y = make_multiclass_data(n, MC_FEATS)
    rng = np.random.default_rng(16)
    W = torch.as_tensor(_fold_weights(y), device=device)
    Xd = torch.as_tensor(X, device=device)
    yi = torch.as_tensor(y, device=device).to(torch.int32)
    mean, scale = standardize_moments(Xd, W, center=True)
    out = {"screen": _softmax_case(Xd, W[:1], yi, mean[:1], scale[:1], 8,
                                   MC_CLASSES, rng, reps),
           "cv": _softmax_case(Xd, W, yi, mean, scale, 8, MC_CLASSES, rng,
                               reps)}
    y40 = torch.as_tensor(rng.integers(0, 40, n).astype(np.int32),
                          device=device)
    out["classes_40"] = _softmax_case(Xd, W[:1], y40, mean[:1], scale[:1],
                                      8, 40, rng, max(2, reps // 2))
    del Xd, y40
    wn, wd = MC_WIDE
    gen = torch.Generator(device=device).manual_seed(16)
    Xw = torch.randn((wn, wd), generator=gen, device=device)
    Ww = torch.as_tensor(_fold_weights(y[:wn]), device=device)
    mean, scale = standardize_moments(Xw, Ww, center=True)
    out["wide"] = _softmax_case(Xw, Ww, yi[:wn], mean, scale, 2, MC_CLASSES,
                                rng, max(2, reps // 2), two_pass=True)
    del Xw
    torch.cuda.empty_cache()
    return [_kernel_row("fista_softmax", out["screen"]),
            _kernel_row("fista_softmax", out["wide"])], out


CONFUSION_CLASSES = (MC_CLASSES, 8, 9, 14, 15, 40)  # both sides of the
                                                    # forms' C
CONFUSION_EMU_ROWS = 200_003       # rows the numpy emulation is held at


def _confusion_case(mk, yi, Pd, Wm, G: int, C: int, reps: int,
                    emulate: bool = False) -> dict:
    """``multiclass_confusion`` on (yi, Pd, Wm) against its twin: equal
    where the weights are 0 or 1 (integer sums), else within 1e-6 of the
    f64 sums relative to max(|sum|, 1); the same bits on two launches; with
    ``emulate``, on the card, the bits of ``confusion_emulate`` (the
    kernel's order in numpy).  Returns its numbers: CUDA-event ``ms``, the
    profiler's ``device_ms`` (``KERNEL_IDS["multiclass_confusion"]``), the
    twin's and the library's (one weighted ``torch.bincount`` of y·C + p a
    candidate)."""
    import torch
    N, K = Pd.shape
    conf = mk.multiclass_confusion(yi, Pd, Wm, G, C)
    if not torch.equal(conf, mk.multiclass_confusion(yi, Pd, Wm, G, C)):
        raise AssertionError(f"multiclass_confusion (K={K}, C={C}): two "
                             "launches differ")
    twin = mk.multiclass_confusion_twin(yi, Pd, Wm.double(), G, C)
    err = float((conf.double() - twin).abs().max())
    rel = float(((conf.double() - twin).abs()
                 / twin.abs().clamp(min=1.0)).max())
    if bool(((Wm == 0) | (Wm == 1)).all()) and err != 0.0:
        raise AssertionError(f"multiclass_confusion (K={K}, C={C}): differs "
                             "from its twin on 0/1 weights")
    if rel > 1e-6:
        raise AssertionError(f"multiclass_confusion (K={K}, C={C}): {rel} "
                             "relative to the f64 sums")
    emulate = emulate and yi.is_cuda          # the CPU runs the twin
    plan = mk.confusion_plan(K, C, N, torch.cuda.get_device_properties(
        yi.device).multi_processor_count) if yi.is_cuda else None
    if emulate and not np.array_equal(
            conf.cpu().numpy(), mk.confusion_emulate(
                yi.cpu().numpy(), Pd.cpu().numpy(), Wm.cpu().numpy(), G,
                C, plan)):
        raise AssertionError(f"multiclass_confusion (K={K}, C={C}): not "
                             "the bits of its emulation")
    keys = (yi.long() * C)[None, :] + Pd.T.long()

    def bincounts():
        return [torch.bincount(keys[k], weights=Wm[k // G],
                               minlength=C * C) for k in range(K)]

    def run():
        return mk.multiclass_confusion(yi, Pd, Wm, G, C)

    bt, by = bound(4 * N * K + 4 * N + 4 * N * Wm.shape[0] + 4 * K * C * C,
                   2 * N * K)
    out = {"candidates": K, "G": G, "classes": C, "rows": N,
           "plan": plan and plan._asdict(),
           "max_abs_err": err, "rel_err": rel, "emulated": emulate,
           "ms": time_ms(run, reps),
           "device_ms": kernel_device_ms(run, reps,
                                         "multiclass_confusion")["ms"],
           "plain_ms": time_ms(
               lambda: mk.multiclass_confusion_twin(yi, Pd, Wm, G, C),
               max(2, reps // 4)),
           "bound_ms": bt, "bound_by": by,
           "library_ms": time_ms(bincounts, max(2, reps // 4))}
    del keys
    return out


def check_confusion_kernel(device="cuda", n: int = N_ROWS, reps: int = 20):
    """``multiclass_confusion`` against its twin at the CV panel's shape:
    1M rows x 24 candidates (3 folds x 8, candidate k reading fold k // 8)
    of ``CONFUSION_CLASSES`` (the thread form up to 14, the shared form
    above): equal on the 0/1 fold masks, within 1e-6 of the f64 sums on
    non-0/1 weights, and bit-repeatable (``_confusion_case``); on the
    first ``CONFUSION_EMU_ROWS`` rows up to 15 classes also the bits of
    the numpy emulation of its order.  Returns the row of the kernels
    line (C = 4) and every case's numbers."""
    import torch

    from transmogrifai_tpu_torch import metrics_kernels as mk
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    _, y = make_multiclass_data(n, MC_FEATS)
    rng = np.random.default_rng(17)
    K, G = 3 * 8, 8
    out = {}
    for C in CONFUSION_CLASSES:
        yc = y if C == MC_CLASSES else rng.integers(0, C, n).astype(
            np.float32)
        P = np.where(rng.random((n, K)) < 0.8, yc[:, None].astype(np.int32),
                     rng.integers(0, C, (n, K))).astype(np.int32)
        yi = torch.as_tensor(yc.astype(np.int32), device=device)
        Pd = torch.as_tensor(P, device=device)
        Wm = torch.as_tensor(1.0 - _fold_weights(yc), device=device)
        Wr = torch.as_tensor(rng.random((N_FOLDS, n)).astype(np.float32),
                             device=device)
        case = _confusion_case(mk, yi, Pd, Wm, G, C, reps)
        real = _confusion_case(mk, yi, Pd, Wr, G, C, 2)
        case["rel_err_weights"] = real["rel_err"]
        if C <= 15:
            m = min(n, CONFUSION_EMU_ROWS)
            for W in (Wm, Wr):
                _confusion_case(mk, yi[:m], Pd[:m].contiguous(),
                                W[:, :m].contiguous(), G, C, 1, emulate=True)
            case["emulated_rows"] = m
        out[f"classes_{C}"] = case
        del Pd, Wm, Wr
        torch.cuda.empty_cache()
    return _kernel_row("multiclass_confusion",
                       out[f"classes_{MC_CLASSES}"]), out


def record_confusion_calls(run) -> tuple:
    """``run()`` with the shape (rows, candidates, fold rows, G, C) of every
    ``multiclass_confusion`` call of the metric panels recorded, and no
    array kept: the run's peak device memory stays its own.  Returns
    (run's result, the shapes)."""
    from transmogrifai_tpu_torch import metrics_device as md
    calls = []
    real = md.multiclass_confusion

    def recorded(y, P, Wm, G, C):
        calls.append((P.shape[0], P.shape[1], Wm.shape[0], G, C))
        return real(y, P, Wm, G, C)

    md.multiclass_confusion = recorded
    try:
        return run(), calls
    finally:
        md.multiclass_confusion = real


def check_confusion_calls(calls, device="cuda", reps: int = 10) -> dict:
    """Each distinct (rows, candidates, G, C) shape of ``calls`` (the
    multiclass train's launches, ``record_confusion_calls``) against the
    twin (``_confusion_case``), with its count of launches: labels in
    [0, C), predictions right 80% of the time, 0/1 fold masks (each row in
    one of the call's folds) and real weights in [0, 1) of the same shape,
    made from a seed."""
    import torch

    from transmogrifai_tpu_torch import metrics_kernels as mk
    rng = np.random.default_rng(23)
    shapes = {}
    for c in calls:
        shapes[c] = shapes.get(c, 0) + 1
    out = {}
    for (N, K, F, G, C), count in sorted(shapes.items()):
        y = rng.integers(0, C, N).astype(np.int32)
        P = np.where(rng.random((N, K)) < 0.8, y[:, None],
                     rng.integers(0, C, (N, K))).astype(np.int32)
        fold = rng.integers(0, F, N)
        W01 = (fold[None, :] == np.arange(F)[:, None]) | (F == 1)
        yi, Pd = (torch.as_tensor(a, device=device) for a in (y, P))
        Wm = torch.as_tensor(W01.astype(np.float32), device=device)
        Wr = torch.as_tensor(rng.random((F, N)).astype(np.float32),
                             device=device)
        out[f"N={N} K={K} G={G} C={C}"] = {
            "launches": count,
            **_confusion_case(mk, yi, Pd, Wm, G, C, reps),
            "rel_err_weights": _confusion_case(
                mk, yi, Pd, Wr, G, C, 1)["rel_err"]}
        del yi, Pd, Wm, Wr
    return out


def _mc_key(params: dict) -> tuple:
    """A candidate's grid point without the values its family shares."""
    return tuple(v for k, v in params.items()
                 if k not in ("max_iter", "max_bins", "num_trees"))


def _mc_candidates(summary) -> list:
    return [[r.model_name, _mc_key(r.params), float(r.metric_values["F1"]),
             r.raced_out] for r in summary.validation_results]


def _mc_family_best(cands) -> dict:
    best = {}
    for name, _, v, raced in cands:
        if not raced and np.isfinite(v) and v > best.get(name, -np.inf):
            best[name] = v
    return best


def multiclass_batch(X, y):
    """The raw columns: ``label`` and RealNN ``f0..f{d-1}``."""
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.types import RealNN
    cols = {"label": Column(RealNN, y)}
    for i in range(X.shape[1]):
        cols[f"f{i}"] = Column(RealNN, X[:, i])
    return ColumnBatch(cols, len(y))


def multiclass_workflow(X, y, models, device):
    """RealNN features → transmogrify → ``MultiClassificationModelSelector``
    (``models`` None: the default grid).  Returns (workflow, batch,
    prediction feature)."""
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        MultiClassificationModelSelector)
    from transmogrifai_tpu_torch.workflow import Workflow

    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor()
             for i in range(X.shape[1])]
    sel = MultiClassificationModelSelector(models=models)
    sel.set_input(label, transmogrify(feats))
    pred = sel.get_output()
    batch = multiclass_batch(X, y)
    wf = Workflow(device=device).set_input_batch(batch)
    return wf.set_result_features(pred), batch, pred


def _mc_models(grid: str):
    from transmogrifai_tpu_torch.models.linear import (
        OpMultilayerPerceptronClassifier, OpNaiveBayes)
    from transmogrifai_tpu_torch.selector import (
        ModelCandidate, MultiClassificationModelSelector, _lr_candidates)
    if grid == "default":
        return None
    if grid == "compact":
        return MultiClassificationModelSelector.compact_models()
    if grid == "lr":
        return [_lr_candidates()]
    return [ModelCandidate(OpNaiveBayes(), [{}], "OpNaiveBayes"),
            ModelCandidate(OpMultilayerPerceptronClassifier(), [{}],
                           "OpMultilayerPerceptronClassifier")]


def run_multiclass(device, X, y, grid: str = "default",
                   fresh=None) -> tuple:
    """Train the multiclass workflow on (X, y), evaluate it on its train
    rows (F1) and, given ``fresh`` (X, y), score that batch.  Returns
    (facts, model, batch)."""
    import torch

    from transmogrifai_tpu_torch.evaluators import Evaluators
    wf, batch, pred = multiclass_workflow(X, y, _mc_models(grid), device)
    t0 = time.perf_counter()
    model = wf.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = model.evaluate(Evaluators.MultiClassification.f1(), batch=batch)
    summ = model.selected_model.summary
    cands = _mc_candidates(summ)
    best = model.selected_model.best_model
    facts = {"train_wall_s": wall, "best_model": summ.best_model_name,
             "winner_kind": best.fitted.get("kind"),
             "family_best_cv_f1": _mc_family_best(cands),
             "train_f1": float(m["F1"]), "train_error": float(m["Error"]),
             "data_prep_results": summ.data_prep_results,
             "phase_seconds": model.phase_seconds,
             "selector_seconds": model.selected_model.selector_seconds,
             "candidates": cands}
    if fresh is not None:
        n = len(fresh[1])
        fresh = multiclass_batch(*fresh)
        t0 = time.perf_counter()
        out = model.score(fresh)[pred.name].values
        if device == "cuda":
            torch.cuda.synchronize()
        facts["score_rows_per_s"] = n / (time.perf_counter() - t0)
        p, prob = out["prediction"], out["probability"]
        if (tuple(p.shape) != (n,) or tuple(prob.shape) != (n, MC_CLASSES)
                or not bool(torch.isfinite(prob).all())
                or float((prob.sum(dim=1) - 1).abs().max()) > 1e-4):
            raise AssertionError("multiclass scores: wrong shape, "
                                 "non-finite or not a distribution")
    return facts, model, batch


def check_multiclass_reference(device="cuda") -> dict:
    """Iris, the default and compact grids on the card, against the JAX
    package's numbers (MC_REF); then the default LR candidates at 4,000
    bench rows, their winner and refit coefficients against
    MC_BENCH_REF."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import multiclass_grid_reference as mgr
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    out = {}
    X, y = mgr.iris()
    for grid, ref in MC_REF.items():
        facts, _, _ = run_multiclass(device, X, y, grid)
        if facts["best_model"] != ref["winner"]:
            raise AssertionError(f"iris ({grid}): winner "
                                 f"{facts['best_model']}, the JAX package's "
                                 f"is {ref['winner']}")
        lr = {key: v for name, key, v, _ in facts["candidates"]
              if name == "OpLogisticRegression"}
        if lr != ref["OpLogisticRegression"]:
            raise AssertionError(f"iris ({grid}): LR CV F1 {lr}, the JAX "
                                 f"package's {ref['OpLogisticRegression']}")
        rf = facts["family_best_cv_f1"]["OpRandomForestClassifier"]
        if abs(rf - ref["rf_best"]) > ref["rf_tol"]:
            raise AssertionError(f"iris ({grid}): forest CV F1 {rf}, the "
                                 f"JAX package's {ref['rf_best']} "
                                 f"(tolerance {ref['rf_tol']})")
        if abs(facts["train_f1"] - ref["train_f1"]) > 1e-9:
            raise AssertionError(f"iris ({grid}): train F1 "
                                 f"{facts['train_f1']}, the JAX package's "
                                 f"{ref['train_f1']}")
        out[f"iris_{grid}"] = {k: facts[k] for k in (
            "best_model", "family_best_cv_f1", "train_f1", "train_wall_s")}
    X, y = make_multiclass_data(MC_BENCH_ROWS, MC_FEATS)
    facts, model, _ = run_multiclass(device, X, y, "lr")
    best = model.selected_model
    cands = [r for r in best.summary.validation_results
             if not r.raced_out and r.metric_values["F1"]
             == best.fitted["best_metric"]]
    if _mc_key(cands[0].params) != MC_BENCH_REF["winner"]:
        raise AssertionError(f"bench LR: winner {cands[0].params}, the JAX "
                             f"package's {MC_BENCH_REF['winner']}")
    coef = best.best_model.fitted["coef"].double().cpu().numpy()
    inter = best.best_model.fitted["intercept"].double().cpu().numpy()
    want_c = np.asarray(MC_BENCH_REF["coef"])
    scale = np.abs(want_c).max()
    err = max(np.abs(coef - want_c).max(),
              np.abs(inter - np.asarray(MC_BENCH_REF["intercept"])).max())
    if err > 1e-3 * scale:
        raise AssertionError(f"bench LR: refit coefficients {err} from the "
                             f"JAX package's (max |coef| {scale})")
    out["bench_lr"] = {"rows": MC_BENCH_ROWS,
                       "winner": _mc_key(cands[0].params),
                       "coef_max_abs_err": float(err),
                       "train_f1": facts["train_f1"]}
    return out


def run_nb_mlp(device, X, y) -> dict:
    """``OpNaiveBayes`` and ``OpMultilayerPerceptronClassifier`` as the
    selector's candidates at the workload's size: they fit and score
    candidate by candidate (no batched panel).  Returns their walls and
    CV F1."""
    facts, _, _ = run_multiclass(device, X, y, "nb_mlp")
    return {k: facts[k] for k in ("train_wall_s", "best_model",
                                  "family_best_cv_f1", "train_f1",
                                  "selector_seconds")}


# --------------------------------------------------------------------------
# phase 10: GLMs (poisson and gamma, backtracking FISTA) and the softmax
# link of LOCO
# --------------------------------------------------------------------------

GLM_FAMILIES = ("poisson", "gamma")
GLM_SCORE_SEED = 22                # the fresh batch scored after training
GLM_COEF_TOL = 0.02                # the GLM refit against the true w and 0.3
GLM_CV_RTOL = 1e-4                 # the GLM family's best CV RMSE vs JAX
# The JAX package's GLM workloads at 1,000,000 rows (synthetic.make_glm_data
# seed 21, CPU; `PYTHONPATH=. JAX_PLATFORMS=cpu python
# scripts/glm_grid_reference.py --package jax --family poisson --rows
# 1000000`, and `--family gamma`): the winner, its params, and each
# family's best CV RMSE over the points that ran every fold.  The card must
# give the same winner and the GLM family's best within GLM_CV_RTOL.
GLM_REF = {
    "poisson": {"winner": "OpGeneralizedLinearRegression",
                "winner_params": {"reg_param": 0.001, "max_iter": 50},
                "family_best_cv_rmse": {
                    "OpGeneralizedLinearRegression": 1.300746003786723,
                    "OpLinearRegression": 1.4255808194478352}},
    "gamma": {"winner": "OpGeneralizedLinearRegression",
              "winner_params": {"reg_param": 0.001, "max_iter": 50},
              "family_best_cv_rmse": {
                  "OpGeneralizedLinearRegression": 1.5022064447402954,
                  "OpLinearRegression": 1.6095457077026367}}}
SOFTMAX_WIDE_CLASSES = 40          # PR 8's 40-class checks


def _glm_case(Xd, W, yd, mean, scale, loss: str, G: int, rng, reps: int,
              grad: bool, chunk: int = 131_072) -> dict:
    """``fista_glm`` for F x G lanes (F = W's folds) with random
    coefficients (margins of sd ~0.4 around 0.3, the workload's own size),
    against its twin run in f64: the loss value, X^T g and sum g each
    within 1e-5 of its absolute mass (the sum of |terms|), and two launches
    bit for bit.  ``grad`` False: the value-only form, as a backtracking
    ladder lays its (lane, trial step) lanes out.  The library yardstick is
    cuBLAS for the margins and (``grad``) for X^T g, with the loss terms
    between.  ``ms`` by CUDA events, ``kernel_ms`` the device ms of the
    call's kernels by the profiler.  Returns the case's numbers."""
    import torch

    from transmogrifai_tpu_torch.models import linear_kernels as lk

    device = Xd.device
    n, D = Xd.shape
    L = W.shape[0] * G
    lanes = torch.arange(L, device=device) // G
    # sd 0.1 on the workload's 16 columns, shrunk on a wider matrix so
    # margins keep the same size
    coef = torch.as_tensor(rng.normal(scale=0.1 * min(1.0, (16 / D) ** 0.5),
                                      size=(L, D)).astype(np.float32),
                           device=device)
    V = (coef / scale[lanes]).contiguous()
    b = torch.as_tensor((0.3 + rng.normal(scale=0.1, size=L)).astype(
        np.float32), device=device)
    args = (Xd, V, (mean[lanes] * V).sum(dim=1), b, W, yd,
            W.sum(dim=1)[lanes], G, loss, grad)
    got = lk.fista_glm(*args)
    again = lk.fista_glm(*args)
    got = got if grad else (got,)
    again = again if grad else (again,)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"fista_glm ({loss}, {L} lanes): two launches "
                             "differ")
    V64, muv64, b64, ws64 = (a.double() for a in (V, args[2], b, args[6]))
    val = torch.zeros(L, dtype=torch.float64, device=device)
    vabs = torch.zeros_like(val)
    want = torch.zeros((L, D), dtype=torch.float64, device=device)
    mass = torch.zeros_like(want)
    gsum, gabs = torch.zeros_like(val), torch.zeros_like(val)
    for r0 in range(0, n, chunk):
        sl = slice(r0, min(n, r0 + chunk))
        x64 = Xd[sl].double()
        lin = V64 @ x64.T - muv64[:, None] + b64[:, None]
        lw, g = lk.glm_row_terms(lin, yd[sl].double(), W[lanes][:, sl].double(),
                                 ws64[:, None], loss)
        val += lw.sum(dim=1)
        vabs += lw.abs().sum(dim=1)
        if grad:
            want += g @ x64
            mass += g.abs() @ x64.abs()
            gsum += g.sum(dim=1)
            gabs += g.abs().sum(dim=1)
    checks = [(got[-1], val / ws64, vabs / ws64)]
    if grad:
        checks += [(got[0], want, mass), (got[1], gsum, gabs)]
    err = 0.0
    for g32, w64, m in checks:
        e = (g32.double() - w64).abs()
        if bool((e > 1e-5 * m + 1e-12).any()):
            raise AssertionError(f"fista_glm ({loss}, {L} lanes, grad "
                                 f"{grad}) disagrees with its f64 twin")
        err = max(err, float(e.max()))

    def cublas():           # margins, loss terms, X^T g: timed only
        lin = V @ Xd.T - args[2][:, None] + b[:, None]
        lw, g = lk.glm_row_terms(lin, yd, W[lanes], args[6][:, None], loss)
        return (lw.sum(dim=1), g @ Xd) if grad else lw.sum(dim=1)

    folds = len(set(lanes.tolist()))
    bt, by = bound(4 * Xd.numel() + 4 * n * folds + 4 * n
                   + 4 * (L * D + 4 * L) + (4 * (L * D + L) if grad else 0),
                   (4 if grad else 2) * n * D * L + 10 * n * L)
    # the margins (and X^T g) on TF32 tensor cores in split TF32: the
    # kernel's own bound (the f32 one above is the rows' yardstick)
    plan = lk.glm_launch_plan(D, L, grad)
    run = lambda: lk.fista_glm(*args)                     # noqa: E731
    nbytes = (4 * Xd.numel() + 4 * n * folds + 4 * n
              + 4 * (L * D + 4 * L) + (4 * (L * D + L) if grad else 0))
    return {"lanes": L, "loss": loss, "grad": grad, "rows": n,
            "plan": plan, "max_abs_err": err,
            "split_tf32_bound_ms": split_tf32_bound(
                nbytes, (4 if grad else 2) * n * D * L),
            "ms": time_ms(run, reps),
            "kernel_ms": kernel_device_ms(
                run, reps, "fista_glm" if plan["form"] != "wide"
                else "fista_wide_kernels")["ms"],
            "plain_ms": time_ms(lambda: lk.fista_glm_twin(*args[:-1], grad),
                                max(2, reps // 4)),
            "bound_ms": bt, "bound_by": by,
            "library_ms": time_ms(cublas, max(2, reps // 4))}


def check_glm_kernel(device="cuda", n: int = N_ROWS, reps: int = 10):
    """``fista_glm`` against its f64 twin on each GLM workload's 1M x 16
    matrix at the CV block's shapes: the gradient form at 3 folds x 4 lanes
    and the value-only form at the 3 x 4 lanes x 8 trial steps of one
    backtracking ladder (``solvers.LADDER``); then the CV block itself (the
    default reg_params, 50 iterations) fitted twice, which must repeat its
    coefficients, ``n_iter`` and step halvings bit for bit.  Returns the
    two rows of the kernels line (poisson: gradient, value pass) and every
    case's numbers."""
    import torch

    from transmogrifai_tpu_torch.models.solvers import (LADDER,
                                                        linear_grid_fit,
                                                        standardize_moments)
    from transmogrifai_tpu_torch.selector import DefaultSelectorParams
    from transmogrifai_tpu_torch.synthetic import make_glm_data
    rng = np.random.default_rng(30)
    out = {}
    for family in GLM_FAMILIES:
        X, y = make_glm_data(n, family)
        Xd = torch.as_tensor(X, device=device)
        yd = torch.as_tensor(y, device=device)
        W = torch.as_tensor(_fold_weights(y), device=device)
        mean, scale = standardize_moments(Xd, W, center=True)
        out[f"{family}_grad"] = _glm_case(Xd, W, yd, mean, scale, family, 4,
                                          rng, reps, True)
        out[f"{family}_value"] = _glm_case(Xd, W, yd, mean, scale, family,
                                           4 * LADDER, rng, reps, False)
        reg = torch.tensor(DefaultSelectorParams.REGULARIZATION,
                           device=device)
        fits = [linear_grid_fit(Xd, yd, W, reg, torch.zeros_like(reg),
                                loss=family, max_iter=50) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*fits)):
            raise AssertionError(f"GLM ({family}) CV block: two fits differ")
        out[f"{family}_cv_block"] = {
            "n_iter": fits[0].n_iter.tolist(),
            "halvings": fits[0].halvings.tolist(), "repeats": True}
        del Xd, yd, W, fits
        torch.cuda.empty_cache()
    return [_kernel_row("fista_glm", out[key])
            for key in ("poisson_grad", "poisson_value")], out


def run_glm(device, n: int, family: str, fresh: bool = True) -> tuple:
    """The GLM workload of ``family`` (``scripts/glm_grid_reference.py``:
    ``make_glm_data`` rows → transmogrify → ``RegressionModelSelector`` over
    GLM x4 and LinReg x8) trained, evaluated (RMSE, R²) and, with
    ``fresh``, scored on a fresh batch (seed GLM_SCORE_SEED); the GLM
    refit's distance from the true coefficients.  Returns (facts, model,
    batch)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import glm_grid_reference as ggr
    from transmogrifai_tpu_torch.evaluators import Evaluators
    X, y = ggr.make_glm_data(n, family)
    model, batch, pred, wall = ggr.train(PORT, X, y, family, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    m = model.evaluate(Evaluators.Regression.rmse(), batch=batch)
    sel = model.selected_model
    best = sel.best_model
    facts = {"family": family, "rows": n, "train_wall_s": wall,
             "best_model": sel.summary.best_model_name,
             "winner_params": ggr.winner_params(model),
             "family_best_cv_rmse": ggr.family_best(model),
             "train_rmse": float(m["RootMeanSquaredError"]),
             "train_r2": float(m["R2"]),
             "refit_n_iter": best.fitted.get("n_iter"),
             "refit_halvings": best.fitted.get("halvings"),
             "phase_seconds": model.phase_seconds,
             "selector_seconds": sel.selector_seconds,
             "candidates": ggr.candidates(model)}
    if best.fitted.get("kind") == "glm":
        facts.update(ggr.coef_errors(
            {k: best.fitted[k].cpu() for k in ("coef", "intercept")},
            X.shape[1]))
    if fresh:
        fb = ggr.batch_of(PORT, *ggr.make_glm_data(n, family,
                                                   seed=GLM_SCORE_SEED))
        t0 = time.perf_counter()
        p = model.score(fb)[pred.name].values["prediction"]
        if device == "cuda":
            torch.cuda.synchronize()
        facts["score_rows_per_s"] = n / (time.perf_counter() - t0)
        if (tuple(p.shape) != (n,) or not bool(torch.isfinite(p).all())
                or not bool((p > 0).all())):
            raise AssertionError(f"GLM ({family}) scores: shape "
                                 f"{tuple(p.shape)}, non-finite or not "
                                 "positive")
    return facts, model, batch


def check_glm_reference(facts: dict) -> None:
    """A GLM workload's run against the JAX package's (GLM_REF) and the
    truth: the same winner, the GLM family's best CV RMSE within
    GLM_CV_RTOL, the winner's refit within GLM_COEF_TOL of the true
    coefficients and intercept."""
    ref = GLM_REF[facts["family"]]
    if facts["best_model"] != ref["winner"]:
        raise AssertionError(f"GLM ({facts['family']}): winner "
                             f"{facts['best_model']}, the JAX package's is "
                             f"{ref['winner']}")
    name = "OpGeneralizedLinearRegression"
    got, want = (facts["family_best_cv_rmse"][name],
                 ref["family_best_cv_rmse"][name])
    if abs(got - want) > GLM_CV_RTOL * want:
        raise AssertionError(f"GLM ({facts['family']}): best CV RMSE {got}, "
                             f"the JAX package's {want}")
    if (facts["coef_max_abs_err"] > GLM_COEF_TOL
            or facts["intercept_abs_err"] > GLM_COEF_TOL):
        raise AssertionError(f"GLM ({facts['family']}): refit "
                             f"{facts['coef_max_abs_err']} / "
                             f"{facts['intercept_abs_err']} from the true "
                             "coefficients / intercept")


def run_loco_stage(model, batch, check, device="cuda") -> tuple:
    """``RecordInsightsLOCO`` (top-20) through its transform on a trained
    model's winner over the selector's own vector of ``batch``, maps
    included, with the launches read around the transform alone, then its
    kernel against the twin on that vector (``check(X, model, col_group,
    G, k)``).  Returns (facts, launches)."""
    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.record_insights import loco_groups
    sel = model.selected_model
    vec_f = sel.input_features[1]
    scored = apply_dag(batch.on(device), model.fitted_dag[:-1]).select(
        [vec_f.name])
    vec = scored[vec_f.name]
    groups = loco_groups(vec.meta, vec.values.shape[1])
    names = list(groups)
    cg = ik.col_group_of(list(groups.values()), vec.values.shape[1], device)
    G = len(names)
    k = min(LOCO_K, G)
    kernels.reset_launch_counts()
    maps, wall = _loco_stage(sel, vec_f, scored)
    launches = kernels.launch_counts()
    _check_maps(maps, len(batch), k, names)
    case = check(vec.values.contiguous(), sel.best_model, cg, G, k)
    return {"winner": type(sel.best_model).__name__,
            "winner_kind": sel.best_model.fitted.get("kind"), "groups": G,
            "top_k": k, "loco_wall_s": wall,
            "loco_rows_per_s": len(batch) / wall, "loco_kernel": case,
            "row0": maps[0]}, launches


def _softmax_library(X, model, col_group, G: int, k: int):
    """The library yardstick of ``loco_softmax``: the base and every
    group's first-layer contributions as one cuBLAS product ``phi(X) @
    (W1 ⊙ onehot)`` [N, G·H], the tail as batched products, the softmax,
    the diffs and ``torch.topk``."""
    import torch

    from transmogrifai_tpu_torch import insights_kernels as ik
    relu_in, W1, b1, tail = ik.softmax_layers(model, X.device)
    D, H = W1.shape
    Wg = torch.zeros((D, G, H), device=X.device)
    Wg[torch.arange(D, device=X.device), col_group.long()] = W1
    Wg = Wg.reshape(D, G * H)

    def run():
        Z = torch.clamp(X, min=0.0) if relu_in else X
        a = Z @ W1
        A = torch.cat([a[:, None], a[:, None] - (Z @ Wg).reshape(
            -1, G, H)], dim=1) + b1
        for Wt, bt in tail:
            A = torch.relu(A) @ Wt + bt
        p = torch.softmax(A, dim=-1)[..., -1]
        return torch.topk((p[:, :1] - p[:, 1:]).abs(), k, dim=1)
    return run


def _softmax_diffs_f64(X, model, col_group, G: int, chunk: int = 100_000):
    """Every group's diff [N, G] in f64 (the model's layers on the masked
    rows, the last class's softmax), ``chunk`` rows at a time."""
    import torch

    from transmogrifai_tpu_torch import insights_kernels as ik
    relu_in, W1, b1, tail = ik.softmax_layers(model, X.device)

    def p_last(Z):
        a = (torch.clamp(Z, min=0.0) if relu_in else Z) @ W1.double() \
            + b1.double()
        for W, b in tail:
            a = torch.relu(a) @ W.double() + b.double()
        return torch.softmax(a, dim=-1)[:, -1]

    out = []
    for i in range(0, X.shape[0], chunk):
        Z = X[i:i + chunk].double()
        base = p_last(Z)
        out.append(torch.stack([base - p_last(Z * (col_group != g).double())
                                for g in range(G)], dim=1))
    return torch.cat(out)


def check_loco_softmax(X, model, col_group, G: int, k: int = LOCO_K,
                       strategy: str = "abs", reps: int = 10,
                       library: bool = False) -> dict:
    """``loco_softmax`` on X against its twin (``_loco_case``), with its
    largest diff error against the f64 diffs and whether its error against
    the twin is within the CPU tests' rule (1e-6 x max(1, the largest
    |logit| / 8)), its device ms by the profiler; where the plan takes the
    row form, that rule held (it fails otherwise) and the same indices and
    diffs bit for bit as the warp form on the same inputs.  The warp
    form's shapes report the rule and are not held to it."""
    import torch

    from transmogrifai_tpu_torch import insights_kernels as ik
    N, D = X.shape
    _, W1, _, tail = ik.softmax_layers(model, X.device)
    H = W1.shape[1]
    dims = [H] + [W.shape[1] for W, _ in tail]
    tail_ops = sum(2 * a * b for a, b in zip(dims, dims[1:]))

    def run():
        return ik.loco_softmax(X, model, col_group, G, k, strategy)

    case = _loco_case(
        run, lambda kk: ik.loco_topk_twin(
            X, lambda Z: ik.loco_score(model, Z), col_group, G, kk,
            strategy), G, k, strategy, reps,
        4 * N * D,
        4 * N * D * H + N * (G + 1) * (tail_ops + 4 * dims[-1]),
        _softmax_library(X, model, col_group, G, k) if library else None)
    plan = ik.loco_softmax_plan(N, D, G, k, H, dims[-1], dims[1:])
    raw = model.device_scores(X, full=True)["rawPrediction"]
    tol6 = 1e-6 * max(1.0, float(raw.abs().max()) / 8.0)
    del raw
    idx, val = run()
    f64 = float((val.double() - torch.gather(
        _softmax_diffs_f64(X, model, col_group, G), 1, idx.long()))
        .abs().max())
    out = {**case, "classes": dims[-1], "first_layer": H,
           "tail": dims[1:], "rows": N, "features": D,
           "rule_1e6": tol6, "within_rule_1e6": case["max_abs_err"] <= tol6,
           "max_abs_err_f64": f64,
           "device_ms": kernel_device_ms(run, reps, "loco_softmax")["ms"],
           "plan": plan._asdict()}
    if getattr(plan, "form", "warps") == "rows":
        if not out["within_rule_1e6"]:
            raise AssertionError(
                f"loco_softmax (row form): diff error {case['max_abs_err']}"
                f" against the twin, past the rule's {tol6}")
        ri, rv = run()
        keep = ik.ROW_WIDTH_MAX
        ik.ROW_WIDTH_MAX = 0
        try:
            wi, wv = run()
            out["warp_form_device_ms"] = kernel_device_ms(
                run, max(2, reps // 2), "loco_softmax")["ms"]
        finally:
            ik.ROW_WIDTH_MAX = keep
        if not (torch.equal(ri, wi.to(ri.dtype)) and torch.equal(rv, wv)):
            raise AssertionError("loco_softmax: the row form's lists are not "
                                 "the warp form's bits")
        out["warp_form_bits"] = True
    return out


def check_softmax_loco_shapes(X, y, device="cuda") -> dict:
    """``loco_softmax`` against its twin beyond the multiclass winner: naive
    Bayes and the MLP fitted on the multiclass workload's 1M x 16 rows (one
    group per column, top-16), a 40-class softmax LR at 1M x 16 (random
    coefficients of sd 0.5: logits of sd ~2) and a 4-class one fitted at
    ``scripts/bench_loco.py``'s 100,000 x 512 with 128 groups (top-20; the
    labels the argmax of random class scores, 20 iterations, as
    ``check_insights_kernels`` fits its LR there), each with its library
    yardstick, and there at k = 40 (the warp form's list in the output);
    random softmax LRs of 16 and 17 classes on ``THRESHOLD_ROWS`` rows, on
    both sides of the row form's widest layer.  Returns every case's
    numbers."""
    import torch

    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models.linear import (
        LinearPredictionModel, OpLogisticRegression,
        OpMultilayerPerceptronClassifier, OpNaiveBayes)
    Xd = torch.as_tensor(X, device=device)
    D = Xd.shape[1]
    cg = torch.arange(D, device=device, dtype=torch.int32)
    out = {}
    for name, est in (("naive_bayes", OpNaiveBayes()),
                      ("mlp", OpMultilayerPerceptronClassifier())):
        m = est.model_cls(fitted=est.fit_arrays(Xd, y, device=device))
        out[name] = check_loco_softmax(Xd, m, cg, D, D, library=True)
    rng = np.random.default_rng(31)

    def random_lr(d, C):
        return LinearPredictionModel(fitted={
            "kind": "multinomial", "n_classes": C,
            "coef": torch.as_tensor(rng.normal(scale=0.5, size=(d, C))
                                    .astype(np.float32), device=device),
            "intercept": torch.as_tensor(rng.normal(size=C).astype(
                np.float32), device=device)})

    out[f"classes_{SOFTMAX_WIDE_CLASSES}"] = check_loco_softmax(
        Xd, random_lr(D, SOFTMAX_WIDE_CLASSES), cg, D, D, library=True)
    del Xd
    n, d, g = BENCH_LOCO
    Xb = rng.normal(size=(n, d)).astype(np.float32)
    yb = np.argmax(Xb @ rng.normal(size=(d, MC_CLASSES)), axis=1).astype(
        np.float32)
    lr = LinearPredictionModel(fitted=OpLogisticRegression(
        max_iter=20).fit_arrays(Xb, yb, device=device))
    Xb = torch.as_tensor(Xb, device=device)
    cg_b = torch.arange(d, device=device, dtype=torch.int32) // (d // g)
    out["bench_loco_g128"] = check_loco_softmax(Xb, lr, cg_b, g,
                                                library=True)
    out["bench_loco_negative"] = check_loco_softmax(
        Xb, lr, cg_b, g, strategy="negative", reps=2)
    out["bench_loco_k40"] = check_loco_softmax(Xb, lr, cg_b, g, min(40, g),
                                               reps=2)
    del Xb
    # both sides of the row form's widest layer (16): 16 and 17 classes
    Xt = torch.as_tensor(X[:THRESHOLD_ROWS], device=device)
    for C in (ik.ROW_WIDTH_MAX, ik.ROW_WIDTH_MAX + 1):
        out[f"classes_{C}"] = check_loco_softmax(Xt, random_lr(D, C), cg, D,
                                                 D, reps=3)
    del Xt
    torch.cuda.empty_cache()
    return out



# --------------------------------------------------------------------------
# phase 12: the repaired card-only refusals, and tree_hist at the forests'
# lane batches
# --------------------------------------------------------------------------

FAULT_BINS = (64, 127)             # max_bins past the 32 a warp lane held
FAULT_MLPS = ((256, 256), (900,))  # hidden layers past one block's memory


def _split_level(device, data: tuple, yr, lanes: int, P: int,
                 seed: int = 17) -> dict:
    """A level of ``lanes`` lanes over ``data`` (y, split values, B: the
    bench matrix binned at some bin count) with the regression target
    ``yr``: xgb, gini and variance statistics (Poisson x fold weights),
    rows over the level's P nodes and 5-of-28 node subsets."""
    import torch

    y, sp_t, B = data
    n, D = B.shape
    rng = np.random.default_rng(seed)
    w = torch.as_tensor((rng.poisson(1.0, size=(lanes, n))
                         * (rng.random((lanes, n)) > 1 / 3)).astype(
                             np.float32), device=device)
    yd = torch.as_tensor(y, device=device)
    pm = torch.sigmoid(0.3 * torch.randn((lanes, n), device=device,
                                         generator=torch.Generator(
                                             device=device).manual_seed(seed)))
    stats = {"xgb": torch.stack([w, w * (pm - yd), w * pm * (1 - pm)], 2),
             "gini": torch.stack([w, w * (1 - yd), w * yd], 2),
             "variance": torch.stack([w, w * yr, w * yr * yr], 2)}
    m = np.zeros((lanes, P, D), bool)
    for k in range(lanes):
        for p in range(P):
            m[k, p, rng.choice(D, 5, replace=False)] = True
    rn = torch.as_tensor(rng.integers(P - 1, 2 * P - 1, size=(lanes, n))
                         .astype(np.int32), device=device)
    return {"B": B, "splits": sp_t, "row_node": rn,
            "stats": {k: v.contiguous() for k, v in stats.items()},
            "mask": torch.as_tensor(m, device=device)}


def check_wide_bins(device="cuda", n: int = 200_000, reps: int = 10):
    """The three split kernels at 64 and 127 bins (two and four bins a warp
    lane) against their twins (``_check_split``,
    ``_check_split_variance``) on histograms of a GBT level (3 lanes,
    P = 4) and a forest level 5 (60 lanes, P = 32, node subsets), timed at
    64 bins; the bench matrix is made once and binned once a bin count.
    Returns the 64-bin rows of the kernels line (their launches are set by
    the caller from ``run_bins_paths``) and the facts."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models.trees import binned
    rows, facts = [], {}
    X, y = make_data(n)
    Xd = torch.as_tensor(X, device=device)
    yr = Xd[:, 0] + Xd[:, 1] * Xd[:, 2]
    for n_bins in FAULT_BINS:
        _, sp_t, B = binned(Xd, Xd, n_bins)
        levels = {(lanes, P): _split_level(device, (y, sp_t, B), yr, lanes,
                                           P)
                  for lanes, P in ((3, 4), (60, 32))}
        for lanes, P, fam in ((3, 4, "xgb"), (60, 32, "gini"),
                              (60, 32, "variance")):
            lv = levels[(lanes, P)]
            D = lv["B"].shape[1]
            nm = None if fam == "xgb" else lv["mask"]
            h, t = tk.tree_hist(lv["B"], lv["row_node"], lv["stats"][fam],
                                P - 1, P, n_bins, node_mask=nm)
            lane = lambda v: torch.full((lanes,), v, device=device)  # noqa
            fmask = torch.ones(D, dtype=torch.bool, device=device)
            # the subsets' width as fit_trees passes it (no wait for the
            # card inside the timed call)
            width = None if nm is None else int(nm.sum(dim=2).amax())
            if fam == "variance":
                args = (h, t, fmask, nm, lv["splits"], lane(10.0),
                        lane(0.001))
                err = _check_split_variance(tk, *args)
                run = lambda: tk.tree_split_variance(  # noqa: E731
                    *args, width=width)
                twin = lambda: tk.tree_split_variance_twin(*args)  # noqa
                name = "tree_split_variance"
            elif fam == "gini":
                args = (h, t, fmask, nm, lv["splits"], lane(10.0), lane(0.0))
                err = _check_split(tk, *args)
                run = lambda: tk.tree_split_gini(  # noqa: E731
                    *args, width=width)
                twin = lambda: tk.tree_split_gini_twin(*args)  # noqa: E731
                name = "tree_split_gini"
            else:
                args = (h, t, fmask, lv["splits"], lane(10.0), lane(0.0),
                        lane(1.0))
                err = _check_split(tk, h, t, fmask, None, lv["splits"],
                                   args[4], args[5], args[6])
                run = lambda: tk.tree_split(*args)  # noqa: E731
                twin = lambda: tk.tree_split_twin(*args)  # noqa: E731
                name = "tree_split"
            case = {"lanes": lanes, "P": P, "bins": n_bins,
                    "max_abs_err": err}
            if n_bins == 64:
                kept = (D * lanes * P if nm is None else int(nm.sum()))
                bt, by = bound(4 * kept * n_bins * 3 + 4 * t.numel()
                               + (0 if nm is None else nm.numel())
                               + 4 * lv["splits"].numel() + 21 * lanes * P,
                               23 * kept * n_bins)
                case.update(ms=time_ms(run, reps),
                            device_ms=kernel_device_ms(run, reps, name)["ms"],
                            plain_ms=time_ms(twin, max(2, reps // 4)),
                            bound_ms=bt, bound_by=by, library_ms=None)
                rows.append(_kernel_row(name, case))
            facts[f"{name}_bins_{n_bins}"] = case
            del h, t, args
        del levels, B
        torch.cuda.empty_cache()
    return rows, facts


def run_bins_paths(device="cuda") -> tuple:
    """Each tree family fitted at ``max_bins=64`` through the estimators a
    user calls, on 2,000 x 4 normal rows, on the card and on the CPU twins
    (a forest's draws made on the host): training AuROC (R² for the
    regressor) within 1e-3 (a split may part at an f32 tie).  Returns the
    facts and the kernel launches of the card fits alone."""
    import torch

    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import trees as pt
    facts = {}
    rng = np.random.default_rng(64)
    X = rng.normal(size=(2000, 4)).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1] ** 2 - 0.7 * X[:, 2] * X[:, 3]
    yc = (z + 0.3 * rng.normal(size=2000) > 0.4).astype(np.float32)

    def auroc(p, y):
        r = np.empty(len(p))
        r[np.argsort(p, kind="stable")] = np.arange(1, len(p) + 1)
        pos = y > 0.5
        return ((r[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                / (pos.sum() * (~pos).sum()))

    def r2(p, y):
        return 1 - ((p - y) ** 2).sum() / ((y - y.mean()) ** 2).sum()

    cases = ((pt.OpRandomForestClassifier(max_bins=64), yc, "scores", auroc),
             (pt.OpGBTClassifier(max_bins=64), yc, "scores", auroc),
             (pt.OpRandomForestRegressor(max_bins=64), z.astype(np.float32),
              "prediction", r2))
    fits = {}
    kernels.reset_launch_counts()
    for est, y, _, _ in cases:
        est.set("draw_device", "cpu")
        fits[id(est)] = est.fit_arrays(X, y, device=device)
    launched = kernels.launch_counts()
    for est, y, key, metric in cases:
        got = {}
        for dev in (device, "cpu"):
            fitted = (fits[id(est)] if dev == device
                      else est.fit_arrays(X, y, device=dev))
            out = pt.TreeEnsembleModel(fitted=fitted).device_scores(
                torch.as_tensor(X, device=dev))[key]
            out = out.cpu().double().numpy()
            if not np.isfinite(out).all():
                raise AssertionError(f"{type(est).__name__}(max_bins=64) "
                                     f"on {dev}: non-finite scores")
            got[dev] = float(metric(out, y))
        facts[f"{type(est).__name__}_bins_64"] = got
        if abs(got[device] - got["cpu"]) > 1e-3:
            raise AssertionError(f"{type(est).__name__}(max_bins=64): card "
                                 f"{got[device]} against CPU {got['cpu']}")
    missing = [k for k in ("tree_split", "tree_split_gini",
                           "tree_split_variance", "tree_hist")
               if launched[k] <= 0]
    if missing and device != "cpu":
        raise AssertionError(f"max_bins=64 fits launched no {missing}")
    return facts, launched


def check_fault_shapes(device="cuda", reps: int = 5, glm_rows: int = N_ROWS):
    """The FISTA shapes no tensor-core or one-tile launch held, through
    the wrappers (``_fista_case``, ``_softmax_case``, ``_glm_case``: within
    1e-5 of each output's f64 mass, bit-repeatable): into the two-pass form
    ``fista_step`` at 2,000 x 27,009 with one lane, ``fista_softmax`` with
    65 classes (20,000 x 16, 8 lanes) and ``fista_glm`` at 2,000 x 27,009
    (past the tensor-core form's width); ``fista_glm`` at ``glm_rows`` x
    4,900 and 5,000 x 16,384, which the old one-tile GLM form refused, now
    on the tensor-core form (a cluster of feature slices); then
    ``loco_softmax`` on MLPs of
    ``hidden_layers=(256, 256)`` and (900,), 4 classes, at 100,000 x 16
    (one group a column, top-16).  Returns the ``fista_wide`` and
    ``fista_glm`` rows of the kernels line and every case's numbers."""
    import torch

    from transmogrifai_tpu_torch.models.linear import MLPClassificationModel
    from transmogrifai_tpu_torch.models.solvers import standardize_moments
    rng = np.random.default_rng(27)
    facts, rows = {}, []

    def matrix(n, d, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        X = torch.randn((n, d), generator=gen, device=device)
        y = (rng.random(n) > 0.5).astype(np.float32)
        W = torch.as_tensor(_fold_weights(y), device=device)
        return X, torch.as_tensor(y, device=device), W

    X, yd, W = matrix(2000, 27_009, 1)
    mean, scale = standardize_moments(X, W, center=True)
    c = _fista_case(X, W[:1], yd, mean[:1], scale[:1], "logistic", 1, rng,
                    reps)
    facts["fista_step_27009"] = c
    rows.append(_kernel_row("fista_wide", c))
    del X, mean, scale
    X, _, W = matrix(20_000, 16, 2)
    yi = torch.as_tensor(rng.integers(0, 65, 20_000).astype(np.int32),
                         device=device)
    mean, scale = standardize_moments(X, W, center=True)
    c = _softmax_case(X, W[:1], yi, mean[:1], scale[:1], 8, 65, rng, reps)
    facts["fista_softmax_65"] = c
    rows.append(_kernel_row("fista_wide", c))
    for n, d, loss, folds in ((glm_rows, 4_900, "poisson", 3),
                              (5_000, 16_384, "gamma", 3),
                              (2_000, 27_009, "poisson", 1)):
        X, _, W = matrix(n, d, d)
        yg = torch.as_tensor((rng.poisson(1.3, n) if loss == "poisson"
                              else rng.gamma(2.0, 0.7, n)).astype(np.float32),
                             device=device)
        mean, scale = standardize_moments(X, W, center=True)
        c = _glm_case(X, W[:folds], yg, mean[:folds], scale[:folds], loss, 4,
                      rng, reps, True)
        wide = d > 16_384
        if (c["plan"]["form"] == "wide") != wide:
            raise AssertionError(f"fista_glm at {d} features: plan "
                                 f"{c['plan']}")
        facts[f"fista_glm_{d}"] = c
        rows.append(_kernel_row("fista_wide" if wide else "fista_glm", c))
        del X, mean, scale
    for name in ("fista_step_27009", "fista_softmax_65"):
        if facts[name]["form"] != "wide":
            raise AssertionError(f"{name}: form {facts[name]['form']}")
    torch.cuda.empty_cache()
    n, D, C = 100_000, 16, 4
    X = torch.randn((n, D), generator=torch.Generator(
        device=device).manual_seed(9), device=device)
    cg = torch.arange(D, dtype=torch.int32, device=device)
    for hidden in FAULT_MLPS:
        sizes = [D, *hidden, C]
        fitted = {"kind": "mlp", "n_layers": len(sizes) - 1, "n_classes": C}
        for i in range(len(sizes) - 1):
            fitted[f"W{i}"] = torch.as_tensor(rng.normal(
                scale=(2.0 / sizes[i]) ** 0.5, size=(sizes[i], sizes[i + 1]))
                .astype(np.float32), device=device)
            fitted[f"b{i}"] = torch.as_tensor(rng.normal(
                scale=0.1, size=sizes[i + 1]).astype(np.float32),
                device=device)
        model = MLPClassificationModel(fitted=fitted)
        facts["loco_softmax_" + "x".join(map(str, hidden))] = \
            check_loco_softmax(X, model, cg, D, D, reps=3, library=True)
    return rows, facts


def run_fault_paths(device="cuda", scale: int = 1) -> tuple:
    """The repaired FISTA shapes through the estimators a user calls
    (``fit_arrays``), on the card and on the CPU twins: a binary
    ``OpLogisticRegression`` at 2,000 x 27,009 (one lane, past the
    tensor-core form's width), a 65-class ``OpLogisticRegression`` at
    20,000 x 16 (past its 64 columns) and a poisson
    ``OpGeneralizedLinearRegression`` at 20,000 x 4,900 (past what the old
    one-tile GLM form held: the tensor-core form's clusters now); ``scale``
    divides the rows and widths (for a CPU try).
    Each card fit's scores agree with the CPU fit's within 1e-3 (the
    probabilities; the poisson means relative to their largest).  Returns
    the facts and the kernel launches of the card fits alone."""
    import torch

    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.models import linear as pl
    rng = np.random.default_rng(31)

    def data(n, d):
        X = rng.normal(size=(n // scale, max(16, d // scale))).astype(
            np.float32)
        w = np.zeros(X.shape[1], np.float32)
        w[:8] = rng.normal(size=8)
        return X, X @ w
    X1, z1 = data(2000, 27_009)
    y1 = (z1 + rng.normal(size=len(z1)) > 0).astype(np.float32)
    X2, _ = data(20_000, 16)
    y2 = np.argmax(X2[:, :1] * np.linspace(-2, 2, 65)[None]
                   + rng.gumbel(size=(len(X2), 65)), 1).astype(np.float32)
    X3, z3 = data(20_000, 4_900)
    y3 = rng.poisson(np.exp(0.3 * z3 / max(1e-6, z3.std()))).astype(
        np.float32)
    cases = {
        "logistic_27009": (pl.OpLogisticRegression(reg_param=0.1), X1, y1,
                           "scores"),
        "softmax_65": (pl.OpLogisticRegression(reg_param=0.01), X2, y2,
                       "probability"),
        "glm_poisson_4900": (pl.OpGeneralizedLinearRegression(
            family="poisson", reg_param=0.01), X3, y3, "prediction")}
    fits, facts = {}, {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for name, (est, X, y, _) in cases.items():
        fits[name] = est.fit_arrays(X, y, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    facts["card_fits_s"] = time.perf_counter() - t0
    launched = kernels.launch_counts()
    for name, (est, X, y, key) in cases.items():
        out = {}
        for dev, fitted in ((device, fits[name]),
                            ("cpu", est.fit_arrays(X, y, device="cpu"))):
            model = est.model_cls(fitted=fitted)
            s = model.device_scores(torch.as_tensor(X, device=dev))[key]
            out[dev] = s.cpu().double().numpy()
            if not np.isfinite(out[dev]).all():
                raise AssertionError(f"{name} on {dev}: non-finite scores")
        diff = float(np.abs(out[device] - out["cpu"]).max())
        if key == "prediction":
            diff /= float(np.abs(out["cpu"]).max())
        facts[name] = {"shape": list(X.shape), "max_score_diff": diff,
                       "n_iter": int(fits[name].get("n_iter", -1))}
        if diff > 1e-3:
            raise AssertionError(f"{name}: card and CPU scores differ by "
                                 f"{diff}")
    if launched["fista_wide"] <= 0 and device != "cpu":
        raise AssertionError("the repaired FISTA fits launched no fista_wide")
    return facts, launched


def check_forest_hist_levels(device="cuda", n: int = N_ROWS, lanes: int = 300,
                             reps: int = 3) -> tuple:
    """``tree_hist`` at the largest lane batch the default grid's forests
    launch (300 lanes; ``trees.lane_batches`` also gives 150 and 200) at
    levels 0, 2, 4 and 5 (P = 1, 4, 16, 32) with the nodes' 5-of-28
    subsets, and at level 5 with every feature (``hist_case``); the bench
    matrix is binned once for all of them.  Returns the rows of the
    kernels line and their numbers."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rows, facts = [], {}
    data = bench_binned(device, n)
    for level in (0, 2, 4, 5):
        inp = forest_level_inputs(device, n, lanes, level, data=data)
        args = (tk, inp["B"], inp["row_node"], inp["stats"], inp["offset"],
                inp["P"])
        facts[f"level_{level}"] = hist_case(*args, node_mask=inp["mask"],
                                            reps=reps)
        rows.append(_kernel_row("tree_hist", facts[f"level_{level}"]))
        if level == 5:
            facts["level_5_all_features"] = hist_case(*args, reps=reps)
            rows.append(_kernel_row("tree_hist",
                                    facts["level_5_all_features"]))
        del inp, args
        torch.cuda.empty_cache()
    return rows, facts


def gbt_level_inputs(device, n: int, lanes: int, level: int, seed: int = 9,
                     data=None) -> dict:
    """Inputs of one GBT level for ``lanes`` lanes (3 folds x lanes/3 grid
    points, as the default grid's depth-12 GBT group batches them): xgb
    statistics (w, w·g, w·h) of fold weights and random margins, every
    feature, and rows as a deep level of a fitted tree holds them: three
    quarters of each lane's rows in ``GBT_HEAVY_NODES`` of its nodes drawn
    at random (at levels of 4·``GBT_HEAVY_NODES`` nodes or more), the rest
    spread over the level's P = 2^level nodes with a fifth of its width
    (at least one node) parked at leaves above.  So the groups of the heavy
    nodes hold more rows than one block takes, and ``tree_hist_deep``
    splits them over several blocks (``hist_deep_split``: R > 1, the
    window's cells zeroed and added into with atomics), as in the default
    grid's GBT fit."""
    import torch
    y, _, B = data if data is not None else bench_binned(device, n)
    rng = np.random.default_rng(seed)
    margin = rng.normal(scale=0.5, size=(lanes, n)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-margin))
    w = np.repeat(_fold_weights(y), -(-lanes // N_FOLDS), axis=0)[:lanes]
    stats = (np.stack([np.ones_like(p), p - y[None],
                       np.maximum(p * (1 - p), 1e-6)], axis=2)
             * w[:, :, None]).astype(np.float32)
    off, P = (1 << level) - 1, 1 << level
    row_node = rng.integers(max(0, off - max(1, P // 5)), off + P,
                            size=(lanes, n))
    if P >= 4 * GBT_HEAVY_NODES:
        heavy = off + np.stack([rng.choice(P, GBT_HEAVY_NODES, replace=False)
                                for _ in range(lanes)])
        pick = rng.integers(0, GBT_HEAVY_NODES, size=(lanes, n))
        row_node = np.where(rng.random((lanes, n)) < 0.75,
                            np.take_along_axis(heavy, pick, axis=1), row_node)
    return {"B": B, "stats": torch.as_tensor(stats, device=device),
            "row_node": torch.as_tensor(row_node.astype(np.int32),
                                        device=device),
            "offset": off, "P": P, "mask": None}


GBT_HEAVY_NODES = 8                # nodes that hold most of a deep GBT level
DEEP_FOREST_LANES = 150            # the depth-12 forests' lane batch (4 levels)
DEEP_WIDE_LANES = 300              # the widest forest batch, at level 11
DEEP_GBT_LANES = (6, 12)           # the depth-12 GBT and GBT regressor groups


def check_deep_hist_levels(device="cuda", n: int = N_ROWS,
                           reps: int = 3) -> tuple:
    """``tree_hist_deep`` at the deep levels the default grid launches it
    (``count_hist_shapes``): a forest batch of ``DEEP_FOREST_LANES`` lanes
    at levels 8-11 (P = 256 .. 2048) with the nodes' 5-of-28 subsets, 300
    lanes at level 11, and the GBT's 6 and 12 lanes at level 11 with every
    feature and most rows in a few nodes (split over several blocks: R >
    1) — each held to its f64 twin (counts equal, GBT cells within
    1e-5 of their mass) and timed beside its bound, the twin and
    ``index_put_`` (``hist_case``).  Returns the rows of the kernels line
    and their numbers."""
    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rows, facts = [], {}
    data = bench_binned(device, n)
    cases = ([("forest", DEEP_FOREST_LANES, lvl) for lvl in (8, 9, 10, 11)]
             + [("forest", DEEP_WIDE_LANES, DEEP - 1)]
             + [("gbt", k, DEEP - 1) for k in DEEP_GBT_LANES])
    for kind, lanes, level in cases:
        make = forest_level_inputs if kind == "forest" else gbt_level_inputs
        inp = make(device, n, lanes, level, data=data)
        fixed = tk.hist_scale(inp["stats"]).fixed
        plan = tk.hist_plan(n, inp["B"].shape[1], lanes, inp["P"], N_BINS, 3,
                            True, 5 if kind == "forest" else None,
                            8 if fixed else 4)
        if plan["route"] != "deep":
            raise AssertionError(f"{kind} level {level} did not plan the "
                                 "deep route")
        # R, the blocks that share a node group's rows, as the wrapper
        # chooses it from the partition: the GBT cases take R > 1
        at = inp["row_node"].long() - inp["offset"]
        live = (at >= 0) & (at < inp["P"]) & (inp["stats"] != 0).any(dim=2)
        group = (at // plan["Pg"]
                 + torch.arange(lanes, device=device)[:, None] * plan["NG"])
        R = tk.hist_deep_split(plan, int(torch.bincount(group[live]).max()),
                               int(live.sum()))
        del at, live, group
        if kind == "gbt" and R < 2:
            raise AssertionError(f"gbt {lanes} lanes, level {level}: R = 1, "
                                 "the split route went untested")
        key = f"{kind}_{lanes}_lanes_level_{level}"
        facts[key] = hist_case(tk, inp["B"], inp["row_node"], inp["stats"],
                               inp["offset"], inp["P"], inp["mask"], reps)
        facts[key]["plan"] = {k: plan[k] for k in (
            "Pg", "NG", "NC", "Wc", "blocks")}
        facts[key]["plan"]["R"] = R
        if fixed:
            facts[key]["fixed_point"] = fixed_point_case(
                tk, inp["B"], inp["row_node"], inp["stats"], inp["offset"],
                inp["P"], inp["mask"])
        rows.append(_kernel_row("tree_hist_deep", facts[key]))
        del inp
        torch.cuda.empty_cache()
    return rows, facts


ROUTE_FOREST_LANES = (150, 300)    # the forests' lane batches at depth 12
ROUTE_FOREST_LEVELS = (5, 11)
ROUTE_GBT_LEVELS = (2, DEEP - 1)   # a depth-3 GBT's last split level, 11


def check_route_split_levels(device="cuda", n: int = N_ROWS,
                             reps: int = 5) -> tuple:
    """``tree_route`` and ``tree_split`` at the shapes the default grid
    launches them, each against its twin and timed by CUDA events and the
    profiler (``route_case``, ``split_case``).  The route at forest batches
    of 150 and 300 lanes at levels 5 and 11 (rows spread over the level, a
    fifth of its width parked at leaves above) and at the GBT's 6 and 12
    lanes at level 2 and level 11 (three quarters of each lane's rows in
    ``GBT_HEAVY_NODES`` nodes, ``gbt_level_inputs``), each node's split
    drawn at random (a seventh of them leaves).  The split on the GBT's
    histograms of level 2 (6 lanes, P = 4) and level 11 (6 and 12 lanes,
    the skewed rows), with the grid's min_instances 10 and 100 and
    min_info_gain 0.001 .. 0.1.  Returns the rows of the kernels line and
    their numbers."""
    import itertools

    import torch

    from transmogrifai_tpu_torch.models import tree_kernels as tk
    rows, facts = [], {}
    data = bench_binned(device, n)
    y, sp_t, B = data
    D = B.shape[1]
    gen = torch.Generator(device=device).manual_seed(15)

    def decisions(lanes, P):
        return (torch.randint(0, D, (lanes, P), generator=gen, device=device,
                              dtype=torch.int32),
                torch.randint(0, N_BINS - 1, (lanes, P), generator=gen,
                              device=device, dtype=torch.int32),
                torch.rand((lanes, P), generator=gen, device=device) < 1 / 7)

    cases = ([("forest", k, lvl) for k in ROUTE_FOREST_LANES
              for lvl in ROUTE_FOREST_LEVELS]
             + [("gbt", k, lvl) for k in DEEP_GBT_LANES
                for lvl in ROUTE_GBT_LEVELS])
    for kind, lanes, level in cases:
        off, P = (1 << level) - 1, 1 << level
        if kind == "forest":
            row_node = torch.randint(max(0, off - max(1, P // 5)), off + P,
                                     (lanes, n), generator=gen,
                                     device=device, dtype=torch.int32)
        else:
            row_node = gbt_level_inputs(device, n, lanes, level,
                                        data=data)["row_node"]
        key = f"route_{kind}_{lanes}_lanes_level_{level}"
        facts[key] = route_case(tk, B, row_node, *decisions(lanes, P), off,
                                reps)
        rows.append(_kernel_row("tree_route", facts[key]))
        del row_node
        torch.cuda.empty_cache()
    points = list(itertools.product((10.0, 100.0), (0.001, 0.01, 0.1)))
    fmask = torch.ones(D, dtype=torch.bool, device=device)
    for lanes, level in ((6, 2), (6, DEEP - 1), (12, DEEP - 1)):
        inp = gbt_level_inputs(device, n, lanes, level, data=data)
        h, t = tk.tree_hist(B, inp["row_node"], inp["stats"], inp["offset"],
                            inp["P"], N_BINS)
        mi, mg, lam = (torch.tensor(v, dtype=torch.float32, device=device)
                       for v in zip(*((points[k % 6][0], points[k % 6][1],
                                       1.0) for k in range(lanes))))
        key = f"split_gbt_{lanes}_lanes_level_{level}"
        facts[key] = split_case(tk, h, t, fmask, sp_t, mi, mg, lam, reps)
        rows.append(_kernel_row("tree_split", facts[key]))
        del inp, h, t
        torch.cuda.empty_cache()
    return rows, facts


def count_hist_shapes(run) -> tuple:
    """``run()`` with every ``tree_hist`` call of the tree fits tallied by
    shape: lanes K (a GBT grid's 3 or 6, a forest batch's hundreds), nodes
    P, histogram or totals only, node subsets or not, and the route
    (``hist_plan``'s deep or shared; the route does not depend on the
    subsets) — beside the launch counters.  Returns (run's result, the
    tally)."""
    from transmogrifai_tpu_torch.models import tree_kernels as tk
    from transmogrifai_tpu_torch.models import trees as pt
    tally = {}
    real = pt.tree_hist

    def counted(B, row_node, stats, offset, P, n_bins, with_hist=True,
                node_mask=None, scale=None):
        plan = tk.hist_plan(B.shape[0], B.shape[1], row_node.shape[0], P,
                            n_bins, stats.shape[2], with_hist, None,
                            8 if scale is not None and scale.fixed else 4)
        key = (f"K={row_node.shape[0]} P={P} "
               f"{'hist' if with_hist else 'totals'}"
               f"{' subsets' if node_mask is not None else ''} "
               f"{plan['route']}")
        tally[key] = tally.get(key, 0) + 1
        return real(B, row_node, stats, offset, P, n_bins, with_hist,
                    node_mask, scale)

    pt.tree_hist = counted
    try:
        return run(), tally
    finally:
        pt.tree_hist = real


# --------------------------------------------------------------------------
# phase 13: queue 3's repairs and the redesigned LOCO walk
# --------------------------------------------------------------------------

WIDE_HASHES = (60_000, 100_003)    # past one row's shared-memory tile
WIDE_HASH_ROWS = 3_000
WIDE_MLP = (2048,)                 # a layer past one warp's shared slots
LOCO_TREE_D = 100                  # columns of the loco_tree shape checks


def check_wide_hashes(device="cuda", reps: int = 10) -> dict:
    """``hash_counts`` at 60,000 and 100,003 hashes (unpacked ids, a few
    thousand rows of up to 40 tokens, sentinels inside rows) written at a
    column offset with the null column: the twin's counts exactly, and
    timed (CUDA events and the profiler's device ms) beside the bytes'
    bound, the twin and one ``index_put_(accumulate=True)`` of the same
    counts into a zeroed [N, H] block."""
    import torch

    from transmogrifai_tpu_torch.ops import text_kernels as tk
    rng = np.random.default_rng(16)
    out = {}
    for H in WIDE_HASHES:
        n = WIDE_HASH_ROWS
        lens = rng.integers(0, 40, size=n)
        flat = rng.integers(0, H, size=int(lens.sum())).astype(np.int32)
        flat[::89] = H
        ids = torch.as_tensor(flat, device=device)
        off = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                              dtype=torch.int64, device=device)
        null = torch.as_tensor(lens == 0, device=device)
        got = torch.full((n, H + 3), -1.0, device=device)
        want = torch.full((n, H + 3), -1.0, device=device)
        tk.hash_counts(ids, off, null, H, out=got, col0=2, packed=False)
        tk.hash_counts_twin(ids, off, null, H, want, 2, False)
        if not torch.equal(got, want):
            raise AssertionError(f"hash_counts at {H} hashes: not the twin's "
                                 "counts")
        bt, by = bound(4 * n * (H + 1) + 4 * flat.size + 8 * (n + 1) + n, 0)
        keep = torch.as_tensor(flat < H, device=device)
        rows = torch.repeat_interleave(
            torch.arange(n, device=device),
            torch.as_tensor(lens, device=device))[keep]
        cols = ids.long()[keep]
        lib = torch.zeros((n, H), device=device)
        one = torch.ones((), device=device)

        def run():
            return tk.hash_counts(ids, off, null, H, out=got, col0=2,
                                  packed=False)

        out[f"hashes_{H}"] = {
            "rows": n, "plan": tk.hash_plan(H), "max_abs_err": 0.0,
            "ms": time_ms(run, reps),
            "device_ms": kernel_device_ms(run, reps,
                                          "hash_counts_kernel")["ms"],
            "plain_ms": time_ms(lambda: tk.hash_counts_twin(
                ids, off, null, H, want, 2, False), 3),
            "bound_ms": bt, "bound_by": by,
            "library_ms": time_ms(lambda: lib.index_put_(
                (rows, cols), one, accumulate=True), 3)}
        del got, want, lib
    return out


def check_wide_mlp_loco(device="cuda") -> dict:
    """``loco_softmax`` on an MLP of ``hidden_layers=(2048,)`` with 4
    classes (random weights from a seed) at 1,000 x 16 rows, one group a
    column, top-5: the warps' slots in the device-memory scratch, held to
    the twin (``_loco_case``)."""
    import torch

    from transmogrifai_tpu_torch import insights_kernels as ik
    from transmogrifai_tpu_torch.models.linear import MLPClassificationModel
    rng = np.random.default_rng(16)
    N, D, C, k = 1_000, 16, 4, 5
    X = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=device)
    sizes = [D, *WIDE_MLP, C]
    fitted = {"kind": "mlp", "n_layers": len(sizes) - 1, "n_classes": C}
    for i in range(len(sizes) - 1):
        fitted[f"W{i}"] = torch.as_tensor(rng.normal(
            scale=(2.0 / sizes[i]) ** 0.5, size=(sizes[i], sizes[i + 1]))
            .astype(np.float32), device=device)
        fitted[f"b{i}"] = torch.as_tensor(rng.normal(
            scale=0.1, size=sizes[i + 1]).astype(np.float32), device=device)
    model = MLPClassificationModel(fitted=fitted)
    cg = torch.arange(D, dtype=torch.int32, device=device)
    plan = ik.loco_softmax_plan(N, D, D, k, WIDE_MLP[0], C, tuple(sizes[2:]))
    if not plan.scratch_floats:
        raise AssertionError("loco_softmax (2048,): slots not in the "
                             "device-memory scratch")
    H = WIDE_MLP[0]
    case = _loco_case(
        lambda: ik.loco_softmax(X, model, cg, D, k),
        lambda kk: ik.loco_topk_twin(X, lambda Z: ik.loco_score(model, Z),
                                     cg, D, kk, "abs"), D, k, "abs", 5,
        4 * N * D, 2 * N * (D * H + (D + 1) * (H * C + H)),
        _softmax_library(X, model, cg, D, k))
    return {**case, "hidden_layers": list(WIDE_MLP), "rows": N,
            "plan": plan._asdict()}


def check_loco_tree_shapes(device="cuda", n: int = 200_000) -> dict:
    """``loco_tree`` against its twin (``check_loco_tree``) beyond the
    default grid's shapes: for each link (GBT and forest, classifier and
    regressor, 8 trees of depth 6 fitted on ``n`` x ``LOCO_TREE_D`` rows),
    one group of every column (G = 1), 28 groups scattered over the
    columns (top-20, "positive"), one group a column (G = 100: two windows
    of groups) at top-40 (past 32: the list in the output) and at top-5
    ("negative")."""
    import torch

    from transmogrifai_tpu_torch.models import trees as pt
    rng = np.random.default_rng(16)
    D = LOCO_TREE_D
    Xh = rng.normal(size=(n, D)).astype(np.float32)
    yh = (Xh[:, 0] + Xh[:, 1] * Xh[:, 2] + Xh[:, D - 1]
          + rng.normal(size=n)).astype(np.float32)
    X = torch.as_tensor(Xh, device=device)
    maps = {1: np.zeros(D, np.int32),
            28: rng.permutation(np.arange(D) % 28).astype(np.int32),
            D: np.arange(D, dtype=np.int32)}
    out = {}
    for link, est in (
            ("gbt", pt.OpGBTClassifier(max_iter=8, max_depth=6)),
            ("forest", pt.OpRandomForestClassifier(num_trees=8, max_depth=6)),
            ("gbt_regression", pt.OpGBTRegressor(max_iter=8, max_depth=6)),
            ("forest_regression", pt.OpRandomForestRegressor(num_trees=8,
                                                             max_depth=6))):
        y = yh if link.endswith("regression") else (yh > 0).astype(
            np.float32)
        model = pt.TreeEnsembleModel(fitted=est.fit_arrays(X, y))
        for G, k, strategy in ((1, 1, "abs"), (28, 20, "positive"),
                               (D, 40, "abs"), (D, 5, "negative")):
            cg = torch.as_tensor(maps[G], device=device)
            r = check_loco_tree(X, model, cg, G, k, strategy, reps=2)
            out[f"{link}_G{G}_k{k}_{strategy}"] = {
                key: r[key] for key in ("max_abs_err", "max_abs_diff", "ms",
                                        "bound_ms")}
        del model
    return out


def check_binary_confusion_selector(device="cuda", n: int = N_ROWS) -> dict:
    """The binary selector ranked by F1: the default LR grid
    (``BinaryClassificationModelSelector``'s own LR candidates) on the
    bench set's 1M x 28 rows, 3-fold CV with racing; the CV panel counts
    each candidate's ``margin > 0`` prediction.  Returns the winner, its
    parameters, every candidate's CV F1, the train wall and AuROC."""
    import torch

    from transmogrifai_tpu_torch import selector as S
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow
    X, y = make_data(n)
    D = X.shape[1]
    label = FeatureBuilder.RealNN("label").as_response()
    feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor() for i in range(D)]
    checked = label.sanity_check(transmogrify(feats), remove_bad_features=True)
    sel = S.BinaryClassificationModelSelector(
        models=[S._lr_candidates()],
        validation_metric=Evaluators.BinaryClassification.f1())
    sel.set_input(label, checked)
    pred = sel.get_output()
    cols = {"label": Column(RealNN, y)}
    for i in range(D):
        cols[f"f{i}"] = Column(RealNN, X[:, i])
    batch = ColumnBatch(cols, n)
    wf = Workflow(device=device).set_input_batch(batch).set_result_features(
        pred)
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summ = model.selected_model.summary
    cv = [(r.params, float(r.metric_values["F1"]), r.raced_out)
          for r in summ.validation_results]
    if not all(np.isfinite(v) and 0.0 < v <= 1.0 for _, v, _ in cv):
        raise AssertionError(f"F1-ranked selector: CV F1s {cv}")
    auroc = float(model.evaluate(Evaluators.BinaryClassification.auROC(),
                                 batch=batch)["AuROC"])
    if auroc <= 0.7:
        raise AssertionError(f"F1-ranked selector: train AuROC {auroc}")
    kept = [(p_, v) for p_, v, raced in cv if not raced]
    top = max(v for _, v in kept)
    return {"rows": n, "winner": summ.best_model_name,
            "winner_params": next(p_ for p_, v in kept if v == top),
            "cv_f1": cv, "train_wall_s": wall, "train_auroc": auroc}



# --------------------------------------------------------------------------
# phase 14: save, load and score
# --------------------------------------------------------------------------

BUNDLE_SCORE_SEED = 12             # the default grid's fresh batch
BUNDLE_RECORDS = 200               # records local.score_function times
BUNDLE_LATENCY_ROWS = (1, 64, 4096)   # ScoreProgram's small batches
BUNDLE_LATENCY_REPS = 20
BUNDLE_TOL = 1e-6                  # a record's scores against the batch's


def _prediction(model, scored) -> dict:
    (name,) = [f.name for f in model.result_features]
    return dict(scored[name].values)


def _require_bits(got: dict, want: dict, what: str) -> None:
    import torch
    if sorted(got) != sorted(want) or not all(
            torch.equal(got[k], want[k]) for k in want):
        raise AssertionError(f"{what}: not the in-memory model's bits")


def _timed(fn, device):
    """(result, wall s, peak device GB during the call, GB live before)."""
    import torch
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else float("nan"))
    return out, wall, peak, (base if device == "cuda" else float("nan"))


def _uncached(batch):
    """``batch``'s columns as new ``Column`` instances over the same arrays.
    The host text profiles (token ids included) and map expansions are
    cached on the instances, so a score of this copy tokenizes, hashes and
    uploads afresh, as a score of a new batch does."""
    import dataclasses
    return batch.with_columns({k: dataclasses.replace(c)
                               for k, c in batch.items()})


def save_load_score(name: str, model, fresh, needs=(), device="cuda",
                    keep=None):
    """Phase 14 on one model: save its bundle, load it on ``device``, and
    score ``fresh`` through the reloaded model's ``ScoreProgram`` and
    through the eager ``apply_dag``, each required to give the in-memory
    model's bits.  Each path scores its own uncached copy of the columns
    twice: cold (host text profiles and map expansions made afresh, the
    cost of a new batch) and then warm (those read from the copy).  The
    kernels' launches are read around the cold ``ScoreProgram`` score
    alone.  ``needs``: kernels that score must launch.  With ``keep`` the
    bundle is saved to ``keep/name`` and left there (phase 15 serves it).
    Returns (facts, launches, the reloaded model)."""
    import shutil
    import tempfile

    from transmogrifai_tpu_torch.dag import apply_dag
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.workflow import WorkflowModel

    n = len(fresh)
    want = _prediction(model, model.score(fresh))
    tmp = keep or tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    try:
        path = os.path.join(tmp, name)
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        loaded, load_s, _, _ = _timed(
            lambda: WorkflowModel.load(path, device=device), device)
    finally:
        if keep is None:
            shutil.rmtree(tmp, ignore_errors=True)
    if loaded.device.type != device:
        raise AssertionError(f"{name}: loaded on {loaded.device}")

    def program(batch):
        return _prediction(loaded, loaded.score(batch))

    def eager(batch):
        return _prediction(loaded, apply_dag(batch.on(device),
                                             loaded.fitted_dag))

    facts = {"rows": n,
             "winner": type(loaded.selected_model.best_model).__name__,
             "save_s": save_s, "bundle_bytes": nbytes, "load_s": load_s}
    launches = None
    for label, fn in (("score_program", program), ("apply_dag", eager)):
        batch = _uncached(fresh)
        for temp in ("cold", "warm"):
            if launches is None:
                kernels.reset_launch_counts()
            got, wall, peak, base = _timed(lambda: fn(batch), device)
            if launches is None:
                launches = kernels.launch_counts()
            _require_bits(got, want, f"{name}: {label} ({temp}) of the "
                          "reloaded model")
            del got
            facts[f"{label}_{temp}_s"] = wall
            facts[f"{label}_{temp}_rows_per_s"] = n / wall
            facts[f"{label}_{temp}_peak_gb"] = peak
            facts.setdefault("live_gb_before", base)
        del batch
    missing = [k for k in needs if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: the reloaded model's score never "
                             f"launched {missing}")
    facts.update(bits="equal",
                 launches={k: v for k, v in launches.items() if v})
    return facts, launches, loaded


def _records(batch, n: int) -> list:
    """The first ``n`` rows of a numeric raw batch as record dicts."""
    out = [{} for _ in range(n)]
    for col_name, col in batch.items():
        vals = np.asarray(col.values[:n])
        for i in range(n):
            out[i][col_name] = float(vals[i])
    return out


def bundle_latencies(loaded, fresh, device="cuda") -> dict:
    """Per-record ``local.score_function`` latency (median ms over
    BUNDLE_RECORDS records, each held to the batch score's row) and
    ``ScoreProgram`` latency at BUNDLE_LATENCY_ROWS rows (median ms of
    BUNDLE_LATENCY_REPS calls, the device synchronised after each)."""
    import torch

    from transmogrifai_tpu_torch import local

    (name,) = [f.name for f in loaded.result_features]
    want = {k: v[:BUNDLE_RECORDS].cpu().numpy()
            for k, v in _prediction(loaded, loaded.score(
                fresh.take_rows(np.arange(BUNDLE_RECORDS)))).items()}
    score = local.score_function(loaded)
    recs = _records(fresh, BUNDLE_RECORDS)
    for r in recs[:3]:                    # warm-up
        score(r)
    per_record, worst = [], 0.0
    for i, r in enumerate(recs):
        t0 = time.perf_counter()
        out = score(r)[name]
        per_record.append((time.perf_counter() - t0) * 1e3)
        if out["prediction"] != float(want["prediction"][i]):
            raise AssertionError(f"record {i}: prediction "
                                 f"{out['prediction']} against the batch's "
                                 f"{want['prediction'][i]}")
        for base in ("probability", "rawPrediction"):
            if base in want:
                row = np.float32([out[f"{base}_{j}"]
                                  for j in range(want[base].shape[1])])
                worst = max(worst, float(np.abs(row - want[base][i]).max()))
    if worst > BUNDLE_TOL:
        raise AssertionError(f"local scores {worst} from the batch's")
    facts = {"local_records": BUNDLE_RECORDS,
             "local_ms_per_record_median": float(np.median(per_record)),
             "local_ms_per_record_p90": float(np.percentile(per_record, 90)),
             "local_max_abs_err": worst, "score_program_ms": {}}
    for rows in BUNDLE_LATENCY_ROWS:
        sub = fresh.take_rows(np.arange(rows) % len(fresh))
        times = []
        for rep in range(BUNDLE_LATENCY_REPS + 2):
            t0 = time.perf_counter()
            p = _prediction(loaded, loaded.score(sub))["prediction"]
            if device == "cuda":
                torch.cuda.synchronize()
            if rep >= 2:                  # two warm-up calls
                times.append((time.perf_counter() - t0) * 1e3)
            del p
        facts["score_program_ms"][str(rows)] = float(np.median(times))
    return facts


# --------------------------------------------------------------------------
# phase 15: serving
# --------------------------------------------------------------------------

SERVE_CLIENTS, SERVE_REQUESTS = 16, 200     # one-record JSON requests
SERVE_RELOAD_CLIENTS, SERVE_RELOAD_REQUESTS = 8, 50
SERVE_COLUMNAR_ROWS, SERVE_COLUMNAR_REQUESTS = 1024, 16
SERVE_SPARSE_ROWS = 64
SERVE_ROWS = (SERVE_CLIENTS * SERVE_REQUESTS
              + SERVE_RELOAD_CLIENTS * SERVE_RELOAD_REQUESTS
              + SERVE_COLUMNAR_ROWS * SERVE_COLUMNAR_REQUESTS)
SERVE_TOL = 1e-6                   # a served probability against the model's
SERVE_BAD_EVENTS = ("degraded", "fallback", "dead_letter")
SERVE_FRESH_REQUESTS, SERVE_FRESH_COLUMNAR = 25, 4   # the fresh process's
SERVE_FRESH_TIMEOUT_S = 300


def _conn(port: int):
    import http.client
    return http.client.HTTPConnection("127.0.0.1", port, timeout=120)


def _call(conn, method: str, path: str, body=None,
          ctype: str = "application/json"):
    """(status, body bytes, headers) of one request on a kept-alive
    connection."""
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if body is not None else {})
    r = conn.getresponse()
    return r.status, r.read(), dict(r.getheaders())


def _host_scores(model, batch) -> dict:
    return {k: v.cpu().numpy() for k, v in
            _prediction(model, model.score(batch)).items()}


def _check_json_row(res: dict, ref: dict, i: int, what: str) -> float:
    """A JSON result row against row ``i`` of the model's scores: the
    prediction equal, the probabilities within SERVE_TOL; returns the
    largest probability gap."""
    if res["prediction"] != float(ref["prediction"][i]):
        raise AssertionError(f"{what}: row {i} prediction {res['prediction']}"
                             f" against the model's {ref['prediction'][i]}")
    gap = max(abs(res[f"probability_{j}"] - float(ref["probability"][i, j]))
              for j in range(ref["probability"].shape[1]))
    if gap > SERVE_TOL:
        raise AssertionError(f"{what}: row {i} probability {gap} off")
    return gap


def _check_arrays(arrays: dict, pred: str, ref: dict, what: str) -> float:
    """Decoded columnar result arrays against the model's scores."""
    got = np.asarray(arrays[f"{pred}.prediction"][0])
    if not np.array_equal(got, ref["prediction"].astype(np.float64)):
        raise AssertionError(f"{what}: predictions differ from the model's")
    gap = max(float(np.abs(np.asarray(arrays[f"{pred}.probability_{j}"][0])
                           - ref["probability"][:, j]).max())
              for j in range(ref["probability"].shape[1]))
    if gap > SERVE_TOL:
        raise AssertionError(f"{what}: probabilities {gap} off")
    return gap


def wire_body(batch, lo: int, hi: int) -> bytes:
    """Rows [lo, hi) of a raw host batch in the columnar wire format: text
    as utf8, numerics as f32 / i64 / bool with their presence masks.  Maps
    and lists have no columnar v1 encoding and are left out (the server
    reads them as absent in every row)."""
    from transmogrifai_tpu_torch.serving import wire
    from transmogrifai_tpu_torch.types import (Binary, Date, Integral,
                                               is_numeric_kind, is_text_kind)
    cols = []
    for name, col in batch.items():
        k = col.kind
        if is_text_kind(k):
            vals = list(col.values[lo:hi])
            cols.append((name, wire.UTF8, vals,
                         np.array([v is not None for v in vals])))
        elif is_numeric_kind(k) and not col.is_host_object():
            code = (wire.BOOL if issubclass(k, Binary) else wire.I64
                    if issubclass(k, (Integral, Date)) else wire.F32)
            mask = None if col.mask is None else np.asarray(col.mask[lo:hi])
            cols.append((name, code, np.asarray(col.values[lo:hi]), mask))
    return wire.encode_arrays(cols, hi - lo)


def _json_traffic(port: int, records: list, clients: int, per_client: int,
                  midway=None):
    """``clients`` threads, each posting ``per_client`` one-record JSON
    requests on its own connection; ``midway()`` runs once half of them
    have answered.  Returns (replies, latencies in s, wall s)."""
    import threading
    n = clients * per_client
    replies, lat, errors = [None] * n, [0.0] * n, []
    done = [0]
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(c):
        conn = _conn(port)
        start.wait()
        try:
            for j in range(per_client):
                i = c * per_client + j
                t0 = time.perf_counter()
                status, body, _ = _call(conn, "POST", "/v1/score",
                                        json.dumps(records[i]).encode())
                lat[i] = time.perf_counter() - t0
                if status != 200:
                    errors.append((i, status, body[:200]))
                replies[i] = json.loads(body)
                with lock:
                    done[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((None, type(e).__name__, str(e)))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    if midway is not None:
        while done[0] < n // 2 and not errors:
            time.sleep(0.001)
        midway()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{len(errors)} failed requests, e.g. "
                             f"{errors[:3]}")
    return replies, lat, wall


def _latency_facts(lat: list, wall: float, n: int, unit: str) -> dict:
    ms = np.asarray(lat) * 1e3
    return {"requests": len(lat), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "wall_s": wall,
            f"{unit}_per_s": n / wall}


def _batch_ms(engine) -> dict:
    """The engine's batch latency (p50 / p99 ms; the histogram's
    interpolated quantiles): the time from a batch's dispatch to its
    results on the host, queue and HTTP excluded."""
    snap = engine.batch_latency.snapshot()
    return {"count": snap["count"], "p50": snap["p50"] * 1e3,
            "p99": snap["p99"] * 1e3}


def _metric(text: str, name: str) -> float:
    full = f"transmogrifai_serving_{name} "
    return float(next(ln for ln in text.splitlines()
                      if ln.startswith(full)).split()[1])


def _serve(root: str, max_batch: int, device: str):
    """(server, thread, warm-up s) of the port's server on ``root``; its
    queue admits four batches (at least the default 256 rows)."""
    from transmogrifai_tpu_torch.serving import start_server
    t0 = time.perf_counter()
    srv, th = start_server(root, port=0, max_batch=max_batch,
                           queue_bound=max(256, 4 * max_batch),
                           device=device)
    return srv, th, time.perf_counter() - t0


def _shed_429(srv) -> dict:
    """Two requests in flight behind the held device lock with
    ``queue_bound=2``, then a third: it must get 429 + Retry-After."""
    import threading
    eng = srv.engine
    old, eng.queue_bound = eng.queue_bound, 2
    codes = []

    def post(payload):
        conn = _conn(srv.port)
        try:
            codes.append(_call(conn, "POST", "/v1/score",
                               json.dumps(payload).encode())[0])
        finally:
            conn.close()
    try:
        with eng._score_lock:
            t1 = threading.Thread(target=post, args=({},))
            t1.start()
            time.sleep(0.2)               # the batcher holds it, waiting
            t2 = threading.Thread(target=post, args=([{}, {}],))
            t2.start()
            deadline = time.monotonic() + 30
            while eng.queue_depth != 2 and time.monotonic() < deadline:
                time.sleep(0.002)
            conn = _conn(srv.port)
            status, body, headers = _call(conn, "POST", "/v1/score", b"{}")
            conn.close()
        t1.join(timeout=60)
        t2.join(timeout=60)
    finally:
        eng.queue_bound = old
    if status != 429 or "Retry-After" not in headers:
        raise AssertionError(f"shed: {status} {headers} (want 429 with "
                             "Retry-After)")
    if sorted(codes) != [200, 200]:
        raise AssertionError(f"the two held requests answered {codes}")
    return {"status": status, "retry_after": headers["Retry-After"],
            "held": sorted(codes)}


def _quality_replies(srv, record: dict, field: str, body: bytes) -> dict:
    """422 with the JAX package's violation kinds for a NaN and for a
    string in the numeric ``field``, 400 for a malformed columnar body,
    then 429 (``_shed_429``)."""
    from transmogrifai_tpu_torch.serving import wire
    conn = _conn(srv.port)
    out = {}
    try:
        for label, value, kinds in (
                ("nan", float("nan"), ["NonFiniteValue"]),
                ("string", "abc", ["TypeMismatch", "NonCoercibleValue"])):
            rec = dict(record)
            rec[field] = value
            status, reply, _ = _call(conn, "POST", "/v1/score",
                                     json.dumps(rec).encode())
            got = [v["kind"] for v in json.loads(reply).get("violations",
                                                            [])]
            if status != 422 or got != kinds:
                raise AssertionError(f"{label}: {status} {got}, want 422 "
                                     f"{kinds}")
            out[label] = {"status": status, "kinds": got}
        status, reply, _ = _call(conn, "POST", "/v1/score", body[:12],
                                 wire.CONTENT_TYPE)
        if status != 400 or json.loads(reply)["error"] != \
                "malformed columnar body":
            raise AssertionError(f"malformed columnar: {status} {reply!r}")
        out["malformed_columnar"] = {"status": status}
    finally:
        conn.close()
    out["overload"] = _shed_429(srv)
    return out


def _columnar_traffic(srv, batch, rows: int, requests: int, model,
                      pred: str, what: str):
    """``requests`` columnar requests of ``rows`` rows, one after another,
    each held to ``model``'s score of the body it sent; (facts, largest
    probability gap)."""
    from transmogrifai_tpu_torch.serving import wire
    conn = _conn(srv.port)
    lat, worst = [], 0.0
    versions = set()
    t0 = time.perf_counter()
    try:
        for r in range(requests):
            lo = (r * rows) % max(1, len(batch) - rows + 1)
            body = wire_body(batch, lo, lo + rows)
            t1 = time.perf_counter()
            status, reply, headers = _call(conn, "POST", "/v1/score", body,
                                           wire.CONTENT_TYPE)
            lat.append(time.perf_counter() - t1)
            if status != 200:
                raise AssertionError(f"{what}: columnar {status} "
                                     f"{reply[:200]!r}")
            versions.add(headers["X-Model-Version"])
            ref = _host_scores(model, wire.decode_batch(body,
                                                        model.raw_features))
            worst = max(worst, _check_arrays(wire.decode_response(reply),
                                             pred, ref, what))
    finally:
        conn.close()
    wall = time.perf_counter() - t0
    facts = _latency_facts(lat, wall, rows * requests, "rows")
    facts["versions"] = sorted(versions)
    return facts, worst


def sparse_pass_split(model, batch, device="cuda", reps: int = 5) -> dict:
    """One ``ScoreProgram`` pass of the sparse bundle over ``batch`` (a
    served request's rows, fresh columns each pass), with the combiner's
    flattened column metadata rebuilt before the pass (as every pass did
    before the combiner kept it) and kept: for each, the median wall ms of
    ``reps`` unprofiled passes, and one profiled pass's wall ms, device
    busy ms (the union of its kernels' intervals) and kernel count; the
    rest of the wall is the host's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transmogrifai_tpu_torch.ops.combiner import VectorsCombiner
    combiners = [s for s in model.stages if isinstance(s, VectorsCombiner)]
    out = {}
    for mode in ("metadata_rebuilt", "metadata_kept"):
        def one():
            if mode == "metadata_rebuilt":
                for c in combiners:
                    c._meta_cache = None
            t0 = time.perf_counter()
            model.score(_uncached(batch))       # the ScoreProgram pass
            if device == "cuda":
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        one()
        plain = float(np.median([one() for _ in range(reps)]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = one()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, -np.inf
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        out[mode] = {"ms": plain, "window_ms": wall,
                     "device_busy_ms": busy / 1e3,
                     "host_ms": wall - busy / 1e3,
                     "device_kernels": len(spans)}
    return out


# A fresh process serving a checkpoint root (argv[2]) with the repository on
# argv[1]: its first line is written once the warm-up is done, its second
# once a line comes on its standard input, then it drains and exits.
SERVE_FRESH_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from transmogrifai_tpu_torch.models import kernels
from transmogrifai_tpu_torch.serving import start_server
srv, th = start_server(sys.argv[2], port=0, max_batch=int(sys.argv[3]),
                       device=sys.argv[4])
eng = srv.engine
kernels.reset_launch_counts()
print(json.dumps({"port": srv.port, "device": str(eng.device),
                  "warmup_builds_total":
                      eng.stats()["counters"]["warmup_builds_total"]}),
      flush=True)
sys.stdin.readline()
s = eng.stats()
print(json.dumps({
    "launches": kernels.launch_counts(),
    "online_builds_total": s["counters"]["online_builds_total"],
    "fallback_batches_total": s["counters"].get("fallback_batches_total", 0),
    "compiled_path_active": s["compiled_path_active"],
    "bad_events": [[e.action, e.point, str(e.cause)]
                   for e in eng.failure_log.events
                   if e.action in ("degraded", "fallback", "dead_letter")]}),
      flush=True)
srv.drain_and_close()
th.join(timeout=10)
"""


def _fresh_process_serving(root: str, records: list, ref: dict, rows,
                           model, pred: str, device: str) -> dict:
    """Phase 15 step 8: the root served by a process that has loaded no
    library yet (``SERVE_FRESH_CHILD``), so its warm-up is what first loads
    ``tree_walk``'s library.  16 clients x SERVE_FRESH_REQUESTS JSON
    requests and SERVE_FRESH_COLUMNAR columnar requests of 64 rows, each
    held to ``model``'s scores; returns the child's facts (its warm-up and
    online builds, launches after warm-up, compiled path, bad events)."""
    import threading
    import types
    log = tempfile.NamedTemporaryFile("w+", suffix=".log", delete=False)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_FRESH_CHILD, ROOT, root, "64", device],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
        text=True)
    guard = threading.Timer(SERVE_FRESH_TIMEOUT_S, proc.kill)
    guard.start()
    try:
        up = proc.stdout.readline()
        if not up:
            log.seek(0)
            raise AssertionError("the fresh serving process died: "
                                 + log.read()[-3000:])
        facts = json.loads(up)
        facts["start_s"] = time.perf_counter() - t0
        n = SERVE_CLIENTS * SERVE_FRESH_REQUESTS
        replies, lat, wall = _json_traffic(facts["port"], records[:n],
                                           SERVE_CLIENTS,
                                           SERVE_FRESH_REQUESTS)
        worst = max(_check_json_row(r["result"][pred], ref, i, "fresh json")
                    for i, r in enumerate(replies))
        cfacts, cworst = _columnar_traffic(
            types.SimpleNamespace(port=facts["port"]), rows, 64,
            SERVE_FRESH_COLUMNAR, model, pred, "fresh columnar")
        facts["json"] = _latency_facts(lat, wall, n, "requests")
        facts["columnar_rows_per_s"] = cfacts["rows_per_s"]
        facts["max_abs_err"] = max(worst, cworst)
        proc.stdin.write("stop\n")
        proc.stdin.flush()
        done = proc.stdout.readline()
        if not done:
            log.seek(0)
            raise AssertionError("the fresh serving process died: "
                                 + log.read()[-3000:])
        facts.update(json.loads(done))
        facts["exit_code"] = proc.wait(timeout=60)
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
        os.unlink(log.name)
    return facts


def run_serving(cases: dict, device="cuda") -> tuple:
    """Phase 15: the port's server on phase 14's saved bundles.
    ``cases``: name → (bundle path, the reloaded model phase 14 held to
    the trained model's bits, raw host rows) for "default_grid",
    "transmog" and "sparse"; every served score is held to that model's
    score of the same rows.  Returns (facts, the served traffic's launches
    by kernel)."""
    import shutil

    import torch

    from transmogrifai_tpu_torch.checkpoint import next_version_dir
    from transmogrifai_tpu_torch.models import kernels

    bundle, model, rows = cases["default_grid"]
    (pred,) = [f.name for f in model.result_features]
    root = os.path.join(os.path.dirname(bundle), "serve_root")
    shutil.copytree(bundle, next_version_dir(root))
    ref = _host_scores(model, rows)
    records = _records(rows, SERVE_CLIENTS * SERVE_REQUESTS
                       + SERVE_RELOAD_CLIENTS * SERVE_RELOAD_REQUESTS)
    launches: dict = {}

    def add_launches():
        for k, v in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + v

    facts: dict = {}
    servers = []
    t_phase = time.perf_counter()
    try:
        # 1-2: 16 clients of one-record JSON requests, max_batch 64
        srv, th, warm_s = _serve(root, 64, device)
        servers.append((srv, th))
        eng = srv.engine
        facts["warmup_s"] = warm_s
        facts["ladder"] = eng.ladder
        facts["warmup_builds_total"] = \
            eng.stats()["counters"]["warmup_builds_total"]
        on_card = device == "cuda"    # the CPU twins count no launches
        if on_card:
            torch.cuda.synchronize()
            seg0 = torch.cuda.memory_stats()["segment.all.allocated"]
        n = SERVE_CLIENTS * SERVE_REQUESTS
        kernels.reset_launch_counts()
        replies, lat, wall = _json_traffic(srv.port, records, SERVE_CLIENTS,
                                           SERVE_REQUESTS)
        walk = kernels.launch_counts()["tree_walk"]
        add_launches()
        conn = _conn(srv.port)
        metrics = _call(conn, "GET", "/metrics")[1].decode()
        conn.close()
        batches = _metric(metrics, "batches_total")
        batch_rows = _metric(metrics, "batch_rows_total")
        versions = {f for f in os.listdir(root) if f.startswith("ckpt-")}
        worst = 0.0
        for i, r in enumerate(replies):
            if r["modelVersion"].split("@")[0] not in versions:
                raise AssertionError(f"reply {i} tagged {r['modelVersion']}")
            worst = max(worst, _check_json_row(r["result"][pred], ref, i,
                                               "json"))
        facts["json"] = {**_latency_facts(lat, wall, n, "requests"),
                         "clients": SERVE_CLIENTS, "batches": batches,
                         "batch_rows": batch_rows,
                         "mean_batch": batch_rows / max(batches, 1),
                         "batch_ms": _batch_ms(eng),
                         "tree_walk_launches": walk,
                         "max_abs_err": worst}
        if walk <= 0 and on_card:
            raise AssertionError("tree_walk never launched while serving")

        # 3: columnar requests of 1,024 rows on a second server
        srv2, th2, warm2 = _serve(root, SERVE_COLUMNAR_ROWS, device)
        servers.append((srv2, th2))
        kernels.reset_launch_counts()
        col_rows = rows.take_rows(np.arange(
            len(records), len(records)
            + SERVE_COLUMNAR_ROWS * SERVE_COLUMNAR_REQUESTS) % len(rows))
        cfacts, cworst = _columnar_traffic(
            srv2, col_rows, SERVE_COLUMNAR_ROWS, SERVE_COLUMNAR_REQUESTS,
            model, pred, "columnar")
        add_launches()
        facts["columnar"] = {**cfacts, "warmup_s": warm2,
                             "batch_ms": _batch_ms(srv2.engine),
                             "max_abs_err": cworst}
        if on_card:
            torch.cuda.synchronize()
            facts["allocator_segments_grown"] = (
                torch.cuda.memory_stats()["segment.all.allocated"] - seg0)

        # 5: version 2 saved and swapped in mid-traffic
        def swap():
            model.save(next_version_dir(root))
            if not eng.reload_now():
                raise AssertionError("reload_now swapped nothing")
        kernels.reset_launch_counts()
        replies, lat, wall = _json_traffic(
            srv.port, records[n:], SERVE_RELOAD_CLIENTS,
            SERVE_RELOAD_REQUESTS, midway=swap)
        add_launches()
        tags: dict = {}
        for i, r in enumerate(replies):
            tag = r["modelVersion"].split("@")[0]
            tags[tag] = tags.get(tag, 0) + 1
            _check_json_row(r["result"][pred], ref, n + i, "reload")
        if sorted(tags) != ["ckpt-000001", "ckpt-000002"]:
            raise AssertionError(f"reload: replies tagged {tags}")
        facts["reload"] = {**_latency_facts(lat, wall, len(replies),
                                            "requests"), "tagged": tags}

        # 6: the quality screen and overload
        facts["quality"] = _quality_replies(
            srv, records[0], "f0", wire_body(rows, 0, 4))

        # 7: the transmog and sparse bundles, one columnar request each
        for name, rows_n, need in (("transmog", SERVE_COLUMNAR_ROWS,
                                    "hash_counts"),
                                   ("sparse", SERVE_SPARSE_ROWS,
                                    "sp_matmat")):
            path, m, batch = cases[name]
            (p,) = [f.name for f in m.result_features]
            s3, t3, w3 = _serve(path, rows_n, device)
            servers.append((s3, t3))
            kernels.reset_launch_counts()
            f3, g3 = _columnar_traffic(s3, batch, rows_n, 1, m, p, name)
            got = kernels.launch_counts()[need]
            add_launches()
            if got <= 0 and on_card:
                raise AssertionError(f"{name}: {need} never launched while "
                                     "serving")
            facts[name] = {**f3, "warmup_s": w3, f"{need}_launches": got,
                           "max_abs_err": g3}
        facts["sparse"]["pass_split"] = sparse_pass_split(
            cases["sparse"][1], cases["sparse"][2], device)

        # 8: the default grid's root served by a fresh process, whose
        # warm-up must load tree_walk's library and whose traffic none
        fresh = _fresh_process_serving(root, records, ref, rows, model,
                                       pred, device)
        facts["fresh_process"] = fresh
        for k, v in fresh["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if on_card and fresh["warmup_builds_total"] < 1:
            raise AssertionError("the fresh process's warm-up loaded no "
                                 "library: the build count cannot see it")
        if on_card and fresh["launches"]["tree_walk"] <= 0:
            raise AssertionError("tree_walk never launched in the fresh "
                                 "serving process")
        if fresh["exit_code"] != 0:
            raise AssertionError(f"the fresh serving process exited "
                                 f"{fresh['exit_code']}")

        # 9: the gates
        stats = [s.engine.stats() for s, _ in servers]
        online = (sum(st["counters"]["online_builds_total"] for st in stats)
                  + fresh["online_builds_total"])
        bad = [(e.action, e.point, e.cause) for s, _ in servers
               for e in s.engine.failure_log.events
               if e.action in SERVE_BAD_EVENTS] + fresh["bad_events"]
        facts["online_builds_total"] = online
        facts["compiled_path_active"] = (
            all(st["compiled_path_active"] for st in stats)
            and fresh["compiled_path_active"])
        facts["bad_events"] = bad
        if online != 0:
            raise AssertionError(f"{online} kernel builds after warm-up")
        if not facts["compiled_path_active"] or bad \
                or fresh["fallback_batches_total"]:
            raise AssertionError(f"served around the compiled path: {bad}")
        facts["wall_s"] = time.perf_counter() - t_phase
    finally:
        for srv, th in servers:
            srv.drain_and_close()
            th.join(timeout=10)
    return facts, launches


# --------------------------------------------------------------------------
# phase 16: training control — resume, workflow CV, sanitizers, the screen
# --------------------------------------------------------------------------

SCREEN_FRACTIONS = (0.005, 0.2)    # quarantined and trained; past 0.1: raises
SCREEN_SEED = 16


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _validation(model) -> list:
    return [(r.model_name, r.params, r.metric_values, r.raced_out)
            for r in model.selected_model.summary.validation_results]


def _same_bits(a, b) -> bool:
    """Fitted state equal bit for bit (tensors and arrays by their bytes)."""
    import torch
    if isinstance(a, (torch.Tensor, np.ndarray)):
        if not isinstance(b, type(a)):
            return False
        ha = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        hb = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
        return (ha.dtype == hb.dtype and ha.shape == hb.shape
                and ha.tobytes() == hb.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_bits(x, z) for x, z in zip(a, b)))
    return a == b


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _flushes(*cps) -> list:
    return [{"seconds": f["seconds"], "npz_bytes": f["npzBytes"]}
            for cp in cps if cp is not None for f in cp.flushes]


def _held_validation(part: str, got: list, want: list) -> None:
    """``got``'s validation results against ``want``'s: the same candidates,
    params and racing marks and the same metric bits, every family — a
    family fit again too, since the tree histograms sum float statistics
    in fixed point (csrc/tree_hist.cuh), the same bits on every launch."""
    if [(a[0], a[1], a[3], sorted(a[2])) for a in got] != \
            [(b[0], b[1], b[3], sorted(b[2])) for b in want]:
        raise AssertionError(f"resume ({part}): other candidates than the "
                             "uninterrupted train's")
    for a, b in zip(got, want):
        if a[2] != b[2]:
            raise AssertionError(f"resume ({part}): {a[0]} {a[1]} "
                                 f"metrics {a[2]} != {b[2]}")


def run_resume(X, y, device="cuda") -> dict:
    """Phase 16's resume check on the bench set at ``X``'s full width,
    unraced so each family is checkpointed after round A: an uninterrupted
    train; a train preempted at the forest's boundary (one family in the
    sweep); a resume with LR's fit armed (LR must be replayed; the winner,
    the validation results, the train AuROC and the refit's arrays equal
    the uninterrupted train's, no "skipped" event); a resume of the sealed
    sweep with every family's fit armed (only the winner's refit runs, and
    the results are the resumed train's, bit for bit).  Every family must
    match bit for bit, replayed or fit again (GBT's float statistics sum in
    fixed point).  Returns the facts with each train's wall and
    launches."""
    from transmogrifai_tpu_torch.checkpoint import (SweepCheckpoint,
                                                    TrainingPreempted)
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.resilience import (FaultInjector,
                                                    inject_faults)
    root = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    atexit.register(shutil.rmtree, root, True)
    sweep = os.path.join(root, "sweep")
    ev = Evaluators.BinaryClassification.auROC()
    families = ("OpLogisticRegression", "OpRandomForestClassifier",
                "OpGBTClassifier")

    def train(resume_from=None, **fail_keys):
        wf, batch = build_workflow(X, y, device)
        wf.result_features[0].origin_stage.validator.racing = False
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        with inject_faults(FaultInjector(fail_keys=fail_keys)):
            model = wf.train(resume_from=resume_from)
        _sync(device)
        wall = time.perf_counter() - t0
        return model, batch, wall, _launch_delta(before,
                                                 kernels.launch_counts())

    full, batch, full_wall, full_l = train()
    full_auroc = float(full.evaluate(ev, batch=batch)["AuROC"])
    try:
        train(sweep, preemption=["OpRandomForestClassifier"])
        raise AssertionError("resume: no TrainingPreempted at the forest")
    except TrainingPreempted as e:
        pre = e
    if len(SweepCheckpoint(sweep)) != 1 or \
            not pre.failure_log.by_action("preempted"):
        raise AssertionError("resume: the preempted train did not leave "
                             "exactly one family and a 'preempted' event")
    res, _, res_wall, res_l = train(
        sweep, **{"selector.candidate_fit": ["OpLogisticRegression"]})
    sealed, _, sealed_wall, sealed_l = train(
        sweep, **{"selector.candidate_fit": list(families)})
    best = full.selected_model
    _held_validation("resumed", _validation(res), _validation(full))
    _held_validation("sealed", _validation(sealed), _validation(res))
    for name, m, n_resumed in (("resumed", res, 2), ("sealed", sealed, 4)):
        resumed = [e for e in m.failure_log if e.action == "resumed"]
        if len(resumed) != n_resumed or not any(
                e.stage == "OpLogisticRegression" for e in resumed):
            raise AssertionError(f"resume ({name}): resumed events "
                                 f"{[e.stage for e in resumed]}")
        if m.failure_log.by_action("skipped"):
            raise AssertionError(f"resume ({name}): a family was refit")
        sm = m.selected_model
        if sm.summary.best_model_name != best.summary.best_model_name or \
                not _same_bits(sm.best_model.fitted, best.best_model.fitted):
            raise AssertionError(f"resume ({name}): the winner or its refit "
                                 "arrays differ")
        if float(m.evaluate(ev, batch=batch)["AuROC"]) != full_auroc:
            raise AssertionError(f"resume ({name}): train AuROC differs")
    if set(sealed.selected_model.selector_seconds) != {"refit",
                                                       "train_evaluation"}:
        raise AssertionError("resume (sealed): the sweep ran a family")
    return {
        "winner": best.summary.best_model_name, "train_auroc": full_auroc,
        "full_train_wall_s": full_wall, "resumed_train_wall_s": res_wall,
        "sealed_refit_wall_s": sealed_wall,
        "gbt_refit_same_bits": True,
        "tree_hist_launches": {"full": full_l["tree_hist"],
                               "resumed": res_l["tree_hist"],
                               "sealed": sealed_l["tree_hist"]},
        "flushes": _flushes(pre.sweep_checkpoint, res.sweep_checkpoint,
                            sealed.sweep_checkpoint),
        "sweep_npz_bytes": os.path.getsize(os.path.join(sweep,
                                                        "sweep.npz")),
        "full_launches": {k: v for k, v in full_l.items() if v}}


REPEAT_FAMILIES = (("OpGBTClassifier", "binary", "_gbt_classifier"),
                   ("OpGBTRegressor", "regression", "_gbt_regressor"),
                   ("OpRandomForestRegressor", "regression",
                    "_rf_regressor"))


def run_repeat_fits(device="cuda", n: int = N_ROWS) -> dict:
    """Phase 16's repeat check of the fixed-point histograms: the default
    grid's ``OpGBTClassifier`` on the bench set and the regression default
    grid's ``OpGBTRegressor`` and ``OpRandomForestRegressor`` on the
    regression rows, each at ``n`` rows, trained twice as the only family
    of its selector (3-fold CV, the winner refit): the same candidates, CV
    metric bits, winner and refit tree arrays bit for bit.  Returns each
    family's two train walls and its ``tree_hist`` / ``tree_hist_deep``
    launches a train."""
    import torch

    from transmogrifai_tpu_torch import selector as S
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.synthetic import make_regression_data
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import Workflow

    data = {"binary": make_data(n),
            "regression": make_regression_data(n, REG_FEATS, 11)}
    out = {}
    for name, kind, cand in REPEAT_FAMILIES:
        X, y = data[kind]
        runs = []
        for _ in range(2):
            label = FeatureBuilder.RealNN("label").as_response()
            feats = [FeatureBuilder.RealNN(f"f{i}").as_predictor()
                     for i in range(X.shape[1])]
            cls = (S.BinaryClassificationModelSelector if kind == "binary"
                   else S.RegressionModelSelector)
            sel = cls(models=[getattr(S, cand)()])
            sel.set_input(label, transmogrify(feats))
            cols = {"label": Column(RealNN, y)}
            for i in range(X.shape[1]):
                cols[f"f{i}"] = Column(RealNN, X[:, i])
            wf = Workflow(device=device).set_input_batch(
                ColumnBatch(cols, n)).set_result_features(sel.get_output())
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            model = wf.train()
            _sync(device)
            runs.append((model, time.perf_counter() - t0,
                         _launch_delta(before, kernels.launch_counts())))
        (a, wa, la), (b, wb, _) = runs
        if _validation(a) != _validation(b):
            raise AssertionError(f"repeat fit ({name}): CV metrics differ: "
                                 f"{_validation(a)} vs {_validation(b)}")
        sa, sb = a.selected_model, b.selected_model
        if sa.summary.best_model_name != name or \
                not _same_bits(sa.best_model.fitted, sb.best_model.fitted):
            raise AssertionError(f"repeat fit ({name}): the refit tree "
                                 "arrays differ")
        out[name] = {"train_wall_s": [wa, wb], "candidates":
                     len(sa.summary.validation_results),
                     "tree_hist_launches": la["tree_hist"],
                     "tree_hist_deep_launches": la["tree_hist_deep"]}
        del runs, a, b
        torch.cuda.empty_cache()
    return out


def run_workflow_cv(cols, schema, n: int, p5_facts: dict,
                    device="cuda") -> dict:
    """Phase 16's workflow CV on phase 5's transmog workflow at ``n`` rows:
    'during' must hold the SanityChecker, three in-fold groups must run
    (SanityChecker fit four times: all rows, then each fold's training
    rows), every candidate's CV metric finite, the checked width phase 5's
    and train AuROC > 0.7; the peak device memory above what was allocated
    before may pass phase 5's peak by at most one n x (kept columns) f32
    matrix, the fold matrix resident beside the full-data one."""
    import math

    import torch

    from transmogrifai_tpu_torch.dag import compute_dag, cut_dag
    from transmogrifai_tpu_torch.preparators.sanity_checker import \
        SanityChecker
    tr = _transmog_ref()
    wf, batch, pred = tr.build(PORT, cols, schema, n, device=device)
    wf.with_workflow_cv()
    during = cut_dag(compute_dag([pred]), pred.origin_stage)[1]
    if "SanityChecker" not in {s.operation_name for l in during for s in l}:
        raise AssertionError("workflow CV: 'during' lacks the SanityChecker")
    fits = []
    real = SanityChecker.fit

    def counted(self, b):
        fits.append(len(b))
        return real(self, b)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    SanityChecker.fit = counted
    try:
        t0 = time.perf_counter()
        model = wf.train()
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        SanityChecker.fit = real
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    facts = {**tr.facts(PORT, model, batch), "train_wall_s": wall,
             "phase5_train_wall_s": p5_facts["train_wall_s"],
             "sanity_checker_fits_rows": fits,
             "peak_device_memory_gb": peak,
             "phase5_peak_device_memory_gb": p5_facts["peak_device_memory_gb"],
             "racing_notes": [e.cause for e in model.failure_log
                              if e.point == "selector.racing"]}
    matrix_gb = n * facts["width"] * 4 / 1e9
    facts["peak_limit_gb"] = p5_facts["peak_device_memory_gb"] + matrix_gb
    if len(fits) != 1 + N_FOLDS or fits[0] != n:
        raise AssertionError(f"workflow CV: SanityChecker fits {fits}, "
                             f"expected all {n} rows then {N_FOLDS} folds")
    if facts["width"] != TRANSMOG_WIDTH:
        raise AssertionError(f"workflow CV width {facts['width']}")
    if not all(math.isfinite(v) for v in facts["cv_aupr"].values()):
        raise AssertionError(f"workflow CV metrics {facts['cv_aupr']}")
    if facts["train_auroc"] <= 0.7:
        raise AssertionError(f"workflow CV train AuROC "
                             f"{facts['train_auroc']} <= 0.7")
    if peak > facts["peak_limit_gb"]:
        raise AssertionError(f"workflow CV peak {peak} GB > "
                             f"{facts['peak_limit_gb']} GB")
    return facts


def run_purity(model, batch, device="cuda") -> dict:
    """The purity audit on a fitted model over its raw batch on the card:
    every transformer applied twice must give the same bits."""
    import torch

    from transmogrifai_tpu_torch.sanitizer import audit_dag_purity
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = audit_dag_purity(model.fitted_dag, batch.on(device))
    _sync(device)
    return {"stages_audited": n, "wall_s": time.perf_counter() - t0,
            "peak_device_memory_gb":
                (torch.cuda.max_memory_allocated() - base) / 1e9}


def run_sanitized(X, y, plain_wall: float, device="cuda") -> dict:
    """The bench set (unraced, as the resume check's) trained under all
    three sanitizers: the NaN guard, the purity audit (each transformer
    applied twice on the card, the same bits) and the serialization
    audit."""
    wf, batch = build_workflow(X, y, device)
    wf.result_features[0].origin_stage.validator.racing = False
    wf.with_sanitizers(nan_check=True, purity_check=True,
                       serialization_check=True)
    t0 = time.perf_counter()
    model = wf.train()
    _sync(device)
    return {"train_wall_s": time.perf_counter() - t0,
            "plain_train_wall_s": plain_wall,
            "purity_audit_s": model.phase_seconds["purity_audit"],
            "winner": model.selected_model.summary.best_model_name}


def run_screen(X, y, device="cuda") -> dict:
    """The train-time screen at ``X``'s size: SCREEN_FRACTIONS of the rows
    given a NaN or an inf in one column.  0.5%: those rows quarantined (one
    event, the count in its cause) and the train succeeds; 20%:
    ``DataQualityError`` with that count."""
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.quality import DataQualityError
    rng = np.random.default_rng(SCREEN_SEED)
    n = len(y)
    out = {}
    for frac in SCREEN_FRACTIONS:
        k = int(round(frac * n))
        rows = rng.choice(n, size=k, replace=False)
        Xp = X.copy()
        Xp[rows, rows % X.shape[1]] = np.where(rows % 2, np.inf, np.nan)
        wf, _ = build_workflow(Xp, y, device)
        t0 = time.perf_counter()
        try:
            model = wf.train()
        except DataQualityError as e:
            if frac <= 0.1 or (e.quarantined, e.total) != (k, n):
                raise
            out[f"fraction_{frac}"] = {
                "raised": "DataQualityError", "quarantined": e.quarantined,
                "wall_s": time.perf_counter() - t0}
            continue
        _sync(device)
        wall = time.perf_counter() - t0
        if frac > 0.1:
            raise AssertionError(f"screen: {frac:.0%} non-finite rows "
                                 "trained")
        evs = model.failure_log.by_action("quarantined")
        if len(evs) != 1 or not evs[0].cause.startswith(f"{k} row(s)"):
            raise AssertionError(f"screen: events {evs}")
        _, clean = build_workflow(X, y, device)
        auroc = float(model.evaluate(Evaluators.BinaryClassification.auROC(),
                                     batch=clean)["AuROC"])
        if auroc <= 0.7:
            raise AssertionError(f"screen: train AuROC {auroc} <= 0.7")
        out[f"fraction_{frac}"] = {
            "quarantined": k, "train_wall_s": wall,
            "screen_s": model.phase_seconds["quality"],
            "train_auroc": auroc}
    return out


# --------------------------------------------------------------------------
# phase 17: more feature kinds
# --------------------------------------------------------------------------

# the JAX package's CPU run of phase 17's workflow, its map bucketizer
# without null tracking (the JAX package's with it writes each split key's
# null column twice and its SanityChecker raises), at KINDS_REF_ROWS rows:
#   PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/kinds_reference.py \
#       --package jax --rows 5000
# (1,449 s on the CPU; the port's CPU run, --package torch --device cpu,
# gave the same checked width, winner and train AuROC, its LR AuPRs within
# 1.2e-6 and its GBT AuPRs within 4.5e-3: deep GBT trees part on one-ulp
# gain gaps, ROADMAP "Reference behaviours").  The card's port holds the
# candidates, the winner and the checked width exactly, the train AuROC
# and each LR AuPR within 1e-4 and each GBT AuPR within 1e-2
# (KINDS_REF_TOL: 2x the CPU runs' gap)
KINDS_REF_ROWS = 5_000
KINDS_REF_PARAMS = {"OpLogisticRegression": ("reg_param", "elastic_net_param"),
                    "OpGBTClassifier": ("max_depth", "min_instances_per_node",
                                        "min_info_gain")}
KINDS_REF = {
    "checked_width": 463, "winner": "OpLogisticRegression",
    "train_auroc": 0.9386298656463623,
    # (family, its KINDS_REF_PARAMS, CV AuPR)
    "cv_aupr": [
        ("OpLogisticRegression", (0.001, 0.1), 0.8864704966545105),
        ("OpLogisticRegression", (0.001, 0.5), 0.8912584185600281),
        ("OpLogisticRegression", (0.01, 0.1), 0.8990752696990967),
        ("OpLogisticRegression", (0.01, 0.5), 0.9077740510304769),
        ("OpLogisticRegression", (0.1, 0.1), 0.9062711199124655),
        ("OpLogisticRegression", (0.1, 0.5), 0.8926313519477844),
        ("OpLogisticRegression", (0.2, 0.1), 0.9022058844566345),
        ("OpLogisticRegression", (0.2, 0.5), 0.846084475517273),
        ("OpGBTClassifier", (3, 10, 0.001), 0.8818145990371704),
        ("OpGBTClassifier", (3, 10, 0.01), 0.8818145990371704),
        ("OpGBTClassifier", (3, 10, 0.1), 0.8818145990371704),
        ("OpGBTClassifier", (3, 100, 0.001), 0.8848638534545898),
        ("OpGBTClassifier", (3, 100, 0.01), 0.8848638534545898),
        ("OpGBTClassifier", (3, 100, 0.1), 0.8848638534545898),
        ("OpGBTClassifier", (6, 10, 0.001), 0.8877368370691935),
        ("OpGBTClassifier", (6, 10, 0.01), 0.886739194393158),
        ("OpGBTClassifier", (6, 10, 0.1), 0.8828977346420288),
        ("OpGBTClassifier", (6, 100, 0.001), 0.8896563450495402),
        ("OpGBTClassifier", (6, 100, 0.01), 0.8871137499809265),
        ("OpGBTClassifier", (6, 100, 0.1), 0.8900924921035767),
        ("OpGBTClassifier", (12, 10, 0.001), 0.8706642389297485),
        ("OpGBTClassifier", (12, 10, 0.01), 0.8693356513977051),
        ("OpGBTClassifier", (12, 10, 0.1), 0.87433260679245),
        ("OpGBTClassifier", (12, 100, 0.001), 0.8893122871716818),
        ("OpGBTClassifier", (12, 100, 0.01), 0.8893331487973531),
        ("OpGBTClassifier", (12, 100, 0.1), 0.8882339199384054)
    ]}
KINDS_REF_TOL = {"OpLogisticRegression": 1e-4, "OpGBTClassifier": 1e-2}
BUCKETIZER_KERNELS = ("tree_hist", "tree_split_gini", "tree_route")


def _kinds_ref():
    """``scripts/kinds_reference.py``: phase 17's workflow and the numbers
    it is held to, shared with the JAX-side run."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import kinds_reference
    return kinds_reference


def time_bucketizer_fits(run, device="cuda") -> tuple:
    """``run()`` with each decision-tree bucketizer's fit timed (between two
    synchronizations), its tree kernels' launches counted around that fit
    alone and its fitted model kept.  Returns (run's result, the fits)."""
    from transmogrifai_tpu_torch.models import kernels
    from transmogrifai_tpu_torch.ops import bucketizers as bk
    fits = []
    reals = {cls: cls.fit for cls in (bk.DecisionTreeNumericBucketizer,
                                      bk.DecisionTreeNumericMapBucketizer)}

    def timed(real):
        def fit(self, batch):
            _sync(device)
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            model = real(self, batch)
            _sync(device)
            d = _launch_delta(before, kernels.launch_counts())
            fits.append({"stage": type(self).__name__,
                         "input": self.input_features[1].name,
                         "seconds": time.perf_counter() - t0,
                         "launches": {k: d[k] for k in BUCKETIZER_KERNELS},
                         "model": model})
            return model
        return fit

    for cls, real in reals.items():
        cls.fit = timed(real)
    try:
        return run(), fits
    finally:
        for cls, real in reals.items():
            cls.fit = real


def check_bucketizer_splits(fits, cols) -> int:
    """Each bucketizer fitted on the card (``time_bucketizer_fits``) against
    the port's CPU fit of the same column (every map key alone): the same
    thresholds exactly.  Returns the columns and keys checked."""
    from transmogrifai_tpu_torch.ops.bucketizers import \
        tree_splits_for_feature
    y = np.asarray(cols["label"].values, np.float64)
    checked = 0
    for f in fits:
        model = f["model"].fitted
        if f["stage"] == "DecisionTreeNumericBucketizer":
            col = cols[f["input"]]
            x = np.asarray(col.values, np.float64)
            p = np.asarray(col.mask, bool) & ~np.isnan(x)
            want = {f["input"]: tree_splits_for_feature(x[p], y[p],
                                                        device="cpu")}
            got = {f["input"]: np.asarray(model["splits"])[1:-1]}
        else:
            from transmogrifai_tpu_torch.ops.map_profile import expand_maps
            exp = expand_maps(cols[f["input"]].values)
            at = exp.key_index()
            want, got = {}, {}
            for k in model["keys"]:
                x = exp.vals[:, at[k]]
                p = ~np.isnan(x)
                want[k] = tree_splits_for_feature(x[p], y[p], device="cpu")
                got[k] = np.asarray(model["splits_by_key"][k])[1:-1]
        for k in want:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"{f['stage']} ({k}): the card's "
                                     f"splits {got[k]} != the CPU fit's "
                                     f"{want[k]}")
            checked += 1
    return checked


def check_calibrators(model, pred, b, device="cuda") -> dict:
    """PercentileCalibrator, IsotonicRegressionCalibrator (label, score)
    and a ScalerTransformer with its DescalerTransformer, once each on a
    RealNN score column of the batch (the winner's probability of class
    1), each fitted and applied on the card's batch and on its CPU copy:
    the same outputs (host numpy work either way), percentiles in
    [0, 99], the isotonic fit non-decreasing in the score and the
    descaled score within 1e-6 of the score."""
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch, host_array
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops import bucketizers as bk
    from transmogrifai_tpu_torch.types import RealNN
    n = len(b)
    score = host_array(model.score(b)[pred.name].values["probability"]
                       )[:, 1].astype(np.float32)
    outs, secs = {}, {}
    for dev in (device, "cpu"):
        label = FeatureBuilder.RealNN("label").as_response()
        sf = FeatureBuilder.RealNN("score").as_predictor()
        pc = bk.PercentileCalibrator()
        pc.set_input(sf)
        iso = bk.IsotonicRegressionCalibrator()
        iso.set_input(label, sf)
        scaled = sf.scale("Linear", {"slope": 2.5, "intercept": -1.0})
        back = scaled.descale(scaled)
        cb = ColumnBatch({"label": b["label"],
                          "score": Column(RealNN, score)}, n, device=dev)
        t0 = time.perf_counter()
        got = {"percentile": pc.fit(cb).transform(cb).values,
               "isotonic": iso.fit(cb).transform(cb).values}
        sc = scaled.origin_stage.transform(cb)
        got["scaled"] = sc.values
        got["descaled"] = back.origin_stage.transform(
            cb.with_columns({scaled.name: sc})).values
        secs[dev] = time.perf_counter() - t0
        outs[dev] = {k: np.asarray(host_array(v)) for k, v in got.items()}
    for k in outs["cpu"]:
        if not np.array_equal(outs[device][k], outs["cpu"][k]):
            raise AssertionError(f"{k}: the card's batch and the CPU's differ")
    o = outs["cpu"]
    order = np.argsort(score, kind="stable")
    if not (0 <= o["percentile"].min() and o["percentile"].max() <= 99) or \
            (np.diff(o["isotonic"][order]) < 0).any() or \
            np.abs(o["descaled"] - score).max() > 1e-6:
        raise AssertionError("calibrators: percentiles out of range, a "
                             "falling isotonic fit or a scale not undone")
    return {"rows": n, "seconds": secs,
            "distinct_percentiles": int(len(np.unique(o["percentile"])))}


def run_more_kinds(device="cuda", n: int = N_ROWS) -> tuple:
    """Phase 17 at ``n`` rows (``scripts/kinds_reference.py``'s workflow
    over ``synthetic.make_kinds_columns``, the map bucketizer with its
    default null tracking): ``Workflow.train()`` with the bucketizers'
    fits timed and their tree kernels counted alone, their splits against
    the CPU fit, the checked width, the candidates (exactly LR and GBT),
    the winner, the CV metrics and train AuROC > 0.7, the peak device
    memory; then the same workflow with ``use_train_validation_split=True``
    over LR only (its summary ``TrainValidationSplit`` with trainRatio
    0.75, racing recorded "degraded"); then the calibrators and scalers.
    Returns (facts, model, a fresh batch of ``n`` rows)."""
    import torch
    kr = _kinds_ref()
    t0 = time.perf_counter()
    b, schema = kr.batch(PORT, n, 17, device)
    data_s = time.perf_counter() - t0
    wf, pred, checked = kr.build(PORT, b, schema, True, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, fits = time_bucketizer_fits(wf.train, device)
    _sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    f = kr.facts(PORT, model, b, checked)
    if {c[0] for c in f["cv_aupr"]} != set(kr.FAMILIES) or \
            f["validation_type"] != "CrossValidation":
        raise AssertionError(f"phase 17: candidates {f['cv_aupr']}")
    if not f["train_auroc"] > 0.7:
        raise AssertionError(f"phase 17: train AuROC {f['train_auroc']}")
    n_split = check_bucketizer_splits(fits, {k: b[k] for k in b.names()})
    tvs_wf, _, _ = kr.build(PORT, b, schema, True, device,
                            use_train_validation_split=True,
                            model_types_to_use=["OpLogisticRegression"])
    t1 = time.perf_counter()
    tvs = tvs_wf.train()
    tvs_wall = time.perf_counter() - t1
    ts = tvs.selected_model.summary
    degraded = [e for e in tvs.failure_log
                if e.action == "degraded" and e.point == "selector.racing"]
    if ts.validation_type != "TrainValidationSplit" or \
            ts.validation_parameters.get("trainRatio") != 0.75 or \
            "numFolds" in ts.validation_parameters or len(degraded) != 1 or \
            {r.model_name for r in ts.validation_results} != \
            {"OpLogisticRegression"}:
        raise AssertionError(f"phase 17 TVS: {ts.validation_type} "
                             f"{ts.validation_parameters} {degraded}")
    cal = check_calibrators(model, pred, b, device)
    del tvs, tvs_wf
    fresh, _ = kr.batch(PORT, n, 23, device)
    facts = {
        "rows": n, "data_s": data_s, "train_wall_s": wall,
        "phase_seconds": model.phase_seconds, **f,
        "bucketizer_fits": [{k: v for k, v in x.items() if k != "model"}
                            for x in fits],
        "bucketizer_fit_s": sum(x["seconds"] for x in fits),
        "bucketizer_launches": {k: sum(x["launches"][k] for x in fits)
                                for k in BUCKETIZER_KERNELS},
        "splits_checked_against_cpu": n_split,
        "peak_device_memory_gb": peak,
        "tvs": {"train_wall_s": tvs_wall, "winner": ts.best_model_name,
                "validation_parameters": ts.validation_parameters,
                "cv_aupr": [float(r.metric_values["AuPR"])
                            for r in ts.validation_results]},
        "calibrators": cal}
    return facts, model, fresh


def check_kinds_reference(device="cuda") -> dict:
    """Phase 17's workflow at KINDS_REF_ROWS on the card against the JAX
    package's CPU run (KINDS_REF): candidates, winner and checked width
    equal, each family's CV AuPRs within its KINDS_REF_TOL and the train
    AuROC within 1e-4."""
    kr = _kinds_ref()
    b, schema = kr.batch(PORT, KINDS_REF_ROWS, 17, device)
    wf, _, checked = kr.build(PORT, b, schema, False, device)
    got = kr.facts(PORT, wf.train(), b, checked)
    want = KINDS_REF
    if [(c[0], tuple(json.loads(c[1])[k] for k in KINDS_REF_PARAMS[c[0]]))
            for c in got["cv_aupr"]] != [c[:2] for c in want["cv_aupr"]] \
            or got["winner"] != want["winner"] or \
            got["checked_width"] != want["checked_width"]:
        raise AssertionError(f"phase 17 reference: {got} vs {want}")
    gaps = {name: 0.0 for name in KINDS_REF_TOL}
    for a, c in zip(got["cv_aupr"], want["cv_aupr"]):
        gaps[a[0]] = max(gaps[a[0]], abs(a[2] - c[2]))
    auroc_gap = abs(got["train_auroc"] - want["train_auroc"])
    if any(gaps[k] > KINDS_REF_TOL[k] for k in gaps) or auroc_gap > 1e-4:
        raise AssertionError(f"phase 17 reference: CV AuPR gaps {gaps}, "
                             f"train AuROC gap {auroc_gap}: {got} vs {want}")
    return {"rows": KINDS_REF_ROWS, "cv_aupr_max_abs_diff": gaps,
            "train_auroc_abs_diff": auroc_gap, "winner": got["winner"],
            "checked_width": got["checked_width"]}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.columns import ColumnBatch
    from transmogrifai_tpu_torch.models import kernels

    # phase 14 runs on each model right after the phase that trained it,
    # while the model and its fresh batch are alive; its launches are
    # summed here and added to the kernels' rows at the end.  Phase 15
    # serves three of its bundles, kept in serve_dir with their rows
    bundle_launches: dict = {}
    serve_dir = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    atexit.register(shutil.rmtree, serve_dir, True)
    serve_rows = {"default_grid": SERVE_ROWS,
                  "transmog": SERVE_COLUMNAR_ROWS,
                  "sparse": SERVE_SPARSE_ROWS}
    serve_cases: dict = {}

    def bundle_phase(name, model, fresh):
        tree = type(model.selected_model.best_model).__name__ == \
            "TreeEnsembleModel"
        needs = {"transmog": ("hash_counts",),
                 "sparse": ("sp_matmat",)}.get(name, ()) + \
            (("tree_walk",) if tree else ())
        keep = serve_dir if name in serve_rows else None
        facts, launches, loaded = save_load_score(name, model, fresh, needs,
                                                  keep=keep)
        if keep:
            serve_cases[name] = (os.path.join(serve_dir, name), loaded,
                                 fresh.take_rows(np.arange(serve_rows[name])
                                                 % len(fresh)))
        for k, v in launches.items():
            bundle_launches[k] = bundle_launches.get(k, 0) + v
        print(f"phase 14 save, load and score ({name}): "
              + json.dumps(facts), flush=True)
        return loaded

    # phase 16 runs in parts: workflow CV and the transmog purity audit on
    # phase 5's columns and model, the sparse purity audit on phase 6's,
    # the rest after phase 15; each part's launches are read around it and
    # summed here
    p16_launches: dict = {}

    def add_p16(launches, part, needs=()):
        missing = [k for k in needs if launches[k] <= 0]
        if missing:
            raise AssertionError(f"phase 16 ({part}): kernels never "
                                 f"launched: {missing}")
        for k, v in launches.items():
            p16_launches[k] = p16_launches.get(k, 0) + v

    # phase 1: device and build
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    from transmogrifai_tpu_torch import native
    t0 = time.perf_counter()
    # the host helpers (g++) build while nvcc builds the kernels
    with ThreadPoolExecutor(1) as pool:
        helpers = pool.submit(native.build_all)
        cuda_build.build_all(verbose=True)
        helpers.result()
    for name in native.NATIVE_SOURCES:
        native.load(name)
    print(f"build_s: {time.perf_counter() - t0:.3f} (kernels "
          f"{list(cuda_build.KERNEL_SOURCES)}, native helpers "
          f"{list(native.NATIVE_SOURCES)})", flush=True)

    # phase 2: kernels vs twins
    rows = check_kernels("cuda")
    gini_row, forest_facts = check_forest_kernels("cuda")
    rows.insert(2, gini_row)
    rows[1:1] = [_kernel_row("tree_hist", forest_facts[k])
                 for k in ("tree_hist", "tree_hist_all_features")]
    rows.append(_kernel_row("tree_walk", forest_facts["tree_walk"]))
    torch.cuda.empty_cache()
    fista_row, fista_facts = check_linear_kernel("cuda")
    deep_row, deep_facts = check_deep_kernels("cuda")
    rows.insert(1, deep_row)
    rows.append(_kernel_row("tree_walk",
                            deep_facts[f"tree_walk_50_trees_depth_{DEEP}"]))
    rows.append(fista_row)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    print("forest shapes: " + json.dumps(forest_facts), flush=True)
    print("fista_step shapes: " + json.dumps(fista_facts), flush=True)
    print(f"depth-{DEEP} shapes: " + json.dumps(deep_facts), flush=True)
    torch.cuda.empty_cache()

    # phase 3: the bench set, launches counted around it alone
    kernels.reset_launch_counts()
    facts = run_main_path("cuda", N_ROWS)
    launches = kernels.launch_counts()
    print(f"main path {N_ROWS}x{N_FEATS}: " + json.dumps(facts), flush=True)
    print("kernel launches: " + json.dumps(launches), flush=True)
    # the bench set's trees are at most depth 6: no level needs the deep
    # histogram; the dense path hashes no text, explains
    # nothing and fits no regression tree
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in ("tree_hist_deep", "hash_counts",
                                       "sp_matmat", "sp_rmatmat",
                                       "loco_linear", "loco_tree",
                                       "tree_split_variance",
                                       "fista_softmax",
                                       "multiclass_confusion", "fista_glm",
                                       "loco_softmax", "fista_wide")]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if facts["train_auroc"] <= 0.7:
        raise AssertionError(f"train AuROC {facts['train_auroc']} <= 0.7")
    torch.cuda.empty_cache()

    # the same workflow at 20,000 rows: card vs CPU twins vs the JAX package
    print("small runs (20000 rows): " + json.dumps(check_small_runs()),
          flush=True)
    torch.cuda.empty_cache()

    # phase 4: the default grid at 1M, launches and peak memory around it
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (grid_facts, grid_model, grid_batch), hist_shapes = count_hist_shapes(
        lambda: run_default_grid("cuda", N_ROWS, with_model=True))
    launches = kernels.launch_counts()
    grid_facts["peak_device_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    print(f"default grid {N_ROWS}x{N_FEATS}: " + json.dumps(grid_facts),
          flush=True)
    print("default grid kernel launches: " + json.dumps(launches), flush=True)
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in ("hash_counts", "sp_matmat",
                                       "sp_rmatmat", "loco_linear",
                                       "loco_tree", "tree_split_variance",
                                       "fista_softmax",
                                       "multiclass_confusion", "fista_glm",
                                       "loco_softmax", "fista_wide")]
    if missing:
        raise AssertionError(f"kernels never launched on the default grid: "
                             f"{missing}")
    print("default grid tree_hist calls by shape: " + json.dumps(
        hist_shapes), flush=True)
    if grid_facts["train_auroc"] <= 0.7:
        raise AssertionError(f"default grid train AuROC "
                             f"{grid_facts['train_auroc']} <= 0.7")
    torch.cuda.empty_cache()
    print(f"reference runs ({REF_ROWS} rows): "
          + json.dumps(check_reference_runs()), flush=True)

    from transmogrifai_tpu_torch import selector as S
    print("profile default grid RF CV: " + json.dumps(profile_lr_cv(
        grid_model, grid_batch, S.BinaryClassificationModelSelector(
            models=[S._rf_classifier()]), top=16)), flush=True)
    print("profile default grid GBT CV: " + json.dumps(profile_lr_cv(
        grid_model, grid_batch, S.BinaryClassificationModelSelector(
            models=[S._gbt_classifier()]), top=16)), flush=True)
    # tree_hist and tree_hist_deep at the forests' and GBTs' own lane
    # batches, timed beside the rows above
    hist_rows, hist_facts = check_forest_hist_levels("cuda")
    print("tree_hist forest levels (300 lanes): " + json.dumps(hist_facts),
          flush=True)
    torch.cuda.empty_cache()
    deep_rows, deep_levels = check_deep_hist_levels("cuda")
    print("tree_hist_deep levels: " + json.dumps(deep_levels), flush=True)
    hist_rows += deep_rows
    torch.cuda.empty_cache()
    route_rows, route_levels = check_route_split_levels("cuda")
    print("tree_route and tree_split levels: " + json.dumps(route_levels),
          flush=True)
    hist_rows += route_rows
    rows += hist_rows
    for r in rows:
        r["launches"] = launches[r["name"]]
    torch.cuda.empty_cache()
    fresh = multiclass_batch(*make_data(N_ROWS, seed=BUNDLE_SCORE_SEED))
    loaded = bundle_phase("default_grid", grid_model, fresh)
    print("phase 14 latencies (default grid, reloaded): " + json.dumps(
        bundle_latencies(loaded, fresh)), flush=True)
    del loaded, fresh
    torch.cuda.empty_cache()

    # phase 5: the transmogrification path at 1M rows; the batches are made
    # before the clock starts, hash_counts is checked on a copy of text1
    from transmogrifai_tpu_torch.synthetic import make_transmog_columns
    cols, schema = make_transmog_columns(N_ROWS)
    score_cols, _ = make_transmog_columns(N_ROWS, seed=7)
    text_row = check_text_kernel(cols["text1"])
    print("kernel hash_counts: " + json.dumps(text_row), flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tm_facts, tm_model, tm_batch = run_transmog("cuda", cols, schema, N_ROWS,
                                                score_cols)
    tm_launches = kernels.launch_counts()
    tm_facts["peak_device_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    print(f"transmog {N_ROWS} rows: " + json.dumps(tm_facts), flush=True)
    print("transmog kernel launches: " + json.dumps(tm_launches), flush=True)
    if tm_facts["width"] != TRANSMOG_WIDTH:
        raise AssertionError(f"transmog checked width {tm_facts['width']}, "
                             f"expected {TRANSMOG_WIDTH}")
    missing = [k for k in ("hash_counts", "fista_step")
               if tm_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the transmog path: "
                             f"{missing}")
    if tm_facts["train_auroc"] <= 0.7:
        raise AssertionError(f"transmog train AuROC "
                             f"{tm_facts['train_auroc']} <= 0.7")
    torch.cuda.empty_cache()
    bundle_phase("transmog", tm_model, ColumnBatch(score_cols, N_ROWS))
    del score_cols
    torch.cuda.empty_cache()
    wide_rows, wide_facts = check_wide_fista(tm_model, tm_batch)
    print("fista_step transmog shapes: " + json.dumps(wide_facts), flush=True)
    torch.cuda.empty_cache()
    print("profile transmog LR CV: " + json.dumps(profile_lr_cv(
        tm_model, tm_batch, transmog_lr_selector())), flush=True)
    torch.cuda.empty_cache()
    # phase 16, on phase 5's columns: the workflow under workflow CV, then
    # the purity audit on phase 5's model (hash_counts twice on the card)
    kernels.reset_launch_counts()
    wcv_facts = run_workflow_cv(cols, schema, N_ROWS, tm_facts)
    add_p16(kernels.launch_counts(), "workflow_cv")
    print("phase 16 workflow CV (transmog): " + json.dumps(wcv_facts),
          flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    print("phase 16 purity audit (transmog): " + json.dumps(
        run_purity(tm_model, tm_batch)), flush=True)
    add_p16(kernels.launch_counts(), "purity_transmog", ("hash_counts",))
    del cols
    torch.cuda.empty_cache()
    print(f"transmog reference runs ({TRANSMOG_REF_ROWS} rows): "
          + json.dumps(check_transmog_reference()), flush=True)
    text_row["launches"] = tm_launches["hash_counts"]
    for r in wide_rows:
        r["launches"] = tm_launches["fista_step"]
    rows += [text_row] + wide_rows
    torch.cuda.empty_cache()

    # phase 6: sparse hashed text at 1M rows x 100,000 hashes; the batches
    # are made before the clock starts, and the kernels are checked first
    # on the run's own matrix (built from copies of the columns)
    from transmogrifai_tpu_torch.synthetic import make_sparse_text_columns
    cols, _ = make_sparse_text_columns(N_ROWS)
    score_cols, _ = make_sparse_text_columns(N_ROWS, seed=7)
    X, host_split = sparse_matrix_of(cols)
    print("sparse text stage, host split: " + json.dumps(host_split),
          flush=True)
    sp_rows, sp_kfacts = check_sparse_kernels(X)
    del X
    print("sparse kernels: " + json.dumps(sp_kfacts), flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sp_facts, sp_model, sp_batch = run_sparse("cuda", N_ROWS, cols,
                                              score_cols)
    sp_launches = kernels.launch_counts()
    sp_facts["peak_device_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    print(f"sparse text {N_ROWS} rows x {SPARSE_HASHES} hashes: "
          + json.dumps(sp_facts), flush=True)
    print("sparse kernel launches: " + json.dumps(sp_launches), flush=True)
    if sp_facts["width"] != SPARSE_WIDTH:
        raise AssertionError(f"sparse width {sp_facts['width']}, expected "
                             f"{SPARSE_WIDTH}")
    missing = [k for k in ("sp_matmat", "sp_rmatmat") if sp_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the sparse path: "
                             f"{missing}")
    if sp_facts["train_auroc"] <= 0.99:
        raise AssertionError(f"sparse train AuROC {sp_facts['train_auroc']} "
                             "<= 0.99")
    if sp_facts["peak_device_memory_gb"] >= SPARSE_PEAK_GB:
        raise AssertionError(f"sparse peak device memory "
                             f"{sp_facts['peak_device_memory_gb']} GB >= "
                             f"{SPARSE_PEAK_GB} GB")
    torch.cuda.empty_cache()
    bundle_phase("sparse", sp_model, ColumnBatch(score_cols, N_ROWS))
    del score_cols
    torch.cuda.empty_cache()
    print("profile sparse LR CV: " + json.dumps(profile_sparse_cv(
        sp_model, sp_batch)), flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    print("phase 16 purity audit (sparse): " + json.dumps(
        run_purity(sp_model, sp_batch)), flush=True)
    add_p16(kernels.launch_counts(), "purity_sparse", ("sp_matmat",))
    del sp_model, sp_batch
    torch.cuda.empty_cache()
    print(f"sparse reference runs ({SPARSE_REF_ROWS} rows): "
          + json.dumps(check_sparse_reference()), flush=True)
    for r in sp_rows:
        r["launches"] = sp_launches[r["name"]]
    rows += sp_rows
    torch.cuda.empty_cache()

    # phase 7: explanations, on the models of phases 4 and 5 (and the bench
    # set's forest, refitted); launches read around the three
    # RecordInsightsLOCO transforms alone
    ins_facts, ins_launches, ins_inputs = run_insights_main_path(
        tm_model, tm_batch, grid_model, grid_batch)
    del tm_model, tm_batch
    print(f"insights {N_ROWS} rows: " + json.dumps(ins_facts), flush=True)
    print("insights kernel launches: " + json.dumps(ins_launches),
          flush=True)
    missing = [k for k in ("loco_linear", "loco_tree")
               if ins_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the insights path: "
                             f"{missing}")
    torch.cuda.empty_cache()
    ins_rows, ins_kfacts = check_insights_kernels(ins_inputs)
    del ins_inputs
    print("loco kernels: " + json.dumps(ins_kfacts), flush=True)
    for r in ins_rows:
        r["launches"] = ins_launches[r["name"]]
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    rows += ins_rows
    torch.cuda.empty_cache()
    print(f"wide trees (D = {WIDE_D}): " + json.dumps(check_wide_trees()),
          flush=True)
    torch.cuda.empty_cache()
    print(f"{MULTI_CLASSES}-class forest: "
          + json.dumps(check_multiclass_forest()), flush=True)
    torch.cuda.empty_cache()
    print("sparse default selector: "
          + json.dumps(check_sparse_default_selector(cols)), flush=True)
    del cols
    torch.cuda.empty_cache()
    print("corr and summary: " + json.dumps(run_corr_and_summary(
        grid_model, grid_batch)), flush=True)
    del grid_model, grid_batch
    torch.cuda.empty_cache()

    # phase 8: the regression family — the variance split and the squared
    # loss against their twins, then the default grid at 1M rows with the
    # launches and peak memory read around its train and score, its LOCO
    # and summary, the compact grid, and both grids at 4,000 rows against
    # the JAX package
    var_row, var_facts = check_variance_split()
    print("tree_split_variance shapes: " + json.dumps(var_facts), flush=True)
    torch.cuda.empty_cache()
    sq_rows, sq_facts = check_fista_squared()
    print("fista_step squared shapes: " + json.dumps(sq_facts), flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    reg_facts, reg_model, reg_batch = run_regression("cuda", N_ROWS)
    reg_launches = kernels.launch_counts()
    reg_facts["peak_device_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    print(f"regression default grid {N_ROWS}x{REG_FEATS}: "
          + json.dumps(reg_facts), flush=True)
    print("regression kernel launches: " + json.dumps(reg_launches),
          flush=True)
    missing = [k for k in ("tree_hist", "tree_hist_deep", "tree_split",
                           "tree_split_variance", "tree_route", "tree_walk",
                           "fista_step") if reg_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the regression "
                             f"path: {missing}")
    if reg_facts["train_r2"] <= REG_R2_MIN:
        raise AssertionError(f"regression train R2 {reg_facts['train_r2']} "
                             f"<= {REG_R2_MIN}")
    if reg_facts["peak_device_memory_gb"] >= REG_PEAK_GB:
        raise AssertionError(f"regression peak device memory "
                             f"{reg_facts['peak_device_memory_gb']} GB")
    torch.cuda.empty_cache()
    bundle_phase("regression", reg_model, regression_workflow(
        N_ROWS, "default", "cuda", REG_SCORE_SEED)[1])
    torch.cuda.empty_cache()
    reg_ins, ins_launches = run_regression_insights(reg_model, reg_batch)
    print("regression insights: " + json.dumps(reg_ins), flush=True)
    if ins_launches["loco_linear"] + ins_launches["loco_tree"] <= 0:
        raise AssertionError("regression LOCO launched no kernel")
    del reg_model, reg_batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cmp_facts, _, _ = run_regression("cuda", N_ROWS, "compact")
    cmp_facts["peak_device_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    print(f"regression compact grid {N_ROWS}x{REG_FEATS}: "
          + json.dumps(cmp_facts), flush=True)
    if cmp_facts["train_r2"] <= REG_R2_MIN:
        raise AssertionError(f"regression compact train R2 "
                             f"{cmp_facts['train_r2']} <= {REG_R2_MIN}")
    torch.cuda.empty_cache()
    print(f"regression reference runs ({REG_REF_ROWS} rows): "
          + json.dumps(check_regression_reference()), flush=True)
    var_row["launches"] = reg_launches["tree_split_variance"]
    for r in sq_rows:
        r["launches"] = reg_launches["fista_step"]
    for r in [var_row] + sq_rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    rows += [var_row] + sq_rows
    torch.cuda.empty_cache()

    # phase 9: the multiclass family — both kernels against their twins,
    # then the default grid at 1M rows with the launches and peak memory
    # read around its train and score, the compact grid, naive Bayes and
    # the MLP, and the reference runs against the JAX package
    sm_rows, sm_facts = check_softmax_kernel()
    print("fista_softmax shapes: " + json.dumps(sm_facts), flush=True)
    cf_row, cf_facts = check_confusion_kernel()
    print("multiclass_confusion shapes: " + json.dumps(cf_facts), flush=True)
    torch.cuda.empty_cache()
    from transmogrifai_tpu_torch.synthetic import make_multiclass_data
    mc_X, mc_y = make_multiclass_data(N_ROWS, MC_FEATS)
    mc_fresh = make_multiclass_data(N_ROWS, MC_FEATS, MC_SCORE_SEED)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (mc_facts, mc_model, mc_batch), cf_calls = record_confusion_calls(
        lambda: run_multiclass("cuda", mc_X, mc_y, "default", mc_fresh))
    mc_launches = kernels.launch_counts()
    mc_facts["peak_device_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    print(f"multiclass default grid {N_ROWS}x{MC_FEATS}: "
          + json.dumps(mc_facts), flush=True)
    print("multiclass kernel launches: " + json.dumps(mc_launches),
          flush=True)
    if len(cf_calls) != mc_launches["multiclass_confusion"]:
        raise AssertionError(f"multiclass_confusion: {len(cf_calls)} calls "
                             f"recorded, {mc_launches['multiclass_confusion']}"
                             " launches")
    print("multiclass_confusion at the train's shapes: "
          + json.dumps(check_confusion_calls(cf_calls)), flush=True)
    del cf_calls
    print("profile multiclass LR CV: " + json.dumps(profile_lr_cv(
        mc_model, mc_batch, S.MultiClassificationModelSelector(
            models=[S._lr_candidates()]))), flush=True)
    missing = [k for k in ("fista_softmax", "multiclass_confusion",
                           "fista_step", "tree_hist", "tree_hist_deep",
                           "tree_split_gini", "tree_route", "tree_walk")
               if mc_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the multiclass "
                             f"path: {missing}")
    if mc_facts["train_f1"] <= MC_F1_MIN:
        raise AssertionError(f"multiclass train F1 {mc_facts['train_f1']} "
                             f"<= {MC_F1_MIN}")
    if mc_facts["peak_device_memory_gb"] >= MC_PEAK_GB:
        raise AssertionError(f"multiclass peak device memory "
                             f"{mc_facts['peak_device_memory_gb']} GB")
    torch.cuda.empty_cache()
    bundle_phase("multiclass", mc_model, multiclass_batch(*mc_fresh))
    torch.cuda.empty_cache()
    cmp_facts, _, _ = run_multiclass("cuda", mc_X, mc_y, "compact")
    print(f"multiclass compact grid {N_ROWS}x{MC_FEATS}: "
          + json.dumps(cmp_facts), flush=True)
    if cmp_facts["train_f1"] <= MC_F1_MIN:
        raise AssertionError(f"multiclass compact train F1 "
                             f"{cmp_facts['train_f1']} <= {MC_F1_MIN}")
    torch.cuda.empty_cache()
    print(f"naive Bayes and MLP {N_ROWS}x{MC_FEATS}: "
          + json.dumps(run_nb_mlp("cuda", mc_X, mc_y)), flush=True)
    del mc_fresh
    torch.cuda.empty_cache()
    print("multiclass reference runs: "
          + json.dumps(check_multiclass_reference()), flush=True)
    for r in sm_rows:
        r["launches"] = mc_launches["fista_softmax"]
    cf_row["launches"] = mc_launches["multiclass_confusion"]
    for r in sm_rows + [cf_row]:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    rows += sm_rows + [cf_row]
    torch.cuda.empty_cache()

    # phase 10: the GLMs — fista_glm against its f64 twin, then each
    # workload at 1M rows with the launches and peak memory read around its
    # train and score, held to the JAX package and the true coefficients,
    # and RecordInsightsLOCO on its winner (loco_linear's exp link)
    glm_rows, glm_kfacts = check_glm_kernel()
    print("fista_glm shapes: " + json.dumps(glm_kfacts), flush=True)
    torch.cuda.empty_cache()
    glm_launches = {}
    for family in GLM_FAMILIES:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        g_facts, g_model, g_batch = run_glm("cuda", N_ROWS, family)
        glm_launches[family] = kernels.launch_counts()
        g_facts["peak_device_memory_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        print(f"GLM {family} {N_ROWS}x16: " + json.dumps(g_facts),
              flush=True)
        print(f"GLM {family} kernel launches: "
              + json.dumps(glm_launches[family]), flush=True)
        if glm_launches[family]["fista_glm"] <= 0:
            raise AssertionError(f"fista_glm never launched on the GLM "
                                 f"({family}) path")
        check_glm_reference(g_facts)
        torch.cuda.empty_cache()
        if family == "poisson":
            print("profile GLM poisson CV: " + json.dumps(profile_glm_cv(
                g_model, g_batch, family)), flush=True)
        g_ins, g_ins_launches = run_loco_stage(
            g_model, g_batch, functools.partial(check_loco_linear,
                                                library=True))
        print(f"GLM {family} insights: " + json.dumps(g_ins), flush=True)
        if g_ins_launches["loco_linear"] <= 0:
            raise AssertionError(f"loco_linear never launched on the GLM "
                                 f"({family}) LOCO")
        if family == "poisson":
            exp_row = _kernel_row("loco_linear", g_ins["loco_kernel"])
            exp_row["launches"] = g_ins_launches["loco_linear"]
        del g_model, g_batch
        torch.cuda.empty_cache()
    for r in glm_rows:
        r["launches"] = glm_launches["poisson"]["fista_glm"]

    # phase 11: the softmax link of LOCO — RecordInsightsLOCO on phase 9's
    # multiclass winner at 1M rows, maps included, with the launches read
    # around the transform; loco_softmax against its twin on naive Bayes,
    # the MLP, a 40-class model and at bench_loco's width
    sm_ins, sm_launches = run_loco_stage(
        mc_model, mc_batch, functools.partial(check_loco_softmax,
                                              library=True))
    print("multiclass insights: " + json.dumps(sm_ins), flush=True)
    if sm_launches["loco_softmax"] <= 0:
        raise AssertionError("loco_softmax never launched on the multiclass "
                             "LOCO")
    del mc_model, mc_batch
    torch.cuda.empty_cache()
    sm_shapes = check_softmax_loco_shapes(mc_X, mc_y)
    print("loco_softmax shapes: " + json.dumps(sm_shapes), flush=True)
    del mc_X, mc_y
    torch.cuda.empty_cache()
    loco_rows = [_kernel_row("loco_softmax", sm_ins["loco_kernel"])] + [
        _kernel_row("loco_softmax", sm_shapes[k])
        for k in ("naive_bayes", "mlp", f"classes_{SOFTMAX_WIDE_CLASSES}",
                  "bench_loco_g128")]
    for r in loco_rows:
        r["launches"] = sm_launches["loco_softmax"]
    for r in glm_rows + [exp_row] + loco_rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    rows += glm_rows + [exp_row] + loco_rows
    torch.cuda.empty_cache()

    # phase 12: the repaired card-only refusals, each kernel against its
    # twin at the fault shapes, then the estimators a user calls at those
    # shapes with the launches read around the card fits alone; the
    # two-pass FISTA form beside the tensor-core form at phases 8 and 9's
    # wide shapes (timed there, not on any path: 0 launches)
    fault_rows, fault_facts = check_fault_shapes()
    bins_rows, bins_facts = check_wide_bins()
    print("fault shapes: " + json.dumps(fault_facts), flush=True)
    print("max_bins 64 / 127: " + json.dumps(bins_facts), flush=True)
    torch.cuda.empty_cache()
    path_facts, wide_launches = run_fault_paths()
    print("fault paths (fit_arrays): " + json.dumps(path_facts), flush=True)
    print("fault path kernel launches: " + json.dumps(wide_launches),
          flush=True)
    bins_path_facts, bins_launches = run_bins_paths()
    print("max_bins 64 fits: " + json.dumps(bins_path_facts), flush=True)
    print("max_bins 64 kernel launches: " + json.dumps(bins_launches),
          flush=True)
    for r in fault_rows:                 # fista_wide's and fista_glm's rows
        r["launches"] = wide_launches[r["name"]]
    for r in bins_rows:
        r["launches"] = bins_launches[r["name"]]
    beside = [_kernel_row("fista_wide", {**c, **c["two_pass"]})
              for c in (sq_facts["wide"], sm_facts["wide"])]
    for r in beside:
        r["launches"] = 0
    fault_rows += beside
    for r in fault_rows + bins_rows + hist_rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}", flush=True)
    rows += fault_rows + bins_rows
    torch.cuda.empty_cache()

    # phase 13: queue 3's repairs (hash_counts past one row's tile,
    # loco_softmax's slots in device memory, the binary selector ranked by
    # F1 with the launches read around its train) and loco_tree's windows,
    # links, strategies and long lists
    print("hash_counts wide: " + json.dumps(check_wide_hashes()), flush=True)
    torch.cuda.empty_cache()
    print("loco_softmax (2048,): " + json.dumps(check_wide_mlp_loco()),
          flush=True)
    print("loco_tree shapes: " + json.dumps(check_loco_tree_shapes()),
          flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    f1_facts = check_binary_confusion_selector()
    f1_launches = kernels.launch_counts()
    print("binary selector ranked by F1: " + json.dumps(f1_facts),
          flush=True)
    print("binary F1 selector kernel launches: " + json.dumps(f1_launches),
          flush=True)
    if f1_launches["fista_step"] <= 0:
        raise AssertionError("fista_step never launched on the F1-ranked "
                             "selector")
    print("phase 14 kernel launches (the five reloaded scores): "
          + json.dumps(bundle_launches), flush=True)
    torch.cuda.empty_cache()

    # phase 15: serving phase 14's bundles over HTTP
    serve_facts, serve_launches = run_serving(serve_cases)
    del serve_cases
    print("phase 15 kernel launches (served traffic): "
          + json.dumps({k: v for k, v in serve_launches.items() if v}),
          flush=True)
    print("serving: " + json.dumps(serve_facts), flush=True)
    torch.cuda.empty_cache()

    # phase 16: resume a preempted sweep, the sanitizers and the train-time
    # screen on the bench set at 1M x 28
    t16 = time.perf_counter()
    X, y = make_data(N_ROWS)
    kernels.reset_launch_counts()
    resume_facts = run_resume(X, y)
    add_p16(kernels.launch_counts(), "resume",
            ("tree_hist", "tree_split", "tree_split_gini", "tree_route",
             "tree_walk", "fista_step"))
    print("phase 16 resume (bench set, unraced): " + json.dumps(resume_facts),
          flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    repeat_facts = run_repeat_fits()
    add_p16(kernels.launch_counts(), "repeat_fits",
            ("tree_hist", "tree_hist_deep", "tree_split",
             "tree_split_variance", "tree_route", "tree_walk"))
    print("phase 16 repeat fits (fixed-point histograms): "
          + json.dumps(repeat_facts), flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    san_facts = run_sanitized(X, y, resume_facts["full_train_wall_s"])
    add_p16(kernels.launch_counts(), "sanitizers", ("tree_walk",))
    print("phase 16 sanitizers (bench set): " + json.dumps(san_facts),
          flush=True)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    screen_facts = run_screen(X, y)
    add_p16(kernels.launch_counts(), "screen")
    print("phase 16 train-time screen: " + json.dumps(screen_facts),
          flush=True)
    del X, y
    torch.cuda.empty_cache()
    print(f"phase 16 kernel launches: {json.dumps(p16_launches)}; "
          f"wall of its last part {time.perf_counter() - t16:.1f} s",
          flush=True)

    # phase 17: dates, geolocations, multi-pick-lists and the bucketizers
    # at 1M rows, the launches read around its two trains; then its bundle
    # (phase 14's checks, launches of its own) and the reference run
    t17 = time.perf_counter()
    kernels.reset_launch_counts()
    kinds_facts, kinds_model, kinds_fresh = run_more_kinds()
    p17_launches = kernels.launch_counts()
    print("phase 17 more kinds: " + json.dumps(kinds_facts), flush=True)
    print("phase 17 kernel launches: " + json.dumps(p17_launches), flush=True)
    missing = [k for k in BUCKETIZER_KERNELS + ("tree_split", "fista_step",
                                                "tree_walk")
               if p17_launches[k] <= 0 or (
                   k in BUCKETIZER_KERNELS
                   and kinds_facts["bucketizer_launches"][k] <= 0)]
    if missing:
        raise AssertionError(f"kernels never launched in phase 17: {missing}")
    bundle_phase("more_kinds", kinds_model, kinds_fresh)
    del kinds_model, kinds_fresh
    torch.cuda.empty_cache()
    print("phase 17 reference: " + json.dumps(check_kinds_reference()),
          flush=True)
    torch.cuda.empty_cache()
    print(f"phase 17 wall {time.perf_counter() - t17:.1f} s", flush=True)
    for r in rows:
        if r["name"] in ("tree_walk", "hash_counts", "sp_matmat"):
            r["launches"] += bundle_launches.get(r["name"], 0) \
                + serve_launches.get(r["name"], 0)
        r["launches"] += p16_launches.get(r["name"], 0) \
            + p17_launches.get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke wall_s: {time.perf_counter() - t_start:.1f}",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
