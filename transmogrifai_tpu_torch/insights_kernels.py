"""The leave-one-covariate-out kernels of the port: wrappers, launch plans
and the plain-PyTorch twin (the dispatch rule and launch counters are in
``models/kernels.py``).

| kernel      | replaces (transmogrifai_tpu/record_insights.py)                 |
|-------------|------------------------------------------------------------------|
| loco_linear | ``_device_topk``'s ``loco`` program (:140-160) on LR, SVC and LinReg |
| loco_tree   | ``_device_topk``'s ``loco`` program (:140-160) on GBT, RF and DT, classifiers and regressors |
| loco_softmax | ``_device_topk``'s ``loco`` program (:140-160) on multinomial LR, naive Bayes and the MLP: the softmax's last class (:82-112) |

The JAX program runs a ``lax.map`` of G masked forwards ``score(X * m_g)``
so that [G, N, D] is never formed, then ``lax.top_k`` over the [N, G]
diffs.  The three kernels read X once and keep each row's top K as they
go (``csrc/loco_topk.cuh``); none forms ``X * m_g``.  In ``loco_linear``
and ``loco_softmax``'s warp form a warp takes a row (lane i group g0 + i);
in ``loco_tree`` and ``loco_softmax``'s row form a thread takes a row.
``loco_topk_twin`` computes ``base - score(X * m_g)`` one group at a time,
the score from the model's own ``device_scores`` (``loco_score``), and
sorts the rank stably: it is what the CPU runs and what the kernels are
held to.

Groups are given as a column -> group map ``col_group`` int32 [D] with
values in [0, G) (every column in one group).  A row's output is K (group,
diff) pairs ordered by rank, highest first, ties to the lower group index
(``lax.top_k``'s rule): rank = |diff|, diff or -diff for the strategies
"abs", "positive" and "negative".
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .models.kernels import check as _check, launch, stream as _stream

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "loco_linear": [_P, _P, _F] + [_P] * 5 + [_L] + [_I] * 9 + [_P],
    "loco_tree": [_P] * 5 + [_L] + [_I] * 8 + [_F, _F] + [_I] * 5 + [_P],
    "loco_softmax": [_P] * 10 + [_L] + [_I] * 19 + [_P],
}
STRATEGIES = ("abs", "positive", "negative")
# kernel codes: loco_linear's links of the margin m — the sigmoid, the
# identity (an SVC's margin, a linear regression's prediction) and a GLM's
# inverse links of clip(m, -30, 30): exp (poisson, gamma), the sigmoid
# (binomial) and the identity (gaussian); loco_tree's GBT and forest
# scores, classifier (probability of the last class) or regressor
# (prediction)
LINKS = {"logistic": 0, "identity": 1, "clipped_exp": 2,
         "clipped_logistic": 3, "clipped_identity": 4, "gbt": 0,
         "forest": 1, "gbt_regression": 2, "forest_regression": 3}
# a linear model's (kind, GLM family) -> the link of the score LOCO
# explains (≙ ``_linear_device_scores``'s tails, linear.py:164-190)
LINEAR_LINKS = {("binary", None): "logistic", ("svc", None): "identity",
                ("regression", None): "identity",
                ("glm", "poisson"): "clipped_exp",
                ("glm", "gamma"): "clipped_exp",
                ("glm", "binomial"): "clipped_logistic",
                ("glm", "gaussian"): "clipped_identity"}


def linear_link(fitted: dict) -> str:
    """The link ``loco_linear`` explains a fitted linear model through, by
    its kind (and a GLM's family); raises ValueError on any other."""
    kind = fitted.get("kind", "binary")
    key = (kind, fitted.get("family", "gaussian") if kind == "glm" else None)
    if key not in LINEAR_LINKS:
        raise ValueError(f"loco_linear: no link for a linear model of kind "
                         f"{kind!r}" + (f", family {key[1]!r}"
                                        if kind == "glm" else ""))
    return LINEAR_LINKS[key]


THREADS = 256                    # 8 warps, a row each at a time
SMEM_MAX = 227 * 1024            # what one block can hold
BLOCKS_IN_FLIGHT = 132 * 8       # SMs x resident 256-thread blocks
GROUP_WINDOW = 1024              # loco_linear: group slots a warp holds
TREE_ROWS = 128                  # loco_tree: rows (threads) a block, 128 or 256
TREE_GROUP_WINDOW = 64           # loco_tree: groups a window sums at most
TREE_X_SMEM = 32 * 1024          # loco_tree: the most bytes of X a block stages
SLOT_SCRATCH_BYTES = 1 << 30     # loco_softmax: the most device-memory slots
ROW_WIDTH_MAX = 16               # loco_softmax: the row form's widest layer
ROW_D_MAX = 96                   # loco_softmax: the row form's widest row
ROW_ROWS = (128, 64, 32)         # loco_softmax: the row form's rows a block


class LocoPlan(NamedTuple):
    blocks: int
    threads: int
    group_window: int   # groups a pass sums (G: one pass)
    smem_bytes: int     # linear: the warps' group slots; tree: the group
                        # sums' slab and the staged rows of X
    wide_groups: bool   # loco_linear: one window of groups of 32+ columns
                        # on average, D % 4 == 0: float4 reads when the
                        # groups are contiguous and the rows aligned
    x_stride: int = 0   # loco_tree: the staged rows' stride (0: X in place)


def loco_plan(kind: str, N: int, D: int, G: int, K: int,
              forest: bool = False) -> LocoPlan:
    """The launch of ``loco_linear`` (``kind`` "linear") or ``loco_tree``
    (``kind`` "tree").  The linear kernel: one warp per row, a grid-stride
    loop over rows, the groups summed in windows of ``GROUP_WINDOW`` slots a
    warp (one pass over the row when G fits, else a margin pass first);
    wide groups (``wide_groups``: one window, 32 or more columns a group on
    average, D a multiple of 4) are read as float4, four columns a lane.
    The tree kernel: one row a thread, ``TREE_ROWS`` a block, the groups'
    leaf sums (two for a ``forest`` classifier) in a shared-memory slab of
    ``group_window`` = min(G, ``TREE_GROUP_WINDOW``) groups x (rows + 1)
    floats, the windows one after another; the block's rows of X staged at
    an odd stride ``x_stride`` where they fit ``TREE_X_SMEM`` (else read in
    place).  Any G >= 1 and 1 <= K <= G: past K = 32 the top-K list lives
    in the output (``loco_topk.cuh``)."""
    if not 1 <= K <= G or D < 1 or N < 0:
        raise ValueError(f"loco_plan: need 1 <= K <= G and D >= 1, got "
                         f"N={N} D={D} G={G} K={K}")
    if kind == "linear":
        blocks = max(1, min(-(-N // (THREADS // 32)), BLOCKS_IN_FLIGHT))
        gw = min(G, GROUP_WINDOW)
        return LocoPlan(blocks, THREADS, gw, 4 * gw * (THREADS // 32),
                        G <= gw and D % 4 == 0 and D >= 32 * G)
    if kind != "tree":
        raise ValueError(f"loco_plan: kind {kind!r}")
    R = TREE_ROWS
    gw = min(G, TREE_GROUP_WINDOW)
    dp = D | 1
    xs = dp if 4 * R * dp <= TREE_X_SMEM else 0
    smem = 4 * ((2 if forest else 1) * gw * (R + 1) + R * xs)
    return LocoPlan(max(1, -(-N // R)), R, gw, smem, False, xs)


class SoftmaxPlan(NamedTuple):
    blocks: int
    threads: int
    slot: int           # floats of a lane's slot: its two buffers
    slot_b: int         # the second buffer's floats (0 without a tail)
    tail_floats: int    # the tail's weights (in shared memory or not)
    tail_in_smem: bool  # staged beside the slots, else read from memory
    smem_bytes: int
    scratch_floats: int  # the warps' slots in device memory (0: in shared)
    form: str = "warps"  # "rows": a row a thread, its state in registers
    x_stride: int = 0    # rows: the staged rows' stride (odd, >= D)
    hm: int = 0          # rows: the registers' width (4, 8 or 16)


def loco_softmax_plan(N: int, D: int, G: int, K: int, H: int, C: int,
                      tail=()) -> SoftmaxPlan:
    """The launch of ``loco_softmax`` for a first layer H wide and ``tail``
    the widths of the layers after it (the last is C; none for logistic
    regression and naive Bayes, where H = C).

    The row form where every layer is at most ``ROW_WIDTH_MAX`` wide, the
    row at most ``ROW_D_MAX`` columns (a thread walks its columns in
    series: on an H100 at 100,000 rows it beat the warp form at 96
    columns, 0.168 against 0.258 ms, tied at 128, 0.305 against 0.304, and
    lost at 256 and 512, ``scripts/loco_softmax_time.py --widths``) and a
    block of ``ROW_ROWS`` rows (the most that fits) holds its state in
    shared memory — W1, b1, the tail's weights, its rows of X at an odd
    stride ``x_stride`` and its rows' top-K lists, 4 (D H + H + tail + R
    x_stride + 2 K (R + 1)) bytes: a row a thread, the row's activations
    in registers ``hm`` wide.  Else the warp form: one warp per row, a
    grid-stride loop over rows, each lane a slot in shared memory of two
    buffers the layers alternate between (the widest of the first layer
    and every second tail layer, and the widest of the others; one buffer
    without a tail), and the tail's weights staged beside the slots.  Up to
    8 warps a block, fewer when the slots do not fit ``SMEM_MAX``; the
    tail's weights are read from device memory where not even one warp's
    slots fit beside them (a wide or deep MLP).  Where one warp's slots
    alone do not fit (a layer of ~1,800 units or as many classes), the slots
    of 8 warps a block live in a device-memory scratch of
    ``scratch_floats`` (32·((SA + SB) | 1) + H floats a warp in flight, the
    blocks cut so that it stays within ``SLOT_SCRATCH_BYTES``), with the
    tail's weights staged where they fit.  Raises ValueError on a shape no
    model has.  Any G >= 1 and 1 <= K <= G, as in :func:`loco_plan`."""
    tail = tuple(int(t) for t in tail)
    if not 1 <= K <= G or D < 1 or N < 0 or H < 1 or C < 2:
        raise ValueError(f"loco_softmax_plan: need 1 <= K <= G, D >= 1, "
                         f"H >= 1, C >= 2; got N={N} D={D} G={G} K={K} "
                         f"H={H} C={C}")
    if (tail[-1] if tail else H) != C:
        raise ValueError(f"loco_softmax_plan: the last layer has "
                         f"{tail[-1] if tail else H} outputs, not C={C}")
    dims = (H,) + tail
    SA = max(dims[0::2])
    SB = max(dims[1::2]) if tail else 0
    tw = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(tail)))
    if max(dims) <= ROW_WIDTH_MAX and D <= ROW_D_MAX:
        hm = next(w for w in (4, 8, 16) if max(dims) <= w)
        xs = D | 1
        for R in ROW_ROWS:
            smem = 4 * (D * H + H + tw + R * xs + 2 * K * (R + 1))
            if smem <= SMEM_MAX:
                return SoftmaxPlan(max(1, -(-N // R)), R, SA + SB, SB, tw,
                                   True, smem, 0, "rows", xs, hm)
    per_warp = 32 * ((SA + SB) | 1) + H
    for staged in (True, False):
        for warps in (THREADS // 32, 4, 2, 1):
            smem = 4 * ((tw if staged else 0) + warps * per_warp)
            if smem <= SMEM_MAX:
                blocks = max(1, min(-(-N // warps), BLOCKS_IN_FLIGHT))
                return SoftmaxPlan(blocks, 32 * warps, SA + SB, SB, tw,
                                   staged, smem, 0)
    warps = THREADS // 32
    staged = 4 * tw <= SMEM_MAX
    blocks = max(1, min(-(-N // warps), BLOCKS_IN_FLIGHT,
                        SLOT_SCRATCH_BYTES // (4 * warps * per_warp)))
    return SoftmaxPlan(blocks, THREADS, SA + SB, SB, tw, staged,
                       4 * tw if staged else 0, blocks * warps * per_warp)


def softmax_layers(model, device):
    """``loco_softmax``'s view of a fitted multinomial LR, naive Bayes or
    MLP model: (relu_in, W1 f32 [D, H], b1 [H], tail [(W [in, out], b
    [out])]) with the first layer a = phi(x) · W1 + b1 (phi = max(x, 0)
    when ``relu_in``) and the tail the layers after it (ReLU before
    each)."""
    from .models.linear import (LinearPredictionModel, MLPClassificationModel,
                                NaiveBayesModel)
    f = model.fitted

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).contiguous()

    if isinstance(model, NaiveBayesModel):
        return True, t(t(f["log_prob"]).T), t(f["log_prior"]), []
    if isinstance(model, MLPClassificationModel):
        n = int(f["n_layers"])
        return (False, t(f["W0"]), t(f["b0"]),
                [(t(f[f"W{i}"]), t(f[f"b{i}"])) for i in range(1, n)])
    if (isinstance(model, LinearPredictionModel)
            and f.get("kind") == "multinomial"):
        return False, t(f["coef"]), t(torch.as_tensor(f["intercept"]).reshape(
            -1)), []
    raise ValueError(f"loco_softmax: {type(model).__name__} "
                     f"(kind {f.get('kind')!r}) has no softmax link")


def index_dtype(G: int) -> torch.dtype:
    """The narrowest index type for G groups (int16 up to 0x7FFF), as the
    JAX program ships indices over the host link."""
    return torch.int16 if G <= 0x7FFF else torch.int32


def _rank(diffs: torch.Tensor, strategy: str) -> torch.Tensor:
    if strategy == "positive":
        return diffs
    if strategy == "negative":
        return -diffs
    return diffs.abs()


def loco_topk_twin(X: torch.Tensor, score_fn: Callable, col_group, G: int,
                   k: int, strategy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of the kernels: ``base - score_fn(X * m_g)`` for
    each group g (one [N, D] masked copy live at a time), then a stable
    descending sort of the rank, so equal ranks keep the lower group first.
    Returns (idx [N, k] in ``index_dtype(G)``, diffs [N, k] f32)."""
    base = score_fn(X)
    cg = torch.as_tensor(col_group, device=X.device)
    diffs = torch.empty((X.shape[0], G), dtype=torch.float32, device=X.device)
    for g in range(G):
        diffs[:, g] = base - score_fn(X * (cg != g).to(X.dtype)[None, :])
    order = torch.sort(_rank(diffs, strategy), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return order.to(index_dtype(G)), torch.gather(diffs, 1, order)


def _check_common(name, X, col_group, G, k, strategy):
    dev = X.device
    _check(f"{name} X", X, torch.float32, 2, dev)
    _check(f"{name} col_group", col_group, torch.int32, 1, dev)
    if col_group.shape[0] != X.shape[1]:
        raise ValueError(f"{name}: col_group must have one entry per column")
    if strategy not in STRATEGIES:
        raise ValueError(f"{name}: strategy {strategy!r} not in {STRATEGIES}")
    if not 1 <= k <= G:
        raise ValueError(f"{name}: need 1 <= k <= G, got k={k}, G={G}")


def _outputs(N: int, k: int, dev):
    return (torch.empty((N, k), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.int32, device=dev))


def loco_score(model, X: torch.Tensor) -> torch.Tensor:
    """The score LOCO explains, from the model's own ``device_scores`` (≙
    ``_device_score_fn``, record_insights.py:82-112): ``scores`` (logistic
    p1, SVC margin, GBT p1, binary forest p1), else ``probability[:, -1]``,
    else ``prediction`` (a regressor's).  A tree ensemble walks with
    ``tree_walk_twin``, so this is plain PyTorch on any device: the twin's
    score."""
    from .models.tree_kernels import tree_walk_twin
    from .models.trees import TreeEnsembleModel
    out = (model.device_scores(X, walk=tree_walk_twin)
           if isinstance(model, TreeEnsembleModel) else model.device_scores(X))
    if "scores" in out:
        return out["scores"]
    if "probability" in out:
        return out["probability"][:, -1]
    return out["prediction"]


def loco_linear(X: torch.Tensor, model, col_group: torch.Tensor, G: int,
                k: int, strategy: str = "abs"):
    """Top-k LOCO (group, diff) pairs per row of a linear model
    (``LinearPredictionModel``: logistic, an SVC's margin, a linear
    regression's prediction, or a GLM's inverse link; :func:`linear_link`).

    X f32 [N, D]; ``col_group`` int32 [D].  Returns (idx [N, k] in
    ``index_dtype(G)``, diffs [N, k] f32)."""
    _check_common("loco_linear", X, col_group, G, k, strategy)
    link = linear_link(model.fitted)
    dev = X.device
    if dev.type == "cpu":
        return loco_topk_twin(X, lambda Z: loco_score(model, Z), col_group,
                              G, k, strategy)
    if dev.type != "cuda":
        raise ValueError(f"loco_linear: unsupported device {dev}")
    f = model.fitted
    coef = torch.as_tensor(f["coef"], dtype=torch.float32,
                           device=dev).reshape(-1).contiguous()
    intercept = float(torch.as_tensor(f["intercept"]).reshape(-1)[0])
    N, D = X.shape
    _check("loco_linear coef", coef, torch.float32, 1, dev)
    if coef.shape[0] != D:
        raise ValueError("loco_linear: coef must have one entry per column")
    plan = loco_plan("linear", N, D, G, k)
    sgid, perm = torch.sort(col_group, stable=True)
    # groups already contiguous (transmogrify's layout): no column gather
    perm = (None if bool(torch.equal(sgid, col_group))
            else perm.to(torch.int32))
    goff = torch.zeros(G + 1, dtype=torch.int32, device=dev)
    goff[1:] = torch.cumsum(torch.bincount(col_group.long(), minlength=G),
                            0).to(torch.int32)
    vec4 = (perm is None and plan.wide_groups and X.data_ptr() % 16 == 0
            and coef.data_ptr() % 16 == 0)
    val, idx = _outputs(N, k, dev)
    launch("loco_linear", _ARGTYPES["loco_linear"], X.data_ptr(),
           coef.data_ptr(), intercept,
           0 if perm is None else perm.data_ptr(),
           sgid.data_ptr(), goff.data_ptr(), val.data_ptr(), idx.data_ptr(),
           N, D, G, k, STRATEGIES.index(strategy), LINKS[link],
           plan.group_window, int(vec4), plan.blocks, plan.threads,
           _stream(X))
    return idx.to(index_dtype(G)), val


def loco_tree(X: torch.Tensor, model, col_group: torch.Tensor, G: int,
              k: int, strategy: str = "abs"):
    """Top-k LOCO (group, diff) pairs per row of a tree ensemble
    (``TreeEnsembleModel``: a binary GBT, a forest's last class, or a GBT or
    forest regressor's prediction).

    X f32 [N, D]; ``col_group`` int32 [D].  Returns (idx [N, k] in
    ``index_dtype(G)``, diffs [N, k] f32)."""
    _check_common("loco_tree", X, col_group, G, k, strategy)
    dev = X.device
    if dev.type == "cpu":
        return loco_topk_twin(X, lambda Z: loco_score(model, Z), col_group,
                              G, k, strategy)
    if dev.type != "cuda":
        raise ValueError(f"loco_tree: unsupported device {dev}")
    nodes = tree_nodes(model, col_group, dev)
    N, D = X.shape
    link = model.fitted["kind"]                  # "gbt" or "forest"
    if model.fitted.get("task") == "regression":
        link += "_regression"
    leaf_b = nodes["leaf_b"] if link == "forest" else None
    plan = loco_plan("tree", N, D, G, k, leaf_b is not None)
    val, idx = _outputs(N, k, dev)
    if N:
        launch("loco_tree", _ARGTYPES["loco_tree"], X.data_ptr(),
               nodes["records"].data_ptr(),
               0 if leaf_b is None else leaf_b.data_ptr(), val.data_ptr(),
               idx.data_ptr(), N, D, nodes["trees"], nodes["T"],
               nodes["steps"], G, k, STRATEGIES.index(strategy), LINKS[link],
               nodes["base"], nodes["eta"], plan.group_window,
               int(plan.x_stride > 0), plan.x_stride, plan.threads,
               plan.smem_bytes, _stream(X))
    return idx.to(index_dtype(G)), val


def loco_softmax(X: torch.Tensor, model, col_group: torch.Tensor, G: int,
                 k: int, strategy: str = "abs"):
    """Top-k LOCO (group, diff) pairs per row of a model scored by the
    softmax probability of its last class over a first layer linear in the
    features (:func:`softmax_layers`: multinomial logistic regression,
    naive Bayes, the MLP).

    X f32 [N, D]; ``col_group`` int32 [D].  Returns (idx [N, k] in
    ``index_dtype(G)``, diffs [N, k] f32)."""
    _check_common("loco_softmax", X, col_group, G, k, strategy)
    dev = X.device
    inp = softmax_kernel_inputs(model, col_group, G, dev)
    N, D = X.shape
    if inp["W1"].shape[0] != D:
        raise ValueError("loco_softmax: the first layer must have one row "
                         "per column")
    if dev.type == "cpu":
        return loco_topk_twin(X, lambda Z: loco_score(model, Z), col_group,
                              G, k, strategy)
    if dev.type != "cuda":
        raise ValueError(f"loco_softmax: unsupported device {dev}")
    H, C, dims = inp["H"], inp["C"], inp["dims"]
    plan = loco_softmax_plan(N, D, G, k, H, C, inp["widths"][1:])
    perm = inp["perm"]
    rows = plan.form == "rows"
    # the row form writes the indices in their final type
    val = torch.empty((N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, k), dtype=index_dtype(G) if rows else torch.int32,
                      device=dev)
    scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                           device=dev) if plan.scratch_floats else None)
    launch("loco_softmax", _ARGTYPES["loco_softmax"], X.data_ptr(),
           inp["W1"].data_ptr(), inp["b1"].data_ptr(), inp["tw"].data_ptr(),
           dims.data_ptr(), 0 if perm is None else perm.data_ptr(),
           inp["goff"].data_ptr(), val.data_ptr(), idx.data_ptr(),
           0 if scratch is None else scratch.data_ptr(), N, D, G,
           k, STRATEGIES.index(strategy), H, C, inp["n_tail"],
           int(inp["relu_in"]), plan.slot - plan.slot_b, plan.slot_b,
           plan.tail_floats, int(plan.tail_in_smem), plan.blocks,
           plan.threads, plan.smem_bytes, int(rows), plan.x_stride,
           int(idx.dtype == torch.int16), plan.hm, _stream(X))
    return (idx if rows else idx.to(index_dtype(G))), val


def softmax_kernel_inputs(model, col_group: torch.Tensor, G: int,
                          device) -> dict:
    """What ``loco_softmax``'s kernel reads, on ``device``: the first layer
    (``relu_in``, ``W1`` [D, H], ``b1`` [H]), the tail packed layer by
    layer as W [in, out] row-major then b [out] (``tw``; one unused float
    when there is no tail), the widths ``dims`` int32 [H, ..., C], and the
    columns sorted by group: ``perm`` int32 [D] (None when the groups are
    already contiguous) with group g at perm[goff[g] .. goff[g+1])."""
    relu_in, W1, b1, tail = softmax_layers(model, device)
    widths = [W.shape[1] for W, _ in tail]
    H = W1.shape[1]
    sgid, perm = torch.sort(col_group, stable=True)
    goff = torch.zeros(G + 1, dtype=torch.int32, device=device)
    goff[1:] = torch.cumsum(torch.bincount(col_group.long(), minlength=G),
                            0).to(torch.int32)
    return {"relu_in": relu_in, "W1": W1, "b1": b1,
            "tw": (torch.cat([torch.cat([W.reshape(-1), b])
                              for W, b in tail]) if tail
                   else torch.zeros(1, dtype=torch.float32, device=device)),
            "dims": torch.tensor([H] + widths, dtype=torch.int32,
                                 device=device),
            "widths": [H] + widths, "n_tail": len(tail), "H": H,
            "C": widths[-1] if widths else H,
            "perm": (None if bool(torch.equal(sgid, col_group))
                     else perm.to(torch.int32)),
            "goff": goff}


def pack_tree_nodes(trees: dict, col_group: torch.Tensor,
                    forest: bool) -> dict:
    """``loco_tree``'s view of the trees of :func:`tree_inputs`: int32 [Tr,
    T, 4] node records {feature (-1 at a leaf), threshold bits, the
    feature's group in ``col_group`` (-1 at a leaf), leaf_a bits} — leaf_a
    a forest classifier's last class share, else the node's one value — and
    for a ``forest`` classifier leaf_b f32 [Tr, T], the sum of its class
    shares."""
    feat, leaf = trees["feature"], trees["leaf"]
    is_leaf = trees["is_leaf"]
    f = torch.clamp(feat.long(), min=0)
    records = torch.stack([
        torch.where(is_leaf, -1, f.to(torch.int32)),
        trees["threshold"].view(torch.int32),
        torch.where(is_leaf, -1, col_group.to(torch.int32)[f]),
        leaf[..., -1 if forest else 0].contiguous().view(torch.int32)],
        dim=-1).contiguous()
    return {"records": records,
            "leaf_b": leaf.sum(dim=2).contiguous() if forest else None}


def tree_nodes(model, col_group: torch.Tensor, device) -> dict:
    """:func:`pack_tree_nodes` of a fitted tree ensemble for ``col_group``
    on ``device``, packed once and kept on the model (one entry a device
    and column map), with the walk's sizes: ``trees``, ``T``, ``steps``
    (depth + 1), ``base`` and ``eta`` (0 for a forest)."""
    key = (str(device), col_group.cpu().numpy().tobytes())
    cache = model.__dict__.setdefault("_loco_tree_nodes", {})
    if key not in cache:
        f = model.fitted
        trees = tree_inputs(f, device)
        forest = f["kind"] == "forest" and f.get("task") != "regression"
        cache[key] = {**pack_tree_nodes(trees, col_group.to(device), forest),
                      "trees": trees["feature"].shape[0],
                      "T": trees["feature"].shape[1],
                      "steps": trees["steps"],
                      "base": float(trees.get("base", 0.0)),
                      "eta": float(trees.get("eta", 0.0))}
    return cache[key]


def tree_inputs(fitted: dict, device) -> dict:
    """``loco_tree``'s view of a fitted GBT or forest
    (``TreeEnsembleModel.fitted``) on ``device``: ``feature`` int32,
    ``threshold`` f32, ``is_leaf`` bool [Tr, T], ``leaf`` f32 [Tr, T, V],
    ``steps`` (walk steps: depth + 1) and, for a GBT, ``base`` and
    ``eta``."""
    f = fitted
    leaf = torch.as_tensor(f["leaf"], dtype=torch.float32, device=device)
    trees = {"feature": torch.as_tensor(f["feature"], dtype=torch.int32,
                                        device=device).contiguous(),
             "threshold": torch.as_tensor(f["threshold"], dtype=torch.float32,
                                          device=device).contiguous(),
             "is_leaf": torch.as_tensor(f["is_leaf"], dtype=torch.bool,
                                        device=device).contiguous(),
             "leaf": (leaf if leaf.ndim == 3 else leaf[..., None]).contiguous(),
             "steps": int(f["max_depth"]) + 1}
    if f["kind"] == "gbt":
        trees.update(base=float(f["base"]), eta=float(f["eta"]))
    return trees


def model_loco(model, X: torch.Tensor, col_group: torch.Tensor, G: int,
               k: int, strategy: str):
    """LOCO top-k of a fitted model of the port on X, explaining the score
    ``loco_score`` picks: a multinomial linear model, naive Bayes and the
    MLP take ``loco_softmax``, another linear model (binary, SVC,
    regression, GLM) ``loco_linear``, a GBT or a forest ``loco_tree``.  Any
    other model raises ``NotImplementedError``."""
    from .models.linear import (LinearPredictionModel, MLPClassificationModel,
                                NaiveBayesModel)
    from .models.trees import TreeEnsembleModel
    from .selector import SelectedModel
    if isinstance(model, SelectedModel):
        model = model.best_model
    if (isinstance(model, (NaiveBayesModel, MLPClassificationModel))
            or (isinstance(model, LinearPredictionModel)
                and model.fitted.get("kind") == "multinomial")):
        return loco_softmax(X, model, col_group, G, k, strategy)
    if isinstance(model, LinearPredictionModel):
        return loco_linear(X, model, col_group, G, k, strategy)
    if isinstance(model, TreeEnsembleModel):
        return loco_tree(X, model, col_group, G, k, strategy)
    kind = getattr(model, "fitted", {}).get("kind", type(model).__name__)
    raise NotImplementedError(
        f"RecordInsightsLOCO: no LOCO kernel for {type(model).__name__} "
        f"(kind {kind!r}); the port explains linear models (binary, SVC, "
        "regression, GLM, multinomial), naive Bayes, the MLP and tree "
        "ensembles")


def col_group_of(groups, D: int, device) -> torch.Tensor:
    """int32 [D] column -> group map of ``groups`` (lists of columns, in
    group order); raises unless every column is in exactly one group."""
    cg = np.full(D, -1, np.int32)
    for g, cols in enumerate(groups):
        if (cg[np.asarray(cols, np.int64)] != -1).any():
            raise ValueError("LOCO groups overlap")
        cg[np.asarray(cols, np.int64)] = g
    if (cg < 0).any():
        raise ValueError("LOCO groups leave columns out")
    return torch.as_tensor(cg, device=device)
