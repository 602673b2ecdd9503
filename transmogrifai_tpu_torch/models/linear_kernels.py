"""The linear family's kernels: ``fista_step``, ``fista_softmax`` and
``fista_glm``, their wrappers and their plain-PyTorch twins (the dispatch
rule and launch counters are in ``kernels.py``).

| kernel        | replaces (transmogrifai_tpu/models/solvers.py)                  |
|---------------|-----------------------------------------------------------------|
| fista_step    | ``_fista_loop``'s ``smooth_grad`` with ``xs_mv`` / ``xs_tmv`` (:160-166, :270-286) for the logistic, squared-hinge and squared (:53-56) losses; the product of ``_spectral_norm_sq_weighted`` (:112-131) |
| fista_softmax | the same ``smooth_grad`` for the multinomial loss ``_softmax_loss_grad`` (:44-50): C margins a lane (wrapper :func:`fista_softmax_step`) |
| fista_glm     | ``smooth_grad`` and the backtracking tests' ``smooth_val`` (:160-170, :189-215) for the exp-link losses ``_poisson_loss_grad`` / ``_gamma_loss_grad`` (:66-80): the loss value of every lane, with Xᵀg and Σg in the gradient form |

``fista_step``, ``fista_softmax`` and ``fista_glm`` are one tensor-core
design (``csrc/fista_tc.cuh``, sized by :func:`tc_plan`; the GLMs add each
column's loss sum, and their value form skips Xᵀg).  A shape no such
launch holds (a dense X wider than ~27,000 columns, more than 64 classes)
runs the feature-chunked two-pass form of all three, ``csrc/fista_wide.cu``
(:func:`wide_plan`): margins to device memory, the loss, then Xᵀg.  For a
``SparseMatrix`` the same gradient evaluation is ``sparse_fista_step``:
margins by the ``sp_matmat`` kernel, the loss derivative in plain PyTorch,
Xᵀg by ``sp_rmatmat`` (``sparse/sparse_kernels.py``); :func:`grad_seam`
picks the one for X.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .kernels import check as _check, launch, stream as _stream

LOSSES = {"logistic": 0, "squared_hinge": 1, "gram": 2, "squared": 3}
SOFTMAX_LOSS = 4         # csrc/fista_tc.cuh's TC_SOFTMAX

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TC_ARGTYPES = [_P] * 11 + [_L] + [_I] * 14 + [_P]  # fista_tc_launch
_GLM_ARGTYPES = [_P] * 11 + [_L] + [_I] * 15 + [_P]  # and the form
_SMEM_MAX = 227 * 1024
_N_BLOCKS = 132 * 4
TC_COLS = 64             # columns a launch: the kernel's 8 column tiles
TC_WARPS = 8             # warps a block (csrc/fista_tc.cuh)
TC_FOLDS = 4             # fold-weight rows a launch stages with X's tile
# The plan's search, best first: (cluster sizes, (stages, V in shared
# memory, accumulators in shared memory) in order, shared-memory cap).  One
# block a row tile where it fits with two stages (the next tile's load
# overlapping this one); else a cluster with two stages (the next tile
# loads while this one's partial margins are exchanged over the previous
# one's X^T g), two blocks an SM if they fit; V and the accumulators leave
# shared memory, and the ring goes to one stage, only for a slice too wide
# to hold them.
_FULL, _HALF = _SMEM_MAX, _SMEM_MAX // 2
_TC_SEARCH = (((1,), ((2, 1, 1),), _FULL),
              ((2, 4, 8), ((2, 1, 1),), _HALF),
              ((2, 4, 8), ((2, 1, 1),), _FULL),
              ((1, 2, 4, 8), ((2, 0, 1), (2, 0, 0)), _FULL),
              ((1, 2, 4, 8), ((1, 1, 1), (1, 0, 1), (1, 0, 0)), _FULL))


def loss_grads(lin, w, y, ws, loss: str):
    """The loss derivative at margins ``lin`` weighted by ``w / ws``,
    elementwise with broadcasting (rows and lanes in either layout)."""
    if loss == "logistic":
        return w * (torch.sigmoid(lin) - y) / ws
    if loss == "squared_hinge":
        viol = torch.clamp(1.0 - y * lin, min=0.0)
        return w * (-2.0 * viol * y) / ws
    if loss == "squared":
        return w * (lin - y) / ws
    return (w / ws) * lin


def fista_row_grads(X, V, muv, b, W, y, wsum, G: int, loss: str):
    """The per-row gradients g [L, N] of ``fista_step`` (see
    :func:`fista_step`), in plain PyTorch."""
    lane_fold = torch.arange(V.shape[0], device=X.device) // G
    lin = V @ X.T - muv[:, None] + b[:, None]
    return loss_grads(lin, W[lane_fold], y, wsum[:, None], loss)


def sparse_fista_step(X, V, muv, b, W, y, wsum, G: int, loss: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fista_step` for a ``SparseMatrix`` X, with the lanes as the
    products' dense columns: margins [N, L] by one ``sp_matmat``, the
    arithmetic of :func:`fista_row_grads` on [N, L], Xᵀg [D, L] by one
    ``sp_rmatmat`` (≙ the sparse ``xs_mv`` / ``xs_tmv``, solvers.py:529-541).
    Both kernels sum in a fixed order, so this is bit-repeatable too."""
    lane_fold = torch.arange(V.shape[0], device=X.device) // G
    lin = X.matmat(V.T.contiguous()) - muv + b
    g = loss_grads(lin, W[lane_fold].T, None if y is None else y[:, None],
                   wsum, loss).contiguous()
    return X.rmatmat(g).T.contiguous(), g.sum(dim=0)


def grad_seam(X, loss: str = "logistic"):
    """The gradient evaluation for X and ``loss``: ``sparse_fista_step``
    for a ``SparseMatrix``, :func:`fista_softmax_step` for the multinomial
    loss on a dense X, :func:`fista_glm` (which also returns the loss
    value) for the poisson and gamma losses, else ``fista_step``."""
    from ..sparse.matrix import SparseMatrix
    if isinstance(X, SparseMatrix):
        if loss in GLM_LOSSES:
            raise TypeError(f"the {loss} loss on a SparseMatrix arrives with "
                            "the port's sparse regression (ROADMAP queue 1 "
                            "item 8)")
        if loss == "softmax":
            raise TypeError("the multinomial loss on a SparseMatrix arrives "
                            "with the port's sparse multinomial fits "
                            "(ROADMAP queue 1 item 8)")
        return sparse_fista_step
    if loss == "softmax":
        return lambda X, V, muv, b, W, y, wsum, G, loss: fista_softmax_step(
            X, V, muv, b, W, y, wsum, G)
    if loss in GLM_LOSSES:
        return fista_glm
    return fista_step


def fista_step_twin(X, V, muv, b, W, y, wsum, G: int, loss: str):
    """Plain-PyTorch twin of ``fista_step`` (see :func:`fista_step`): the
    two matmuls per evaluation the JAX package leaves to XLA."""
    g = fista_row_grads(X, V, muv, b, W, y, wsum, G, loss)
    return g @ X, g.sum(dim=1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b) * b


def _tc_stride(cols: int) -> int:
    """Row stride (floats) of the gradient, reduction and accumulator
    tiles: at least ``cols``, ≡ 8 or 24 mod 32, so fragment loads of 8
    rows x 4 columns and float2 stores of half a warp hit distinct banks."""
    s = cols
    while s % 32 not in (8, 24):
        s += 8
    return s


def _tc_layout(TR: int, CS: int, DS: int, S: int, Jc: int, v_res: int,
               acc_res: int, lsum: bool = False) -> dict:
    """The block's shared-memory carve-up of ``csrc/fista_tc.cuh`` (its
    ``tc_smem_floats`` adds the same terms): the ring of X's tile with its
    rows of fold weights and y, g hi/lo (two of them where a cluster
    pipelines its tiles), the WK warps' margin partials, the
    cluster exchange (a slot per block, two buffers), V's slice (split:
    hi and lo; in device memory unless V and the accumulators both fit), the
    accumulators (k groups x (m-tiles + the ones tile) x 16 rows), four
    constants a column and (``lsum``: a GLM's gradient form) the loss
    terms' per-(row slot, column) sums (the value form keeps them in the g
    buffer it does not use)."""
    WM = TR // 16
    WK = TC_WARPS // WM
    DSA = _ceil(DS, 16)
    DSX = _ceil(DSA + 16, 32)          # + the ones m-tile
    DSV = DS + (4 - DS) % 32
    Jp = _tc_stride(Jc)
    MT = DSA // 16 + 1
    KG = max(1, TC_WARPS // MT)
    acc = KG * MT * 16 * Jp
    floats = (S * TR * (DSX + TC_FOLDS + 1)
              + (4 if CS > 1 and S == 2 else 2) * TR * Jp
              + (WK * TR * Jp if WK > 1 else 0)
              + (2 * CS * TR * Jp if CS > 1 else 0)
              + (2 * Jc * DSV if v_res and acc_res else 0)
              + (acc if acc_res else 0) + 4 * Jc
              + (TR * Jp if lsum else 0))
    return {"smem": 4 * floats, "acc_floats": acc}


def _tc_plan_dict(lanes, Jc, TR, CS, DS, S, v_res, acc_res, lay) -> dict:
    return {"form": "narrow" if CS == 1 else "cluster", "lanes": lanes,
            "cols": Jc, "TR": TR, "CS": CS, "DS": DS, "S": S,
            "v_res": v_res, "acc_res": acc_res, "smem": lay["smem"],
            "acc_floats": lay["acc_floats"]}


def _tc_fit(D: int, lanes: int, C: int, lsum: bool) -> Optional[dict]:
    Jc = _ceil(lanes * C, 8)
    for sizes, placements, cap in _TC_SEARCH:
        for S, v_res, acc_res in placements:
            for CS in sizes:
                DS = _ceil(-(-D // CS), 8)
                if (CS - 1) * DS >= D:
                    continue
                for TR in (128, 64, 32, 16):
                    lay = _tc_layout(TR, CS, DS, S, Jc, v_res, acc_res,
                                     lsum)
                    if lay["smem"] <= cap:
                        return _tc_plan_dict(lanes, Jc, TR, CS, DS, S,
                                             v_res, acc_res, lay)
    return None


def tc_plan(D: int, L: int, C: int = 1, lsum: bool = False) -> dict:
    """How ``csrc/fista_tc.cuh`` runs D features and L lanes of C columns:
    whole lanes a launch up to 64 columns (``lanes``); one block a row
    tile (``CS`` = 1) where X's tile, V and the accumulators fit its shared
    memory with two stages (``S``), with the largest tile (``TR`` rows; 128
    give each warp whole margins, so the loss runs in its fragments); else
    the narrowest cluster of ``CS`` blocks, each a feature slice of ``DS``,
    that fits half an SM's shared memory (two blocks an SM) with two
    stages, else a whole SM's.  Keeps V (``v_res``) or the
    accumulators (``acc_res``) out of shared memory, and then the ring to
    one stage, only where nothing else fits (a 16,384-wide X), and then
    the lanes a launch (32, 16, 8 columns).  Where no launch holds the
    shape (more than 64 classes, or a slice too wide even so: past ~27,000
    features) the two-pass form of :func:`wide_plan`.  ``lsum``: room for a
    GLM gradient form's loss sums.  The one place that sizes the launch:
    every D, L and C has a plan."""
    if D < 1 or L < 1 or C < 1:
        raise ValueError(f"fista_tc: {L} lanes of {C} columns, {D} features")
    if C > TC_COLS:
        return wide_plan(D, L, C)
    top = min(L, TC_COLS // C)
    for lanes in sorted({top} | {max(1, k // C) for k in (32, 16, 8)
                                 if k // C < top}, reverse=True):
        plan = _tc_fit(D, lanes, C, lsum)
        if plan is not None:
            return plan
    return wide_plan(D, L, C)


def launch_plan(D: int, L: int) -> dict:
    """How ``fista_step`` launches for D features and L lanes
    (:func:`tc_plan` with one column a lane)."""
    return tc_plan(D, L, 1)


WIDE_LOSSES = {"logistic": 0, "squared_hinge": 1, "gram": 2, "squared": 3,
               "softmax": 4, "poisson": 5, "gamma": 6}   # csrc/fista_wide.cu
WIDE_ROWS = 64           # fista_wide.cu's TRX: rows a tile of the Xᵀg pass
WIDE_FEATS = 128         # its DCX: features a chunk of the Xᵀg pass
WIDE_MARGIN_ROWS = 64    # its TRM: rows a block of the margin pass
_WIDE_ARGTYPES = [_P] * 11 + [_L] + [_I] * 11 + [_P]


def wide_plan(D: int, L: int, C: int = 1, glm: bool = False) -> dict:
    """The two-pass form of ``csrc/fista_wide.cu`` for D features and L
    lanes of C columns (J = L·C; ``glm``: a loss column a lane more): every
    lane in one launch, its margins ``Jp`` floats a row in device memory
    (J, plus L for the GLMs' loss terms, to a multiple of 4), the Xᵀg pass
    over ``chunks`` feature chunks and the ones column.  Holds any shape."""
    J = L * C
    Jt = J + (L if glm else 0)
    return {"form": "wide", "lanes": L, "cols": J, "Jp": _ceil(Jt, 4),
            "Jt": Jt, "chunks": -(-D // WIDE_FEATS) + 1}


def _wide_run(X, V, muv, b, W, y, wsum, G: int, C: int, loss: str,
              plan: dict, grad: bool = True) -> torch.Tensor:
    """Launch ``csrc/fista_wide.cu`` once for every lane: returns out
    [(D·J if grad) + Jt] — Xᵀg [D, J], then Σg [J] and, for the GLMs, Σ
    of the loss terms [L]."""
    N, D = X.shape
    L = wsum.shape[0]
    dev = X.device
    J, Jt = L * C, plan["Jt"]
    # row-tile blocks of the Xᵀg pass share the card with its chunks
    chunks = plan["chunks"] if grad else 1
    nb = max(1, min(-(-N // WIDE_ROWS), -(-_N_BLOCKS * 2 // chunks), 65535))
    # the margin pass splits the features where its row tiles and column
    # chunks alone would not fill the card (few rows, many features)
    tiles = -(-N // WIDE_MARGIN_ROWS) * -(-J // 32)
    Dk = _ceil(-(-D // max(1, min(-(-_N_BLOCKS * 2 // tiles),
                                  -(-D // WIDE_FEATS)))), WIDE_FEATS)
    KS = -(-D // Dk)
    n_out = (D * J if grad else 0) + Jt
    mbuf = torch.empty((N, plan["Jp"]), dtype=torch.float32, device=dev)
    mpart = (torch.empty((KS, N, plan["Jp"]), dtype=torch.float32,
                         device=dev) if KS > 1 else None)
    partial = torch.empty((n_out, nb), dtype=torch.float32, device=dev)
    out = torch.empty((n_out,), dtype=torch.float32, device=dev)
    loss_blocks = max(1, min(-(-(N * L) // 256), _N_BLOCKS * 4))
    VT = V.reshape(J, D).T.contiguous()      # the margin pass reads [D, J]
    launch("fista_wide", _WIDE_ARGTYPES, X.data_ptr(), VT.data_ptr(),
           muv.data_ptr(), b.data_ptr(), W.data_ptr(), y.data_ptr(),
           wsum.data_ptr(), mbuf.data_ptr(),
           None if mpart is None else mpart.data_ptr(), partial.data_ptr(),
           out.data_ptr(), N, D, L, C, G, WIDE_LOSSES[loss], int(grad),
           plan["Jp"], KS, Dk, nb, loss_blocks, _stream(X))
    return out


def wide_outputs(out: torch.Tensor, D: int, L: int, C: int = 1,
                 grad: bool = True, glm: bool = False):
    """The results in ``fista_wide``'s output vector (Xᵀg as [D, J]
    row-major, then Σg [J], then for the GLMs Σ of the loss terms [L]):
    (Xᵀg [L, D] or, with C > 1, [L, C, D] — None without ``grad`` —, Σg
    [L] or [L, C], the loss sums [L] or None)."""
    J = L * C
    off = D * J if grad else 0
    gx = None
    if grad:
        gx = out[:off].reshape(D, J).T
        gx = gx.contiguous() if C == 1 else gx.reshape(L, C, D)
    gs = out[off:off + J] if C == 1 else out[off:off + J].reshape(L, C)
    return gx, gs, (out[off + J:off + J + L] if glm else None)


def tc_chunks(V, muv, b, wsum, G: int, plan: dict):
    """The launches of one gradient evaluation: (lane0, lanes, V, muv, b,
    wsum) of each — whole lanes, at most ``plan["lanes"]`` of them and at
    most ``TC_FOLDS`` folds' weights (lane l reads fold l // G) a launch:
    the arrays the wrapper hands the kernel."""
    L, lc = wsum.shape[0], plan["lanes"]
    l0 = 0
    while l0 < L:
        n = min(lc, L - l0, (l0 // G + TC_FOLDS) * G - l0)
        yield (l0, n, V[l0:l0 + n], muv[l0:l0 + n], b[l0:l0 + n],
               wsum[l0:l0 + n])
        l0 += n


def _tc_run(name: str, X, V, muv, b, W, y, wsum, G: int, C: int, loss: int,
            plan: dict, grad: bool = True, glm: bool = False) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` for each of :func:`tc_chunks`; returns
    out [rows, L*C]: with ``grad`` the (D+1) rows of Xᵀg and Σg, then for a
    GLM (``glm``) the row of the loss sums."""
    N, D = X.shape
    L = wsum.shape[0]
    dev = X.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ncl_max = max(1, sms * 4 // plan["CS"])
    rows = (D + 1 if grad else 0) + (1 if glm else 0)
    out = torch.empty((rows, L * C), dtype=torch.float32, device=dev)
    partial = torch.empty((ncl_max, rows * plan["lanes"] * C),
                          dtype=torch.float32, device=dev)
    accg = (None if plan["acc_res"] else torch.empty(
        (ncl_max * plan["CS"], plan["acc_floats"]), dtype=torch.float32,
        device=dev))
    vg = (None if plan["v_res"] and plan["acc_res"] else torch.empty(
        (2, plan["cols"], plan["CS"] * plan["DS"]), dtype=torch.float32,
        device=dev))
    form = (int(grad),) if glm else ()
    for l0, n_l, Vc, mc, bc, wc in tc_chunks(V, muv, b, wsum, G, plan):
        o = out if n_l == L else torch.empty((rows, n_l * C),
                                             dtype=torch.float32, device=dev)
        launch(name, _GLM_ARGTYPES if glm else _TC_ARGTYPES, X.data_ptr(),
               Vc.data_ptr(), mc.data_ptr(), bc.data_ptr(), W.data_ptr(),
               y.data_ptr(), wc.data_ptr(), partial.data_ptr(),
               None if accg is None else accg.data_ptr(),
               None if vg is None else vg.data_ptr(), o.data_ptr(), N, D, n_l,
               C, l0, G, loss, plan["TR"], plan["CS"], plan["DS"], plan["S"],
               plan["v_res"], plan["acc_res"], ncl_max, plan["smem"], *form,
               _stream(X))
        if o is not out:
            out[:, l0 * C:(l0 + n_l) * C] = o
    return out


def fista_step(X: torch.Tensor, V: torch.Tensor, muv: torch.Tensor,
               b: torch.Tensor, W: torch.Tensor, y: Optional[torch.Tensor],
               wsum: torch.Tensor, G: int, loss: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gradient evaluation of FISTA for L lanes over one X.

    X f32 [N, D]; V f32 [L, D] the lanes' scaled coefficients (coef /
    scale); muv f32 [L] = mean · V; b f32 [L] intercepts; W f32 [F, N] fold
    row weights, lane l reading fold ``l // G``; y f32 [N] the loss target
    (0/1 logistic, ±1 squared hinge, the label itself for "squared";
    ignored by "gram"); wsum f32 [L].  With
    margins m = (X V_l - muv_l) + b_l and g the loss derivative weighted by
    ``W / wsum`` ("gram": g = (W / wsum) · m, the product of the power
    iteration), returns (Xᵀ g [L, D], Σ_n g [L]).  The card's products run
    on tensor cores in split TF32 and its sums in a fixed order: the same
    inputs give the same bits on every run."""
    dev = X.device
    _check("fista_step X", X, torch.float32, 2, dev)
    _check("fista_step V", V, torch.float32, 2, dev)
    _check("fista_step W", W, torch.float32, 2, dev)
    for name, t in (("muv", muv), ("b", b), ("wsum", wsum)):
        _check(f"fista_step {name}", t, torch.float32, 1, dev)
    if loss not in LOSSES:
        raise ValueError(f"fista_step: loss {loss!r}")
    if loss != "gram":
        _check("fista_step y", y, torch.float32, 1, dev)
    N, D = X.shape
    L = V.shape[0]
    if (V.shape[1] != D or W.shape[1] != N or muv.shape != (L,)
            or b.shape != (L,) or wsum.shape != (L,)
            or (L - 1) // G >= W.shape[0]
            or (y is not None and y.shape != (N,))):
        raise ValueError("fista_step: shapes of X/V/W/y and lanes disagree")
    if dev.type == "cpu":
        return fista_step_twin(X, V, muv, b, W, y, wsum, G, loss)
    if dev.type != "cuda":
        raise ValueError(f"fista_step: unsupported device {dev}")
    plan = launch_plan(D, L)
    yk = X if y is None else y
    if plan["form"] == "wide":
        out = _wide_run(X, V, muv, b, W, yk, wsum, G, 1, loss, plan)
        return wide_outputs(out, D, L)[:2]
    out = _tc_run("fista_step", X, V, muv, b, W, yk, wsum, G, 1,
                  LOSSES[loss], plan)
    return out[:D].T.contiguous(), out[D]


# --------------------------------------------------------------------------
# the multinomial (softmax) loss: fista_softmax
# --------------------------------------------------------------------------

def fista_softmax_row_grads(X, V, muv, b, W, y, wsum, G: int):
    """The per-row gradients g [L, C, N] of :func:`fista_softmax_step`, in
    plain PyTorch (≙ ``_softmax_loss_grad``, solvers.py:44-50, per lane)."""
    L, C, D = V.shape
    N = X.shape[0]
    lane_fold = torch.arange(L, device=X.device) // G
    lin = ((V.reshape(L * C, D) @ X.T).reshape(L, C, N)
           - muv[..., None] + b[..., None])
    p = torch.softmax(lin, dim=1)
    onehot = torch.nn.functional.one_hot(y.long(), C).T.to(X.dtype)
    return W[lane_fold][:, None, :] * (p - onehot) / wsum[:, None, None]


def fista_softmax_step_twin(X, V, muv, b, W, y, wsum, G: int):
    """Plain-PyTorch twin of :func:`fista_softmax_step`: the two matmuls
    and the softmax between them, as XLA runs the JAX package's loop."""
    g = fista_softmax_row_grads(X, V, muv, b, W, y, wsum, G)
    L, C, N = g.shape
    return (g.reshape(L * C, N) @ X).reshape(L, C, -1), g.sum(dim=2)


def softmax_launch_plan(D: int, L: int, C: int) -> dict:
    """How ``fista_softmax`` launches for D features and L lanes of C
    classes (:func:`tc_plan` with C columns a lane: whole lanes, at most 64
    columns a launch, so every C up to 64; past that, or past the widest
    slice, the two-pass form).  Any D, L and C >= 2."""
    if C < 2:
        raise ValueError(f"fista_softmax: {C} classes")
    return tc_plan(D, L, C)


def fista_softmax_step(X: torch.Tensor, V: torch.Tensor, muv: torch.Tensor,
                       b: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
                       wsum: torch.Tensor, G: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gradient evaluation of FISTA for L lanes of the multinomial loss
    over one X.

    X f32 [N, D]; V f32 [L, C, D] the lanes' scaled coefficients per class
    (coef / scale); muv f32 [L, C] = mean · V; b f32 [L, C] intercepts; W
    f32 [F, N] fold row weights, lane l reading fold ``l // G``; y int32
    [N] class ids (< C); wsum f32 [L].  With margins m = (X V_lc - muv_lc)
    + b_lc, p the softmax of a lane's C margins and g = W·(p - onehot(y)) /
    wsum, returns (Xᵀ g [L, C, D], Σ_n g [L, C]).  The card's products run
    on tensor cores in split TF32 and its sums in a fixed order: the same
    inputs give the same bits on every run."""
    dev = X.device
    _check("fista_softmax X", X, torch.float32, 2, dev)
    _check("fista_softmax V", V, torch.float32, 3, dev)
    _check("fista_softmax W", W, torch.float32, 2, dev)
    _check("fista_softmax y", y, torch.int32, 1, dev)
    for name, t, nd in (("muv", muv, 2), ("b", b, 2), ("wsum", wsum, 1)):
        _check(f"fista_softmax {name}", t, torch.float32, nd, dev)
    N, D = X.shape
    L, C = V.shape[:2]
    if (V.shape[2] != D or W.shape[1] != N or muv.shape != (L, C)
            or b.shape != (L, C) or wsum.shape != (L,) or y.shape != (N,)
            or (L - 1) // G >= W.shape[0]):
        raise ValueError("fista_softmax: shapes of X/V/W/y and lanes "
                         "disagree")
    if dev.type == "cpu":
        return fista_softmax_step_twin(X, V, muv, b, W, y, wsum, G)
    if dev.type != "cuda":
        raise ValueError(f"fista_softmax: unsupported device {dev}")
    plan = softmax_launch_plan(D, L, C)
    if plan["form"] == "wide":
        out = _wide_run(X, V, muv, b, W, y, wsum, G, C, "softmax", plan)
        return wide_outputs(out, D, L, C)[:2]
    out = _tc_run("fista_softmax", X, V, muv, b, W, y, wsum, G, C,
                  SOFTMAX_LOSS, plan)
    return out[:D].T.reshape(L, C, D), out[D].reshape(L, C)


# --------------------------------------------------------------------------
# the exp-link GLM losses (poisson, gamma): fista_glm
# --------------------------------------------------------------------------

GLM_LOSSES = {"poisson": 5, "gamma": 6}   # csrc/fista_loss.cuh's codes


def glm_row_terms(lin, y, w, ws, loss: str):
    """Each row's weighted loss term and gradient at margins ``lin``
    (≙ ``_poisson_loss_grad`` / ``_gamma_loss_grad``, solvers.py:66-80):
    poisson w·(μ - y·m) and w·(μ - y)/ws with μ = exp(clip(m, ±30)); gamma
    w·(y/μ + m) and w·(1 - y/μ)/ws with 1/μ = exp(clip(-m, ±30)).  y·m is
    not clipped, as in the JAX package.  Elementwise with broadcasting."""
    if loss == "poisson":
        mu = torch.exp(torch.clamp(lin, -30.0, 30.0))
        return w * (mu - y * lin), w * (mu - y) / ws
    if loss == "gamma":
        iv = torch.exp(torch.clamp(-lin, -30.0, 30.0))
        return w * (y * iv + lin), w * (1.0 - y * iv) / ws
    raise ValueError(f"fista_glm: loss {loss!r}")


def fista_glm_twin(X, V, muv, b, W, y, wsum, G: int, loss: str,
                   grad: bool = True):
    """Plain-PyTorch twin of :func:`fista_glm`: the margin matmul, the loss
    terms and (``grad``) the Xᵀg matmul, as XLA runs the JAX package's
    ``smooth_grad`` / ``smooth_val``."""
    lane_fold = torch.arange(V.shape[0], device=X.device) // G
    lin = V @ X.T - muv[:, None] + b[:, None]
    lw, g = glm_row_terms(lin, y, W[lane_fold], wsum[:, None], loss)
    val = lw.sum(dim=1) / wsum
    if not grad:
        return val
    return g @ X, g.sum(dim=1), val


def glm_launch_plan(D: int, L: int, grad: bool) -> dict:
    """How ``fista_glm`` launches for D features and L lanes: the
    tensor-core form's :func:`tc_plan` for a full launch of 64 lanes with
    room for the loss sums — the same rows a tile, cluster and shared
    memory for both forms and every lane count, so that at one point the
    gradient form and a ladder's value form add their loss sums in the
    same order (the kernel gives both the clusters that its 64-column
    form holds co-resident) — with
    at most its lanes a launch (a ladder's 96 trial lanes are two launches
    of 64 and 32, each reading X once); ``grad`` does not change it.
    Where that takes the two-pass form (past ~27,000 features)
    :func:`wide_plan` with a loss column a lane.  Every D and L has a
    plan."""
    if L < 1 or D < 1:
        raise ValueError(f"fista_glm: {L} lanes, {D} features")
    plan = tc_plan(D, TC_COLS, 1, lsum=True)
    if plan["form"] == "wide":
        return wide_plan(D, L, 1, glm=True)
    return {**plan, "lanes": min(L, plan["lanes"])}


def fista_glm(X: torch.Tensor, V: torch.Tensor, muv: torch.Tensor,
              b: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
              wsum: torch.Tensor, G: int, loss: str, grad: bool = True):
    """One evaluation of the smooth part of an exp-link GLM loss for L
    lanes over one X.

    X f32 [N, D]; V f32 [L, D] the lanes' scaled coefficients (coef /
    scale); muv f32 [L] = mean · V; b f32 [L] intercepts; W f32 [F, N] fold
    row weights, lane l reading fold ``l // G``; y f32 [N]; wsum f32 [L];
    ``loss`` "poisson" or "gamma".  With margins m = (X V_l - muv_l) + b_l,
    returns the mean loss Σ_n W·ℓ(m) / wsum [L] and, with ``grad``, first
    (Xᵀ g [L, D], Σ_n g [L]) for g the loss derivative weighted by W /
    wsum: (Xᵀg, Σg, loss).  The card's sums run in a fixed order: the same
    inputs give the same bits on every run."""
    dev = X.device
    _check("fista_glm X", X, torch.float32, 2, dev)
    _check("fista_glm V", V, torch.float32, 2, dev)
    _check("fista_glm W", W, torch.float32, 2, dev)
    _check("fista_glm y", y, torch.float32, 1, dev)
    for name, t in (("muv", muv), ("b", b), ("wsum", wsum)):
        _check(f"fista_glm {name}", t, torch.float32, 1, dev)
    if loss not in GLM_LOSSES:
        raise ValueError(f"fista_glm: loss {loss!r}")
    N, D = X.shape
    L = V.shape[0]
    if (V.shape[1] != D or W.shape[1] != N or muv.shape != (L,)
            or b.shape != (L,) or wsum.shape != (L,) or y.shape != (N,)
            or (L - 1) // G >= W.shape[0]):
        raise ValueError("fista_glm: shapes of X/V/W/y and lanes disagree")
    if dev.type == "cpu":
        return fista_glm_twin(X, V, muv, b, W, y, wsum, G, loss, grad)
    if dev.type != "cuda":
        raise ValueError(f"fista_glm: unsupported device {dev}")
    plan = glm_launch_plan(D, L, grad)
    if plan["form"] == "wide":
        out = _wide_run(X, V, muv, b, W, y, wsum, G, 1, loss, plan, grad)
        gx, gs, lsum = wide_outputs(out, D, L, 1, grad, glm=True)
        return (gx, gs, lsum / wsum) if grad else lsum / wsum
    out = _tc_run("fista_glm", X, V, muv, b, W, y, wsum, G, 1,
                  GLM_LOSSES[loss], plan, grad=grad, glm=True)
    val = out[-1] / wsum
    return (out[:D].T.contiguous(), out[D], val) if grad else val
