"""The linear family's kernels: ``fista_step``, ``fista_softmax`` and
``fista_glm``, their wrappers and their plain-PyTorch twins (the dispatch
rule and launch counters are in ``kernels.py``).

| kernel        | replaces (transmogrifai_tpu/models/solvers.py)                  |
|---------------|-----------------------------------------------------------------|
| fista_step    | ``_fista_loop``'s ``smooth_grad`` with ``xs_mv`` / ``xs_tmv`` (:160-166, :270-286) for the logistic, squared-hinge and squared (:53-56) losses; the product of ``_spectral_norm_sq_weighted`` (:112-131) |
| fista_softmax | the same ``smooth_grad`` for the multinomial loss ``_softmax_loss_grad`` (:44-50): C margins a lane (wrapper :func:`fista_softmax_step`) |
| fista_glm     | ``smooth_grad`` and the backtracking tests' ``smooth_val`` (:160-170, :189-215) for the exp-link losses ``_poisson_loss_grad`` / ``_gamma_loss_grad`` (:66-80): the loss value of every lane, with Xᵀg and Σg in the gradient form |

For a ``SparseMatrix`` the same gradient evaluation is ``sparse_fista_step``:
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 10 + [_L] + [_I] * 13 + [_P]     # both kernels' launch
_SMEM_MAX = 227 * 1024
_N_BLOCKS = 132 * 4
WIDE_LANES = 32          # lanes per launch of the wide form
_DC_MARGIN = 64          # features per chunk, margin pass
_TR_XTG, _DC_XTG = 64, 128   # rows per tile and features per chunk, X^T g


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


def _tile_smem(D: int, L: int, tr: int) -> int:
    Lp = -(-L // 4) * 4
    return 4 * (tr * (D | 1) + tr * Lp + D * Lp + (D + 1) * Lp + 3 * Lp)


def _tile_rows(D: int, L: int) -> Optional[int]:
    """Rows per tile (a multiple of 32, at most 128) whose shared memory
    fits one block of the one-tile form; None when not even 32 rows fit."""
    for tr in (128, 64, 32):
        if _tile_smem(D, L, tr) <= _SMEM_MAX:
            return tr
    return None


def launch_plan(D: int, L: int) -> dict:
    """How ``fista_step`` launches for D features and L lanes: the one-tile
    form (X's row tile and every lane's coefficients in one block's shared
    memory) where it fits, else the wide two-pass form, 32 lanes at a time.
    Each form's shared memory in bytes is here, the one place that sizes
    it; the launch passes it on."""
    tr = _tile_rows(D, L)
    if tr is not None:
        return {"form": "tile", "lanes": L, "TR": tr,
                "smem": (_tile_smem(D, L, tr),)}
    lc = min(L, WIDE_LANES)
    Lp = -(-lc // 4) * 4
    lg = Lp // 4
    trm = min(256, 512 // lg) // 32 * 32     # TR * lanes/4 <= 2 per thread
    return {"form": "wide", "lanes": lc, "TR": trm,
            "smem": (4 * (trm * (_DC_MARGIN + 1) + _DC_MARGIN * Lp),
                     4 * (_TR_XTG * (_DC_XTG + 1) + _TR_XTG * Lp))}


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
    iteration), returns (Xᵀ g [L, D], Σ_n g [L]).  The card's sums run in
    a fixed order: the same inputs give the same bits on every run."""
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
    lc, tr = plan["lanes"], plan["TR"]
    out = torch.empty((D + 1, L), dtype=torch.float32, device=dev)
    yp = (X if y is None else y).data_ptr()
    if plan["form"] == "tile":
        nb = max(1, min(_N_BLOCKS, -(-N // tr)))
        partial = torch.empty(((D + 1) * L, nb), dtype=torch.float32,
                              device=dev)
        launch("fista_step", _ARGTYPES, X.data_ptr(), V.data_ptr(),
               muv.data_ptr(), b.data_ptr(), W.data_ptr(), yp,
               wsum.data_ptr(), None, partial.data_ptr(), out.data_ptr(), N,
               D, L, 0, G, LOSSES[loss], 0, tr, nb, 0, 0, 0, plan["smem"][0],
               0, _stream(X))
        return out[:D].T.contiguous(), out[D]
    # wide: row-tile blocks of the X^T g pass share the card with its
    # feature chunks; g [N, lanes] round-trips through device memory
    chunks = -(-D // _DC_XTG) + 1           # + the ones column's blocks
    nb = max(1, min(-(-N // _TR_XTG), -(-_N_BLOCKS * 2 // chunks)))
    Lp = -(-lc // 4) * 4
    gbuf = torch.empty((N, Lp), dtype=torch.float32, device=dev)
    partial = torch.empty(((D + 1) * lc, nb), dtype=torch.float32,
                          device=dev)
    for l0 in range(0, L, lc):
        n_l = min(lc, L - l0)
        o = out if n_l == L else torch.empty((D + 1, n_l),
                                             dtype=torch.float32, device=dev)
        launch("fista_step", _ARGTYPES, X.data_ptr(), V[l0:].data_ptr(),
               muv[l0:].data_ptr(), b[l0:].data_ptr(), W.data_ptr(), yp,
               wsum[l0:].data_ptr(), gbuf.data_ptr(), partial.data_ptr(),
               o.data_ptr(), N, D, n_l, l0, G, LOSSES[loss], 1, tr, nb,
               _DC_MARGIN, _TR_XTG, _DC_XTG, *plan["smem"], _stream(X))
        if n_l != L:
            out[:, l0:l0 + n_l] = o
    return out[:D].T.contiguous(), out[D]


# --------------------------------------------------------------------------
# the multinomial (softmax) loss: fista_softmax
# --------------------------------------------------------------------------

SOFTMAX_WIDE_COLS = 32   # (lane, class) columns a launch of the wide form


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


def _softmax_tile_smem(D: int, L: int, C: int, tr: int) -> int:
    Jp = -(-L * C // 4) * 4
    return 4 * (tr * (D | 1) + tr * Jp + D * Jp + (D + 1) * Jp + 2 * Jp + L)


def _softmax_tile_rows(D: int, L: int, C: int) -> Optional[int]:
    for tr in (128, 64, 32):
        if _softmax_tile_smem(D, L, C, tr) <= _SMEM_MAX:
            return tr
    return None


def _softmax_tile(D: int, lanes: int, C: int, tr: int) -> dict:
    return {"form": "tile", "lanes": lanes, "TR": tr,
            "smem": (_softmax_tile_smem(D, lanes, C, tr),)}


def softmax_launch_plan(D: int, L: int, C: int) -> dict:
    """How ``fista_softmax`` launches for D features and L lanes of C
    classes: the one-tile form with every lane where X's row tile and all
    L·C coefficient columns fit one block's shared memory; else the wide
    two-pass form, ``SOFTMAX_WIDE_COLS // C`` lanes a launch (C ≤ 32: a
    lane's classes never straddle two launches); else the one-tile form
    with as many lanes a launch as fit.  Raises ValueError for a shape that
    fits no form.  Each form's shared memory in bytes is here, the one
    place that sizes it."""
    if C < 2 or L < 1 or D < 1:
        raise ValueError(f"fista_softmax: {L} lanes, {C} classes, {D} "
                         "features")
    tr = _softmax_tile_rows(D, L, C)
    if tr is not None:
        return _softmax_tile(D, L, C, tr)
    if C <= SOFTMAX_WIDE_COLS:
        lc = min(L, SOFTMAX_WIDE_COLS // C)
        Jp = -(-lc * C // 4) * 4
        trm = min(256, 512 // (Jp // 4)) // 32 * 32
        return {"form": "wide", "lanes": lc, "TR": trm,
                "smem": (4 * (trm * (_DC_MARGIN + 1) + _DC_MARGIN * Jp),
                         4 * (_TR_XTG * (_DC_XTG + 1) + _TR_XTG * Jp))}
    for lc in range(L - 1, 0, -1):
        tr = _softmax_tile_rows(D, lc, C)
        if tr is not None:
            return _softmax_tile(D, lc, C, tr)
    raise ValueError(f"fista_softmax: no launch form holds {C} classes at "
                     f"{D} features")


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
    wsum, returns (Xᵀ g [L, C, D], Σ_n g [L, C]).  The card's sums run in
    a fixed order: the same inputs give the same bits on every run."""
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
    lc, tr = plan["lanes"], plan["TR"]
    wide = plan["form"] == "wide"
    if wide:
        # row-tile blocks of the X^T g pass share the card with its feature
        # chunks; g [N, columns] round-trips through device memory
        chunks = -(-D // _DC_XTG) + 1
        nb = max(1, min(-(-N // _TR_XTG), -(-_N_BLOCKS * 2 // chunks)))
        gbuf = torch.empty((N, -(-lc * C // 4) * 4), dtype=torch.float32,
                           device=dev)
    else:
        nb = max(1, min(_N_BLOCKS, -(-N // tr)))
        gbuf = None
    partial = torch.empty(((D + 1) * lc * C, nb), dtype=torch.float32,
                          device=dev)
    gx = torch.empty((L, C, D), dtype=torch.float32, device=dev)
    gs = torch.empty((L, C), dtype=torch.float32, device=dev)
    smem = plan["smem"] + (0,)
    for l0 in range(0, L, lc):
        n_l = min(lc, L - l0)
        out = torch.empty((D + 1, n_l * C), dtype=torch.float32, device=dev)
        launch("fista_softmax", _ARGTYPES, X.data_ptr(),
               V[l0:].data_ptr(), muv[l0:].data_ptr(), b[l0:].data_ptr(),
               W.data_ptr(), y.data_ptr(), wsum[l0:].data_ptr(),
               None if gbuf is None else gbuf.data_ptr(), partial.data_ptr(),
               out.data_ptr(), N, D, n_l, C, l0, G, int(wide), tr, nb,
               _DC_MARGIN, _TR_XTG, _DC_XTG, smem[0], smem[1], _stream(X))
        gx[l0:l0 + n_l] = out[:D].T.reshape(n_l, C, D)
        gs[l0:l0 + n_l] = out[D].reshape(n_l, C)
    return gx, gs


# --------------------------------------------------------------------------
# the exp-link GLM losses (poisson, gamma): fista_glm
# --------------------------------------------------------------------------

GLM_LOSSES = {"poisson": 0, "gamma": 1}
_GLM_ARGTYPES = [_P] * 9 + [_L] + [_I] * 9 + [_P]


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


def _glm_smem(D: int, L: int, tr: int, grad: bool) -> int:
    Lp = -(-L // 4) * 4
    floats = tr * (D | 1) + tr * Lp + D * Lp + 3 * Lp
    if grad:
        floats += tr * Lp + (D + 1) * Lp
    return 4 * floats


def glm_launch_plan(D: int, L: int, grad: bool) -> dict:
    """How ``fista_glm`` launches for D features and L lanes: X's row tile
    (``TR`` rows), the lanes' coefficients, per-(row slot, lane) loss sums
    and, in the gradient form, the tile's gradients and the block's Xᵀg
    sums in one block's shared memory.  Takes every lane in one launch with
    the largest tile that fits, else fewer lanes a launch, else smaller
    tiles; raises ValueError when not even one lane fits at 4 rows (past
    about 7,200 features, 4,800 in the gradient form).  The one place that
    sizes the launch's shared memory."""
    if L < 1 or D < 1:
        raise ValueError(f"fista_glm: {L} lanes, {D} features")
    chunks = [L] + [c for c in (32, 16, 8, 4, 2, 1) if c < L]
    for trs in ((128, 64, 32), (16, 8, 4)):
        for lc in chunks:
            for tr in trs:
                smem = _glm_smem(D, lc, tr, grad)
                if smem <= _SMEM_MAX:
                    return {"lanes": lc, "TR": tr, "smem": smem}
    raise ValueError(f"fista_glm: no launch form holds one lane at {D} "
                     "features")


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
    lc, tr = plan["lanes"], plan["TR"]
    nb = max(1, min(_N_BLOCKS, -(-N // tr)))
    rows = ((D + 2) if grad else 1) * lc
    partial = torch.empty((rows, nb), dtype=torch.float32, device=dev)
    gx = torch.empty((L, D), dtype=torch.float32, device=dev)
    gs = torch.empty((L,), dtype=torch.float32, device=dev)
    val = torch.empty((L,), dtype=torch.float32, device=dev)
    for l0 in range(0, L, lc):
        n_l = min(lc, L - l0)
        out = torch.empty(((D + 2) * n_l if grad else n_l,),
                          dtype=torch.float32, device=dev)
        launch("fista_glm", _GLM_ARGTYPES, X.data_ptr(), V[l0:].data_ptr(),
               muv[l0:].data_ptr(), b[l0:].data_ptr(), W.data_ptr(),
               y.data_ptr(), wsum[l0:].data_ptr(), partial.data_ptr(),
               out.data_ptr(), N, D, n_l, l0, G, GLM_LOSSES[loss], int(grad),
               tr, nb, plan["smem"], _stream(X))
        if grad:
            xtg = out[:(D + 1) * n_l].reshape(D + 1, n_l)
            gx[l0:l0 + n_l] = xtg[:D].T
            gs[l0:l0 + n_l] = xtg[D]
        val[l0:l0 + n_l] = out[-n_l:]
    val = val / wsum
    return (gx, gs, val) if grad else val
