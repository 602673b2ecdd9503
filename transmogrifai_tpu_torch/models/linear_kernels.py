"""The linear family's kernel: ``fista_step``, its wrapper and its
plain-PyTorch twin (the dispatch rule and launch counters are in
``kernels.py``).

| kernel     | replaces (transmogrifai_tpu/models/solvers.py)                     |
|------------|--------------------------------------------------------------------|
| fista_step | ``_fista_loop``'s ``smooth_grad`` with ``xs_mv`` / ``xs_tmv`` (:160-166, :270-286); the product of ``_spectral_norm_sq_weighted`` (:112-131) |
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .kernels import check as _check, launch, stream as _stream

LOSSES = {"logistic": 0, "squared_hinge": 1, "gram": 2}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 9 + [_L] + [_I] * 7 + [_P]
_SMEM_MAX = 227 * 1024
_N_BLOCKS = 132 * 4


def fista_row_grads(X, V, muv, b, W, y, wsum, G: int, loss: str):
    """The per-row gradients g [L, N] of ``fista_step`` (see
    :func:`fista_step`), in plain PyTorch."""
    lane_fold = torch.arange(V.shape[0], device=X.device) // G
    Wl = W[lane_fold]
    lin = V @ X.T - muv[:, None] + b[:, None]
    ws = wsum[:, None]
    if loss == "logistic":
        return Wl * (torch.sigmoid(lin) - y) / ws
    if loss == "squared_hinge":
        viol = torch.clamp(1.0 - y * lin, min=0.0)
        return Wl * (-2.0 * viol * y) / ws
    return (Wl / ws) * lin


def fista_step_twin(X, V, muv, b, W, y, wsum, G: int, loss: str):
    """Plain-PyTorch twin of ``fista_step`` (see :func:`fista_step`): the
    two matmuls per evaluation the JAX package leaves to XLA."""
    g = fista_row_grads(X, V, muv, b, W, y, wsum, G, loss)
    return g @ X, g.sum(dim=1)


def _tile_rows(D: int, L: int) -> Optional[int]:
    """Rows per tile (a multiple of 32, at most 128) whose shared memory
    fits one block; None when not even 32 rows fit."""
    Lp = -(-L // 4) * 4
    fixed = D * Lp + (D + 1) * Lp + 3 * Lp
    for tr in (128, 64, 32):
        if 4 * (tr * (D | 1) + tr * Lp + fixed) <= _SMEM_MAX:
            return tr
    return None


def fista_step(X: torch.Tensor, V: torch.Tensor, muv: torch.Tensor,
               b: torch.Tensor, W: torch.Tensor, y: Optional[torch.Tensor],
               wsum: torch.Tensor, G: int, loss: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gradient evaluation of FISTA for L lanes over one X.

    X f32 [N, D]; V f32 [L, D] the lanes' scaled coefficients (coef /
    scale); muv f32 [L] = mean · V; b f32 [L] intercepts; W f32 [F, N] fold
    row weights, lane l reading fold ``l // G``; y f32 [N] the loss target
    (0/1 logistic, ±1 squared hinge; ignored by "gram"); wsum f32 [L].  With
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
    # lanes per launch: all of them unless a wide matrix needs smaller tiles
    Lc = L
    while _tile_rows(D, Lc) is None and Lc > 4:
        Lc = max(4, Lc // 2)
    TR = _tile_rows(D, Lc)
    if TR is None:
        raise ValueError(f"fista_step: {D} features do not fit the kernel's "
                         "shared-memory tile")
    nb = max(1, min(_N_BLOCKS, -(-N // TR)))
    out = torch.empty((D + 1, L), dtype=torch.float32, device=dev)
    partial = torch.empty(((D + 1) * Lc, nb), dtype=torch.float32,
                          device=dev)
    yp = (X if y is None else y).data_ptr()
    for l0 in range(0, L, Lc):
        lc = min(Lc, L - l0)
        o = out if lc == L else torch.empty((D + 1, lc), dtype=torch.float32,
                                            device=dev)
        launch("fista_step", _ARGTYPES, X.data_ptr(), V[l0:].data_ptr(),
               muv[l0:].data_ptr(), b[l0:].data_ptr(), W.data_ptr(), yp,
               wsum[l0:].data_ptr(), partial.data_ptr(), o.data_ptr(), N, D,
               lc, l0, G, LOSSES[loss], TR, nb, _stream(X))
        if lc != L:
            out[:, l0:l0 + lc] = o
    return out[:D].T.contiguous(), out[D]
