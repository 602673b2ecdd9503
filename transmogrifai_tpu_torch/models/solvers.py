"""Full-batch dense solver for the linear family (port of the dense logistic
and squared-hinge paths of ``transmogrifai_tpu/models/solvers.py``).

The JAX package vmaps a per-lane ``lax.while_loop`` over the (fold × grid)
lanes, so a lane that meets its tolerance freezes while the others run.  The
port runs all F×G lanes as ONE batched loop of ``max_iter`` iterations: every
iteration updates every lane, and a per-lane freeze mask on the device keeps
a finished lane's state (and its ``n_iter``) exactly where its own loop
stopped, so no iteration waits on the host to ask whether any lane is left.

X enters only through the implicitly standardized products
``Xs @ v = X @ (v/scale) - mu·(v/scale)`` and ``Xsᵀ @ g``, so every lane
shares the one device-resident X (the standardized copy never exists).  Each
gradient evaluation, and each product of the power iteration, is one
``fista_step`` (``linear_kernels.py``): on the card a kernel that reads X
once for all lanes, on the CPU its matmul twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linear_kernels import fista_step

# Lipschitz constant of d²loss/dmargin² per row (≙ ``_LOSS_CURVATURE``)
_LOSS_CURVATURE = {"logistic": 0.25, "squared_hinge": 2.0}


class FitResult(NamedTuple):
    coef: torch.Tensor       # [F, G, D]
    intercept: torch.Tensor  # [F, G, 1]
    n_iter: torch.Tensor     # [F, G] int32


def standardize_moments(X: torch.Tensor, W: torch.Tensor, center: bool):
    """Weighted standardisation moments per weight row: W [F, N] →
    (mean, scale) [F, D] (≙ ``standardize_moments``)."""
    w = W / W.sum(dim=1, keepdim=True)
    mean = w @ X
    var = w @ (X * X) - mean * mean
    scale = torch.sqrt(torch.clamp(var, min=1e-12))
    mu = mean if center else torch.zeros_like(mean)
    return mu, scale


def loss_target(loss: str, y: torch.Tensor) -> torch.Tensor:
    """The loss's target from 0/1 labels: ±1 for the squared hinge (≙
    ``_loss_target``, solvers.py:134-141)."""
    if loss == "squared_hinge":
        return torch.where(y > 0.5, 1.0, -1.0).to(torch.float32)
    return y.to(torch.float32)


def _spectral_norm_sq_weighted(X, W, wsum, mean, scale, iters: int = 16):
    """λ_max of Xsᵀ diag(W/wsum) Xs per fold by power iteration, for the
    implicitly standardized Xs (≙ ``_spectral_norm_sq_weighted``,
    solvers.py:112-131).  W [F, N] fold weights, wsum [F]; → [F]."""
    d = X.shape[1]
    v = torch.full((W.shape[0], d), 1.0 / float(d) ** 0.5,
                   dtype=torch.float32, device=X.device)
    zero = torch.zeros_like(wsum)

    def mv(v):
        vs = v / scale
        gx, gs = fista_step(X, vs, (mean * vs).sum(dim=1), zero, W, None,
                            wsum, 1, "gram")
        return (gx - mean * gs[:, None]) / scale

    for _ in range(iters):
        u = mv(v)
        v = u / (torch.linalg.vector_norm(u, dim=1, keepdim=True) + 1e-12)
    return (v * mv(v)).sum(dim=1)


class FistaState(NamedTuple):
    coef: torch.Tensor     # [L, D]
    inter: torch.Tensor    # [L]
    zc: torch.Tensor       # [L, D] extrapolated point
    zi: torch.Tensor       # [L]
    t: torch.Tensor        # [L] momentum
    k: torch.Tensor        # [L] int32 iterations taken
    active: torch.Tensor   # [L] bool: not yet within tol


class FistaLoop:
    """FISTA with adaptive restart for L lanes at once (≙ ``_fista_loop``,
    solvers.py:143-289, for the dense "logistic" and "squared_hinge"
    losses).  Lane l trains on fold row ``W[l // G]`` with penalties l2[l],
    l1[l] and standardisation mu[l], sc[l]; it minimises
    mean_loss(Xs w + b) + l2/2 ||w||² + l1 ||w||₁ in the standardized
    basis.  ``step`` is one iteration of every lane; a lane whose update
    moved less than ``tol`` is frozen from then on."""

    def __init__(self, X, target, W, G: int, l2, l1, mu, sc, sigma_sq, *,
                 loss: str, fit_intercept: bool, tol: float):
        if loss not in _LOSS_CURVATURE:
            raise ValueError(f"FistaLoop: loss {loss!r}")
        self.X, self.target, self.W, self.G = X, target, W, G
        self.mu, self.sc, self.loss, self.tol = mu, sc, loss, tol
        self.fit_intercept = fit_intercept
        lane_fold = torch.arange(mu.shape[0], device=X.device) // G
        self.wsum = W.sum(dim=1)[lane_fold]
        self.step_size = (1.0 / torch.clamp(
            _LOSS_CURVATURE[loss] * sigma_sq + l2, min=1e-12))[:, None]
        self.l2c, self.l1c = l2[:, None], l1[:, None]

    def start(self) -> FistaState:
        L, d = self.mu.shape
        dev = self.X.device
        coef = torch.zeros((L, d), dtype=torch.float32, device=dev)
        inter = torch.zeros((L,), dtype=torch.float32, device=dev)
        return FistaState(coef, inter, coef.clone(), inter.clone(),
                          torch.ones((L,), dtype=torch.float32, device=dev),
                          torch.zeros((L,), dtype=torch.int32, device=dev),
                          torch.ones((L,), dtype=torch.bool, device=dev))

    def step(self, s: FistaState) -> FistaState:
        mu, sc, step = self.mu, self.sc, self.step_size
        v = s.zc / sc
        gx, g_i = fista_step(self.X, v, (mu * v).sum(dim=1), s.zi, self.W,
                             self.target, self.wsum, self.G, self.loss)
        g_c = (gx - mu * g_i[:, None]) / sc + self.l2c * s.zc
        u = s.zc - step * g_c
        new_c = torch.sign(u) * torch.clamp(torch.abs(u) - step * self.l1c,
                                            min=0.0)
        new_i = s.zi - step[:, 0] * g_i if self.fit_intercept else s.zi
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * s.t * s.t))
        beta = (s.t - 1.0) / t_new
        # adaptive restart on a non-descent direction
        restart = ((s.zc - new_c) * (new_c - s.coef)).sum(dim=1) > 0.0
        beta = torch.where(restart, 0.0, beta)
        t_new = torch.where(restart, 1.0, t_new)
        zc_next = new_c + beta[:, None] * (new_c - s.coef)
        zi_next = new_i + beta * (new_i - s.inter)
        delta = (torch.abs(new_c - s.coef).amax(dim=1)
                 + torch.abs(new_i - s.inter))
        # frozen lanes keep the state their own loop stopped at
        a, act = s.active[:, None], s.active
        return FistaState(torch.where(a, new_c, s.coef),
                          torch.where(act, new_i, s.inter),
                          torch.where(a, zc_next, s.zc),
                          torch.where(act, zi_next, s.zi),
                          torch.where(act, t_new, s.t),
                          s.k + act.to(torch.int32),
                          act & (delta > self.tol))


def fista_fit(loop: FistaLoop, max_iter: int) -> FistaState:
    """``max_iter`` iterations of every lane.  A lane that froze earlier is
    held by ``torch.where`` in each later iteration, so running them all
    returns exactly what stopping when no lane is active would (the
    iterations after that change no value), without asking the host
    whether any lane is left."""
    s = loop.start()
    for _ in range(max_iter):
        s = loop.step(s)
    return s


def unscale_params(coef, intercept, mean, scale):
    """Standardized-basis (coef, intercept) → raw-feature basis."""
    c = coef / scale
    return c, intercept - (mean * c).sum(dim=-1)


def linear_grid_fit(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
                    l2s: torch.Tensor, l1s: torch.Tensor, *,
                    loss: str = "logistic", fit_intercept: bool = True,
                    standardization: bool = True, max_iter: int = 100,
                    tol: float = 1e-6) -> FitResult:
    """The whole (fold × grid-point) CV block of a binary linear loss
    (≙ ``linear_grid_fit``, solvers.py:334-376): W [F, N] fold weights,
    l2s/l1s [G] → FitResult with [F, G, ...] leaves.  Moments and λ_max are
    per fold, shared by the fold's grid lanes; lane f·G + g is grid point g
    on fold f."""
    F, G = W.shape[0], l2s.shape[0]
    d = X.shape[1]
    if standardization:
        mean, scale = standardize_moments(X, W, center=fit_intercept)
    else:
        mean = torch.zeros((F, d), dtype=torch.float32, device=X.device)
        scale = torch.ones((F, d), dtype=torch.float32, device=X.device)
    sigma_sq = _spectral_norm_sq_weighted(X, W, W.sum(dim=1), mean, scale)

    def lanes(a):       # per-fold [F, ...] → per-lane [F*G, ...]
        return a.repeat_interleave(G, dim=0)

    loop = FistaLoop(X, loss_target(loss, y), W, G, l2s.repeat(F),
                     l1s.repeat(F), lanes(mean), lanes(scale),
                     lanes(sigma_sq), loss=loss, fit_intercept=fit_intercept,
                     tol=tol)
    s = fista_fit(loop, max_iter)
    coef, inter = unscale_params(s.coef, s.inter, lanes(mean), lanes(scale))
    return FitResult(coef.reshape(F, G, d), inter.reshape(F, G, 1),
                     s.k.reshape(F, G))
