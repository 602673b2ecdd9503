"""Full-batch solvers for the linear family (port of the logistic,
squared-hinge, squared-loss, (dense) multinomial and (dense) poisson and
gamma paths of ``transmogrifai_tpu/models/solvers.py``, dense and sparse,
of its closed-form ridge and of its naive Bayes).

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
once for all lanes, on the CPU its matmul twin.  The multinomial loss
("softmax") keeps C coefficient rows a lane (coef [L, C, D]) and takes its
gradients from ``fista_softmax_step``; its restart test and stop rule
reduce over all of a lane's classes, as the JAX package's do.

The exp-link losses ("poisson", "gamma") have no curvature bound, so their
step is per-lane state, carried from one iteration to the next and never
grown (Beck–Teboulle backtracking, ≙ solvers.py:189-215): each iteration
takes the first of s, s/2, s/4, ... (at most 30 halvings) at which the
smooth part lies under its quadratic model at z.  The port tests a ladder
of ``LADDER`` such trial steps in one ``fista_glm`` value pass (one lane
per (lane, trial step)) and takes each lane's first passing rung, which is
the step the sequential rule accepts; only when some active lane passes no
rung does the host learn of it and test the next ladder.

A ``SparseMatrix`` X runs the same loop: only the gradient seam differs
(``grad_seam``: ``sp_matmat`` margins and ``sp_rmatmat`` products over all
lanes), and standardisation is scale only — the mean stays zero, since
centring would densify every row (≙ ``sparse_linear_grid_fit``,
solvers.py:469-578).

Ridge (squared loss with no l1 penalty) is closed form, in plain PyTorch:
one weighted Gram per fold and an f32 Cholesky solve per grid point
(:func:`ridge_grid_fit`, :func:`ridge_fit`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .linear_kernels import GLM_LOSSES, fista_glm, grad_seam

# Lipschitz constant of d²loss/dmargin² per row (≙ ``_LOSS_CURVATURE``);
# for the exp-link losses only the first step's guess
_LOSS_CURVATURE = {"logistic": 0.25, "squared_hinge": 2.0, "squared": 1.0,
                   "softmax": 0.5, "poisson": 1.0, "gamma": 1.0}
LADDER = 8              # trial steps a backtracking value pass tests
MAX_HALVINGS = 30       # ≙ the JAX loop's ``it < 30``


class FitResult(NamedTuple):
    coef: torch.Tensor       # [F, G, D]; softmax [F, G, D, C]
    intercept: torch.Tensor  # [F, G, 1]; softmax [F, G, C]
    n_iter: torch.Tensor     # [F, G] int32
    # [F, G] int32: step halvings over the run (the exp-link losses)
    halvings: Optional[torch.Tensor] = None


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
    """The loss's target: int32 class ids for the multinomial loss (the
    kernel's one-hot), ±1 from 0/1 labels for the squared hinge, the
    labels themselves otherwise (≙ ``_loss_target``, solvers.py:133-140)."""
    if loss == "softmax":
        return y.to(torch.int32)
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
    grad = grad_seam(X)

    def mv(v):
        vs = v / scale
        gx, gs = grad(X, vs, (mean * vs).sum(dim=1), zero, W, None, wsum, 1,
                      "gram")
        return (gx - mean * gs[:, None]) / scale

    for _ in range(iters):
        u = mv(v)
        v = u / (torch.linalg.vector_norm(u, dim=1, keepdim=True) + 1e-12)
    return (v * mv(v)).sum(dim=1)


class FistaState(NamedTuple):
    coef: torch.Tensor     # [L, D]; softmax [L, C, D]
    inter: torch.Tensor    # [L]; softmax [L, C]
    zc: torch.Tensor       # like coef: the extrapolated point
    zi: torch.Tensor       # like inter
    t: torch.Tensor        # [L] momentum
    k: torch.Tensor        # [L] int32 iterations taken
    active: torch.Tensor   # [L] bool: not yet within tol
    step: torch.Tensor     # [L] the step (carried by backtracking lanes)
    halvings: torch.Tensor  # [L] int32 step halvings so far


class FistaLoop:
    """FISTA with adaptive restart for L lanes at once (≙ ``_fista_loop``,
    solvers.py:143-289, for the "logistic", "squared_hinge", "squared",
    "softmax", "poisson" and "gamma" losses).  Lane l trains on fold row
    ``W[l // G]`` with penalties l2[l], l1[l] and standardisation mu[l],
    sc[l]; it minimises mean_loss(Xs w + b) + l2/2 ||w||² + l1 ||w||₁ in
    the standardized basis.  ``step`` is one iteration of every lane; a
    lane whose update moved less than ``tol`` (max |Δcoef| + max
    |Δintercept| over its classes) is frozen from then on.  The poisson and
    gamma losses backtrack (:meth:`_backtrack`)."""

    def __init__(self, X, target, W, G: int, l2, l1, mu, sc, sigma_sq, *,
                 loss: str, fit_intercept: bool, tol: float,
                 n_classes: int = 1):
        if loss not in _LOSS_CURVATURE:
            raise ValueError(f"FistaLoop: loss {loss!r}")
        self.C = n_classes if loss == "softmax" else 1
        if loss == "softmax" and self.C < 2:
            raise ValueError("FistaLoop: the softmax loss needs n_classes")
        self.X, self.target, self.W, self.G = X, target, W, G
        self.loss, self.tol = loss, tol
        self.grad = grad_seam(X, loss)
        self.fit_intercept = fit_intercept
        lane_fold = torch.arange(mu.shape[0], device=X.device) // G
        self.wsum = W.sum(dim=1)[lane_fold]
        step = 1.0 / torch.clamp(_LOSS_CURVATURE[loss] * sigma_sq + l2,
                                 min=1e-12)
        # per-lane values broadcast against coef ([L, D] or [L, C, D]) and
        # against the intercepts ([L] or [L, C])
        multi = self.C > 1
        self._c = ((lambda a: a[:, None, None]) if multi
                   else (lambda a: a[:, None]))
        self._i = (lambda a: a[:, None]) if multi else (lambda a: a)
        self.mu = mu[:, None, :] if multi else mu
        self.sc = sc[:, None, :] if multi else sc
        self.step0, self.l2, self.l1 = step, l2, l1
        self.l2c, self.l1c = self._c(l2), self._c(l1)
        self.backtrack = loss in GLM_LOSSES

    def start(self) -> FistaState:
        L, d = self.mu.shape[0], self.mu.shape[-1]
        dev = self.X.device
        cshape = (L, self.C, d) if self.C > 1 else (L, d)
        coef = torch.zeros(cshape, dtype=torch.float32, device=dev)
        inter = torch.zeros(cshape[:-1], dtype=torch.float32, device=dev)
        zeros = torch.zeros((L,), dtype=torch.int32, device=dev)
        return FistaState(coef, inter, coef.clone(), inter.clone(),
                          torch.ones((L,), dtype=torch.float32, device=dev),
                          zeros,
                          torch.ones((L,), dtype=torch.bool, device=dev),
                          self.step0.clone(), zeros.clone())

    def _attempt(self, zc, zi, g_c, g_i, step, l1):
        """The proximal step from z at ``step`` (≙ ``attempt``,
        solvers.py:182-185); ``step`` and ``l1`` broadcast against zc."""
        u = zc - step * g_c
        new_c = torch.sign(u) * torch.clamp(torch.abs(u) - step * l1,
                                            min=0.0)
        return new_c, (zi - step[..., 0] * g_i if self.fit_intercept else zi)

    def _backtrack(self, s: FistaState, f_z, g_c, g_i) -> torch.Tensor:
        """Each lane's halvings of its carried step this iteration (≙ the
        backtracking loop, solvers.py:189-215): the first t in 0..30 at
        which the smooth part at the proximal step from z with step s·2^-t
        lies under its quadratic model, f(new) <= f(z) + <Δ, g> +
        |Δ|²/(2·s·2^-t) + 1e-12, else 30.  A ladder of trial steps is one
        ``fista_glm`` value pass; the next ladder runs only while some
        active lane has passed no rung.  Frozen lanes halve nothing."""
        L, d = s.zc.shape
        dev = s.zc.device
        unresolved = s.active.clone()
        taken = torch.zeros((L,), dtype=torch.int32, device=dev)
        t0 = 0
        while True:
            R = min(LADDER, MAX_HALVINGS + 1 - t0)
            t = torch.arange(t0, t0 + R, device=dev)
            steps = s.step[:, None] * torch.exp2(-t.to(torch.float32))[None]
            nc, ni = self._attempt(s.zc[:, None], s.zi[:, None],
                                   g_c[:, None], g_i[:, None],
                                   steps[..., None], self.l1[:, None, None])
            ni = ni.expand(L, R)
            dc, di = nc - s.zc[:, None], ni - s.zi[:, None]
            quad = (f_z[:, None] + (dc * g_c[:, None]).sum(dim=-1)
                    + di * g_i[:, None]
                    + ((dc * dc).sum(dim=-1) + di * di) / (2.0 * steps))
            mu = self.mu[:, None].expand(L, R, d)
            v = (nc / self.sc[:, None]).reshape(L * R, d)
            val = fista_glm(self.X, v, (mu.reshape(L * R, d) * v).sum(
                dim=-1), ni.reshape(L * R).contiguous(), self.W, self.target,
                self.wsum.repeat_interleave(R), self.G * R, self.loss,
                grad=False).reshape(L, R)
            ok = (val + 0.5 * self.l2[:, None] * (nc * nc).sum(dim=-1)
                  <= quad + 1e-12)
            hit = ok.any(dim=1)
            first = torch.argmax(ok.to(torch.int32), dim=1).to(torch.int32)
            taken = torch.where(unresolved & hit, t0 + first, taken)
            unresolved &= ~hit
            t0 += R
            if t0 > MAX_HALVINGS:
                return torch.where(unresolved, MAX_HALVINGS, taken)
            if not bool(unresolved.any()):
                return taken

    def step(self, s: FistaState) -> FistaState:
        mu, sc = self.mu, self.sc
        v = s.zc / sc
        out = self.grad(self.X, v, (mu * v).sum(dim=-1), s.zi, self.W,
                        self.target, self.wsum, self.G, self.loss)
        gx, g_i = out[:2]
        g_c = (gx - mu * g_i[..., None]) / sc + self.l2c * s.zc
        halv = torch.zeros_like(s.halvings)
        step = s.step
        if self.backtrack:
            f_z = out[2] + 0.5 * self.l2 * (s.zc * s.zc).sum(dim=-1)
            halv = self._backtrack(s, f_z, g_c, g_i)
            step = s.step * torch.exp2(-halv.to(torch.float32))
        new_c, new_i = self._attempt(s.zc, s.zi, g_c, g_i, self._c(step),
                                     self.l1c)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * s.t * s.t))
        beta = (s.t - 1.0) / t_new
        # adaptive restart on a non-descent direction
        restart = ((s.zc - new_c) * (new_c - s.coef)).flatten(1).sum(
            dim=1) > 0.0
        beta = torch.where(restart, 0.0, beta)
        t_new = torch.where(restart, 1.0, t_new)
        zc_next = new_c + self._c(beta) * (new_c - s.coef)
        zi_next = new_i + self._i(beta) * (new_i - s.inter)
        d_i = torch.abs(new_i - s.inter)
        delta = (torch.abs(new_c - s.coef).flatten(1).amax(dim=1)
                 + (d_i.amax(dim=1) if self.C > 1 else d_i))
        # frozen lanes keep the state their own loop stopped at
        a, ai, act = self._c(s.active), self._i(s.active), s.active
        return FistaState(torch.where(a, new_c, s.coef),
                          torch.where(ai, new_i, s.inter),
                          torch.where(a, zc_next, s.zc),
                          torch.where(ai, zi_next, s.zi),
                          torch.where(act, t_new, s.t),
                          s.k + act.to(torch.int32),
                          act & (delta > self.tol),
                          torch.where(act, step, s.step),
                          s.halvings + torch.where(act, halv, 0))


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


def unscale_params(coef, intercept, mean, scale, n_classes: int = 1):
    """Standardized-basis (coef, intercept) → raw-feature basis (≙
    ``unscale_params``, solvers.py:580-588).  coef [..., D] with mean and
    scale [..., D]; with ``n_classes`` > 1, coef [..., D, C] and intercept
    [..., C]."""
    if n_classes > 1:
        c = coef / scale[..., :, None]
        return c, intercept - (mean[..., :, None] * c).sum(dim=-2)
    c = coef / scale
    return c, intercept - (mean * c).sum(dim=-1)


def linear_grid_fit(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
                    l2s: torch.Tensor, l1s: torch.Tensor, *,
                    loss: str = "logistic", fit_intercept: bool = True,
                    standardization: bool = True, max_iter: int = 100,
                    tol: float = 1e-6, n_classes: int = 1) -> FitResult:
    """The whole (fold × grid-point) CV block of a linear loss
    (≙ ``linear_grid_fit``, solvers.py:334-376): W [F, N] fold weights,
    l2s/l1s [G] → FitResult with [F, G, ...] leaves.  Moments and λ_max are
    per fold, shared by the fold's grid lanes; lane f·G + g is grid point g
    on fold f.  ``loss="softmax"`` fits ``n_classes`` classes (y holds
    class ids): coef [F, G, D, C], intercept [F, G, C]."""
    F, d = W.shape[0], X.shape[1]
    if standardization:
        mean, scale = standardize_moments(X, W, center=fit_intercept)
    else:
        mean = torch.zeros((F, d), dtype=torch.float32, device=X.device)
        scale = torch.ones((F, d), dtype=torch.float32, device=X.device)
    return _grid_fit(X, y, W, l2s, l1s, mean, scale, loss=loss,
                     fit_intercept=fit_intercept, max_iter=max_iter, tol=tol,
                     n_classes=n_classes)


def _grid_fit(X, y, W, l2s, l1s, mean, scale, *, loss: str,
              fit_intercept: bool, max_iter: int, tol: float,
              n_classes: int = 1) -> FitResult:
    """The (fold × grid) FISTA block given per-fold moments [F, D]: λ_max
    per fold, the lanes' loop, and the coefficients unscaled."""
    F, G, d = W.shape[0], l2s.shape[0], X.shape[1]
    sigma_sq = _spectral_norm_sq_weighted(X, W, W.sum(dim=1), mean, scale)

    def lanes(a):       # per-fold [F, ...] → per-lane [F*G, ...]
        return a.repeat_interleave(G, dim=0)

    loop = FistaLoop(X, loss_target(loss, y), W, G, l2s.repeat(F),
                     l1s.repeat(F), lanes(mean), lanes(scale),
                     lanes(sigma_sq), loss=loss, fit_intercept=fit_intercept,
                     tol=tol, n_classes=n_classes)
    s = fista_fit(loop, max_iter)
    if loop.C > 1:      # [L, C, D] → the JAX package's [D, C] layout
        coef, inter = unscale_params(s.coef.transpose(1, 2), s.inter,
                                     lanes(mean), lanes(scale), loop.C)
        return FitResult(coef.reshape(F, G, d, loop.C),
                         inter.reshape(F, G, loop.C), s.k.reshape(F, G))
    coef, inter = unscale_params(s.coef, s.inter, lanes(mean), lanes(scale))
    return FitResult(coef.reshape(F, G, d), inter.reshape(F, G, 1),
                     s.k.reshape(F, G),
                     s.halvings.reshape(F, G) if loop.backtrack else None)


def naive_bayes_fit(X: torch.Tensor, y: torch.Tensor,
                    sample_weight: torch.Tensor, smoothing: float, *,
                    n_classes: int):
    """Multinomial naive Bayes (≙ ``naive_bayes_fit``, solvers.py:319-333):
    class-conditional log likelihoods from the weighted per-class sums of
    the non-negative parts of the features.  Returns (log_prior [C],
    log_prob [C, D])."""
    yoh = torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32)
    w = sample_weight.to(torch.float32)
    cls_count = w @ yoh
    feat_count = (yoh * w[:, None]).T @ torch.clamp(X, min=0.0)
    log_prior = (torch.log(cls_count + 1e-12)
                 - torch.log(cls_count.sum() + 1e-12))
    sm = feat_count + smoothing
    log_prob = torch.log(sm) - torch.log(sm.sum(dim=1, keepdim=True))
    return log_prior, log_prob


def ridge_fit(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
              l2: float, *, fit_intercept: bool = True) -> FitResult:
    """Closed-form weighted ridge regression by its normal equations (≙
    ``ridge_fit``, solvers.py:293-316): with the weighted means removed,
    (Xcᵀ W Xc / Σw + l2·I) coef = Xcᵀ W yc / Σw, solved by an f32
    Cholesky.  Returns coef [D], intercept [1], n_iter 0."""
    d = X.shape[1]
    w = sample_weight.to(torch.float32)
    wsum = w.sum()
    if fit_intercept:
        xm = (w @ X) / wsum
        ym = (w * y).sum() / wsum
        Xc, yc = X - xm, y - ym
    else:
        Xc, yc = X, y
    Xw = Xc * w[:, None]
    A = (Xc.T @ Xw) / wsum + l2 * torch.eye(d, dtype=torch.float32,
                                            device=X.device)
    b = (Xw.T @ yc) / wsum
    coef = torch.cholesky_solve(b[:, None], torch.linalg.cholesky(A))[:, 0]
    intercept = (ym - xm @ coef if fit_intercept
                 else torch.zeros((), dtype=torch.float32, device=X.device))
    return FitResult(coef, intercept.reshape(1),
                     torch.zeros((), dtype=torch.int32, device=X.device))


def ridge_grid_fit(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
                   l2s: torch.Tensor, *, fit_intercept: bool = True,
                   standardization: bool = True) -> FitResult:
    """Closed-form ridge over the (fold × l2-grid) block (≙
    ``ridge_grid_fit``, solvers.py:381-444), the l1 = 0 path of
    ``OpLinearRegression``: W [F, N] fold weights, l2s [G] → FitResult with
    [F, G, ...] leaves.

    With an intercept, X is first shifted by its global column means (one
    [N, D] copy): centring a raw Gram algebraically would cancel
    catastrophically in f32 for features of large mean.  Each fold then
    takes one weighted Gram (XᵀWX)/Σw, is centred by its weighted mean and
    standardised on those O(variance) entries, and every grid point is one
    f32 Cholesky solve of the fold's standardised system.  The folds run one
    after another, each with one [N, D] weighted scratch, as the JAX
    package's ``lax.map`` does."""
    F, d = W.shape[0], X.shape[1]
    dev = X.device
    if fit_intercept:
        g = X.mean(dim=0)
        X = X - g
    else:
        g = torch.zeros(d, dtype=torch.float32, device=dev)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    coefs, inters = [], []
    for f in range(F):
        w = W[f]
        s = w.sum()
        Xw = X * w[:, None]                       # the fold's scratch [N, D]
        G = (X.T @ Xw) / s
        p = (X.T @ (w * y)) / s
        m = (w @ X) / s
        ym = (w * y).sum() / s
        del Xw
        if standardization:
            scale = torch.sqrt(torch.clamp(torch.diagonal(G) - m * m,
                                           min=1e-12))
        else:
            scale = torch.ones(d, dtype=torch.float32, device=dev)
        if fit_intercept:
            Gc, bc, y0, mean_u = G - torch.outer(m, m), p - m * ym, ym, m
        else:
            Gc, bc = G, p
            y0 = torch.zeros((), dtype=torch.float32, device=dev)
            mean_u = torch.zeros(d, dtype=torch.float32, device=dev)
        A0 = Gc / (scale[:, None] * scale[None, :])
        b = bc / scale
        A = A0[None] + l2s[:, None, None] * eye               # [G, D, D]
        coef = torch.cholesky_solve(
            b[None, :, None].expand(A.shape[0], d, 1).contiguous(),
            torch.linalg.cholesky(A))[..., 0]                  # [G, D]
        c, inter = unscale_params(coef, y0.expand(A.shape[0]), mean_u, scale)
        coefs.append(c)
        inters.append(inter - c @ g)      # undo the global shift
    return FitResult(torch.stack(coefs), torch.stack(inters)[..., None],
                     torch.zeros((F, l2s.shape[0]), dtype=torch.int32,
                                 device=dev))


def _sp_col_scale(X, W: torch.Tensor) -> torch.Tensor:
    """Weighted per-column scale sqrt(E[x²] - E[x]²) per fold row of W
    [F, N] → [F, D], from the stored entries only: two ``sp_rmatmat``
    products (values and values² against the normalised weights) (≙
    ``_sp_col_scale``, solvers.py:469-481).  Absent columns clamp to scale
    1e-6 and their coefficients stay 0."""
    wn = (W / W.sum(dim=1, keepdim=True)).T.contiguous()
    mean = X.rmatmat(wn).T
    ex2 = X.elementwise(torch.square).rmatmat(wn).T
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    return torch.sqrt(torch.clamp(var, min=1e-12))


def sparse_linear_grid_fit(X, y: torch.Tensor, W: torch.Tensor,
                           l2s: torch.Tensor, l1s: torch.Tensor, *,
                           loss: str = "logistic", fit_intercept: bool = True,
                           standardization: bool = True, max_iter: int = 100,
                           tol: float = 1e-6) -> FitResult:
    """``linear_grid_fit`` for a ``SparseMatrix`` X (≙
    ``sparse_linear_grid_fit``, solvers.py:502-559): every lane shares the
    one device-resident entry stream, nothing is ever [N, D].
    Standardisation is scale only (``_sp_col_scale``), the mean zero; the
    coefficients come back unscaled."""
    F, d = W.shape[0], X.shape[1]
    mean = torch.zeros((F, d), dtype=torch.float32, device=X.device)
    scale = (_sp_col_scale(X, W) if standardization
             else torch.ones((F, d), dtype=torch.float32, device=X.device))
    return _grid_fit(X, y, W, l2s, l1s, mean, scale, loss=loss,
                     fit_intercept=fit_intercept, max_iter=max_iter, tol=tol)


def sparse_fista_fit(X, y: torch.Tensor, sample_weight: torch.Tensor,
                     l2: float, l1: float, **kw) -> FitResult:
    """One sparse fit: the one-fold, one-lane case of
    :func:`sparse_linear_grid_fit` (≙ ``sparse_fista_fit``,
    solvers.py:562-578).  Returns coef [D], intercept [1], n_iter []."""
    dev = X.device
    res = sparse_linear_grid_fit(
        X, y, sample_weight.reshape(1, -1),
        torch.tensor([l2], dtype=torch.float32, device=dev),
        torch.tensor([l1], dtype=torch.float32, device=dev), **kw)
    return FitResult(res.coef[0, 0], res.intercept[0, 0], res.n_iter[0, 0])
