"""The two-pass form of the FISTA gradient (``csrc/fista_wide.cu``): a numpy
emulation of its arithmetic and output layout, on the wrapper's own
arrays, held to the plain twins in f64; and the plans that pick it.

The kernel runs only on the card.  The emulation follows it step by step:
margins (X·V - muv) + b (the kernel adds its feature splits' dot products
in split order: another f32 order, within the tolerance), the loss pass
per (row, lane) — the softmax over a lane's classes, the GLMs' loss terms
in extra columns — and the Xᵀg pass's partial sums over row tiles of 64
dealt to ``nb`` blocks, added in block order;
:func:`linear_kernels.wide_outputs` then reads the vector as the wrappers
do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu_torch.models import linear_kernels as lk  # noqa: E402

F32, F64 = np.float32, np.float64
TOL = 1e-5


def _inputs(N, D, L, C, G, loss, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(F32)
    V = (rng.normal(size=(L * C, D)) * 0.3 / np.sqrt(D)).astype(F32)
    muv = (rng.normal(size=L * C) * 0.1).astype(F32)
    b = (rng.normal(size=L * C) * 0.1).astype(F32)
    F = -(-L // G)
    W = (rng.random((F, N)) < 0.7).astype(F32)
    wsum = (W[np.arange(L) // G].sum(axis=1) + 1.0).astype(F32)
    if loss == "softmax":
        y = rng.integers(0, C, size=N).astype(np.int32)
    elif loss in ("poisson", "gamma"):
        y = rng.gamma(2.0, 0.5, size=N).astype(F32)
    elif loss == "squared_hinge":
        y = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(F32)
    else:
        y = (rng.random(N) < 0.4).astype(F32)
    return X, V, muv, b, W, y, wsum


def emulate_fista_wide(X, V, muv, b, W, y, wsum, G, C, loss, grad, nb):
    """``fista_wide_launch``'s output vector, step by step in f32."""
    N, D = X.shape
    L = wsum.shape[0]
    J = L * C
    glm = loss in ("poisson", "gamma")
    m = (X @ V.T - muv[None]) + b[None]                       # [N, J]
    w = W[np.arange(L) // G].T                                # [N, L]
    ws = wsum[None]
    with np.errstate(over="ignore"):
        if loss == "softmax":
            z = m.reshape(N, L, C)
            e = np.exp(z - z.max(axis=2, keepdims=True))
            p = e * (F32(1) / e.sum(axis=2, keepdims=True))
            onehot = (np.arange(C)[None, None] == y[:, None, None])
            g = ((w / ws)[..., None] * (p - onehot)).reshape(N, J)
        elif loss == "logistic":
            g = w * (F32(1) / (F32(1) + np.exp(-m)) - y[:, None]) / ws
        elif loss == "squared_hinge":
            viol = np.maximum(F32(0), F32(1) - y[:, None] * m)
            g = w * (F32(-2) * viol * y[:, None]) / ws
        elif loss == "squared":
            g = w * (m - y[:, None]) / ws
        elif loss == "gram":
            g = (w / ws) * m
        elif loss == "poisson":
            mu = np.exp(np.clip(m, -30, 30))
            lw = w * (mu - y[:, None] * m)
            g = w * (mu - y[:, None]) / ws
        else:
            iv = np.exp(np.clip(-m, -30, 30))
            lw = w * (y[:, None] * iv + m)
            g = w * (F32(1) - y[:, None] * iv) / ws
    gbuf = np.concatenate([g, lw], axis=1) if glm else g       # [N, Jt]
    gbuf = gbuf.astype(F32)
    tiles = -(-N // lk.WIDE_ROWS)
    parts = []
    for blk in range(nb):
        rows = np.concatenate([np.arange(t * lk.WIDE_ROWS,
                                         min(N, (t + 1) * lk.WIDE_ROWS))
                               for t in range(blk, tiles, nb)] or [[]])
        rows = rows.astype(int)
        xtg = X[rows].T @ gbuf[rows, :J] if grad else np.zeros((0, J), F32)
        parts.append(np.concatenate([xtg.reshape(-1),
                                     gbuf[rows].sum(axis=0)]))
    out = np.zeros_like(parts[0], dtype=F32)
    for part in parts:                    # the reduction: blocks in order
        out = (out + part).astype(F32)
    return out


CASES = {
    "logistic": ("logistic", 1, True), "squared_hinge": ("squared_hinge", 1,
                                                         True),
    "gram": ("gram", 1, True), "squared": ("squared", 1, True),
    "softmax_5": ("softmax", 5, True), "softmax_70": ("softmax", 70, True),
    "poisson": ("poisson", 1, True), "gamma": ("gamma", 1, True),
    "poisson_value": ("poisson", 1, False), "gamma_value": ("gamma", 1,
                                                            False)}


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_two_pass_form_matches_the_twins(name):
    """At 300 rows x 150 features (two Xᵀg feature chunks of 128), 6 lanes
    3 folds, every loss's emulated output, read by ``wide_outputs``, lies
    within 1e-5 of each output's absolute mass of the f64 twin."""
    loss, C, grad = CASES[name]
    N, D, L, G = 300, 150, 6, 2
    X, V, muv, b, W, y, wsum = _inputs(N, D, L, C, G, loss, len(name))
    glm = loss in ("poisson", "gamma")
    plan = lk.wide_plan(D, L, C, glm)
    assert plan["Jt"] == L * C + (L if glm else 0)
    out = emulate_fista_wide(X, V, muv, b, W, y, wsum, G, C, loss, grad, 3)
    gx, gs, lsum = lk.wide_outputs(torch.as_tensor(out), D, L, C, grad, glm)
    t = {k: torch.as_tensor(v, dtype=torch.float64)
         for k, v in dict(X=X, muv=muv, b=b, W=W, wsum=wsum).items()}
    ty = torch.as_tensor(y if loss == "softmax" else y.astype(F64))
    if loss == "softmax":
        Vt = torch.as_tensor(V, dtype=torch.float64).reshape(L, C, D)
        args = (t["X"], Vt, t["muv"].reshape(L, C), t["b"].reshape(L, C),
                t["W"], ty, t["wsum"], G)
        want = lk.fista_softmax_step_twin(*args)
        g = lk.fista_softmax_row_grads(*args).abs()
        mass = ((g.reshape(L * C, N) @ t["X"].abs()).reshape(L, C, D),
                g.sum(dim=2))
    else:
        Vt = torch.as_tensor(V, dtype=torch.float64)
        args = (t["X"], Vt, t["muv"], t["b"], t["W"], ty, t["wsum"], G, loss)
        if glm:
            want = lk.fista_glm_twin(*args, grad=True)
            lw_mass = lk.glm_row_terms(
                (Vt @ t["X"].T - t["muv"][:, None] + t["b"][:, None]), ty,
                t["W"][torch.arange(L) // G], t["wsum"][:, None],
                loss)[0].abs().sum(dim=1) / t["wsum"]
            np.testing.assert_array_less(
                np.abs(lsum.numpy() / wsum - want[2].numpy()),
                TOL * lw_mass.numpy() + 1e-12)
        else:
            want = lk.fista_step_twin(*args)
        g = (lk.fista_row_grads(*args) if not glm else lk.glm_row_terms(
            Vt @ t["X"].T - t["muv"][:, None] + t["b"][:, None], ty,
            t["W"][torch.arange(L) // G], t["wsum"][:, None], loss)[1])
        mass = (g.abs() @ t["X"].abs(), g.abs().sum(dim=1))
    if grad:
        np.testing.assert_array_less(np.abs(gx.numpy() - want[0].numpy()),
                                     TOL * mass[0].numpy() + 1e-12)
    np.testing.assert_array_less(np.abs(gs.numpy() - want[1].numpy()),
                                 TOL * mass[1].numpy() + 1e-12)


def test_fault_widths_plan_the_two_pass_form():
    """The shapes the tensor-core launches refuse plan the two-pass form:
    one lane at 27,009 features, 65 classes, a GLM past the tensor-core
    form's width; the widest tensor-core shapes keep their form, and a GLM
    at 4,900 features (which the old one-tile GLM form refused) runs on the
    tensor-core form."""
    assert lk.launch_plan(27_009, 1)["form"] == "wide"
    assert lk.launch_plan(27_008, 1)["form"] != "wide"
    assert lk.softmax_launch_plan(16, 8, 65)["form"] == "wide"
    assert lk.softmax_launch_plan(16, 1, 64)["form"] != "wide"
    assert lk.glm_launch_plan(27_009, 1, True)["form"] == "wide"
    assert lk.glm_launch_plan(4_900, 12, True)["form"] == "cluster"
