"""The port's generalized linear regression (``OpGeneralizedLinearRegression``:
poisson and gamma through backtracking FISTA on ``fista_glm``'s twin,
binomial and gaussian through the logistic and squared losses) against the
JAX package, on the CPU.

Tolerances: the loss value and each row's gradient rtol 1e-6 (the same f32
formulas; a row's gradient to 1e-6 of its terms' size, as μ - y cancels
where the model fits the row); the twin's Xᵀg and Σg within 1e-5 of their
absolute mass (the cancelling rows and the fold sums in another order); grid fits: each lane's objective within 1e-5 relative
and its coefficients and intercept within 1e-3, and the step halvings of
the first ``FIRST`` iterations equal lane by lane.  ``n_iter`` is not held
lane by lane: the sufficient-decrease test compares f32 loss sums that
differ by less than their rounding once a lane nears its optimum, so late
halvings (each shrinking the step for good) and with them the ``tol`` stop
follow the summation order — the JAX package's own jitted grid and an
eager run of its loop stop lane 0 of the poisson grid below at 26 and 21
iterations, the port at 19, all three at the same objective.  The selector:
the same candidates, racing and winner, every CV RMSE within 1e-4 relative;
scores of converted JAX models rtol 1e-5; LOCO diffs within 1e-6 of the
prediction scale.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import linear as jl  # noqa: E402
from transmogrifai_tpu.models import solvers as js  # noqa: E402
from transmogrifai_tpu_torch import convert  # noqa: E402
from transmogrifai_tpu_torch import insights_kernels as ik  # noqa: E402
from transmogrifai_tpu_torch.models import linear as pl  # noqa: E402
from transmogrifai_tpu_torch.models import linear_kernels as lk  # noqa: E402
from transmogrifai_tpu_torch.models import solvers as ps  # noqa: E402
from transmogrifai_tpu_torch.synthetic import make_glm_data  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FAMILIES = ("poisson", "gamma")
REG = np.array([0.001, 0.01, 0.1, 0.2], np.float32)
N = 4000
FIRST = 8           # iterations whose halvings are held lane by lane


def _folds(n, seed=3):
    rng = np.random.default_rng(seed)
    W = np.ones((3, n), np.float32)
    for f, idx in enumerate(np.array_split(rng.permutation(n), 3)):
        W[f, idx] = 0.0
    return W


def _terms_input(family, n=500, seed=0):
    rng = np.random.default_rng(seed)
    eta = rng.normal(scale=2.0, size=n).astype(np.float32)
    eta[:6] = [35.0, -35.0, 31.0, -31.0, 29.5, -40.0]   # past the clip
    mu = np.exp(np.clip(eta, -5, 5))
    y = (rng.poisson(mu) if family == "poisson"
         else rng.gamma(2.0, mu / 2.0)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    return eta, y, w


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_terms_and_twin_match_jax(family):
    """``glm_row_terms`` against ``_poisson_loss_grad`` /
    ``_gamma_loss_grad`` at margins past the ±30 clip (y·m unclipped), and
    ``fista_glm_twin`` for 3 lanes over 2 folds against the JAX loss and
    Xᵀ of its gradient."""
    eta, y, w = _terms_input(family)
    fn = {"poisson": js._poisson_loss_grad, "gamma": js._gamma_loss_grad}
    want_l, want_g = fn[family](jnp.asarray(eta), jnp.asarray(y),
                                jnp.asarray(w))
    ws = torch.tensor(float(jnp.sum(jnp.asarray(w))))   # the JAX f32 sum
    lw, g = lk.glm_row_terms(torch.as_tensor(eta), torch.as_tensor(y),
                             torch.as_tensor(w), ws, family)
    np.testing.assert_allclose(float(lw.sum() / ws), float(want_l),
                               rtol=1e-6)
    # μ - y (or 1 - y/μ) cancels where the model fits the row: hold each
    # row's gradient to 1e-6 of its terms' size
    e = np.clip(eta.astype(np.float64), -30, 30)
    size = w * (np.exp(e) + y if family == "poisson"
                else 1 + y * np.exp(-e)) / float(ws)
    assert np.all(np.abs(g.numpy() - np.asarray(want_g)) <= 1e-6 * size)

    rng = np.random.default_rng(1)
    n, D, L, G = 600, 5, 3, 2
    X = rng.normal(size=(n, D)).astype(np.float32)
    W = (rng.random((2, n)) > 0.3).astype(np.float32)
    V = rng.normal(scale=0.3, size=(L, D)).astype(np.float32)
    muv = rng.normal(scale=0.1, size=L).astype(np.float32)
    b = rng.normal(scale=0.3, size=L).astype(np.float32)
    y = _terms_input(family, n=n, seed=2)[1]
    lane_w = W[np.arange(L) // G]
    ws = lane_w.sum(axis=1)
    gx, gs, val = lk.fista_glm(*(torch.as_tensor(a) for a in (
        X, V, muv, b, W, y, ws)), G, family)
    for l in range(L):
        eta_l = jnp.asarray(X) @ jnp.asarray(V[l]) - muv[l] + b[l]
        lv, gl = fn[family](eta_l, jnp.asarray(y), jnp.asarray(lane_w[l]))
        gl = np.asarray(gl, np.float64)
        np.testing.assert_allclose(float(val[l]), float(lv), rtol=1e-6)
        mass = np.abs(gl) @ np.abs(X.astype(np.float64))
        assert np.all(np.abs(gx[l].numpy() - gl @ X) <= 1e-5 * mass + 1e-12)
        assert abs(float(gs[l]) - gl.sum()) <= 1e-5 * np.abs(gl).sum()
    vo = lk.fista_glm(*(torch.as_tensor(a) for a in (X, V, muv, b, W, y, ws)),
                      G, family, grad=False)
    assert torch.equal(vo, val)


def _jax_halvings(X, y, w, l2, loss, sigma_sq=None, max_iter=FIRST):
    """The JAX loop's step halvings per iteration for one lane: run eagerly
    (``jax.disable_jit``: ``lax.while_loop`` as a Python loop) with the
    matrix products counted — per iteration ``xs_mv`` once for the gradient
    at z, once per sufficient-decrease test, ``xs_tmv`` once."""
    Xj, wj = jnp.asarray(X), jnp.asarray(w)
    mean, scale = js.standardize_moments(Xj, wj, True)
    if sigma_sq is None:
        sigma_sq = js._spectral_norm_sq_weighted(Xj, wj / jnp.sum(wj), mean,
                                                 scale)
    ev = []

    def xs_mv(coef):
        ev.append("M")
        v = coef / scale
        return Xj @ v - mean @ v

    def xs_tmv(g):
        ev.append("T")
        return (Xj.T @ g - mean * jnp.sum(g)) / scale

    with jax.disable_jit():
        js._fista_loop(xs_mv, xs_tmv, jnp.asarray(y), wj, jnp.float32(l2),
                       jnp.float32(0.0), loss=loss, d=X.shape[1], n_classes=1,
                       fit_intercept=True, max_iter=max_iter, tol=1e-6,
                       sigma_sq=jnp.float32(sigma_sq))
    # after each "T": the tests (1 + halvings), then the next gradient's
    # "M" (or the final objective's)
    return [len(seg) - 2 for seg in "".join(ev).split("T")[1:]]


def _port_halvings(X, y, W, l2s, loss, sigma_sq=None, iters=FIRST):
    """The port's halvings per iteration, lane by lane ([iters, L])."""
    Xt, Wt = torch.as_tensor(X), torch.as_tensor(W)
    F, G = W.shape[0], len(l2s)
    mean, scale = ps.standardize_moments(Xt, Wt, True)
    sig = (ps._spectral_norm_sq_weighted(Xt, Wt, Wt.sum(dim=1), mean, scale)
           if sigma_sq is None else torch.full((F,), float(sigma_sq)))

    def lanes(a):
        return a.repeat_interleave(G, dim=0)

    loop = ps.FistaLoop(Xt, ps.loss_target(loss, torch.as_tensor(y)), Wt, G,
                        torch.as_tensor(l2s).repeat(F), torch.zeros(F * G),
                        lanes(mean), lanes(scale), lanes(sig), loss=loss,
                        fit_intercept=True, tol=1e-6)
    s, out = loop.start(), []
    for _ in range(iters):
        h0 = s.halvings.clone()
        s = loop.step(s)
        out.append((s.halvings - h0).tolist())
    return np.asarray(out)


def _objective(X, y, w, coef, inter, scale, l2, loss):
    """The JAX objective in f64: the weighted mean loss at the raw
    coefficients plus l2/2 |coef · scale|² (the penalty of the standardised
    basis)."""
    eta = X.astype(np.float64) @ coef + inter
    if loss == "poisson":
        lv = np.exp(np.clip(eta, -30, 30)) - y * eta
    else:
        lv = y * np.exp(np.clip(-eta, -30, 30)) + eta
    return (w * lv).sum() / w.sum() + 0.5 * l2 * ((coef * scale) ** 2).sum()


@pytest.fixture(scope="module", params=FAMILIES)
def grid_fits(request):
    family = request.param
    X, y = make_glm_data(N, family)
    W = _folds(N)
    ref = js.linear_grid_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                             jnp.asarray(REG), jnp.zeros(4), loss=family,
                             max_iter=50, tol=1e-6)
    port = ps.linear_grid_fit(torch.as_tensor(X), torch.as_tensor(y),
                              torch.as_tensor(W), torch.as_tensor(REG),
                              torch.zeros(4), loss=family, max_iter=50,
                              tol=1e-6)
    return family, X, y, W, ref, port


def test_grid_fit_matches_jax(grid_fits):
    """3 folds x 4 reg_params: the objective and coefficients of every
    lane, and that every lane ran and stopped inside ``max_iter``."""
    family, X, y, W, ref, port = grid_fits
    _, scale = ps.standardize_moments(torch.as_tensor(X), torch.as_tensor(W),
                                      True)
    rc, ri = np.asarray(ref.coef, np.float64), np.asarray(ref.intercept)
    pc, pi = port.coef.double().numpy(), port.intercept.double().numpy()
    np.testing.assert_allclose(pc, rc, atol=1e-3)
    np.testing.assert_allclose(pi, ri, atol=1e-3)
    for f in range(3):
        for g, l2 in enumerate(REG):
            sc = scale[f].double().numpy()
            want = _objective(X, y, W[f], rc[f, g], ri[f, g, 0], sc, l2,
                              family)
            got = _objective(X, y, W[f], pc[f, g], pi[f, g, 0], sc, l2,
                             family)
            assert abs(got - want) <= 1e-5 * abs(want), (f, g, got, want)
    n_it = port.n_iter.numpy()
    assert ((n_it >= 1) & (n_it <= 50)).all()
    assert port.halvings is not None and (port.halvings.numpy() >= 0).all()


def test_first_iterations_halve_like_jax(grid_fits):
    """The step halvings of the first FIRST iterations, lane by lane, for
    fold 0's four reg_params, against the JAX loop run eagerly."""
    family, X, y, W, _, _ = grid_fits
    port = _port_halvings(X, y, W[:1], REG, family)
    for g, l2 in enumerate(REG):
        want = _jax_halvings(X, y, W[0], float(l2), family)
        assert port[:, g].tolist() == want, (g, port[:, g].tolist(), want)


def test_ladders_and_the_cap_follow_the_sequential_rule():
    """A first step far too long (no l2 penalty): with λ_max given as 2^-20
    of itself the first iterations need more halvings than one ladder holds
    (the next ladders run), and with 2^-40 the first reaches the
    30-halving cap, taking s·2^-30 untested, as the JAX loop does."""
    X, y = make_glm_data(800, "poisson", d=4)
    W = np.ones((1, 800), np.float32)
    Xt, Wt = torch.as_tensor(X), torch.as_tensor(W)
    mean, scale = ps.standardize_moments(Xt, Wt, True)
    sig = float(ps._spectral_norm_sq_weighted(Xt, Wt, Wt.sum(dim=1), mean,
                                              scale)[0])
    for shrink, iters in ((2.0 ** -20, 3), (2.0 ** -40, 1)):
        port = _port_halvings(X, y, W, np.zeros(1, np.float32), "poisson",
                              sigma_sq=sig * shrink, iters=iters)
        want = _jax_halvings(X, y, W[0], 0.0, "poisson",
                             sigma_sq=sig * shrink, max_iter=iters)
        assert port[:, 0].tolist() == want
        assert port[0, 0] > ps.LADDER
    assert port[0, 0] == ps.MAX_HALVINGS


def _estimator(pkg, family, **kw):
    mod = jl if pkg == "jax" else pl
    return mod.OpGeneralizedLinearRegression(family=family, **kw)


def _family_data(family, n=1500):
    if family in FAMILIES:
        return make_glm_data(n, family, d=6)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    eta = 0.3 + X @ rng.normal(scale=0.4, size=6)
    y = (eta + rng.normal(size=n) > 0 if family == "binomial"
         else eta + 0.3 * rng.normal(size=n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson",
                                    "gamma"])
def test_fit_arrays_and_converted_scores_match_jax(family):
    """Every family: one fit (X standardised explicitly) against the JAX
    package's, coefficients within 1e-3, and for gaussian (ridge) and
    binomial the estimator's grid path too (poisson's and gamma's is the
    selector's, ``test_selector_matches_jax``); a JAX-fitted model,
    exported as plain arrays and built by ``convert``, scores as the JAX
    package scores it (the inverse link of the clipped margin, nothing
    else)."""
    X, y = _family_data(family)
    ref = _estimator("jax", family, reg_param=0.01).fit_arrays(X, y)
    got = _estimator("port", family, reg_param=0.01).fit_arrays(
        X, y, device="cpu")
    assert got["kind"] == "glm" and got["family"] == family
    np.testing.assert_allclose(got["coef"].numpy(), ref["coef"], atol=1e-3)
    np.testing.assert_allclose(got["intercept"].numpy(), ref["intercept"],
                               atol=1e-3)
    if family not in FAMILIES:
        W = _folds(len(y))
        grids = [{"reg_param": 0.01}, {"reg_param": 0.1}]
        rg = _estimator("jax", family).fit_arrays_grid(X, y, W, grids)
        pg = _estimator("port", family).fit_arrays_grid(X, y, W, grids,
                                                        device="cpu")
        for f in range(3):
            for g in range(2):
                np.testing.assert_allclose(pg[f][g]["coef"].numpy(),
                                           rg[f][g]["coef"], atol=1e-3)
                assert pg[f][g]["family"] == family
    exported = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in ref.items()}
    pm = convert.prediction_model({"model": "GLMPredictionModel",
                                   "fitted": exported}, CPU)
    assert isinstance(pm, pl.GLMPredictionModel)
    want = jl.GLMPredictionModel(fitted=ref).device_scores(jnp.asarray(X))
    out = pm.device_scores(torch.as_tensor(X), full=True)
    assert set(out) == set(want) == {"prediction"}
    np.testing.assert_allclose(out["prediction"].numpy(),
                               np.asarray(want["prediction"]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(NotImplementedError, match="family"):
        convert.prediction_model({"model": "GLMPredictionModel", "fitted": {
            **exported, "family": "tweedie"}}, CPU)


def _reference_script():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import glm_grid_reference
    return glm_grid_reference


@pytest.mark.parametrize("family", FAMILIES)
def test_selector_matches_jax(family):
    """``RegressionModelSelector`` over GLM x4 and LinReg x8
    (``scripts/glm_grid_reference.py``) at 2,000 rows in both packages:
    the same candidates and racing, every CV RMSE within 1e-4 relative,
    the same winner and train RMSE."""
    ggr = _reference_script()
    X, y = make_glm_data(2000, family)
    runs = {}
    for pkg, kw in (("transmogrifai_tpu", {}),
                    ("transmogrifai_tpu_torch", {"device": "cpu"})):
        model, batch, _, _ = ggr.train(pkg, X, y, family, **kw)
        ev = ggr._mod(pkg, "evaluators").Evaluators.Regression.rmse()
        runs[pkg] = (model, model.evaluate(ev, batch=batch))
    (jm, jmet), (pm, pmet) = runs.values()
    jc, pc = ggr.candidates(jm), ggr.candidates(pm)
    assert [(n, p, r) for n, p, _, r in pc] == [(n, p, r) for n, p, _, r in jc]
    for (name, p, got, _), (_, _, want, _) in zip(pc, jc):
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"{name} {p}")
    assert pm.selected_model.summary.best_model_name == \
        jm.selected_model.summary.best_model_name == \
        "OpGeneralizedLinearRegression"
    assert ggr.winner_params(pm) == ggr.winner_params(jm)
    np.testing.assert_allclose(pmet["RootMeanSquaredError"],
                               jmet["RootMeanSquaredError"], rtol=1e-4)
    best = pm.selected_model.best_model
    assert isinstance(best, pl.GLMPredictionModel)
    assert best.fitted["halvings"] >= 0 and 1 <= best.fitted["n_iter"] <= 50


def test_sparse_glm_is_refused_for_the_skip_seam():
    """A ``SparseMatrix`` is refused with ``TypeError`` (the selector's skip
    seam), by the estimator and by the gradient seam."""
    from transmogrifai_tpu_torch.sparse.matrix import SparseMatrix
    Xs = SparseMatrix.from_dense(np.eye(4, dtype=np.float32), device="cpu")
    est = pl.OpGeneralizedLinearRegression(family="poisson")
    with pytest.raises(TypeError, match="SparseMatrix"):
        est.fit_arrays_grid(Xs, np.ones(4, np.float32),
                            np.ones((1, 4), np.float32), [{}], device="cpu")
    with pytest.raises(TypeError, match="SparseMatrix"):
        est.fit_arrays(Xs, np.ones(4, np.float32), device="cpu")
    with pytest.raises(TypeError, match="poisson"):
        lk.grad_seam(Xs, "poisson")


@pytest.mark.parametrize("D,grad", [(16, True), (16, False), (1596, True),
                                    (1596, False), (4000, True)])
def test_glm_launch_plan_fits_shared_memory(D, grad):
    """Every plan is the tensor-core plan of ``tc_plan`` for a full launch
    of 64 lanes with room for the gradient form's loss sums (the value
    form keeps them in its unused g buffer), the same for both forms and
    every lane count but the lanes a launch: it fits one block's shared
    memory and takes at most 64 lanes a launch — the CV's 12 in one, a
    ladder's 96 trial lanes in two (64 and 32, each reading X once); a
    width no tensor-core launch holds takes the two-pass form with a loss
    column a lane."""
    full = lk.tc_plan(D, lk.TC_COLS, 1, lsum=True)
    for L in (1, 4, 12, 96):
        plan = lk.glm_launch_plan(D, L, grad)
        assert plan == {**full, "lanes": min(L, full["lanes"])}
        assert plan == {**lk.glm_launch_plan(D, L, not grad)}
        assert plan["form"] in ("narrow", "cluster")
        assert plan["smem"] <= lk._SMEM_MAX
        assert 1 <= plan["lanes"] <= min(L, lk.TC_COLS)
        lay = lk._tc_layout(plan["TR"], plan["CS"], plan["DS"], plan["S"],
                            plan["cols"], plan["v_res"], plan["acc_res"],
                            True)
        assert plan["smem"] == lay["smem"]
        bare = lk._tc_layout(plan["TR"], plan["CS"], plan["DS"], plan["S"],
                             plan["cols"], plan["v_res"], plan["acc_res"])
        Jp = lk._tc_stride(plan["cols"])
        assert lay["smem"] - bare["smem"] == 4 * plan["TR"] * Jp
    if D == 16:
        assert lk.glm_launch_plan(D, 12, grad)["lanes"] == 12
        assert lk.glm_launch_plan(D, 96, grad)["lanes"] == 64
        assert lk.glm_launch_plan(D, 96, grad)["form"] == "narrow"
    wide = lk.glm_launch_plan(30_000, 1, grad)
    assert wide["form"] == "wide" and wide["Jt"] == 2 and wide["Jp"] == 4


@pytest.mark.parametrize("grad", [True, False])
def test_glm_launch_plan_holds_every_width(grad):
    """Widths 16 .. 16,384 and 27,009 all plan, for one lane, the CV's 12
    and a ladder's 96: the tensor-core form wherever ``tc_plan`` holds the
    shape (the fault widths 4,900 and 16,384 included: a cluster of feature
    slices), else — exactly where ``tc_plan`` itself takes it for one lane,
    past ~27,000 features — the two-pass form with every lane and a loss
    column a lane."""
    for D in (16, 64, 256, 1024, 4096, 4800, 4900, 7200, 8192, 16_384,
              27_009):
        for L in (1, 12, 96):
            plan = lk.glm_launch_plan(D, L, grad)
            tc = lk.tc_plan(D, lk.TC_COLS, 1, lsum=True)
            if tc["form"] != "wide":
                assert plan == {**tc, "lanes": min(L, tc["lanes"])}
                assert plan["smem"] <= lk._SMEM_MAX
                continue
            assert lk.tc_plan(D, L, 1)["form"] == "wide"
            assert plan["form"] == "wide" and D > 16_384
            assert plan["lanes"] == L and plan["Jt"] == 2 * L
            assert plan["Jp"] % 4 == 0 and plan["Jp"] >= 2 * L
    for D in (4_900, 16_384):
        assert lk.glm_launch_plan(D, 12, grad)["form"] == "cluster"
    assert lk.glm_launch_plan(27_009, 1, grad)["form"] == "wide"


# --------------------------------------------------------------------------
# LOCO of a GLM: the inverse link, never a sigmoid
# --------------------------------------------------------------------------

def _jax_glm_model(family, X, y):
    from transmogrifai_tpu.columns import Column as JC
    from transmogrifai_tpu.columns import ColumnBatch as JB
    from transmogrifai_tpu.features import Feature as JF
    from transmogrifai_tpu.types import OPVector as JV
    from transmogrifai_tpu.types import RealNN as JR
    est = jl.OpGeneralizedLinearRegression(family=family, reg_param=0.01)
    est.set_input(JF("label", JR, True, None, parents=()),
                  JF("v", JV, False, None, parents=()))
    return est.fit(JB({"label": JC(JR, y), "v": JC(JV, X)}, len(y)))


def test_loco_of_a_poisson_glm_matches_jax():
    """``RecordInsightsLOCO`` (top-4, one group per column) on a JAX-fitted
    poisson GLM carried across by ``convert``: the port's twin against the
    JAX stage, diffs within 1e-6 of the prediction scale."""
    from transmogrifai_tpu import record_insights as jri
    from transmogrifai_tpu.columns import Column as JC
    from transmogrifai_tpu.columns import ColumnBatch as JB
    from transmogrifai_tpu.features import Feature as JF
    from transmogrifai_tpu.types import OPVector as JV
    from transmogrifai_tpu_torch import record_insights as pri
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import Feature
    from transmogrifai_tpu_torch.types import OPVector
    X, y = make_glm_data(600, "poisson", d=8)
    jm = _jax_glm_model("poisson", X, y)
    pm = convert.prediction_model(
        {"model": type(jm).__name__,
         "fitted": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                    for k, v in jm.fitted.items()}}, CPU)
    jst = jri.RecordInsightsLOCO(model=jm, top_k=4)
    jst.set_input(JF("v", JV, False, None, parents=()))
    want = jst.transform(JB({"v": JC(JV, X)}, len(X))).values
    pst = pri.RecordInsightsLOCO(model=pm, top_k=4)
    pst.set_input(Feature("v", OPVector, False, None, parents=()))
    got = pst.transform(ColumnBatch({"v": Column(OPVector,
                                                 torch.as_tensor(X))},
                                    len(X), device="cpu")).values
    scale = float(np.abs(np.asarray(
        jm.device_scores(jnp.asarray(X))["prediction"])).max())
    tol = 1e-6 * scale
    for rw, rg in zip(want, got):
        pw = [(k, json.loads(v)[0][1]) for k, v in rw.items()]
        pg = [(k, json.loads(v)[0][1]) for k, v in rg.items()]
        assert len(pw) == len(pg) == 4
        for (nw, vw), (ng, vg) in zip(pw, pg):
            if nw != ng:
                assert abs(abs(vw) - abs(vg)) <= tol
        dw, dg = dict(pw), dict(pg)
        for n in set(dw) & set(dg):
            assert abs(dw[n] - dg[n]) <= tol, (n, dw[n], dg[n])


@pytest.mark.parametrize("family,link", [
    ("poisson", "clipped_exp"), ("gamma", "clipped_exp"),
    ("binomial", "clipped_logistic"), ("gaussian", "clipped_identity")])
def test_glm_is_never_explained_through_the_sigmoid(family, link):
    """``loco_linear``'s link comes from an explicit (kind, family) table:
    a GLM takes its family's inverse link of the clipped margin, and the
    twin's diffs are differences of that link — for poisson and gamma
    larger than a sigmoid could give; a kind or family the table lacks
    raises instead of falling back to the sigmoid."""
    X, y = _family_data(family, n=300)
    fit = pl.OpGeneralizedLinearRegression(family=family).fit_arrays(
        X, y, device="cpu")
    model = pl.GLMPredictionModel(fitted=fit)
    assert ik.linear_link(model.fitted) == link
    assert ik.LINKS[link] not in (ik.LINKS["logistic"],
                                  ik.LINKS["identity"])
    Xt = torch.as_tensor(X)
    cg = torch.arange(X.shape[1], dtype=torch.int32)
    idx, val = ik.model_loco(model, Xt, cg, X.shape[1], X.shape[1], "abs")
    coef = fit["coef"].double().numpy()
    eta = X.astype(np.float64) @ coef + float(fit["intercept"][0])
    inv = {"clipped_exp": lambda e: np.exp(np.clip(e, -30, 30)),
           "clipped_logistic": lambda e: 1 / (1 + np.exp(-np.clip(e, -30,
                                                                  30))),
           "clipped_identity": lambda e: np.clip(e, -30, 30)}[link]
    want = inv(eta)[:, None] - inv(eta[:, None] - X * coef[None, :])
    got = np.take_along_axis(want, idx.long().numpy(), axis=1)
    np.testing.assert_allclose(val.numpy(), got, rtol=1e-4, atol=1e-5)
    for bad in ({**fit, "kind": "isotonic"}, {**fit, "family": "tweedie"}):
        with pytest.raises(ValueError, match="no link"):
            ik.loco_linear(Xt, pl.LinearPredictionModel(fitted=bad), cg,
                           X.shape[1], 2)


@pytest.mark.parametrize("D", [16, 300, 4_900])
def test_glm_forms_share_one_cluster_count(D):
    """A GLM's gradient form (12 lanes), a ladder's value form (64 and 32
    columns) and the refit's one lane take one plan — rows a tile, cluster,
    slice and shared memory — and differ only in the lanes a launch; the
    kernel gives them the clusters its 64-column form holds co-resident,
    so at one point both forms add their loss sums over the same tiles in
    the same order."""
    g, v = lk.glm_launch_plan(D, 12, True), lk.glm_launch_plan(D, 96, False)
    one = lk.glm_launch_plan(D, 1, True)
    assert {**g, "lanes": 0} == {**v, "lanes": 0} == {**one, "lanes": 0}
    assert (g["lanes"], v["lanes"], one["lanes"]) == (12, 64, 1)
