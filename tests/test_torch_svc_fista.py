"""The port's squared-hinge linear SVC and the default grid's FISTA lanes
against the JAX package, on the CPU, and the FISTA loop's device-side stop.

Tolerances: coefficients, intercepts and margins rtol 1e-4 / atol 1e-5 (f32
matmuls summed in another order over 50 iterations); ``n_iter`` equal per
lane, except that with elastic_net 0.5 a lane whose last step lands within
rounding of ``tol`` may stop up to 2 iterations apart (ROADMAP queue 3's
FISTA stop hazard; the coefficients are still held to rtol 1e-4);
``fista_step``'s twin against an f64 numpy evaluation 1e-5 of each output's
absolute mass; the loop that runs all ``max_iter`` iterations bit for bit
equal to the one that stops when every lane has; scores of a converted JAX
SVC rtol 1e-5 / atol 1e-6, predictions exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu.models import linear as jl  # noqa: E402
from transmogrifai_tpu.models import solvers as js  # noqa: E402
from transmogrifai_tpu_torch.models import linear as pl  # noqa: E402
from transmogrifai_tpu_torch.models import linear_kernels as lk  # noqa: E402
from transmogrifai_tpu_torch.models import solvers as ps  # noqa: E402

N, D = 400, 6
REG = [0.001, 0.01, 0.1, 0.2]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    X = (rng.normal(size=(N, D)) * rng.uniform(0.5, 3.0, size=D)
         + rng.normal(size=D)).astype(np.float32)
    w = rng.normal(size=D)
    y = ((X - X.mean(0)) / X.std(0) @ w + rng.normal(size=N) > 0
         ).astype(np.float32)
    W = np.zeros((3, N), np.float32)
    for f, idx in enumerate(np.array_split(rng.permutation(N), 3)):
        W[f] = 1.0
        W[f, idx] = 0.0
    return X, y, W


def _fits(X, y, W, l2s, l1s, loss, max_iter=50):
    ref = js.linear_grid_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                             jnp.asarray(l2s), jnp.asarray(l1s), loss=loss,
                             max_iter=max_iter, tol=1e-6)
    port = ps.linear_grid_fit(torch.as_tensor(X), torch.as_tensor(y),
                              torch.as_tensor(W), torch.as_tensor(l2s),
                              torch.as_tensor(l1s), loss=loss,
                              max_iter=max_iter, tol=1e-6)
    return ref, port


@pytest.fixture(scope="module")
def svc_fit(data):
    """The default grid's SVC lanes: reg_param x4 as l2, no l1, 3 folds."""
    X, y, W = data
    l2s = np.asarray(REG, np.float32)
    return _fits(X, y, W, l2s, np.zeros(4, np.float32), "squared_hinge")


@pytest.fixture(scope="module")
def lr_grid_fit(data):
    """The default grid's LR lanes: reg_param x4 x elastic_net {0.1, 0.5}
    in one group (ParamGridBuilder order), max_iter 50, 3 folds."""
    X, y, W = data
    reg = np.repeat(np.asarray(REG, np.float32), 2)
    en = np.tile(np.asarray([0.1, 0.5], np.float32), 4)
    return _fits(X, y, W, reg * (np.float32(1) - en), reg * en, "logistic")


def _margins(X, coef, intercept):
    return X @ np.asarray(coef).reshape(-1, D).T + np.asarray(
        intercept).reshape(1, -1)


def test_squared_hinge_grid_fit_matches_jax(data, svc_fit):
    X, _, _ = data
    ref, port = svc_fit
    np.testing.assert_array_equal(port.n_iter.numpy(), np.asarray(ref.n_iter))
    np.testing.assert_allclose(port.coef.numpy(), np.asarray(ref.coef),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.intercept.numpy(),
                               np.asarray(ref.intercept), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        _margins(X, port.coef.numpy(), port.intercept.numpy()),
        _margins(X, np.asarray(ref.coef), np.asarray(ref.intercept)),
        rtol=1e-4, atol=1e-4)


def test_default_lr_grid_with_elastic_net_half_matches_jax(data, lr_grid_fit):
    X, _, _ = data
    ref, port = lr_grid_fit
    n_ref, n_port = np.asarray(ref.n_iter), port.n_iter.numpy()
    assert (n_ref < 50).any()
    assert np.abs(n_port - n_ref).max() <= 2
    assert (n_port == n_ref).sum() >= n_ref.size - 2
    np.testing.assert_allclose(port.coef.numpy(), np.asarray(ref.coef),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        _margins(X, port.coef.numpy(), port.intercept.numpy()),
        _margins(X, np.asarray(ref.coef), np.asarray(ref.intercept)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_fista_loop_needs_no_host_check(data, loss):
    """Running every lane for all ``max_iter`` iterations, frozen lanes held
    by ``torch.where``, gives the same bits as stopping once no lane is
    active (the JAX package's while_loop condition)."""
    X, y, W = data
    Xt, Wt = torch.as_tensor(X), torch.as_tensor(W)
    l2 = torch.tensor(REG * 3, dtype=torch.float32)
    l1 = torch.full((12,), 1e-3)
    mean, scale = ps.standardize_moments(Xt, Wt, center=True)
    lanes = torch.arange(12) // 4
    sigma = ps._spectral_norm_sq_weighted(Xt, Wt, Wt.sum(dim=1), mean, scale)
    loop = ps.FistaLoop(Xt, ps.loss_target(loss, torch.as_tensor(y)), Wt, 4,
                        l2, l1, mean[lanes], scale[lanes], sigma[lanes],
                        loss=loss, fit_intercept=True, tol=1e-4)
    full = ps.fista_fit(loop, 300)
    s, it = loop.start(), 0
    while bool(s.active.any()) and it < 300:
        s, it = loop.step(s), it + 1
    assert it < 300 and int(full.k.max()) == it
    for a, b in zip(full, s):
        assert torch.equal(a, b)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge", "gram"])
def test_fista_step_twin_matches_f64(data, loss):
    X, y, W = data
    rng = np.random.default_rng(1)
    L, G = 6, 2
    V = rng.normal(size=(L, D)).astype(np.float32)
    mu = rng.normal(size=(L, D)).astype(np.float32)
    b = rng.normal(size=L).astype(np.float32)
    muv = (mu * V).sum(axis=1)
    tgt = np.where(y > 0.5, 1.0, -1.0) if loss == "squared_hinge" else y
    ws = W.sum(axis=1)[np.arange(L) // G]
    gx, gs = lk.fista_step(*(torch.as_tensor(np.asarray(a, np.float32))
                             for a in (X, V, muv, b, W, tgt, ws)), G, loss)
    Wl = W[np.arange(L) // G].astype(np.float64)
    m = V.astype(np.float64) @ X.T.astype(np.float64) - muv[:, None] + b[:, None]
    if loss == "logistic":
        g = Wl * (1 / (1 + np.exp(-m)) - y) / ws[:, None]
    elif loss == "squared_hinge":
        g = Wl * (-2.0 * np.maximum(0.0, 1.0 - tgt * m) * tgt) / ws[:, None]
    else:
        g = Wl / ws[:, None] * m
    np.testing.assert_array_less(np.abs(gx.numpy() - g @ X),
                                 1e-5 * (np.abs(g) @ np.abs(X)) + 1e-9)
    np.testing.assert_array_less(np.abs(gs.numpy() - g.sum(axis=1)),
                                 1e-5 * np.abs(g).sum(axis=1) + 1e-9)


def test_svc_estimator_and_scores_match_jax(data):
    X, y, W = data
    grids = [{"reg_param": r, "max_iter": 50} for r in (0.001, 0.1)]
    ref = jl.OpLinearSVC().fit_arrays_grid(X, y, W, grids)
    port = pl.OpLinearSVC().fit_arrays_grid(X, y, W, grids, device="cpu")
    for f in range(3):
        for g in range(2):
            assert port[f][g]["kind"] == ref[f][g]["kind"] == "svc"
            assert port[f][g]["n_iter"] == ref[f][g]["n_iter"]
            np.testing.assert_allclose(port[f][g]["coef"].numpy(),
                                       ref[f][g]["coef"], rtol=1e-4, atol=1e-5)
    fitted = pl.OpLinearSVC(reg_param=0.01).fit_arrays(X, y, device="cpu")
    want = jl.OpLinearSVC(reg_param=0.01).fit_arrays(X, y)
    np.testing.assert_allclose(fitted["coef"].numpy(), want["coef"],
                               rtol=1e-4, atol=1e-5)
    got = pl.LinearPredictionModel(fitted=fitted).device_scores(
        torch.as_tensor(X), full=True)
    exp = jl.LinearPredictionModel(fitted=want).device_scores(
        jnp.asarray(X), full=True)
    assert "probability" not in got
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(exp["scores"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["rawPrediction"].numpy(),
                               np.asarray(exp["rawPrediction"]), rtol=1e-4,
                               atol=1e-4)


def test_jax_svc_converted_scores_like_jax(data):
    """A JAX-fitted SVC, exported as plain arrays and built by ``convert``,
    scores as the JAX package scores it; a kind the port lacks raises."""
    from transmogrifai_tpu_torch import convert
    X, y, _ = data
    ref = jl.OpLinearSVC(reg_param=0.01).fit_arrays(X, y)
    exported = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in ref.items()}
    fitted = convert._model_fitted("LinearPredictionModel", exported,
                                   torch.device("cpu"))
    got = pl.LinearPredictionModel(fitted=fitted).device_scores(
        torch.as_tensor(X), full=True)
    want = jl.LinearPredictionModel(fitted=ref).device_scores(jnp.asarray(X),
                                                              full=True)
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))
    np.testing.assert_allclose(got["rawPrediction"].numpy(),
                               np.asarray(want["rawPrediction"]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(NotImplementedError, match="isotonic"):
        convert._model_fitted("LinearPredictionModel",
                              {**exported, "kind": "isotonic"},
                              torch.device("cpu"))


@pytest.mark.parametrize("D", [16, 28, 1200, 1596, 1597, 4096, 16384,
                               27_009, 100_003])
def test_fista_step_launch_plan_fits_every_width(D):
    """Every width the linear family meets has a launch plan for 1 to 96
    lanes: up to the JAX package's 16,384 hashed columns (and on to 27,008)
    a tensor-core plan whose shared memory fits one block (the kernel's own
    carve-up, ``_tc_layout``), whose columns fit the kernel's 8 register
    column tiles, and whose feature slices cover X with no empty block
    (``fista_tc_run`` refuses anything else); past that the two-pass form
    with every lane in one launch."""
    for L in range(1, 97):
        plan = lk.launch_plan(D, L)
        if D > 27_008:
            assert plan["form"] == "wide", (D, L, plan)
            assert plan["cols"] == plan["lanes"] == L
            assert plan["Jp"] % 4 == 0 and plan["Jp"] >= L
            continue
        assert plan["smem"] <= 227 * 1024, (D, L, plan)
        assert 1 <= plan["lanes"] <= min(L, lk.TC_COLS) and plan["cols"] <= 64
        assert plan["lanes"] == min(L, lk.TC_COLS) or D > 4096
        assert plan["cols"] == -(-plan["lanes"] // 8) * 8
        assert plan["TR"] in (16, 32, 64, 128) and plan["CS"] in (1, 2, 4, 8)
        assert plan["DS"] % 8 == 0
        assert (plan["CS"] - 1) * plan["DS"] < D <= plan["CS"] * plan["DS"]
        assert plan["smem"] == lk._tc_layout(
            plan["TR"], plan["CS"], plan["DS"], plan["S"], plan["cols"],
            plan["v_res"], plan["acc_res"])["smem"]
    if D <= 28:
        # a narrow X: one block a row tile of 128 rows, each warp whole
        # margins (the loss in the fragments), everything in shared memory
        assert all(lk.launch_plan(D, L)["form"] == "narrow"
                   and lk.launch_plan(D, L)["TR"] == 128
                   for L in range(1, 25))
    if D in (1596, 1597):
        # the transmogrified width: a cluster over feature slices keeps X's
        # tile, V and the accumulators in shared memory with two stages
        for L in (1, 6, 8, 24):
            p = lk.launch_plan(D, L)
            assert p["form"] == "cluster" and p["S"] == 2
            assert p["v_res"] and p["acc_res"]
