"""LOCO through the softmax link: ``RecordInsightsLOCO`` on multinomial
logistic regression, naive Bayes and MLP models (fitted by the JAX package
and carried across by ``convert``) against the JAX stage, on the CPU, and
``loco_softmax``'s launch plan and kernel inputs.

On a CPU tensor ``insights_kernels.loco_softmax`` runs the plain twin
``loco_topk_twin`` on the model's own ``device_scores``; the card kernel
(``csrc/loco_softmax.cu``) instead forms each group's first-layer
contribution from one read of the row and subtracts it.  Its arithmetic is
emulated here in numpy (f32, the kernel's order: lane partials of the base,
then per group its columns in ``perm`` order, the tail, the softmax after
the max) on the very arrays the wrapper hands the kernel, so the layout of
those arrays is held on the CPU.

Tolerances: LOCO diffs within 1e-6 absolute (probabilities: f32 forwards
summed in another order; a diff of two probabilities near 1 cancels, so
absolute, not relative) for logits of size up to 8, and in proportion
beyond: naive Bayes' logits are sums of x·log p over the row (~30 here),
whose f32 rounding in another order moves a probability by ~1e-6, so each
model is held to 1e-6 x max(1, max |logit| / 8); group indices equal
wherever the rank gap exceeds that; the emulated kernel within the same of
the twin's diffs; the layers the kernel reads reproduce the model's
probabilities within 1e-6.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transmogrifai_tpu import record_insights as jri  # noqa: E402
from transmogrifai_tpu.columns import Column as JColumn  # noqa: E402
from transmogrifai_tpu.columns import ColumnBatch as JBatch  # noqa: E402
from transmogrifai_tpu.features import Feature as JFeature  # noqa: E402
from transmogrifai_tpu.models import linear as jl  # noqa: E402
from transmogrifai_tpu.types import OPVector as JOPVector  # noqa: E402
from transmogrifai_tpu.vector_meta import VectorColumnMeta as JVCM  # noqa: E402
from transmogrifai_tpu.vector_meta import VectorMeta as JVM  # noqa: E402
from transmogrifai_tpu_torch import convert  # noqa: E402
from transmogrifai_tpu_torch import insights_kernels as ik  # noqa: E402
from transmogrifai_tpu_torch import record_insights as pri  # noqa: E402
from transmogrifai_tpu_torch.columns import Column, ColumnBatch  # noqa: E402
from transmogrifai_tpu_torch.features import Feature  # noqa: E402
from transmogrifai_tpu_torch.types import OPVector  # noqa: E402
from transmogrifai_tpu_torch.vector_meta import (  # noqa: E402
    VectorColumnMeta, VectorMeta)

CPU = torch.device("cpu")
TOL = 1e-6
# raw parents of the 9 columns: groups of 1 to 3 columns, one of them
# scattered (c), so the kernel's columns are not in group order
PARENTS = ["a", "b", "b", "c", "d", "c", "e", "e", "c"]
D, C, N = len(PARENTS), 4, 300
KINDS = ("multinomial", "naive_bayes", "mlp", "mlp_deep")


def _blobs(seed=4):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=1.2, size=(C, D))
    y = rng.integers(0, C, N)
    X = (centres[y] + rng.normal(size=(N, D))).astype(np.float32)
    X[:, 4] = 0.0                                   # a group of zeros
    return X, y.astype(np.float32)


def _metas():
    return (JVM("v", [JVCM(p, "Real", index=i) for i, p in
                      enumerate(PARENTS)]),
            VectorMeta("v", [VectorColumnMeta(p, "Real", index=i)
                             for i, p in enumerate(PARENTS)]))


@pytest.fixture(scope="module")
def models():
    X, y = _blobs()
    fits = {"multinomial": (jl.LinearPredictionModel,
                            jl.OpLogisticRegression(reg_param=0.01)),
            "naive_bayes": (jl.NaiveBayesModel, jl.OpNaiveBayes()),
            "mlp": (jl.MLPClassificationModel,
                    jl.OpMultilayerPerceptronClassifier(max_iter=30)),
            "mlp_deep": (jl.MLPClassificationModel,
                         jl.OpMultilayerPerceptronClassifier(
                             hidden_layers=(6, 5), max_iter=30))}
    out = {}
    for kind, (cls, est) in fits.items():
        Xf = np.abs(X) if kind == "naive_bayes" else X
        jm = cls(fitted=est.fit_arrays(Xf, y))
        pm = convert.prediction_model(
            {"model": cls.__name__,
             "fitted": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                        for k, v in jm.fitted.items()}}, CPU)
        out[kind] = (Xf, jm, pm)
    return out


def _jax_loco(model, X, meta, **kw):
    loco = jri.RecordInsightsLOCO(model=model, **kw)
    loco.set_input(JFeature("v", JOPVector, False, None, parents=()))
    return loco.transform(JBatch({"v": JColumn(JOPVector, X, meta=meta)},
                                 len(X))).values


def _port_loco(model, X, meta, **kw):
    loco = pri.RecordInsightsLOCO(model=model, **kw)
    loco.set_input(Feature("v", OPVector, False, None, parents=()))
    return loco.transform(ColumnBatch(
        {"v": Column(OPVector, torch.as_tensor(X), meta=meta)}, len(X),
        device="cpu")).values


def _rank(v, strategy):
    return {"abs": abs(v), "positive": v, "negative": -v}[strategy]


def _tol(pm, X):
    """1e-6, scaled up with the model's largest |logit| past 8."""
    raw = pm.device_scores(torch.as_tensor(X), full=True)["rawPrediction"]
    return TOL * max(1.0, float(raw.abs().max()) / 8.0)


def _assert_maps_close(want, got, strategy, tol):
    assert len(want) == len(got)
    for rw, rg in zip(want, got):
        pw = [(k, json.loads(v)) for k, v in rw.items()]
        pg = [(k, json.loads(v)) for k, v in rg.items()]
        assert len(pw) == len(pg)
        for (nw, jw), (ng, jg) in zip(pw, pg):
            assert jw[0][0] == nw and jg[0][0] == ng
            if nw != ng:
                assert abs(_rank(jw[0][1], strategy)
                           - _rank(jg[0][1], strategy)) <= tol
        dw = {n: p[0][1] for n, p in pw}
        dg = {n: p[0][1] for n, p in pg}
        for n in set(dw) & set(dg):
            assert abs(dw[n] - dg[n]) <= tol, (n, dw[n], dg[n])


@pytest.mark.parametrize("strategy", ["abs", "positive", "negative"])
@pytest.mark.parametrize("kind", KINDS)
def test_loco_maps_match_jax(models, kind, strategy):
    """The stage's maps by raw parent (top-3 of 5 groups) and meta-less
    (one group per column, k = G) against the JAX stage."""
    X, jm, pm = models[kind]
    jmeta, pmeta = _metas()
    tol = _tol(pm, X)
    _assert_maps_close(_jax_loco(jm, X, jmeta, top_k=3, strategy=strategy),
                       _port_loco(pm, X, pmeta, top_k=3, strategy=strategy),
                       strategy, tol)
    if strategy == "abs":
        _assert_maps_close(_jax_loco(jm, X, None, top_k=D),
                           _port_loco(pm, X, None, top_k=D), strategy, tol)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_layers_reproduce_the_probabilities(models, kind):
    """phi(X) · W1 + b1, then the tail (ReLU before each layer) and the
    softmax, from the arrays the kernel reads, give the model's own
    probabilities."""
    X, _, pm = models[kind]
    Xt = torch.as_tensor(X)
    cg = torch.arange(D, dtype=torch.int32)
    inp = ik.softmax_kernel_inputs(pm, cg, D, CPU)
    a = (torch.clamp(Xt, min=0.0) if inp["relu_in"] else Xt) @ inp["W1"] \
        + inp["b1"]
    tw, dims = inp["tw"], inp["dims"].tolist()
    for i in range(inp["n_tail"]):
        din, dout = dims[i], dims[i + 1]
        W = tw[:din * dout].reshape(din, dout)
        a = torch.relu(a) @ W + tw[din * dout:din * dout + dout]
        tw = tw[din * dout + dout:]
    want = pm.device_scores(Xt)["probability"]
    np.testing.assert_allclose(torch.softmax(a, dim=-1).numpy(),
                               want.numpy(), atol=TOL)
    assert inp["C"] == dims[-1] == C and inp["widths"] == dims
    assert inp["perm"] is None


def _row_list(d, k, strategy):
    """The row form's top-k: each group offered in order and inserted after
    every entry of equal or higher rank (``loco_push``)."""
    val, idx = [], []
    for g, x in enumerate(d):
        key = _rank(x, strategy)
        if len(val) < k:
            val.append(x)
            idx.append(g)
            i = len(val) - 1
        elif key > _rank(val[-1], strategy):
            i = k - 1
        else:
            continue
        while i > 0 and key > _rank(val[i - 1], strategy):
            val[i], idx[i] = val[i - 1], idx[i - 1]
            i -= 1
        val[i], idx[i] = x, g
    return idx, val


def _emulate_kernel(X, inp, G, k, strategy="abs", form="rows"):
    """The kernel's arithmetic in numpy f32 for each row, the same in both
    forms: the base from 32 lane partials (column j to partial j % 32, a
    fused multiply-add chain each, emulated in f64 where an f32 product is
    exact) summed in lane order, each group's columns in ``perm`` order (a
    fused chain) subtracted from the dot, the bias, the tail (each output a
    fused chain over its inputs) and the softmax of the last class after
    the max (numpy's exp, not the card's).  The top-k: the row form's list
    (``_row_list``, indices in ``index_dtype(G)``) or the warp form's rule,
    a stable sort of the rank (int32 indices)."""
    f32 = np.float32
    W1, b1 = inp["W1"].numpy(), inp["b1"].numpy()
    tw, dims = inp["tw"].numpy(), inp["dims"].tolist()
    perm = (np.arange(X.shape[1]) if inp["perm"] is None
            else inp["perm"].numpy())
    goff = inp["goff"].numpy()
    H = dims[0]

    def fma(a, b, c):
        return (np.float64(a) * b.astype(np.float64) + c).astype(f32)

    def prob(a):
        a = a.copy()
        off = 0
        for i in range(inp["n_tail"]):
            din, dout = dims[i], dims[i + 1]
            a = np.maximum(a, f32(0))
            W = tw[off:off + din * dout].reshape(din, dout)
            s = np.zeros(dout, f32)
            for k_ in range(din):
                s = fma(a[k_], W[k_], s)
            a = s + tw[off + din * dout:off + din * dout + dout]
            off += din * dout + dout
        e = np.exp((a - a.max()).astype(f32))
        total = f32(0)
        for v in e:
            total += v
        return f32(e[-1] / total)

    idx, val = [], []
    for x in X:
        phi = np.maximum(x, 0) if inp["relu_in"] else x
        parts = np.zeros((32, H), f32)
        for j in range(len(x)):
            parts[j % 32] = fma(phi[j], W1[j], parts[j % 32])
        dot = np.zeros(H, f32)
        for lane in range(32):
            dot += parts[lane]
        base = prob(dot + b1)
        d = np.empty(G, f32)
        for g in range(G):
            pg = np.zeros(H, f32)
            for c in range(goff[g], goff[g + 1]):
                pg = fma(phi[perm[c]], W1[perm[c]], pg)
            d[g] = base - prob((dot - pg) + b1)
        if form == "rows":
            order, _ = _row_list(d, k, strategy)
        else:
            order = np.argsort(-np.asarray([_rank(v, strategy) for v in d]),
                               kind="stable")[:k]
        idx.append(order)
        val.append(d[order])
    itype = (np.int16 if ik.index_dtype(G) == torch.int16 else np.int32) \
        if form == "rows" else np.int32
    return np.asarray(idx, itype), np.asarray(val, f32)


@pytest.mark.parametrize("kind", KINDS)
def test_emulated_kernel_matches_the_twin(models, kind):
    """The kernel's arithmetic on its own inputs (scattered groups: a
    ``perm``) against the wrapper's CPU twin, and ``model_loco`` takes the
    softmax link for every one of these models.  These widths plan the row
    form (a row a thread), whose lists are the warp form's bit for bit
    under every strategy: the same sums in the same order, the same
    insertion rule (ties to the lower group)."""
    X, _, pm = models[kind]
    _, pmeta = _metas()
    groups = pri.loco_groups(pmeta, D)
    G = len(groups)
    cg = ik.col_group_of(list(groups.values()), D, CPU)
    Xt = torch.as_tensor(X[:60])
    ti, tv = ik.model_loco(pm, Xt, cg, G, G, "abs")
    li, lv = ik.loco_softmax(Xt, pm, cg, G, G, "abs")
    assert torch.equal(ti, li) and torch.equal(tv, lv)
    inp = ik.softmax_kernel_inputs(pm, cg, G, CPU)
    assert inp["perm"] is not None
    plan = ik.loco_softmax_plan(60, D, G, G, inp["H"], inp["C"],
                                inp["widths"][1:])
    assert plan.form == "rows"
    ei, ev = _emulate_kernel(X[:60], inp, G, G)
    assert ei.dtype == np.int16
    for strategy in ik.STRATEGIES:
        for k in (1, 3, G):
            ri, rv = _emulate_kernel(X[:60], inp, G, k, strategy)
            wi, wv = _emulate_kernel(X[:60], inp, G, k, strategy, "warps")
            np.testing.assert_array_equal(ri, wi)
            assert rv.tobytes() == wv.tobytes()
    full = np.zeros((60, G), np.float64)
    np.put_along_axis(full, ti.long().numpy(), tv.numpy(), axis=1)
    tol = _tol(pm, X[:60])
    np.testing.assert_allclose(ev, np.take_along_axis(full, ei, axis=1),
                               atol=tol)
    np.testing.assert_allclose(np.abs(ev), np.abs(tv.numpy()), atol=tol)


@pytest.mark.parametrize("D_,G", [(48, 12), (70, 70), (33, 5)])
def test_emulated_order_past_32_columns(D_, G):
    """Past 32 columns a base partial chains two or three columns: a
    random 4-class multinomial model at D = 33 .. 70 with scattered
    groups, the emulated kernel within 1e-6 of the twin's diffs, its row
    lists the warp form's bits."""
    from transmogrifai_tpu_torch.models.linear import LinearPredictionModel
    rng = np.random.default_rng(D_ + G)
    X = rng.normal(size=(40, D_)).astype(np.float32)
    pm = LinearPredictionModel(fitted={
        "coef": torch.as_tensor(rng.normal(scale=2.0 / D_ ** 0.5,
                                           size=(D_, C)).astype(np.float32)),
        "intercept": torch.as_tensor(rng.normal(size=C).astype(np.float32)),
        "kind": "multinomial", "n_classes": C})
    cg = rng.permutation(np.arange(D_) % G).astype(np.int32)
    cgt = torch.as_tensor(cg)
    inp = ik.softmax_kernel_inputs(pm, cgt, G, CPU)
    k = min(G, 5)
    ri, rv = _emulate_kernel(X, inp, G, k)
    wi, wv = _emulate_kernel(X, inp, G, k, form="warps")
    np.testing.assert_array_equal(ri, wi)
    assert rv.tobytes() == wv.tobytes()
    ti, tv = ik.loco_softmax(torch.as_tensor(X), pm, cgt, G, G, "abs")
    full = np.zeros((40, G), np.float64)
    np.put_along_axis(full, ti.long().numpy(), tv.numpy(), axis=1)
    np.testing.assert_allclose(rv, np.take_along_axis(full, ri.astype(
        np.int64), axis=1), atol=TOL)


@pytest.mark.parametrize("C_,H,tail,G,K", [
    (4, 4, (), 16, 16), (40, 40, (), 16, 16), (4, 10, (4,), 16, 16),
    (4, 6, (5, 4), 128, 20), (300, 300, (), 3, 2), (2, 2, (), 1, 1),
    (4, 4, (), 512, 40), (900, 900, (), 20, 20), (3, 100, (200, 3), 64, 33)])
def test_softmax_plan_sizes_any_shape(C_, H, tail, G, K, monkeypatch):
    """The warp form's sizing (the row form switched off): slots of two
    buffers (the widest of the first layer and every second tail layer;
    the widest of the others) for every lane of every warp, and the tail's
    weights, inside one block's shared memory; fewer warps a block for wide
    models."""
    monkeypatch.setattr(ik, "ROW_WIDTH_MAX", 0)
    plan = ik.loco_softmax_plan(1_000_000, 16, G, K, H, C_, tail)
    assert plan.form == "warps"
    dims = (H,) + tail
    assert plan.slot_b == (max(dims[1::2]) if tail else 0)
    assert plan.slot == max(dims[0::2]) + plan.slot_b
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= ik.THREADS
    assert plan.smem_bytes <= ik.SMEM_MAX
    warps = plan.threads // 32
    assert plan.tail_in_smem
    assert plan.smem_bytes == 4 * (plan.tail_floats
                                   + warps * (32 * (plan.slot | 1) + H))
    assert plan.tail_floats == sum(dims[i] * dims[i + 1] + dims[i + 1]
                                   for i in range(len(tail)))
    assert 1 <= plan.blocks <= ik.BLOCKS_IN_FLIGHT


# every shape the plan tests above and below hold, by (N, D, G, K, H, C,
# tail)
EARLIER_SHAPES = [
    (1_000_000, 16, 16, 16, 4, 4, ()), (1_000_000, 16, 16, 16, 40, 40, ()),
    (1_000_000, 16, 16, 16, 10, 4, (4,)), (1_000_000, 16, 128, 20, 6, 4,
                                            (5, 4)),
    (1_000_000, 16, 3, 2, 300, 300, ()), (1_000_000, 16, 1, 1, 2, 2, ()),
    (1_000_000, 16, 512, 40, 4, 4, ()), (1_000_000, 16, 20, 20, 900, 900,
                                         ()),
    (1_000_000, 16, 64, 33, 100, 3, (200, 3)),
    (1_000_000, 16, 16, 5, 256, 4, (256, 4)),
    (1_000_000, 16, 16, 5, 900, 4, (4,)), (1_000_000, 16, 16, 5, 512, 4,
                                           (4,)),
    (10, 16, 4, 2, 2000, 2000, ()), (1_000_000, 16, 16, 5, 1800, 1800, ()),
    (1_000_000, 16, 16, 5, 2048, 4, (4,)), (1_000_000, 16, 16, 5, 64, 4,
                                            (2048, 4)),
    (1_000, 16, 16, 5, 1800, 4, (4,)), (1_000_000, 16, 16, 5, 1700, 4, (4,)),
    (1_000_000, 16, 16, 5, 16, 4, (4,)), (100_000, 512, 128, 20, 4, 4, ()),
    (100_000, 512, 128, 40, 4, 4, ()), (1_000, 16, 16, 5, 2048, 4, (4,))]


@pytest.mark.parametrize("shape", EARLIER_SHAPES)
def test_softmax_plan_still_plans_every_earlier_shape(shape):
    """Each shape the earlier plan tests hold plans under the threshold,
    in the form it picks: the row form within one block's shared memory
    (its 4 (D H + H + tail + R x_stride + 2 K (R + 1)) bytes), every layer
    within its register width; else the warp form, as sized before."""
    N, D_, G, K, H, C_, tail = shape
    plan = ik.loco_softmax_plan(*shape)
    dims = (H,) + tail
    tw = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(tail)))
    assert plan.tail_floats == tw
    if plan.form == "rows":
        R = plan.threads
        assert R in ik.ROW_ROWS and plan.blocks == max(1, -(-N // R))
        assert max(dims) <= plan.hm in (4, 8, 16)
        assert plan.x_stride == D_ | 1 and plan.scratch_floats == 0
        assert plan.smem_bytes == 4 * (D_ * H + H + tw + R * plan.x_stride
                                       + 2 * K * (R + 1)) <= ik.SMEM_MAX
    else:
        # too wide, too long a row, or the row form's block of 32 rows
        # past shared memory
        assert max(dims) > ik.ROW_WIDTH_MAX or D_ > ik.ROW_D_MAX or 4 * (
            D_ * H + H + tw + 32 * (D_ | 1) + 2 * K * 33) > ik.SMEM_MAX
        assert plan.hm == 0 and plan.x_stride == 0
        per_warp = 32 * (plan.slot | 1) + H
        if plan.scratch_floats:
            assert 4 * plan.scratch_floats <= ik.SLOT_SCRATCH_BYTES
        else:
            assert plan.smem_bytes == 4 * (tw * plan.tail_in_smem
                                           + plan.threads // 32 * per_warp)
        assert plan.smem_bytes <= ik.SMEM_MAX


@pytest.mark.parametrize("D_,G,K,H,C_,tail,form,rows", [
    (16, 16, 16, 4, 4, (), "rows", 128),        # the multiclass winner
    (16, 16, 16, 10, 4, (4,), "rows", 128),     # the 16-10-4 MLP
    (16, 16, 16, 16, 16, (), "rows", 128),      # at the widest register
    (16, 16, 16, 17, 17, (), "warps", 0),       # one class past it
    (16, 16, 16, 16, 4, (17, 4), "warps", 0),   # a tail layer past it
    (16, 16, 16, 40, 40, (), "warps", 0),       # 40 classes
    (96, 24, 20, 4, 4, (), "rows", 128),        # the widest row
    (97, 24, 20, 4, 4, (), "warps", 0),         # a column past it
    (512, 128, 20, 4, 4, (), "warps", 0),       # bench_loco
    (1596, 10, 10, 4, 4, (), "warps", 0),       # the transmog width
    (16, 4000, 4000, 4, 4, (), "warps", 0),     # top-K lists past a block
    (16, 600, 600, 4, 4, (), "rows", 32),       # fewer rows a block
    (96, 1000, 200, 16, 16, (), "rows", 64)])
def test_softmax_plan_chooses_the_form_at_its_threshold(D_, G, K, H, C_, tail,
                                                        form, rows):
    """The row form wherever every layer is at most ``ROW_WIDTH_MAX`` (16)
    wide, the row at most ``ROW_D_MAX`` (96) columns and a block of 128, 64
    or 32 rows holds its state (the most rows that fit); else the warp
    form."""
    plan = ik.loco_softmax_plan(100_000, D_, G, K, H, C_, tail)
    assert plan.form == form
    if form == "rows":
        assert plan.threads == rows
        assert plan.hm == next(w for w in (4, 8, 16)
                               if max((H,) + tail) <= w)


@pytest.mark.parametrize("H,tail,staged", [
    (256, (256, 4), False), (900, (4,), True), (512, (4,), True)])
def test_softmax_plan_holds_wide_and_deep_mlps(H, tail, staged):
    """MLPs of ``hidden_layers=(256, 256)`` (the tail's 66,820 weights
    leave the block: read from device memory beside the slots) and of one
    hidden layer of 900 or 512 (the second buffer holds the 4 logits, not
    another layer's width) with 4 classes."""
    plan = ik.loco_softmax_plan(1_000_000, 16, 16, 5, H, 4, tail)
    assert plan.tail_in_smem is staged
    assert plan.smem_bytes <= ik.SMEM_MAX
    assert plan.slot == max(((H,) + tail)[0::2]) + max(tail[0::2])
    assert plan.smem_bytes == 4 * (plan.tail_floats * staged
                                   + plan.threads // 32
                                   * (32 * (plan.slot | 1) + H))


@pytest.mark.parametrize("args,match", [
    ((10, 16, 4, 5, 4, 4, ()), "K <= G"), ((10, 16, 4, 0, 4, 4, ()), "K"),
    ((10, 16, 4, 2, 4, 1, ()), "C >= 2"), ((10, 16, 4, 2, 4, 3, ()), "C=3"),
    ((10, 16, 4, 2, 10, 4, (5,)), "outputs")])
def test_softmax_plan_raises_on_shapes_it_cannot_hold(args, match):
    with pytest.raises(ValueError, match=match):
        ik.loco_softmax_plan(*args)


@pytest.mark.parametrize("args", [
    (10, 16, 4, 2, 2000, 2000, ()),                 # 2,000 classes
    (1_000_000, 16, 16, 5, 1800, 1800, ()),         # 1,800 classes
    (1_000_000, 16, 16, 5, 2048, 4, (4,)),          # hidden_layers=(2048,)
    (1_000_000, 16, 16, 5, 64, 4, (2048, 4)),       # hidden_layers=(64, 2048)
    (1_000, 16, 16, 5, 1800, 4, (4,))])
def test_softmax_plan_holds_slots_past_shared_memory(args):
    """Where one warp's slots do not fit shared memory, the plan puts the
    slots of 8 warps a block in device memory (lane-interleaved, one region
    a warp in flight, within ``SLOT_SCRATCH_BYTES``) and stages the tail's
    weights where they fit."""
    N, D, G, K, H, C_, tail = args
    plan = ik.loco_softmax_plan(*args)
    dims = (H,) + tail
    per_warp = 32 * (plan.slot | 1) + H
    assert 4 * per_warp > ik.SMEM_MAX
    assert plan.threads == ik.THREADS
    assert plan.slot == max(dims[0::2]) + (max(dims[1::2]) if tail else 0)
    assert plan.scratch_floats == plan.blocks * plan.threads // 32 * per_warp
    assert 4 * plan.scratch_floats <= ik.SLOT_SCRATCH_BYTES
    assert 1 <= plan.blocks <= min(ik.BLOCKS_IN_FLIGHT, -(-N // 8))
    assert plan.tail_in_smem is (4 * plan.tail_floats <= ik.SMEM_MAX)
    assert plan.smem_bytes == 4 * plan.tail_floats * plan.tail_in_smem


@pytest.mark.parametrize("H,tail", [(256, (256, 4)), (900, (4,)),
                                    (512, (4,)), (1700, (4,)), (16, (4,))])
def test_softmax_plan_keeps_shared_slots_where_they_fit(H, tail):
    """Every shape whose slots fit shared memory keeps them there."""
    plan = ik.loco_softmax_plan(1_000_000, 16, 16, 5, H, 4, tail)
    assert plan.scratch_floats == 0 and plan.smem_bytes <= ik.SMEM_MAX


def test_wide_mlp_twin_matches_jax_loco():
    """A 1,000 x 16 MLP with ``hidden_layers=(2048,)`` and 4 classes (random
    weights from a seed, one group a column, top-5): the port's LOCO (the
    twin on the CPU) within 1e-6 of the JAX stage's diffs."""
    rng = np.random.default_rng(16)
    n, d, h, c = 1000, 16, 2048, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    fitted = {"n_layers": 2, "n_classes": c,
              "W0": rng.normal(scale=(2.0 / d) ** 0.5, size=(d, h))
              .astype(np.float32),
              "b0": rng.normal(scale=0.1, size=h).astype(np.float32),
              "W1": rng.normal(scale=(2.0 / h) ** 0.5, size=(h, c))
              .astype(np.float32),
              "b1": rng.normal(scale=0.1, size=c).astype(np.float32)}
    jm = jl.MLPClassificationModel(fitted=fitted)
    pm = convert.prediction_model({"model": "MLPClassificationModel",
                                   "fitted": fitted}, CPU)
    assert ik.loco_softmax_plan(n, d, d, 5, h, c, (c,)).scratch_floats > 0
    _assert_maps_close(_jax_loco(jm, X, None, top_k=5),
                       _port_loco(pm, X, None, top_k=5), "abs", TOL)


def test_models_without_a_softmax_link_are_refused():
    """``softmax_layers`` refuses a binary linear model; ``model_loco``
    refuses a model with no LOCO kernel at all."""
    from transmogrifai_tpu_torch.models.base import PredictionModel
    from transmogrifai_tpu_torch.models.linear import LinearPredictionModel
    binary = LinearPredictionModel(fitted={"coef": torch.ones(3),
                                           "intercept": torch.zeros(1),
                                           "kind": "binary"})
    with pytest.raises(ValueError, match="no softmax link"):
        ik.softmax_layers(binary, CPU)

    class Other(PredictionModel):
        def device_scores(self, X, full=False):
            return {"prediction": X[:, 0]}

    with pytest.raises(NotImplementedError, match="no LOCO kernel"):
        ik.model_loco(Other(fitted={}), torch.ones((2, 3)),
                      torch.arange(3, dtype=torch.int32), 3, 1, "abs")
