"""The port's sparse hashed-text path against the JAX package, on the CPU:
``SparseMatrix`` and its products, the host dedupe of hashed tokens, block
stacking, SmartTextVectorizer's sparse routing, the sparse FISTA grid fit
and the whole slice (``bench.run_text_sparse``'s workflow at 600 rows ×
4,096 hashes).

Tolerances: containers, triples, routing, widths, nnz and metadata exactly
equal; the ``sp_*`` twins rtol 1e-6 / atol 1e-6 (the same f32 products
added in another order); the sparse gradient seam against the dense
``fista_step`` twin on the densified matrix rtol 1e-5 / atol 1e-7 (f32
sums in another order); grid-fit coefficients and intercepts rtol 1e-4 /
atol 1e-5 (50 FISTA iterations of f32 sums in another order), ``n_iter``
within ±2 with at most 2 lanes apart (ROADMAP queue 3's tolerance-stop
hazard); CV AuPR and train AuROC within 1e-4, the same winner; fresh-batch
predictions equal, probabilities rtol 1e-5 / atol 1e-6."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import sparse_reference as sr  # noqa: E402
from transmogrifai_tpu.models import solvers as js  # noqa: E402
from transmogrifai_tpu.sparse import matrix as jm  # noqa: E402
from transmogrifai_tpu.sparse import transform as jt  # noqa: E402
from transmogrifai_tpu_torch.models import kernels  # noqa: E402
from transmogrifai_tpu_torch.models import linear_kernels as lk  # noqa: E402
from transmogrifai_tpu_torch.models import solvers as ps  # noqa: E402
from transmogrifai_tpu_torch.sparse import matrix as pm  # noqa: E402
from transmogrifai_tpu_torch.sparse import sparse_kernels as sk  # noqa: E402
from transmogrifai_tpu_torch.sparse import transform as pt  # noqa: E402

JAX, PORT = sr.PACKAGES["jax"], sr.PACKAGES["torch"]
CPU = "cpu"


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _coo(seed=0, n=90, d=40):
    """COO triples with duplicate entries, empty rows (every 7th), empty
    columns (the last 5) and column 3 holding every row."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 500)
    r = r[r % 7 != 0]
    c = rng.integers(0, d - 5, len(r))
    r = np.concatenate([r, r[:40], np.arange(n)])        # duplicates
    c = np.concatenate([c, c[:40], np.full(n, 3)])       # a full column
    v = rng.normal(size=len(r)).astype(np.float32)
    return r, c, v, n, d


def _both(r, c, v, n, d):
    return (jm.SparseMatrix.from_coo(r, c, v, n, d),
            pm.SparseMatrix.from_coo(r, c, v, n, d, device=CPU))


def _sorted_triples(rows, cols, vals):
    o = np.lexsort((_np(cols), _np(rows)))
    return _np(rows)[o], _np(cols)[o], _np(vals)[o]


# --------------------------------------------------------------------------
# container
# --------------------------------------------------------------------------

def test_nnz_capacity_equals_the_jax_ladder():
    for n in list(range(0, 5000, 97)) + [10**6, 9_000_123]:
        assert pm.nnz_capacity(n) == jm.nnz_capacity(n)


def test_from_coo_from_dense_and_to_dense_equal_the_jax_package():
    js_, ps_ = _both(*_coo())
    np.testing.assert_array_equal(_np(ps_.to_dense()),
                                  np.asarray(js_.to_dense()))
    assert ps_.shape == js_.shape and ps_.nnz == js_.nnz
    assert ps_.density == js_.density and ps_.ndim == 2
    assert ps_.dtype == torch.float32 and ps_.device == torch.device(CPU)
    assert ps_.nbytes == 12 * ps_.nnz
    x = np.asarray(js_.to_dense())
    jd, pd = jm.SparseMatrix.from_dense(x), pm.SparseMatrix.from_dense(
        x, device=CPU)
    assert pd.nnz == jd.nnz
    np.testing.assert_array_equal(_np(pd.to_dense()), x)
    with pytest.raises(ValueError, match="outside"):
        pm.SparseMatrix.from_coo([0, 5], [1, 1], [1.0, 2.0], 5, 3,
                                 device=CPU)


def test_take_rows_and_pad_rows_equal_the_jax_package():
    js_, ps_ = _both(*_coo(1))
    idx = np.array([3, 3, 0, 89, 7, 14, 3, 50])     # duplicates, empty rows
    np.testing.assert_array_equal(_np(ps_.take_rows(idx).to_dense()),
                                  np.asarray(js_.take_rows(idx).to_dense()))
    np.testing.assert_array_equal(ps_.dense_rows(idx), js_.dense_rows(idx))
    pj, pp = js_.pad_rows(128), ps_.pad_rows(128)
    assert pp.shape == pj.shape and pp.nnz == ps_.nnz
    np.testing.assert_array_equal(_np(pp.to_dense()),
                                  np.asarray(pj.to_dense()))
    with pytest.raises(IndexError):
        ps_.take_rows([90])


def test_refuses_implicit_densify():
    _, ps_ = _both(*_coo())
    with pytest.raises(TypeError, match="to_dense"):
        np.asarray(ps_)


def test_sorted_orders_and_pointers():
    """The row- and column-sorted orders hold every entry once, segments
    ascending, other coordinate ascending within a segment (stable), with
    pointers that bound each segment."""
    r, c, v, n, d = _coo(2)
    X = pm.SparseMatrix.from_coo(r, c, v, n, d, device=CPU)
    for order, nseg, seg_of, gat_of in ((X.row_order(), n, r, c),
                                        (X.col_order(), d, c, r)):
        seg = _np(order.segment)
        assert (np.diff(seg) >= 0).all()
        ptr = _np(order.ptr)
        assert ptr[0] == 0 and ptr[-1] == len(v) and len(ptr) == nseg + 1
        np.testing.assert_array_equal(np.diff(ptr),
                                      np.bincount(seg_of, minlength=nseg))
        got = sorted(zip(seg, _np(order.gather), _np(order.values)))
        want = sorted(zip(seg_of, gat_of, v))
        assert got == want
    cg = _np(X.col_order().gather)
    for s in range(d):
        a, b = _np(X.col_order().ptr)[s:s + 2]
        assert (np.diff(cg[a:b]) >= 0).all()


# --------------------------------------------------------------------------
# products
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op,k", [("matvec", 1), ("rmatvec", 1),
                                  ("matmat", 1), ("matmat", 6),
                                  ("rmatmat", 3), ("rmatmat", 40)])
def test_product_twins_equal_the_jax_package(op, k):
    r, c, v, n, d = _coo(3)
    js_, ps_ = _both(r, c, v, n, d)
    rng = np.random.default_rng(k)
    other = n if op.startswith("r") else d
    dense = rng.normal(size=(other, k) if op.endswith("mat")
                       else other).astype(np.float32)
    kernels.reset_launch_counts()
    got = _np(getattr(ps_, op)(torch.as_tensor(dense)))
    fn = {"matvec": jm.sp_matvec, "rmatvec": jm.sp_rmatvec,
          "matmat": jm.sp_matmat, "rmatmat": jm.sp_rmatmat}[op]
    kw = ({"n_cols": d} if op.startswith("r") else {"n_rows": n})
    want = np.asarray(fn(js_.values, js_.indices, js_.row_ids,
                         jnp.asarray(dense), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # CPU tensors take the twins: no kernel launched
    assert not any(kernels.launch_counts().values())


def test_wrappers_check_their_operand():
    _, ps_ = _both(*_coo())
    with pytest.raises(ValueError, match="rows"):
        sk.sp_matmat(ps_, torch.zeros((ps_.n_cols + 1, 2)))
    with pytest.raises(TypeError, match="dtype"):
        sk.sp_rmatmat(ps_, torch.zeros((ps_.n_rows, 2), dtype=torch.float64))
    assert sk.sp_matmat(ps_, torch.zeros((ps_.n_cols, 0))).shape == (
        ps_.n_rows, 0)


def test_elementwise_maps_values_and_keeps_the_orders():
    r, c, v, n, d = _coo(4)
    X = pm.SparseMatrix.from_coo(r, c, v, n, d, device=CPU)
    X2 = X.elementwise(torch.square)
    np.testing.assert_array_equal(_np(X2.col_order().values),
                                  _np(X.col_order().values) ** 2)
    ref = pm.SparseMatrix.from_coo(r, c, v * v, n, d, device=CPU)
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 2))
                        .astype(np.float32))
    np.testing.assert_allclose(_np(X2.rmatmat(g)), _np(ref.rmatmat(g)),
                               rtol=1e-6, atol=1e-6)


def test_sparse_entry_points_default_to_cuda_and_never_fall_back(
        monkeypatch):
    """With no device the sparse constructors mean CUDA, and raise where
    CUDA is absent instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.SparseMatrix.from_coo([0], [1], [1.0], 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.sparse_from_hash_flat([2, 0], [3, 3], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.combine_blocks([np.eye(3, dtype=np.float32)], 3)
    _, ps_ = _both(*_coo())
    with pytest.raises(RuntimeError, match="CUDA"):
        ps_.to("cuda")


# --------------------------------------------------------------------------
# hashed text → sparse, block stacking
# --------------------------------------------------------------------------

def _token_stream(seed=5, n=70, H=16):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, n)                     # empty rows included
    lens[-1] = 0
    flat = rng.integers(0, H, int(lens.sum()))       # H = 16: collisions
    return lens, flat


@pytest.mark.parametrize("binary", [False, True])
def test_sparse_from_hash_flat_triples_equal_the_jax_package(binary):
    lens, flat = _token_stream()
    j = jt.sparse_from_hash_flat(lens, flat, 16, binary=binary,
                                 record=False)
    p = pt.sparse_from_hash_flat(lens, flat, 16, binary=binary,
                                 record=False, device=CPU)
    assert p.shape == j.shape == (70, 16)
    for a, b in zip(_sorted_triples(*p.host_coo()),
                    _sorted_triples(*j.host_coo())):
        np.testing.assert_array_equal(a, b)
    # rows come out row-major sorted: the row order is the stream itself
    assert p.row_order().values is p.values
    empty = pt.sparse_from_hash_flat([0, 0, 0], [], 50_000, record=False,
                                     device=CPU).pad_rows(8)
    assert empty.shape == (8, 50_000) and empty.nnz == 0


def test_hash_tokens_to_sparse_equals_the_jax_package():
    rng = np.random.default_rng(6)
    words = [f"w{i}" for i in range(40)]
    tokens = [list(rng.choice(words, size=int(rng.integers(0, 7))))
              for _ in range(50)]
    j = jt.hash_tokens_to_sparse(tokens, 97)
    p = pt.hash_tokens_to_sparse(tokens, 97, device=CPU)
    np.testing.assert_array_equal(_np(p.to_dense()), np.asarray(j.to_dense()))


def test_combine_blocks_equals_the_jax_package_and_records_stats():
    r, c, v, n, d = _coo(7, n=30, d=12)
    js_, ps_ = _both(r, c, v, n, d)
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    dense[rng.random((n, 3)) < 0.5] = 0.0
    col = (rng.random(n) < 0.3).astype(np.float32)
    j = jt.combine_blocks([dense, js_, col], n, record=False)
    pt.reset_sparse_stats()
    p = pt.combine_blocks([torch.as_tensor(dense), ps_, col], n, device=CPU)
    np.testing.assert_array_equal(_np(p.to_dense()), np.asarray(j.to_dense()))
    assert p.nnz == j.nnz and p.shape == (n, 16)
    stats = pt.sparse_stats()
    assert stats["matrices"] == 1 and stats["nnz_total"] == p.nnz
    assert stats["density"] == p.density
    assert pt.combine_blocks([ps_], n, record=False) is ps_
    assert pt.combine_blocks([ps_], n, record=False, device=CPU) is ps_
    with pytest.raises(ValueError, match="rows"):
        pt.combine_blocks([ps_, dense[:5]], n, device=CPU)
    pt.reset_sparse_stats()
    assert pt.sparse_stats()["nnz_total"] == 0


# --------------------------------------------------------------------------
# SmartTextVectorizer routing and output
# --------------------------------------------------------------------------

def _text_batch(pkg, n=80, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(300)]
    txt = [" ".join(rng.choice(vocab, size=5)) for _ in range(n)]
    txt[3] = None
    cats = [f"c{i % 4}" for i in range(n)]
    T = sr._mod(pkg, "types")
    C = sr._mod(pkg, "columns")
    return C.ColumnBatch({"txt": C.column_from_values(T.Text, txt),
                          "cat": C.column_from_values(T.Text, cats)}, n)


def _vectorize(pkg, num_hashes, sparse_hashing, names=("txt",)):
    F = sr._mod(pkg, "features")
    st = sr._mod(pkg, "ops.text").SmartTextVectorizer(
        max_cardinality=5, num_hashes=num_hashes,
        sparse_hashing=sparse_hashing)
    st.set_input(*[F.FeatureBuilder.Text(n).as_predictor() for n in names])
    batch = _text_batch(pkg)
    if pkg == PORT:
        batch = batch.on(CPU)
    model = st.fit(batch)
    return model, model.transform(batch)


@pytest.mark.parametrize("num_hashes,sparse_hashing,expect_sparse", [
    (4096, "auto", True), (512, "auto", False),
    (4096, False, False), (64, True, True)])
def test_smart_text_vectorizer_sparse_routing(num_hashes, sparse_hashing,
                                              expect_sparse):
    for pkg, SM in ((JAX, jm.SparseMatrix), (PORT, pm.SparseMatrix)):
        model, col = _vectorize(pkg, num_hashes, sparse_hashing)
        assert bool(model.metadata["sparse"]) is expect_sparse
        assert isinstance(col.values, SM) is expect_sparse
        assert col.values.shape == (80, num_hashes + 1)


@pytest.mark.parametrize("num_hashes,sparse_hashing", [(4096, "auto"),
                                                      (64, True)])
def test_sparse_output_and_metadata_equal_the_jax_package(num_hashes,
                                                          sparse_hashing):
    """A pivoted feature and a hashed one with its null column: the same
    matrix and the same column names as the JAX package."""
    out = {pkg: _vectorize(pkg, num_hashes, sparse_hashing, ("cat", "txt"))
           for pkg in (JAX, PORT)}
    (_, jcol), (_, pcol) = out[JAX], out[PORT]
    assert isinstance(pcol.values, pm.SparseMatrix)
    np.testing.assert_array_equal(_np(pcol.values.to_dense()),
                                  np.asarray(jcol.values.to_dense()))
    assert pcol.meta.column_names() == jcol.meta.column_names()


def test_vectors_combiner_goes_sparse_with_the_same_layout():
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import Feature
    from transmogrifai_tpu_torch.ops.combiner import VectorsCombiner
    r, c, v, n, d = _coo(8, n=20, d=9)
    sm = pm.SparseMatrix.from_coo(r, c, v, n, d, device=CPU)
    dense = torch.as_tensor(np.random.default_rng(8).normal(size=(n, 2))
                            .astype(np.float32))
    batch = ColumnBatch({"a": Column(T.OPVector, dense),
                         "b": Column(T.OPVector, sm)}, n, CPU)
    comb = VectorsCombiner().set_input(
        *[Feature(k, T.OPVector, False, None, parents=()) for k in "ab"])
    out = comb.transform(batch)
    assert isinstance(out.values, pm.SparseMatrix)
    np.testing.assert_array_equal(
        _np(out.values.to_dense()),
        np.concatenate([_np(dense), _np(sm.to_dense())], axis=1))
    assert out.meta.size == 11
    sub = batch.with_columns({"v": out}).take_rows([4, 4, 0])
    np.testing.assert_array_equal(_np(sub["v"].values.to_dense()),
                                  _np(out.values.to_dense())[[4, 4, 0]])


def test_vectors_combiner_reuses_its_metadata_while_the_blocks_do():
    """Blocks that hand back the same metadata objects (a fitted
    vectorizer's) get the same flattened metadata object, equal to a fresh
    ``VectorMeta.flatten``; a block with new metadata gets it rebuilt."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import Feature
    from transmogrifai_tpu_torch.ops.combiner import VectorsCombiner
    from transmogrifai_tpu_torch.vector_meta import (VectorColumnMeta,
                                                     VectorMeta)

    def meta(name, n):
        return VectorMeta(name, [VectorColumnMeta(name, "Text", None, None,
                                                  f"h{i}", i)
                                 for i in range(n)])
    r, c, v, n, d = _coo(8, n=20, d=9)
    sm = pm.SparseMatrix.from_coo(r, c, v, n, d, device=CPU)
    dense = torch.ones(n, 2)
    ma, mb = meta("a", 2), meta("b", 9)

    def batch(mb):
        return ColumnBatch({"a": Column(T.OPVector, dense, meta=ma),
                            "b": Column(T.OPVector, sm, meta=mb)}, n, CPU)
    comb = VectorsCombiner().set_input(
        *[Feature(k, T.OPVector, False, None, parents=()) for k in "ab"])
    first = comb.transform(batch(mb)).meta
    assert comb.transform(batch(mb)).meta is first
    assert first == VectorMeta.flatten(comb.output_name(), [ma, mb])
    assert [col.index for col in first.columns] == list(range(11))
    other = meta("b", 3)
    again = comb.transform(batch(other)).meta
    assert again is not first and again.size == 5
    assert again == VectorMeta.flatten(comb.output_name(), [ma, other])


# --------------------------------------------------------------------------
# the sparse fitters
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def text_problem():
    """Hashed 8-token rows (64 hashes: collisions) plus one dense column
    with every row, a label that follows the tokens, and 3 CV folds."""
    rng = np.random.default_rng(9)
    n, H = 300, 64
    y = rng.integers(0, 2, n)
    lens = np.full(n, 8)
    flat = np.where(np.repeat(y, 8) == 1, rng.integers(0, 40, 8 * n),
                    rng.integers(24, H, 8 * n))
    hj = jt.sparse_from_hash_flat(lens, flat, H, record=False)
    x0 = rng.normal(size=(n, 1)).astype(np.float32)
    Xj = jt.combine_blocks([hj, x0], n, record=False)
    r, c, v = (np.asarray(a) for a in Xj.host_coo())
    Xp = pm.SparseMatrix.from_coo(r, c, v, n, H + 1, device=CPU)
    W = np.zeros((3, n), np.float32)
    for f, idx in enumerate(np.array_split(rng.permutation(n), 3)):
        W[f] = 1.0
        W[f, idx] = 0.0
    return Xj, Xp, y.astype(np.float32), W


def test_sparse_gradient_seam_equals_the_dense_twin(text_problem):
    _, Xp, y, W = text_problem
    rng = np.random.default_rng(10)
    L, G, D = 6, 2, Xp.n_cols
    V = torch.as_tensor(rng.normal(scale=0.1, size=(L, D)).astype(np.float32))
    b = torch.as_tensor(rng.normal(scale=0.1, size=L).astype(np.float32))
    zero = torch.zeros(L)
    Wt = torch.as_tensor(W)
    wsum = Wt.sum(dim=1).repeat_interleave(G)
    Xd = Xp.to_dense()
    assert lk.grad_seam(Xp) is lk.sparse_fista_step
    assert lk.grad_seam(Xd) is lk.fista_step
    for loss, yt in (("logistic", torch.as_tensor(y)),
                     ("squared_hinge", ps.loss_target("squared_hinge",
                                                      torch.as_tensor(y))),
                     ("gram", None)):
        gs, ss = lk.sparse_fista_step(Xp, V, zero, b, Wt, yt, wsum, G, loss)
        gd, sd = lk.fista_step_twin(Xd, V, zero, b, Wt, yt, wsum, G, loss)
        torch.testing.assert_close(gs, gd, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(ss, sd, rtol=1e-5, atol=1e-7)


def test_sparse_linear_grid_fit_matches_jax(text_problem):
    Xj, Xp, y, W = text_problem
    l2s = np.array([0.01, 0.1, 0.0, 0.05], np.float32)
    l1s = np.array([0.0, 0.0, 0.01, 0.02], np.float32)
    ref = js.sparse_linear_grid_fit(
        Xj.values, Xj.indices, Xj.row_ids, jnp.asarray(y), jnp.asarray(W),
        jnp.asarray(l2s), jnp.asarray(l1s), n_rows=Xj.n_rows,
        n_cols=Xj.n_cols, max_iter=50, tol=1e-6)
    port = ps.sparse_linear_grid_fit(
        Xp, torch.as_tensor(y), torch.as_tensor(W), torch.as_tensor(l2s),
        torch.as_tensor(l1s), max_iter=50, tol=1e-6)
    np.testing.assert_allclose(_np(port.coef), np.asarray(ref.coef),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(port.intercept),
                               np.asarray(ref.intercept), rtol=1e-4,
                               atol=1e-5)
    apart = np.abs(_np(port.n_iter) - np.asarray(ref.n_iter))
    assert apart.max() <= 2 and (apart > 0).sum() <= 2
    # the absent columns keep zero coefficients (scale clamps, no signal)
    absent = np.bincount(_np(Xp.indices), minlength=Xp.n_cols) == 0
    assert (_np(port.coef)[..., absent] == 0).all()


def test_sparse_fista_fit_is_the_one_lane_grid(text_problem):
    Xj, Xp, y, W = text_problem
    ref = js.sparse_fista_fit(Xj, jnp.asarray(y), jnp.asarray(W[0]), 0.01,
                              0.0, max_iter=50)
    port = ps.sparse_fista_fit(Xp, torch.as_tensor(y), torch.as_tensor(W[0]),
                               0.01, 0.0, max_iter=50)
    np.testing.assert_allclose(_np(port.coef), np.asarray(ref.coef),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(port.intercept),
                               np.asarray(ref.intercept), rtol=1e-4,
                               atol=1e-5)
    assert abs(int(port.n_iter) - int(ref.n_iter)) <= 2
    # the estimator's single fit on a SparseMatrix is that same lane
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    fit = OpLogisticRegression(reg_param=0.01, max_iter=50).fit_arrays(
        Xp, y, sample_weight=W[0])
    assert torch.equal(fit["coef"], port.coef)
    assert torch.equal(fit["intercept"], port.intercept)


def test_tree_families_on_a_sparse_matrix_raise_naming_the_slice(
        text_problem):
    from transmogrifai_tpu_torch.models.trees import (OpGBTClassifier,
                                                      OpRandomForestClassifier)
    _, Xp, y, W = text_problem
    for est in (OpGBTClassifier(max_iter=2, max_depth=2),
                OpRandomForestClassifier(num_trees=2, max_depth=2)):
        with pytest.raises(NotImplementedError, match="later slice"):
            est.fit_arrays_grid(Xp, y, W, [{}])
        with pytest.raises(NotImplementedError, match="later slice"):
            est.fit_arrays(Xp, y)


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------

ROWS, HASHES = 600, 4096


@pytest.fixture(scope="module")
def trained():
    """Both packages' workflows on the bench's columns at 600 rows × 4,096
    hashes, each scored on a fresh seed-7 batch."""
    out = {}
    for pkg in (JAX, PORT):
        kw = {"device": CPU} if pkg == PORT else {}
        wf, batch, pred = sr.build(pkg, ROWS, num_hashes=HASHES, **kw)
        model = wf.train()
        fresh = sr.raw_batch(pkg, wf.raw_features, ROWS, seed=7)
        vals = model.score(batch=fresh)[pred.name].values
        out[pkg] = {"model": model, "facts": sr.facts(pkg, model, batch),
                    "pred": _np(vals["prediction"]),
                    "prob": _np(vals["probability"])}
    return out


def test_generator_equals_the_bench_generator_value_by_value():
    from bench import make_sparse_text_columns as bench_cols
    from transmogrifai_tpu_torch.synthetic import make_sparse_text_columns
    records, y = bench_cols(500, seed=11)
    cols, schema = make_sparse_text_columns(500, seed=11)
    assert list(cols["txt"].values) == [r["txt"] for r in records]
    np.testing.assert_array_equal(cols["x0"].values,
                                  np.float32([r["x0"] for r in records]))
    np.testing.assert_array_equal(cols["label"].values, y.astype(np.float32))
    assert sorted(schema) == ["label", "txt", "x0"]


def test_slice_matches_the_jax_package(trained):
    a, b = trained[PORT]["facts"], trained[JAX]["facts"]
    assert a["width"] == b["width"] == HASHES + 3
    assert a["nnz"] == b["nnz"] and a["density"] == b["density"]
    assert a["winner"] == b["winner"]
    assert a["cv_aupr"].keys() == b["cv_aupr"].keys()
    for k, v in b["cv_aupr"].items():
        assert abs(a["cv_aupr"][k] - v) <= 1e-4, k
    assert abs(a["train_auroc"] - b["train_auroc"]) <= 1e-4


def test_fresh_batch_predictions_match_the_jax_package(trained):
    np.testing.assert_array_equal(trained[PORT]["pred"],
                                  trained[JAX]["pred"])
    np.testing.assert_allclose(trained[PORT]["prob"], trained[JAX]["prob"],
                               rtol=1e-5, atol=1e-6)


def test_the_selector_trains_on_the_sparse_matrix(trained):
    model = trained[PORT]["model"]
    coef = model.selected_model.best_model.fitted["coef"]
    assert tuple(coef.shape) == (HASHES + 3,)
    assert set(model.phase_seconds) >= {
        "SmartTextVectorizer", "RealVectorizer", "VectorsCombiner",
        "BinaryClassificationModelSelector"}
