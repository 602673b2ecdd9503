"""``multiclass_confusion``'s two forms on the CPU: ``confusion_plan`` and a
numpy emulation of the card kernel's summation order on the wrapper's own
arrays (``metrics_kernels.confusion_emulate``), against the twin and the
JAX package's ``masked_multiclass_confusion``.

The thread form (C <= 14; a thread's own cells in shared memory) sums
each thread's rows in row order (one candidate a thread, rows
a grid-stride walk), adds a block's threads of one candidate in a fixed
tree, then the blocks in the reduction kernel's order; the shared form
(C > 14) adds each 32 rows' group of a cell in lane order into a warp's
histogram, then the warps in order, then the blocks.
The card kernel is held to the emulation's bits by
``tests/test_torch_cuda.py``.

Tolerances: equal to the twin and to the JAX package on 0/1 fold masks
(integer sums below 2^24 are exact in any order); within 1e-6 of the f64
sums, relative to max(|sum|, 1), on real weights in [0, 1) (f32 sums of
up to a few hundred terms a thread, then a tree: ~1e-7 here), and the
JAX package's f32 one-hot matmul within the same.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from transmogrifai_tpu import metrics_device as jmd  # noqa: E402
from transmogrifai_tpu_torch import metrics_kernels as mk  # noqa: E402

SMS = 132                                       # an H100 SXM's SMs

# (N, K candidates, G candidates a fold mask, C classes): the multiclass
# train's CV block (3 folds x 8) and its K = 1 evaluations, iris's 3
# classes, 8 and 9 classes, both sides of the thread form's limit (14),
# 40 classes, more candidates than a block's threads, and one class
SHAPES = [(3001, 24, 8, 4), (2000, 1, 1, 4), (1500, 24, 8, 3),
          (2500, 6, 2, 8), (1200, 5, 5, 9), (1100, 5, 5, 14),
          (1000, 4, 2, 15), (900, 3, 1, 40), (300, 300, 100, 2),
          (40, 7, 7, 5), (700, 3, 1, 1)]


def _inputs(N, K, G, C, seed):
    """Labels with the last class absent, predictions right 70% of the
    time plus a few outside [0, C), 0/1 fold masks with the last fold
    empty, and real weights."""
    rng = np.random.default_rng(seed)
    F = -(-K // G)
    y = rng.integers(0, max(1, C - 1), N).astype(np.int32)
    P = np.where(rng.random((N, K)) < 0.7, y[:, None],
                 rng.integers(0, C, (N, K))).astype(np.int32)
    P[rng.random((N, K)) < 0.01] = C              # outside the classes
    W01 = (rng.random((F, N)) < 0.6).astype(np.float32)
    if F > 1:
        W01[-1] = 0.0
    Wr = rng.random((F, N)).astype(np.float32)
    return y, P, W01, Wr


def _emulate(y, P, W, G, C):
    """The kernel's bits under the plan an H100 SXM takes."""
    return mk.confusion_emulate(
        y, P, W, G, C, mk.confusion_plan(P.shape[1], C, P.shape[0], SMS))


def _twin(y, P, W, G, C):
    return mk.multiclass_confusion_twin(
        torch.as_tensor(y), torch.as_tensor(P), torch.as_tensor(W), G,
        C).numpy()


@pytest.mark.parametrize("N,K,G,C", SHAPES)
def test_emulation_equals_the_twin_on_fold_masks(N, K, G, C):
    y, P, W01, _ = _inputs(N, K, G, C, seed=N + K + C)
    got = _emulate(y, P, W01, G, C)
    assert got.dtype == np.float32 and got.shape == (K, C, C)
    np.testing.assert_array_equal(got, _twin(y, P, W01, G, C))
    # the wrapper on a CPU tensor is the twin
    np.testing.assert_array_equal(
        mk.multiclass_confusion(torch.as_tensor(y), torch.as_tensor(P),
                                torch.as_tensor(W01), G, C).numpy(),
        got)


@pytest.mark.parametrize("N,K,G,C", SHAPES)
def test_emulation_within_1e6_of_the_f64_sums(N, K, G, C):
    y, P, _, Wr = _inputs(N, K, G, C, seed=7 * N + C)
    got = _emulate(y, P, Wr, G, C).astype(np.float64)
    want = _twin(y, P, Wr.astype(np.float64), G, C)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert float(rel.max()) <= 1e-6


@pytest.mark.parametrize("N,K,G,C", [s for s in SHAPES if s[1] <= 24])
def test_emulation_matches_jax(N, K, G, C):
    """Each candidate's matrix against the JAX package's one-hot matmul
    over its fold's mask: equal on 0/1 masks, 1e-6 on real weights."""
    y, P, W01, Wr = _inputs(N, K, G, C, seed=3 * N + K)
    for W, exact in ((W01, True), (Wr, False)):
        got = _emulate(y, P, W, G, C)
        for k in range(K):
            want = np.asarray(jmd.masked_multiclass_confusion(
                jnp.asarray(y.astype(np.float32)),
                jnp.asarray(P[:, k].astype(np.float32)),
                jnp.asarray(W[k // G]), n_classes=C))
            if exact:
                np.testing.assert_array_equal(got[k], want)
            else:
                rel = np.abs(got[k] - want) / np.maximum(np.abs(want), 1.0)
                assert float(rel.max()) <= 1e-6


def test_emulation_follows_the_plan():
    """The emulated bits depend on the plan (the rows a thread sums in
    order): two grids give sums that differ in their last bits on real
    weights, each within 1e-6 of the f64 sums; on 0/1 masks every plan
    gives the twin's integers."""
    y, P, W01, Wr = _inputs(20_000, 24, 8, 4, seed=5)
    plan = mk.confusion_plan(24, 4, 20_000, SMS)
    other = plan._replace(blocks=plan.blocks // 4)
    a = mk.confusion_emulate(y, P, Wr, 8, 4, plan)
    b = mk.confusion_emulate(y, P, Wr, 8, 4, other)
    assert not np.array_equal(a, b)
    want = _twin(y, P, Wr.astype(np.float64), 8, 4)
    for got in (a, b):
        assert float((np.abs(got - want) / np.maximum(want, 1.0)).max()) \
            <= 1e-6
    np.testing.assert_array_equal(
        mk.confusion_emulate(y, P, W01, 8, 4, other), _twin(y, P, W01, 8, 4))
    assert np.array_equal(a, _emulate(y, P, Wr, 8, 4))


@pytest.mark.parametrize("N", [0, 1, 37, 100_003, 1_000_000])
@pytest.mark.parametrize("K", [1, 3, 8, 24, 54, 255, 256, 300, 1000])
def test_plan_picks_the_form_by_classes_and_sizes_every_shape(N, K):
    """The thread form where a block's cells fit shared memory, C <= 14
    (candidates across a block's threads in P's row order, k_chunk x rows
    <= 256 threads, 4 C² bytes of cells and tree a thread, one wave of
    blocks — 4 an SM, or as many as its shared memory holds — and no
    more passes than N needs), the shared form above (warps' histograms
    within shared memory, class chunks past ~230 classes); every C up to
    400, on an H100 SXM's 132 SMs and a card of 114."""
    for sms in (SMS, 114):
        for C in list(range(1, 41)) + [57, 64, 100, 229, 230, 300, 400]:
            p = mk.confusion_plan(K, C, N, sms)
            assert 1 <= p.k_chunk <= min(K, 256) and p.blocks >= 1
            if C <= 14:
                assert mk.thread_form_fits(C)
                assert p.form == "thread" and p.c_chunk == C
                assert p.k_chunk * p.rows == p.threads <= mk.THREAD_THREADS
                assert p.rows == mk.THREAD_THREADS // p.k_chunk
                assert p.smem == 4 * C * C * p.threads <= mk._SMEM_MAX
                resident = min(mk.THREAD_BLOCKS_PER_SM,
                               mk._SMEM_SM // (p.smem + mk._SMEM_BLOCK))
                assert resident >= 1
                assert p.blocks <= sms * resident
                assert p.blocks == max(1, min(sms * resident,
                                              -(-N // p.rows)))
            else:
                assert not mk.thread_form_fits(C)
                assert p.form == "shared" and p.rows == 0
                assert p.threads % 32 == 0 and 32 <= p.threads <= 256
                assert 1 <= p.c_chunk <= C and p.smem <= mk._SMEM_MAX
                assert p.smem == 4 * (p.threads // 32) * p.k_chunk \
                    * p.c_chunk * C
                assert p.blocks <= sms * mk._SHARED_BLOCKS_PER_SM
    assert mk.confusion_plan(24, 4, 1_000_000, SMS) == mk.ConfusionPlan(
        "thread", 24, 4, 240, 10, 528, 15_360)
    assert mk.confusion_plan(24, 8, 1_000_000, SMS).blocks == 3 * SMS
    assert mk.confusion_plan(24, 14, 1_000_000, SMS).blocks == SMS
    assert mk.confusion_plan(24, 4, 1_000_000, 114).blocks == 4 * 114
    with pytest.raises(ValueError):
        mk.confusion_plan(0, 4, N, SMS)
    with pytest.raises(ValueError):
        mk.confusion_plan(1, 4, N, 0)
