"""The tensor-core FISTA gradient (``csrc/fista_tc.cuh``, run by
``fista_step`` and ``fista_softmax``) on the CPU: its launch plans, and its
arithmetic emulated in numpy on the arrays the wrapper hands the kernel.

The kernel cannot run here, so this is the CPU evidence for its numerics.
The emulation follows the kernel step by step: TF32 round-to-nearest-away
(the rounding of ``cvt.rna.tf32.f32``), the three-term split (lo·hi,
hi·lo, hi·hi; lo·lo dropped), MMA chains of at most four k-steps started
from zero and added to f32 sums, the warps' k-ranges and the cluster's feature slices added in
order, the ones tile's Σg, the k-groups, the clusters' row tiles and the
fixed-order reduction over clusters.  A chain's k-steps go to independent
accumulators in turn (four for the margins of up to 16 columns, else two),
added in order.  Each MMA is modelled as exact
products rounded once to f32 (the tensor cores truncate inside an MMA; the
chains bound that).  Tolerance: each output within 1e-5 of its absolute
mass Σ|x|·|g| of the JAX package's f64 gradient, the gate the card is held
to; the same emulation with plain TF32 (hi·hi alone) must miss it, which is
why the kernel splits.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import solvers as jsolvers
from transmogrifai_tpu_torch.models import linear_kernels as lk

F32, F64 = np.float32, np.float64
TOL = 1e-5


def _tf32(a):
    """cvt.rna.tf32.f32: round to the nearest TF32 (10 mantissa bits), ties
    away from zero, on the f32 bit pattern."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _split(a, terms):
    hi = _tf32(a)
    lo = _tf32((np.asarray(a, F32) - hi).astype(F32))
    return hi, (lo if terms == 3 else np.zeros_like(lo))


def _chain(A, B, terms):
    """One MMA chain from zero over A [m, 8k] · B [8k, n]: per k-step the
    small terms, then hi·hi (``tc_mma3``), each MMA rounded once to f32."""
    d = np.zeros((A.shape[0], B.shape[1]), F32)
    for ks in range(A.shape[1] // 8):
        ah, al = _split(A[:, 8 * ks:8 * ks + 8], terms)
        bh, bl = _split(B[8 * ks:8 * ks + 8], terms)
        pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
        for a, b in pairs:
            d = (d.astype(F64) + a.astype(F64) @ b.astype(F64)).astype(F32)
    return d


def _chains(A, B, k0, k1, run, terms, acc=2):
    """k-steps [k0, k1) in chains of 4, k-step kc + i of a chain into
    accumulator i % ``acc``, added to the f32 sum ``run`` in accumulator
    order."""
    for kc in range(k0, k1, 4):
        ke = min(k1, kc + 4)
        for par in range(acc):
            ks = [k for k in range(kc + par, ke, acc)]
            if not ks:
                continue
            cols = np.concatenate([np.arange(8 * k, 8 * k + 8) for k in ks])
            run = (run + _chain(A[:, cols], B[cols], terms)).astype(F32)
    return run


def _loss(m, rows, y, Wr, ws, loss, C, L):
    """The f32 loss gradient of a tile's margins m [TR, Jc] (rows past the
    tile's ``rows`` and padding columns 0)."""
    g = np.zeros_like(m)
    J = L * C
    for l in range(L):
        mm = m[:rows, l * C:(l + 1) * C]
        w, s = Wr[l][:, None], ws[l]
        if loss == "softmax":
            e = np.exp((mm - mm.max(axis=1, keepdims=True)).astype(F32))
            p = (e / e.sum(axis=1, keepdims=True)).astype(F32)
            onehot = (y[:, None] == np.arange(C)[None]).astype(F32)
            g[:rows, l * C:(l + 1) * C] = w * (p - onehot) / s
        elif loss == "logistic":
            p = (F32(1) / (F32(1) + np.exp(-mm))).astype(F32)
            g[:rows, l:l + 1] = w * (p - y[:, None]) / s
        else:                                         # squared
            g[:rows, l:l + 1] = w * (mm - y[:, None]) / s
    assert not g[:, J:].any()
    return g.astype(F32)


def emulate(X, V, muv, b, W, y, wsum, G, lane0, loss, C, plan, ncl,
            terms=3):
    """out [(D+1), L*C] of one launch of ``fista_tc_kernel`` followed by
    ``fista_tc_reduce`` on ``ncl`` clusters."""
    N, D = X.shape
    L = wsum.shape[0]
    J = L * C
    Jc = -(-J // 8) * 8
    TR, CS, DS = plan["TR"], plan["CS"], plan["DS"]
    WK = 8 // (TR // 16)
    KS = DS // 8
    kper = -(-KS // WK)
    DSA = -(-DS // 16) * 16
    MTx = DSA // 16
    MT = MTx + 1
    KG = max(1, 8 // MT)
    KT = TR // 8
    kper2 = -(-KT // KG)
    Vp = np.zeros((Jc, CS * DS + 16), F32)
    Vp[:J, :D] = V.reshape(J, D)
    cm, cb = np.zeros(Jc, F32), np.zeros(Jc, F32)
    cm[:J], cb[:J] = muv.reshape(J), b.reshape(J)
    T = -(-N // TR)
    ncl = min(ncl, T)
    partial = np.zeros((ncl, D + 1, J), F32)
    ones = np.zeros((16, TR), F32)
    ones[0] = 1
    for cid in range(ncl):
        acc = np.zeros((CS, KG, MT * 16, Jc), F32)
        for tile in range(cid, T, ncl):
            r0 = tile * TR
            rows = min(TR, N - r0)
            Xt = np.zeros((TR, CS * DS + 16), F32)
            Xt[:rows, :D] = X[r0:r0 + rows]
            parts = []
            for r in range(CS):
                xs, vs = Xt[:, r * DS:(r + 1) * DS], Vp[:, r * DS:(r + 1) * DS]
                s = None
                for wk in range(WK):
                    ka, kb = wk * kper, min(KS, wk * kper + kper)
                    run = _chains(xs, vs.T, ka, kb, np.zeros((TR, Jc), F32),
                                  terms, 4 if Jc <= 16 else 2)
                    s = run if s is None else (s + run).astype(F32)
                parts.append(s)
            m = parts[0]
            if CS > 1:
                m = np.zeros((TR, Jc), F32)
                for p in parts:
                    m = (m + p).astype(F32)
            m = ((m - cm) + cb).astype(F32)
            Wr = [W[(lane0 + l) // G, r0:r0 + rows] for l in range(L)]
            g = _loss(m, rows, y[r0:r0 + rows], Wr, wsum, loss, C, L)
            for r in range(CS):
                xs = Xt[:, r * DS:r * DS + DSA]
                for mt in range(MT):
                    if mt == MTx and r != 0:
                        continue
                    A = ones if mt == MTx else xs[:, 16 * mt:16 * mt + 16].T
                    for kg in range(KG):
                        k0, k1 = kg * kper2, min(KT, kg * kper2 + kper2)
                        if k0 < k1:
                            sl = slice(16 * mt, 16 * mt + 16)
                            acc[r, kg, sl] = _chains(A, g, k0, k1,
                                                     acc[r, kg, sl], terms)
        for r in range(CS):
            f0 = r * DS
            fs = min(DS, D - f0)
            s = acc[r, 0]
            for k in range(1, KG):
                s = (s + acc[r, k]).astype(F32)
            partial[cid, f0:f0 + fs] = s[:fs, :J]
            if r == 0:
                partial[cid, D] = s[MTx * 16, :J]
    red = np.zeros((8, D + 1, J), F32)
    for ci in range(8):
        for c in range(ci, ncl, 8):
            red[ci] = (red[ci] + partial[c]).astype(F32)
    out = red[0]
    for k in range(1, 8):
        out = (out + red[k]).astype(F32)
    return out


def _wrapper_run(X, V, muv, b, W, y, wsum, G, loss, C, plan, ncl, terms):
    """The wrapper's launches (``lk.tc_chunks``) emulated: out [(D+1), L*C]."""
    L = wsum.shape[0]
    out = np.zeros((X.shape[1] + 1, L * C), F32)
    for l0, n_l, Vc, mc, bc, wc in lk.tc_chunks(
            torch.as_tensor(V), torch.as_tensor(muv), torch.as_tensor(b),
            torch.as_tensor(wsum), G, plan):
        out[:, l0 * C:(l0 + n_l) * C] = emulate(
            X, Vc.numpy(), mc.numpy(), bc.numpy(), W, y, wc.numpy(), G, l0,
            loss, C, plan, ncl, terms)
    return out


def _inputs(N, D, L, C, G, seed):
    rng = np.random.default_rng(seed)
    F = -(-L // G)
    X = rng.normal(size=(N, D)).astype(F32)
    W = (rng.random((F, N)) > 1 / 3).astype(F32)
    sd = 0.3 * min(1.0, (16 / D) ** 0.5)
    shape = (L, C, D) if C > 1 else (L, D)
    V = rng.normal(scale=sd, size=shape).astype(F32)
    muv = rng.normal(scale=0.3, size=shape[:-1]).astype(F32)
    b = rng.normal(scale=0.3, size=shape[:-1]).astype(F32)
    if C > 1:
        y = rng.integers(0, C, N).astype(np.int32)
    else:
        y = (rng.random(N) > 0.5).astype(F32)
    ws = W.sum(axis=1)[np.arange(L) // G].astype(F32)
    return X, V, muv, b, W, y, ws


def _jax_grad(X, V, muv, b, W, y, ws, G, loss, C):
    """The JAX package's f64 gradient and its absolute mass, lane by lane:
    ``_logistic_loss_grad`` / ``_squared_loss_grad`` / ``_softmax_loss_grad``
    (solvers.py:35-56; their wsum is Σw, the kernel's ``wsum``) at margins
    X·V - muv + b, then [Xᵀg; Σg] [(D+1), L*C]."""
    X64 = X.astype(F64)
    outs, masses = [], []
    with jax.enable_x64(True):
        for l in range(ws.shape[0]):
            w = jnp.asarray(W[l // G].astype(F64))
            lin = jnp.asarray(X64 @ V[l].astype(F64).T - muv[l] + b[l])
            if C > 1:
                yoh = jnp.asarray(np.eye(C)[y])
                _, g = jsolvers._softmax_loss_grad(lin, yoh, w)
            elif loss == "logistic":
                _, g = jsolvers._logistic_loss_grad(
                    lin, jnp.asarray(y.astype(F64)), w)
            else:
                _, g = jsolvers._squared_loss_grad(
                    lin, jnp.asarray(y.astype(F64)), w)
            g2 = np.asarray(g, F64).reshape(len(X), -1)
            outs.append(np.vstack([X64.T @ g2, g2.sum(axis=0)[None]]))
            masses.append(np.vstack([np.abs(X64).T @ np.abs(g2),
                                     np.abs(g2).sum(axis=0)[None]]))
    return np.hstack(outs), np.hstack(masses)


CASES = {
    # name: (N, D, L, C, G, loss, ncl)
    "step_narrow": (300, 28, 6, 1, 2, "logistic", 2),
    "step_cluster": (100, 1597, 2, 1, 1, "squared", 3),
    "step_two_launches": (200, 20, 72, 1, 24, "logistic", 2),
    "softmax_fragments": (300, 16, 3, 4, 1, "softmax", 2),
    "softmax_smem": (300, 16, 2, 3, 1, "softmax", 2),
    "softmax_cluster": (100, 1200, 2, 4, 2, "softmax", 2),
}


@pytest.fixture(scope="module")
def emulated():
    got = {}
    for name, (N, D, L, C, G, loss, ncl) in CASES.items():
        X, V, muv, b, W, y, ws = _inputs(N, D, L, C, G, seed=len(got) + 3)
        plan = lk.tc_plan(D, L, C)
        want, mass = _jax_grad(X, V, muv, b, W, y, ws, G, loss, C)
        runs = {t: _wrapper_run(X, V, muv, b, W, y, ws, G, loss, C, plan,
                                ncl, t) for t in (3, 1)}
        got[name] = (plan, want, mass, runs)
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_split_tf32_emulation_is_within_the_gate(emulated, name):
    """The three-term split on the kernel's tile order lands within 1e-5 of
    each output's absolute mass of the JAX package's f64 gradient."""
    plan, want, mass, runs = emulated[name]
    err = np.abs(runs[3].astype(F64) - want)
    assert (err <= TOL * mass + 1e-12).all(), float((err / mass).max())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_tf32_emulation_misses_the_gate(emulated, name):
    """The same tiles with plain TF32 products (hi·hi alone) miss 1e-5 of
    the mass: the split is what makes the tensor cores f32-accurate."""
    plan, want, mass, runs = emulated[name]
    err = np.abs(runs[1].astype(F64) - want)
    assert (err > TOL * mass + 1e-12).any()
    # and by far more than the split's worst case
    split_err = np.abs(runs[3].astype(F64) - want)
    assert (err / mass).max() > 30 * (split_err / mass).max()


def test_the_cases_take_every_path_of_the_kernel(emulated):
    """Narrow plans keep whole margins in one warp (the fragment loss, C =
    1 and 4; the shared-memory loss, C = 3), wide ones slice the features
    over a cluster, and 72 lanes take two launches."""
    plans = {k: v[0] for k, v in emulated.items()}
    assert plans["step_narrow"]["CS"] == 1 and plans["step_narrow"]["TR"] == 128
    assert plans["softmax_fragments"]["TR"] == 128
    assert plans["step_cluster"]["CS"] >= 2
    assert plans["softmax_cluster"]["CS"] >= 2
    assert plans["step_two_launches"]["lanes"] == lk.TC_COLS
    assert len(list(lk.tc_chunks(torch.zeros(72, 20), torch.zeros(72),
                                 torch.zeros(72), torch.zeros(72), 24,
                                 plans["step_two_launches"]))) == 2
    # lanes of one fold each (the power iteration): at most TC_FOLDS folds'
    # weights a launch
    chunks = list(lk.tc_chunks(torch.zeros(10, 20), torch.zeros(10),
                               torch.zeros(10), torch.zeros(10), 1,
                               lk.tc_plan(20, 10)))
    assert [c[:2] for c in chunks] == [(0, 4), (4, 4), (8, 2)]


def test_tf32_rounding_is_nearest_away():
    """The emulated cvt.rna.tf32: ties go away from zero, below half an ulp
    down, and hi + lo keeps 21 bits of every value."""
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                  1 + 3 * ulp / 2], F32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1 + ulp, 1, -(1 + ulp), 1 + 2 * ulp], F32))
    rng = np.random.default_rng(0)
    v = rng.normal(size=10_000).astype(F32)
    hi, lo = _split(v, 3)
    rel = np.abs((hi.astype(F64) + lo) - v) / np.abs(v)
    assert rel.max() <= 2.0 ** -21
    assert np.abs(hi.astype(F64) - v).max() / np.abs(v).max() > 2.0 ** -13
