"""The transform compositions of ops/ntt.py and the HPS base extension of
models/bfv_rns.py against exact integer references: the native C++ oracle
(runtime/native.py) for transforms and ring products, Python ints for CRT.

These are the XLA paths every platform runs around the transform kernel
(tensor products, key-switch contractions, base extension)."""

import random

import numpy as np
import pytest
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as R
from fhe_study_tpu.ops import ntt
from fhe_study_tpu.ops.primes import ntt_primes
from fhe_study_tpu.runtime import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")

N = 64
QS = ntt_primes(3, 30, 1 << 12)
PS = ntt_primes(4, 30, 1 << 12, skip=3)
R32 = 1 << 32


def _rand(qs, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, shape) for q in qs]).astype(np.uint64)


def _rows(f, *arrs, qs):
    """Apply f(row..., q) to every [..., n] row of the [L, ..., n] arrays."""
    out = np.empty(arrs[0].shape, np.uint64)
    for l, q in enumerate(qs):
        for idx in np.ndindex(arrs[0].shape[1:-1]):
            out[(l,) + idx] = f(*(a[(l,) + idx] for a in arrs), q)
    return out


def _fwd(x, qs):
    return _rows(lambda r, q: native.ntt(r, q), x, qs=qs)


def _inv(x, qs):
    return _rows(lambda r, q: native.ntt(r, q, inverse=True), x, qs=qs)


def _mul(a, b, qs):
    return _rows(lambda u, v, q: native.polymul_mod(u, v, q), a, b, qs=qs)


def _uniform(bound, count, seed):
    """`count` Python ints uniform in [0, bound)."""
    rng = random.Random(seed)
    return [rng.randrange(bound) for _ in range(count)]


def _col(vals, nd):
    return np.array(vals, object).reshape((len(vals),) + (1,) * (nd - 1))


def _mod(a, qs, nd):
    return (np.asarray(a, object) % _col(qs, nd)).astype(np.uint64)


def _tensor_ref(x0, x1, y0, y1, qs, scale):
    nd = x0.ndim
    s = _col(scale if scale else (1,) * len(qs), nd)
    add = lambda u, v: _mod(u.astype(object) + v, qs, nd)  # noqa: E731
    prods = [_mul(x0, y0, qs), add(_mul(x0, y1, qs), _mul(x1, y0, qs)),
             _mul(x1, y1, qs)]
    return np.stack([_mod(p.astype(object) * s, qs, nd) for p in prods], -2)


def test_ntt_multi_mont_scale_and_dtype_vs_native():
    x = _rand(QS, (2, N), 1)
    fwd, inv = _fwd(x, QS), _inv(x, QS)
    s = tuple(q - 5 for q in QS)
    for dt in (jnp.uint32, jnp.uint64):
        xj = jnp.asarray(x).astype(dt)
        got = [ntt.ntt_multi(xj, QS), ntt.ntt_multi(xj, QS, mont=True),
               ntt.intt_multi(xj, QS), ntt.intt_multi(xj, QS, scale=s)]
        assert all(g.dtype == dt for g in got)
        want = [fwd, _mod(fwd.astype(object) * R32, QS, 3), inv,
                _mod(inv.astype(object) * _col(s, 3), QS, 3)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g).astype(np.uint64), w)


@pytest.mark.parametrize("scaled", [False, True])
def test_tensor_mul_multi_vs_native(scaled):
    x4 = _rand(QS, (2, 4, N), 2)
    scale = tuple(q - 7 for q in QS) if scaled else None
    got = ntt.tensor_mul_multi(jnp.asarray(x4), QS, scale=scale)
    assert got.dtype == jnp.uint32 and got.shape == (3, 2, 3, N)
    want = _tensor_ref(*(x4[..., i, :] for i in range(4)), QS, scale)
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), want)


def test_tensor_mul4_src_extends_then_multiplies():
    """src given: operands over QS are read as integers in [0, Q) and
    extended to PS before the product."""
    Q = int(np.prod(np.array(QS, object)))
    vals = [[_uniform(Q, N, 3 + 10 * i + j) for j in range(2)]
            for i in range(4)]                                # [4, B, n]
    ops = [np.stack([np.array([[v % q for v in row] for row in op], np.uint64)
                     for q in QS]) for op in vals]
    got = ntt.tensor_mul4(*map(jnp.asarray, ops), PS, src=QS,
                          scale=tuple(p - 3 for p in PS))
    ext = [np.stack([np.array([[v % p for v in row] for row in op], np.uint64)
                     for p in PS]) for op in vals]
    want = _tensor_ref(*ext, PS, tuple(p - 3 for p in PS))
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), want)


def test_tensor_eval4_vs_native():
    a = [_rand(QS, (2, N), 10 + i) for i in range(4)]
    ev = [jnp.asarray(_fwd(x, QS)) for x in a]
    scale = tuple(q - 11 for q in QS)
    got = ntt.tensor_eval4(*ev, QS, scale=scale)
    want = _tensor_ref(*a, QS, scale)
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), want)


def test_ext_ntt_vs_native():
    Q = int(np.prod(np.array(QS, object)))
    vals = [_uniform(Q, N, 4 + i) for i in range(3)]
    x = np.stack([np.array([[v % q for v in r] for r in vals], np.uint64)
                  for q in QS])                               # [Ls, 3, n]
    got = ntt.ext_ntt(jnp.asarray(x), QS, PS)
    ext = np.stack([np.array([[v % p for v in r] for r in vals], np.uint64)
                    for p in PS])
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64),
                                  _fwd(ext, PS))


def _keyswitch_ref(c_limbs, kb, ka, primes):
    """INTT(sum_i NTT(c_i mod p) * k_i) per prime p, with Python ints."""
    acc = [np.zeros((len(primes),) + c_limbs.shape[1:], object)
           for _ in range(2)]
    for i in range(c_limbs.shape[0]):
        d = _mod(np.broadcast_to(c_limbs[i].astype(object),
                                 (len(primes),) + c_limbs.shape[1:]),
                 primes, c_limbs.ndim)
        e = _fwd(d, primes).astype(object)
        for a, k in zip(acc, (kb, ka)):
            a += e * k[i][:, None, :].astype(object)
    return [_mod(a, primes, c_limbs.ndim) for a in acc]


def _ks_inputs(seed):
    both = QS + PS[:2]
    c = _rand(QS, (2, N), seed)                               # R = 3 digits
    kb = np.stack([_rand(both, (N,), seed + 1 + i) for i in range(3)])
    ka = np.stack([_rand(both, (N,), seed + 5 + i) for i in range(3)])
    return both, c, kb, ka


def test_ks_fused_multi_vs_native():
    both, c, kb, ka = _ks_inputs(20)
    r0, r1 = ntt.ks_fused_multi(jnp.asarray(c), jnp.asarray(kb),
                                jnp.asarray(ka), both, QS)
    e0, e1 = _keyswitch_ref(c, kb, ka, both)
    np.testing.assert_array_equal(np.asarray(r0).astype(np.uint64),
                                  _inv(e0, both))
    np.testing.assert_array_equal(np.asarray(r1).astype(np.uint64),
                                  _inv(e1, both))


def test_ks_contract_multi_vs_native():
    """Hoisted digits: Montgomery-lifted eval-domain digit rows in."""
    both, c, kb, ka = _ks_inputs(30)
    d = np.stack([_mod(np.broadcast_to(c[i].astype(object),
                                       (len(both),) + c.shape[1:]), both, 3)
                  for i in range(3)])                         # [R, Lp, B, n]
    edm = np.stack([_mod(_fwd(di, both).astype(object) * R32, both, 3)
                    for di in d])
    r0, r1 = ntt.ks_contract_multi(jnp.asarray(edm.astype(np.uint32)),
                                   jnp.asarray(kb), jnp.asarray(ka), both)
    e0, e1 = _keyswitch_ref(c, kb, ka, both)
    np.testing.assert_array_equal(np.asarray(r0).astype(np.uint64),
                                  _inv(e0, both))
    np.testing.assert_array_equal(np.asarray(r1).astype(np.uint64),
                                  _inv(e1, both))


def test_ks_fused_eval_vs_native():
    """Both domains out: e = NTT(add) + contraction, r = INTT(e)."""
    both, c, kb, ka = _ks_inputs(40)
    adds = [_rand(both, (2, N), 50 + i) for i in range(2)]
    e0, e1, r0, r1 = ntt.ks_fused_eval(
        jnp.asarray(c), jnp.asarray(kb), jnp.asarray(ka), both, QS,
        adds=tuple(map(jnp.asarray, adds)))
    w = _keyswitch_ref(c, kb, ka, both)
    for got_e, got_r, acc, add in ((e0, r0, w[0], adds[0]),
                                   (e1, r1, w[1], adds[1])):
        want_e = _mod(acc.astype(object) + _fwd(add, both), both, 3)
        np.testing.assert_array_equal(np.asarray(got_e).astype(np.uint64),
                                      want_e)
        np.testing.assert_array_equal(np.asarray(got_r).astype(np.uint64),
                                      _inv(want_e, both))


@pytest.mark.parametrize("centered", [False, True])
def test_fast_base_extend_vs_crt(centered):
    """Random integers well inside the exactness margins extend exactly:
    [0, S) for the unsigned reading, (-S/16, S/16) for the centered one;
    u32 and u64 inputs keep their dtype."""
    S = int(np.prod(np.array(QS, object)))
    if centered:
        vals = [v - S // 16 for v in _uniform(S // 8, 128, 5)]
    else:
        vals = [S // 4 + v for v in _uniform(S // 2, 128, 5)]
    x = np.stack([np.array([v % q for v in vals], np.uint64) for q in QS])
    for dt in (jnp.uint32, jnp.uint64):
        got = R.fast_base_extend(jnp.asarray(x).astype(dt), QS, PS,
                                 centered=centered)
        assert got.dtype == dt
        want = np.stack([np.array([v % p for v in vals], np.uint64)
                         for p in PS])
        np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), want)


def test_scale_round_sub_mul_epilogue_vs_bigint():
    """The BFV scaling step: w over Q and P -> (w_P − ext(w_Q))·Q^{-1} over P
    -> centered extension back to Q == floor(w/Q) mod q, for signed w."""
    param = R.RnsParam(n=N, t=2, L=3, M=4)
    qs, ps = param.qs, param.ps
    Q = int(np.prod(np.array(qs, object)))
    P = int(np.prod(np.array(ps, object)))
    w = [[v - Q * P // 64 for v in _uniform(Q * P // 32, N, 6 + i)]
         for i in range(3)]

    def res(primes):
        return jnp.asarray(np.stack([np.array([[v % q for v in r] for r in w],
                                              np.uint32) for q in primes]))
    got = R._scale_round(param, res(qs), res(ps))            # 3 x [L, n]
    for i in range(3):
        want = np.stack([[(v // Q) % q for v in w[i]] for q in qs]
                        ).astype(np.uint64)
        np.testing.assert_array_equal(np.asarray(got[i]).astype(np.uint64),
                                      want)
