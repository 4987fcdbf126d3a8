"""RNS-BFV (production/bench variant) correctness tests."""

import numpy as np
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as R
from fhe_study_tpu.arith import rn
from fhe_study_tpu.ops import modops
from fhe_study_tpu.utils import prng


def _naive_pt_mul(m1, m2, t, n):
    return rn.to_rq(rn.naive_poly_mul(m1.astype(jnp.int64), m2.astype(jnp.int64)), t, n)


def test_fast_base_extend_exact():
    from fhe_study_tpu.models.bfv_rns import fast_base_extend, _to_residues
    from fhe_study_tpu.ops.primes import ntt_primes
    src = ntt_primes(3, 30, 1 << 16)
    dst = ntt_primes(3, 30, 1 << 16, skip=3)
    S = src[0] * src[1] * src[2]
    rng = np.random.default_rng(0)
    # values away from the S boundary: v within ~2^-50·S of S is the known
    # HPS float-correction edge (mis-extends by ±S; harmless in-scheme since
    # Q-multiples vanish mod t after scaling — see fast_base_extend docstring)
    vals = [int(v) % S for v in rng.integers(0, 2 ** 63, 64)] + [0, 1, S // 2]
    x = jnp.stack([jnp.asarray([v % p for v in vals], jnp.uint64) for p in src], 0)
    out = np.asarray(fast_base_extend(x, src, dst))
    # unsigned contract: v, or v+S when frac(v/S) is below the fixed-point
    # alpha truncation (~2^-25) — the documented in-scheme-harmless slip
    for j, d in enumerate(dst):
        exact = np.array([v % d for v in vals], np.uint64)
        slip = np.array([(v + S) % d for v in vals], np.uint64)
        ok = (out[j] == exact) | (out[j] == slip)
        assert ok.all(), f"dst prime {d}: {np.where(~ok)}"
    # values with fractional position >= 2^-20 extend EXACTLY
    big = [S // 3 + int(v) for v in rng.integers(0, 2 ** 60, 32)]
    xb = jnp.stack([jnp.asarray([v % p for v in big], jnp.uint64) for p in src], 0)
    outb = np.asarray(fast_base_extend(xb, src, dst))
    for j, d in enumerate(dst):
        np.testing.assert_array_equal(outb[j], [v % d for v in big])

    # centered interpretation recovers signed values
    svals = [-5, 5, -(S // 4), S // 4, 0]
    xs = jnp.stack([jnp.asarray([v % p for v in svals], jnp.uint64) for p in src], 0)
    outs = np.asarray(fast_base_extend(xs, src, dst, centered=True))
    for j, d in enumerate(dst):
        np.testing.assert_array_equal(outs[j], [v % d for v in svals])


def test_encrypt_decrypt():
    param = R.RnsParam(n=256, t=64, L=3, M=4)
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = prng.split(key, 3)
    B = 8
    sk, pk = R.new_key(k1, param, batch=(B,))
    m = prng.uniform_mod(k2, (B, param.n), param.t)
    c = R.encrypt(k3, param, pk, m, batch=(B,))
    rec = R.decrypt(param, sk, c)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))


def test_add_and_pt_ops():
    param = R.RnsParam(n=256, t=64, L=3, M=4)
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    B = 4
    sk, pk = R.new_key(k1, param, batch=(B,))
    m1 = prng.uniform_mod(k2, (B, param.n), param.t)
    m2 = prng.uniform_mod(k3, (B, param.n), param.t)
    c1 = R.encrypt(k4, param, pk, m1, batch=(B,))
    c2 = R.encrypt(k5, param, pk, m2, batch=(B,))

    rec = R.decrypt(param, sk, R.add(param, c1, c2))
    np.testing.assert_array_equal(np.asarray(rec),
                                  np.asarray(modops.coerce_u64(m1 + m2, param.t)))

    rec = R.decrypt(param, sk, R.add_pt(param, c1, m2))
    np.testing.assert_array_equal(np.asarray(rec),
                                  np.asarray(modops.coerce_u64(m1 + m2, param.t)))

    rec = R.decrypt(param, sk, R.mul_pt(param, c1, m2))
    want = _naive_pt_mul(m1, m2, param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))


def test_ct_mul_relin():
    param = R.RnsParam(n=256, t=16, L=3, M=4)
    key = jax.random.PRNGKey(2)
    k1, k2, k3, k4, k5, k6 = prng.split(key, 6)
    B = 4
    sk, pk = R.new_key(k1, param, batch=(B,))
    rlk = R.rlk_key(k2, param, sk, batch=(B,))
    m1 = prng.uniform_mod(k3, (B, param.n), param.t)
    m2 = prng.uniform_mod(k4, (B, param.n), param.t)
    c1 = R.encrypt(k5, param, pk, m1, batch=(B,))
    c2 = R.encrypt(k6, param, pk, m2, batch=(B,))

    c3 = R.mul(param, rlk, c1, c2)
    rec = R.decrypt(param, sk, c3)
    want = _naive_pt_mul(m1, m2, param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))


def test_eval_resident_mul_matches_mul():
    """mul_e on eval-resident ciphertexts is bit-identical to mul, and a
    depth-2 chain (mul_e -> add_e -> mul_e) decrypts correctly without ever
    leaving the NTT domain.  (Small L/n: bit-identity is shape-independent;
    the bench shape runs on the GPU via bench.py's decrypt-verified chain.)"""
    param = R.RnsParam(n=128, t=4, L=3, M=4)
    ks = prng.split(jax.random.PRNGKey(7), 8)
    B = 2
    sk, pk = R.new_key(ks[0], param)
    rlk = R.rlk_key(ks[1], param, sk)
    ms = [prng.uniform_mod(ks[2 + i], (B, param.n), param.t) for i in range(2)]
    cts = [R.encrypt(ks[4 + i], param, pk, ms[i], batch=(B,)) for i in range(2)]

    ref = R.mul(param, rlk, cts[0], cts[1])
    ces = [R.to_evals(param, c) for c in cts]
    ce = R.mul_e(param, rlk, ces[0], ces[1])
    got = R.from_evals(param, ce)
    np.testing.assert_array_equal(np.asarray(got.c0),
                                  np.asarray(R._lift(ref).c0))
    np.testing.assert_array_equal(np.asarray(got.c1),
                                  np.asarray(R._lift(ref).c1))

    # round trip: to_evals∘from_evals = id on the Q components
    rt = R.from_evals(param, R.to_evals(param, cts[0]))
    np.testing.assert_array_equal(np.asarray(rt.c0),
                                  np.asarray(R._lift(cts[0]).c0))

    # depth-2 chain entirely eval-resident: ((m1·m2) + m1) · m2
    ce2 = R.mul_e(param, rlk, R.add_e(param, ce, ces[0]), ces[1])
    rec = R.decrypt(param, sk, R.from_evals(param, ce2))
    w1 = _naive_pt_mul(ms[0], ms[1], param.t, param.n)
    w2 = _naive_pt_mul(
        modops.coerce_u64(w1.astype(jnp.int64) + ms[0].astype(jnp.int64),
                          param.t), ms[1], param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(w2))


def test_eval_resident_linear_ops():
    """mul_pt_e against pt_to_evals == the coefficient-domain mul_pt,
    bit-exactly, and a chained eval-resident linear pipeline
    (add_e -> mul_pt_e, never leaving the NTT domain) decrypts to the
    same plaintext algebra — the production linear path the bfv_linear
    bench measures."""
    param = R.RnsParam(n=128, t=16, L=3, M=4)
    ks = prng.split(jax.random.PRNGKey(9), 6)
    B = 4
    sk, pk = R.new_key(ks[0], param)
    m1 = prng.uniform_mod(ks[1], (B, param.n), param.t)
    m2 = prng.uniform_mod(ks[2], (B, param.n), param.t)
    c1 = R.encrypt(ks[3], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[4], param, pk, m2, batch=(B,))
    # bit-exact vs mul_pt on the Q components
    ref = R._lift(R.mul_pt(param, c1, m2))
    em = R.pt_to_evals(param, m2)
    got = R.from_evals(param, R.mul_pt_e(param, R.to_evals(param, c1), em))
    np.testing.assert_array_equal(np.asarray(got.c0), np.asarray(ref.c0))
    np.testing.assert_array_equal(np.asarray(got.c1), np.asarray(ref.c1))
    # chained pipeline: ((m1+m2)*m2 + m2)*m2, all eval-resident
    ce = R.mul_pt_e(param, R.add_e(param, R.to_evals(param, c1),
                                   R.to_evals(param, c2)), em)
    ce = R.mul_pt_e(param, R.add_e(param, ce, R.to_evals(param, c2)), em)
    rec = R.decrypt(param, sk, R.from_evals(param, ce))
    w1 = _naive_pt_mul(modops.coerce_u64(
        m1.astype(jnp.int64) + m2.astype(jnp.int64), param.t),
        m2, param.t, param.n)
    w2 = _naive_pt_mul(modops.coerce_u64(
        w1.astype(jnp.int64) + m2.astype(jnp.int64), param.t),
        m2, param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(w2))


def test_hybrid_relin_mul():
    """1-row hybrid (P-extended) relinearization: same product as the RNS
    gadget, for mul AND mul_e, and a depth-2 chain decrypts (noise ~2^69 at
    headline params stays far under the Q/2t budget — bfv_rns.HRLK docs)."""
    param = R.RnsParam(n=256, t=16, L=3, M=4)
    ks = prng.split(jax.random.PRNGKey(11), 8)
    B = 2
    sk, pk = R.new_key(ks[0], param)
    hk = R.hybrid_rlk1(ks[1], param, sk)
    assert hk.b.shape == (param.L + 2, param.n)
    ms = [prng.uniform_mod(ks[2 + i], (B, param.n), param.t)
          for i in range(3)]
    cts = [R.encrypt(ks[5 + i], param, pk, ms[i], batch=(B,))
           for i in range(3)]
    c3 = R.mul(param, hk, cts[0], cts[1])
    rec = R.decrypt(param, sk, c3)
    want = _naive_pt_mul(ms[0], ms[1], param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))
    # eval-resident hybrid path is bit-identical to the coeff path
    ce = R.mul_e(param, hk, R.to_evals(param, cts[0]),
                 R.to_evals(param, cts[1]))
    got = R.from_evals(param, ce)
    np.testing.assert_array_equal(np.asarray(got.c0), np.asarray(c3.c0))
    np.testing.assert_array_equal(np.asarray(got.c1), np.asarray(c3.c1))
    # depth 2 under hybrid relin
    c123 = R.mul(param, hk, c3, cts[2])
    rec2 = R.decrypt(param, sk, c123)
    w12 = rn.naive_poly_mul(ms[0].astype(jnp.int64), ms[1].astype(jnp.int64))
    want2 = rn.to_rq(rn.naive_poly_mul(w12, ms[2].astype(jnp.int64)),
                     param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec2), np.asarray(want2))


def test_ct_mul_depth2_with_mod_switch():
    """(m1·m2)·m3 with a modulus drop between — noise management works."""
    param = R.RnsParam(n=256, t=4, L=4, M=5)
    key = jax.random.PRNGKey(3)
    ks = prng.split(key, 8)
    B = 2
    sk, pk = R.new_key(ks[0], param, batch=(B,))
    rlk = R.rlk_key(ks[1], param, sk, batch=(B,))
    ms = [prng.uniform_mod(ks[2 + i], (B, param.n), param.t) for i in range(3)]
    cts = [R.encrypt(ks[5 + i], param, pk, ms[i], batch=(B,)) for i in range(3)]

    c12 = R.mul(param, rlk, cts[0], cts[1])
    c123 = R.mul(param, rlk, c12, cts[2])
    rec = R.decrypt(param, sk, c123)
    w12 = rn.naive_poly_mul(ms[0].astype(jnp.int64), ms[1].astype(jnp.int64))
    want = rn.to_rq(rn.naive_poly_mul(w12, ms[2].astype(jnp.int64)),
                    param.t, param.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))


def test_base_extend_centered_boundary_exact():
    """Adversarial α-boundary sweep: centered extension is deterministically
    exact for |v| ≤ S/8 (the scheme guarantees |r| ≤ S/16 via the capacity
    assert; see fast_base_extend docstring)."""
    from fhe_study_tpu.models.bfv_rns import fast_base_extend
    from fhe_study_tpu.ops.primes import ntt_primes
    src = ntt_primes(5, 30, 1 << 16)
    dst = ntt_primes(4, 30, 1 << 16, skip=5)
    S = 1
    for p in src:
        S *= p
    import random
    rng = random.Random(7)
    # worst cases: near ±S/8, near 0, and random; plus exact ±S/8
    vals = ([S // 8 - k for k in range(32)] + [-(S // 8) + k for k in range(32)]
            + [0, 1, -1, 17, -17]
            + [rng.randrange(-(S // 8), S // 8) for _ in range(256)])
    x = jnp.stack([jnp.asarray([v % p for v in vals], jnp.uint64)
                   for p in src], 0)
    out = np.asarray(fast_base_extend(x, src, dst, centered=True))
    for j, d in enumerate(dst):
        np.testing.assert_array_equal(out[j], [v % d for v in vals])
