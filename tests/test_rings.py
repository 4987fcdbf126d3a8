"""Ring-layer parity tests: Rq golden strings/decompose (ring_nq.rs tests),
R = Z[X] golden vectors (ring_n.rs tests), Tn rotate/decompose
(ring_torus.rs / torus.rs tests)."""

import numpy as np
import jax.numpy as jnp

from fhe_study_tpu.arith import rq, rn, tn
from fhe_study_tpu.ops import modops


# -- Rq (reference ring_nq.rs:626-730) --------------------------------------

def test_rq_pretty_print_golden():
    q, n = 7, 3
    p = rq.from_u64(jnp.asarray([0, 1, 2, 3, 4, 5], jnp.uint64), q, n)
    assert rq.to_string(p, q, n) == "4*x^2 + 4*x + 4 mod Z_7/(X^3+1)"

    p = rq.from_u64(jnp.asarray([0, 1, q + 2, 3, 4, 5], jnp.uint64), q, n)
    assert rq.to_string(p, q, n) == "4*x^2 + 4*x + 4 mod Z_7/(X^3+1)"

    p = rq.from_u64(jnp.asarray([0, 1, 2, 3, 4, 5], jnp.uint64), 7, 4)
    assert rq.to_string(p, 7, 4) == "3*x^3 + 2*x^2 + 3*x + 3 mod Z_7/(X^4+1)"

    p = rq.from_u64(jnp.asarray([0, 0, 0, 0, 4, 5], jnp.uint64), q, n)
    assert rq.to_string(p, q, n) == "2*x^2 + 3*x mod Z_7/(X^3+1)"

    p = rq.from_u64(jnp.asarray([5, 4, 5, 2, 1, 0], jnp.uint64), q, n)
    assert rq.to_string(p, q, n) == "5*x^2 + 3*x + 3 mod Z_7/(X^3+1)"


def test_rq_add_sub_golden():
    q, n = 7, 3
    a = rq.from_u64(jnp.asarray([0, 1, 2, 3, 4, 5], jnp.uint64), q, n)
    b = rq.from_u64(jnp.asarray([5, 4, 3, 2, 1, 0], jnp.uint64), q, n)
    assert rq.to_string(rq.add(a, b, q), q, n) == "0 mod Z_7/(X^3+1)"
    assert rq.to_string(rq.sub(a, b, q), q, n) == "x^2 + x + 1 mod Z_7/(X^3+1)"


def test_rq_decompose_golden():
    # reference ring_nq.rs:706-730
    q, n, beta, l = 16, 4, 4, 2
    a = rq.from_u64(jnp.asarray([7, 14, 3, 6], jnp.uint64), q, n)
    d = rq.decompose(a, q, beta, l)
    np.testing.assert_array_equal(np.asarray(d[0]), [1, 3, 0, 1])
    np.testing.assert_array_equal(np.asarray(d[1]), [3, 2, 3, 2])


# -- R = Z[X] (reference ring_n.rs:453-483) ---------------------------------

def test_rn_mul_golden():
    # reference ring_n.rs:453-470 (SageMath vectors, q = 2^16+1)
    q = 2 ** 16 + 1
    a = jnp.asarray([q - 1, q - 1], jnp.int64)
    c = rn.naive_poly_mul(a, a)
    np.testing.assert_array_equal(np.asarray(c), [0, 8589934592])

    b = jnp.asarray([1, q - 1], jnp.int64)
    c = rn.naive_poly_mul(b, b)
    np.testing.assert_array_equal(np.asarray(c), [-4294967295, 131072])


def test_rn_mod_centered():
    q = 11
    a = jnp.asarray([12, -13, 6, -6, 5], jnp.int64)
    got = np.asarray(rn.mod_centered_q(a, q))
    # Rust: v % q truncated toward zero, then if res > q/2: res -= q
    np.testing.assert_array_equal(got, [1, -2, -5, -6, 5])


# -- Tn (reference ring_torus.rs:333-366, torus.rs:160-190) -----------------

def test_tn_left_rotate_golden():
    n = 4
    f = tn.from_i64(jnp.asarray([2, 3, -4, -1], jnp.int64), n)
    r3 = tn.left_rotate(f, 3, n)
    np.testing.assert_array_equal(
        np.asarray(r3), np.asarray(tn.from_i64(jnp.asarray([-1, -2, -3, 4], jnp.int64), n)))
    r1 = tn.left_rotate(f, 1, n)
    np.testing.assert_array_equal(
        np.asarray(r1), np.asarray(tn.from_i64(jnp.asarray([3, -4, -1, -2], jnp.int64), n)))


def test_tn_left_rotate_second_half_sign():
    # X^{-n} = -1: rotating by n must negate everything
    n = 4
    f = tn.from_i64(jnp.asarray([2, 3, -4, -1], jnp.int64), n)
    rn_ = tn.left_rotate(f, n, n)
    np.testing.assert_array_equal(
        np.asarray(rn_), np.asarray(tn.from_i64(jnp.asarray([-2, -3, 4, 1], jnp.int64), n)))


def test_t64_decompose_roundtrip():
    # reference torus.rs:160-190
    def recompose_bits(d):
        acc = np.uint64(0)
        for b in np.asarray(d).astype(np.uint64):
            acc = np.uint64((int(acc) << 1 | int(b)) % (1 << 64))
        return acc

    for x in [12345, 0, (1 << 64) - 2]:
        d = tn.decompose(jnp.uint64(x), 2, 64)
        assert int(recompose_bits(d)) == x

    rng = np.random.default_rng(7)
    xs = rng.integers(0, 1 << 63, size=50, dtype=np.uint64) * 2 + 1
    for x in xs[:20]:
        d = tn.decompose(jnp.uint64(int(x)), 2, 64)
        assert int(recompose_bits(d)) == int(x)


def test_t64_decompose_reference_l_lt_64():
    """Fixed-vector parity with torus.rs:43-52 for l < 64:
    the reference maps x to [(x >> i) & 1 for i in (0..l).rev()] — the LOW
    l bits, slice-MSB first.  Digits computed here with pure Python ints
    emulating the Rust expression exactly."""
    for l in (8, 32):
        for x in (12345, 0, (1 << 64) - 2, 0xDEADBEEF_CAFEBABE):
            want = [(x >> i) & 1 for i in range(l - 1, -1, -1)]
            got = np.asarray(tn.decompose_base2_reference(
                jnp.uint64(x), l)).astype(int).tolist()
            assert got == want, (l, x)
    # and for l = 64 the reference slice IS the library's gadget decompose
    x = 0x0123456789ABCDEF
    np.testing.assert_array_equal(
        np.asarray(tn.decompose_base2_reference(jnp.uint64(x), 64)),
        np.asarray(tn.decompose(jnp.uint64(x), 2, 64)))


def test_tn_mul_crt_matches_naive():
    rng = np.random.default_rng(8)
    for n in (64, 256):
        a = jnp.asarray(rng.integers(0, 1 << 64, size=(3, n), dtype=np.uint64))
        b = jnp.asarray(rng.integers(0, 1 << 64, size=(3, n), dtype=np.uint64))
        np.testing.assert_array_equal(
            np.asarray(tn.mul_crt(a, b)), np.asarray(tn.naive_mul(a, b)))


def test_tn_naive_mul_vs_bigint():
    rng = np.random.default_rng(9)
    n = 8
    a = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    got = np.asarray(tn.naive_mul(jnp.asarray(a), jnp.asarray(b)))
    c = [0] * (2 * n)
    for i in range(n):
        for j in range(n):
            c[i + j] += int(a[i]) * int(b[j])
    want = np.array([(c[k] - c[k + n]) % (1 << 64) for k in range(n)], dtype=object)
    np.testing.assert_array_equal(got.astype(object), want)


def test_tn_mod_switch():
    # torus.rs:58-66: right shift by 64 - log2(q2)
    v = jnp.uint64(0xF000_0000_0000_0000)
    assert int(tn.mod_switch(v, 1024)) == 0xF000_0000_0000_0000 >> 54


def test_matrix_ops_match_numpy():
    """Matrix<Zq> add / mul / transpose / scalar-mul over Z_q (reference
    matrix.rs:155-188) against numpy object-int arithmetic."""
    import numpy as np
    from fhe_study_tpu.arith import rq
    from fhe_study_tpu.ops import modops
    q = 65537
    rng = np.random.default_rng(0)
    A = rng.integers(0, q, (3, 4), dtype=np.uint64)
    B = rng.integers(0, q, (4, 5), dtype=np.uint64)
    v = rng.integers(0, q, (4,), dtype=np.uint64)
    # add (elementwise over Zq) + scalar mul
    got_add = modops.addmod(jnp.asarray(A), jnp.asarray(A[::-1].copy()), q)
    np.testing.assert_array_equal(np.asarray(got_add), (A + A[::-1]) % q)
    got_smul = modops.mulmod(jnp.asarray(A), jnp.uint64(12345), q)
    np.testing.assert_array_equal(np.asarray(got_smul), (A * 12345) % q)
    # mat-vec / mat-mat / transpose
    got_mv = rq.matrix_vec_product(jnp.asarray(A), jnp.asarray(v), q)
    np.testing.assert_array_equal(np.asarray(got_mv),
                                  (A.astype(object) @ v.astype(object)) % q)
    got_mm = rq.matrix_mul(jnp.asarray(A), jnp.asarray(B), q)
    np.testing.assert_array_equal(np.asarray(got_mm),
                                  (A.astype(object) @ B.astype(object)) % q)
    np.testing.assert_array_equal(np.asarray(rq.matrix_transpose(jnp.asarray(A))), A.T)
