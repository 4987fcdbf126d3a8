"""GLWE core tests (reference gfhe/src/glwe.rs + glev.rs tests).

The reference loops 200 serial iterations per property; we run one batched
shot over a batch axis — same statistical coverage, batched.
"""

import numpy as np
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith import RingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.arith.ring import ring_for
from fhe_study_tpu.models.gfhe import glwe as G
from fhe_study_tpu.models.gfhe import glev as GL
from fhe_study_tpu.ops import modops
from fhe_study_tpu.utils import prng

Q = 2 ** 16 + 1
B = 32  # batch


def _msg(key, param, batch=()):
    return prng.uniform_mod(key, tuple(batch) + (param.ring.n,), param.t)


def test_encrypt_decrypt_rq():
    # reference glwe.rs:327-363 (q=2^16+1, n=128, k=16, t=32)
    param = G.Param(G.ERR_SIGMA, RingParam(Q, 128), 16, 32)
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = prng.split(key, 4)
    sk, pk = G.new_key(k1, param, batch=(B,))
    m = _msg(k2, param, (B,))
    p = G.encode(param, m)

    c = G.encrypt(k3, param, pk, p, batch=(B,))
    rec = G.decode(param, G.decrypt(param, sk, c))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))

    c = G.encrypt_s(k4, param, sk, p, batch=(B,))
    rec = G.decode(param, G.decrypt(param, sk, c))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))


def test_encrypt_decrypt_torus():
    # reference glwe.rs:379-416 (q=torus, n=128, k=16, t=32)
    param = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, 128), 16, 32)
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4 = prng.split(key, 4)
    sk, pk = G.new_key(k1, param, batch=(B,))
    m = _msg(k2, param, (B,))
    delta = TORUS_Q // param.t
    p = m * jnp.uint64(delta)  # t_encode (glwe.rs:366-374)

    c = G.encrypt(k3, param, pk, p, batch=(B,))
    rec = ring_for(param.ring).decode_scale(G.decrypt(param, sk, c), param.t)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))

    c = G.encrypt_s(k4, param, sk, p, batch=(B,))
    rec = ring_for(param.ring).decode_scale(G.decrypt(param, sk, c), param.t)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))


def test_addition_and_add_plaintext():
    # reference glwe.rs:418-491
    param = G.Param(G.ERR_SIGMA, RingParam(Q, 128), 16, 20)
    key = jax.random.PRNGKey(2)
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    sk, pk = G.new_key(k1, param, batch=(B,))
    m1 = _msg(k2, param, (B,))
    m2 = _msg(k3, param, (B,))
    c1 = G.encrypt(k4, param, pk, G.encode(param, m1), batch=(B,))
    c2 = G.encrypt(k5, param, pk, G.encode(param, m2), batch=(B,))

    c3 = G.add(param, c1, c2)
    rec = G.decode(param, G.decrypt(param, sk, c3))
    want = modops.coerce_u64(m1 + m2, param.t)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))

    c3 = G.add_pt(param, c1, G.encode(param, m2))
    rec = G.decode(param, G.decrypt(param, sk, c3))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))


def test_mul_plaintext():
    # reference glwe.rs:493-527 (n=16, t=4)
    from fhe_study_tpu.arith import rn
    param = G.Param(G.ERR_SIGMA, RingParam(Q, 16), 16, 4)
    key = jax.random.PRNGKey(3)
    k1, k2, k3, k4 = prng.split(key, 4)
    sk, pk = G.new_key(k1, param, batch=(B,))
    m1 = _msg(k2, param, (B,))
    m2 = _msg(k3, param, (B,))
    c1 = G.encrypt(k4, param, pk, G.encode(param, m1), batch=(B,))

    c3 = G.mul_pt(param, c1, modops.coerce_u64(m2, Q))
    rec = G.decode(param, G.decrypt(param, sk, c3))
    # exact integer product mod (X^n+1), then mod t (reference:
    # (m1.to_r() * m2.to_r()).to_rq(t))
    want = rn.to_rq(rn.naive_poly_mul(m1.astype(jnp.int64), m2.astype(jnp.int64)),
                    param.t, param.ring.n)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))


def test_mod_switch():
    # reference glwe.rs:529-578 (q=2^16+1 -> 2^8+1, n=8, t=4)
    param = G.Param(G.ERR_SIGMA, RingParam(Q, 8), 16, 4)
    new_q = 2 ** 8 + 1
    key = jax.random.PRNGKey(4)
    k1, k2, k3 = prng.split(key, 3)
    sk, pk = G.new_key(k1, param, batch=(B,))
    m = _msg(k2, param, (B,))
    c = G.encrypt(k3, param, pk, G.encode(param, m), batch=(B,))

    c2 = G.mod_switch(param, c, new_q)
    new_param = G.Param(G.ERR_SIGMA, RingParam(new_q, 8), 16, 4)
    sk2 = modops.coerce_u64(sk, new_q)  # remodule of each sk_i
    rec = G.decode(new_param, G.decrypt(new_param, sk2, c2))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))


def test_key_switch():
    # reference glwe.rs:580-624 (beta=2, l=16, n=128, k=16, t=2)
    param = G.Param(G.ERR_SIGMA, RingParam(Q, 128), 16, 2)
    beta, l = 2, 16
    key = jax.random.PRNGKey(5)
    k1, k2, k3, k4, k5, k6 = prng.split(key, 6)
    sk, pk = G.new_key(k1, param)
    sk2, _ = G.new_key(k2, param)
    ksk = G.new_ksk(k3, param, beta, l, sk, sk2)

    m = _msg(k4, param)
    p = G.encode(param, m)
    c = G.encrypt_s(k5, param, sk, p)
    c2 = G.key_switch(param, beta, l, ksk, c)
    rec = G.decode(param, G.decrypt(param, sk2, c2))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))

    c = G.encrypt(k6, param, pk, p)
    c2 = G.key_switch(param, beta, l, ksk, c)
    rec = G.decode(param, G.decrypt(param, sk2, c2))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))


def test_glev_encrypt_decrypt():
    # reference glev.rs:91-122 (beta=2, l=16, t=2)
    param = G.Param(G.ERR_SIGMA, RingParam(Q, 128), 16, 2)
    beta, l = 2, 16
    key = jax.random.PRNGKey(6)
    k1, k2, k3 = prng.split(key, 3)
    sk, pk = G.new_key(k1, param, batch=(8,))
    m = modops.coerce_u64(_msg(k2, param, (8,)), Q)
    c = GL.encrypt(k3, param, beta, l, pk, m, batch=(8,))
    rec = GL.decrypt(param, sk, c, beta)
    np.testing.assert_array_equal(np.asarray(modops.coerce_u64(rec, param.t)),
                                  np.asarray(modops.coerce_u64(m, param.t)))
