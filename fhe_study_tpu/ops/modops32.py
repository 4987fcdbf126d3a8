"""u32 Montgomery modular arithmetic in plain XLA.

Why: residues below 2^31 need only 32-bit lanes, half the bytes of the u64
path in ops/modops.py.  The 32x32 -> 64 product is built from 16-bit-limb
partial products as ordinary jnp ops on u32 arrays, which XLA fuses into
the surrounding elementwise work.

Conventions:
  * all arrays u32, canonical values in [0, q), q < 2^31 odd;
  * per-prime constants travel as BROADCASTABLE u32 arrays: qv (primes),
    nqv (-q^{-1} mod 2^32), r2v (2^64 mod q — the Montgomery lift);
  * `mulmod(a, b, ...)` multiplies two NORMAL-domain operands (one internal
    lift: 2 REDC rounds); when one operand is a reusable table, pre-lift it
    with `to_mont` and call `mont_mul` (1 round).
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32


@lru_cache(maxsize=None)
def consts(qs: tuple, ndim: int):
    """(qv, nqv, r2v) u32 numpy arrays shaped [P, 1, ..1] for `ndim` dims."""
    shape = (len(qs),) + (1,) * (ndim - 1)
    qv = np.array(qs, np.uint32).reshape(shape)
    nqv = np.array([(-pow(q, -1, 1 << 32)) % (1 << 32) for q in qs],
                   np.uint32).reshape(shape)
    r2v = np.array([(1 << 64) % q for q in qs], np.uint32).reshape(shape)
    return qv, nqv, r2v


def mul32_hi_lo(a, b):
    """32x32 -> (hi, lo) via 16-bit limbs (u32 lanes only)."""
    mask = U32(0xFFFF)
    a0, a1 = a & mask, a >> U32(16)
    b0, b1 = b & mask, b >> U32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> U32(16)) + (p01 & mask) + (p10 & mask)
    lo = (mid << U32(16)) | (p00 & mask)
    hi = p11 + (p01 >> U32(16)) + (p10 >> U32(16)) + (mid >> U32(16))
    return hi, lo


def mont_mul(a, b_mont, qv, nqv):
    """a (normal) * b_mont (Montgomery) mod q -> normal domain.
    Valid for a*b_mont < q*2^32 (a may exceed q, up to 2^32/q headroom)."""
    hi, lo = mul32_hi_lo(a, b_mont)
    m = lo * nqv
    mh, _ = mul32_hi_lo(m, qv)
    t = hi + mh + (lo != U32(0)).astype(U32)
    return jnp.where(t >= qv, t - qv, t)


def to_mont(b, qv, nqv, r2v):
    """Lift normal -> Montgomery domain (b * 2^32 mod q)."""
    return mont_mul(b, r2v, qv, nqv)


def shoup_mul(a, w, wsh, qv):
    """a*w mod q via Harvey/Shoup: wsh = floor(w*2^32/q) precomputed
    alongside the (plain-domain) multiplier w.  One wide-high mul + two
    low muls — cheaper than Montgomery when the multiplier is key/plan
    material that can carry its companion plane.  Valid for any a < 2^32,
    w < q < 2^31."""
    hi, _ = mul32_hi_lo(a, wsh)
    t = a * w - hi * qv           # wrapping low-32; lands in [0, 2q)
    return jnp.where(t >= qv, t - qv, t)


def mulmod(a, b, qv, nqv, r2v):
    """(a * b) mod q for two NORMAL-domain operands."""
    return mont_mul(a, to_mont(b, qv, nqv, r2v), qv, nqv)


def addmod(a, b, qv):
    s = a + b
    return jnp.where(s >= qv, s - qv, s)


def submod(a, b, qv):
    return jnp.where(a >= b, a - b, (qv - b) + a)


def negmod(a, qv):
    return jnp.where(a == U32(0), a, qv - a)
