"""Vectorized Z_q arithmetic on uint64 arrays.

Vectorized substrate replacing the reference's scalar ``Zq`` type
(reference arith/src/zq.rs).  XLA has no 64x64->128 multiply, so:

  * q < 2^32 (every NTT modulus and every reference test modulus): products of
    canonical representatives fit exactly in u64 -> plain ``(a * b) % q``.
  * 2^32 <= q < 2^63, q odd (e.g. the BFV relinearization modulus p*q):
    Montgomery multiplication built on a 32-bit-limb mul128.

All functions operate elementwise on arrays of any shape; ``q`` is a static
Python int baked into the jit cache.
"""

from functools import lru_cache

import jax.numpy as jnp

from ..utils.rounding import round_half_away

U64 = jnp.uint64
_MASK32 = (1 << 32) - 1


def u64(x):
    return jnp.asarray(x, dtype=jnp.uint64)


# ---------------------------------------------------------------------------
# add / sub / neg (conditional correction, reference zq.rs:219-313)
# ---------------------------------------------------------------------------

def addmod(a, b, q: int):
    s = a + b  # a, b < q < 2^63 -> no wrap
    return jnp.where(s >= U64(q), s - U64(q), s)


def submod(a, b, q: int):
    return jnp.where(a >= b, a - b, (U64(q) - b) + a)


def negmod(a, q: int):
    return jnp.where(a == U64(0), a, U64(q) - a)


def coerce_u64(v, q: int):
    """u64 values (any range) -> canonical [0, q)."""
    return u64(v) % U64(q)


def coerce_i64(v, q: int):
    """signed int64 values -> canonical [0, q) (Rust (e % q + q) % q)."""
    qq = jnp.int64(q)
    return (jnp.mod(jnp.mod(jnp.asarray(v, jnp.int64), qq) + qq, qq)).astype(jnp.uint64)


def coerce_f64(v, q: int):
    """f64 -> round-half-away -> canonical [0, q).  (reference zq.rs:32-39)"""
    return coerce_i64(round_half_away(jnp.asarray(v, jnp.float64)), q)


# ---------------------------------------------------------------------------
# mul
# ---------------------------------------------------------------------------

def mul128(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) u64 pair, via 32-bit limbs."""
    a0 = a & U64(_MASK32)
    a1 = a >> U64(32)
    b0 = b & U64(_MASK32)
    b1 = b >> U64(32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> U64(32)) + (p01 & U64(_MASK32)) + (p10 & U64(_MASK32))
    lo = (mid << U64(32)) | (p00 & U64(_MASK32))
    hi = p11 + (p01 >> U64(32)) + (p10 >> U64(32)) + (mid >> U64(32))
    return hi, lo


@lru_cache(maxsize=None)
def _mont_consts(q: int):
    assert q % 2 == 1 and q < (1 << 63), "Montgomery path needs odd q < 2^63"
    nqinv = (-pow(q, -1, 1 << 64)) % (1 << 64)  # -q^{-1} mod 2^64
    r2 = (1 << 128) % q                          # 2^128 mod q
    return nqinv, r2


def _mont_redc(hi, lo, q: int, nqinv: int):
    """Montgomery reduction of a 128-bit value (hi, lo): returns value * 2^-64 mod q."""
    m = lo * U64(nqinv)                       # wrapping low-64 product
    mh, ml = mul128(m, U64(q))
    carry = (lo != U64(0)).astype(jnp.uint64)  # lo + ml == 0 mod 2^64 by construction
    t = hi + mh + carry
    return jnp.where(t >= U64(q), t - U64(q), t)


def mulmod(a, b, q: int):
    """a * b mod q for canonical a, b in [0, q).  Exact for any q < 2^63."""
    if q < (1 << 32):
        return (a * b) % U64(q)
    nqinv, r2 = _mont_consts(q)
    hi, lo = mul128(a, b)
    t = _mont_redc(hi, lo, q, nqinv)          # a*b*2^-64 mod q
    hi2, lo2 = mul128(t, U64(r2 % (1 << 64)))
    return _mont_redc(hi2, lo2, q, nqinv)     # a*b mod q


def powmod(a, e: int, q: int):
    """a^e mod q (static exponent, square-and-multiply unrolled at trace time)."""
    result = jnp.full_like(u64(a), 1)
    base = u64(a)
    ee = int(e)
    while ee > 0:
        if ee & 1:
            result = mulmod(result, base, q)
        base = mulmod(base, base, q)
        ee >>= 1
    return result


def invmod_prime(a, q: int):
    """a^-1 mod q by Fermat (q prime — the library's hot path; every NTT/RNS
    modulus is prime).  For composite q use invmod (reference-parity egcd
    semantics, zq.rs:113-130)."""
    return powmod(a, q - 2, q)


def _binary_inv_odd(a, m: int):
    """Vectorized a^{-1} mod odd m via binary extended gcd, static iteration
    bound (jittable: no data-dependent control flow).  a coprime to m."""
    assert m % 2 == 1 and 1 <= m < (1 << 63)
    u = u64(a) % U64(m)
    v = jnp.full_like(u, U64(m))
    x1 = jnp.ones_like(u)
    x2 = jnp.zeros_like(u)
    one, mm = U64(1), U64(m)

    def body(_, st):
        u, v, x1, x2 = st
        u_even = (u & one) == 0
        v_even = jnp.logical_and(~u_even, (v & one) == 0)
        sub_u = jnp.logical_and(~u_even, jnp.logical_and(~v_even, u >= v))
        sub_v = jnp.logical_and(~u_even, jnp.logical_and(~v_even, u < v))
        # halving step: x/2 if even else (x+m)/2 (exact: x+m < 2^64);
        # all updates computed from the OLD state, then assigned together
        h1 = jnp.where((x1 & one) == 0, x1 >> one, (x1 + mm) >> one)
        h2 = jnp.where((x2 & one) == 0, x2 >> one, (x2 + mm) >> one)
        return (jnp.where(u_even, u >> one, jnp.where(sub_u, u - v, u)),
                jnp.where(v_even, v >> one, jnp.where(sub_v, v - u, v)),
                jnp.where(u_even, h1,
                          jnp.where(sub_u, submod(x1, x2, m), x1)),
                jnp.where(v_even, h2,
                          jnp.where(sub_v, submod(x2, x1, m), x2)))

    # each iteration either halves u or v, or subtracts (making one even):
    # bitlen(u)+bitlen(v) falls by >=1 every 2 iterations -> 4*bitlen bound
    import jax
    u, v, x1, x2 = jax.lax.fori_loop(0, 4 * m.bit_length() + 4, body,
                                     (u, v, x1, x2))
    return jnp.where(u == one, x1, x2)


def invmod(a, q: int):
    """a^{-1} mod q for ANY modulus (a coprime to q) — parity with the
    reference's egcd-based Zq::inv (zq.rs:113-130), which is valid for
    composite q; invmod_prime (Fermat) is the prime-q fast path.

    Vectorized/jittable: binary xgcd with a static iteration bound for the
    odd part of q, Newton (Hensel) lifting for the 2-power part, CRT-combined
    with host constants.  Non-coprime inputs yield unspecified output (the
    reference panics there; inside jit there is no data-dependent panic)."""
    assert 1 < q < (1 << 63)
    k = (q & -q).bit_length() - 1          # q = 2^k * m, m odd
    m = q >> k
    if k == 0:
        return _binary_inv_odd(a, q)
    # inverse mod 2^k: x0 = a satisfies a*x0 == 1 (mod 8); five Newton
    # doublings x <- x*(2 - a*x) reach 2^96 >= 2^64 >= 2^k (wrapping u64)
    mask = U64((1 << k) - 1)
    av = u64(a)
    x = av
    for _ in range(5):
        x = x * (U64(2) - av * x)          # wrapping: correct mod 2^64
    i1 = x & mask
    if m == 1:
        return i1
    i2 = _binary_inv_odd(a, m)
    # CRT: x == i2 (mod m), x == i1 (mod 2^k):  x = i2 + m * t,
    # t = (i1 - i2) * m^{-1} mod 2^k  (all < q < 2^63: exact u64)
    minv2k = pow(m, -1, 1 << k)
    t = ((i1 - i2) * U64(minv2k)) & mask
    return i2 + U64(m) * t


def divmod_prime(a, b, q: int):
    """a / b = a * b^-1 mod q (q prime; reference zq.rs:329-337)."""
    return mulmod(a, invmod_prime(b, q), q)


def divmod_any(a, b, q: int):
    """a / b mod q for any modulus with b coprime to q (egcd-parity div)."""
    return mulmod(a, invmod(b, q), q)


# ---------------------------------------------------------------------------
# mod switch / scaled rounding  (reference zq.rs:133-138)
# ---------------------------------------------------------------------------

def mod_switch(v, q: int, q2: int):
    """round(v * q2 / q) mod q2, f64 semantics as in the reference."""
    r = round_half_away(v.astype(jnp.float64) * float(q2) / float(q))
    return coerce_i64(r, q2)


def mul_div_round(v, num: int, den: int, q: int):
    """round(num * v / den) mod q, f64 semantics (reference ring_nq.rs:106-113)."""
    r = round_half_away(float(num) * v.astype(jnp.float64) / float(den))
    return coerce_i64(r, q)


# ---------------------------------------------------------------------------
# gadget decomposition  (reference zq.rs:140-207)
# ---------------------------------------------------------------------------

def decompose_base_beta(v, q: int, beta: int, l: int):
    """Unsigned digits of v against denominators q // beta^i, i = 1..l.

    Saturates to beta-1 digits when v >= beta^l (the reference's
    "approximate" branch, zq.rs:151-160).  Returns an array with a new
    leading axis of length l (digit-major, most significant first).
    """
    digits = []
    rem = u64(v)
    for i in range(1, l + 1):
        den = U64(q // beta ** i)
        d = rem // den
        rem = rem % den
        digits.append(d)
    out = jnp.stack(digits, axis=0)
    sat = (u64(v) >= U64(beta ** l))
    return jnp.where(sat[None, ...], U64(beta - 1), out)


def decompose_base2(v, q: int, l: int):
    """Bit decomposition, MSB-of-l-bit-window first (reference zq.rs:174-207)."""
    shifts = jnp.arange(l - 1, -1, -1, dtype=jnp.uint64)
    shape = (l,) + (1,) * jnp.ndim(v)
    d = (u64(v)[None, ...] >> shifts.reshape(shape)) & U64(1)
    sat = (u64(v) >= U64(1 << l)) if l < 64 else jnp.zeros(jnp.shape(v), bool)
    return jnp.where(sat[None, ...], U64(1), d)


def decompose(v, q: int, beta: int, l: int):
    """Dispatch matching the reference (beta==2 -> pure bit path)."""
    if beta == 2:
        return decompose_base2(v, q, l)
    return decompose_base_beta(v, q, beta, l)


def recompose(digits, q: int, beta: int, l: int):
    """sum_i d_i * (q // beta^(i+1)) mod q — test helper (zq.rs:374-380)."""
    acc = jnp.zeros(digits.shape[1:], dtype=jnp.uint64)
    for i in range(l):
        acc = acc + digits[i] * U64(q // beta ** (i + 1))
    return coerce_u64(acc, q)
