"""T_{N,q}[X] with q = 2^64 — torus polynomials on u64 [..., n] arrays.

All arithmetic is native wrapping u64 (exact mod 2^64), replacing the
reference's u128-accumulate schoolbook (reference arith/src/ring_torus.rs).
The scalar torus T64 (reference arith/src/torus.rs) is the n = 1 case; TLWE
code stores it as plain u64 arrays without a poly axis.

Two product paths, both exact mod 2^64:
  * `naive_mul`: wrapping outer-product schoolbook, O(n^2) — wrapping u64
    products/sums ARE the low 64 bits of the exact integer convolution.
  * `mul` (default for n >= 64): 16-bit limb split + 2-prime CRT NTT,
    O(n log n) — the fast path.  Limb convolutions are exact (< 2^48 for
    n <= 2^14) and recombined with wrapping shifts.
"""

import jax.numpy as jnp

from ..ops import modops, ntt
from ..utils.rounding import round_half_away

U64 = jnp.uint64


# -- basic wrapping ops -----------------------------------------------------

def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return U64(0) - a


def scalar_mul(a, s):
    """wrapping a * s (s: u64 array or int)."""
    return a * jnp.asarray(s, jnp.uint64)


# -- construction -----------------------------------------------------------

def reduce_negacyclic(c, n: int):
    """mod (X^n+1) with wrapping subtraction (ring_torus.rs:141-151)."""
    while c.shape[-1] > n:
        length = c.shape[-1]
        m = min(n, length - n)
        head, tail = c[..., :n], c[..., n:n + m]
        pad = [(0, 0)] * (c.ndim - 1) + [(0, n - m)]
        folded = head - jnp.pad(tail, pad)
        rest = c[..., n + m:]
        c = jnp.concatenate([folded, rest], axis=-1) if rest.shape[-1] else folded
    return c


def from_u64(coeffs, n: int):
    return reduce_negacyclic(jnp.asarray(coeffs, jnp.uint64), n)


def from_i64(coeffs, n: int):
    return reduce_negacyclic(jnp.asarray(coeffs, jnp.int64).astype(jnp.uint64), n)


# -- products ---------------------------------------------------------------

def naive_mul(a, b):
    """Wrapping schoolbook negacyclic product (ring_torus.rs:266-287)."""
    n = a.shape[-1]
    prod = a[..., :, None] * b[..., None, :]
    i = jnp.arange(n)[:, None] + jnp.arange(n)[None, :]
    out = jnp.zeros(a.shape[:-1] + (2 * n - 1,), dtype=jnp.uint64)
    full = out.at[..., i].add(prod)
    return reduce_negacyclic(full, n)


_LIMB_BITS = 16
_NUM_LIMBS = 4


def _split_limbs(a):
    """u64 [..., n] -> [..., 4, n] of 16-bit limbs (low first)."""
    mask = U64((1 << _LIMB_BITS) - 1)
    limbs = [(a >> U64(_LIMB_BITS * i)) & mask for i in range(_NUM_LIMBS)]
    return jnp.stack(limbs, axis=-2)


def mul_crt(a, b):
    """Exact wrapping negacyclic product via limb-split CRT NTT.

    result mod 2^64 = sum_{k=0..3} 2^(16k) * g_k  where
    g_k = sum_{c+d=k} conv(a_c, b_d); each g_k < 4*n*2^32 (exact under the
    2-prime CRT for n <= 2^26)."""
    p1, p2 = ntt.CRT_PRIMES[:2]
    al = _split_limbs(a)  # [..., 4, n]
    bl = _split_limbs(b)
    out = jnp.zeros(jnp.broadcast_shapes(a.shape, b.shape), dtype=jnp.uint64)
    # transform limbs once per prime
    ea1 = ntt.ntt(al % U64(p1), p1)
    eb1 = ntt.ntt(bl % U64(p1), p1)
    ea2 = ntt.ntt(al % U64(p2), p2)
    eb2 = ntt.ntt(bl % U64(p2), p2)
    p1_inv_p2 = pow(p1, -1, p2)
    for k in range(_NUM_LIMBS):
        # pointwise sum over limb pairs c + d = k
        acc1 = jnp.zeros(out.shape, dtype=jnp.uint64)
        acc2 = jnp.zeros(out.shape, dtype=jnp.uint64)
        for c in range(k + 1):
            d = k - c
            acc1 = acc1 + modops.mulmod(ea1[..., c, :], eb1[..., d, :], p1)
            acc2 = acc2 + modops.mulmod(ea2[..., c, :], eb2[..., d, :], p2)
        r1 = ntt.intt(acc1 % U64(p1), p1)
        r2 = ntt.intt(acc2 % U64(p2), p2)
        delta = modops.mulmod(modops.submod(r2, r1 % U64(p2), p2), U64(p1_inv_p2), p2)
        g_k = r1 + U64(p1) * delta          # in [0, p1*p2)
        # centered lift: negacyclic-reduced convolutions can be negative;
        # the wrapping subtraction of p1*p2 yields the right value mod 2^64
        m = ntt.CRT_PRIMES[0] * ntt.CRT_PRIMES[1]
        g_k = jnp.where(g_k > U64(m // 2), g_k - U64(m % (1 << 64)), g_k)
        out = out + (g_k << U64(_LIMB_BITS * k))  # wrapping recombine
    return out


def mul(a, b):
    n = a.shape[-1]
    if n >= 64:
        return mul_crt(a, b)
    return naive_mul(a, b)


# -- rotations / extraction -------------------------------------------------

def left_rotate(a, h, n: int):
    """Multiply by X^{-h}, h in [0, 2n), traced or static; h must be
    broadcastable to a.shape[:-1] (per-batch rotation amounts supported).

    h < n reproduces the reference exactly (ring_torus.rs:118-132:
    [c_h..c_{n-1}, -c_0..-c_{h-1}]); h in [n, 2n) applies the extra
    negacyclic sign flip (X^{-n} = -1), needed by the *correct* blind
    rotation over mod-2N switched exponents."""
    h = jnp.asarray(h, jnp.int64) % (2 * n)
    idx = (jnp.arange(n, dtype=jnp.int64) + h[..., None]) % (2 * n)
    wrapped = idx >= n
    take = jnp.where(wrapped, idx - n, idx)
    shape = jnp.broadcast_shapes(a.shape, take.shape)
    a_b = jnp.broadcast_to(a, shape)
    take_b = jnp.broadcast_to(take, shape)
    wrapped_b = jnp.broadcast_to(wrapped, shape)
    vals = jnp.take_along_axis(a_b, take_b, axis=-1)
    return jnp.where(wrapped_b, U64(0) - vals, vals)


# -- switches / decomposition ----------------------------------------------

def mod_switch(a, q2: int):
    """2^64 -> q2 (power of two): right shift by 64 - log2(q2)
    (reference torus.rs:58-66 — floor semantics)."""
    assert q2 & (q2 - 1) == 0 and q2 > 0
    log2_q2 = q2.bit_length() - 1
    return a >> U64(64 - log2_q2)


def mod_switch_round(a, q2: int):
    """2^64 -> q2 (power of two), round-to-nearest: the standard TFHE
    mod switch. Floor switching biases the blind-rotation phase by
    +E[sum frac_j * s_j] ≈ kn/4 switched units — a full LUT window at
    typical parameters — so the correct bootstrap must round."""
    assert q2 & (q2 - 1) == 0 and q2 > 0
    log2_q2 = q2.bit_length() - 1
    shifted = a >> U64(63 - log2_q2)                     # one guard bit
    return ((shifted + U64(1)) >> U64(1)) % U64(q2)


def mod_switch_to_rq(a, p: int):
    """Tn -> Rq mod switch (ring_torus.rs:85-101)."""
    return modops.coerce_u64(mod_switch(a, p), p)


def mul_div_round(a, num: int, den: int):
    """round(num * v / den) as u64, f64 path (torus.rs:68-70)."""
    r = round_half_away(float(num) * a.astype(jnp.float64) / float(den))
    return r.astype(jnp.int64).astype(jnp.uint64)


def decompose_base2(a, l: int):
    """Bit decomposition MSB-first over the top-l bits -> [l, ...].

    For l = 64 this is exactly the reference (torus.rs:43-52).  For l < 64 the
    reference takes the LOW l bits (its own doc says "only beta=2 and l=64 is
    supported", torus.rs:41-42, and no reference call site uses l < 64); we
    take the TOP l bits, which is the correct gadget decomposition and what
    the TLev scale factors (2^64/2^i) correspond to.  The reference's exact
    l < 64 behavior is reproduced by `decompose_base2_reference` below and
    pinned against torus.rs digit vectors in tests/test_rings.py."""
    shifts = jnp.arange(l, dtype=jnp.uint64)
    shape = (l,) + (1,) * jnp.ndim(a)
    return (a[None, ...] >> (U64(63) - shifts.reshape(shape))) & U64(1)


def decompose_base2_reference(a, l: int):
    """Bit-parity mode for the reference's l < 64 slice (torus.rs:43-52):
    digits are the LOW l bits, MSB-of-the-slice first —
    digit_i = (x >> (l-1-i)) & 1.  Quirk-parity only: these digits do NOT
    satisfy the gadget identity sum(digit_i * 2^(64-1-i)) = x for l < 64
    (the reference never exercises that path; see decompose_base2)."""
    shifts = jnp.arange(l, dtype=jnp.uint64)
    shape = (l,) + (1,) * jnp.ndim(a)
    return (a[None, ...] >> (U64(l - 1) - shifts.reshape(shape))) & U64(1)


def decompose_base_pow2(a, w: int, l: int):
    """Unsigned base-2^w gadget digits, MSB-first: digit_i = top bits
    [64-w(i+1), 64-w*i). Generalization used by production bootstrapping
    parameters (the reference hardwires beta=2, l=64)."""
    assert w * l <= 64
    shifts = (64 - w * (jnp.arange(l, dtype=jnp.uint64) + 1)).astype(jnp.uint64)
    shape = (l,) + (1,) * jnp.ndim(a)
    return (a[None, ...] >> shifts.reshape(shape)) & U64((1 << w) - 1)


def decompose(a, beta: int, l: int):
    assert beta >= 2 and (beta & (beta - 1)) == 0, "torus decomposition needs beta = 2^w"
    w = beta.bit_length() - 1
    if beta == 2:
        return decompose_base2(a, l)
    return decompose_base_pow2(a, w, l)
