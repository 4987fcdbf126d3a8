"""R_q = Z_q[X]/(X^N+1): batched polynomial-ring ops on u64 [..., n] arrays.

The workhorse ring (reference arith/src/ring_nq.rs).  Functional design:
elements are plain u64 arrays with coefficients in [0, q); (q, n) are static.
Multiplication goes through the NTT; callers that reuse an operand across many
products hold its NTT evaluations explicitly (`to_evals` / `mul_evals`) — the
functional analog of the reference's lazy `evals` cache (ring_nq.rs:24-26).
"""

import jax.numpy as jnp

from ..ops import modops, ntt

U64 = jnp.uint64


# -- construction -----------------------------------------------------------

def reduce_negacyclic_u64(coeffs, q: int, n: int):
    """Apply mod (X^n + 1) to a coefficient array of length >= n over Z_q.
    (reference ring_nq.rs:132-141: p[i-n] -= p[i], repeatedly)"""
    c = coeffs
    while c.shape[-1] > n:
        length = c.shape[-1]
        m = min(n, length - n)
        head, tail = c[..., :n], c[..., n:n + m]
        pad = [(0, 0)] * (c.ndim - 1) + [(0, n - m)]
        folded = modops.submod(head, jnp.pad(tail, pad), q)
        rest = c[..., n + m:]
        c = jnp.concatenate([folded, rest], axis=-1) if rest.shape[-1] else folded
    return c


def from_u64(coeffs, q: int, n: int):
    """coeffs (any u64 values, length >= n or == n) -> canonical ring element."""
    c = modops.coerce_u64(jnp.asarray(coeffs, jnp.uint64), q)
    return reduce_negacyclic_u64(c, q, n)


def from_i64(coeffs, q: int, n: int):
    c = modops.coerce_i64(jnp.asarray(coeffs, jnp.int64), q)
    return reduce_negacyclic_u64(c, q, n)


def from_f64(coeffs, q: int, n: int):
    c = modops.coerce_f64(jnp.asarray(coeffs, jnp.float64), q)
    return reduce_negacyclic_u64(c, q, n)


def zeros(shape, n: int):
    return jnp.zeros(tuple(shape) + (n,), dtype=jnp.uint64)


# -- ring ops ---------------------------------------------------------------

def add(a, b, q: int):
    return modops.addmod(a, b, q)


def sub(a, b, q: int):
    return modops.submod(a, b, q)


def neg(a, q: int):
    return modops.negmod(a, q)


def mul(a, b, q: int):
    """Ring product via NTT (assumes q prime, q ≡ 1 mod 2n)."""
    return ntt.negacyclic_mul(a, b, q)


def to_evals(a, q: int):
    return ntt.ntt(a, q)


def from_evals(ea, q: int):
    return ntt.intt(ea, q)


def mul_evals(ea, eb, q: int):
    """Pointwise product in the evaluation domain."""
    return modops.mulmod(ea, eb, q)


def scalar_mul_u64(a, s, q: int):
    """a * s with s (array or int) reduced mod q first (ring_nq.rs:274-281)."""
    s = modops.coerce_u64(jnp.asarray(s, jnp.uint64), q)
    return modops.mulmod(a, s, q)


def scalar_mul_f64(a, s, q: int):
    """round(a_i * s) mod q per coefficient (ring_nq.rs:282-292)."""
    return modops.coerce_f64(a.astype(jnp.float64) * s, q)


# -- conversions / switches -------------------------------------------------

def remodule(a, q: int, p: int):
    """Reinterpret coefficients mod p (crops when q >= p; ring_nq.rs:82-88)."""
    return modops.coerce_u64(a, p)


def mod_switch(a, q: int, p: int):
    """Coefficient-wise round(v * p / q) mod p (ring_nq.rs:91-101)."""
    return modops.mod_switch(a, q, p)


def mul_div_round(a, num: int, den: int, q: int):
    """round(num * v / den) mod q, f64 path (ring_nq.rs:103-113)."""
    return modops.mul_div_round(a, num, den, q)


def div_round(a, s: int, q: int):
    """round(v / s) mod q (ring_nq.rs:299-306)."""
    return modops.coerce_f64(a.astype(jnp.float64) / float(s), q)


def coeffs_mod(a, t: int):
    """Apply mod t to coefficients (ring_nq.rs:253-261)."""
    return modops.coerce_u64(a, t)


def decompose(a, q: int, beta: int, l: int):
    """Gadget decomposition per coefficient -> [l, ..., n] (ring_nq.rs:67-77)."""
    return modops.decompose(a, q, beta, l)


# -- norms / lifts ----------------------------------------------------------

def infinity_norm(a, q: int):
    """max |centered lift| (ring_nq.rs:347-358)."""
    c = jnp.where(a > U64(q // 2), U64(q) - a, a)
    return jnp.max(c, axis=-1)


def to_centered_i64(a, q: int):
    """Centered lift to (-q/2, q/2] as int64 (reference mod_centered_q,
    ring_n.rs:113-128: res > q/2 -> res - q)."""
    v = a.astype(jnp.int64)
    return jnp.where(v > q // 2, v - jnp.int64(q), v)


def to_r(a):
    """Lift to Z[X] keeping representatives in [0, q) (reference Rq::to_r,
    ring_n.rs:72-79 — note: NOT centered)."""
    return a.astype(jnp.int64)


# -- matrix helpers (reference ring_nq.rs:363-399 / matrix.rs:16-100) -------

def matrix_vec_product(m, v, q: int):
    """[..., r, c] x [..., c] -> [..., r] over Z_q (sum of mulmods — the
    reference's matrix_vec_product; u64 has no matrix unit, so mul+reduce)."""
    prod = modops.mulmod(m, v[..., None, :], q)       # each < q < 2^32
    return modops.coerce_u64(jnp.sum(prod, axis=-1), q)


def matrix_transpose(m):
    return jnp.swapaxes(m, -1, -2)


def matrix_mul(a, b, q: int):
    """[..., r, k] x [..., k, c] -> [..., r, c] over Z_q."""
    prod = modops.mulmod(a[..., :, :, None], b[..., None, :, :], q)
    return modops.coerce_u64(jnp.sum(prod, axis=-2), q)


# -- pretty printer (host; golden-string tests, ring_nq.rs:308-345) ---------

def to_string(a, q: int, n: int) -> str:
    import numpy as np
    coeffs = np.asarray(a).reshape(-1)
    assert coeffs.shape[0] == n
    parts = []
    for i in range(n - 1, -1, -1):
        v = int(coeffs[i])
        if v == 0:
            continue
        if i == 0:
            term = str(v)
        elif i == 1:
            term = "x" if v == 1 else f"{v}*x"
        else:
            term = f"x^{i}" if v == 1 else f"{v}*x^{i}"
        parts.append(term)
    body = " + ".join(parts) if parts else "0"
    return f"{body} mod Z_{q}/(X^{n}+1)"
