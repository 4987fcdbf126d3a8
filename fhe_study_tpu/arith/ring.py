"""Ring abstraction: the two coefficient worlds the GLWE layer runs over.

The reference expresses genericity with a Rust trait (arith/src/ring.rs); here
each ring is a lightweight static object whose methods operate on batched
coefficient arrays:

  * RqRing(q, n)   — Z_q[X]/(X^n+1), u64 [..., n] in [0, q)   (arith/ring_nq.rs)
  * TorusRing(n)   — T_{n,2^64}[X], wrapping u64 [..., n]     (arith/ring_torus.rs,
                      n = 1 recovers the scalar torus T64, arith/torus.rs)

Elements are stacked along axis -2 for GLWE masks: a mask is [..., k, n].
`contract(x, y)` — sum_k x_k * y_k (the TR·TR dot product of tuple_ring.rs:117)
is THE hot op: both rings implement it as one fused transform/pointwise/
reduce/inverse-transform pipeline (batched array ops, no per-element loops).
"""

from dataclasses import dataclass

import jax.numpy as jnp

from ..ops import modops, ntt
from ..utils import prng
from . import rq, tn
from .params import RingParam, TORUS_Q

U64 = jnp.uint64


@dataclass(frozen=True)
class RqRing:
    q: int
    n: int

    @property
    def param(self):
        return RingParam(self.q, self.n)

    # construction ---------------------------------------------------------
    def zeros(self, shape=()):
        return jnp.zeros(tuple(shape) + (self.n,), dtype=jnp.uint64)

    def from_u64(self, coeffs):
        return rq.from_u64(coeffs, self.q, self.n)

    # sampling -------------------------------------------------------------
    def rand_uniform(self, key, shape=()):
        return prng.uniform_mod(key, tuple(shape) + (self.n,), self.q)

    def rand_bin(self, key, shape=()):
        return prng.binary(key, tuple(shape) + (self.n,))

    def rand_err(self, key, shape, sigma):
        return prng.gaussian_mod(key, tuple(shape) + (self.n,), sigma, self.q)

    # arithmetic -----------------------------------------------------------
    def add(self, a, b):
        return modops.addmod(a, b, self.q)

    def sub(self, a, b):
        return modops.submod(a, b, self.q)

    def neg(self, a):
        return modops.negmod(a, self.q)

    def mul(self, a, b):
        return ntt.negacyclic_mul(a, b, self.q) if self.n > 1 else \
            modops.mulmod(a, b, self.q)

    def scalar_mul_u64(self, a, s: int):
        return rq.scalar_mul_u64(a, s, self.q)

    def contract(self, x, y):
        """sum over axis -2 of ring products: [..., M, n] x [..., M, n] -> [..., n]."""
        if self.n == 1:
            prod = modops.mulmod(x, y, self.q)     # each < q
            return modops.coerce_u64(jnp.sum(prod, axis=-2), self.q)
        ex = ntt.ntt(x, self.q)
        ey = ntt.ntt(y, self.q)
        prod = modops.mulmod(ex, ey, self.q)      # each < q < 2^32
        s = jnp.sum(prod, axis=-2)                 # sum of M terms, fits u64 for M < 2^32
        return ntt.intt(modops.coerce_u64(s, self.q), self.q)

    # gadget / switching ---------------------------------------------------
    def decompose(self, a, beta: int, l: int):
        return modops.decompose(a, self.q, beta, l)

    def mod_switch(self, a, p: int):
        return modops.mod_switch(a, self.q, p)

    def mul_div_round(self, a, num: int, den: int):
        return modops.mul_div_round(a, num, den, self.q)

    def decode_scale(self, a, t: int):
        """decode helper: round(t * v / q) mod t (glwe.rs:192-196)."""
        return modops.coerce_u64(modops.mul_div_round(a, t, self.q, self.q), t)


@dataclass(frozen=True)
class TorusRing:
    n: int
    q: int = TORUS_Q  # tag, matching the reference's RingParam convention

    @property
    def param(self):
        return RingParam(TORUS_Q, self.n)

    # construction ---------------------------------------------------------
    def zeros(self, shape=()):
        return jnp.zeros(tuple(shape) + (self.n,), dtype=jnp.uint64)

    def from_u64(self, coeffs):
        return tn.from_u64(coeffs, self.n)

    # sampling -------------------------------------------------------------
    def rand_uniform(self, key, shape=()):
        return prng.uniform_u64(key, tuple(shape) + (self.n,))

    def rand_bin(self, key, shape=()):
        return prng.binary(key, tuple(shape) + (self.n,))

    def rand_err(self, key, shape, sigma):
        return prng.gaussian_torus(key, tuple(shape) + (self.n,), sigma)

    # arithmetic (wrapping) -------------------------------------------------
    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return U64(0) - a

    def mul(self, a, b):
        if self.n == 1:
            return a * b
        return tn.mul(a, b)

    def scalar_mul_u64(self, a, s: int):
        return a * U64(s % (1 << 64))

    def contract(self, x, y):
        """sum over axis -2 of torus ring products."""
        if self.n == 1:
            return jnp.sum(x * y, axis=-2)          # wrapping mul+sum: exact mod 2^64
        if self.n < 64:
            return jnp.sum(tn.naive_mul(x, y), axis=-2)
        return self._contract_crt(x, y)

    def _contract_crt(self, x, y):
        """Fused CRT-NTT contraction: transform once, pointwise-multiply,
        reduce over M in the eval domain, inverse-transform 4 limb outputs."""
        p1, p2 = ntt.CRT_PRIMES[:2]
        xl = tn._split_limbs(x)   # [..., M, 4, n]
        yl = tn._split_limbs(y)
        out_shape = jnp.broadcast_shapes(x.shape[:-2], y.shape[:-2]) + (x.shape[-1],)
        out = jnp.zeros(out_shape, dtype=jnp.uint64)
        m12 = p1 * p2
        p1_inv_p2 = pow(p1, -1, p2)
        ex1 = ntt.ntt(xl % U64(p1), p1)
        ey1 = ntt.ntt(yl % U64(p1), p1)
        ex2 = ntt.ntt(xl % U64(p2), p2)
        ey2 = ntt.ntt(yl % U64(p2), p2)
        for k in range(tn._NUM_LIMBS):
            acc1 = jnp.zeros(out_shape, dtype=jnp.uint64)
            acc2 = jnp.zeros(out_shape, dtype=jnp.uint64)
            for c in range(k + 1):
                d = k - c
                acc1 = acc1 + jnp.sum(
                    modops.mulmod(ex1[..., c, :], ey1[..., d, :], p1), axis=-2)
                acc2 = acc2 + jnp.sum(
                    modops.mulmod(ex2[..., c, :], ey2[..., d, :], p2), axis=-2)
            r1 = ntt.intt(acc1 % U64(p1), p1)
            r2 = ntt.intt(acc2 % U64(p2), p2)
            delta = modops.mulmod(modops.submod(r2, r1 % U64(p2), p2),
                                  U64(p1_inv_p2), p2)
            g_k = r1 + U64(p1) * delta
            g_k = jnp.where(g_k > U64(m12 // 2), g_k - U64(m12 % (1 << 64)), g_k)
            out = out + (g_k << U64(tn._LIMB_BITS * k))
        return out

    # gadget / switching ---------------------------------------------------
    def decompose(self, a, beta: int, l: int):
        return tn.decompose(a, beta, l)

    def mod_switch(self, a, p: int):
        return tn.mod_switch(a, p)

    def mul_div_round(self, a, num: int, den: int):
        return tn.mul_div_round(a, num, den)

    def decode_scale(self, a, t: int):
        return modops.coerce_u64(tn.mul_div_round(a, t, TORUS_Q), t)


def ring_for(param: RingParam):
    """RingParam -> ring object (q == u64::MAX tags the torus, as in the ref)."""
    if param.q == TORUS_Q:
        return TorusRing(param.n)
    return RqRing(param.q, param.n)
