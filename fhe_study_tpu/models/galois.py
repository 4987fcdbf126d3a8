"""Galois automorphisms + rotation keys for the RNS schemes.

The reference library's homomorphic API stops at add/mul (README.md:62-72);
it has no automorphism support.  Slot rotations are the standard production
extension (SEAL / OpenFHE "Galois keys"), and they fall out of machinery this
framework already has: the automorphism x(X) -> x(X^g) is a static gather
with a sign mask (a static permutation), and switching the rotated ciphertext
back to the original key is exactly the RNS-gadget key switch used for
relinearization (bfv_rns.ksk_key / relinearize).

Math: for odd g coprime to 2n, phi_g(m)(X) = m(X^g) mod (X^n + 1) permutes
the 2n-th-root evaluation points zeta^e -> zeta^{g e}; applying phi_g to both
ciphertext components of an RLWE pair gives an encryption of phi_g(m) under
phi_g(s), and a key switch with a key encrypting phi_g(s) under s completes
the rotation.  Works identically for RNS-BFV and RNS-CKKS (both are RLWE
pairs over the same limb layout).
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from ..ops.ntt import (ntt_multi, intt_multi, _qvec)
from . import bfv_rns


@lru_cache(maxsize=None)
def galois_map(n: int, g: int):
    """Gather map for phi_g over Z[X]/(X^n+1): out[j] = sign[j] * in[src[j]].

    Coefficient i of the input lands at X^{i*g mod 2n}; exponents >= n fold
    negacyclically to (e - n, negated).  g must be odd (coprime to 2n), which
    makes i -> (i*g mod 2n) mod n a bijection on [0, n)."""
    assert g % 2 == 1, "Galois element must be odd (coprime to 2n)"
    g = g % (2 * n)
    ginv = pow(g, -1, 2 * n)
    j = np.arange(n)
    i0 = (j * ginv) % (2 * n)
    neg = i0 >= n
    src = np.where(neg, i0 - n, i0).astype(np.int32)
    return src, neg


def _np_ntt_ref(x, plan):
    """Numpy mirror of ops.ntt.ntt's butterfly (host-side precompute only;
    cross-checked by tests/test_galois.py)."""
    q = plan.q
    n = plan.n
    r = x.astype(object).copy()          # python ints: exact mod-q products
    roots = plan.roots
    t, m = n // 2, 1
    while m < n:
        r = r.reshape(-1, m, 2, t)
        u = r[:, :, 0, :]
        s = roots[m:2 * m].astype(object)
        v = (r[:, :, 1, :] * s[None, :, None]) % q
        r = np.stack([(u + v) % q, (u - v) % q], axis=2)
        t //= 2
        m *= 2
    return r.reshape(n)


@lru_cache(maxsize=None)
def _eval_exponents(n: int):
    """e_j (odd, mod 2n) with NTT(x)[j] = x(w^{e_j}) for the library's root
    ordering.  Prime-independent: every NttPlan uses the same bit-reversed
    exponent schedule (ops/ntt.py:60-68); computed by discrete-logging the
    transform of the monomial X on one small plan."""
    from ..ops.ntt import get_plan
    from ..ops.primes import ntt_primes
    q = ntt_primes(1, 30, 2 * n)[0]
    plan = get_plan(q, n)
    x = np.zeros(n, np.uint64)
    x[1] = 1
    v = _np_ntt_ref(x, plan)
    dlog = {pow(plan.root, k, q): k for k in range(2 * n)}
    return np.array([dlog[int(vj)] for vj in v], np.int64)


@lru_cache(maxsize=None)
def eval_perm(n: int, g: int):
    """pi (int32 [n]) with NTT(phi_g(x)) = NTT(x)[pi] — phi_g is a PURE
    permutation in the evaluation domain (x(w^e) -> x(w^{g e}); the odd
    exponents mod 2n are closed under multiplication by odd g)."""
    e = _eval_exponents(n)
    pos = {int(ej): j for j, ej in enumerate(e)}
    return np.array([pos[(g * int(ej)) % (2 * n)] for ej in e], np.int32)


def apply_galois(x, g: int, qs: tuple):
    """phi_g on residue arrays [L, ..., n] (mod q_i per limb)."""
    n = x.shape[-1]
    src, neg = galois_map(n, g)
    qv = _qvec(qs, x.ndim)
    y = jnp.take(x, jnp.asarray(src), axis=-1)
    negm = jnp.asarray(neg)
    return jnp.where(negm, jnp.where(y == 0, y, qv - y), y)


def apply_galois_tab(x, src, neg, qs: tuple):
    """phi on residue arrays [L, ..., n] with table OPERANDS (src [n] i32,
    neg [n] bool) instead of a static g — the lax.scan-body variant of
    apply_galois (per-step tables ride the scan xs)."""
    qv = _qvec(qs, x.ndim)
    y = jnp.take(x, src, axis=-1)
    return jnp.where(neg, jnp.where(y == 0, y, qv - y), y)


def apply_galois_i64(x, g: int):
    """phi_g on signed integer coefficient arrays [..., n] (plaintext side)."""
    n = x.shape[-1]
    src, neg = galois_map(n, g)
    y = jnp.take(jnp.asarray(x, jnp.int64), jnp.asarray(src), axis=-1)
    return jnp.where(jnp.asarray(neg), -y, y)


def galois_key(key, param, sk, g: int):
    """Key-switching key phi_g(s) -> s (a "Galois key", SEAL terminology).

    `param` needs .qs/.L/.n (bfv_rns.RnsParam and ckks_rns.Param both fit);
    `sk` needs .s_evals [>=L, ..., n]."""
    qs = param.qs
    L = param.L
    s_coeffs = intt_multi(sk.s_evals[:L], qs)
    sg = apply_galois(s_coeffs, g, qs)
    sk_g = bfv_rns.SecretKey(ntt_multi(sg, qs))
    return bfv_rns.ksk_key(key, param, sk_old=sk_g,
                           sk_new=bfv_rns.SecretKey(sk.s_evals[:L]))


def apply_to_ct(param, gk, ct, g: int):
    """Rotate a ciphertext: phi_g on both components, then key switch back
    under the original key.  Returns the same CT type as the input."""
    qs = param.qs
    c0 = apply_galois(ct.c0, g, qs)
    c1 = apply_galois(ct.c1, g, qs)
    out = bfv_rns.key_switch(param, gk, bfv_rns.CT(c0, c1))
    return type(ct)(out.c0, out.c1)


def conj_element(n: int) -> int:
    """g = 2n - 1: complex conjugation (CKKS) / row swap (BFV batching)."""
    return 2 * n - 1


def rotation_element(n: int, k: int) -> int:
    """g = 5^k mod 2n: rotation by k slots in the orbit-of-5 slot order."""
    return pow(5, k % (n // 2), 2 * n)


@lru_cache(maxsize=None)
def ckks_slot_perm(n: int, g: int):
    """Effect of phi_g on the device encoder's natural slot order
    (encoder_device: slot j = m(zeta^{2j+1}), zeta = e^{i pi/n}).

    Returns (perm [n/2] int32, conj [n/2] bool):
      decode(phi_g(ct))[j] = conj?(decode(ct)[perm[j]])
    (m has real coefficients, so the value at zeta^{-e} is the conjugate of
    the value at zeta^{e})."""
    half = n // 2
    perm = np.zeros(half, np.int32)
    conj = np.zeros(half, bool)
    for j in range(half):
        e = (g * (2 * j + 1)) % (2 * n)
        if e < n:
            perm[j] = (e - 1) // 2
        else:
            perm[j] = (2 * n - e - 1) // 2
            conj[j] = True
    return perm, conj


class GaloisKeys:
    """A keyring of Galois keys indexed by group element g, with the usual
    power-of-two generating set so any rotation needs <= log2(n/2) hops."""

    def __init__(self, keys: dict):
        self.keys = dict(keys)

    @classmethod
    def for_rotations(cls, key, param, sk, steps=None, conj: bool = False):
        """Build keys for the given rotation steps (default: +/- powers of
        two — enough to compose any rotation)."""
        import jax
        n = param.n
        if steps is None:
            steps = []
            p = 1
            while p < n // 2:
                steps += [p, -p]
                p *= 2
        gs = sorted({rotation_element(n, k) for k in steps}
                    | ({conj_element(n)} if conj else set()))
        keys = {}
        for i, g in enumerate(gs):
            keys[g] = galois_key(jax.random.fold_in(key, i), param, sk, g)
        return cls(keys)

    def rotate(self, param, ct, k: int):
        """Rotate by k slots, composing power-of-two hops as needed."""
        n = param.n
        k = k % (n // 2)
        if k == 0:
            return ct
        g = rotation_element(n, k)
        if g in self.keys:
            return apply_to_ct(param, self.keys[g], ct, g)
        out = ct
        p, rem = 1, k
        while rem:
            if rem & 1:
                g = rotation_element(n, p)
                assert g in self.keys, f"missing Galois key for step {p}"
                out = apply_to_ct(param, self.keys[g], out, g)
            rem >>= 1
            p *= 2
        return out

    def conjugate(self, param, ct):
        g = conj_element(param.n)
        assert g in self.keys, "keyring built without conj=True"
        return apply_to_ct(param, self.keys[g], ct, g)
