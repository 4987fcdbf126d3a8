"""Hybrid (P-extended / GHS-style) key switching for the RNS schemes.

The plain RNS-gadget key switch (bfv_rns.ksk_key/key_switch) has noise
~ sqrt(n L) * 2^30 * sigma — fine for BFV's huge Q/t headroom, but it
dominates CKKS rotation error.  The production fix (SEAL/OpenFHE "hybrid"
keyswitching, eprint 2012/099 + RNS refinements): encrypt the key material
scaled by an auxiliary modulus P = prod(p_j), do the digit contraction over
the extended basis Q u P, and divide the result by P with rounding — the
gadget noise shrinks by a factor P (~2^60 with two extension primes),
leaving only the tiny rounding term.

All pieces ride existing machinery: digits of a single-prime residue extend
to other primes by plain Barrett reduction (they are integers < q_i), the
P-division is one centered fast_base_extend + exact scaling, and the
contraction is the same NTT-domain gadget product as relinearization.
"""

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.ntt import (ntt_multi, intt_multi, mulmod_v, _qvec, _addmod_v,
                       _submod_v, barrett_muv, barrett_red)
from ..ops.primes import ntt_primes
from ..utils import prng
from . import bfv_rns
from .bfv_rns import _basis, _bcast_mid, _to_residues, ERR_SIGMA


class HybridKSK(NamedTuple):
    """L gadget rows over the EXTENDED basis Q u P, NTT domain:
    b, a: [L_rows, L+K_primes, ..., N]."""
    b: jax.Array
    a: jax.Array


def ks_ext_primes(param, K: int = 2) -> tuple:
    """K auxiliary primes, disjoint from the scheme's Q (and P, if any)."""
    skip = param.L + getattr(param, "M", 0)
    return ntt_primes(K, param.prime_bits, 1 << 16, skip=skip)


def _centered_coeffs(param, s_evals_q):
    """NTT(s) over Q -> small signed coefficients (|s| <= q0/4 assumed —
    secret keys are binary/ternary)."""
    qs = param.qs
    s_res = intt_multi(s_evals_q[: param.L], qs)
    r0 = s_res[0]
    q0 = qs[0]
    return jnp.where(r0 > jnp.uint64(q0 // 2),
                     r0.astype(jnp.int64) - jnp.int64(q0),
                     r0.astype(jnp.int64))


def _evals_over(param, s_coeffs, primes: tuple):
    return ntt_multi(_to_residues(s_coeffs, primes), primes)


@lru_cache(maxsize=None)
def _hybrid_ksk_jit(param, K: int):
    return jax.jit(
        lambda key, so, sn: _hybrid_ksk_impl(key, param, so, sn, K=K))


def hybrid_ksk(key, param, s_old_evals, s_new_evals, K: int = 2) -> HybridKSK:
    """jit-cached per (param, K): key-set builders call this dozens of
    times; eager per-op dispatch on the CPU backend dominates otherwise."""
    return _hybrid_ksk_jit(param, K)(key, s_old_evals, s_new_evals)


def _hybrid_ksk_impl(key, param, s_old_evals, s_new_evals,
                     K: int = 2) -> HybridKSK:
    """Row i encrypts P * g_i * s_old under s_new over basis Q u P
    (g_i = the RNS gadget of bfv_rns.ksk_key; P*g_i == 0 mod every p_j)."""
    qs = param.qs
    ps = ks_ext_primes(param, K)
    both = qs + ps
    L, n = param.L, param.n
    bq = _basis(qs)
    P = 1
    for p in ps:
        P *= p
    s_old = _centered_coeffs(param, s_old_evals)
    s_new = _centered_coeffs(param, s_new_evals)
    se_old = _evals_over(param, s_old, both)
    se_new = _evals_over(param, s_new, both)
    k_a, k_e = prng.split(key, 2)
    nb = len(both)
    # one sampler op each (vector moduli / one gaussian draw), then batched
    # NTTs with the repeated-primes trick (see hoist_digits) — NOT per-row
    # Python loops: at L~30 limbs those trace thousands of ops per key
    a = jnp.transpose(prng.uniform_mod_multi(k_a, (L, n), both),
                      (1, 0, 2))                   # [L_rows, L+K, n]
    e = jnp.transpose(_to_residues(prng.gaussian_int(k_e, (L, n), ERR_SIGMA),
                                   both), (1, 0, 2))
    bv = _qvec(both, a.ndim - 1)
    mv = barrett_muv(both, a.ndim - 1)
    # msg_i residues: (P * Qhat_i * [Qhat_i^{-1}]_{q_i}) mod q_j ; 0 mod p_j
    g = np.array([[(P * bq.hat[i] * int(bq.hat_inv[i])) % q for q in both]
                  for i in range(L)], np.uint64)
    gv = jnp.asarray(g).reshape((L, nb) + (1,) * (a.ndim - 2))
    ea = jnp.moveaxis(ntt_multi(jnp.moveaxis(a, 1, 0), both), 0, 1)
    as_ = mulmod_v(ea, se_new[None], bv[None], mv[None])
    sg = mulmod_v(se_old[None], gv, bv[None], mv[None])
    ee = jnp.moveaxis(ntt_multi(jnp.moveaxis(e, 1, 0), both), 0, 1)
    b = _submod_v(_addmod_v(sg, ee, bv[None]), as_, bv[None])
    # u32 storage: residues < 2^31 and every consumer (the modops32
    # products) computes in u32 — HALVES the rotation-key-set HBM
    # footprint, the binding constraint on the CKKS-bootstrap ring size
    return HybridKSK(b=b.astype(jnp.uint32), a=ea.astype(jnp.uint32))


def seed_of(key):
    """The a-plane PRNG subkey of the HybridKSK built from `key`.

    `_hybrid_ksk_impl` draws (k_a, k_e) = split(key, 2) and derives the
    uniform mask `a` purely from k_a (threefry: deterministic on every
    backend) — so a packer can drop the stored `a` plane entirely and
    keep only k_a.  Seeded-key compression (the SEAL/OpenFHE trick the
    reference never had): halves key bytes at rest / over the wire."""
    return prng.split(key, 2)[0]


@lru_cache(maxsize=None)
def _expand_a_jit(param, K: int):
    def build(ka):
        qs = param.qs
        ps = ks_ext_primes(param, K)
        both = qs + ps
        L, n = param.L, param.n
        a = jnp.transpose(prng.uniform_mod_multi(ka, (L, n), both),
                          (1, 0, 2))
        ea = jnp.moveaxis(ntt_multi(jnp.moveaxis(a, 1, 0), both), 0, 1)
        return ea.astype(jnp.uint32)
    return jax.jit(build)


def expand_a(param, ka, K: int = 2):
    """Regenerate a HybridKSK's `a` plane (NTT domain, u32 [L, L+K, n])
    bit-exactly from its PRNG subkey (see seed_of).  Runs on the current
    default device — expanding on the device after uploading only the b
    planes halves the host->device transfer of a key set."""
    return _expand_a_jit(param, K)(ka)


def _div_by_P_round(param, acc, ps: tuple):
    """acc: coeff-domain [L+K, ..., n] residues of X over Q u P ->
    round(X / P) over Q (exact: subtract the centered remainder, multiply
    by P^{-1} mod Q)."""
    qs = param.qs
    L = param.L
    P = 1
    for p in ps:
        P *= p
    qv = _qvec(qs, acc.ndim - 0)
    frac = bfv_rns.fast_base_extend(acc[L:], ps, qs, centered=True)
    qv = _qvec(qs, frac.ndim)
    mv = barrett_muv(qs, frac.ndim)
    pinv = jnp.asarray(np.array([pow(P, -1, q) for q in qs], np.uint64)
                       ).reshape(qv.shape)
    return mulmod_v(_submod_v(acc[:L], frac, qv), pinv, qv, mv)


def hoist_digits(param, c1, K: int = 2):
    """The rotation-independent half of a hybrid key switch: extended-basis
    NTT-domain Montgomery digits of c1 ([L_rows, L+K, ..., n] u32).

    phi_g commutes with the digit extraction (it is a ring automorphism mod
    every basis prime, applied to the SAME small integer digit polynomials)
    and acts on the eval domain as a pure permutation (galois.eval_perm) —
    so ONE decomposition+NTT serves every rotation of the same ciphertext
    (the "hoisting" trick, eprint 2018/244 §5)."""
    import os
    K = int(os.environ.get("FHE_HYBRID_K", K))
    qs = param.qs
    L = param.L
    ps = ks_ext_primes(param, K)
    both = qs + ps
    bv = _qvec(both, c1.ndim)
    bmu = barrett_muv(both, c1.ndim)
    # digits: [L_rows, L+K, ..., n]; row i = c1's limb-i residue mod each
    # prime of the extended basis (integers < q_i -> plain reduction)
    d = barrett_red(c1[:, None, ...], bv[None, ...], bmu[None, ...])
    # the forward kernel's epilogue lifts into the Montgomery domain —
    # no separate to_mont pass over the [L, L+K, ..., n] digit grid
    return jnp.moveaxis(ntt_multi(
        jnp.moveaxis(d, 1, 0).astype(jnp.uint32), both, mont=True), 0, 1)


def ks_hoisted(param, hksk: HybridKSK, edm):
    """Gadget contraction + INTT + P-division on hoisted digits.  Returns
    (r0, r1), coeff-domain over Q: the switched encryption of c1*s_old
    (add r0 to c0 to finish a key switch)."""
    qs = param.qs
    K = hksk.b.shape[1] - param.L
    ps = ks_ext_primes(param, K)
    both = qs + ps
    # contraction + both INTTs fuse into one kernel (ops/ntt)
    from ..ops import ntt as ntt_ops
    acc0, acc1 = ntt_ops.ks_contract_multi(edm, hksk.b, hksk.a, both)
    return (_div_by_P_round(param, acc0.astype(jnp.uint64), ps),
            _div_by_P_round(param, acc1.astype(jnp.uint64), ps))


def hybrid_key_switch(param, hksk: HybridKSK, c) -> "bfv_rns.CT":
    """(c0, 0) + round(P^{-1} * sum_i [c1]_{q_i} * KSK_i) — the low-noise
    switch.  c may carry batch axes.

    Single-shot path: digit reduction + forward NTTs + contraction + INTTs
    in one call (ntt.ks_fused_multi).  (Multi-rotation callers hoist instead: hoist_digits once, then
    ks_hoisted per rotation.)"""
    from ..ops import ntt as ntt_ops
    K = hksk.b.shape[1] - param.L
    ps = ks_ext_primes(param, K)
    r0c, r1c = ntt_ops.ks_fused_multi(c.c1, hksk.b, hksk.a,
                                      param.qs + ps, param.qs)
    r0 = _div_by_P_round(param, r0c.astype(jnp.uint64), ps)
    r1 = _div_by_P_round(param, r1c.astype(jnp.uint64), ps)
    qv = _qvec(param.qs, r0.ndim)
    return bfv_rns.CT(_addmod_v(c.c0, r0, qv), r1)


# -- Galois integration ------------------------------------------------------

@lru_cache(maxsize=None)
def _galois_key_jit(param, K: int):
    """ONE compile per (param, K), reused for every rotation index: the
    Galois map rides in as (src, neg) table operands.  Building the full
    C2S/S2C rotation-key set eagerly costs minutes of per-op dispatch on
    the CPU backend (~50 keys x hundreds of tiny XLA calls); jitted, each
    key is one call."""
    from . import galois

    def build(key, s_evals, src, neg):
        qs = param.qs
        s_coeffs_res = intt_multi(s_evals, qs)
        sg = galois.apply_galois_tab(s_coeffs_res, src, neg, qs)
        return hybrid_ksk(key, param, ntt_multi(sg, qs), s_evals, K=K)

    return jax.jit(build)


def galois_key_hybrid(key, param, sk, g: int, K: int = 2) -> HybridKSK:
    """Hybrid Galois key: phi_g(s) -> s with P-suppressed noise.
    FHE_HYBRID_K overrides K globally (noise-vs-cost experiments)."""
    import os
    K = int(os.environ.get("FHE_HYBRID_K", K))
    from . import galois
    src, neg = galois.galois_map(param.n, g)
    return _galois_key_jit(param, K)(
        key, sk.s_evals[: param.L], jnp.asarray(src), jnp.asarray(neg))


def rotate_hybrid(param, hgk: HybridKSK, ct, g: int):
    from . import galois
    qs = param.qs
    c0 = galois.apply_galois(ct.c0, g, qs)
    c1 = galois.apply_galois(ct.c1, g, qs)
    out = hybrid_key_switch(param, hgk, bfv_rns.CT(c0, c1))
    return type(ct)(out.c0, out.c1)


def rotate_hoisted(param, hgk: HybridKSK, ct, g: int, edm):
    """rotate_hybrid against precomputed hoisted digits (hoist_digits of
    ct.c1): the per-rotation forward NTTs collapse to one eval-domain gather.

    The digit representatives differ from rotate_hybrid's (signed-permuted
    vs canonical lifts), so ciphertext bits differ; decryptions agree with
    the same noise bound (|digit| < q_i either way)."""
    from . import galois
    if g == 1:
        return ct
    perm = jnp.asarray(galois.eval_perm(param.n, g))
    r0, r1 = ks_hoisted(param, hgk, jnp.take(edm, perm, axis=-1))
    c0g = galois.apply_galois(ct.c0, g, param.qs)
    qv = _qvec(param.qs, r0.ndim)
    return type(ct)(_addmod_v(c0g, r0, qv), r1)
