"""RNS-CKKS: approximate arithmetic over a multi-prime modulus Q = prod(q_i).

The limb-partitioned CKKS pipeline (the ckks bench cell): encode on-device
(split-complex FFT, encoder_device.py), encrypt/add residue-wise over L
~30-bit NTT primes (the leading limb axis shards over the `ep` mesh axis),
decrypt via HPS float accumulation, decode back through the FFT.

Scope note: homomorphic multiply + rescale (level dropping) reuses the
machinery in bfv_rns (`mod_switch_drop` is exactly CKKS rescaling by q_last);
`mul` here composes tensor (without BFV's t/Q scaling) + relinearization and
one rescale — the standard RNS-CKKS multiply.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ...ops import modops
from ...ops.ntt import (ntt_multi, intt_multi, mulmod_v, _qvec, _addmod_v,
                        _submod_v, barrett_muv, tensor_mul4)
from ...ops.primes import ntt_primes
from ...utils import prng
from ..bfv_rns import _to_residues, _bcast_mid
from . import encoder_device

ERR_SIGMA = 3.2
U64 = jnp.uint64


@dataclass(frozen=True)
class Param:
    n: int
    L: int                 # number of RNS primes
    delta: float           # encoding scale
    prime_bits: int = 30

    def __post_init__(self):
        assert self.n >= 4 and (self.n & (self.n - 1)) == 0, \
            f"ring degree n={self.n} must be a power of two (X^N+1 ring)"
        assert self.L >= 1 and self.delta > 0

    @property
    def qs(self):
        return ntt_primes(self.L, self.prime_bits, 1 << 16)


class SecretKey(NamedTuple):
    s_evals: jax.Array     # [L, ..., N]


class PublicKey(NamedTuple):
    b: jax.Array
    a: jax.Array


class CT(NamedTuple):
    c0: jax.Array          # [L, ..., N]
    c1: jax.Array


def new_key(key, param: Param, batch=(), h: int | None = None):
    """h: optional secret Hamming weight (sparse ternary, the CKKS
    bootstrapping convention — see prng.sparse_ternary).  Default: dense
    ternary, matching the reference's round(U[-1,1)) secret."""
    qs = param.qs
    k_s, k_a, k_e = prng.split(key, 3)
    s = (prng.ternary(k_s, tuple(batch) + (param.n,)) if h is None
         else prng.sparse_ternary(k_s, tuple(batch) + (param.n,), h))
    s_evals = ntt_multi(_to_residues(s, qs), qs)
    a = jnp.stack([prng.uniform_mod(jax.random.fold_in(k_a, i),
                                    tuple(batch) + (param.n,), q)
                   for i, q in enumerate(qs)], 0)
    e = _to_residues(prng.gaussian_int(k_e, tuple(batch) + (param.n,),
                                       ERR_SIGMA), qs)
    qv = _qvec(qs, a.ndim)
    mv = barrett_muv(qs, a.ndim)
    a_s = intt_multi(mulmod_v(ntt_multi(a, qs), s_evals, qv, mv), qs)
    return SecretKey(s_evals), PublicKey(b=_submod_v(e, a_s, qv), a=a)


def encode(param: Param, z_re, z_im):
    """[..., N/2] complex slots -> RNS residues [L, ..., N]."""
    m = encoder_device.encode(z_re, z_im, param.n, param.delta)
    return _to_residues(m, param.qs)


def encrypt(key, param: Param, pk: PublicKey, m_res, batch=()):
    qs = param.qs
    k_u, k_e0, k_e1 = prng.split(key, 3)
    u = _to_residues(prng.ternary(k_u, tuple(batch) + (param.n,)), qs)
    e0 = _to_residues(prng.gaussian_int(k_e0, tuple(batch) + (param.n,),
                                        ERR_SIGMA), qs)
    e1 = _to_residues(prng.gaussian_int(k_e1, tuple(batch) + (param.n,),
                                        ERR_SIGMA), qs)
    qv = _qvec(qs, u.ndim)
    mv = barrett_muv(qs, u.ndim)
    eu = ntt_multi(u, qs)
    epb = _bcast_mid(ntt_multi(pk.b, qs), eu.ndim)
    epa = _bcast_mid(ntt_multi(pk.a, qs), eu.ndim)
    c0 = _addmod_v(_addmod_v(
        intt_multi(mulmod_v(epb, eu, qv, mv), qs), e0, qv), m_res, qv)
    c1 = _addmod_v(intt_multi(mulmod_v(epa, eu, qv, mv), qs), e1, qv)
    return CT(c0, c1)


def add(param: Param, x: CT, y: CT) -> CT:
    qv = _qvec(param.qs, x.c0.ndim)
    return CT(_addmod_v(x.c0, y.c0, qv), _addmod_v(x.c1, y.c1, qv))


def sub(param: Param, x: CT, y: CT) -> CT:
    qv = _qvec(param.qs, x.c0.ndim)
    return CT(_submod_v(x.c0, y.c0, qv), _submod_v(x.c1, y.c1, qv))


def mul_pt(param: Param, x: CT, m_res) -> CT:
    """Slot-wise ciphertext x plaintext product (NTT pointwise, u32
    Montgomery).  m_res: encoded residues [L, ..., N] (delta-scaled) —
    the result carries scale delta^2; rescale with bfv_rns.mod_switch_drop."""
    from ...ops import modops32
    qs = param.qs
    qv32, nqv32, r2v32 = (jnp.asarray(c_)
                          for c_ in modops32.consts(qs, x.c0.ndim))
    from .. import bfv_rns
    m32 = bfv_rns._bcast_mid(jnp.asarray(m_res).astype(jnp.uint32),
                             x.c0.ndim)      # [L, n] pt vs batched ct
    em = modops32.to_mont(ntt_multi(m32, qs), qv32, nqv32, r2v32)
    c0 = intt_multi(modops32.mont_mul(
        ntt_multi(x.c0.astype(jnp.uint32), qs), em, qv32, nqv32), qs)
    c1 = intt_multi(modops32.mont_mul(
        ntt_multi(x.c1.astype(jnp.uint32), qs), em, qv32, nqv32), qs)
    return CT(c0.astype(U64), c1.astype(U64))


def rescale(param: Param, x: CT):
    """Drop the last prime: scale delta -> delta / q_last; returns
    (ct', param') with L-1 limbs (the standard CKKS level drop)."""
    from .. import bfv_rns
    bp = _bfv_param(param)
    out = bfv_rns.mod_switch_drop(bp, bfv_rns.CT(x.c0, x.c1))
    new_param = Param(n=param.n, L=param.L - 1,
                      delta=param.delta / param.qs[-1] * 1.0,
                      prime_bits=param.prime_bits)
    return CT(out.c0, out.c1), new_param


def decrypt_to_coeffs(param: Param, sk: SecretKey, c: CT,
                      crt_limbs: int | None = None):
    """c0 + c1·s -> centered f64 coefficients.

    The decrypted phase Δ·z + e is tiny relative to Q, so it is recovered
    from the first few limbs only.  crt_limbs=2 (the default up to
    Δ ≤ 2^40): exact centered 2-prime CRT, valid while |phase| < q0·q1/2
    ≈ 2^60.  crt_limbs=3 (auto for the double-prime scales of the
    high-precision pipeline, Δ ≈ q_i·q_j ≈ 2^60): centered mixed-radix
    (Garner) digits summed in f64 — only the TOP digit is centered, so
    every term stays ≈ |phase| and the f64 error is ~2^-53 RELATIVE, not
    2^-53 of q0·q1·q2."""
    qs = param.qs
    if crt_limbs is None:
        crt_limbs = 2 if param.delta <= 2.0 ** 40 else 3
    qv = _qvec(qs, c.c0.ndim)
    mv = barrett_muv(qs, c.c0.ndim)
    # slice the key to the ciphertext's limb count (rescaled cts are shorter)
    se = _bcast_mid(sk.s_evals[: c.c0.shape[0]], c.c1.ndim)
    cs = _addmod_v(
        c.c0, intt_multi(mulmod_v(ntt_multi(c.c1, qs), se, qv, mv), qs), qv)
    if crt_limbs == 2:
        q0, q1 = qs[0], qs[1]
        r0, r1 = cs[0], cs[1]
        q0_inv_q1 = pow(q0, -1, q1)
        d = modops.mulmod(modops.submod(r1, r0 % U64(q1), q1),
                          U64(q0_inv_q1), q1)
        v = r0 + U64(q0) * d                    # in [0, q0*q1)
        m01 = q0 * q1
        sv = jnp.where(v > U64(m01 // 2),
                       -((U64(m01 % (1 << 64)) - v).astype(jnp.float64)),
                       v.astype(jnp.float64))
        return sv
    assert crt_limbs == 3 and c.c0.shape[0] >= 3, (crt_limbs, c.c0.shape)
    q0, q1, q2 = qs[0], qs[1], qs[2]
    r0, r1, r2 = cs[0], cs[1], cs[2]
    # Garner digits: v = r0 + q0·d1 + q0·q1·d2, each digit < its prime
    d1 = modops.mulmod(modops.submod(r1, r0 % U64(q1), q1),
                       U64(pow(q0, -1, q1)), q1)
    v01_q2 = modops.addmod(r0 % U64(q2),
                           modops.mulmod(d1 % U64(q2), U64(q0 % q2), q2), q2)
    d2 = modops.mulmod(modops.submod(r2, v01_q2, q2),
                       U64(pow(q0 * q1, -1, q2)), q2)
    # center the top digit: |phase| << q0·q1·q2/2 means d2 is ±small
    c2 = jnp.where(d2 > U64(q2 // 2),
                   -((U64(q2) - d2).astype(jnp.float64)),
                   d2.astype(jnp.float64))
    return (r0.astype(jnp.float64)
            + float(q0) * d1.astype(jnp.float64)
            + float(q0 * q1) * c2)


def decode(param: Param, coeffs_f64):
    return encoder_device.decode(coeffs_f64, param.n, param.delta)


# -- hybrid (P-extended) multiply: the low-noise production path ------------

def hybrid_rlk(key, param: Param, sk: SecretKey, K: int = 2):
    import os
    K = int(os.environ.get("FHE_HYBRID_K", K))
    """P-extended relinearization key: encrypts P*g_i*s^2 under s.  Noise
    after the switch is ~1 unit (vs ~2^36 for the plain RNS gadget at
    30-bit primes) — required for chained multiplications at delta ~ 2^30."""
    from .. import hybrid_ks
    qs = param.qs
    qv = _qvec(qs, sk.s_evals.ndim)
    mv = barrett_muv(qs, sk.s_evals.ndim)
    s2 = mulmod_v(sk.s_evals[: param.L], sk.s_evals[: param.L], qv, mv)
    return hybrid_ks.hybrid_ksk(key, param, s2, sk.s_evals[: param.L], K=K)


def mul_hybrid(param: Param, hrlk, x: CT, y: CT):
    """(x (x) y) -> hybrid relinearize -> rescale.  Returns (ct', param')
    with L-1 limbs and scale delta^2 / q_last."""
    from .. import hybrid_ks
    qs = param.qs
    d = tensor_mul4(x.c0, x.c1, y.c0, y.c1, qs)
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    sw = hybrid_ks.hybrid_key_switch(
        param, hrlk, CT(d0.astype(U64), d2.astype(U64)))
    qv = _qvec(qs, d1.ndim)
    ct = CT(sw.c0, _addmod_v(sw.c1, d1.astype(U64), qv))
    from .. import bfv_rns
    bp = _bfv_param(param)
    out = bfv_rns.mod_switch_drop(bp, bfv_rns.CT(ct.c0, ct.c1))
    new_param = Param(n=param.n, L=param.L - 1,
                      delta=param.delta * param.delta / qs[-1],
                      prime_bits=param.prime_bits)
    return CT(out.c0, out.c1), new_param


# -- double-prime scale: the high-precision pipeline ------------------------
#
# With u32-sized primes (q_i < 2^31) a single-prime scale caps delta at
# ~2^30 (slot precision ~2^-24 after noise).  Setting delta ~= q_i·q_j
# ~= 2^60 and rescaling by TWO primes per multiply keeps the scale
# stationary and lifts slot precision to ~2^-48: encode still fits (f64
# mantissa quantizes the 2^60-scaled coefficients to multiples of 2^7 —
# a 2^-53 relative error — and int64 residue conversion holds to 2^62);
# decrypt recovers the phase by centered 3-limb Garner CRT.  Relin noise
# must be ~1 unit for the precision to survive, so the multiply is the
# hybrid (P-extended) switch — the plain RNS gadget's ~2^36 noise would
# cap precision at ~2^-24 again.


def delta2(param_or_qs, L: int | None = None) -> float:
    """The stationary double-prime scale q_{L-1}·q_{L-2} (as f64)."""
    qs = param_or_qs.qs if hasattr(param_or_qs, "qs") else param_or_qs
    L = len(qs) if L is None else L
    return float(qs[L - 1]) * float(qs[L - 2])


def rescale2(param: Param, x: CT):
    """Drop the last TWO primes: delta -> delta/(q_{L-1}·q_{L-2})."""
    ct, p1 = rescale(param, x)
    return rescale(p1, ct)


def mul_hybrid2(param: Param, hrlk, x: CT, y: CT):
    """(x (x) y) -> hybrid relinearize -> rescale by TWO primes.  Returns
    (ct', param') with L-2 limbs and scale delta^2/(q_{L-1}·q_{L-2}) —
    stationary at delta ~= 2^60 with ~30-bit primes."""
    from .. import hybrid_ks
    qs = param.qs
    d = tensor_mul4(x.c0, x.c1, y.c0, y.c1, qs)
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    sw = hybrid_ks.hybrid_key_switch(
        param, hrlk, CT(d0.astype(U64), d2.astype(U64)))
    qv = _qvec(qs, d1.ndim)
    p_sq = Param(n=param.n, L=param.L, delta=param.delta * param.delta,
                 prime_bits=param.prime_bits)   # tensor carries delta^2
    return rescale2(p_sq, CT(sw.c0, _addmod_v(sw.c1, d1.astype(U64), qv)))


# -- multiply + rescale (the standard RNS-CKKS pipeline) --------------------

def _bfv_param(param: Param):
    from ..bfv_rns import RnsParam
    # same prime sequence; t unused by relin/mod-switch machinery
    return RnsParam(n=param.n, t=2, L=param.L, M=1,
                    prime_bits=param.prime_bits)


def rlk_key(key, param: Param, sk: SecretKey, batch=()):
    """RNS-gadget relinearization key (shared machinery with RNS-BFV)."""
    from .. import bfv_rns
    return bfv_rns.rlk_key(key, _bfv_param(param), sk, batch=batch)


def mul(param: Param, rlk, x: CT, y: CT):
    """(x ⊗ y) -> relinearize -> rescale by q_last.

    Returns (ct', param') where param' has L-1 limbs and scale delta^2/q_last
    — the standard CKKS level drop.  No base extension is needed: CKKS
    multiplies mod Q directly and divides by ONE prime."""
    from .. import bfv_rns
    qs = param.qs
    d = tensor_mul4(x.c0, x.c1, y.c0, y.c1, qs)
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    bp = _bfv_param(param)
    ct = bfv_rns.relinearize(bp, rlk, d0, d1, d2)
    ct = bfv_rns.mod_switch_drop(bp, bfv_rns.CT(ct.c0, ct.c1))
    new_param = Param(n=param.n, L=param.L - 1,
                      delta=param.delta * param.delta / qs[-1],
                      prime_bits=param.prime_bits)
    return CT(ct.c0, ct.c1), new_param
