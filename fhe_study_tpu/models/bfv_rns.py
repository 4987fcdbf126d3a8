"""RNS-BFV — the production / benchmark BFV variant.

The reference BFV (bfv/src/lib.rs) works over one small modulus with i128
schoolbook arithmetic and a p·q relinearization; it cannot reach production
ring sizes (its own tests stop at n=16, and q=2^16+1 runs out of noise budget
beyond n≈32).  This module is the design the headline benchmark
needs: ciphertext modulus Q = prod(q_i) of ~30-bit NTT primes, all arithmetic
residue-wise (u64 exact), tensor scaling via HPS-style fast base extension
with floating-point sign correction (eprint 2018/117's technique), and
RNS-gadget relinearization (no p·q extension).

Residue layout: every polynomial is [L, ..., N] u64 with the LIMB axis
leading — the natural `ep` sharding axis, and the leading axis of the
MULTI-PRIME NTT (`ops/ntt.py::ntt_multi`), which runs all primes through one
transform (small HLO graphs, one kernel launch per transform on the GPU).

Divergences from the reference (documented, production-motivated):
  * scaling uses floor instead of round-half-away (≤1 ulp noise at Q≈2^240)
  * relinearization = RNS gadget (per-limb digits), not 2021/204's p·q lift
"""

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import modops, ntt
from ..ops.ntt import (ntt_multi, intt_multi, mulmod_v, _qvec, _addmod_v,
                       _submod_v, barrett_muv, barrett_red)
from ..ops.primes import ntt_primes
from ..utils import prng
from ..utils.rounding import round_half_away

ERR_SIGMA = 3.2
U64 = jnp.uint64


@dataclass(frozen=True)
class RnsParam:
    n: int            # ring degree
    t: int            # plaintext modulus
    L: int            # number of Q-basis primes
    M: int            # number of P-basis (extension) primes
    prime_bits: int = 30

    def __post_init__(self):
        assert self.n >= 2 and (self.n & (self.n - 1)) == 0, \
            f"ring degree n={self.n} must be a power of two (X^N+1 ring)"
        assert self.L >= 1 and self.M >= 1 and self.t >= 2, \
            f"need L,M >= 1 and t >= 2 (got L={self.L}, M={self.M}, t={self.t})"

    @property
    def qs(self):
        return ntt_primes(self.L, self.prime_bits, 1 << 16)

    @property
    def ps(self):
        return ntt_primes(self.M, self.prime_bits, 1 << 16, skip=self.L)


class _Basis:
    """Host-precomputed CRT data for one prime basis (numpy only — cached)."""

    def __init__(self, primes):
        self.primes = tuple(primes)
        self.prod = 1
        for p in self.primes:
            self.prod *= p
        self.hat = [self.prod // p for p in self.primes]           # Q̂_i
        self.hat_inv = np.array([pow(h, -1, p) for h, p in
                                 zip(self.hat, self.primes)], np.uint64)
        self.inv_f = np.array([1.0 / p for p in self.primes])
        self.pv = np.array(self.primes, np.uint64)


@lru_cache(maxsize=None)
def _basis(primes: tuple) -> _Basis:
    return _Basis(primes)


@lru_cache(maxsize=None)
def _ext_table(src: tuple, dst: tuple):
    """[Ls, Ld] table (S/s_i) mod d_j, and [Ld] S mod d_j."""
    b = _basis(src)
    tab = np.array([[h % d for d in dst] for h in b.hat], np.uint64)
    smod = np.array([b.prod % d for d in dst], np.uint64)
    return tab, smod


@lru_cache(maxsize=None)
def _hat_inv_mont(src: tuple):
    """[Ls] (Q̂_i^{-1} << 32) mod s_i — Montgomery-lifted (numpy u32)."""
    b = _basis(src)
    return np.array([(int(h) << 32) % p for h, p in
                     zip(b.hat_inv, src)], np.uint32)


def _to_residues(x, primes):
    """int64 [..., n] -> [L, ..., n] residues (vectorized over primes)."""
    x = jnp.asarray(x, jnp.int64)[None, ...]
    pv = jnp.asarray(np.array(primes, np.int64)).reshape((len(primes),) +
                                                         (1,) * (x.ndim - 1))
    return (jnp.mod(jnp.mod(x, pv) + pv, pv)).astype(jnp.uint64)


def fast_base_extend(x, src: tuple, dst: tuple, centered: bool = False):
    """HPS fast base conversion: x [Ls, ..., n] residues -> [Ld, ..., n].

    centered=False: value v interpreted in [0, S)      -> α = floor(Σ y_i/s_i)
    centered=True : value v interpreted in (−S/2, S/2) -> α = round(Σ y_i/s_i)
    (the tensor's negacyclic folds produce SIGNED values; the centered
    interpretation recovers them exactly — BEHZ's signed-representative
    handling, done with f64 correction à la HPS.)

    Exactness analysis (how each caller dodges the f64 α boundary):
      * centered=True (the tensor's r = round(t·w/Q), |r| ≤ t·n·Q/4 + 1):
        the capacity assert in _tensor enforces P > 4·t·n·Q, so |v|/S ≤ 1/16
        and the true Σ y_i/s_i sits ≥ 7/16 away from the round-half
        boundary.  The fixed-point evaluation error is ≤ Ls·2^-28 (see the
        α computation below), so α is DETERMINISTICALLY exact.
        Pinned by test_base_extend_centered_boundary_exact.
      * centered=False on tensor operands (c Q→P): a boundary mis-floor
        shifts the value by +Q; the tensor then differs by Q·(junk), which
        the t/Q scaling turns into a multiple of t — vanishes mod t at
        decryption (eprint 2018/117 §3 makes the same argument).
      * centered=False on w_q (the [w·t]_Q lift): a slip of +Q changes r by
        ±1 — one unit of additive noise, absorbed by the noise budget.

    Accepts u64 or u32 residues; returns the INPUT dtype (the y products run
    in u32 Montgomery either way)."""
    from ..ops import modops32
    b = _basis(src)
    tab, smod = _ext_table(src, dst)
    sv32, snq32, _ = (jnp.asarray(c) for c in modops32.consts(src, x.ndim))
    x32 = x.astype(jnp.uint32)
    him = jnp.asarray(_hat_inv_mont(src)).reshape(sv32.shape)
    ys = modops32.mont_mul(x32, him, sv32, snq32)              # [Ls, ..., n]
    # α = floor/round(Σ y_i/s_i) in 2^59 FIXED POINT (integer, so the
    # result does not depend on float rounding): t_i = y_i·⌊2^59/s_i⌋
    # ≤ 2^59, Σ ≤ Ls·2^59 < 2^64; truncation error ≤ Ls·2^-28 — far
    # inside the exactness margins documented above (centered: 1/16;
    # unsigned: the harmless ±S slip).
    cfix = jnp.asarray(np.array([(1 << 59) // p for p in src], np.uint64)
                       ).reshape(sv32.shape)
    tsum = jnp.sum(ys.astype(jnp.uint64) * cfix, axis=0)       # [..., n]
    half = jnp.uint64(1 << 58) if centered else jnp.uint64(0)
    alpha = ((tsum + half) >> jnp.uint64(59)).astype(jnp.uint32)
    # out_j = Σ_i (y_i · tab[i,j]) − α·S (mod d_j).
    # Accumulate in pairs of raw u64 products (2·2^62 < 2^64) with one
    # Barrett per pair — avoids the full [Ls, Ld, ...] product tensor.
    ys = ys.astype(jnp.uint64)
    alpha = alpha.astype(jnp.uint64)
    dv = _qvec(dst, x.ndim)
    dmu = barrett_muv(dst, x.ndim)
    tabj = jnp.asarray(tab)                                    # [Ls, Ld]
    tabj = tabj.reshape((len(src), len(dst)) + (1,) * (x.ndim - 1))
    Ls = len(src)
    acc = jnp.zeros((len(dst),) + x.shape[1:], jnp.uint64)
    for i0 in range(0, Ls, 2):
        raw = ys[i0][None, ...] * tabj[i0]
        if i0 + 1 < Ls:
            raw = raw + ys[i0 + 1][None, ...] * tabj[i0 + 1]
        acc = acc + barrett_red(raw, dv, dmu)                  # acc < Ls/2·d
    acc = barrett_red(acc, dv, dmu)                            # [Ld, ..., n]
    smodv = jnp.asarray(smod).reshape(dv.shape)
    corr = mulmod_v(alpha[None, ...], smodv, dv, dmu)  # alpha < Ls << d
    return _submod_v(acc, corr, dv).astype(x.dtype)


def _bcast_mid(x, target_ndim: int, lead: int = 1):
    """Insert singleton axes after the first `lead` (limb) axes so an
    unbatched key [L, ..., n] broadcasts against batched ciphertexts
    [L, B..., n] (leading-limb layout breaks right-aligned broadcasting)."""
    extra = target_ndim - x.ndim
    if extra <= 0:
        return x
    return x.reshape(x.shape[:lead] + (1,) * extra + x.shape[lead:])


class SecretKey(NamedTuple):
    s_evals: jax.Array   # [L+M, ..., N] NTT(s) per prime (Q then P basis)


class PublicKey(NamedTuple):
    b: jax.Array  # [L, ..., N]  (-a·s + e)
    a: jax.Array


class RLK(NamedTuple):
    """RNS-gadget relin key, NTT domain: [L_rows, L_primes, ..., N]."""
    b: jax.Array
    a: jax.Array


class CT(NamedTuple):
    c0: jax.Array  # [L, ..., N]
    c1: jax.Array


# -- keys -------------------------------------------------------------------

def _lift(c: CT) -> CT:
    """CTs may carry u32 components (the eval-domain helpers compute in
    u32); lift to u64 for the generic vector-mod helpers."""
    return CT(c.c0.astype(U64), c.c1.astype(U64))


def new_key(key, param: RnsParam, batch=()):
    qs, ps = param.qs, param.ps
    both = qs + ps
    k_s, k_a, k_e = prng.split(key, 3)
    s = prng.binary(k_s, tuple(batch) + (param.n,)).astype(jnp.int64)
    s_evals = ntt_multi(_to_residues(s, both), both)
    a = prng.uniform_mod_multi(k_a, tuple(batch) + (param.n,), qs)
    e_res = _to_residues(prng.gaussian_int(k_e, tuple(batch) + (param.n,),
                                           ERR_SIGMA), qs)
    qv = _qvec(qs, a.ndim)
    mv = barrett_muv(qs, a.ndim)
    ea = ntt_multi(a, qs)
    a_s = intt_multi(mulmod_v(ea, s_evals[: param.L], qv, mv), qs)
    b = _submod_v(e_res, a_s, qv)
    return SecretKey(s_evals), PublicKey(b=b, a=a)


def rlk_key(key, param: RnsParam, sk: SecretKey, batch=()):
    """Row i: (-(a_i·s + e_i) + s^2·g_i, a_i) mod Q, g_i = Q̂_i·[Q̂_i^{-1}]_{q_i}
    the RNS gadget.  All L rows built in one batched pass."""
    qs = param.qs
    L = param.L
    bq = _basis(qs)
    k_a, k_e = prng.split(key, 2)
    shp = tuple(batch) + (param.n,)
    # a: [L_rows, L_primes, batch..., n] — one sampler op (vector moduli),
    # batched NTTs via the repeated-primes trick (no per-row traced loops)
    a = prng.uniform_mod_multi(k_a, (L,) + shp, qs
                               ).transpose((1, 0) + tuple(
                                   range(2, 2 + len(shp))))
    e = jnp.swapaxes(_to_residues(
        prng.gaussian_int(k_e, (L,) + shp, ERR_SIGMA), qs), 0, 1)
    qv = _qvec(qs, a.ndim - 1)
    mv = barrett_muv(qs, a.ndim - 1)
    sq = sk.s_evals[:L]
    s2 = mulmod_v(sq, sq, qv, mv)                              # NTT(s²)
    # gadget residues g_i mod q_j  -> [L_rows, L_primes]
    g = np.array([[ (bq.hat[i] * int(bq.hat_inv[i])) % q for q in qs]
                  for i in range(L)], np.uint64)
    gv = jnp.asarray(g).reshape((L, L) + (1,) * (a.ndim - 2))
    ea = jnp.moveaxis(ntt_multi(jnp.moveaxis(a, 1, 0), qs), 0, 1)
    as_ = mulmod_v(ea, sq[None], qv[None], mv[None])
    s2g = mulmod_v(s2[None], gv, qv[None], mv[None])
    ee = jnp.moveaxis(ntt_multi(jnp.moveaxis(e, 1, 0), qs), 0, 1)
    b = _submod_v(_addmod_v(s2g, ee, qv[None]), as_, qv[None])
    return RLK(b=b, a=ea)


# -- encrypt / decrypt ------------------------------------------------------

def encrypt(key, param: RnsParam, pk: PublicKey, m, batch=()):
    """c = (Δ·m + pk.b·u + e0, pk.a·u + e1), Δ_i = (Q//t) mod q_i."""
    qs = param.qs
    bq = _basis(qs)
    delta = bq.prod // param.t
    k_u, k_e0, k_e1 = prng.split(key, 3)
    u = prng.ternary(k_u, tuple(batch) + (param.n,))
    u_res = _to_residues(u, qs)
    e0 = _to_residues(prng.gaussian_int(k_e0, tuple(batch) + (param.n,),
                                        ERR_SIGMA), qs)
    e1 = _to_residues(prng.gaussian_int(k_e1, tuple(batch) + (param.n,),
                                        ERR_SIGMA), qs)
    qv = _qvec(qs, u_res.ndim)
    mv = barrett_muv(qs, u_res.ndim)
    dm = mulmod_v(_to_residues(jnp.asarray(m, jnp.int64), qs),
                  jnp.asarray(np.array([delta % q for q in qs], np.uint64)
                              ).reshape(qv.shape), qv, mv)
    eu = ntt_multi(u_res, qs)
    epb = _bcast_mid(ntt_multi(pk.b, qs), eu.ndim)
    epa = _bcast_mid(ntt_multi(pk.a, qs), eu.ndim)
    c0 = _addmod_v(_addmod_v(
        intt_multi(mulmod_v(epb, eu, qv, mv), qs), e0, qv), dm, qv)
    c1 = _addmod_v(
        intt_multi(mulmod_v(epa, eu, qv, mv), qs), e1, qv)
    return CT(c0, c1)


def decrypt(param: RnsParam, sk: SecretKey, c: CT):
    """m = round(t·x/Q) mod t via per-limb HPS accumulation (no big ints)."""
    c = _lift(c)
    qs = param.qs
    bq = _basis(qs)
    qv = _qvec(qs, c.c0.ndim)
    mv = barrett_muv(qs, c.c0.ndim)
    se = _bcast_mid(sk.s_evals[: param.L], c.c1.ndim)
    cs = _addmod_v(
        c.c0,
        intt_multi(mulmod_v(ntt_multi(c.c1, qs), se, qv, mv), qs),
        qv)
    ys = mulmod_v(cs, jnp.asarray(bq.hat_inv).reshape(qv.shape), qv, mv)
    wf = jnp.asarray(param.t * bq.inv_f).reshape(qv.shape)
    v = jnp.sum(ys.astype(jnp.float64) * wf, axis=0)
    return modops.coerce_i64(round_half_away(v), param.t)


# -- linear ops -------------------------------------------------------------

def add(param: RnsParam, x: CT, y: CT) -> CT:
    x, y = _lift(x), _lift(y)
    qv = _qvec(param.qs, x.c0.ndim)
    return CT(_addmod_v(x.c0, y.c0, qv), _addmod_v(x.c1, y.c1, qv))


def add_pt(param: RnsParam, x: CT, m) -> CT:
    x = _lift(x)
    qs = param.qs
    delta = _basis(qs).prod // param.t
    qv = _qvec(qs, x.c0.ndim)
    mv = barrett_muv(qs, x.c0.ndim)
    dm = mulmod_v(_to_residues(jnp.asarray(m, jnp.int64), qs),
                  jnp.asarray(np.array([delta % q for q in qs], np.uint64)
                              ).reshape(qv.shape), qv, mv)
    return CT(_addmod_v(x.c0, dm, qv), x.c1)


def mul_pt(param: RnsParam, x: CT, m) -> CT:
    x = _lift(x)
    qs = param.qs
    qv = _qvec(qs, x.c0.ndim)
    mv = barrett_muv(qs, x.c0.ndim)
    em = ntt_multi(_to_residues(jnp.asarray(m, jnp.int64), qs), qs)
    c0 = intt_multi(mulmod_v(ntt_multi(x.c0, qs), em, qv, mv), qs)
    c1 = intt_multi(mulmod_v(ntt_multi(x.c1, qs), em, qv, mv), qs)
    return CT(c0, c1)


# -- multiplication ---------------------------------------------------------

def _check_capacity(param: RnsParam):
    """|t·v| < t·n·Q^2 must fit in QP/2, and |r| < t·n·Q in P/2."""
    q_bits = sum(math.log2(q) for q in param.qs)
    p_bits = sum(math.log2(p) for p in param.ps)
    need_p = math.log2(param.t) + math.log2(param.n) + q_bits + 2
    assert p_bits > need_p and param.t <= (1 << 22), \
        f"P basis too small: {p_bits:.0f} bits, need > {need_p:.0f}"


def _scale_round(param: RnsParam, w_q, w_p):
    """w = t·v over Q and P (u32) -> r = floor(t·v/Q) over Q, as the three
    [L, ..., n] u32 components.

    [w]_Q is the UNSIGNED remainder (w − [w]_Q = Q·floor(w/Q), exact for
    signed w too) -> extend with the [0,Q) interpretation and divide by Q
    over P; r is signed & small -> centered extension back to Q.  All in
    u32 Montgomery (constants pre-lifted host-side)."""
    from ..ops import modops32
    qs, ps = param.qs, param.ps
    Q = _basis(qs).prod
    qinvm = np.array([(pow(Q, -1, p) << 32) % p for p in ps], np.uint32)
    pv32, nq32p, _ = (jnp.asarray(c) for c in modops32.consts(ps, w_q.ndim))
    wq_in_p = fast_base_extend(w_q, qs, ps)
    r_p = modops32.mont_mul(modops32.submod(w_p, wq_in_p, pv32),
                            jnp.asarray(qinvm).reshape(pv32.shape),
                            pv32, nq32p)
    out3 = fast_base_extend(r_p, ps, qs, centered=True)
    return [out3[..., i, :] for i in range(3)]


def _tensor(param: RnsParam, x: CT, y: CT):
    """Degree-2 product over basis Q∪P, then floor(t·v/Q) mapped back to Q.
    The Q and P limb groups stay split end-to-end (a joint [L+M, ...]
    layout would cost two full-array concat copies)."""
    _check_capacity(param)
    qs, ps = param.qs, param.ps
    ops4 = (x.c0, x.c1, y.c0, y.c1)
    # w = t·v comes out of the inverse transforms directly (scale folding);
    # the P half extends the operands Q -> P first
    w_q = ntt.tensor_mul4(*ops4, qs, scale=(param.t,) * len(qs))
    w_p = ntt.tensor_mul4(*ops4, ps, scale=(param.t,) * len(ps), src=qs)
    return _scale_round(param, w_q, w_p)


def relinearize(param: RnsParam, rlk: RLK, c0, c1, c2) -> CT:
    """RNS-gadget relin: digits are c2's own limb residues (broadcast to all
    primes), contracted against the key rows in the NTT domain.

    Accepts u64 or u32 inputs; returns a CT of c0's dtype."""
    qs = param.qs
    assert c2.shape[0] == param.L
    acc0, acc1 = ntt.ks_fused_multi(c2, rlk.b, rlk.a, qs, qs)
    qv = _qvec(qs, acc0.ndim)
    r0 = _addmod_v(c0.astype(U64), acc0.astype(U64), qv)
    r1 = _addmod_v(c1.astype(U64), acc1.astype(U64), qv)
    return CT(r0.astype(c0.dtype), r1.astype(c0.dtype))


def mul(param: RnsParam, rlk, x: CT, y: CT) -> CT:
    """ct x ct multiply; rlk selects the relinearization: RLK = RNS gadget
    (L digit rows), HRLK = 1-row hybrid P-extension (fewer transforms,
    see relinearize_hybrid).  Returns a CT of x's dtype."""
    c0, c1, c2 = _tensor(param, x, y)
    if isinstance(rlk, HRLK):
        out = relinearize_hybrid(param, rlk, c0, c1, c2)
    else:
        out = relinearize(param, rlk, c0, c1, c2)
    return CT(out.c0.astype(x.c0.dtype), out.c1.astype(x.c0.dtype))


# -- eval-resident ciphertexts ------------------------------------------------
#
# The production form of the reference's lazy NTT-evals cache
# (arith/src/ring_nq.rs:19-27): ciphertexts LIVE in the NTT domain over BOTH
# RNS bases between homomorphic ops, so a multiply pays zero forward
# transforms and zero operand extensions — per ct-mul the transform count
# drops from 4L+4M+L^2 fwd + 3L+3M+2L inv (=87 at L=4, M=5) to
# L^2+2L+2M fwd + 3L+3M+2L inv (=69).

class CTE(NamedTuple):
    """Eval-domain resident ciphertext: canonical NTT-domain residues over
    the Q basis ([L, ..., N]) and the P basis ([M, ..., N])."""
    e0q: jax.Array
    e1q: jax.Array
    e0p: jax.Array
    e1p: jax.Array


def to_evals(param: RnsParam, c: CT) -> CTE:
    """CT (coeff domain over Q) -> CTE: forward NTT over Q, then the
    unsigned HPS extension + forward NTT over P."""
    qs, ps = param.qs, param.ps
    c = _lift(c)
    x2 = jnp.stack([c.c0, c.c1], axis=-2)          # [L, ..., 2, n]
    eq = ntt_multi(x2.reshape((param.L, -1, param.n)).astype(jnp.uint32), qs
                   ).reshape(x2.shape)
    ep = ntt.ext_ntt(x2.astype(jnp.uint32), qs, ps)
    return CTE(eq[..., 0, :], eq[..., 1, :], ep[..., 0, :], ep[..., 1, :])


def from_evals(param: RnsParam, ce: CTE) -> CT:
    """CTE -> CT: inverse NTT over the Q basis (P evals are redundant)."""
    qs = param.qs
    x2 = jnp.stack([ce.e0q, ce.e1q], axis=-2)
    r = intt_multi(x2.reshape((param.L, -1, param.n)).astype(jnp.uint32), qs
                   ).reshape(x2.shape)
    return CT(r[..., 0, :].astype(U64), r[..., 1, :].astype(U64))


def add_e(param: RnsParam, x: CTE, y: CTE) -> CTE:
    """Homomorphic add, eval domain (pointwise over both bases)."""
    from ..ops import modops32
    qv, _, _ = (jnp.asarray(c) for c in modops32.consts(param.qs, x.e0q.ndim))
    pv, _, _ = (jnp.asarray(c) for c in modops32.consts(param.ps, x.e0p.ndim))
    a32 = lambda a: a.astype(jnp.uint32)  # noqa: E731
    return CTE(modops32.addmod(a32(x.e0q), a32(y.e0q), qv),
               modops32.addmod(a32(x.e1q), a32(y.e1q), qv),
               modops32.addmod(a32(x.e0p), a32(y.e0p), pv),
               modops32.addmod(a32(x.e1p), a32(y.e1p), pv))


def pt_to_evals(param: RnsParam, m):
    """Plaintext -> Montgomery-domain NTT residues over BOTH bases (Q and
    P) — SEAL's "plaintext in NTT form": precompute once per plaintext
    operand, then every mul_pt_e is one Montgomery product per component
    with ZERO transforms.  (The coefficient-domain mul_pt pays
    5 transforms per call; linear pipelines — encrypted linear layers,
    masks, constants — reuse the same plaintext across many ciphertexts.)"""
    qs, ps = param.qs, param.ps
    mi = jnp.asarray(m, jnp.int64)
    mq = ntt_multi(_to_residues(mi, qs).astype(jnp.uint32), qs, mont=True)
    mp = ntt_multi(_to_residues(mi, ps).astype(jnp.uint32), ps, mont=True)
    return mq, mp


def mul_pt_e(param: RnsParam, x: CTE, em) -> CTE:
    """Ciphertext x plaintext, eval domain: pointwise Montgomery products
    against pt_to_evals output on both bases.  Same products as the
    coefficient-domain mul_pt (glwe.rs:207-280 analog) — identical noise."""
    from ..ops import modops32
    mq, mp = em
    qv, nqv, _ = (jnp.asarray(c) for c in modops32.consts(param.qs,
                                                          x.e0q.ndim))
    pv, npv, _ = (jnp.asarray(c) for c in modops32.consts(param.ps,
                                                          x.e0p.ndim))
    a32 = lambda a: a.astype(jnp.uint32)  # noqa: E731
    return CTE(modops32.mont_mul(a32(x.e0q), mq, qv, nqv),
               modops32.mont_mul(a32(x.e1q), mq, qv, nqv),
               modops32.mont_mul(a32(x.e0p), mp, pv, npv),
               modops32.mont_mul(a32(x.e1p), mp, pv, npv))


def mul_e(param: RnsParam, rlk: RLK, x: CTE, y: CTE) -> CTE:
    """Eval-resident ct x ct multiply + relinearization.  Bit-identical to
    mul(from_evals(x), from_evals(y)) — same products, same HPS scaling,
    same gadget relin — with every transform that the eval residency makes
    redundant removed."""
    _check_capacity(param)
    qs, ps = param.qs, param.ps
    # 1. degree-2 products in the resident eval domain; INTTs fold t·
    w_q = ntt.tensor_eval4(x.e0q, x.e1q, y.e0q, y.e1q, qs,
                           scale=(param.t,) * len(qs))
    w_p = ntt.tensor_eval4(x.e0p, x.e1p, y.e0p, y.e1p, ps,
                           scale=(param.t,) * len(ps))
    # 2. r = floor(t·v/Q) over P, then centered extension back to Q
    c0, c1, c2 = _scale_round(param, w_q, w_p)
    if isinstance(rlk, HRLK):
        # 3'. 1-row hybrid relin (L+K digit transforms instead of L^2):
        # coeff-domain result, then re-enter BOTH eval bases
        r = relinearize_hybrid(param, rlk, c0, c1, c2)
        x2 = jnp.stack([r.c0, r.c1], axis=-2).astype(jnp.uint32)
        eq = ntt_multi(x2.reshape((param.L, -1, param.n)), qs
                       ).reshape(x2.shape)
        ep = ntt.ext_ntt(x2, qs, ps)
        return CTE(eq[..., 0, :], eq[..., 1, :], ep[..., 0, :], ep[..., 1, :])
    # 3. gadget relin emitting the result in BOTH domains (eval Q + coeff Q)
    e0q, e1q, r0, r1 = ntt.ks_fused_eval(c2, rlk.b, rlk.a, qs, qs,
                                         adds=(c0, c1))
    # 4. re-enter the P basis: extend + forward NTT
    ep = ntt.ext_ntt(jnp.stack([r0, r1], axis=-2), qs, ps)
    return CTE(e0q, e1q, ep[..., 0, :], ep[..., 1, :])


# -- hybrid (P-extended) relinearization --------------------------------------
#
# The RNS-gadget relin above burns L^2 digit transforms per multiply (L rows
# x L primes).  The production alternative (same P-extension trick as
# models/hybrid_ks.py, specialized to ONE digit row): the key encrypts
# P*s^2 over the extended basis Q u P_K, the "digit" is c2 itself (extended
# to the K auxiliary primes), and the contraction result is divided by P
# with rounding.  Transform count per mul_e drops 34+35 -> 24+39 fwd+inv
# (L=4, M=5, K=2) and the contraction shrinks from L^2 to L+K pointwise
# rows.  Noise: |c2| <= ~2Q (canonical lift + a harmless extension slip), so
# the relin error is ~ sqrt(n)*Q*sigma/P ~ 2^69 at the headline parameters —
# far below the Q/2t = 2^111 budget, depth >= 3 capable (gadget relin stays
# available for deeper circuits).  Semantic parity: the relinearization of
# reference bfv/src/lib.rs:251-271 (any correct relin qualifies; pinned by
# tests/test_bfv_rns.py depth tests).


class HRLK(NamedTuple):
    """1-row hybrid relin key over basis Q u P_K, NTT domain: [L+K, ..., N]."""
    b: jax.Array
    a: jax.Array


@lru_cache(maxsize=None)
def _hybrid_rlk1_jit(param: "RnsParam", K: int):
    return jax.jit(lambda key, se: _hybrid_rlk1_impl(key, param, se, K=K))


def hybrid_rlk1(key, param: RnsParam, sk: SecretKey, K: int = 2) -> HRLK:
    """Hybrid relin key: encrypts P*s^2 under s over Q u P_K (P = prod of K
    auxiliary primes, disjoint from Q and the tensor's P basis)."""
    return _hybrid_rlk1_jit(param, K)(key, sk.s_evals)


def _hybrid_rlk1_impl(key, param: RnsParam, s_evals, K: int = 2) -> HRLK:
    from . import hybrid_ks as H
    qs = param.qs
    ks = H.ks_ext_primes(param, K)
    both = qs + ks
    P = 1
    for p in ks:
        P *= p
    s = H._centered_coeffs(param, s_evals)          # small signed coeffs
    se = ntt_multi(_to_residues(s, both), both)     # [L+K, n]
    bv = _qvec(both, se.ndim)
    mv = barrett_muv(both, se.ndim)
    s2 = mulmod_v(se, se, bv, mv)                   # NTT(s^2) per prime
    k_a, k_e = prng.split(key, 2)
    a = prng.uniform_mod_multi(k_a, (param.n,), both)
    e = _to_residues(prng.gaussian_int(k_e, (param.n,), ERR_SIGMA), both)
    ea = ntt_multi(a, both)
    ee = ntt_multi(e, both)
    pg = jnp.asarray(np.array([P % p for p in both], np.uint64)
                     ).reshape(bv.shape)            # == 0 on the K primes
    b = _submod_v(_addmod_v(mulmod_v(s2, pg, bv, mv), ee, bv),
                  mulmod_v(ea, se, bv, mv), bv)
    # u32 storage (residues < 2^31; consumers compute in u32 — see
    # hybrid_ks._hybrid_ksk_impl)
    return HRLK(b=b.astype(jnp.uint32), a=ea.astype(jnp.uint32))


def relinearize_hybrid(param: RnsParam, hk: HRLK, c0, c1, c2):
    """(c0 + round(P^-1 * c2 * hk.b), c1 + round(P^-1 * c2 * hk.a)) — the
    1-row hybrid relin.  c2: [L, ..., n] residues over Q (any dtype);
    returns a CT over Q of c0's dtype (the same contract as relinearize).

    The P-division round(acc/P) = (acc_Q − centered-ext(acc_P)) · P^{-1}
    runs in u32 Montgomery."""
    from . import hybrid_ks as H
    from ..ops import modops32
    qs = param.qs
    L = param.L
    K = hk.b.shape[0] - L
    ks = H.ks_ext_primes(param, K)
    both = qs + ks
    P = 1
    for p in ks:
        P *= p
    d = jnp.concatenate([c2.astype(jnp.uint32),
                         fast_base_extend(c2.astype(jnp.uint32), qs, ks)],
                        axis=0)                     # [L+K, ..., n]
    edm = ntt_multi(d, both, mont=True)
    acc0, acc1 = ntt.ks_contract_multi(edm[None], hk.b[None], hk.a[None],
                                       both)
    acc0 = acc0.astype(jnp.uint32)
    acc1 = acc1.astype(jnp.uint32)
    qv32, nq32, _ = (jnp.asarray(c) for c in modops32.consts(qs, acc0.ndim))
    pinvm = jnp.asarray(np.array([(pow(P, -1, q) << 32) % q for q in qs],
                                 np.uint32)).reshape(qv32.shape)

    def add_div(c, acc):
        frac = fast_base_extend(acc[L:], ks, qs, centered=True)
        r = modops32.mont_mul(modops32.submod(acc[:L], frac, qv32),
                              pinvm, qv32, nq32)
        return modops32.addmod(c.astype(jnp.uint32), r, qv32).astype(c0.dtype)
    return CT(add_div(c0, acc0), add_div(c1, acc1))


def ksk_key(key, param: RnsParam, sk_old: SecretKey, sk_new: SecretKey,
            batch=()):
    """Key-switching key: row i encrypts s_old·g_i under s_new (same RNS
    gadget as relinearization — rlk is the special case s_old = s_new²)."""
    qs = param.qs
    L = param.L
    bq = _basis(qs)
    k_a, k_e = prng.split(key, 2)
    a = jnp.stack([
        jnp.stack([prng.uniform_mod(jax.random.fold_in(k_a, i * L + j),
                                    tuple(batch) + (param.n,), q)
                   for j, q in enumerate(qs)], 0)
        for i in range(L)], 0)
    e = jnp.stack([
        _to_residues(prng.gaussian_int(jax.random.fold_in(k_e, i),
                                       tuple(batch) + (param.n,), ERR_SIGMA), qs)
        for i in range(L)], 0)
    qv = _qvec(qs, a.ndim - 1)
    mv = barrett_muv(qs, a.ndim - 1)
    s_new = sk_new.s_evals[:L]
    s_old = sk_old.s_evals[:L]
    g = np.array([[(bq.hat[i] * int(bq.hat_inv[i])) % q for q in qs]
                  for i in range(L)], np.uint64)
    gv = jnp.asarray(g).reshape((L, L) + (1,) * (a.ndim - 2))
    ea = jnp.stack([ntt_multi(a[i], qs) for i in range(L)], 0)
    as_ = mulmod_v(ea, s_new[None], qv[None], mv[None])
    sg = mulmod_v(s_old[None], gv, qv[None], mv[None])
    ee = jnp.stack([ntt_multi(e[i], qs) for i in range(L)], 0)
    b = _submod_v(_addmod_v(sg, ee, qv[None]), as_, qv[None])
    return RLK(b=b, a=ea)


def key_switch(param: RnsParam, ksk: RLK, c: CT) -> CT:
    """(c0, 0) + Σ_i [c1]_{q_i}·KSK_i — moves c under the new key
    (the GLWE key switch of gfhe, in RNS-gadget form)."""
    zero = jnp.zeros_like(c.c1)
    out = relinearize(param, ksk, c.c0, zero, c.c1)
    return CT(out.c0, out.c1)


def noise_budget_bits(param: RnsParam, sk: SecretKey, c: CT, m):
    """log2 of remaining decryption headroom (the FHE health metric;
    generalizes the reference's infinity_norm probe, ring_nq.rs:347-358).

    Measures e = (c0 + c1·s) − Δ·m EXACTLY: the error residues are
    reconstructed by centered 2-limb CRT (valid while |e| < q0·q1/2 ≈ 2^60 —
    far beyond any decryptable noise).  budget = log2(Q/2t) − log2|e|."""
    import math
    c = _lift(c)
    qs = param.qs
    bq = _basis(qs)
    qv = _qvec(qs, c.c0.ndim)
    mv = barrett_muv(qs, c.c0.ndim)
    se = _bcast_mid(sk.s_evals[: param.L], c.c1.ndim)
    cs = _addmod_v(
        c.c0,
        intt_multi(mulmod_v(ntt_multi(c.c1, qs), se, qv, mv), qs), qv)
    delta = bq.prod // param.t
    dm = mulmod_v(_to_residues(jnp.asarray(m, jnp.int64), qs),
                  jnp.asarray(np.array([delta % q for q in qs], np.uint64)
                              ).reshape(qv.shape), qv, mv)
    err = _submod_v(cs, dm, qv)
    q0, q1 = qs[0], qs[1]
    r0, r1 = err[0], err[1]
    d = modops.mulmod(modops.submod(r1, r0 % U64(q1), q1),
                      U64(pow(q0, -1, q1)), q1)
    v = r0 + U64(q0) * d
    m01 = q0 * q1
    mag = jnp.where(v > U64(m01 // 2), U64(m01 % (1 << 64)) - v, v)
    worst = jnp.max(mag, axis=-1).astype(jnp.float64)
    cap = math.log2(bq.prod / (2 * param.t))
    return cap - jnp.log2(jnp.maximum(worst, 1.0))


def mod_switch_drop(param: RnsParam, c: CT):
    """Drop the last Q prime: c' = (c - [c]_{q_last})·q_last^{-1} — the BFV
    modulus-switch noise-management step (returns ct under L-1 primes)."""
    c = _lift(c)
    qs = param.qs
    last = qs[-1]
    rest = qs[:-1]
    qv = _qvec(rest, c.c0.ndim)
    inv = jnp.asarray(np.array([pow(last, -1, q) for q in rest], np.uint64)
                      ).reshape(qv.shape)
    c0 = mulmod_v(_submod_v(c.c0[:-1], c.c0[-1:] % qv, qv), inv, qv)
    c1 = mulmod_v(_submod_v(c.c1[:-1], c.c1[-1:] % qv, qv), inv, qv)
    return CT(c0, c1)
