"""TGGSW + TGLev over torus polynomials (reference tfhe/src/tggsw.rs).

    TGLev(a=[..., l, K, N], b=[..., l, N])
    TGGSW(a=[..., K+1, l, K, N], b=[..., K+1, l, N])

The external product TGGSW ⊠ TGLWE is the bootstrapping workhorse: it
decomposes the (K+1) ciphertext polys into l digit-polys each and contracts
the (K+1)·l grid of polynomial products through ONE fused CRT-NTT pipeline
(TorusRing.contract) — digits transform once, key rows were transformable
ahead of time, partial sums reduce in the eval domain.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...arith import tn
from ...arith.ring import TorusRing
from ...ops import modops
from ...utils import prng
from ..gfhe import glwe as G
from ..gfhe.glwe import GLWE, Param
from .tlwe import TORUS_MAX, _tlev_scales

U64 = jnp.uint64


class TGLev(NamedTuple):
    a: jax.Array  # [..., l, K, N]
    b: jax.Array  # [..., l, N]


class TGGSW(NamedTuple):
    a: jax.Array  # [..., K+1, l, K, N]
    b: jax.Array  # [..., K+1, l, N]


# -- TGLev (tggsw.rs:65-128) ------------------------------------------------

def tglev_encode(param: Param, m):
    return jnp.asarray(m, U64)


def tglev_decode(param: Param, p):
    return modops.coerce_u64(p, param.t)


def tglev_encrypt_s(key, param: Param, beta: int, l: int, s, m, batch=()) -> TGLev:
    scales = _tlev_scales(beta, l)                          # [l]
    msgs = jnp.asarray(m, U64)[..., None, :] * scales[:, None]  # [..., l, N]
    ct = G.encrypt_s(key, param, s, msgs, batch=tuple(batch) + (l,))
    return TGLev(a=ct.a, b=ct.b)


def tglev_encrypt(key, param: Param, beta: int, l: int, pk, m, batch=()) -> TGLev:
    scales = _tlev_scales(beta, l)
    msgs = jnp.asarray(m, U64)[..., None, :] * scales[:, None]
    ct = G.encrypt(key, param, pk, msgs, batch=tuple(batch) + (l,))
    return TGLev(a=ct.a, b=ct.b)


def tglev_decrypt(param: Param, s, c: TGLev, beta: int):
    pt = G.decrypt(param, s, GLWE(a=c.a[..., 0, :, :], b=c.b[..., 0, :]))
    return tn.mul_div_round(pt, beta, TORUS_MAX)


def tglev_mul_vec(param: Param, c: TGLev, v) -> GLWE:
    """sum_i TGLWE_i · v_i, v: [..., l, N] (tggsw.rs:139-149)."""
    ring = TorusRing(param.ring.n)
    b = ring.contract(c.b, v)
    a = ring.contract(jnp.moveaxis(c.a, -2, 0), v)
    return GLWE(a=jnp.moveaxis(a, 0, -2), b=b)


# -- TGGSW (tggsw.rs:16-62) -------------------------------------------------

def encrypt_s(key, param: Param, beta: int, l: int, s, m, batch=()) -> TGGSW:
    """Rows j < K encrypt -s_j·m (polynomial product!); row K encrypts m.
    One batched GLWE encryption over the (K+1, l) grid."""
    ring = TorusRing(param.ring.n)
    m = jnp.asarray(m, U64)
    neg_sm = ring.mul(ring.neg(s), m[..., None, :])          # [..., K, N]
    rows = jnp.concatenate([neg_sm, m[..., None, :]], axis=-2)  # [..., K+1, N]
    scales = _tlev_scales(beta, l)
    msgs = rows[..., :, None, :] * scales[:, None]           # [..., K+1, l, N]
    ct = G.encrypt_s(key, param, s, msgs, batch=tuple(batch) + (param.k + 1, l))
    return TGGSW(a=ct.a, b=ct.b)


def decrypt(param: Param, s, c: TGGSW, beta: int):
    return tglev_decrypt(
        param, s, TGLev(a=c.a[..., -1, :, :, :], b=c.b[..., -1, :, :]), beta)


def external_product(param: Param, beta: int, l: int, g: TGGSW, c: GLWE) -> GLWE:
    """TGGSW ⊠ TGLWE (tggsw.rs:45-62): decompose [a | b] -> (K+1, l) digit
    polys, contract against the key grid in one fused reduce."""
    ring = TorusRing(param.ring.n)
    k, n = param.k, param.ring.n
    ab = jnp.concatenate([c.a, c.b[..., None, :]], axis=-2)   # [..., K+1, N]
    d = tn.decompose(ab, beta, l)                             # [l, ..., K+1, N]
    d = jnp.moveaxis(d, 0, -2)                                # [..., K+1, l, N]
    batch = jnp.broadcast_shapes(d.shape[:-3], g.b.shape[:-3])
    M = (k + 1) * l
    d_flat = jnp.broadcast_to(d, batch + d.shape[-3:]).reshape(batch + (M, n))
    gb = jnp.broadcast_to(g.b, batch + g.b.shape[-3:]).reshape(batch + (M, n))
    out_b = ring.contract(gb, d_flat)
    ga = jnp.broadcast_to(g.a, batch + g.a.shape[-4:]).reshape(batch + (M, k, n))
    out_a = ring.contract(jnp.moveaxis(ga, -2, 0), d_flat)    # [k, ..., n]
    return GLWE(a=jnp.moveaxis(out_a, 0, -2), b=out_b)


def cmux(param: Param, beta: int, l: int, bit: TGGSW, c1: GLWE, c2: GLWE) -> GLWE:
    """c1 + bit ⊠ (c2 - c1) (tggsw.rs:39-41)."""
    diff = G.sub(param, c2, c1)
    prod = external_product(param, beta, l, bit, diff)
    return G.add(param, c1, prod)


# ---------------------------------------------------------------------------
# Fast path: TGGSW keys pre-transformed to the CRT-NTT domain.
#
# The generic external product re-transforms the key polynomials at every
# call — prohibitive inside the blind-rotation scan (the key side is ~6x the
# digit side).  Production TFHE keeps bootstrap keys in the Fourier domain;
# the exact-integer analog here: 32-bit key limbs per CRT prime, stored u32.
# Digits are small (< beta ≤ 2^12), so they need only ONE limb, and the
# convolution bound (K+1)·l·n·beta·2^32 stays under the 2-prime CRT capacity.
# ---------------------------------------------------------------------------

class TGGSWEvals(NamedTuple):
    """[..., K+1(row), l, K+1(col), 2(limb), N] u32 per CRT prime, PLAIN
    domain, each with its Harvey/Shoup companion plane floor(w*2^32/p) —
    the external product multiplies them against normal-domain digits with
    one wide-high + two low u32 muls each (cheaper than the former
    Montgomery REDC, which needed two wide muls plus a re-lift)."""
    ev1: jax.Array
    ev2: jax.Array
    ev1s: jax.Array
    ev2s: jax.Array


def precompute_evals(param: Param, g: TGGSW) -> TGGSWEvals:
    """Transform a TGGSW (any leading batch dims) into NTT-domain 32-bit
    limbs under both CRT primes + Shoup planes (one-time u64 math)."""
    from ...ops import ntt as ntt_mod
    p1, p2 = ntt_mod.CRT_PRIMES_TFHE
    ab = jnp.concatenate([g.a, g.b[..., None, :]], axis=-2)  # [..., K+1r, l, K+1c, N]
    lo = ab & U64(0xFFFFFFFF)
    hi = ab >> U64(32)
    limbs = jnp.stack([lo, hi], axis=-2)                     # [..., K+1c, 2, N]
    ev1 = ntt_mod.ntt(limbs % U64(p1), p1)
    ev2 = ntt_mod.ntt(limbs % U64(p2), p2)
    ev1s = ((ev1 << U64(32)) // U64(p1)).astype(jnp.uint32)
    ev2s = ((ev2 << U64(32)) // U64(p2)).astype(jnp.uint32)
    return TGGSWEvals(ev1.astype(jnp.uint32), ev2.astype(jnp.uint32),
                      ev1s, ev2s)


def external_product_evals(param: Param, gev: TGGSWEvals, c: GLWE,
                           beta: int, l: int) -> GLWE:
    """TGGSW ⊠ TGLWE with a pre-transformed key: forward-NTT only the (K+1)·l
    digit polys (single limb), reduce over the grid in the eval domain,
    inverse transforms, exact CRT recombination mod 2^64.

    Both CRT primes ride the MULTI-prime transform path (one kernel launch
    per direction); the eval-domain contraction runs in u32 Montgomery
    against the pre-lifted key evals — no u64 lane emulation in the scan."""
    from ...ops import ntt as ntt_mod
    from ...ops import modops32
    from ...ops.ntt import ntt_multi, intt_multi
    pq = ntt_mod.CRT_PRIMES_TFHE
    p1, p2 = pq
    m12 = p1 * p2
    p1_inv_p2 = pow(p1, -1, p2)
    k, n = param.k, param.ring.n
    # conv bound: (K+1)·l·n·beta·2^32 must stay under p1·p2/2 ≈ 2^58.4
    # (see ntt.CRT_PRIMES_TFHE)
    assert (k + 1) * l * n * beta < (1 << 26), "CRT capacity exceeded"
    ab = jnp.concatenate([c.a, c.b[..., None, :]], axis=-2)   # [..., K+1, N]
    d = tn.decompose(ab, beta, l)                             # [l, ..., K+1, N]
    d = jnp.moveaxis(d, 0, -2)                                # [..., K+1, l, N]

    if beta <= min(pq):
        # digits are UNSIGNED in [0, beta) (tn.decompose) — already reduced
        # mod both primes; the generic u64 `%` would cost an emulated
        # division chain per element for nothing
        d32 = d.astype(jnp.uint32)
        dd = jnp.stack([d32, d32], 0)
    else:
        dd = jnp.stack([d % U64(p1), d % U64(p2)], 0).astype(jnp.uint32)
    ed = ntt_multi(dd, pq)                                    # u32
    ev = jnp.stack([gev.ev1, gev.ev2], 0)                     # [2, r, l, c, 2, N]
    evs = jnp.stack([gev.ev1s, gev.ev2s], 0)                  # shoup planes
    edx = ed[..., :, :, None, None, :]                        # [2, .., r, l, 1, 1, N]
    extra = edx.ndim - ev.ndim          # ciphertext batch dims absent in the key
    if extra > 0:
        ev = ev.reshape(ev.shape[:1] + (1,) * extra + ev.shape[1:])
        evs = evs.reshape(evs.shape[:1] + (1,) * extra + evs.shape[1:])
    qv32, nq32, _ = (jnp.asarray(cst)
                     for cst in modops32.consts(pq, edx.ndim))
    prod = modops32.shoup_mul(edx, ev, evs, qv32)
    # contraction over the (row, level) grid: static small count -> addmod
    # chain (u32 can't hold the raw sum; a chain stays canonical)
    grid = prod.shape[-5] * prod.shape[-4]
    flat = prod.reshape(prod.shape[:-5] + (grid,) + prod.shape[-3:])
    qv32s = jnp.asarray(modops32.consts(pq, edx.ndim - 2)[0])
    s = flat[..., 0, :, :, :]
    for i in range(1, grid):
        s = modops32.addmod(s, flat[..., i, :, :, :], qv32s)
    # s: [2, ..., K+1c, 2limb, N] -> inverse transform both primes at once
    r = intt_multi(s, pq)
    r1 = r[0].astype(U64)
    r2 = r[1].astype(U64)
    r1p2 = jnp.where(r1 >= U64(p2), r1 - U64(p2), r1)         # p1 < 2*p2
    diff12 = jnp.where(r2 >= r1p2, r2 - r1p2, (U64(p2) - r1p2) + r2)
    dm = modops32.mont_mul(diff12.astype(jnp.uint32),
                           jnp.uint32((p1_inv_p2 << 32) % p2),
                           jnp.uint32(p2),
                           jnp.uint32((-pow(p2, -1, 1 << 32)) % (1 << 32)))
    gk = r1 + U64(p1) * dm.astype(U64)                        # in [0, p1*p2)
    gk = jnp.where(gk > U64(m12 // 2), gk - U64(m12 % (1 << 64)), gk)
    out = gk[..., 0, :] + (gk[..., 1, :] << U64(32))          # wrapping
    return GLWE(a=out[..., :k, :], b=out[..., k, :])


def cmux_evals(param: Param, beta: int, l: int, gev: TGGSWEvals,
               c1: GLWE, c2: GLWE) -> GLWE:
    diff = G.sub(param, c2, c1)
    prod = external_product_evals(param, gev, diff, beta, l)
    return G.add(param, c1, prod)
