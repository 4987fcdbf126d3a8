"""Negacyclic NTT / INTT (Cooley-Tukey DIT forward, Gentleman-Sande inverse).

Vectorized re-design of the reference NTT (reference arith/src/ntt.rs):

  * the per-(q, n) root tables are computed host-side with Python big ints and
    cached (functional analog of the reference's OnceLock cache, ntt.rs:16-38);
    they are stored bit-reversed exactly as the reference does (ntt.rs:133-147)
    so that the butterfly schedule — and hence every intermediate value — is
    bit-exact with the reference.
  * the log2(n) butterfly stages are expressed as reshape + broadcast
    elementwise ops over the whole (batched) coefficient array: no scalar
    loops, no gathers.  Lowered for CUDA, the multi-prime transforms run
    the fused kernel of ops/ntt_kernel.cu instead (`_transform`), which
    computes the same values.
  * arbitrary leading batch dimensions are supported; the transform applies to
    the last axis.

Requires q prime with q ≡ 1 (mod 2n).
"""

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from . import modops, ntt_cuda

U64 = jnp.uint64


def _pow_mod(x: int, k: int, q: int) -> int:
    return pow(x, k, q)


def _primitive_root_of_unity(q: int, m: int) -> int:
    """Smallest-k primitive m-th root of unity by Pornin's method
    (reference ntt.rs:115-131): w = k^((q-1)/m); accept if w^(m/2) != 1."""
    assert (q - 1) % m == 0, f"q={q} is not NTT-friendly for m={m}"
    for k in range(1, q):
        w = _pow_mod(k, (q - 1) // m, q)
        if _pow_mod(w, m // 2, q) != 1:
            return w
    raise ValueError("no primitive root of unity")


def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


class NttPlan:
    """Precomputed tables for a negacyclic NTT over Z_q[X]/(X^n+1)."""

    def __init__(self, q: int, n: int):
        assert n & (n - 1) == 0, "n must be a power of two"
        self.q = q
        self.n = n
        self.log_n = n.bit_length() - 1
        w = _primitive_root_of_unity(q, 2 * n)  # 2n-th root -> negacyclic
        logn = self.log_n
        roots = [_pow_mod(w, _bit_reverse(i, logn), q) for i in range(n)]
        roots_inv = [pow(r, q - 2, q) for r in roots]
        self.root = w
        # plain numpy (NOT jnp): plans are lru_cached and may be constructed
        # inside a trace — jnp values would cache leaked tracers
        self.roots = np.array(roots, dtype=np.uint64)
        self.roots_inv = np.array(roots_inv, dtype=np.uint64)
        self.n_inv = pow(n, q - 2, q)


@lru_cache(maxsize=None)
def get_plan(q: int, n: int) -> NttPlan:
    return NttPlan(q, n)


def ntt(a, q: int):
    """Forward negacyclic NTT over the last axis. a: u64 [..., n] in [0, q)."""
    n = a.shape[-1]
    if n == 1:
        return a
    if q < (1 << 31):
        return ntt_multi(a[None], (q,))[0]
    plan = get_plan(q, n)
    batch = a.shape[:-1]
    r = a
    t, m = n // 2, 1
    while m < n:
        # group layout (reference ntt.rs:48-65): m groups of 2t lanes
        r = r.reshape(batch + (m, 2, t))
        u = r[..., 0, :]
        s = plan.roots[m:2 * m]                      # [m]
        v = modops.mulmod(r[..., 1, :], s[:, None], q)
        r = jnp.stack([modops.addmod(u, v, q), modops.submod(u, v, q)], axis=-2)
        t //= 2
        m *= 2
    return r.reshape(batch + (n,))


def intt(a, q: int):
    """Inverse negacyclic NTT (GS) over the last axis, with final n^-1 scale."""
    n = a.shape[-1]
    if n == 1:
        return a
    if q < (1 << 31):
        return intt_multi(a[None], (q,))[0]
    plan = get_plan(q, n)
    batch = a.shape[:-1]
    r = a
    t, m = 1, n // 2
    while m > 0:
        r = r.reshape(batch + (m, 2, t))
        u = r[..., 0, :]
        v = r[..., 1, :]
        s = plan.roots_inv[m:2 * m]
        r = jnp.stack(
            [modops.addmod(u, v, q), modops.mulmod(modops.submod(u, v, q), s[:, None], q)],
            axis=-2)
        t *= 2
        m //= 2
    r = r.reshape(batch + (n,))
    return modops.mulmod(r, U64(plan.n_inv), q)


def negacyclic_mul(a, b, q: int):
    """Polynomial product in Z_q[X]/(X^n+1) via NTT∘pointwise∘INTT."""
    ea = ntt(a, q)
    eb = ntt(b, q)
    return intt(modops.mulmod(ea, eb, q), q)


# ---------------------------------------------------------------------------
# Multi-modulus NTT: all RNS primes in ONE pass (vector modulus broadcast).
# Collapses the per-prime Python loops of the RNS schemes into a single
# stage chain — ~L× smaller HLO graphs and bigger elementwise ops.
# Requires every prime < 2^32 (u64 products exact).
# ---------------------------------------------------------------------------

# id-keyed interning of CACHED numpy tables as device constants: a fresh
# jnp.asarray(table) per call site becomes a SEPARATE constant in the
# lowered module; at production shapes the twiddle tables are multi-MB and
# a staged bootstrap graph holds dozens of call sites, so interning keeps
# one copy per table in each module.  Feed it only lru-cached numpy arrays
# (stable object ids); the jax value is uncommitted, so it follows the
# computation to any device.
_DEV_INTERN: dict = {}


def _dev(x):
    ent = _DEV_INTERN.get(id(x))
    if ent is None or ent[0] is not x:
        # ensure_compile_time_eval: inside a jit trace a bare asarray stages
        # the constant as a TRACER — caching that leaks it (the CLAUDE.md
        # "builders must return numpy" rule); this forces a concrete array
        with jax.ensure_compile_time_eval():
            ent = (x, jnp.asarray(x))
        _DEV_INTERN[id(x)] = ent
    return ent[1]


def _qvec(qs, ndim):
    return jnp.asarray(np.array(qs, np.uint64)).reshape((len(qs),) + (1,) * (ndim - 1))


def _addmod_v(a, b, qv):
    s = a + b
    return jnp.where(s >= qv, s - qv, s)


def _submod_v(a, b, qv):
    return jnp.where(a >= b, a - b, (qv - b) + a)


def mulmod_v(a, b, qv, muv=None):
    """(a*b) mod broadcastable modulus array; operands' product must be <2^64.

    With muv = floor(2^62/q) per prime (see barrett_mu), uses Barrett
    reduction: 2 u64 multiplies + shifts + a few conditional subtracts —
    far cheaper than XLA's generic 64-bit division, and valid whenever
    a, b < q < 2^31 (all RNS primes)."""
    t = a * b
    if muv is None:
        return t % qv
    return barrett_red(t, qv, muv)


def barrett_red(t, qv, muv):
    """t mod q for t < 2^62, q < 2^31, muv = floor(2^62/q)."""
    qhat = ((t >> jnp.uint64(31)) * muv) >> jnp.uint64(31)
    r = t - qhat * qv
    for _ in range(4):   # Barrett quotient undershoots by < 5 at 30-bit q
        r = jnp.where(r >= qv, r - qv, r)
    return r


def barrett_ok(qs: tuple) -> bool:
    """Whether barrett_red's four corrections suffice for these primes: its
    quotient undershoots by less than 1 + q_max^2/2^62 + 2^31/q_min (true
    for the ~2^30 RNS primes; small test primes take the `%` path)."""
    return max(qs) < (1 << 31) and \
        1 + max(qs) ** 2 / 2.0 ** 62 + 2.0 ** 31 / min(qs) <= 5


@lru_cache(maxsize=None)
def barrett_mu(qs: tuple):
    """floor(2^62 / q) per prime, for mulmod_v's Barrett path (numpy)."""
    return np.array([(1 << 62) // q for q in qs], np.uint64)


def barrett_muv(qs: tuple, ndim: int):
    return jnp.asarray(barrett_mu(qs)).reshape((len(qs),) + (1,) * (ndim - 1))


@lru_cache(maxsize=None)
def _multi_tables(qs: tuple, n: int):
    assert all(q < (1 << 32) for q in qs)
    n_inv = np.array([get_plan(q, n).n_inv for q in qs], np.uint64)
    return n_inv


@lru_cache(maxsize=None)
def _plan_row(q: int, n: int, inverse: bool):
    """Per-prime [1, n] root table (numpy, stable id for _dev interning)."""
    p = get_plan(q, n)
    return np.ascontiguousarray((p.roots_inv if inverse else p.roots)[None])


def _roots_dev(qs: tuple, n: int, inverse: bool):
    """[L, n] root table as an in-graph concat of per-PRIME interned
    constants — constants dedupe across every prime-set variant (levels)."""
    parts = [_dev(_plan_row(q, n, inverse)) for q in qs]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)


def ntt_multi(a, qs: tuple, mont: bool = False):
    """Forward negacyclic NTT per-prime: a [L, ..., n] -> same, prime i mod
    qs[i].  One stage chain for all primes; output dtype = input dtype
    (u32 or u64).

    mont=True lifts the output into the Montgomery domain (x R mod q,
    R = 2^32) in the transform's epilogue."""
    n = a.shape[-1]
    L = a.shape[0]
    assert L == len(qs)
    if n == 1:
        assert not mont
        return a
    fin = tuple((1 << 32) % q for q in qs) if mont else (1,) * L
    return _transform(a, qs, False, fin)


def intt_multi(a, qs: tuple, scale: tuple | None = None):
    """Inverse negacyclic NTT per-prime.  scale: optional per-prime extra
    factor folded into the final n^-1 multiply: callers use it for the t/Q
    scaling constant t and/or the Montgomery de-lift R^-1 after
    Montgomery-domain pointwise products."""
    n = a.shape[-1]
    if n == 1:
        assert scale is None
        return a
    n_inv = _multi_tables(qs, n)
    scale = scale if scale is not None else (1,) * len(qs)
    fin = tuple(int(v) * int(s) % q for v, s, q in zip(n_inv, scale, qs))
    return _transform(a, qs, True, fin)


def _transform(a, qs: tuple, inverse: bool, fin: tuple):
    """The one dispatch point: the CUDA kernel when lowered for CUDA and the
    shape fits it, the XLA stage chain otherwise.  `fin` is the per-prime
    constant multiplied into every output."""
    def xla(x):
        return _transform_xla(x, qs, inverse, fin)
    if not ntt_cuda.supported(qs, a.shape[-1]):
        return xla(a)
    return jax.lax.platform_dependent(
        a, cuda=lambda x: ntt_cuda.transform(x, qs, inverse, fin),
        default=xla)


def _transform_xla(a, qs: tuple, inverse: bool, fin: tuple):
    """log2(n) reshape/stack stages in u64 (Barrett below 2^31)."""
    if a.dtype == jnp.uint32:   # products need 2^62 of headroom
        return _transform_xla(a.astype(U64), qs, inverse, fin
                              ).astype(jnp.uint32)
    n = a.shape[-1]
    L = a.shape[0]
    roots = _roots_dev(qs, n, inverse)    # per-prime interned constants
    qv = _qvec(qs, a.ndim + 1)            # broadcast over [L, batch..., m, t]
    muv = barrett_muv(qs, a.ndim + 1) if barrett_ok(qs) else None
    batch = a.shape[1:-1]
    r = a
    t, m = (1, n // 2) if inverse else (n // 2, 1)
    while 0 < m < n:
        r = r.reshape((L,) + batch + (m, 2, t))
        u = r[..., 0, :]
        v = r[..., 1, :]
        s = roots[:, m:2 * m].reshape((L,) + (1,) * len(batch) + (m, 1))
        if inverse:
            pair = [_addmod_v(u, v, qv),
                    mulmod_v(_submod_v(u, v, qv), s, qv, muv)]
            t, m = t * 2, m // 2
        else:
            v = mulmod_v(v, s, qv, muv)
            pair = [_addmod_v(u, v, qv), _submod_v(u, v, qv)]
            t, m = t // 2, m * 2
        r = jnp.stack(pair, axis=-2)
    r = r.reshape(a.shape)
    if not inverse and all(c == 1 for c in fin):
        return r
    cv = jnp.asarray(np.array(fin, np.uint64)).reshape(
        (L,) + (1,) * (a.ndim - 1))
    return mulmod_v(r, cv, _qvec(qs, a.ndim),
                    barrett_muv(qs, a.ndim) if barrett_ok(qs) else None)


def tensor_mul_multi(x4, qs: tuple, scale: tuple | None = None):
    """Degree-2 negacyclic tensor product, per-prime.

    x4: [L, ..., 4, n] coefficient-domain residues (x0, x1, y0, y1) mod
    qs[i].  Returns [L, ..., 3, n] u32 = scale_i * (x0*y0, x0*y1+x1*y0,
    x1*y1) in the coefficient domain — the ct x ct degree-2 product of
    BFV/CKKS multiplication (reference bfv/src/lib.rs:59-85 over
    arith/src/ring_nq.rs:563-607): Montgomery-lifted forward transforms,
    u32 Montgomery products, inverse transforms with R^-1 and the scale
    folded into their epilogue."""
    from . import modops32
    assert x4.shape[-2] == 4 and len(qs) == x4.shape[0]
    e4 = ntt_multi(x4.astype(jnp.uint32), qs, mont=True)
    ex0, ex1, ey0, ey1 = (e4[..., i, :] for i in range(4))
    qv32, nqv32, _ = (jnp.asarray(c)
                      for c in modops32.consts(qs, e4.ndim - 1))
    prods = jnp.stack([
        modops32.mont_mul(ex0, ey0, qv32, nqv32),
        modops32.addmod(modops32.mont_mul(ex0, ey1, qv32, nqv32),
                        modops32.mont_mul(ex1, ey0, qv32, nqv32), qv32),
        modops32.mont_mul(ex1, ey1, qv32, nqv32)], axis=-2)
    # both operands were lifted (product = x*y*R): fold R^-1 (+ scale) in
    rinv = lambda q: pow(1 << 32, -1, q)  # noqa: E731
    sc = tuple((1 if scale is None else int(scale[i])) * rinv(q) % q
               for i, q in enumerate(qs))
    return intt_multi(prods, qs, scale=sc)


def tensor_mul4(x0, x1, y0, y1, dst: tuple, scale: tuple | None = None,
                src: tuple | None = None):
    """tensor_mul_multi from four separate operand arrays; with src given,
    the operands are first HPS-extended (unsigned) from src to dst."""
    four = jnp.stack([x0, x1, y0, y1], axis=-2).astype(jnp.uint32)
    if src is not None:
        from ..models.bfv_rns import fast_base_extend
        four = fast_base_extend(four, src, dst)
    return tensor_mul_multi(four, dst, scale=scale)


def tensor_eval4(x0, x1, y0, y1, dst: tuple, scale: tuple | None = None):
    """Degree-2 tensor product of EVAL-domain operands ([Ld, ..., n]
    canonical NTT-domain residues): returns [Ld, ..., 3, n] u32 coeff-domain
    scale*(x0y0, x0y1+x1y0, x1y1).  The eval-resident ct-mul path: no
    forward transforms (the production form of the reference's evals
    cache, arith/src/ring_nq.rs:19-27)."""
    from . import modops32
    qv32, nqv32, r2v32 = (jnp.asarray(c)
                          for c in modops32.consts(dst, x0.ndim))
    e = [a.astype(jnp.uint32) for a in (x0, x1, y0, y1)]
    my0 = modops32.to_mont(e[2], qv32, nqv32, r2v32)
    my1 = modops32.to_mont(e[3], qv32, nqv32, r2v32)
    prods = jnp.stack([
        modops32.mont_mul(e[0], my0, qv32, nqv32),
        modops32.addmod(modops32.mont_mul(e[0], my1, qv32, nqv32),
                        modops32.mont_mul(e[1], my0, qv32, nqv32), qv32),
        modops32.mont_mul(e[1], my1, qv32, nqv32)], axis=-2)
    sc = tuple((1 if scale is None else int(scale[i])) % q
               for i, q in enumerate(dst))
    return intt_multi(prods, dst, scale=sc)


def ext_ntt(x, src: tuple, dst: tuple):
    """x: [Ls, ..., P, n] coeff-domain residues over src -> [Ld, ..., P, n]
    u32 canonical EVAL-domain residues over dst: unsigned HPS base
    extension, then the forward transforms."""
    from ..models.bfv_rns import fast_base_extend
    return ntt_multi(fast_base_extend(x.astype(jnp.uint32), src, dst), dst)


def _key_mid(k, ndim: int):
    """Align [R, Lp, n] key material against [R, Lp, batch.., n] digits."""
    if k.ndim == 3:
        return k.reshape(k.shape[:2] + (1,) * (ndim - 3) + k.shape[-1:])
    return k


def _digits_eval(c_limbs, primes: tuple, src_primes: tuple):
    """Gadget digits of c_limbs [R, ..., n] (row i < src_primes[i]) reduced
    mod every prime and transformed: [R, Lp, ..., n] Montgomery-lifted
    eval-domain u32."""
    R, Lp = c_limbs.shape[0], len(primes)
    reps = (max(src_primes) - 1) // min(primes) + 1
    prow = jnp.asarray(np.array(primes, np.uint32)).reshape(
        (1, Lp) + (1,) * (c_limbs.ndim - 1))
    d = jnp.broadcast_to(c_limbs.astype(jnp.uint32)[:, None],
                         (R, Lp) + c_limbs.shape[1:])
    for _ in range(reps):
        d = jnp.where(d >= prow, d - prow, d)
    return jnp.moveaxis(ntt_multi(jnp.moveaxis(d, 1, 0), primes,
                                  mont=True), 0, 1)


def _contract(edm, kb, ka, primes: tuple):
    """(sum_i edm_i * kb_i, sum_i edm_i * ka_i) in the eval domain, u32."""
    from . import modops32
    qv32, nqv32, _ = (jnp.asarray(c)[None]
                      for c in modops32.consts(primes, edm.ndim - 1))
    rb = _key_mid(kb, edm.ndim).astype(jnp.uint32)
    ra = _key_mid(ka, edm.ndim).astype(jnp.uint32)
    pb = modops32.mont_mul(rb, edm, qv32, nqv32)
    pa = modops32.mont_mul(ra, edm, qv32, nqv32)
    acc0, acc1 = pb[0], pa[0]
    for i in range(1, edm.shape[0]):
        acc0 = modops32.addmod(acc0, pb[i], qv32[0])
        acc1 = modops32.addmod(acc1, pa[i], qv32[0])
    return acc0, acc1


def ks_contract_multi(edm, kb, ka, primes: tuple):
    """Gadget key-switch contraction on HOISTED digits.

    edm: [R, Lp, ..., n] Montgomery-lifted eval-domain digits
    (hybrid_ks.hoist_digits); kb/ka: [R, Lp, n] eval-domain key rows.
    Returns (r0, r1) u32 coeff-domain [Lp, ..., n]:
    r = INTT(sum_i edm_i * k_i) — the gadget product of
    gfhe/src/glwe.rs:126-137 / glev.rs:67-80 in RNS-NTT form."""
    acc0, acc1 = _contract(edm, kb, ka, primes)
    return intt_multi(acc0, primes), intt_multi(acc1, primes)


def ks_fused_multi(c_limbs, kb, ka, primes: tuple, src_primes: tuple):
    """Gadget key switch from limb residues: per-prime digit reduction,
    forward NTT of the R digit rows, key contraction, and the 2 inverse
    NTTs.  c_limbs: [R, ..., n] limb residues (row i < src_primes[i]);
    kb/ka: [R, Lp, n].  Returns (r0, r1) u32 coeff-domain [Lp, ..., n]."""
    return ks_contract_multi(_digits_eval(c_limbs, primes, src_primes),
                             kb, ka, primes)


def ks_fused_eval(c_limbs, kb, ka, primes: tuple, src_primes: tuple, adds):
    """Eval-resident gadget key switch (relinearization): digits of c_limbs
    [R, ..., n], keys [R, Lp, n] eval-domain, adds=(c0, c1) coeff-domain
    [Lp, ..., n].  Returns u32 (e0, e1, r0, r1):
    e = NTT(c) + Σ_i NTT(d_i)·k_i (eval), r = INTT(e) (coeff) — the caller
    re-enters the eval-resident representation without extra transforms."""
    from . import modops32
    acc0, acc1 = _contract(_digits_eval(c_limbs, primes, src_primes),
                           kb, ka, primes)
    qv32 = jnp.asarray(modops32.consts(primes, acc0.ndim)[0])
    ea = jnp.moveaxis(ntt_multi(
        jnp.stack([a.astype(jnp.uint32) for a in adds], 1), primes), 1, 0)
    e0 = modops32.addmod(acc0, ea[0], qv32)
    e1 = modops32.addmod(acc1, ea[1], qv32)
    return e0, e1, intt_multi(e0, primes), intt_multi(e1, primes)


# ---------------------------------------------------------------------------
# Cyclic NTT, natural order (building block of the DISTRIBUTED four-step NTT:
# negacyclic transform = psi-twist + cyclic NTT; see parallel/ntt_sharded.py).
# ---------------------------------------------------------------------------

class CyclicPlan:
    """Tables for a natural-order iterative cyclic NTT of size n over Z_q."""

    def __init__(self, q: int, n: int, w: int | None = None):
        assert n & (n - 1) == 0
        self.q, self.n = q, n
        self.w = w if w is not None else _primitive_root_of_unity(q, n)
        logn = n.bit_length() - 1
        self.bitrev = np.array([_bit_reverse(i, logn) for i in range(n)], np.int64)
        # per-stage twiddles: stage s (len = 2^(s+1)) uses w^(n/len * j), j<len/2
        # (numpy, not jnp: see NttPlan)
        self.tw = [np.array(
            [_pow_mod(self.w, (n // (1 << (s + 1))) * j, q) for j in range(1 << s)],
            np.uint64) for s in range(logn)]
        w_inv = pow(self.w, q - 2, q)
        self.tw_inv = [np.array(
            [_pow_mod(w_inv, (n // (1 << (s + 1))) * j, q) for j in range(1 << s)],
            np.uint64) for s in range(logn)]
        self.n_inv = pow(n, q - 2, q)


@lru_cache(maxsize=None)
def get_cyclic_plan(q: int, n: int, w: int | None = None) -> CyclicPlan:
    """w: explicit n-th root (the four-step decomposition needs the inner
    transforms to use powers of the OUTER root, not an arbitrary one)."""
    return CyclicPlan(q, n, w)


def _ntt_cyclic_stages(a, q: int, tws):
    """Iterative DIT with bit-reversed input, natural-order output."""
    n = a.shape[-1]
    batch = a.shape[:-1]
    logn = n.bit_length() - 1
    r = a
    for s in range(logn):
        half = 1 << s
        m = n // (2 * half)
        r = r.reshape(batch + (m, 2, half))
        u = r[..., 0, :]
        v = modops.mulmod(r[..., 1, :], tws[s], q)
        r = jnp.stack([modops.addmod(u, v, q), modops.submod(u, v, q)], axis=-2)
        # interleave: results for this stage live at stride pattern handled by
        # the reshape of the next iteration (arrays stay [m, 2, half] blocks)
        r = r.reshape(batch + (m, 2 * half))
    return r.reshape(batch + (n,))


def ntt_cyclic(a, q: int, w: int | None = None):
    """Cyclic DFT over Z_q, natural index order (X^n - 1 evaluation points)."""
    n = a.shape[-1]
    if n == 1:
        return a
    plan = get_cyclic_plan(q, n, w)
    return _ntt_cyclic_stages(jnp.take(a, plan.bitrev, axis=-1), q, plan.tw)


def intt_cyclic(a, q: int, w: int | None = None):
    n = a.shape[-1]
    if n == 1:
        return a
    plan = get_cyclic_plan(q, n, w)
    r = _ntt_cyclic_stages(jnp.take(a, plan.bitrev, axis=-1), q, plan.tw_inv)
    return modops.mulmod(r, U64(plan.n_inv), q)


# ---------------------------------------------------------------------------
# Exact integer negacyclic convolution via CRT over NTT-friendly primes.
# Used for: Z[X] products whose coefficients exceed the direct i64 range
# (BFV tensor at large N) and the fast mod-2^64 torus product.
# ---------------------------------------------------------------------------

# NTT-friendly primes p ≡ 1 (mod 2^27): support n up to 2^26.
CRT_PRIMES = (2013265921, 1811939329, 469762049)  # 15*2^27+1, 27*2^26+1, 7*2^26+1

# Sub-2^30 pair for the TFHE eval-domain path (tggsw Fourier-BSK).
# Capacity p1*p2/2 ≈ 2^58.4 → conv bound (K+1)·l·n·beta < 2^26 (vs 2^28 for
# the 31-bit pair); TFHE defaults use 2^24.  Exactness is prime-agnostic —
# both CRT recombinations return the identical mod-2^64 value.
CRT_PRIMES_TFHE = (998244353, 754974721)  # 119*2^23+1, 45*2^24+1 (n ≤ 2^22)


def _conv_mod_p(a_mod, b_mod, p):
    return negacyclic_mul(a_mod, b_mod, p)


def negacyclic_conv_crt_u64(a, b, num_primes: int = 2):
    """Exact negacyclic convolution of nonneg u64 inputs, values assumed small
    enough that |result| < prod(primes)/2.  Returns u64 (exact value)."""
    p1, p2 = CRT_PRIMES[:2]
    assert num_primes == 2
    r1 = _conv_mod_p(a % U64(p1), b % U64(p1), p1)
    r2 = _conv_mod_p(a % U64(p2), b % U64(p2), p2)
    # Garner: v = r1 + p1 * ((r2 - r1) * p1^{-1} mod p2)
    p1_inv_p2 = pow(p1, -1, p2)
    d = modops.mulmod(modops.submod(r2, r1 % U64(p2), p2), U64(p1_inv_p2), p2)
    return r1 + U64(p1) * d


def polymul_i64_crt(a, b):
    """Exact negacyclic product of signed int64 coefficient arrays via 2-prime
    CRT; result must satisfy |c_k| < p1*p2/2 ≈ 2^60.7. Returns int64."""
    p1, p2 = CRT_PRIMES[:2]
    a1 = modops.coerce_i64(a, p1)
    b1 = modops.coerce_i64(b, p1)
    a2 = modops.coerce_i64(a, p2)
    b2 = modops.coerce_i64(b, p2)
    r1 = _conv_mod_p(a1, b1, p1)
    r2 = _conv_mod_p(a2, b2, p2)
    p1_inv_p2 = pow(p1, -1, p2)
    d = modops.mulmod(modops.submod(r2, r1 % U64(p2), p2), U64(p1_inv_p2), p2)
    v = (r1 + U64(p1) * d).astype(jnp.int64)  # in [0, p1*p2) — fits i64
    m = p1 * p2
    return jnp.where(v > m // 2, v - jnp.int64(m), v)  # centered lift
