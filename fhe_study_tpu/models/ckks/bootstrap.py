"""CKKS bootstrapping: refresh an exhausted (level-1) ciphertext to a high
level without decrypting.

Far beyond the reference's surface (its CKKS stops at encrypt/add,
ckks/src/lib.rs:113-118) — this is the full production pipeline
(eprint 2018/153 structure), built from this library's own toolkit:

  1. ModRaise      — reinterpret the level-1 residues (centered) over the
                     full basis: phase becomes t = m + q0*I, |I| <= K.
  2. CoeffToSlot   — eval.coeff_to_slot with the twist constants folded in:
                     slots w = (2*pi*t/q0 - pi/2) / (2^r * vmax), |w| <= 1.
  3. EvalMod       — cos(vmax*w) by even Taylor series in y = w^2
                     (poly.poly_eval), then r double-angle steps
                     cos(2x) = 2cos^2 x - 1 (each: 1 mul + add + const),
                     yielding sin(2*pi*t/q0) ~ 2*pi*(t mod q0)/q0.
  4. SlotToCoeff   — eval.slot_to_coeff scaled by q0/(2*pi): coefficients
                     return to ~m, now under the big modulus.

Level budget: 1 (C2S) + 1 (w^2) + ceil(log2(deg/2)) + 1 (fold) + r
(doublings) + 1 (S2C);  with deg=24, r=3 that is 11 levels.

Key material (relinearization + rotation keys) is basis-dependent, so keys
are built lazily per level from the secret key (fine for a functional API;
a deployment would precompute the two rotation levels + mul levels)."""

import math
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ...ops import modops32
from .. import bfv_rns, galois, hybrid_ks
from . import ckks_rns, eval as ev, poly

U64 = jnp.uint64


class BootstrapKeys:
    """Lazy per-level key cache (holds sk — see module docstring)."""

    def __init__(self, key, param, sk):
        self.key = key
        self.param = param
        self.sk = sk
        self._rlk = None
        self._rot = None
        self._plans = {}   # (tag, L, ...) -> ev.RmapPlan (C2S/S2C reuse)

    def rlks(self):
        # persistent: later bootstrap() calls reuse already-built keys
        if self._rlk is None:
            self._rlk = _LazyRlk(self)
        return self._rlk

    def rotkeys(self):
        if self._rot is None:
            self._rot = _LazyRot(self)
        return self._rot


def _rlk_subkey(master, L: int):
    """Deterministic per-level relin subkey — single source of truth shared
    by the lazy builder and the seeded-key packer (pack_seeded)."""
    return jax.random.fold_in(master, 100000 + L)


def _rot_subkey(master, L: int, g: int):
    # TWO folds, not one packed tag: Galois elements range over [1, 2n), so
    # any single-int packing `L*C + g` collides for n > C/2 — two (L, g)
    # pairs would then share a PRNG subkey, i.e. two rotation keys with
    # identical (a, e); b1-b2 reveals g*(sigma_g1(s)-sigma_g2(s))
    # NOISELESSLY (advisor r4, medium).  Chained fold_ins are injective in
    # (L, g) and cannot meet the single-fold _rlk_subkey chain.
    return jax.random.fold_in(jax.random.fold_in(master, 200000 + L), g)


class _LazyRlk(dict):
    def __init__(self, bk):
        super().__init__()
        self.bk = bk

    def __missing__(self, L):
        pL = ckks_rns.Param(n=self.bk.param.n, L=L, delta=self.bk.param.delta,
                            prime_bits=self.bk.param.prime_bits)
        # compile-time eval: key material must come out CONCRETE even when
        # the cache miss fires inside a trace (eval_shape/jit warmups)
        with jax.ensure_compile_time_eval():
            k = _rlk_subkey(self.bk.key, L)
            self[L] = ckks_rns.hybrid_rlk(
                k, pL, ckks_rns.SecretKey(self.bk.sk.s_evals[:L]))
        return self[L]


class _LazyRot(ev.RotKeys):
    def __init__(self, bk):
        super().__init__({})
        self.bk = bk

    def get(self, L: int, g: int):
        if (L, g) not in self.keys:
            pL = ckks_rns.Param(n=self.bk.param.n, L=L,
                                delta=self.bk.param.delta,
                                prime_bits=self.bk.param.prime_bits)
            with jax.ensure_compile_time_eval():   # concrete even mid-trace
                k = _rot_subkey(self.bk.key, L, g)
                self.keys[(L, g)] = hybrid_ks.galois_key_hybrid(
                    k, pL, ckks_rns.SecretKey(self.bk.sk.s_evals[:L]), g)
        return self.keys[(L, g)]


def freeze(keys: BootstrapKeys):
    """Split lazily-built key material into (arrays, static): `arrays` is a
    jit-passable pytree (every HybridKSK + plan diagonal tensor), `static`
    the host-side plan metadata.  Call AFTER one eager bootstrap() has
    populated the caches; rehydrate per-trace with FrozenKeys(arrays,
    static) — this is how the whole bootstrap becomes ONE jitted function
    with no giant closure constants."""
    arrays = {
        "rlk": dict(keys.rlks()),
        "rot": dict(keys.rotkeys().keys),
        "em": {k: p.em for k, p in keys._plans.items()},
    }
    static = {k: (p.n1, frozenset(p.need_d), frozenset(p.need_e), p.maps,
                  p.pt_levels)
              for k, p in keys._plans.items()}
    bad = [x for x in jax.tree.leaves(arrays) if isinstance(x, jax.core.Tracer)]
    assert not bad, ("tracer leaked into bootstrap key caches — build keys "
                     "outside a trace (the lazy builders use "
                     "ensure_compile_time_eval; a tracer here means a "
                     "ciphertext-dependent value was cached)")
    return arrays, static


class FrozenKeys:
    """Prebuilt bootstrap key material (see freeze); drop-in for
    BootstrapKeys inside jit."""

    def __init__(self, arrays, static):
        self._rlk = arrays["rlk"]
        self._rot = ev.RotKeys(arrays["rot"])
        self._plans = {
            k: ev.RmapPlan(n1, set(nd), set(ne), maps, arrays["em"][k], pl)
            for k, (n1, nd, ne, maps, pl) in static.items()}

    def rlks(self):
        return self._rlk

    def rotkeys(self):
        return self._rot


def pack_seeded(arrays, master_key, param_boot, em_src=None):
    """Seeded-`a` key compression of a frozen bootstrap key set.

    Every HybridKSK mask `a` is a pure function of its deterministic PRNG
    subkey (hybrid_ks.seed_of + the _rlk_subkey/_rot_subkey schedule), so
    the packed pytree keeps only the `b` planes + PER-KSK a-subkeys — HALF
    the bytes on disk and over the wire.  expand_seeded() regenerates the
    `a` planes bit-exactly on whatever device the packed pytree lives on.
    (Production feature beyond the reference — it never serializes keys
    at all; SURVEY.md §5 checkpoint row.)

    SECURITY (advisor r4, high): the pack must NOT contain the master key
    or any per-KSK subkey ABOVE the a/e split — split(fold_in(master,
    tag)) yields the error subkey k_e alongside k_a, and a holder of k_e
    can regenerate every error tensor e and solve b = g*s_old - a*s_new +
    e (a noiseless linear system) for the SECRET KEY.  Only the per-KSK
    a-seeds (hybrid_ks.seed_of results — the k_a half, a few bytes each,
    not invertible to k_e) are stored."""
    import numpy as np

    def a_seed(sub):
        return np.asarray(hybrid_ks.seed_of(sub))

    rlk = {L: (k.b, a_seed(_rlk_subkey(master_key, L)))
           for L, k in arrays["rlk"].items()}
    rot = {kk: (k.b, a_seed(_rot_subkey(master_key, *kk)))
           for kk, k in arrays["rot"].items()}
    out = {"rlk": rlk, "rot": rot}
    if em_src is not None:
        # ship the compact i64 sources (~L x smaller); expand_seeded
        # rebuilds each em tensor bit-exactly on-device (ev.realize_em)
        out["em_src"] = em_src
    else:
        out["em"] = arrays["em"]
    return out


def expand_seeded(packed, param_boot):
    """Inverse of pack_seeded: regenerate every `a` plane on-device.

    One small jit per distinct level shape (persistently compile-cached);
    bit-exact vs the originally built keys (threefry + integer NTTs are
    backend-deterministic).  Consumes the per-KSK a-seeds directly — the
    packed artifact carries no master key (see pack_seeded SECURITY)."""
    P = ckks_rns.Param

    def pL_of(L):
        return P(n=param_boot.n, L=L, delta=param_boot.delta,
                 prime_bits=param_boot.prime_bits)

    rlk = {}
    for L, (b, ka) in packed["rlk"].items():
        K = int(b.shape[1]) - L
        rlk[L] = hybrid_ks.HybridKSK(
            b=b, a=hybrid_ks.expand_a(pL_of(L), jnp.asarray(ka), K))
    rot = {}
    for (L, g), (b, ka) in packed["rot"].items():
        K = int(b.shape[1]) - L
        rot[(L, g)] = hybrid_ks.HybridKSK(
            b=b, a=hybrid_ks.expand_a(pL_of(L), jnp.asarray(ka), K))
    if "em_src" in packed:
        # int() coercion: generic pytree loaders (tree.map(jnp.asarray) /
        # device_put) may have turned the L metadata into device scalars
        em = {k: ev.realize_em(pL_of(int(Lp)), m)
              for k, (m, Lp, _pl) in packed["em_src"].items()}
    else:
        em = packed["em"]
    return {"rlk": rlk, "rot": rot, "em": em}


def mod_raise(param_boot, ct_l1):
    """Level-1 residues (mod q0 = qs[0]), centered lift, re-reduced over the
    full basis.  Output phase = m + q0*I over Q."""
    qs = param_boot.qs
    q0 = qs[0]
    L = param_boot.L

    def raise_one(c):
        v = c[0]                                   # [., n] mod q0
        # centered: v_c in (-q0/2, q0/2]; residues of v_c mod each q_j
        neg = v > U64(q0 // 2)
        out = []
        for j, qj in enumerate(qs):
            pos = v if qj == q0 else v % U64(qj)
            vneg = (U64(qj) - ((U64(q0) - v) % U64(qj))) % U64(qj)
            out.append(jnp.where(neg, vneg, pos))
        return jnp.stack(out, 0)

    return ckks_rns.CT(raise_one(ct_l1.c0), raise_one(ct_l1.c1))


def mod_raise2(param_boot, ct_l2):
    """Double-base ModRaise: level-2 residues (mod q0 and q1) -> full
    basis.  2-limb Garner lift v = v0 + q0·((v1 − v0)·q0^{-1} mod q1)
    ∈ [0, Q0), Q0 = q0·q1 < 2^61 (exact u64), then the centered
    representative re-reduced per prime.  Output phase = m + Q0·I.

    The point (see bootstrap(base_limbs=2)): the refreshed precision is
    delta0 / (additive KS+rescale noise ~2^8), and delta0 is capped by the
    ModRaise base (|m| << Q0).  A single ~30-bit prime caps delta0 at
    ~2^24 -> ~16 bits; the 2-limb base lifts delta0 to ~2^45."""
    qs = param_boot.qs
    q0, q1 = qs[0], qs[1]
    Q0 = q0 * q1
    inv01 = pow(q0, -1, q1)

    def raise_one(c):
        v0 = c[0]                                   # [., n] mod q0
        v1 = c[1]
        d = (v1 + U64(q1) - v0 % U64(q1)) % U64(q1)
        t = (d * U64(inv01)) % U64(q1)              # < 2^62: exact u64
        v = v0 + U64(q0) * t                        # exact: < q0*q1 < 2^61
        neg = v > U64(Q0 // 2)
        out = []
        for qj in qs:
            pos = v % U64(qj)
            vneg = (U64(qj) - ((U64(Q0) - v) % U64(qj))) % U64(qj)
            out.append(jnp.where(neg, vneg, pos))
        return jnp.stack(out, 0)

    return ckks_rns.CT(raise_one(ct_l2.c0), raise_one(ct_l2.c1))


def suggest_K_r(n: int, h: int | None = None, sigma_mult: float = 5.0):
    """EvalMod range parameters for a given ring size / secret weight.

    The ModRaise overflow t = v0 + v1*s has per-coefficient deviation
    sigma_I = sqrt((1 + h_eff)/12) base units (v uniform in +-Q0/2, s
    ternary with h_eff nonzeros; dense ternary has h_eff ~ 2n/3).  K must
    cover the max over ~n coefficients: sigma_mult * sigma_I.  r then
    keeps vmax = (2*pi*(K+.5) + pi/2)/2^r in the ~4..6 range where the
    deg~30 cosine Taylor converges.  K=7/r=3 (the old fixed default) is
    only valid for tiny rings — at n=2048 dense, |I| reaches ~45."""
    h_eff = (2 * n) // 3 if h is None else h
    sigma_i = math.sqrt((1 + h_eff) / 12.0)
    K = max(7, math.ceil(sigma_mult * sigma_i))
    r = max(3, math.ceil(math.log2((2 * math.pi * (K + 0.5)
                                    + math.pi / 2) / 5.0)))
    return K, r


@lru_cache(maxsize=None)
def _cos_taylor_even(deg: int, vmax: float):
    """cos(vmax*w) = sum_j c_j (w^2)^j, j = 0..deg/2 (exact even Taylor)."""
    out = []
    for j in range(deg // 2 + 1):
        out.append((-1.0) ** j * vmax ** (2 * j) / math.factorial(2 * j))
    return tuple(out)


def _base(param_boot, base_limbs: int) -> int:
    """The ModRaise base modulus: q0 (classic) or q0·q1 (double-base)."""
    Q0 = 1
    for q in param_boot.qs[:base_limbs]:
        Q0 *= q
    return Q0


def _stage_raise_c2s(param_boot, keys, ct_l1, K, r, delta_w,
                     base_limbs: int = 1):
    """ModRaise + C2S (twist folded) + affine shift -> [(ct, param)] x 2.

    base_limbs=2: the double-base pipeline — the raised phases t reach
    K·Q0 ~ 2^63, so a one-prime diagonal encoding (rounding ~2^-30
    relative) would leak ~2^33 of absolute w-phase error; a TWO-prime
    plaintext scale (integer magnitude ~2^52, still inside both i64 and
    f64-exact range since a·delta_w·A ~ 2^-8) keeps the rounding ~2^8
    absolute against the 2^60 w-phase.  The matvec consumes 2 levels."""
    n = param_boot.n
    Q0 = _base(param_boot, base_limbs)
    rk = keys.rotkeys()
    ct = (mod_raise(param_boot, ct_l1) if base_limbs == 1
          else mod_raise2(param_boot, ct_l1))
    vmax = (2 * math.pi * (K + 0.5) + math.pi / 2) / (1 << r)
    a = 2 * math.pi / (Q0 * (1 << r) * vmax)
    b = (-math.pi / 2) / ((1 << r) * vmax)
    (A1, B1), (A2, B2) = ev._c2s_matrices(n)
    scale_fold = a * delta_w
    pt_levels = 1 if base_limbs == 1 else 2
    p_unit = ckks_rns.Param(n=n, L=param_boot.L, delta=1.0,
                            prime_bits=param_boot.prime_bits)
    pkey = ("c2s", param_boot.L, K, r, delta_w, base_limbs)
    if pkey not in keys._plans:
        keys._plans[pkey] = ev.build_rmap_plan(
            p_unit, [(A1 * scale_fold, B1 * scale_fold),
                     (A2 * scale_fold, B2 * scale_fold)],
            pt_levels=pt_levels)
    cs, _ = ev.apply_rmap_plan(p_unit, rk, ct, keys._plans[pkey])
    outs = []
    for c_ in cs:
        p_ = ckks_rns.Param(n=n, L=param_boot.L - pt_levels, delta=delta_w,
                            prime_bits=param_boot.prime_bits)
        c_ = poly.add_pt_const(p_, c_, b * 1.0)
        outs.append((c_, p_))
    return outs


def _c2s_ms_consts(param_boot, K, r, delta_w, base_limbs):
    Q0 = _base(param_boot, base_limbs)
    vmax = (2 * math.pi * (K + 0.5) + math.pi / 2) / (1 << r)
    a = 2 * math.pi / (Q0 * (1 << r) * vmax)
    b = (-math.pi / 2) / ((1 << r) * vmax)
    return a, b, (1 if base_limbs == 1 else 2)


def _c2s_ms_stage(param_boot, keys, s, c1, c2, L_cur, K, r, delta_w,
                  base_limbs: int, stages: int):
    """Apply C2S stage `s` to both chains (stage 0: c1 is the raised ct,
    c2 ignored — one shared plan emits both chains).  Returns (c1', c2')."""
    import numpy as np
    n = param_boot.n
    rk = keys.rotkeys()
    a, _, pt_levels = _c2s_ms_consts(param_boot, K, r, delta_w, base_limbs)
    smaps = ev.c2s_stage_maps(n, stages, fold=(a * delta_w) / 2)
    m1, m2 = smaps[s]
    pL = ckks_rns.Param(n=n, L=L_cur, delta=1.0,
                        prime_bits=param_boot.prime_bits)
    if s == 0:
        pkey = ("c2s_ms", s, L_cur, K, r, delta_w, base_limbs, stages)
        if pkey not in keys._plans:
            keys._plans[pkey] = ev.build_rmap_plan(
                pL, [m1, m2], pt_levels=pt_levels)
        (c1, c2), _ = ev.apply_rmap_plan(pL, rk, c1, keys._plans[pkey])
        return c1, c2
    same = (np.array_equal(m1[0], m2[0]) and np.array_equal(m1[1], m2[1]))
    outs = []
    for chain, (mm, cc) in enumerate(((m1, c1), (m2, c2))):
        ch = 0 if same else chain
        pkey = ("c2s_ms", s, ch, L_cur, K, r, delta_w, base_limbs, stages)
        if pkey not in keys._plans:
            keys._plans[pkey] = ev.build_rmap_plan(
                pL, [mm], pt_levels=pt_levels)
        (o,), _ = ev.apply_rmap_plan(pL, rk, cc, keys._plans[pkey])
        outs.append(o)
    return outs[0], outs[1]


def _stage_raise_c2s_multi(param_boot, keys, ct_l1, K, r, delta_w,
                           base_limbs: int, stages: int):
    """Radix-split ModRaise + C2S: `stages` sparse
    butterfly-group plans instead of ONE dense plan — per-stage diagonal
    material shrinks from O(n/2) rows to O(2^(log(n/2)/stages)) rows, at
    the cost of (stages-1)*pt_levels extra levels.  Two parallel chains
    (lower/upper coefficient half); stage 0 shares one plan (and its
    hoisted babies) across both chains since they consume the same raised
    ciphertext.  Output coefficient layout is bitrev-in-t — consumed by
    _stage_s2c_multi, invisible to the slot-pointwise EvalMod."""
    n = param_boot.n
    ct = (mod_raise(param_boot, ct_l1) if base_limbs == 1
          else mod_raise2(param_boot, ct_l1))
    _, b, pt_levels = _c2s_ms_consts(param_boot, K, r, delta_w, base_limbs)
    L_cur = param_boot.L
    c1, c2 = ct, None
    for s in range(stages):
        c1, c2 = _c2s_ms_stage(param_boot, keys, s, c1, c2, L_cur, K, r,
                               delta_w, base_limbs, stages)
        L_cur -= pt_levels
    outs = []
    for c_ in (c1, c2):
        p_ = ckks_rns.Param(n=n, L=L_cur, delta=delta_w,
                            prime_bits=param_boot.prime_bits)
        c_ = poly.add_pt_const(p_, c_, b * 1.0)
        outs.append((c_, p_))
    return outs


def _s2c_ms_stage(param_boot, keys, s, c1, c2, L_cur, base_limbs: int,
                  stages: int):
    """Apply S2C stage `s` to both chains.  Returns (c1', c2')."""
    import numpy as np
    n = param_boot.n
    Q0 = _base(param_boot, base_limbs)
    rk = keys.rotkeys()
    fold = Q0 / (2 * math.pi) if base_limbs == 1 else 1.0
    pt_levels = 1 if base_limbs == 1 else 2
    smaps = ev.s2c_stage_maps(n, stages)
    m1, m2 = smaps[s]
    if s == len(smaps) - 1 and fold != 1.0:
        m1 = (m1[0] * fold, m1[1] * fold)
        m2 = (m2[0] * fold, m2[1] * fold)
    pL = ckks_rns.Param(n=n, L=L_cur, delta=1.0,
                        prime_bits=param_boot.prime_bits)
    same = (np.array_equal(m1[0], m2[0]) and np.array_equal(m1[1], m2[1]))
    outs = []
    for chain, (mm, cc) in enumerate(((m1, c1), (m2, c2))):
        ch = 0 if same else chain
        pkey = ("s2c_ms", s, ch, L_cur, base_limbs, stages)
        if pkey not in keys._plans:
            keys._plans[pkey] = ev.build_rmap_plan(
                pL, [mm], pt_levels=pt_levels)
        (o,), _ = ev.apply_rmap_plan(pL, rk, cc, keys._plans[pkey])
        outs.append(o)
    return outs[0], outs[1]


def _stage_s2c_multi(param_boot, keys, halves, delta0, double=False,
                     drops: int | None = None, base_limbs: int = 1,
                     stages: int = 2):
    """Radix-split SlotToCoeff: forward butterfly-group plans per chain;
    chain 2's last stage carries the diag(sigma) fold so the final combine
    is a plain add.  Scale bookkeeping identical to _stage_s2c."""
    n = param_boot.n
    Q0 = _base(param_boot, base_limbs)
    (s1, p1), (s2, p2) = halves
    L = min(p1.L, p2.L)
    s1, p1 = poly.level_drop(p1, s1, L)
    s2, p2 = poly.level_drop(p2, s2, L)
    pt_levels = 1 if base_limbs == 1 else 2
    L_cur = L
    cs = (s1, s2)
    for s in range(stages):
        cs = _s2c_ms_stage(param_boot, keys, s, cs[0], cs[1], L_cur,
                           base_limbs, stages)
        L_cur -= pt_levels
    pf = ckks_rns.Param(n=n, L=L_cur, delta=p1.delta,
                        prime_bits=param_boot.prime_bits)
    out = ckks_rns.add(pf, cs[0], cs[1])
    out_delta = (pf.delta * delta0 if base_limbs == 1
                 else pf.delta * (2 * math.pi / Q0) * delta0)
    pout = ckks_rns.Param(n=n, L=pf.L, delta=out_delta,
                          prime_bits=param_boot.prime_bits)
    if drops is None:
        drops = 1 if base_limbs == 1 else 0
    for _ in range(drops):
        out, _ = ckks_rns.rescale(pout, out)
        pout = ckks_rns.Param(n=n, L=pout.L - 1,
                              delta=pout.delta / pout.qs[pout.L - 1],
                              prime_bits=param_boot.prime_bits)
    return out, pout


def _arcsin_coeffs(terms: int):
    """arcsin(s) Taylor: s + s^3/6 + 3 s^5/40 + 15 s^7/336 ... (`terms`
    odd-power terms) — cancels the linearization error of
    sin(2 pi m / q0) ~ 2 pi m / q0 up to O((m/q0)^{2*terms+1})."""
    out = [0.0, 1.0]
    c = 1.0
    for j in range(1, terms):
        c *= (2 * j - 1) / (2 * j)
        out += [0.0, c / (2 * j + 1)]
    return out


def _stage_evalmod(keys, c_, p_, K, r, deg, double=False, arcsin_terms=2):
    """cos Taylor in w^2 + double-angle ladder + arcsin correction — one
    half of EvalMod.  The trailing odd polynomial is the inverse-sine
    correction (see _arcsin_coeffs).  double=True runs every multiply at
    the two-prime-drop scale (poly.mul_ct2/poly_eval2) for ~2^-40-grade
    relative error per level instead of ~2^-24."""
    rlks = keys.rlks()
    mul = poly.mul_ct2 if double else poly.mul_ct
    peval = poly.poly_eval2 if double else poly.poly_eval
    vmax = (2 * math.pi * (K + 0.5) + math.pi / 2) / (1 << r)
    coeffs = _cos_taylor_even(deg, vmax)
    y, py = mul(rlks, c_, p_, c_, p_)                      # y = w^2
    cosv, pc = peval(rlks, y, py, list(coeffs))
    for _ in range(r):                                     # double angle
        sq, ps = mul(rlks, cosv, pc, cosv, pc)
        dbl = ckks_rns.add(ps, sq, sq)                     # 2 cos^2
        cosv = poly.add_pt_const(ps, dbl, -1.0)
        pc = ps
    return peval(rlks, cosv, pc, _arcsin_coeffs(arcsin_terms))


def _stage_s2c(param_boot, keys, halves, delta0, double=False,
               drops: int | None = None, base_limbs: int = 1):
    """S2C scaled by q0/(2 pi), combine halves, final rescale.

    `drops` controls how many primes the final rescale removes:
      * single mode: 1 (delta_sin ~ one prime -> output scale ~ delta0).
      * double mode default: 1, NOT 2 — the output stays at the
        double-prime scale ~ delta0*q' (~2^54).  Rescaling all the way to
        delta0 would floor the refreshed precision at
        log2(delta0) - log2(KS/rescale noise) ~ 15 bits (measured,
        scripts/boot_probe.py (r3 probe): the S2C matvec itself is 45-bit
        accurate pre-rescale); at the double-prime scale the additive
        noise sits ~46 bits below the scale and EvalMod's approximation
        error becomes the limiter.  Downstream arithmetic uses the
        double-prime toolkit (poly.mul_ct2 etc.), same as EvalMod itself.
      * drops=2 restores the to-delta0 behavior when scale compatibility
        with single-prime consumers matters more than precision."""
    n = param_boot.n
    Q0 = _base(param_boot, base_limbs)
    rk = keys.rotkeys()
    (s1, p1), (s2, p2) = halves
    L = min(p1.L, p2.L)
    s1, p1 = poly.level_drop(p1, s1, L)
    s2, p2 = poly.level_drop(p2, s2, L)
    D1, D2 = ev._s2c_matrices(n)
    # base_limbs=1: fold Q0/(2pi) numerically so the output scale lands at
    # ~delta_sin*delta0.  base_limbs=2: Q0/(2pi) ~ 2^57 would overflow the
    # f64/i64 encoding path — fold NOTHING and carry the factor in the
    # output Param.delta instead (scale is metadata in CKKS; the phase
    # stays ~delta_sin*2pi*delta0/Q0*msg ~ 2^48*msg, far above the ~2^8
    # additive noise floor).
    fold = Q0 / (2 * math.pi) if base_limbs == 1 else 1.0
    pt_levels = 1 if base_limbs == 1 else 2
    for tag, D in (("s2c1", D1), ("s2c2", D2)):
        if (tag, L, base_limbs) not in keys._plans:
            keys._plans[(tag, L, base_limbs)] = ev.build_rmap_plan(
                ckks_rns.Param(n=n, L=L, delta=1.0,
                               prime_bits=param_boot.prime_bits),
                [(D * fold, None)], pt_levels=pt_levels)
    (c1,), pf = ev.apply_rmap_plan(p1, rk, s1,
                                   keys._plans[("s2c1", L, base_limbs)])
    (c2,), _ = ev.apply_rmap_plan(
        ckks_rns.Param(n=n, L=L, delta=p2.delta,
                       prime_bits=param_boot.prime_bits),
        rk, s2, keys._plans[("s2c2", L, base_limbs)])
    out = ckks_rns.add(pf, c1, c2)
    # phase = delta_sin * fold * sin(2 pi t / Q0)
    #       ~ delta_sin * fold * (2 pi / Q0) * delta0 * msg
    out_delta = (pf.delta * delta0 if base_limbs == 1       # fold cancels
                 else pf.delta * (2 * math.pi / Q0) * delta0)
    pout = ckks_rns.Param(n=n, L=pf.L, delta=out_delta,
                          prime_bits=param_boot.prime_bits)
    # final rescale: see the docstring — by default one drop in the classic
    # base (double mode intentionally keeps one working-scale prime in
    # delta) and ZERO drops in the double base (its output delta is already
    # ~2^48; a drop would push it below the additive noise floor)
    if drops is None:
        drops = 1 if base_limbs == 1 else 0
    for _ in range(drops):
        out, _ = ckks_rns.rescale(pout, out)
        pout = ckks_rns.Param(n=n, L=pout.L - 1,
                              delta=pout.delta / pout.qs[pout.L - 1],
                              prime_bits=param_boot.prime_bits)
    return out, pout


def _is_double(delta_w: float, double):
    # delta_w ~ one prime (2^30) -> single-drop ladder; ~ two primes
    # (2^60) -> double-drop.  Explicit `double` overrides the heuristic.
    return (delta_w > 2.0 ** 45) if double is None else double


def bootstrap(param_boot, keys: BootstrapKeys, ct_l1, delta0: float,
              K: int = 7, r: int = 3, deg: int = 24,
              delta_w: float = 2.0 ** 30, double: bool | None = None,
              arcsin_terms: int = 2, s2c_drops: int | None = None,
              base_limbs: int = 1, c2s_stages: int = 1,
              s2c_stages: int = 1):
    # NB delta_w must sit at ~the rescale granularity: single mode drops one
    # ~2^30 prime per multiply (delta_w ~ 2^30), double mode drops two
    # (delta_w ~ 2^60) — a mismatched working scale would COLLAPSE
    # geometrically through the power ladder (delta -> delta^2/q).
    """ct_l1: level-1 ciphertext with message scale delta0 (|phase| << q0).
    Returns (ct', param') at a high level with the same message and scale
    ~delta0 (exact output scale in param'.delta).

    High-precision mode: delta_w ~ 2^60 (auto-detected) runs EvalMod at
    double-prime scales (poly.mul_ct2/poly_eval2) — ~2x the limb budget,
    ~20+ refreshed bits instead of ~8.  Pair with deg>=30 and
    arcsin_terms>=3 so the approximation error keeps up with the noise."""
    dbl = _is_double(delta_w, double)
    if c2s_stages > 1:
        outs = _stage_raise_c2s_multi(param_boot, keys, ct_l1, K, r,
                                      delta_w, base_limbs, c2s_stages)
    else:
        outs = _stage_raise_c2s(param_boot, keys, ct_l1, K, r, delta_w,
                                base_limbs)
    halves = [_stage_evalmod(keys, c_, p_, K, r, deg, dbl, arcsin_terms)
              for c_, p_ in outs]
    if s2c_stages > 1:
        return _stage_s2c_multi(param_boot, keys, halves, delta0, dbl,
                                s2c_drops, base_limbs, s2c_stages)
    return _stage_s2c(param_boot, keys, halves, delta0, dbl, s2c_drops,
                      base_limbs)


def precompute_keys(key, param_boot, sk, delta0: float, *, batch=(),
                    K: int = 7, r: int = 3, deg: int = 24,
                    delta_w: float = 2.0 ** 30, double: bool | None = None,
                    arcsin_terms: int = 2, s2c_drops: int | None = None,
                    base_limbs: int = 1, with_em_src: bool = False,
                    c2s_stages: int = 1, s2c_stages: int = 1):
    """Production key builder: derive the COMPLETE bootstrap key set
    (per-level hybrid relin + rotation keys, C2S/S2C diagonal plans) from
    the secret key once, and return (arrays, static, pout) with NO secret
    material retained — `arrays` is the jit-passable public pytree for
    FrozenKeys/make_staged, `static` the host-side plan metadata, `pout`
    the output Param.  jax.eval_shape walks the exact pipeline (zero
    ciphertext compute) so every lazily-keyed level is discovered without
    running a bootstrap."""
    keys = BootstrapKeys(key, param_boot, sk)
    spec = jax.ShapeDtypeStruct((base_limbs,) + tuple(batch)
                                + (param_boot.n,), jnp.uint64)
    cell = {}

    def probe(c0, c1):
        out, po = bootstrap(param_boot, keys, ckks_rns.CT(c0, c1),
                            delta0=delta0, K=K, r=r, deg=deg,
                            delta_w=delta_w, double=double,
                            arcsin_terms=arcsin_terms, s2c_drops=s2c_drops,
                            base_limbs=base_limbs, c2s_stages=c2s_stages,
                            s2c_stages=s2c_stages)
        cell["pout"] = po
        return out.c0, out.c1

    jax.eval_shape(probe, spec, spec)
    arrays, static = freeze(keys)
    em_src = None
    if with_em_src:
        # compact integer sources of the plan diagonal tensors (ev.realize_em
        # rebuilds em bit-exactly on-device): ~L x smaller than em — the
        # seeded key pack ships these instead of the 100s-of-MB em tensors
        em_src = {k: (p.src_m, p.src_L, p.pt_levels)
                  for k, p in keys._plans.items()}
    del keys   # BootstrapKeys (and its sk reference) does not escape
    if em_src is not None:
        return arrays, static, cell["pout"], em_src
    return arrays, static, cell["pout"]


def make_staged(param_boot, static, delta0: float, K: int = 7, r: int = 3,
                deg: int = 24, delta_w: float = 2.0 ** 30,
                double: bool | None = None, arcsin_terms: int = 2,
                s2c_drops: int | None = None, base_limbs: int = 1,
                c2s_stages: int = 1, s2c_stages: int = 1):
    """Per-STAGE jitted bootstrap: ModRaise+C2S | EvalMod (shared across
    both halves) | S2C each compile as their OWN jit — the whole-pipeline
    single jit produces a graph XLA takes tens of minutes to compile (every
    level's kernels inlined ~100x); staged, compiles are small and the
    EvalMod jit is reused for both halves.

    static: plan metadata from freeze() (plans must be prebuilt, e.g. by
    one jax.eval_shape of bootstrap()).  Returns run(arrays, c0, c1) ->
    (CT, pout); pout is also available as run.pout after the first call."""
    cell = {}
    dbl = _is_double(delta_w, double)
    pt_levels = 1 if base_limbs == 1 else 2

    def f1(arr, c0, c1):
        fk = FrozenKeys(arr, static)
        outs = _stage_raise_c2s(param_boot, fk, ckks_rns.CT(c0, c1),
                                K, r, delta_w, base_limbs)
        cell["p1"] = outs[0][1]
        assert outs[1][1] == outs[0][1]    # halves share a level signature
        return (outs[0][0].c0, outs[0][0].c1,
                outs[1][0].c0, outs[1][0].c1)

    # multi-stage: ONE JIT PER TRANSFORM STAGE — the bundled raise+C2S
    # graph at n=2^12 serializes to ~90 MB MLIR; per-stage graphs stay
    # small and compile quickly
    def f1_ms(s):
        L_cur = param_boot.L - s * pt_levels

        def g(arr, c0, c1, d0, d1):
            fk = FrozenKeys(arr, static)
            if s == 0:
                ct = (mod_raise(param_boot, ckks_rns.CT(c0, c1))
                      if base_limbs == 1
                      else mod_raise2(param_boot, ckks_rns.CT(c0, c1)))
                a_, b_ = _c2s_ms_stage(param_boot, fk, 0, ct, None,
                                       L_cur, K, r, delta_w, base_limbs,
                                       c2s_stages)
            else:
                a_, b_ = _c2s_ms_stage(param_boot, fk,
                                       s, ckks_rns.CT(c0, c1),
                                       ckks_rns.CT(d0, d1), L_cur, K, r,
                                       delta_w, base_limbs, c2s_stages)
            if s == c2s_stages - 1:        # final: the b-shift epilogue
                _, bconst, _ = _c2s_ms_consts(param_boot, K, r, delta_w,
                                              base_limbs)
                p_ = ckks_rns.Param(n=param_boot.n,
                                    L=L_cur - pt_levels, delta=delta_w,
                                    prime_bits=param_boot.prime_bits)
                a_ = poly.add_pt_const(p_, a_, bconst * 1.0)
                b_ = poly.add_pt_const(p_, b_, bconst * 1.0)
                cell["p1"] = p_
            return a_.c0, a_.c1, b_.c0, b_.c1

        return g

    def f2(arr, c0, c1):
        fk = FrozenKeys(arr, static)
        ct, pc = _stage_evalmod(fk, ckks_rns.CT(c0, c1), cell["p1"],
                                K, r, deg, dbl, arcsin_terms)
        cell["p2"] = pc
        return ct.c0, ct.c1

    def f3(arr, a0, a1, b0, b1):
        fk = FrozenKeys(arr, static)
        halves = [(ckks_rns.CT(a0, a1), cell["p2"]),
                  (ckks_rns.CT(b0, b1), cell["p2"])]
        out, pout = _stage_s2c(param_boot, fk, halves, delta0, dbl,
                               s2c_drops, base_limbs)
        cell["pout"] = pout
        return out.c0, out.c1

    def f3_ms(s):
        def g(arr, a0, a1, b0, b1):
            fk = FrozenKeys(arr, static)
            L_cur = cell["p2"].L - s * pt_levels
            c1_, c2_ = _s2c_ms_stage(param_boot, fk, s, ckks_rns.CT(a0, a1),
                                     ckks_rns.CT(b0, b1), L_cur,
                                     base_limbs, s2c_stages)
            if s < s2c_stages - 1:
                return c1_.c0, c1_.c1, c2_.c0, c2_.c1
            # last stage: combine + delta bookkeeping + final drops
            n = param_boot.n
            Q0 = _base(param_boot, base_limbs)
            pf = ckks_rns.Param(n=n, L=L_cur - pt_levels,
                                delta=cell["p2"].delta,
                                prime_bits=param_boot.prime_bits)
            out = ckks_rns.add(pf, c1_, c2_)
            out_delta = (pf.delta * delta0 if base_limbs == 1
                         else pf.delta * (2 * math.pi / Q0) * delta0)
            pout = ckks_rns.Param(n=n, L=pf.L, delta=out_delta,
                                  prime_bits=param_boot.prime_bits)
            drops = s2c_drops
            if drops is None:
                drops = 1 if base_limbs == 1 else 0
            for _ in range(drops):
                out, _ = ckks_rns.rescale(pout, out)
                pout = ckks_rns.Param(n=n, L=pout.L - 1,
                                      delta=pout.delta
                                      / pout.qs[pout.L - 1],
                                      prime_bits=param_boot.prime_bits)
            cell["pout"] = pout
            return out.c0, out.c1, out.c0, out.c1

        return g

    j2 = jax.jit(f2)
    if c2s_stages > 1:
        j1s = [jax.jit(f1_ms(s)) for s in range(c2s_stages)]
    else:
        j1 = jax.jit(f1)
    if s2c_stages > 1:
        j3s = [jax.jit(f3_ms(s)) for s in range(s2c_stages)]
    else:
        j3 = jax.jit(f3)

    def run(arrays, c0, c1):
        if c2s_stages > 1:
            a0, a1, b0, b1 = c0, c1, c0, c1
            for jf in j1s:
                a0, a1, b0, b1 = jf(arrays, a0, a1, b0, b1)
        else:
            a0, a1, b0, b1 = j1(arrays, c0, c1)
        a0, a1 = j2(arrays, a0, a1)
        b0, b1 = j2(arrays, b0, b1)        # same compile, second half
        if s2c_stages > 1:
            for jf in j3s:
                a0, a1, b0, b1 = jf(arrays, a0, a1, b0, b1)
            o0, o1 = a0, a1
        else:
            o0, o1 = j3(arrays, a0, a1, b0, b1)
        run.pout = cell["pout"]
        return ckks_rns.CT(o0, o1), cell["pout"]

    run.jits = ((tuple(j1s) if c2s_stages > 1 else (j1,))
                + (j2,)
                + (tuple(j3s) if s2c_stages > 1 else (j3,)))
    return run
