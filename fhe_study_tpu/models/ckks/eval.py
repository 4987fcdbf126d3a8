"""CKKS evaluation toolkit: slot rotations, conjugation, and general slot
linear transforms (matrix-vector via rotation diagonals).

These are the building blocks of encrypted linear algebra (and of CKKS
bootstrapping's CoeffToSlot/SlotToCoeff): for the device encoder's natural
slot order (slot j = m(zeta^{2j+1}), encoder_device.py), the automorphism
phi_g moves slot values by the permutation/conjugation of
galois.ckks_slot_perm.  The odd-unit group mod 2n factors as <5> x <-1>, so
every complex-LINEAR slot map decomposes over rotations of z and rotations
of conj(z):

    M z = sum_k d_k * rho_k(z)  +  sum_k e_k * rho_k(z_c)

with rho_k = phi_{5^k}, z_c = phi_{2n-1}(z) (the conjugated ciphertext), and
host-computed diagonals d_k/e_k (each matrix entry M[j,c] lands in exactly
one of them).  Key switching uses the hybrid (P-extended) keys so the
rotation noise stays ~1 unit.

Plaintext diagonals are encoded at scale q_last so the trailing rescale
returns the ciphertext to its input scale (the standard level-consume).
"""

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ...ops.ntt import ntt_multi, intt_multi
from .. import bfv_rns, galois, hybrid_ks
from . import ckks_rns, encoder_device


class RotKeys:
    """Hybrid Galois keys for a set of rotation steps (+ conjugation),
    built PER LEVEL (the RNS gadget is basis-dependent — the same reason
    relinearization keys are per-level in poly.py)."""

    def __init__(self, keys: dict):
        self.keys = dict(keys)        # (L, g) -> HybridKSK

    @classmethod
    def build(cls, key, param, sk, steps, conj: bool = True, K: int = 2,
              min_L: int = 2):
        n = param.n
        gs = sorted({galois.rotation_element(n, k) for k in steps if
                     k % (n // 2)})
        if conj:
            gs.append(galois.conj_element(n))
        keys = {}
        for L in range(min_L, param.L + 1):
            pL = ckks_rns.Param(n=n, L=L, delta=param.delta,
                                prime_bits=param.prime_bits)
            skL = ckks_rns.SecretKey(sk.s_evals[:L])
            for i, g in enumerate(gs):
                keys[(L, g)] = hybrid_ks.galois_key_hybrid(
                    jax.random.fold_in(key, L * 4096 + i), pL, skL, g, K=K)
        return cls(keys)

    def get(self, L: int, g: int):
        assert (L, g) in self.keys, f"missing Galois key (L={L}, g={g})"
        return self.keys[(L, g)]


def rotate(param, rk: RotKeys, ct, k: int):
    """phi_{5^k}: slots move by galois.ckks_slot_perm(n, 5^k)."""
    g = galois.rotation_element(param.n, k)
    if g == 1:
        return ct
    return hybrid_ks.rotate_hybrid(param, rk.get(param.L, g), ct, g)


def conjugate(param, rk: RotKeys, ct):
    g = galois.conj_element(param.n)
    return hybrid_ks.rotate_hybrid(param, rk.get(param.L, g), ct, g)


@lru_cache(maxsize=None)
def _orbit_maps(n: int):
    """For each rotation step k: (perm, conj) of phi_{5^k}; plus the
    conjugation map."""
    half = n // 2
    rots = [galois.ckks_slot_perm(n, pow(5, k, 2 * n)) for k in range(half)]
    conj = galois.ckks_slot_perm(n, 2 * n - 1)
    return rots, conj


def matrix_diagonals(M, n: int):
    """Host-side: decompose complex [n/2, n/2] M into rotation diagonals.

    Returns (d, e): dicts k -> complex [n/2] vector with
    M z = sum_k d[k] * rho_k(z) + sum_k e[k] * rho_k(z_c); zero diagonals
    are omitted (banded matrices touch few rotations)."""
    half = n // 2
    M = np.asarray(M, np.complex128)
    assert M.shape == (half, half)
    rots, (pc, _) = _orbit_maps(n)
    d, e = {}, {}
    for k in range(half):
        perm, cj = rots[k]
        dk = np.zeros(half, np.complex128)
        ek = np.zeros(half, np.complex128)
        any_d = any_e = False
        for j in range(half):
            if not cj[j]:
                # rho_k(z)[j] = z[perm[j]] — linear: direct diagonal
                v = M[j, perm[j]]
                if v != 0:
                    dk[j] = v
                    any_d = True
            else:
                # rho_k(z)[j] = conj(z[perm[j]]) — antilinear; reach the
                # entry through z_c: rho_k(z_c)[j] = conj(z_c[perm[j]])
                #   = conj(conj(z[pc[perm[j]]])) = z[pc[perm[j]]]
                v = M[j, pc[perm[j]]]
                if v != 0:
                    ek[j] = v
                    any_e = True
        if any_d:
            d[k] = dk
        if any_e:
            e[k] = ek
    return d, e


def _encode_diag(param, vec, scale: float):
    m = encoder_device.encode(jnp.asarray(vec.real), jnp.asarray(vec.imag),
                              param.n, scale)
    return bfv_rns._to_residues(m, param.qs)


def matvec(param, rk: RotKeys, ct, M):
    """Homomorphic y = M z: rotations + plaintext diagonal multiplies +
    one rescale.  Returns (ct', param') at the input scale, one level down.

    Keys: rk must contain every rotation step with a nonzero diagonal
    (matrix_diagonals(M, n) tells you which; RotKeys.build(steps=...))."""
    n = param.n
    d, e = matrix_diagonals(np.asarray(M), n)
    scale_pt = float(param.qs[-1])        # rescale eats exactly this
    acc = None
    zc = conjugate(param, rk, ct) if e else None
    for k, vec in sorted(d.items()):
        term = ckks_rns.mul_pt(param, rotate(param, rk, ct, k),
                               _encode_diag(param, vec, scale_pt))
        acc = term if acc is None else ckks_rns.add(param, acc, term)
    for k, vec in sorted(e.items()):
        term = ckks_rns.mul_pt(param, rotate(param, rk, zc, k),
                               _encode_diag(param, vec, scale_pt))
        acc = term if acc is None else ckks_rns.add(param, acc, term)
    assert acc is not None, "zero matrix"
    # acc carries scale delta * q_last; the drop returns it to delta
    ct2, _ = ckks_rns.rescale(param, acc)
    param2 = ckks_rns.Param(n=param.n, L=param.L - 1, delta=param.delta,
                            prime_bits=param.prime_bits)
    return ct2, param2


# ---------------------------------------------------------------------------
# Baby-step/giant-step (BSGS) slot maps — the production path for DENSE
# matrices (C2S/S2C): ~2*sqrt(n/2) rotations instead of one per diagonal,
# with the baby rotations hoisted (one digit decomposition per input ct;
# hybrid_ks.rotate_hoisted).
# ---------------------------------------------------------------------------

def _inv_slot_apply(n: int, g: int, u):
    """Host: v with slotmap_g(v) = u — i.e. v[perm[j]] = conj^{cj[j]}(u[j]),
    so that  d .* rho_g(w) == rho_g(inv(d) .* w)  for plaintext diagonals."""
    perm, cj = galois.ckks_slot_perm(n, g)
    v = np.empty_like(u)
    v[perm] = np.where(cj, np.conj(u), u)
    return v


def rmap_diagonals(A, B, n: int):
    """Diagonals of the R-linear slot map y = A z + B conj(z):
    y = sum_k D_k .* rho_k(z) + sum_k E_k .* rho_k(z_c).  The B-part rides
    the same orbit through z_c: B z_c contributes its d-diagonals to E and
    its e-diagonals (which reach back through (z_c)_c = z) to D."""
    D, E = {}, {}
    for M, (lin, anti) in ((A, (D, E)), (B, (E, D))):
        if M is None or not np.any(M):
            continue
        d, e = matrix_diagonals(np.asarray(M), n)
        for k, v in d.items():
            lin[k] = lin.get(k, 0) + v
        for k, v in e.items():
            anti[k] = anti.get(k, 0) + v
    return D, E


def _bsgs_n1(n: int) -> int:
    half = n // 2
    return 1 << ((half.bit_length()) // 2)


def bsgs_steps(n: int, n1: int | None = None):
    """Rotation steps a RotKeys ring needs for rmap_bsgs (babies + giants;
    conj=True covers the antilinear part)."""
    half = n // 2
    n1 = n1 or _bsgs_n1(n)
    return sorted(set(range(1, n1)) |
                  {n1 * i for i in range(1, -(-half // n1))})


class RmapPlan:
    """Precompiled BSGS plan for a fixed list of maps y_m = A_m z + B_m z_c.

    k = n1*i + j splits every rotation as rho_{n1 i} o rho_j.  Host side:
    combined diagonals, giant-block grouping, inverse-giant pre-rotation of
    every diagonal (exact complex).  Device side: ALL diagonals encoded,
    NTT'd and Montgomery-lifted in one batched launch — the apply-time
    inner loops are pure pointwise contraction (zero per-term transforms).

    Reusable across ciphertexts at the same level (bootstrap amortization);
    em is [L, num, n] u32 on device.  pt_levels: how many top primes the
    diagonal encoding scale spans (apply rescales that many times) — >1
    lets very small map values (e.g. the double-base bootstrap's C2S fold
    ~2^-34) carry enough integer precision."""

    def __init__(self, n1, need_d, need_e, maps, em, pt_levels: int = 1):
        self.n1 = n1
        self.need_d = need_d        # baby steps j feeding rho_j(z)
        self.need_e = need_e        # baby steps j feeding rho_j(z_c)
        self.maps = maps            # per map: [(gi, [(idx, src, j), ...])]
        self.em = em                # [L, num, n] u32 Montgomery eval domain
        self.pt_levels = pt_levels


def build_rmap_plan(param, maps, n1: int | None = None,
                    pt_levels: int = 1) -> RmapPlan:
    # plans are reusable key-like material: force CONCRETE construction
    # even when the builder fires inside a trace (eval_shape/jit warmups)
    with jax.ensure_compile_time_eval():
        return _build_rmap_plan(param, maps, n1, pt_levels)


def _build_rmap_plan(param, maps, n1, pt_levels: int = 1):
    from .. import bfv_rns as _bfv
    from ...ops import modops32
    n = param.n
    half = n // 2
    n1 = n1 or _bsgs_n1(n)
    scale_pt = 1.0
    for q in param.qs[param.L - pt_levels:]:
        scale_pt *= float(q)
    vecs, plan_maps = [], []
    need_d, need_e = set(), set()
    for (A, B) in maps:
        D, E = rmap_diagonals(A, B, n)
        assert D or E, "zero map"
        giants = []
        for i in range(-(-half // n1)):
            gi = i * n1
            ggi = galois.rotation_element(n, gi)
            entries = []
            for j in range(min(n1, half - gi)):
                k = gi + j
                if k in D:
                    entries.append((len(vecs), 0, j))
                    need_d.add(j)
                    vecs.append(_inv_slot_apply(n, ggi, D[k]))
                if k in E:
                    entries.append((len(vecs), 1, j))
                    need_e.add(j)
                    vecs.append(_inv_slot_apply(n, ggi, E[k]))
            if entries:
                giants.append((gi, entries))
        plan_maps.append(giants)
    vecs.append(np.zeros(half, np.complex128))   # pad row: index `num` is 0
    V = np.stack(vecs)                                   # [num+1, half]
    qv32, nqv32, r2v32 = (jnp.asarray(c)
                          for c in modops32.consts(param.qs, 3))
    # CHUNKED device pipeline: a dense C2S at production n has ~n diagonal
    # rows; encoding/residue-splitting/transforming them in one shot
    # materializes [L, ~n, n] u64 intermediates (~100+ GB at n=2^13,
    # L=38 — measured OOM on a 125 GB host).  Only the final u32 em tensor
    # is kept; everything transient stays <= ~chunk-sized.
    chunk = max(1, (1 << 24) // n)                       # ~16M coeffs/slab
    parts, m_parts = [], []
    for i0 in range(0, V.shape[0], chunk):
        Vc = V[i0: i0 + chunk]
        m = encoder_device.encode(jnp.asarray(Vc.real), jnp.asarray(Vc.imag),
                                  n, scale_pt)           # [c, n] i64
        m_parts.append(np.asarray(m))
        res = _bfv._to_residues(m, param.qs)             # [L, c, n]
        parts.append(modops32.to_mont(
            ntt_multi(res.astype(jnp.uint32), param.qs),
            qv32, nqv32, r2v32))
    em = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    plan = RmapPlan(n1, need_d, need_e, plan_maps, em, pt_levels)
    # compact host-side source of em: the f64-sensitive encode is done (and
    # exact); `realize_em` re-derives em BIT-EXACTLY from m via pure integer
    # ops on ANY backend.  m is ~L x smaller than em — seeded-key packing
    # ships m and rebuilds em on-chip (upload is the ckks_boot bottleneck).
    plan.src_m = (np.concatenate(m_parts) if len(m_parts) > 1
                  else m_parts[0])                       # [num+1, n] i64
    plan.src_L = param.L
    return plan


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _realize_em_jit(qs: tuple):
    from .. import bfv_rns as _bfv
    from ...ops import modops32

    def f(m):
        qv32, nqv32, r2v32 = (jnp.asarray(c)
                              for c in modops32.consts(qs, 3))
        res = _bfv._to_residues(m, qs)
        return modops32.to_mont(ntt_multi(res.astype(jnp.uint32), qs),
                                qv32, nqv32, r2v32)

    return jax.jit(f)


def realize_em(param, m):
    """em from its compact integer source (see _build_rmap_plan): residue
    split + forward NTT + Montgomery lift — exact integer ops, bit-equal to
    the build-time em on every backend.  param must carry the plan's own
    limb count (src_L).

    Chunked + jitted: the [L, chunk, n] u64 residue intermediates cap at
    ~0.7 GB (a whole-plan chunk needs over 16 GB at n=2^11, L=39), and one
    jit per (qs, chunk-shape) keeps the eager path to one dispatch."""
    n = m.shape[-1]
    chunk = max(1, (1 << 21) // n)
    f = _realize_em_jit(param.qs)
    parts = []
    mj = jnp.asarray(m)
    for i0 in range(0, m.shape[0], chunk):
        parts.append(f(mj[i0: i0 + chunk]))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


def apply_rmap_plan(param, rk: RotKeys, ct, plan: RmapPlan):
    """Execute a plan: (n1-1) hoisted baby rotations of z (+ of z_c if any
    map has an antilinear part) shared across all maps; per (map, giant
    block) one eval-domain pointwise contraction + one full rotation.

    The per-giant work runs as ONE lax.scan over stacked diagonal/galois/key
    tables, so compiled size is O(#babies + 1) — NOT O(#diagonals): dense
    C2S/S2C maps at production n would otherwise unroll to 100k+ HLO ops.
    One rescale per map; one level consumed.  Returns ([ct_m...], param')."""
    from .. import hybrid_ks
    from ...ops import modops32
    n = param.n
    qs = param.qs
    L = param.L
    edm = hybrid_ks.hoist_digits(param, ct.c1)
    zc = None
    if plan.need_e:
        gc = galois.conj_element(n)
        zc = hybrid_ks.rotate_hoisted(param, rk.get(L, gc), ct, gc, edm)
        edm_c = hybrid_ks.hoist_digits(param, zc.c1)

    def to_eval(c):
        return (ntt_multi(c.c0.astype(jnp.uint32), qs),
                ntt_multi(c.c1.astype(jnp.uint32), qs))

    # hoisted babies -> stacked eval operands [L, nb_all, B.., n]
    # (slot order: need_d babies then need_e babies).  The rotated babies of
    # each source run as ONE lax.scan over stacked (perm, galois-map, key)
    # tables — the unrolled loop compiled a full hybrid-KS body PER baby,
    # and at production n (n1 = ~32 babies) the serialized module grew past
    # what compiles in reasonable time.
    babies_d = sorted(plan.need_d)
    babies_e = sorted(plan.need_e)
    slot_of = {(0, j): i for i, j in enumerate(babies_d)}
    slot_of.update({(1, j): len(babies_d) + i
                    for i, j in enumerate(babies_e)})
    def _babies_scanned(base, ed, rot_babies):
        perms, srcs, negs, kbs, kas = [], [], [], [], []
        for j in rot_babies:
            g = galois.rotation_element(n, j)
            perms.append(np.asarray(galois.eval_perm(n, g), np.int32))
            src_t, neg_t = galois.galois_map(n, g)
            srcs.append(np.asarray(src_t, np.int32))
            negs.append(np.asarray(neg_t))
            hk = rk.get(L, g)
            kbs.append(hk.b)
            kas.append(hk.a)
        xs = (jnp.asarray(np.stack(perms)), jnp.asarray(np.stack(srcs)),
              jnp.asarray(np.stack(negs)), jnp.stack(kbs), jnp.stack(kas))

        def body(_, x):
            perm, src_t, neg_t, kb, ka = x
            r0, r1 = hybrid_ks.ks_hoisted(
                param, hybrid_ks.HybridKSK(b=kb, a=ka),
                jnp.take(ed, perm, axis=-1))
            c0g = galois.apply_galois_tab(base.c0, src_t, neg_t, qs)
            c0 = bfv_rns._addmod_v(c0g, r0, bfv_rns._qvec(qs, r0.ndim))
            return None, (ntt_multi(c0.astype(jnp.uint32), qs),
                          ntt_multi(r1.astype(jnp.uint32), qs))

        _, (y0, y1) = jax.lax.scan(body, None, xs)
        return y0, y1                     # [nb_rot, L, B.., n]

    parts0, parts1 = [], []
    for src, babies in ((0, babies_d), (1, babies_e)):
        if not babies:       # purely linear plan: no z_c side at all
            continue
        base, ed = (ct, edm) if src == 0 else (zc, edm_c)
        rot = [j for j in babies if j != 0]
        if 0 in babies:                   # identity baby: plain to_eval
            e0, e1 = to_eval(base)
            parts0.append(e0[:, None])
            parts1.append(e1[:, None])
        if len(rot) > 4:
            y0, y1 = _babies_scanned(base, ed, rot)
            parts0.append(jnp.moveaxis(y0, 0, 1))
            parts1.append(jnp.moveaxis(y1, 0, 1))
        else:                             # small maps: keep the fusible form
            for j in rot:
                g = galois.rotation_element(n, j)
                e0, e1 = to_eval(hybrid_ks.rotate_hoisted(
                    param, rk.get(L, g), base, g, ed))
                parts0.append(e0[:, None])
                parts1.append(e1[:, None])
    EB0 = jnp.concatenate(parts0, axis=1)      # [L, nb_all, B.., n]
    EB1 = jnp.concatenate(parts1, axis=1)

    nbatch = ct.c0.ndim - 2
    qv32e, nqv32e, _ = (jnp.asarray(c)
                        for c in modops32.consts(qs, EB0.ndim))
    qv = bfv_rns._qvec(qs, ct.c0.ndim)
    pad_idx = plan.em.shape[1] - 1       # the all-zero diagonal row

    def inner_ct(em_idx, slot_idx):
        """[Emax] index tables -> contracted inner ct (u64 coeff domain)."""
        em_g = jnp.take(plan.em, em_idx, axis=1)      # [L, Emax, n]
        em_g = em_g.reshape(em_g.shape[:2] + (1,) * nbatch + (n,))
        p0 = modops32.mont_mul(jnp.take(EB0, slot_idx, axis=1), em_g,
                               qv32e, nqv32e)
        p1 = modops32.mont_mul(jnp.take(EB1, slot_idx, axis=1), em_g,
                               qv32e, nqv32e)
        while p0.shape[1] > 1:           # exact tree addmod over entries
            p0 = modops32.addmod(p0[:, 0::2], p0[:, 1::2], qv32e)
            p1 = modops32.addmod(p1[:, 0::2], p1[:, 1::2], qv32e)
        return (intt_multi(p0[:, 0], qs).astype(jnp.uint64),
                intt_multi(p1[:, 0], qs).astype(jnp.uint64))

    outs = []
    param2 = ckks_rns.Param(n=param.n, L=L - plan.pt_levels,
                            delta=param.delta, prime_bits=param.prime_bits)
    for giants in plan.maps:
        zero_blocks = [e for gi, e in giants if gi == 0]
        rot_blocks = [(gi, e) for gi, e in giants if gi != 0]
        emax = max(len(e) for _, e in giants)
        emax = 1 << (emax - 1).bit_length()           # pow2 for the tree

        def tables(entries):
            ei = np.full(emax, pad_idx, np.int32)
            sl = np.zeros(emax, np.int32)
            for t, (idx, src, j) in enumerate(entries):
                ei[t] = idx
                sl[t] = slot_of[(src, j)]
            return ei, sl

        if zero_blocks:
            ei, sl = tables(zero_blocks[0])
            a0, a1 = inner_ct(jnp.asarray(ei), jnp.asarray(sl))
        else:
            a0, a1 = jnp.zeros_like(ct.c0), jnp.zeros_like(ct.c1)
        if rot_blocks:
            ei_r, sl_r, srcs, negs, kbs, kas = [], [], [], [], [], []
            for gi, entries in rot_blocks:
                ggi = galois.rotation_element(n, gi)
                ei, sl = tables(entries)
                ei_r.append(ei)
                sl_r.append(sl)
                src_t, neg_t = galois.galois_map(n, ggi)
                srcs.append(np.asarray(src_t, np.int32))
                negs.append(np.asarray(neg_t))
                hk = rk.get(L, ggi)
                kbs.append(hk.b)
                kas.append(hk.a)
            xs = (jnp.asarray(np.stack(ei_r)), jnp.asarray(np.stack(sl_r)),
                  jnp.asarray(np.stack(srcs)), jnp.asarray(np.stack(negs)),
                  jnp.stack(kbs), jnp.stack(kas))

            def body(carry, x):
                ei, sl, src_t, neg_t, kb, ka = x
                c0, c1 = inner_ct(ei, sl)
                c0 = galois.apply_galois_tab(c0, src_t, neg_t, qs)
                c1 = galois.apply_galois_tab(c1, src_t, neg_t, qs)
                sw = hybrid_ks.hybrid_key_switch(
                    param, hybrid_ks.HybridKSK(b=kb, a=ka),
                    bfv_rns.CT(c0, c1))
                return (bfv_rns._addmod_v(carry[0], sw.c0, qv),
                        bfv_rns._addmod_v(carry[1], sw.c1, qv)), None

            (a0, a1), _ = jax.lax.scan(body, (a0, a1), xs)
        ct2 = type(ct)(a0, a1)
        for lv in range(plan.pt_levels):      # one drop per pt-scale prime
            pL = ckks_rns.Param(n=param.n, L=L - lv, delta=param.delta,
                                prime_bits=param.prime_bits)
            ct2, _ = ckks_rns.rescale(pL, ct2)
        outs.append(ct2)
    return outs, param2


# ---------------------------------------------------------------------------
# Multi-stage (radix-split) special-FFT factorization — the level-for-memory
# trade that shrinks C2S/S2C diagonal material from O(m) dense rows to
# O(2^(log(m)/S)) rows per stage (eprint 2018/1073 structure).
#
# Core identity: slot evaluation is y_t = p(zeta^{5^t mod 2n}) in the
# 5-orbit coordinates t (slot rotations act as translations of t).  The
# classic decimation recursion applies because 5^(mm/2) == 1 + (2n/2^d)*odd
# (2-adic valuation of 5^(2^i)-1 is i+2), so the paired point at every
# depth is the negation: y-pair = -y.  Each butterfly level is a matrix
# with rotation-diagonals {0, +-mm/2}; grouping adjacent levels keeps the
# product sparse (subset sums of the offsets).  The leftover input
# bit-reversal is absorbed by the slot-LAYOUT freedom between C2S and S2C:
# EvalMod is slot-pointwise with real Taylor coefficients, so any fixed
# (conj-flagged) relabeling that C2S emits and S2C consumes cancels.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _special_fft_factors(n: int):
    """Butterfly factors of F (t-space, [m, m], m = n/2):
    F = factors[0] @ ... @ factors[-1] @ Pbr, F[t, k] = zeta^(5^t * k).
    Factor d has nonzeros only on t-diagonals {0, +-(m >> (d+1))}."""
    m = n // 2
    zeta = np.exp(1j * np.pi / n)
    logm = m.bit_length() - 1
    factors = []
    for d in range(logm):
        mm = m >> d
        F = np.zeros((m, m), np.complex128)
        for b in range(0, m, mm):
            for t in range(mm // 2):
                e = (pow(5, t, 2 * n) * (1 << d)) % (2 * n)
                y = zeta ** e
                F[b + t, b + t] = 1
                F[b + t, b + mm // 2 + t] = y
                F[b + mm // 2 + t, b + t] = 1
                F[b + mm // 2 + t, b + mm // 2 + t] = -y
        factors.append(F)
    return factors


@lru_cache(maxsize=None)
def _bitrev(m: int):
    bits = m.bit_length() - 1
    return np.array([int(format(t, f"0{bits}b")[::-1], 2) if bits else 0
                     for t in range(m)], np.int64)


@lru_cache(maxsize=None)
def _t_maps(n: int):
    """5-orbit coordinates: t -> (slot j, conj flag).  Slot j holds the
    eval at zeta^(2j+1); 5^t mod 2n lands either at u = 2j+1 (linear) or
    at 2n-u (the conjugate point)."""
    m = n // 2
    j_of_t = np.empty(m, np.int64)
    cj_of_t = np.empty(m, bool)
    u = 1
    for t in range(m):
        if u < n:
            j_of_t[t] = (u - 1) // 2
            cj_of_t[t] = False
        else:
            j_of_t[t] = (2 * n - u - 1) // 2
            cj_of_t[t] = True
        u = (u * 5) % (2 * n)
    assert len(set(j_of_t.tolist())) == m, "5-orbit does not cover slots"
    return j_of_t, cj_of_t


def _t_to_nat(n: int, lin=None, anti=None):
    """t-space map -> natural-slot (A, B) pair for rmap machinery.

    V_t = conj^{cj(t)}(z[j(t)]); out V'_t = lin V + anti conj(V); written
    back as z'[j(t)] = conj^{cj(t)}(V'_t).  Distributing the conjugations:
    a t-entry v with total conj parity p contributes conj^{cj_o}(v) to A
    (p even) or B (p odd) at [j_out, j_in]."""
    m = n // 2
    j_of, cj_of = _t_maps(n)
    A = np.zeros((m, m), np.complex128)
    B = np.zeros((m, m), np.complex128)
    for M, base_parity in ((lin, 0), (anti, 1)):
        if M is None:
            continue
        to, ti = np.nonzero(M)
        for t_o, t_i in zip(to, ti):
            v = M[t_o, t_i]
            if cj_of[t_o]:
                v = np.conj(v)
            parity = base_parity ^ int(cj_of[t_o]) ^ int(cj_of[t_i])
            (B if parity else A)[j_of[t_o], j_of[t_i]] += v
    return A, B


def _group_prod(mats):
    out = mats[0]
    for M in mats[1:]:
        out = out @ M
    return out


def _split_groups(k: int, S: int):
    """k factor indices into S contiguous groups, coarse levels first."""
    S = max(1, min(S, k))
    base, extra = divmod(k, S)
    sizes = [base + (1 if i < extra else 0) for i in range(S)]
    out, i = [], 0
    for s in sizes:
        out.append(list(range(i, i + s)))
        i += s
    return out


@lru_cache(maxsize=None)
def _sigma_t(n: int):
    """sigma in t-space: sigma_j = x_j^m = i*(-1)^j, the X^m eval —
    as a t-indexed diagonal (exponent 5^t * m mod 2n)."""
    m = n // 2
    zeta = np.exp(1j * np.pi / n)
    return np.array([zeta ** ((pow(5, t, 2 * n) * m) % (2 * n))
                     for t in range(m)], np.complex128)


@lru_cache(maxsize=None)
def c2s_stage_maps(n: int, S: int, fold: complex = 1.0):
    """Per-stage natural (A, B) maps for the radix-split CoeffToSlot.

    Returns `stages`: a list of S entries, each [(A, B) for chain 1,
    (A, B) for chain 2] — chain 1 yields the LOWER coefficient half,
    chain 2 the UPPER (its first stage folds the diag(conj(sigma))
    pre-multiply).  The LAST stage of both chains folds the real
    extraction out = fold*(y + conj(y)) (lin = fold*M, anti =
    fold*conj(M)) — no separate extraction level.  Output coefficient
    LAYOUT is bit-reversed-in-t (consumed by s2c_stage_maps; cancels)."""
    m = n // 2
    factors = _special_fft_factors(n)
    inv = [np.linalg.inv(F) for F in factors]
    # C2S chain: y = inv[L-1] @ ... @ inv[0] @ z (F^{-1} sans bitrev).
    # Application order: the group containing inv[0] (the coarsest
    # butterfly) runs FIRST; within a group the product is reversed so
    # stage_mats[s] applied in order s = 0..S-1 composes to the chain.
    stage_mats = []
    for g in _split_groups(len(inv), S):
        stage_mats.append(_group_prod([inv[i] for i in reversed(g)]))
    sig_c = np.conj(_sigma_t(n))
    out = []
    for s, M in enumerate(stage_mats):
        first, last = (s == 0), (s == S - 1)
        M2 = M @ np.diag(sig_c) if first else M
        if last:
            e1 = _t_to_nat(n, lin=fold * M, anti=fold * np.conj(M))
            e2 = _t_to_nat(n, lin=fold * M2, anti=fold * np.conj(M2))
        else:
            e1 = _t_to_nat(n, lin=M)
            e2 = _t_to_nat(n, lin=M2)
        out.append((e1, e2))
    return out


@lru_cache(maxsize=None)
def s2c_stage_maps(n: int, S: int):
    """Per-stage natural (A, B) maps for the radix-split SlotToCoeff.
    Chain 1 consumes ct1 (lower coeffs, bitrev-t layout), chain 2 ct2;
    chain 2's LAST stage folds the diag(sigma) post-multiply so the final
    combine is a plain ciphertext add."""
    factors = _special_fft_factors(n)
    groups = _split_groups(len(factors), S)
    # forward chain: W = factors[0] @ ... @ factors[-1] @ (bitrev layout);
    # application order: factors[-1] group FIRST
    stage_mats = []
    for g in reversed(groups):
        stage_mats.append(_group_prod([factors[i] for i in g]))
    sig = _sigma_t(n)
    out = []
    for s, M in enumerate(stage_mats):
        last = (s == len(stage_mats) - 1)
        M2 = np.diag(sig) @ M if last else M
        out.append((_t_to_nat(n, lin=M), _t_to_nat(n, lin=M2)))
    return out


def rmap_bsgs_multi(param, rk: RotKeys, ct, maps, n1: int | None = None):
    """build_rmap_plan + apply_rmap_plan in one shot (single-use maps).
    Returns ([ct_m...], param')."""
    return apply_rmap_plan(param, rk, ct, build_rmap_plan(param, maps, n1))


def rmap_bsgs(param, rk: RotKeys, ct, A, B=None, n1: int | None = None):
    """Single-map rmap_bsgs_multi.  Returns (ct', param')."""
    outs, param2 = rmap_bsgs_multi(param, rk, ct, [(A, B)], n1=n1)
    return outs[0], param2


# ---------------------------------------------------------------------------
# CoeffToSlot / SlotToCoeff — the linear stages of CKKS bootstrapping.
#
# For the device encoder, slot_j(ct) = m(zeta^{2j+1})/delta with
# D[j,k] = zeta^{(2j+1)k} satisfying D D^H = n I and D conj(D)^T = 0, so the
# (real) coefficient vector recovers as p = (1/n)(D^H z + conj(D^H z)).
# ---------------------------------------------------------------------------

def linear_rmap(param, rk: RotKeys, ct, A, B):
    """Homomorphic R-linear slot map y = A z + B conj(z) (two matvecs; one
    level).  Zero matrices are skipped."""
    A = np.asarray(A)
    B = np.asarray(B)
    outs = []
    if np.any(A):
        outs.append(matvec(param, rk, ct, A))
    if np.any(B):
        outs.append(matvec(param, rk, conjugate(param, rk, ct), B))
    assert outs, "zero map"
    if len(outs) == 1:
        return outs[0]
    (c1, p1), (c2, _) = outs
    return ckks_rns.add(p1, c1, c2), p1


@lru_cache(maxsize=None)
def _c2s_matrices(n: int):
    """A1/B1 (slots -> first-half coeffs) and A2/B2 (second half)."""
    half = n // 2
    k = np.arange(n)[:, None]
    j = np.arange(half)[None, :]
    zeta = np.exp(1j * np.pi / n)
    Dh = zeta ** (-((2 * j + 1) * k))          # [n, half] = D^H
    A = Dh / n
    return ((A[:half], A[:half].conj()), (A[half:], A[half:].conj()))


@lru_cache(maxsize=None)
def _s2c_matrices(n: int):
    """D1, D2: coeffs-in-slots -> slots of the packed polynomial."""
    half = n // 2
    j = np.arange(half)[:, None]
    k = np.arange(n)[None, :]
    zeta = np.exp(1j * np.pi / n)
    D = zeta ** ((2 * j + 1) * k)              # [half, n]
    return D[:, :half], D[:, half:]


def coeff_to_slot(param, rk: RotKeys, ct):
    """-> (ct1, ct2, param'): slots(ct1) = coeffs p[0:n/2]/1, slots(ct2) =
    p[n/2:n] (both real; one level consumed).  BSGS with shared hoisted
    babies across the two matrix halves."""
    (A1, B1), (A2, B2) = _c2s_matrices(param.n)
    (c1, c2), p1 = rmap_bsgs_multi(param, rk, ct, [(A1, B1), (A2, B2)])
    return c1, c2, p1


def slot_to_coeff(param, rk: RotKeys, ct1, ct2):
    """Inverse of coeff_to_slot: packs slots(ct1)|slots(ct2) back into the
    coefficient positions.  -> (ct, param')."""
    D1, D2 = _s2c_matrices(param.n)
    c1, p1 = rmap_bsgs(param, rk, ct1, D1)
    c2, _ = rmap_bsgs(param, rk, ct2, D2)
    return ckks_rns.add(p1, c1, c2), p1
