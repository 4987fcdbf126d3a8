"""CKKS bootstrapping end-to-end (ModRaise -> C2S -> EvalMod -> S2C)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_study_tpu.models.ckks import ckks_rns as C
from fhe_study_tpu.models.ckks import bootstrap as B
from fhe_study_tpu.models.ckks import poly as P
from fhe_study_tpu.utils import prng


def test_ckks_bootstrap_roundtrip():
    """End-to-end refresh through the PRODUCTION key path: precompute_keys
    (eval_shape key discovery, sk not retained) + make_staged jits — the
    eager whole-pipeline path is covered (bit-exactly vs the jitted one)
    by test_ckks_bootstrap_frozen_jit in the slow tier.

    L=18 is the minimum budget: the default pipeline consumes exactly 15
    levels (C2S 1 + EvalMod 11 incl. arcsin + S2C 2 + final rescale) and
    decrypt_to_coeffs needs 3 left.  Wall-clock relief comes from the
    persistent compile cache in conftest.py, not a smaller config."""
    n, L = 32, 18
    delta0 = 2.0 ** 24
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(0), 3)
    sk, pk = C.new_key(ks[0], param)
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z.real), jnp.asarray(z.imag)))
    # exhaust the modulus: drop to level 1
    ct1, p1 = P.level_drop(param, ct, 1)
    arrays, static, pout = B.precompute_keys(ks[2], param, sk, delta0)
    run = B.make_staged(param, static, delta0)
    out, pout2 = run(arrays, ct1.c0, ct1.c1)
    assert pout2.L >= 3, f"bootstrap ended too low: L={pout2.L}"
    assert pout2.L == pout.L and pout2.delta == pout.delta
    rr, ri = C.decode(pout2, C.decrypt_to_coeffs(pout2, sk, out))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    np.testing.assert_allclose(got, z, atol=1e-2)


@pytest.mark.slow
def test_ckks_bootstrap_frozen_jit():
    """freeze() -> FrozenKeys: the whole bootstrap as ONE jitted function
    with key material passed as a pytree argument, bit-identical to the
    eager path (the eager run is why this is slow-tier)."""
    n, L = 32, 18
    delta0 = 2.0 ** 24
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(5), 3)
    sk, pk = C.new_key(ks[0], param)
    rng = np.random.default_rng(6)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z.real), jnp.asarray(z.imag)))
    ct1, _ = P.level_drop(param, ct, 1)
    keys = B.BootstrapKeys(ks[2], param, sk)
    out_e, pout = B.bootstrap(param, keys, ct1, delta0=delta0)  # eager warmup
    arrays, static = B.freeze(keys)

    def _step(c0, c1, arr):
        fk = B.FrozenKeys(arr, static)
        out, _ = B.bootstrap(param, fk, C.CT(c0, c1), delta0=delta0)
        return out.c0, out.c1

    o0, o1 = jax.jit(_step)(ct1.c0, ct1.c1, arrays)
    rr, ri = C.decode(pout, C.decrypt_to_coeffs(pout, sk, C.CT(o0, o1)))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    np.testing.assert_allclose(got, z, atol=1e-2)
    # jitted and eager paths agree bit-for-bit (same keys, same graph math)
    np.testing.assert_array_equal(np.asarray(o0), np.asarray(out_e.c0))


@pytest.mark.slow
def test_ckks_bootstrap_staged_jits():
    """make_staged (per-stage jits) == the single-graph bootstrap,
    bit-for-bit (same keys, same math, smaller compiles)."""
    n, L = 32, 18
    delta0 = 2.0 ** 24
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(9), 3)
    sk, pk = C.new_key(ks[0], param)
    rng = np.random.default_rng(10)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z.real), jnp.asarray(z.imag)))
    ct1, _ = P.level_drop(param, ct, 1)
    keys = B.BootstrapKeys(ks[2], param, sk)
    out_e, pout = B.bootstrap(param, keys, ct1, delta0=delta0)  # eager warmup
    arrays, static = B.freeze(keys)
    run = B.make_staged(param, static, delta0)
    out_s, pout_s = run(arrays, ct1.c0, ct1.c1)
    assert pout_s == pout
    np.testing.assert_array_equal(np.asarray(out_e.c0), np.asarray(out_s.c0))
    np.testing.assert_array_equal(np.asarray(out_e.c1), np.asarray(out_s.c1))


def test_mod_raise2_exact():
    """2-limb Garner ModRaise: residues of the centered representative of
    v mod q0*q1 over the full basis, checked against python bigints."""
    n, L = 16, 8
    param = C.Param(n=n, L=L, delta=2.0 ** 45)
    qs = param.qs
    q0, q1 = qs[0], qs[1]
    rng = np.random.default_rng(3)
    v = rng.integers(0, q0 * q1, n, dtype=np.uint64)
    ct2 = C.CT(jnp.stack([jnp.asarray(v % q0), jnp.asarray(v % q1)]),
               jnp.stack([jnp.asarray(v % q0), jnp.asarray(v % q1)]))
    out = B.mod_raise2(param, ct2)
    Q0 = q0 * q1
    for j, qj in enumerate(qs):
        want = [(int(x) if int(x) <= Q0 // 2 else int(x) - Q0) % qj
                for x in v]
        np.testing.assert_array_equal(np.asarray(out.c0[j]),
                                      np.asarray(want, np.uint64))


@pytest.mark.slow
def test_ckks_bootstrap_double_base_high_precision():
    """base_limbs=2 (ModRaise over q0*q1, delta0=2^45): >= 25 refreshed
    bits end-to-end — the production high-precision pipeline (the classic
    single-prime base floors at ~16 bits: the additive KS/rescale noise
    ~2^8 against delta0 <= 2^24)."""
    n, L = 32, 34
    delta0 = 2.0 ** 45
    delta_w = 2.0 ** 60
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(13), 3)
    sk, pk = C.new_key(ks[0], param)
    rng = np.random.default_rng(14)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z.real), jnp.asarray(z.imag)))
    ct2, _ = P.level_drop(param, ct, 2)
    arrays, static, pout = B.precompute_keys(
        ks[2], param, sk, delta0, K=7, r=3, deg=30, delta_w=delta_w,
        arcsin_terms=3, base_limbs=2)
    run = B.make_staged(param, static, delta0, K=7, r=3, deg=30,
                        delta_w=delta_w, arcsin_terms=3, base_limbs=2)
    out, pout2 = run(arrays, ct2.c0, ct2.c1)
    assert pout2.L == pout.L and pout2.delta == pout.delta
    rr, ri = C.decode(pout2, C.decrypt_to_coeffs(pout2, sk, out,
                                                 crt_limbs=3))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    err = np.abs(got - z).max()
    assert err < 2.0 ** -25, f"only {-np.log2(err):.1f} refreshed bits"


def test_seeded_key_pack_expand_bit_exact():
    """pack_seeded drops every HybridKSK `a` plane (half the key bytes);
    expand_seeded regenerates them BIT-EXACTLY from the PRNG schedule —
    the seeded-key compression round trip is lossless."""
    n, L = 32, 18
    delta0 = 2.0 ** 24
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(5), 3)
    sk, pk = C.new_key(ks[0], param)
    arrays, static, pout, em_src = B.precompute_keys(ks[2], param, sk,
                                                     delta0,
                                                     with_em_src=True)
    packed = B.pack_seeded(arrays, ks[2], param, em_src=em_src)
    # packed is really smaller: no `a` planes, em as compact i64 sources
    full_b = sum(x.nbytes for x in jax.tree.leaves(arrays))
    pack_b = sum(np.asarray(x).nbytes for x in jax.tree.leaves(packed))
    assert pack_b < 0.62 * full_b, (pack_b, full_b)
    # SECURITY (advisor r4 high): the pack must NOT carry the master key or
    # any subkey above the a/e split — only the k_a halves.  Every stored
    # seed must be a seed_of() result, none may equal the master or a raw
    # _rlk_subkey/_rot_subkey (from which k_e = split(.,2)[1] regenerates
    # every error tensor -> full key recovery).
    from fhe_study_tpu.models import hybrid_ks
    master = np.asarray(ks[2])
    forbidden = {master.tobytes()}
    for Lk in arrays["rlk"]:
        forbidden.add(np.asarray(B._rlk_subkey(ks[2], Lk)).tobytes())
    for (Lk, g) in arrays["rot"]:
        forbidden.add(np.asarray(B._rot_subkey(ks[2], Lk, g)).tobytes())
    stored = ([np.asarray(s).tobytes() for _, s in packed["rlk"].values()]
              + [np.asarray(s).tobytes() for _, s in packed["rot"].values()])
    assert not (set(stored) & forbidden), "pack leaks a pre-split subkey"
    # collision-free rot schedule (advisor r4 medium): distinct (L, g) must
    # yield distinct subkeys even when L*8192+g would alias (g up to 2n)
    aliases = {np.asarray(B._rot_subkey(ks[2], Lx, g)).tobytes()
               for Lx in range(1, 20) for g in (1, 3, 5, 8192 + 3)}
    assert len(aliases) == 19 * 4, "rot subkey collision"
    out = B.expand_seeded(packed, param)
    # em rebuilt from sources is bit-equal to the build-time em
    for k, em in arrays["em"].items():
        np.testing.assert_array_equal(np.asarray(out["em"][k]),
                                      np.asarray(em))
    for Lk, k in arrays["rlk"].items():
        np.testing.assert_array_equal(np.asarray(out["rlk"][Lk].a),
                                      np.asarray(k.a))
        np.testing.assert_array_equal(np.asarray(out["rlk"][Lk].b),
                                      np.asarray(k.b))
    for kk, k in arrays["rot"].items():
        np.testing.assert_array_equal(np.asarray(out["rot"][kk].a),
                                      np.asarray(k.a))
    # and the expanded set actually bootstraps (decrypt-verified)
    rng = np.random.default_rng(6)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z.real), jnp.asarray(z.imag)))
    ct1, _ = P.level_drop(param, ct, 1)
    run = B.make_staged(param, static, delta0)
    out_ct, pout2 = run(out, ct1.c0, ct1.c1)
    rr, ri = C.decode(pout2, C.decrypt_to_coeffs(pout2, sk, out_ct))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    np.testing.assert_allclose(got, z, atol=1e-2)


def test_ckks_bootstrap_multistage_c2s_s2c():
    """Radix-split C2S/S2C (c2s_stages=s2c_stages=2): the per-stage
    diagonal material shrinks to the butterfly-group bands and the refreshed message matches the single-stage pipeline's
    accuracy.  The stage factorization itself is pinned numerically in
    test_special_fft_factorization below."""
    n, S = 32, 2
    L = 18 + 2 * (S - 1)          # one extra pt_level per extra stage/side
    delta0 = 2.0 ** 24
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(0), 3)
    sk, pk = C.new_key(ks[0], param)
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z.real), jnp.asarray(z.imag)))
    ct1, _ = P.level_drop(param, ct, 1)
    arrays, static, pout = B.precompute_keys(ks[2], param, sk, delta0,
                                             c2s_stages=S, s2c_stages=S)
    run = B.make_staged(param, static, delta0, c2s_stages=S, s2c_stages=S)
    out, pout2 = run(arrays, ct1.c0, ct1.c1)
    assert pout2.L >= 3
    rr, ri = C.decode(pout2, C.decrypt_to_coeffs(pout2, sk, out))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    np.testing.assert_allclose(got, z, atol=1e-2)


def test_special_fft_factorization():
    """The butterfly factorization behind the multi-stage C2S/S2C:
    exact reconstruction of the slot transform, sparse rotation-diagonal
    structure, and C2S∘S2C identity — pure host math, every radix."""
    from fhe_study_tpu.models.ckks import eval as ev

    def apply_rlin(AB, v):
        return AB[0] @ v + AB[1] @ np.conj(v)

    for n in (16, 64):
        m = n // 2
        zeta = np.exp(1j * np.pi / n)
        rng = np.random.default_rng(0)
        p = rng.uniform(-1, 1, n)
        x = zeta ** (2 * np.arange(m) + 1)
        z = np.array([np.polyval(p[::-1], xj) for xj in x])
        for S in (2, 3):
            st = ev.c2s_stage_maps(n, S, fold=0.5)
            v1, v2 = z.copy(), z.copy()
            for m1, m2 in st:
                v1, v2 = apply_rlin(m1, v1), apply_rlin(m2, v2)
            j_of, _ = ev._t_maps(n)
            br = ev._bitrev(m)
            want1 = np.zeros(m)
            want2 = np.zeros(m)
            want1[j_of] = p[:m][br]
            want2[j_of] = p[m:][br]
            np.testing.assert_allclose(v1, want1, atol=1e-9)
            np.testing.assert_allclose(v2, want2, atol=1e-9)
            for m1, m2 in ev.s2c_stage_maps(n, S):
                v1, v2 = apply_rlin(m1, v1), apply_rlin(m2, v2)
            np.testing.assert_allclose(v1 + v2, z, atol=1e-9)
            # sparsity: every stage's diagonal count is far below dense m
            for (A, B), _ in st:
                D, E = ev.rmap_diagonals(A, B, n)
                assert len(D) + len(E) <= 2 * (1 << -(-len(
                    ev._special_fft_factors(n)) // S)) + 2
