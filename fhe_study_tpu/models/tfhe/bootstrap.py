"""TFHE programmable bootstrapping: LUT build, blind rotation, key switch.

The reference's blind rotation (reference tfhe/src/tlwe.rs:121-148) contains
a lazy-iterator bug: its CMux chain is never executed, and it mod-switches to
q2 = K·N instead of 2N — the test only passes because `encrypt_s` uses a
near-zero binary mask (SURVEY §2.5).  This module implements the CORRECT
full CMux chain over all K·N key bits (per eprint 2018/421 / 2021/1402) as a
`lax.scan`, with two mod-switch modes:

  * mode="standard": q2 = 2N — real TFHE; the test polynomial is negacyclic,
    so messages must live in [0, t/2) (or the LUT must satisfy
    f(m + t/2) = -f(m)).
  * mode="reference": q2 = K·N — reproduces the reference's observable
    behavior (identity bootstrap over the full [0, t) range) for
    tiny-mask (encrypt_s) ciphertexts, where all switched mask digits
    vanish and the chain contributes nothing.

The BootstrappingKey is per-key-BIT (K·N TGGSWs), the correct granularity —
the reference builds K per-polynomial TGGSWs (tlwe.rs:176-179), which is
only consistent with its never-executed chain.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...arith import tn
from ...utils import prng
from ..gfhe import glwe as G
from ..gfhe.glwe import GLWE, Param
from . import tlwe as tlwe_mod
from . import tglwe as tglwe_mod
from . import tggsw as tggsw_mod
from .tlwe import TLWE
from .tggsw import TGGSW

U64 = jnp.uint64


class BootstrappingKey(NamedTuple):
    btk_a: jax.Array  # [kn, K+1, l, K, N]  — TGGSW per LWE key bit
    btk_b: jax.Array  # [kn, K+1, l, N]
    ksk_a: jax.Array  # [kn, l_ks, kn]
    ksk_b: jax.Array  # [kn, l_ks]


def compute_lookup_table(param: Param) -> GLWE:
    """v(X): t plaintext values each repeated N/t times, encoded, wrapped as a
    noiseless TGLWE (tlwe.rs:196-214; cites eprint 2021/1402).

    Used with mode="reference" (q2 = K·N): one slot window per message."""
    n, t = param.ring.n, param.t
    delta_slots = n // t
    values = jnp.repeat(jnp.arange(t, dtype=jnp.uint64), delta_slots)
    v = tglwe_mod.encode(param, values % U64(t))
    return tglwe_mod.from_plaintext(param, v)


def compute_lookup_table_standard(param: Param) -> GLWE:
    """Identity LUT for mode="standard" (q2 = 2N, negacyclic): messages live
    in [0, t/2); each of the t/2 values occupies a 2N/t coefficient window."""
    n, t = param.ring.n, param.t
    window = 2 * n // t
    values = jnp.repeat(jnp.arange(t // 2, dtype=jnp.uint64), window)
    v = tglwe_mod.encode(param, values % U64(t))
    return tglwe_mod.from_plaintext(param, v)


def new_bootstrapping_key(key, param: Param, s_tglwe,
                          beta: int = 2, l: int = 64,
                          beta_ks: int = 2, l_ks: int = 64,
                          s_lwe_out=None) -> BootstrappingKey:
    """BTK = (TGGSW_s(s_bit_j) for each of the kn LWE key bits,
    KSK: extracted key -> fresh TLWE key)  (tlwe.rs:169-194, corrected to
    per-bit granularity).  All kn TGGSW encryptions run as one batch."""
    kn = param.kn
    k_btk, k_sk2, k_ksk = prng.split(key, 3)
    s_flat = tglwe_mod.sk_to_tlwe(s_tglwe)                  # [kn]
    if s_lwe_out is None:
        s_lwe_out, _ = tlwe_mod.new_key(k_sk2, param.lwe())
    # each bit as a constant polynomial m_j(X) = s_j
    n = param.ring.n
    bits_poly = jnp.zeros((kn, n), U64).at[:, 0].set(s_flat)
    g = tggsw_mod.encrypt_s(k_btk, param, beta, l, s_tglwe, bits_poly,
                            batch=(kn,))
    ksk = tlwe_mod.new_ksk(k_ksk, param.lwe(), beta_ks, l_ks,
                           s_flat, s_lwe_out)
    return BootstrappingKey(btk_a=g.a, btk_b=g.b, ksk_a=ksk.a, ksk_b=ksk.b), \
        s_lwe_out


def precompute_btk_evals(param: Param, btk: BootstrappingKey):
    """Transform the whole bootstrapping key to the CRT-NTT domain once
    (the production Fourier-BSK layout); pass the result to blind_rotation /
    bootstrap via btk_evals to amortize across calls."""
    return tggsw_mod.precompute_evals(param, TGGSW(a=btk.btk_a, b=btk.btk_b))


def blind_rotation(param: Param, btk: BootstrappingKey, table: GLWE, c: TLWE,
                   beta: int = 2, l: int = 64, mode: str = "standard",
                   fast: bool = True, btk_evals=None) -> GLWE:
    """acc = v·X^{-b'} ; for each key bit j: acc = CMux(btk_j, acc, acc·X^{+a'_j}).

    Final rotation ≈ -(b' - Σ a'_j s_j) = -phase(m).  The chain runs as a
    lax.scan over the kn bits; each step is one fused external product.

    fast=True (when the CRT bound admits it) pre-transforms the WHOLE
    bootstrapping key to the NTT domain in one batched pass and scans over
    its eval slices — the production Fourier-domain-BSK layout."""
    kn, n = param.kn, param.ring.n
    q2 = (2 * n) if mode == "standard" else kn
    if mode == "standard":
        # round-to-nearest switch (floor bias ≈ kn/4 units = a full window)
        c2 = TLWE(a=tn.mod_switch_round(c.a, q2), b=tn.mod_switch_round(c.b, q2))
    else:
        c2 = tlwe_mod.mod_switch(c, q2)   # reference floor semantics
    # half-window centering: land phases mid-slot so the lookup tolerates
    # ±window/2 of noise+switching error.  (The reference omits this and its
    # test survives only by its saturating-noise/{0,1,2}-mask quirks.)
    half = (n // param.t) if mode == "standard" else (n // param.t) // 2
    acc0 = tglwe_mod.left_rotate(param, table, c2.b + U64(half))

    a_T = jnp.moveaxis(c2.a, -1, 0)                        # [kn, ...batch]
    use_fast = fast and (param.k + 1) * l * n * beta < (1 << 26)
    if use_fast:
        # Fourier-domain BSK: use the precomputed transform when the caller
        # supplies one (btk_evals), else transform here (amortized only over
        # this call's batch)
        gev = btk_evals if btk_evals is not None else tggsw_mod.precompute_evals(
            param, TGGSW(a=btk.btk_a, b=btk.btk_b))        # [kn, ...]

        def step_fast(acc, inputs):
            a_j, e1, e2, e1s, e2s = inputs
            rot = tglwe_mod.left_rotate(param, acc,
                                        (U64(2 * n) - a_j) % U64(2 * n))
            acc = tggsw_mod.cmux_evals(param, beta, l,
                                       tggsw_mod.TGGSWEvals(e1, e2, e1s, e2s),
                                       acc, rot)
            return acc, None

        acc, _ = jax.lax.scan(step_fast, acc0,
                              (a_T, gev.ev1, gev.ev2, gev.ev1s, gev.ev2s))
        return acc

    def step(acc, inputs):
        a_j, ga, gb = inputs
        bit = TGGSW(a=ga, b=gb)
        rot = tglwe_mod.left_rotate(param, acc, (U64(2 * n) - a_j) % U64(2 * n))
        acc = tggsw_mod.cmux(param, beta, l, bit, acc, rot)
        return acc, None

    acc, _ = jax.lax.scan(step, acc0, (a_T, btk.btk_a, btk.btk_b))
    return acc


class ShortBootstrappingKey(NamedTuple):
    """Keys for the keyswitch-FIRST pipeline over a short LWE dimension
    n_lwe < K·N: KSK (kn -> n_lwe) + per-bit TGGSWs of the short key."""
    btk_a: jax.Array   # [n_lwe, K+1, l, K, N]
    btk_b: jax.Array   # [n_lwe, K+1, l, N]
    ksk_a: jax.Array   # [kn, l_ks, n_lwe]
    ksk_b: jax.Array   # [kn, l_ks]


def new_short_bootstrapping_key(key, param: Param, s_tglwe, n_lwe: int,
                                beta: int = 256, l: int = 3,
                                beta_ks: int = 16, l_ks: int = 8
                                ) -> ShortBootstrappingKey:
    """Production TFHE key layout (the reference has no analog — its chain
    length is always K·N, tlwe.rs:139-147): an intermediate SHORT LWE key
    s' of dimension n_lwe cuts the CMux chain from K·N to n_lwe steps.

    Pipeline (bootstrap_short): key_switch kn->n_lwe FIRST, then blind-rotate
    over n_lwe bits, then sample-extract — the output lands back under the
    ORIGINAL extracted key s_flat, so bootstraps compose without a trailing
    key switch."""
    kn = param.kn
    assert n_lwe < kn, "short dimension must shrink the chain"
    k_short, k_btk, k_ksk = prng.split(key, 3)
    s_flat = tglwe_mod.sk_to_tlwe(s_tglwe)                  # [kn]
    s_short = prng.binary(k_short, (n_lwe,))
    n = param.ring.n
    bits_poly = jnp.zeros((n_lwe, n), U64).at[:, 0].set(s_short)
    g = tggsw_mod.encrypt_s(k_btk, param, beta, l, s_tglwe, bits_poly,
                            batch=(n_lwe,))
    ksk = tlwe_mod.new_ksk(k_ksk, param.lwe(), beta_ks, l_ks,
                           s_flat, s_short, uniform_mask=True)
    return ShortBootstrappingKey(btk_a=g.a, btk_b=g.b,
                                 ksk_a=ksk.a, ksk_b=ksk.b)


def precompute_short_btk_evals(param: Param, sbtk: ShortBootstrappingKey):
    return tggsw_mod.precompute_evals(param,
                                      TGGSW(a=sbtk.btk_a, b=sbtk.btk_b))


def bootstrap_short(param: Param, sbtk: ShortBootstrappingKey, table: GLWE,
                    c: TLWE, beta: int = 256, l: int = 3,
                    beta_ks: int = 16, l_ks: int = 8,
                    btk_evals=None) -> TLWE:
    """key_switch (kn -> n_lwe) -> blind rotation (n_lwe CMux steps) ->
    sample_extraction.  Input and output both live under s_flat."""
    ksk = tlwe_mod.KSK(a=sbtk.ksk_a, b=sbtk.ksk_b)
    c_short = tlwe_mod.key_switch(param.lwe(), beta_ks, l_ks, ksk, c)
    btk = BootstrappingKey(btk_a=sbtk.btk_a, btk_b=sbtk.btk_b,
                           ksk_a=sbtk.ksk_a, ksk_b=sbtk.ksk_b)
    rotated = blind_rotation(param, btk, table, c_short, beta, l,
                             mode="standard", btk_evals=btk_evals)
    return tglwe_mod.sample_extraction(param, rotated, 0)


def bootstrap(param: Param, btk: BootstrappingKey, table: GLWE, c: TLWE,
              beta: int = 2, l: int = 64,
              beta_ks: int = 2, l_ks: int = 64,
              mode: str = "standard", fast: bool = True,
              btk_evals=None) -> TLWE:
    """blind rotation -> sample_extraction(0) -> key switch (tlwe.rs:150-161)."""
    rotated = blind_rotation(param, btk, table, c, beta, l, mode, fast=fast,
                             btk_evals=btk_evals)
    c_h = tglwe_mod.sample_extraction(param, rotated, 0)
    ksk = tlwe_mod.KSK(a=btk.ksk_a, b=btk.ksk_b)
    return tlwe_mod.key_switch(param.lwe(), beta_ks, l_ks, ksk, c_h)
