"""Benchmark: seven cells on one GPU, each decrypt-checked.

    python bench.py                      # every mode, in the order below
    FHE_BENCH_KIND=bfv python bench.py   # one mode

Each mode prints one JSON line: metric, value, unit, and the device it ran
on (platform, device_kind, device_count, and the card's name and power
limit from nvidia-smi).  Set-up (keygen, encryption) runs on the device
before the timed window and is reported on stderr.  Every timed window
closes on `jax.block_until_ready`.

A mode that raises prints a `<mode>_ERROR` line and the rest still run; a
result that fails its decrypt check carries a `_DECRYPT_FAIL` suffix.
Either makes the process exit non-zero.  Without a GPU the bench exits
non-zero before running anything: it never measures the CPU.

Size knobs for quick runs: FHE_BENCH_N, FHE_BENCH_L, FHE_BENCH_M,
FHE_BENCH_B, FHE_BENCH_T, FHE_BENCH_ITERS, FHE_BENCH_CHAIN.
"""

import gc
import json
import os
import subprocess
import sys
import time
import traceback
from functools import lru_cache

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fhe_study_tpu.models import bfv_rns as R  # noqa: E402
from fhe_study_tpu.utils import compile_cache, prng  # noqa: E402


def _env(name: str, default: int) -> int:
    return int(os.environ.get(f"FHE_BENCH_{name}", default))


@lru_cache(maxsize=1)
def card() -> str:
    """`name, power.limit` of every card, from nvidia-smi in a child
    process (the child never touches JAX)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return "; ".join(ln.strip() for ln in res.stdout.splitlines() if ln.strip())


def device_info() -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def _emit(d: dict) -> dict:
    d = {**d, **device_info(), "card": card()}
    print(json.dumps(d), flush=True)
    return d


def _note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def timed(step, state, iters: int) -> float:
    """Seconds for `iters` chained calls state = step(state), closed on
    block_until_ready."""
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    jax.block_until_ready(state)
    return time.perf_counter() - t0


# -- shared with chip_smoke.py ------------------------------------------------

def ntt_link_chain(qs: tuple, links: int):
    """x [L, B, n] -> `links` x (forward NTT, inverse NTT): a chain of
    2·links transforms whose values stay canonical."""
    from fhe_study_tpu.ops import ntt as ntt_mod

    def chain(x):
        def body(c, _):
            return ntt_mod.intt_multi(ntt_mod.ntt_multi(c, qs), qs), None
        return jax.lax.scan(body, x, None, length=links)[0]
    return chain


def ctmul_one(param):
    """One eval-resident ct x ct multiply with hybrid relinearization:
    (x0, x1, y0, y1, rlk.b, rlk.a) -> coefficient-domain (c0, c1)."""
    def one(x0, x1, y0, y1, rb, ra):
        r = R.from_evals(param, R.mul_e(
            param, R.HRLK(rb, ra), R.to_evals(param, R.CT(x0, x1)),
            R.to_evals(param, R.CT(y0, y1))))
        return r.c0, r.c1
    return one


def ctmul_chain(param, links: int):
    """`links` eval-resident multiplies, each feeding the next: operands
    enter the NTT domain once, every link is a full mul_e (products, scale,
    hybrid relin, P re-entry).  Noise grows along the chain: its output is
    for timing only."""
    def chain(x0, x1, y0, y1, rb, ra):
        rlk = R.HRLK(rb, ra)
        ye = R.to_evals(param, R.CT(y0, y1))

        def body(ce, _):
            return R.mul_e(param, rlk, ce, ye), None
        ce = jax.lax.scan(body, R.to_evals(param, R.CT(x0, x1)), None,
                          length=links)[0]
        r = R.from_evals(param, ce)
        return r.c0, r.c1
    return chain


def ctmul_setup(param, B: int, seed: int = 0):
    """Keys and two batches of ciphertexts, built on the default device."""
    ks = prng.split(jax.random.PRNGKey(seed), 6)
    sk, pk = R.new_key(ks[0], param)
    rlk = R.hybrid_rlk1(ks[1], param, sk)
    m1 = prng.uniform_mod(ks[2], (B, param.n), param.t)
    m2 = prng.uniform_mod(ks[3], (B, param.n), param.t)
    c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[5], param, pk, m2, batch=(B,))
    jax.block_until_ready((rlk, c1, c2))
    return sk, rlk, m1, m2, c1, c2


def plain_product(m1, m2, t: int):
    """The exact plaintext product mod t (CRT negacyclic convolution)."""
    from fhe_study_tpu.ops import modops, ntt as ntt_mod
    return modops.coerce_i64(ntt_mod.polymul_i64_crt(
        m1.astype(jnp.int64), m2.astype(jnp.int64)), t)


# -- modes ----------------------------------------------------------------------

def bench_ntt():
    """Forward+inverse transform pairs at the headline's shape: 9 primes of
    30 bits, n=2^14, B=64 rows per prime, a chain of 8 pairs."""
    from fhe_study_tpu.ops.primes import ntt_primes
    from fhe_study_tpu.utils.profiling import ntt_roofline
    n = _env("N", 1 << 14)
    L = _env("L", 4) + _env("M", 5)
    B = _env("B", 64)
    iters = _env("ITERS", 3)
    links = _env("CHAIN", 8)
    qs = ntt_primes(L, 30, 1 << 16)
    x = prng.uniform_mod_multi(jax.random.PRNGKey(0), (B, n), qs
                               ).astype(jnp.uint32)
    f = jax.jit(ntt_link_chain(qs, links))
    jax.block_until_ready(f(x))
    dt = timed(f, x, iters)
    rows = 2 * links * iters * L * B
    rep = ntt_roofline(rows, n, dt).report(jax.devices()[0].device_kind)
    return _emit({
        "metric": f"ntt_n{n}_L{L}_butterflies_per_sec",
        "value": rep["butterflies_per_sec"], "unit": "butterflies/s",
        "hbm_bytes_per_sec": rep["hbm_bytes_per_sec"],
        "hbm_fraction_of_peak": rep["hbm_fraction_of_peak"], "ok": True})


def bench_bfv():
    """The headline: RNS-BFV ct x ct multiply with hybrid relinearization,
    eval-resident chain, N=2^14, L=4, M=5, t=256, B=128."""
    n = _env("N", 1 << 14)
    B = _env("B", 128)
    iters = _env("ITERS", 3)
    links = _env("CHAIN", 8)
    param = R.RnsParam(n=n, t=_env("T", 256), L=_env("L", 4), M=_env("M", 5))
    t0 = time.perf_counter()
    sk, rlk, m1, m2, c1, c2 = ctmul_setup(param, B)
    _note(f"bfv: setup {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    args = (c1.c0, c1.c1, c2.c0, c2.c1, rlk.b, rlk.a)
    one = jax.jit(ctmul_one(param)).lower(*args).compile()
    chain = jax.jit(ctmul_chain(param, links)).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = one(*args)
    rec = R.decrypt(param, sk, R.CT(*out))
    ok = bool(np.array_equal(np.asarray(rec),
                             np.asarray(plain_product(m1, m2, param.t))))
    dt = timed(lambda c: chain(c[0], c[1], *args[2:]), (c1.c0, c1.c1),
               iters)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    return _emit({
        "metric": f"bfv_rns_ctmul_n{n}_L{param.L}_per_sec"
                  + ("" if ok else "_DECRYPT_FAIL"),
        "value": B * links * iters / dt, "unit": "ctmul/s",
        "compile_s": compile_s, "peak_bytes_in_use": peak, "ok": ok})


def bench_bfv_linear():
    """Encrypted add + plaintext multiply, N=2^12, L=2, B=1024: plaintext in
    NTT form, ciphertexts eval-resident along a chain of 8 steps."""
    n = _env("N", 1 << 12)
    L = _env("L", 2)
    t = _env("T", 256)
    B = _env("B", 1024)
    iters = _env("ITERS", 3)
    links = _env("CHAIN", 8)
    param = R.RnsParam(n=n, t=t, L=L, M=L + 1)
    ks = prng.split(jax.random.PRNGKey(0), 6)
    t0 = time.perf_counter()
    sk, pk = R.new_key(ks[0], param)
    m1 = prng.uniform_mod(ks[2], (B, n), t)
    m2 = prng.uniform_mod(ks[3], (B, n), t)
    c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[5], param, pk, m2, batch=(B,))
    jax.block_until_ready((c1, c2))
    _note(f"bfv_linear: setup {time.perf_counter() - t0:.1f} s")

    def step(a0, a1, b0, b1, m, links):
        em = R.pt_to_evals(param, m)
        ce = R.to_evals(param, R.CT(a0, a1))
        be = R.to_evals(param, R.CT(b0, b1))
        for _ in range(links):
            ce = R.mul_pt_e(param, R.add_e(param, ce, be), em)
        r = R.from_evals(param, ce)
        return r.c0, r.c1

    one = jax.jit(lambda *a: step(*a, 1))
    chain = jax.jit(lambda *a: step(*a, links))
    out = one(c1.c0, c1.c1, c2.c0, c2.c1, m2)
    rec = R.decrypt(param, sk, R.CT(*out))
    want = plain_product((m1 + m2) % jnp.uint64(t), m2, t)
    ok = bool(np.array_equal(np.asarray(rec), np.asarray(want)))
    jax.block_until_ready(chain(c1.c0, c1.c1, c2.c0, c2.c1, m2))
    dt = timed(lambda c: chain(c[0], c[1], c2.c0, c2.c1, m2),
               (c1.c0, c1.c1), iters)
    return _emit({
        "metric": f"bfv_rns_add_ptmul_n{n}_per_sec"
                  + ("" if ok else "_DECRYPT_FAIL"),
        "value": B * links * iters / dt, "unit": "ops/s", "ok": ok})


# decode tolerance of tests/test_ckks_poly.py::test_mul_hybrid_chain
CKKS_ATOL = 3e-3


def bench_ckks():
    """CKKS add + mul_hybrid + rescale, N=2^13, L=4, B=32.  The float work
    (encode, decode) is complex128/f64; no float matrix product runs on
    the device, so no TF32 rounding arises."""
    from fhe_study_tpu.models.ckks import ckks_rns as C
    n = _env("N", 1 << 13)
    L = _env("L", 4)
    B = _env("B", 32)
    iters = _env("ITERS", 3)
    param = C.Param(n=n, L=L, delta=2.0 ** 28)
    ks = prng.split(jax.random.PRNGKey(0), 5)
    rng = np.random.default_rng(0)
    z1 = rng.uniform(-1, 1, (B, n // 2))
    z2 = rng.uniform(-1, 1, (B, n // 2))
    t0 = time.perf_counter()
    sk, pk = C.new_key(ks[0], param)
    hrlk = C.hybrid_rlk(ks[1], param, sk)
    c1 = C.encrypt(ks[2], param, pk,
                   C.encode(param, jnp.asarray(z1), jnp.zeros_like(z1)),
                   batch=(B,))
    c2 = C.encrypt(ks[3], param, pk,
                   C.encode(param, jnp.asarray(z2), jnp.zeros_like(z2)),
                   batch=(B,))
    jax.block_until_ready((hrlk, c1, c2))
    _note(f"ckks: setup {time.perf_counter() - t0:.1f} s")

    def _step(a0, a1, b0, b1, hb, ha):
        out = C.mul_hybrid(param, type(hrlk)(hb, ha), C.CT(a0, a1),
                           C.add(param, C.CT(a0, a1), C.CT(b0, b1)))[0]
        # a padded copy keeps the chained operand at L limbs
        pad = lambda a: jnp.concatenate([a, a[-1:]], axis=0)  # noqa: E731
        return out[0], out[1], pad(out[0]), pad(out[1])

    step = jax.jit(_step)
    out = step(c1.c0, c1.c1, c2.c0, c2.c1, hrlk.b, hrlk.a)
    p2 = C.Param(n=n, L=L - 1, delta=param.delta ** 2 / param.qs[-1])
    rr, _ = C.decode(p2, C.decrypt_to_coeffs(p2, sk, C.CT(out[0], out[1])))
    err = float(np.max(np.abs(np.asarray(rr) - (z1 + z2) * z1)))
    ok = err <= CKKS_ATOL
    dt = timed(lambda c: step(c1.c0, c1.c1, c[2], c[3], hrlk.b, hrlk.a),
               out, iters)
    return _emit({
        "metric": f"ckks_rns_add_mul_rescale_n{n}_per_sec"
                  + ("" if ok else "_DECRYPT_FAIL"),
        "value": B * iters / dt, "unit": "ops/s", "decode_max_err": err,
        "ok": ok})


def _tfhe_bench(short: bool):
    from fhe_study_tpu.arith import RingParam
    from fhe_study_tpu.arith.params import TORUS_Q
    from fhe_study_tpu.models.gfhe.glwe import Param, ERR_SIGMA
    from fhe_study_tpu.models.tfhe import tlwe, tglwe, bootstrap
    n = _env("N", 1024)
    n_lwe = _env("NLWE", 700)
    t = _env("T", 8)
    B = _env("B", 64)
    iters = _env("ITERS", 3)
    # 2^12 x 2 decomposition: 4 digit rows per CMux step
    beta, l, beta_ks, l_ks = 4096, 2, 16, 8
    param = Param(ERR_SIGMA, RingParam(TORUS_Q, n), 1, t)
    ks = prng.split(jax.random.PRNGKey(0), 3)
    t0 = time.perf_counter()
    table = bootstrap.compute_lookup_table_standard(param)
    s, _ = tglwe.new_key(ks[0], param)
    s_flat = tglwe.sk_to_tlwe(s)
    if short:
        key = bootstrap.new_short_bootstrapping_key(
            ks[1], param, s, n_lwe=n_lwe, beta=beta, l=l, beta_ks=beta_ks,
            l_ks=l_ks)
        evals = bootstrap.precompute_short_btk_evals(param, key)
        s_out = s_flat
    else:
        key, s_out = bootstrap.new_bootstrapping_key(
            ks[1], param, s, beta=beta, l=l, beta_ks=beta_ks, l_ks=l_ks,
            s_lwe_out=s_flat)
        evals = bootstrap.precompute_btk_evals(param, key)
    m = jnp.arange(B, dtype=jnp.uint64) % jnp.uint64(t // 2)
    c = tlwe.encrypt_uniform(ks[2], param.lwe(), s_flat,
                             tlwe.encode(param, m), batch=(B,))
    jax.block_until_ready((key, evals, c))
    _note(f"tfhe{'_prod' if short else ''}: setup "
          f"{time.perf_counter() - t0:.1f} s")

    def _bs(ca, cb, key_, table_, ev_):
        ct = tlwe.TLWE(ca, cb)
        if short:
            out = bootstrap.bootstrap_short(
                param, key_, table_, ct, beta=beta, l=l, beta_ks=beta_ks,
                l_ks=l_ks, btk_evals=ev_)
        else:
            out = bootstrap.bootstrap(
                param, key_, table_, ct, beta=beta, l=l, beta_ks=beta_ks,
                l_ks=l_ks, mode="standard", btk_evals=ev_)
        return out.a, out.b

    bs = jax.jit(_bs)
    out = bs(c.a, c.b, key, table, evals)
    rec = tlwe.decode(param, tlwe.decrypt(param.lwe(), s_out,
                                          tlwe.TLWE(*out)))
    ok = bool(np.array_equal(np.asarray(rec), np.asarray(m)))
    # chained: the identity LUT keeps the message, the bits change per link
    dt = timed(lambda c_: bs(c_[0], c_[1], key, table, evals), out,
               iters)
    name = (f"tfhe_bootstrap_short_n{n}_nlwe{n_lwe}_per_sec" if short
            else f"tfhe_bootstrap_n{n}_per_sec")
    return _emit({"metric": name + ("" if ok else "_DECRYPT_FAIL"),
                  "value": B * iters / dt, "unit": "bootstraps/s", "ok": ok})


def bench_tfhe():
    """TFHE bootstrap over the full k·N = 1024-step CMux chain, B=64."""
    return _tfhe_bench(short=False)


def bench_tfhe_prod():
    """TFHE bootstrap, keyswitch first, n_lwe=700 CMux steps, B=64."""
    return _tfhe_bench(short=True)


def bench_ckks_boot():
    """CKKS bootstrap: double-base ModRaise (Q0 = q0·q1, delta0 = 2^55),
    sparse secret h=64, EvalMod range from suggest_K_r, double-prime
    working scale 2^60; per-stage jits with the keys as one pytree
    argument.  n=2^11, B=8."""
    from fhe_study_tpu.models.ckks import bootstrap as BB
    from fhe_study_tpu.models.ckks import ckks_rns as C
    from fhe_study_tpu.models.ckks import poly as P
    n = _env("N", 1 << 11)
    B = _env("B", 8)
    iters = _env("ITERS", 3)
    delta0, delta_w = 2.0 ** 55, 2.0 ** 60
    deg, arcsin_terms, base = 30, 4, 2
    h = 64
    K, r = BB.suggest_K_r(n, h)
    # radix-split C2S/S2C above n=2^11: 4·(S-1) extra levels
    S = 1 if n <= (1 << 11) else 2
    L = _env("L", 29 + 2 * r + 4 * (S - 1))
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(0), 3)
    t0 = time.perf_counter()
    sk, pk = C.new_key(ks[0], param, h=h)
    z = np.random.default_rng(0).uniform(-1, 1, (B, n // 2))
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z), jnp.zeros_like(z)),
                   batch=(B,))
    ct1, _ = P.level_drop(param, ct, base)
    arrays, static, pout = BB.precompute_keys(
        ks[2], param, sk, delta0, batch=(B,), K=K, r=r, deg=deg,
        delta_w=delta_w, arcsin_terms=arcsin_terms, base_limbs=base,
        c2s_stages=S, s2c_stages=S)
    jax.block_until_ready((arrays, ct1))
    _note(f"ckks_boot: setup {time.perf_counter() - t0:.1f} s")
    run = BB.make_staged(param, static, delta0, K=K, r=r, deg=deg,
                         delta_w=delta_w, arcsin_terms=arcsin_terms,
                         base_limbs=base, c2s_stages=S, s2c_stages=S)
    back = jax.jit(lambda c0, c1: P.level_drop(pout, C.CT(c0, c1), base)[0])
    fresh, _ = run(arrays, ct1.c0, ct1.c1)
    rr, _ = C.decode(pout, C.decrypt_to_coeffs(pout, sk, fresh, crt_limbs=3))
    # gate at 2^-18 (a broken path decodes to ~2^0); precision reported
    err = float(np.max(np.abs(np.asarray(rr) - z)))
    ok = err < 2.0 ** -18
    nxt = back(fresh.c0, fresh.c1)

    def step(c):
        out, _ = run(arrays, c[0], c[1])
        b = back(out.c0, out.c1)    # chain back to the bootstrap's input level
        return b.c0, b.c1
    jax.block_until_ready(step((nxt.c0, nxt.c1)))
    dt = timed(step, (ct1.c0, ct1.c1), iters)
    return _emit({
        "metric": f"ckks_bootstrap_n{n}_per_sec"
                  + ("" if ok else "_DECRYPT_FAIL"),
        "value": B * iters / dt, "unit": "bootstraps/s",
        "refreshed_bits": -float(np.log2(max(err, 1e-300))), "ok": ok})


MODES = {
    "ntt": bench_ntt,
    "bfv": bench_bfv,
    "bfv_linear": bench_bfv_linear,
    "ckks": bench_ckks,
    "tfhe": bench_tfhe,
    "tfhe_prod": bench_tfhe_prod,
    "ckks_boot": bench_ckks_boot,
}


def main() -> int:
    cache = compile_cache.configure()
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py: no GPU found (JAX platform "
              f"{jax.devices()[0].platform!r}); the bench measures only a "
              f"GPU", file=sys.stderr)
        return 2
    _note(f"card: {card()}; compile cache: {cache}")
    kind = os.environ.get("FHE_BENCH_KIND", "all")
    names = list(MODES) if kind == "all" else [kind]
    failed = []
    for name in names:
        try:
            if not MODES[name]()["ok"]:
                failed.append(name)
        except Exception as e:  # one broken mode must not hide the rest
            traceback.print_exc(file=sys.stderr)
            _emit({"metric": f"{name}_ERROR", "value": 0, "unit": "error",
                   "error": f"{type(e).__name__}: {e}"[:300]})
            failed.append(name)
        gc.collect()        # free a mode's device buffers before the next
    if failed:
        print(f"bench.py: failed modes: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
