#!/usr/bin/env python3
"""On-chip smoke test: the system's main path on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded phase only

Phases (each prints its findings on its own line; any failure raises and
the script exits non-zero without its last line):

  device    the card (nvidia-smi name and power limit), device_kind and the
            compile-cache directory; no GPU -> exit 2.
  parity    the CUDA NTT kernel against the XLA transform chain on the same
            card, bit for bit, at n = 2^10 .. 2^14 with 9 primes and 64 rows
            per prime: forward, inverse, Montgomery lift and folded scale;
            a few rows against the C++ oracle (runtime/native.py).
  headline  RNS-BFV ct x ct multiply with hybrid relinearization, run
            eval-resident: keygen, encryption, a chain of 8 multiplies and
            decryption at N=2^14, L=4, M=5, t=256, B=128.  The single
            product decrypts to the exact plaintext product mod t; two rows
            also match the native polymul oracle.
  schemes   the tfhe_prod bootstrap (N=1024, n_lwe=700) and CKKS
            add + mul_hybrid + rescale (N=2^13, L=4) at their bench shapes.
  ab        the kernel against the XLA transform chain, in turns (XLA,
            kernel, kernel, XLA): (a) the transform alone at the ntt cell's
            shape, (b) the headline chain end to end.
  tests     the `gpu`-marked tests, through pytest in this process.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def xla_transforms():
    """Route every transform through the XLA stage chain while tracing
    inside this block: the A/B seam of this script, not a library option."""
    from fhe_study_tpu.ops import ntt
    kernel = ntt._transform
    ntt._transform = ntt._transform_xla
    try:
        yield
    finally:
        ntt._transform = kernel


def phase_device(multi: bool):
    import jax
    from fhe_study_tpu.utils import compile_cache
    import bench
    cache = compile_cache.configure()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU found (JAX platform "
              f"{devs[0].platform!r}); this script checks the GPU path only",
              file=sys.stderr)
        sys.exit(2)
    need = 4 if multi else 1
    if len(devs) < need:
        raise RuntimeError(f"need {need} GPUs, JAX sees {len(devs)}")
    card = bench.card()
    print(card, flush=True)
    log("device", f"{card} | device_kind={devs[0].device_kind} | "
        f"count={len(devs)} | compile cache {cache}")
    return devs


def phase_parity(log_ns=(10, 11, 12, 13, 14), L: int = 9, B: int = 64):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from fhe_study_tpu.ops import ntt
    from fhe_study_tpu.ops.primes import ntt_primes
    from fhe_study_tpu.runtime import native
    from fhe_study_tpu.utils import prng
    qs = ntt_primes(L, 30, 1 << 16)
    scale = tuple(q - 5 for q in qs)

    def four():
        def f(x):
            return (ntt.ntt_multi(x, qs), ntt.ntt_multi(x, qs, mont=True),
                    ntt.intt_multi(x, qs), ntt.intt_multi(x, qs, scale=scale))
        return jax.jit(f)

    for log_n in log_ns:
        n = 1 << log_n
        x = prng.uniform_mod_multi(jax.random.PRNGKey(log_n), (B, n), qs
                                   ).astype(jnp.uint32)
        got = jax.block_until_ready(four()(x))
        with xla_transforms():
            want = jax.block_until_ready(four()(x))
        names = ("forward", "forward mont", "inverse", "inverse scale")
        for name, g, w in zip(names, got, want):
            if g.dtype != jnp.uint32 or not np.array_equal(np.asarray(g),
                                                           np.asarray(w)):
                raise AssertionError(f"n=2^{log_n} {name}: kernel != XLA")
        g64 = jax.jit(lambda v: ntt.ntt_multi(v, qs))(x.astype(jnp.uint64))
        if g64.dtype != jnp.uint64 or not np.array_equal(
                np.asarray(g64), np.asarray(got[0]).astype(np.uint64)):
            raise AssertionError(f"n=2^{log_n}: u64 input breaks the contract")
        xh, fwd, inv = (np.asarray(a) for a in (x, got[0], got[2]))
        for l, b in ((0, 0), (L - 1, B - 1)):
            if not (np.array_equal(native.ntt(xh[l, b], qs[l]), fwd[l, b])
                    and np.array_equal(native.ntt(xh[l, b], qs[l],
                                                  inverse=True), inv[l, b])):
                raise AssertionError(f"n=2^{log_n}: kernel != native oracle")
        log("parity", f"n=2^{log_n} L={L} B={B}: forward, inverse, mont, "
            f"scale bit-exact vs XLA on the card; u64 in -> u64 out; "
            f"rows (0,0), ({L - 1},{B - 1}) == native oracle")


def phase_headline(card: str, n: int = 1 << 14, L: int = 4, M: int = 5,
                   t: int = 256, B: int = 128, links: int = 8,
                   iters: int = 3):
    import numpy as np
    import jax
    import bench
    from fhe_study_tpu.models import bfv_rns as R
    from fhe_study_tpu.ops import modops
    from fhe_study_tpu.runtime import native
    param = R.RnsParam(n=n, t=t, L=L, M=M)
    t0 = time.perf_counter()
    sk, rlk, m1, m2, c1, c2 = bench.ctmul_setup(param, B)
    setup_s = time.perf_counter() - t0
    args = (c1.c0, c1.c1, c2.c0, c2.c1, rlk.b, rlk.a)
    t0 = time.perf_counter()
    one = jax.jit(bench.ctmul_one(param)).lower(*args).compile()
    chain = jax.jit(bench.ctmul_chain(param, links)).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    rec = np.asarray(R.decrypt(param, sk, R.CT(*one(*args))))
    want = np.asarray(bench.plain_product(m1, m2, t))
    if not np.array_equal(rec, want):
        raise AssertionError("headline product does not decrypt to m1*m2")
    m1h, m2h = np.asarray(m1).astype(np.int64), np.asarray(m2).astype(np.int64)
    for i in (0, B - 1):
        ref = np.asarray(modops.coerce_i64(native.polymul_i64(m1h[i], m2h[i]),
                                           t))
        if not np.array_equal(rec[i], ref):
            raise AssertionError(f"headline row {i} != native polymul")
    dt = bench.timed(lambda c: chain(c[0], c[1], *args[2:]),
                     (c1.c0, c1.c1), iters)
    rate = B * links * iters / dt
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log("headline", f"N=2^{n.bit_length() - 1} L={L} M={M} t={t} B={B}: "
        f"decrypt exact ({B} rows vs CRT product, rows 0,{B - 1} vs native); "
        f"compile {compile_s:.1f} s, setup {setup_s:.1f} s, "
        f"{rate:.1f} ct-mul/s (chain {links} x {iters}), "
        f"peak_bytes_in_use {peak} | {card}")
    return param, args, rate


def phase_schemes():
    import bench
    res = bench.bench_tfhe_prod()
    if not res["ok"]:
        raise AssertionError("tfhe_prod bootstrap decrypts wrong")
    log("schemes", f"tfhe_prod N=1024 n_lwe=700: decrypt exact, "
        f"{res['value']:.1f} bootstraps/s")
    res = bench.bench_ckks()
    if not res["ok"]:
        raise AssertionError(f"CKKS decode error {res['decode_max_err']} > "
                             f"{bench.CKKS_ATOL}")
    log("schemes", f"ckks mul_hybrid+rescale N=2^13 L=4: max decode error "
        f"{res['decode_max_err']:.3g} <= {bench.CKKS_ATOL} (the tolerance of "
        f"tests/test_ckks_poly.py::test_mul_hybrid_chain); float work is "
        f"complex128/f64 and no float matmul runs on the device, so TF32 "
        f"does not arise; {res['value']:.1f} ops/s")


def _turns(name: str, legs: dict, reps: int = 2):
    """Time each leg in the order XLA, kernel, kernel, XLA; returns the
    best seconds per leg."""
    order = ["xla", "kernel", "kernel", "xla"]
    best = {}
    for leg in order:
        dt = min(legs[leg]() for _ in range(reps))
        best[leg] = min(best.get(leg, dt), dt)
        log("ab", f"{name} {leg}: {dt * 1e3:.3f} ms")
    return best


def phase_ab(card: str, param, args, links: int = 8, iters: int = 3):
    import jax
    import jax.numpy as jnp
    import bench
    from fhe_study_tpu.ops.primes import ntt_primes
    from fhe_study_tpu.utils import prng, profiling
    # (a) the transform alone: n=2^14, 9 primes, B=64, 8 forward+inverse
    n, L, B = 1 << 14, 9, 64
    qs = ntt_primes(L, 30, 1 << 16)
    x = prng.uniform_mod_multi(jax.random.PRNGKey(1), (B, n), qs
                               ).astype(jnp.uint32)
    kern = jax.jit(bench.ntt_link_chain(qs, links)).lower(x).compile()
    with xla_transforms():
        xla = jax.jit(bench.ntt_link_chain(qs, links)).lower(x).compile()
    legs = {k: (lambda f=f: bench.timed(f, x, iters))
            for k, f in (("kernel", kern), ("xla", xla))}
    best = _turns("transform", legs)
    kind = jax.devices()[0].device_kind
    peak = profiling.device_peaks(kind)["hbm_bytes_per_s"]
    rows = 2 * links * iters * L * B
    for leg in ("xla", "kernel"):
        rep = profiling.ntt_roofline(rows, n, best[leg]).report(kind)
        log("ab", f"transform {leg}: {best[leg] * 1e3:.3f} ms for {rows} "
            f"row transforms; {rep['hbm_bytes_per_sec'] / 1e9:.1f} GB/s "
            f"(u32 row read+write once) = {rep['hbm_fraction_of_peak']:.4f} "
            f"of {peak / 1e12:.2f} TB/s | {card}")
    log("ab", f"transform speed-up kernel/XLA: "
        f"{best['xla'] / best['kernel']:.2f}x")
    # (b) the headline chain end to end
    kern = jax.jit(bench.ctmul_chain(param, links)).lower(*args).compile()
    t0 = time.perf_counter()
    with xla_transforms():
        xla = jax.jit(bench.ctmul_chain(param, links)).lower(*args).compile()
    log("ab", f"headline XLA-transform chain compiled in "
        f"{time.perf_counter() - t0:.1f} s")

    def leg(f):
        return lambda: bench.timed(lambda c: f(c[0], c[1], *args[2:]),
                                   (args[0], args[1]), iters)
    best = _turns("headline", {"kernel": leg(kern), "xla": leg(xla)})
    B = args[0].shape[1]
    for k in ("xla", "kernel"):
        log("ab", f"headline {k}: {B * links * iters / best[k]:.1f} ct-mul/s "
            f"| {card}")
    log("ab", f"headline speed-up kernel/XLA: "
        f"{best['xla'] / best['kernel']:.2f}x")


def phase_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "--chip", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "-p", "no:randomly",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {int(rc)})")
    log("tests", "gpu-marked tests passed on the card")


def phase_multi(card: str, n: int = 1 << 14):
    from fhe_study_tpu.parallel import pipeline
    mesh = pipeline.factor_mesh(4)
    log("multi", f"mesh {dict(mesh.shape)} | {card}")
    pipeline.dryrun_rns(mesh, n=n)
    log("multi", f"limb-sharded RNS ct-mul N=2^{n.bit_length() - 1}: "
        "bit-equal to one card, decrypt exact")
    pipeline.dryrun_sp(mesh, n=n)
    log("multi", f"sp four-step NTT product N=2^{n.bit_length() - 1}: "
        "bit-equal to one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "fhe_study_tpu")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(fhe_study_tpu/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)
    devs = phase_device(opts.multi)
    card = __import__("bench").card()
    if opts.multi:
        phase_multi(card)
    else:
        phase_parity()
        param, args, _ = phase_headline(card)
        phase_schemes()
        phase_ab(card, param, args)
        phase_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
