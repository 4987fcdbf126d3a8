"""Per-stage timing of the RNS-BFV multiply pipeline on the GPU.

Usage: python scripts/profile_mul.py [coeff|eval]
  coeff  — stages of the coefficient-domain `bfv_rns.mul`
           (one dispatch per iteration, chained, closed on
           block_until_ready)
  eval   — stages of the EVAL-RESIDENT `bfv_rns.mul_e`: every section runs
           CH times inside one jitted unrolled chain, and two chain lengths
           (CH and 2*CH) cancel the per-dispatch overhead:
           stage = (t_2CH - t_CH)/CH.

Env knobs: FHE_BENCH_N/L/M/B/ITERS, FHE_BENCH_CHAIN (eval mode).
Consolidates the r1-r3 one-off profilers (profile_mul{,2,3,4}, profile_mule{,2}).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fhe_study_tpu.models import bfv_rns as R  # noqa: E402
from fhe_study_tpu.ops import modops32, ntt as ntt_mod  # noqa: E402
from fhe_study_tpu.utils import compile_cache, prng  # noqa: E402

compile_cache.configure()

MODE = sys.argv[1] if len(sys.argv) > 1 else "eval"
n = int(os.environ.get("FHE_BENCH_N", 1 << 14))
L = int(os.environ.get("FHE_BENCH_L", 4))
M = int(os.environ.get("FHE_BENCH_M", 5))
B = int(os.environ.get("FHE_BENCH_B", 64))
CH = int(os.environ.get("FHE_BENCH_CHAIN", 4))
ITERS = int(os.environ.get("FHE_BENCH_ITERS", 6 if MODE == "coeff" else 4))

param = R.RnsParam(n=n, t=256, L=L, M=M)
qs, ps = param.qs, param.ps
ks = prng.split(jax.random.PRNGKey(0), 6)
sk, pk = R.new_key(ks[0], param)
rlk = R.rlk_key(ks[1], param, sk)
m1 = prng.uniform_mod(ks[2], (B, n), param.t)
c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
c2 = R.encrypt(ks[5], param, pk, m1, batch=(B,))

Q = R._basis(qs).prod
qinvm = np.array([(pow(Q, -1, p) << 32) % p for p in ps], np.uint32)


def ext_sub_mul(w_q, w_p):
    """(w_P − ext(w_Q))·Q^{-1} over P: the first half of the BFV scaling."""
    pv, npv, _ = (jnp.asarray(c) for c in modops32.consts(ps, w_q.ndim))
    ext = R.fast_base_extend(w_q, qs, ps)
    return modops32.mont_mul(modops32.submod(w_p, ext, pv),
                             jnp.asarray(qinvm).reshape(pv.shape), pv, npv)


def run_coeff():
    x4 = jnp.stack([c1.c0, c1.c1, c2.c0, c2.c1], 1).astype(jnp.uint32)
    xM3 = jnp.concatenate([c1.c0, c1.c0[:1]], 0)[:M, :, None, :].astype(jnp.uint32)
    xM3 = jnp.broadcast_to(xM3 % jnp.asarray(
        np.array(ps, np.uint64)).astype(jnp.uint32).reshape(M, 1, 1, 1),
        (M, B, 3, n)) + jnp.uint32(0)          # [M,B,3,n] canonical mod p

    def timeit(f, x, iters=ITERS):
        jax.block_until_ready(f(x))
        t0 = time.perf_counter()
        y = x
        for _ in range(iters):
            y = f(y)
        jax.block_until_ready(y)
        return (time.perf_counter() - t0) / iters

    null = timeit(jax.jit(lambda a: a + jnp.uint32(1)), x4)
    print(f"null(x4 {x4.nbytes>>20} MB)        {null*1e3:8.3f} ms", flush=True)

    def secA(a):
        o = ntt_mod.tensor_mul4(a[:, 0], a[:, 1], a[:, 2], a[:, 3], qs,
                                scale=(param.t,) * L)           # [L,B,3,n]
        o4 = jnp.concatenate([o, o[:, :, :1]], 2)
        return jnp.moveaxis(o4, 2, 1)

    def secB(a):
        o = ntt_mod.tensor_mul4(a[:, 0], a[:, 1], a[:, 2], a[:, 3], ps,
                                scale=(param.t,) * M, src=qs)   # [M,B,3,n]
        o4 = jnp.concatenate([o[:L], o[:L, :, :1]], 2)
        return jnp.moveaxis(o4, 2, 1)

    def secC(a):
        w_q = jnp.moveaxis(a[:, :3], 1, 2)                       # [L,B,3,n]
        r_p = ext_sub_mul(w_q, xM3)
        o4 = jnp.concatenate([r_p[:L], r_p[:L, :, :1]], 2)
        return jnp.moveaxis(o4, 2, 1)

    def secD(a):
        r_p = jnp.concatenate([a[:, :3], a[:1, :3]], 0)          # [M,4->3..]
        r_p = jnp.moveaxis(r_p[:, :3], 1, 2)                     # [M,B,3,n]
        out3 = R.fast_base_extend(r_p, ps, qs, centered=True)    # [L,B,3,n]
        o4 = jnp.concatenate([out3, out3[:, :, :1]], 2)
        return jnp.moveaxis(o4, 2, 1)

    def secE(a):
        r0, r1 = ntt_mod.ks_fused_multi(a[:, 2], rlk.b, rlk.a, qs, qs)
        return jnp.stack([r0, r1, r0, r1], 1)

    def secF(a):
        qv = ntt_mod._qvec(qs, 3)
        r0 = ntt_mod._addmod_v(a[:, 0].astype(jnp.uint64),
                               a[:, 1].astype(jnp.uint64), qv)
        r1 = ntt_mod._addmod_v(a[:, 2].astype(jnp.uint64),
                               a[:, 3].astype(jnp.uint64), qv)
        return jnp.stack([r0, r1, r0, r1], 1).astype(jnp.uint32)

    def secG(a):
        o = R.mul(param, rlk, R.CT(a[:, 0], a[:, 1]), R.CT(a[:, 2], a[:, 3]))
        return jnp.stack([o.c0, o.c1, o.c0, o.c1], 1).astype(jnp.uint32)

    cases = [("A tensor Q", secA), ("B tensor P+ext", secB),
             ("C ext wq->P +sub", secC), ("D ext rp->Q centered", secD),
             ("E relin ks_fused", secE), ("F u64 lift+adds", secF),
             ("G mul full", secG)]
    tot = 0.0
    for name, f in cases:
        try:
            dt = timeit(jax.jit(f), x4) - null
            if not name.startswith("G"):
                tot += dt
            print(f"{name:28s} {dt*1e3:8.3f} ms", flush=True)
        except Exception as e:
            print(f"{name:28s} FAIL {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
    print(f"{'sum A..F':28s} {tot*1e3:8.3f} ms", flush=True)
    print(f"per ct-mul at sum: {B / tot:.0f}/s" if tot else "", flush=True)


def run_eval():
    e1_ = R.to_evals(param, c1)
    e2_ = R.to_evals(param, c2)
    x4 = jnp.stack([e1_.e0q, e1_.e1q, e2_.e0q, e2_.e1q], 1).astype(jnp.uint32)
    xP0 = jnp.stack([e1_.e0p, e1_.e1p, e2_.e0p, e2_.e1p], 1
                    ).astype(jnp.uint32)

    def pad_to4(o):
        o4 = jnp.concatenate([o[:L], o[:L, :, :1]], 2)
        return jnp.moveaxis(o4, 2, 1)

    def secA(a):
        o = ntt_mod.tensor_eval4(a[:, 0], a[:, 1], a[:, 2], a[:, 3], qs,
                                 scale=(param.t,) * L)          # [L,B,3,n]
        return pad_to4(o)

    def secB(a):
        # perturb by a so the chain is value-dependent (cache-proof)
        xPv = (xP0 + a[:1, :, :1, :1]) % jnp.uint32(3) + xP0
        o = ntt_mod.tensor_eval4(xPv[:, 0] % jnp.uint32(ps[0] - 2),
                                 xPv[:, 1] % jnp.uint32(ps[1] - 2),
                                 xPv[:, 2] % jnp.uint32(ps[2] - 2),
                                 xPv[:, 3] % jnp.uint32(ps[3] - 2), ps,
                                 scale=(param.t,) * M)          # [M,B,3,n]
        return pad_to4(o)

    def secC(a):
        w_q = jnp.moveaxis(a[:, :3], 1, 2)                      # [L,B,3,n]
        w_p = jnp.moveaxis(jnp.concatenate(
            [xP0[:, :3], xP0[:1, :3]], 0)[:M, :3], 1, 2) % jnp.uint32(3)
        w_p = w_p + jnp.uint32(1)
        r_p = ext_sub_mul(w_q, w_p)
        return pad_to4(r_p)

    def secD(a):
        r_p = jnp.concatenate([a[:, :3], a[:1, :3]], 0)[:M]
        r_p = jnp.moveaxis(r_p, 1, 2)                           # [M,B,3,n]
        out3 = R.fast_base_extend(r_p, ps, qs, centered=True)   # [L,B,3,n]
        return pad_to4(out3).astype(jnp.uint32)

    def secE(a):
        e0, e1x, r0, r1 = ntt_mod.ks_fused_eval(
            a[:, 2], rlk.b, rlk.a, qs, qs, adds=(a[:, 0], a[:, 1]))
        return jnp.stack([e0, e1x, r0.astype(jnp.uint32),
                          r1.astype(jnp.uint32)], 1)

    def secF(a):
        ep = ntt_mod.ext_ntt(jnp.stack([a[:, 0], a[:, 1]], axis=-2), qs, ps)
        return pad_to4(jnp.concatenate([ep, ep[..., :1, :]], -2))

    def secG(a):
        o = R.mul_e(param, rlk, R.CTE(a[:, 0], a[:, 1], xP0[:, 0], xP0[:, 1]),
                    R.CTE(a[:, 2], a[:, 3], xP0[:, 2], xP0[:, 3]))
        return jnp.stack([o.e0q, o.e1q, o.e0q, o.e1q], 1)

    def chain(f, k):
        def run(a):
            for _ in range(k):
                a = f(a)
            return a
        return jax.jit(run)

    def timed(fj, x):
        y = jax.block_until_ready(fj(x))    # compile + warm
        t0 = time.perf_counter()
        for _ in range(ITERS):
            y = fj(y)
        jax.block_until_ready(y)
        return (time.perf_counter() - t0) / ITERS

    cases = [("A tensor_eval4 Q", secA), ("B tensor_eval4 P", secB),
             ("C ext wq->P +sub", secC), ("D ext rp->Q centered", secD),
             ("E relin ks_fused_eval", secE), ("F ext_ntt Q->P re-entry", secF),
             ("G mul_e full", secG)]
    tot = 0.0
    for name, f in cases:
        try:
            t1 = timed(chain(f, CH), x4)
            t2 = timed(chain(f, 2 * CH), x4)
            dt = (t2 - t1) / CH
            if not name.startswith("G"):
                tot += dt
            print(f"{name:28s} {dt*1e3:8.3f} ms   "
                  f"(dispatch~{(2*t1-t2)*1e3:.2f})", flush=True)
        except Exception as e:
            print(f"{name:28s} FAIL {type(e).__name__}: {str(e)[:160]}",
                  flush=True)
    print(f"{'sum A..F':28s} {tot*1e3:8.3f} ms", flush=True)
    if tot:
        print(f"per ct-mul at sum: {B / tot:.0f}/s", flush=True)


if MODE == "coeff":
    run_coeff()
elif MODE == "eval":
    run_eval()
else:
    sys.exit(f"unknown mode {MODE!r}: use coeff|eval")
