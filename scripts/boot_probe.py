"""CKKS-bootstrap probe tool: end-to-end precision, per-stage precision,
and serialized-HLO sizes, at any ring size.

Usage: python scripts/boot_probe.py <e2e|stages|hlo> [n_log2] [B]
       (JAX_PLATFORMS=cpu to probe on the CPU)

  e2e    — run the staged bootstrap end-to-end and print refreshed bits
           (-log2 of max slot error) + wall times; discriminates a
           kernel bug from a pipeline/parameter problem (the e2e
           tests only cover n=32).
  stages — decrypt after C2S (w accuracy) and after EvalMod (sin accuracy)
           against exact ground truth derived from the secret key:
           localizes which stage loses the refreshed bits.
  hlo    — lower (never compile) each stage jit and print the serialized
           HLO module-proto size (compile time grows with it).

Env knobs (all optional): BOOT_L, BOOT_DELTA0 (absolute, e.g. 3.6e16),
BOOT_DW (log2 delta_w), BOOT_DEG, BOOT_K, BOOT_R, BOOT_ARCSIN, BOOT_H,
BOOT_BASE, BOOT_DROPS.
Consolidates the r2-r3 one-off probes (check_boot_*, debug_boot_*,
boot_precision, measure_boot_hlo, debug_ckks_boot).
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fhe_study_tpu.models.ckks import bootstrap as BB  # noqa: E402
from fhe_study_tpu.models.ckks import ckks_rns as C  # noqa: E402
from fhe_study_tpu.models.ckks import poly as P  # noqa: E402
from fhe_study_tpu.utils import prng  # noqa: E402


def setup(nlog, B):
    """Build the bench-config pipeline (keys, staged jits) at ring 2^nlog."""
    n = 1 << nlog
    delta0 = float(os.environ.get("BOOT_DELTA0", 2.0 ** 45))
    delta_w = 2.0 ** float(os.environ.get("BOOT_DW", 60))
    deg = int(os.environ.get("BOOT_DEG", 30))
    arcsin_terms = int(os.environ.get("BOOT_ARCSIN", 3))
    base = int(os.environ.get("BOOT_BASE", 2))
    h = int(os.environ.get("BOOT_H", 64))
    drops = os.environ.get("BOOT_DROPS")
    drops = None if drops is None else int(drops)
    K, r = BB.suggest_K_r(n, h)
    K = int(os.environ.get("BOOT_K", K))
    r = int(os.environ.get("BOOT_R", r))
    L = int(os.environ.get("BOOT_L", 28 + 2 * r))
    print(f"n={n} L={L} K={K} r={r} B={B} delta0=2^{math.log2(delta0):.1f}",
          flush=True)
    param = C.Param(n=n, L=L, delta=delta0)
    ks = prng.split(jax.random.PRNGKey(0), 3)
    sk, pk = C.new_key(ks[0], param, h=h)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, (B, n // 2))
    ct = C.encrypt(ks[1], param, pk,
                   C.encode(param, jnp.asarray(z), jnp.zeros_like(z)),
                   batch=(B,))
    ct1, _ = P.level_drop(param, ct, base)
    t0 = time.time()
    arrays, static, pout = BB.precompute_keys(
        ks[2], param, sk, delta0, batch=(B,), K=K, r=r, deg=deg,
        delta_w=delta_w, arcsin_terms=arcsin_terms, s2c_drops=drops,
        base_limbs=base)
    nbytes = sum(x.nbytes for x in jax.tree.leaves(arrays))
    print(f"keys in {time.time()-t0:.0f}s  ({nbytes/2**30:.2f} GiB sk-free "
          f"pytree)", flush=True)
    run = BB.make_staged(param, static, delta0, K=K, r=r, deg=deg,
                         delta_w=delta_w, arcsin_terms=arcsin_terms,
                         s2c_drops=drops, base_limbs=base)
    cfg = dict(n=n, L=L, K=K, r=r, delta0=delta0, delta_w=delta_w, z=z)
    return param, sk, ct1, arrays, static, pout, run, cfg


def cmd_e2e(nlog, B):
    param, sk, ct1, arrays, static, pout, run, cfg = setup(nlog, B)
    t0 = time.time()
    out, pout2 = run(arrays, ct1.c0, ct1.c1)
    jax.block_until_ready(out.c0)
    print(f"bootstrap in {time.time()-t0:.1f}s  pout: L={pout2.L} "
          f"delta=2^{math.log2(pout2.delta):.2f}", flush=True)
    rr, _ = C.decode(pout2, C.decrypt_to_coeffs(pout2, sk, out, crt_limbs=3))
    err = np.abs(np.asarray(rr) - cfg["z"]).max()
    print(f"max err = {err:.3e}  ({-np.log2(err):.1f} refreshed bits; "
          f"bench gate = 2^-18)", flush=True)


def cmd_stages(nlog, B):
    param, sk, ct1, arrays, static, pout, run, cfg = setup(nlog, B)
    n, L, K, r = cfg["n"], cfg["L"], cfg["K"], cfg["r"]
    delta_w = cfg["delta_w"]
    j1, j2, j3 = run.jits

    # ground truth: raw raised phase t (exact to f64 ~2^10 abs at 2^63)
    qs = param.qs
    Q0 = qs[0] * qs[1]
    raised = BB.mod_raise2(param, ct1)
    p_unit = C.Param(n=n, L=L, delta=1.0)
    t_true = np.asarray(C.decrypt_to_coeffs(p_unit, sk, raised,
                                            crt_limbs=3))[0]
    vmax = (2 * math.pi * (K + 0.5) + math.pi / 2) / (1 << r)
    w_true = (2 * math.pi * t_true / Q0 - math.pi / 2) / ((1 << r) * vmax)
    print(f"|I| max = {np.max(np.abs(np.round(t_true / Q0))):.0f} (K={K})",
          flush=True)

    a0, a1, b0, b1 = j1(arrays, ct1.c0, ct1.c1)
    p1 = C.Param(n=n, L=L - 2, delta=delta_w)
    # half 1 slots hold w for coeffs [0, n/2), half 2 for [n/2, n)
    w1 = np.asarray(C.decode(p1, C.decrypt_to_coeffs(p1, sk, C.CT(a0, a1),
                                                     crt_limbs=3))[0])[0]
    w2 = np.asarray(C.decode(p1, C.decrypt_to_coeffs(p1, sk, C.CT(b0, b1),
                                                     crt_limbs=3))[0])[0]
    w_got = np.concatenate([w1, w2])
    e_c2s = np.abs(w_got - w_true).max()
    print(f"C2S:     max |w err| = {e_c2s:.3e} ({-np.log2(e_c2s):.1f} bits)",
          flush=True)

    s_true = np.sin(((1 << r) * vmax) * w_true + math.pi / 2)  # sin(2pi t/Q0)
    o1 = j2(arrays, a0, a1)
    o2 = j2(arrays, b0, b1)
    out, pout2 = run(arrays, ct1.c0, ct1.c1)
    rr, _ = C.decode(pout2, C.decrypt_to_coeffs(pout2, sk, out, crt_limbs=3))
    e_final = np.abs(np.asarray(rr)[0] - cfg["z"][0]).max()
    print(f"final:   max err = {e_final:.3e} ({-np.log2(e_final):.1f} bits)",
          flush=True)
    # EvalMod check at the level the arrays say; scale-calibrate (delta
    # after the ladder may differ from delta_w by exact bookkeeping)
    Lm = int(o1[0].shape[0])
    pm = C.Param(n=n, L=Lm, delta=delta_w)
    m1 = np.asarray(C.decode(pm, C.decrypt_to_coeffs(
        pm, sk, C.CT(*o1), crt_limbs=3))[0])[0]
    m2 = np.asarray(C.decode(pm, C.decrypt_to_coeffs(
        pm, sk, C.CT(*o2), crt_limbs=3))[0])[0]
    m_got = np.concatenate([m1, m2])
    denom = float(np.dot(m_got, m_got)) or 1.0
    c = float(np.dot(s_true, m_got) / denom)
    e_mod = np.abs(c * m_got - s_true).max()
    print(f"EvalMod: max |sin err| = {e_mod:.3e} ({-np.log2(e_mod):.1f} "
          f"bits; scale fit {c:.3e})", flush=True)


def cmd_hlo(nlog, B):
    param, sk, ct1, arrays, static, pout, run, cfg = setup(nlog, B)
    j1, j2, j3 = run.jits
    specs = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), arrays)
    c0s = jax.ShapeDtypeStruct(ct1.c0.shape, ct1.c0.dtype)

    def report(name, lowered):
        proto = lowered.compiler_ir("hlo").as_serialized_hlo_module_proto()
        print(f"{name}: hlo_proto={len(proto)/2**20:.1f} MiB", flush=True)

    t0 = time.time()
    o1 = jax.eval_shape(j1, specs, c0s, c0s)       # populates cell["p1"]
    report("j1 (ModRaise+C2S)", j1.lower(specs, c0s, c0s))
    print(f"  lower {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    o2 = jax.eval_shape(j2, specs, o1[0], o1[1])   # populates cell["p2"]
    report("j2 (EvalMod)", j2.lower(specs, o1[0], o1[1]))
    print(f"  lower {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    report("j3 (S2C)", j3.lower(specs, o2[0], o2[1], o2[0], o2[1]))
    print(f"  lower {time.time()-t0:.0f}s", flush=True)


def main():
    cmds = {"e2e": cmd_e2e, "stages": cmd_stages, "hlo": cmd_hlo}
    cmd = sys.argv[1] if len(sys.argv) > 1 else "e2e"
    if cmd not in cmds:
        sys.exit(f"unknown command {cmd!r}: use {'|'.join(cmds)}")
    nlog = int(sys.argv[2]) if len(sys.argv) > 2 else 11
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    cmds[cmd](nlog, B)


if __name__ == "__main__":
    main()
