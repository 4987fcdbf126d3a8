"""Multi-chip execution: mesh factoring + the full sharded ct-mul step.

Parallelism axes exercised (SURVEY §2.6 mapping):
  dp — ciphertext batch (pure data parallel)
  ep — CRT/RNS prime axis of the BFV tensor (limb parallel; all_gather)
  sp — polynomial coefficient axis (four-step NTT; all_to_all)
  tp — key-switch gadget axis k_src (partial gadget products; psum)

Pipeline parallelism (pp) is deliberately NOT used: the FHE op graph is a
short chain of large data-parallel ops with no weight-stationary stages —
staging it across device groups would only add bubble overhead (documented
decision per SURVEY §2.6).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..arith import rq
from ..arith.ring import ring_for
from ..ops import modops, ntt
from ..models import bfv
from ..models.gfhe import glwe as G
from ..utils import prng
from . import ntt_sharded

U64 = jnp.uint64


def factor_mesh(n_devices: int) -> Mesh:
    """Factor n_devices into a (dp, ep, sp, tp) mesh.  Powers of two feed the
    ep/sp/tp axes first (they need >= 2 to exercise collectives), the
    remainder goes to dp."""
    sizes = {"dp": 1, "ep": 1, "sp": 1, "tp": 1}
    rem = n_devices
    for axis in ("ep", "sp", "tp"):
        if rem % 2 == 0 and rem >= 2:
            sizes[axis] = 2
            rem //= 2
    sizes["dp"] = rem
    devs = np.array(jax.devices()[:n_devices]).reshape(
        sizes["dp"], sizes["ep"], sizes["sp"], sizes["tp"])
    return Mesh(devs, axis_names=("dp", "ep", "sp", "tp"))


# -- ep: CRT prime pair sharded over devices --------------------------------

def polymul_i64_crt_ep(a, b, mesh: Mesh):
    """Exact signed negacyclic product; the two CRT primes run on separate
    `ep` devices, reconstruction all_gathers the residues."""
    p1, p2 = ntt.CRT_PRIMES[:2]
    if mesh.shape["ep"] == 1:
        return ntt.polymul_i64_crt(a, b)

    def local(a, b):
        i = jax.lax.axis_index("ep")
        r1 = ntt.negacyclic_mul(modops.coerce_i64(a, p1),
                                modops.coerce_i64(b, p1), p1)
        r2 = ntt.negacyclic_mul(modops.coerce_i64(a, p2),
                                modops.coerce_i64(b, p2), p2)
        mine = jnp.where(i == 0, r1, r2)
        both = jax.lax.all_gather(mine, "ep")          # [2, ..., n]
        rr1, rr2 = both[0], both[1]
        p1_inv_p2 = pow(p1, -1, p2)
        d = modops.mulmod(modops.submod(rr2, rr1 % U64(p2), p2),
                          U64(p1_inv_p2), p2)
        v = (rr1 + U64(p1) * d).astype(jnp.int64)
        m = p1 * p2
        return jnp.where(v > m // 2, v - jnp.int64(m), v)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P()), out_specs=P(),
        axis_names={"ep"}, check_vma=False,
    )(a, b)


# -- tp: key-switch gadget contraction with psum ----------------------------

def key_switch_tp(param: G.Param, beta: int, l: int, ksk: G.KSK, ct: G.GLWE,
                  mesh: Mesh) -> G.GLWE:
    """GLWE key switch with the k_src gadget axis sharded over `tp`:
    each device contracts its slice of the KSK, partial GLWEs psum over tp."""
    ring = ring_for(param.ring)
    k, n = param.k, param.ring.n
    d = ring.decompose(ct.a, beta, l)       # [l, ..., k_src, n]
    d = jnp.moveaxis(d, 0, -2)              # [..., k_src, l, n]
    batch = ct.b.shape[:-1]

    def local(d_loc, ka_loc, kb_loc):
        ks_loc = d_loc.shape[-3]
        M = ks_loc * l
        d_flat = d_loc.reshape(batch + (M, n))
        rhs_b = ring.contract(kb_loc.reshape(batch + (M, n)), d_flat)
        ka = ka_loc.reshape(batch + (M, k, n))
        rhs_a = ring.contract(jnp.moveaxis(ka, -2, 0), d_flat)
        rhs_a = jnp.moveaxis(rhs_a, 0, -2)
        # partial sums over the sharded k_src axis -> psum (mod-q correction
        # after the raw u64 sum: each partial is already reduced mod q)
        rhs_a = jax.lax.psum(rhs_a, "tp")
        rhs_b = jax.lax.psum(rhs_b, "tp")
        return rhs_a, rhs_b

    nb = len(batch)
    spec_d = P(*([None] * nb), "tp", None, None)
    spec_ka = P(*([None] * nb), "tp", None, None, None)
    spec_kb = P(*([None] * nb), "tp", None, None)
    rhs_a, rhs_b = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec_d, spec_ka, spec_kb),
        out_specs=(P(), P()), axis_names={"tp"}, check_vma=False,
    )(d, ksk.a, ksk.b)
    # psum over u64 partials then reduce mod q
    rhs_a = modops.coerce_u64(rhs_a, param.ring.q)
    rhs_b = modops.coerce_u64(rhs_b, param.ring.q)
    zero_a = ring.zeros(batch + (k,))
    return G.GLWE(a=ring.sub(zero_a, rhs_a), b=ring.sub(ct.b, rhs_b))


# -- the full multi-chip step ----------------------------------------------

def multichip_ct_mul_step(mesh: Mesh, param: bfv.Param, ks_param: G.Param,
                          beta: int, l: int):
    """Returns a jitted function running, across the mesh:
       dp: batched BFV ct×ct multiply + relinearization (fast path)
       ep: one CRT-pair product of the tensor on separate devices
       sp: one four-step-sharded polynomial product
       tp: a GLWE key switch with psum'd gadget partials
    """
    q, n = param.ring.q, param.ring.n

    def step(c1, c2, rlk, ksk, glwe_ct):
        out = bfv.mul(param, rlk, bfv.RLWE(*c1), bfv.RLWE(*c2), fast=True)
        ep_prod = polymul_i64_crt_ep(
            c1[0].astype(jnp.int64)[0], c2[0].astype(jnp.int64)[0], mesh)
        sp_prod = ntt_sharded.negacyclic_mul_sharded(
            c1[0][0], c2[0][0], q, mesh, axis="sp")
        ks_out = key_switch_tp(ks_param, beta, l, ksk, glwe_ct, mesh)
        return out, ep_prod, sp_prod, ks_out

    return jax.jit(step)


def dryrun_rns(mesh: Mesh, n: int = 4096):
    """RNS-BFV ct-mul with the limb axis sharded over `ep` and the batch
    over `dp` — the headline path on a (dp, ep, sp, tp) mesh: bit-equal to
    the same multiply on one device, and decrypt-verified."""
    from ..models import bfv_rns as R
    param = R.RnsParam(n=n, t=16, L=4, M=5)
    B = max(mesh.shape["dp"], 2)
    ks = prng.split(jax.random.PRNGKey(1), 6)
    sk, pk = R.new_key(ks[0], param)
    rlk = R.rlk_key(ks[1], param, sk)
    m1 = prng.uniform_mod(ks[2], (B, param.n), param.t)
    m2 = prng.uniform_mod(ks[3], (B, param.n), param.t)
    c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[5], param, pk, m2, batch=(B,))
    one = jax.jit(lambda a, b: R.mul(param, rlk, a, b))(c1, c2)
    sh = NamedSharding(mesh, P("ep", "dp", None))          # [L, B, n]
    s1 = R.CT(*[jax.device_put(x, sh) for x in c1])
    s2 = R.CT(*[jax.device_put(x, sh) for x in c2])
    f = jax.jit(lambda a, b: R.mul(param, rlk, a, b))
    out = jax.block_until_ready(f(s1, s2))
    import time as _time
    t0 = _time.perf_counter()
    jax.block_until_ready(f(s1, s2))
    print(f"[dryrun] mesh={dict(mesh.shape)} RNS ct-mul (ep x dp, n={n}): "
          f"{(_time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    assert all((np.asarray(a) == np.asarray(b)).all()
               for a, b in zip(out, one)), \
        "limb-sharded RNS ct-mul differs from the one-device result"
    rec = np.asarray(R.decrypt(param, sk, out))
    want = np.asarray(modops.coerce_i64(ntt.polymul_i64_crt(
        m1.astype(jnp.int64), m2.astype(jnp.int64)), param.t))
    assert (rec == want).all(), "RNS limb-sharded ct-mul decrypts wrong"


def dryrun_sp(mesh: Mesh, n: int = 4096):
    """Four-step NTT product with the coefficient axis sharded over `sp`,
    bit-equal to the one-device negacyclic product."""
    from ..ops.primes import ntt_primes
    q = ntt_primes(1, 30, 1 << 16)[0]
    a = prng.uniform_mod(jax.random.PRNGKey(2), (n,), q)
    b = prng.uniform_mod(jax.random.PRNGKey(3), (n,), q)
    got = ntt_sharded.negacyclic_mul_sharded(a, b, q, mesh, axis="sp")
    want = rq.mul(a, b, q)
    assert (np.asarray(got) == np.asarray(want)).all(), \
        "sp-sharded four-step NTT product differs from one device"


def dryrun_hybrid(n_devices: int):
    """The multi-host code path, simulated in one process: a 2-level
    (across x within processes) mesh with the process factor feeding dp
    (see parallel/distributed.py), running (a) the RNS ct-mul with
    ep-sharded limbs at N=2^12 and (b) the four-step sp-sharded NTT at
    N=2^12 — bit-equal to single-device."""
    from . import distributed
    if n_devices % 4 or n_devices < 4:
        return  # hybrid factorizations need a multiple of 4 devices
    dryrun_rns(distributed.hybrid_mesh(ici={"ep": 2}, simulate_hosts=2))
    dryrun_sp(distributed.hybrid_mesh(ici={"sp": 2}, simulate_hosts=2))


def dryrun_bootstrap(mesh: Mesh):
    """TFHE blind rotation under the mesh at the PRODUCTION ring (N=1024,
    k=1, the reference's own bootstrap ring): ciphertext batch dp-sharded,
    the Fourier-BSK's TGGSW digit-row axis tp-sharded — in production TFHE
    the BSK is the multi-GB object, so its storage shards across devices and
    GSPMD inserts the per-step gather/psum over tp.  Short chain
    (n_lwe=32) keeps the virtual-CPU-mesh dryrun fast; the sharded run is
    asserted BIT-EQUAL to the unsharded chain and decrypt-exact on every
    message: the bootstrap pipeline certifies under the same mesh as the
    BFV slice."""
    from ..arith.params import RingParam as RP, TORUS_Q
    from ..models.gfhe.glwe import Param as TParam, ERR_SIGMA
    from ..models.tfhe import tlwe, tglwe, bootstrap
    n, t, n_lwe = 1024, 8, 32
    beta, l = 4096, 2
    beta_ks, l_ks = 16, 8
    param = TParam(ERR_SIGMA, RP(TORUS_Q, n), 1, t)
    B = max(mesh.shape["dp"] * 2, 2)
    ks = prng.split(jax.random.PRNGKey(11), 3)
    table = bootstrap.compute_lookup_table_standard(param)
    s, _ = tglwe.new_key(ks[0], param)
    s_flat = tglwe.sk_to_tlwe(s)
    sbtk = bootstrap.new_short_bootstrapping_key(
        ks[1], param, s, n_lwe=n_lwe, beta=beta, l=l,
        beta_ks=beta_ks, l_ks=l_ks)
    gev = bootstrap.precompute_short_btk_evals(param, sbtk)
    m = jnp.arange(B, dtype=jnp.uint64) % jnp.uint64(t // 2)
    c = tlwe.encrypt_uniform(ks[2], param.lwe(), s_flat,
                             tlwe.encode(param, m), batch=(B,))

    def f(ca, cb, sb, ev):
        out = bootstrap.bootstrap_short(param, sb, table, tlwe.TLWE(ca, cb),
                                        beta=beta, l=l, beta_ks=beta_ks,
                                        l_ks=l_ks, btk_evals=ev)
        return out.a, out.b

    want_a, want_b = jax.jit(f)(c.a, c.b, sbtk, gev)   # unsharded reference
    dp = NamedSharding(mesh, P("dp"))
    tp_row = NamedSharding(mesh, P(None, "tp"))        # [n_lwe, r, ...] axis 1
    ca = jax.device_put(c.a, dp)
    cb = jax.device_put(c.b, dp)
    ev_sh = type(gev)(*[jax.device_put(x, tp_row) for x in gev])
    got_a, got_b = jax.jit(f)(ca, cb, sbtk, ev_sh)
    jax.block_until_ready((got_a, got_b))
    assert (np.asarray(got_a) == np.asarray(want_a)).all() and \
        (np.asarray(got_b) == np.asarray(want_b)).all(), \
        "dp x tp sharded blind rotation diverged from unsharded"
    rec = tlwe.decode(param, tlwe.decrypt(param.lwe(), s_flat,
                                          tlwe.TLWE(got_a, got_b)))
    assert (np.asarray(rec) == np.asarray(m)).all(), \
        "sharded bootstrap decrypts wrong"
    print(f"[dryrun] mesh={dict(mesh.shape)} TFHE blind-rotate "
          f"(dp batch x tp BSK rows, N={n}): bit-equal + decrypt ok",
          flush=True)


def dryrun_ckks(mesh: Mesh, n: int = 4096):
    """CKKS Galois rotation (hybrid key switch) + rescale at production
    ring size under the mesh: batch dp-sharded, the hybrid Galois key's
    gadget-row axis tp-sharded (key storage sharded across chips — the
    rotation-key set is the HBM-binding object in CKKS bootstrapping).
    Sharded run asserted bit-equal to unsharded + decode-accurate."""
    from ..models.ckks import ckks_rns as C
    from ..models import hybrid_ks, galois
    # L=4: the hybrid key's gadget-row axis (= L) must divide over tp
    param = C.Param(n=n, L=4, delta=2.0 ** 28)
    B = max(mesh.shape["dp"], 2)
    ks = prng.split(jax.random.PRNGKey(12), 4)
    sk, pk = C.new_key(ks[0], param)
    g = galois.rotation_element(n, 1)        # rotate slots by one
    hgk = hybrid_ks.galois_key_hybrid(ks[1], param, sk, g)
    hrlk = C.hybrid_rlk(ks[3], param, sk)    # replicated (1-row relin key)
    rng = np.random.default_rng(5)
    z = rng.uniform(-1, 1, (B, n // 2))
    ct = C.encrypt(ks[2], param, pk,
                   C.encode(param, jnp.asarray(z), jnp.zeros_like(z)),
                   batch=(B,))

    def f(c0, c1, hb, ha, rb, ra):
        rot = hybrid_ks.rotate_hybrid(param, hybrid_ks.HybridKSK(hb, ha),
                                      C.CT(c0, c1), g)
        out = C.mul_hybrid(param, type(hrlk)(rb, ra), rot, rot)[0]
        return out[0], out[1]

    want = jax.jit(f)(ct.c0, ct.c1, hgk.b, hgk.a, hrlk.b, hrlk.a)
    dp = NamedSharding(mesh, P(None, "dp"))            # [L, B, n]
    tp_row = NamedSharding(mesh, P("tp"))              # [L_rows, L+K, n]
    c0 = jax.device_put(ct.c0, dp)
    c1 = jax.device_put(ct.c1, dp)
    hb = jax.device_put(hgk.b, tp_row)
    ha = jax.device_put(hgk.a, tp_row)
    got = jax.jit(f)(c0, c1, hb, ha, hrlk.b, hrlk.a)
    jax.block_until_ready(got)
    assert (np.asarray(got[0]) == np.asarray(want[0])).all() and \
        (np.asarray(got[1]) == np.asarray(want[1])).all(), \
        "dp x tp sharded CKKS rotate+mul+rescale diverged from unsharded"
    # mul_hybrid rescales: L-1 limbs at delta^2 / q_top
    p1 = C.Param(n=n, L=param.L - 1,
                 delta=param.delta ** 2 / param.qs[param.L - 1])
    rr, ri = C.decode(p1, C.decrypt_to_coeffs(p1, sk, C.CT(*got)))
    perm, conj = galois.ckks_slot_perm(n, g)
    want_slots = z[:, np.asarray(perm)] ** 2   # real inputs: conj no-op
    ok = np.allclose(np.asarray(rr), want_slots, atol=1e-2)
    assert ok, "sharded CKKS rotate+mul+rescale decodes wrong"
    print(f"[dryrun] mesh={dict(mesh.shape)} CKKS rotate+rescale "
          f"(dp batch x tp key rows, n={n}): bit-equal + decode ok",
          flush=True)


def dryrun(n_devices: int):
    """Compile + execute ONE full multi-chip step on tiny shapes, with real
    dp/ep/sp/tp shardings, on an n_devices mesh; then the 2-level
    (across x within processes) layout at production ring sizes, and the TFHE /
    CKKS bootstrap-pipeline stages (dp x tp) at production ring sizes."""
    mesh = factor_mesh(n_devices)
    from ..arith.params import RingParam
    q = 2 ** 16 + 1
    n = 64
    param = bfv.Param(RingParam(q, n), 2, q * q)
    ks_param = G.Param(G.ERR_SIGMA, RingParam(q, n), 4, 2)
    beta, l = 2, 8
    B = max(mesh.shape["dp"] * 2, 2)

    key = jax.random.PRNGKey(0)
    ks = prng.split(key, 8)
    sk, pk = bfv.new_key(ks[0], param, batch=(B,))
    rlk = bfv.rlk_key(ks[1], param, sk, batch=(B,))
    m = prng.uniform_mod(ks[2], (B, n), param.t)
    c1 = bfv.encrypt(ks[3], param, pk, m, batch=(B,))
    c2 = bfv.encrypt(ks[4], param, pk, m, batch=(B,))

    gsk, gpk = G.new_key(ks[5], ks_param)
    gsk2, _ = G.new_key(ks[6], ks_param)
    ksk = G.new_ksk(ks[7], ks_param, beta, l, gsk, gsk2)
    gct = G.encrypt_s(ks[5], ks_param, gsk, G.encode(ks_param, m[0] % ks_param.t))

    dp_sh = NamedSharding(mesh, P("dp"))
    c1 = jax.tree.map(lambda x: jax.device_put(x, dp_sh), tuple(c1))
    c2 = jax.tree.map(lambda x: jax.device_put(x, dp_sh), tuple(c2))

    step = multichip_ct_mul_step(mesh, param, ks_param, beta, l)
    out, ep_prod, sp_prod, ks_out = step(c1, c2, rlk, ksk, gct)
    jax.block_until_ready((out, ep_prod, sp_prod, ks_out))
    # per-axis step timing (execute-only, warm) — a coarse topology-
    # regression signal; printed, not asserted (CPU-backend timings are
    # indicative only)
    import time as _time
    t0 = _time.perf_counter()
    jax.block_until_ready(step(c1, c2, rlk, ksk, gct))
    print(f"[dryrun] mesh={dict(mesh.shape)} full step (dp+ep+sp+tp): "
          f"{(_time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    # sanity: the sharded step must be CORRECT, not just compile
    from ..arith import rn
    rec = np.asarray(bfv.decrypt(param, sk, out))
    want = np.asarray(rn.to_rq(
        rn.naive_poly_mul(m.astype(jnp.int64), m.astype(jnp.int64)),
        param.t, n))
    assert (rec == want).all(), "multichip BFV ct-mul decrypts wrong"
    sp_want = np.asarray(rq.mul(c1[0][0], c2[0][0], q))
    assert (np.asarray(sp_prod) == sp_want).all(), "sp-sharded NTT mismatch"
    ep_want = np.asarray(ntt.polymul_i64_crt(
        c1[0].astype(jnp.int64)[0], c2[0].astype(jnp.int64)[0]))
    assert (np.asarray(ep_prod) == ep_want).all(), "ep-sharded CRT mismatch"
    dryrun_hybrid(n_devices)
    dryrun_bootstrap(mesh)
    dryrun_ckks(mesh)
    return mesh
