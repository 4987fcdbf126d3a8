"""Worker process for the REAL multi-process jax.distributed test
(tests/test_distributed.py::test_two_process_distributed_ct_mul).

Launched twice by the test with JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
/ JAX_PROCESS_ID in the env (the exact production recipe of
parallel/distributed.py's module docstring), CPU backend with 4 virtual
devices per process -> an 8-device global runtime across 2 OS processes.

What it proves (SURVEY §2.6 comm tier):
  * distributed.initialize() brings up the coordination service for real
    (jax.process_count() == 2),
  * hybrid_mesh() builds the (dp, ep, sp, tp) mesh over devices owned by
    TWO processes, dp spanning the processes,
  * a dp-sharded RNS-BFV ct-mul (hybrid relin) compiles and executes SPMD
    across the processes, and each process decrypt-verifies its LOCAL
    batch shards,
  * a replicated-output reduction actually crosses processes (the all-reduce
    is the cross-process collective), checked against the host-computed
    value.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from fhe_study_tpu.models import bfv_rns as R  # noqa: E402
from fhe_study_tpu.parallel import distributed  # noqa: E402
from fhe_study_tpu.utils import prng  # noqa: E402
from fhe_study_tpu.arith import rn  # noqa: E402


def main():
    assert distributed.initialize(), "coordinator env not set?"
    pid = jax.process_index()
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8 and jax.local_device_count() == 4
    mesh = distributed.hybrid_mesh(ici={"ep": 1})
    assert mesh.shape == {"dp": 8, "ep": 1, "sp": 1, "tp": 1}, mesh.shape

    param = R.RnsParam(n=256, t=16, L=3, M=4)
    B = 8
    ks = prng.split(jax.random.PRNGKey(0), 6)
    # identical setup in both processes (same PRNG keys): every process
    # holds the full host-side batch, shards are assembled per-device
    sk, pk = R.new_key(ks[0], param)
    hk = R.hybrid_rlk1(ks[1], param, sk)
    m1 = prng.uniform_mod(ks[2], (B, param.n), param.t)
    m2 = prng.uniform_mod(ks[3], (B, param.n), param.t)
    c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[5], param, pk, m2, batch=(B,))

    dp_sh = NamedSharding(mesh, P(None, "dp", None))   # [L, B, n]
    rep_sh = NamedSharding(mesh, P())

    def put(a, sh):
        an = np.asarray(a)
        return jax.make_array_from_callback(an.shape, sh,
                                            lambda idx: an[idx])

    c1s = R.CT(put(c1.c0, dp_sh), put(c1.c1, dp_sh))
    c2s = R.CT(put(c2.c0, dp_sh), put(c2.c1, dp_sh))
    kb, ka = put(hk.b, rep_sh), put(hk.a, rep_sh)

    step = jax.jit(lambda a0, a1, b0, b1, b_, a_: R.mul(
        param, R.HRLK(b_, a_), R.CT(a0, a1), R.CT(b0, b1)))
    out = step(c1s.c0, c1s.c1, c2s.c0, c2s.c1, kb, ka)
    jax.block_until_ready(out)

    # decrypt-verify the LOCAL shards only (each process owns 4 of the 8
    # dp rows); expected product computed host-side
    want = np.asarray(rn.to_rq(rn.naive_poly_mul(
        m1.astype(jnp.int64), m2.astype(jnp.int64)), param.t, param.n))
    shards0 = {s.index[1].start: np.asarray(s.data)
               for s in out.c0.addressable_shards}
    shards1 = {s.index[1].start: np.asarray(s.data)
               for s in out.c1.addressable_shards}
    assert len(shards0) == 4, sorted(shards0)
    for b0, d0 in shards0.items():
        ct_loc = R.CT(jnp.asarray(d0), jnp.asarray(shards1[b0]))
        rec = np.asarray(R.decrypt(param, sk, ct_loc))[0]
        assert (rec == want[b0]).all(), f"row {b0} decrypt mismatch"

    # a collective that genuinely crosses the two processes: replicated sum
    tot = jax.jit(lambda x: jnp.sum(x.astype(jnp.float64)),
                  out_shardings=rep_sh)(c1s.c0)
    assert float(tot) == float(np.asarray(c1.c0, np.float64).sum())

    print(f"DIST2PROC OK p{pid}", flush=True)

    # ---- phase 2: ep SPANNING the process boundary -------------------------
    # dcn_axis="ep": the RNS limb axis crosses the processes, so the base-
    # extension limb all_gathers inside R.mul are REAL cross-process
    # collectives (not just the replicated all-reduce above).  dp=4 stays
    # within each process.
    mesh2 = distributed.hybrid_mesh(ici={"ep": 1}, dcn_axis="ep")
    assert mesh2.shape == {"dp": 4, "ep": 2, "sp": 1, "tp": 1}, mesh2.shape
    # every (dp, ep) mesh entry pairs devices from BOTH processes along ep
    procs = np.vectorize(lambda d: d.process_index)(mesh2.devices)
    assert (procs[:, 0, 0, 0] != procs[:, 1, 0, 0]).all(), \
        "ep axis does not span the two processes"

    B2 = 4
    m1b, m2b = m1[:B2], m2[:B2]
    # L=4 limbs so the limb axis divides ep=2 (phase 1's L=3 doesn't)
    param4 = R.RnsParam(n=256, t=16, L=4, M=5)
    ep_sh = NamedSharding(mesh2, P("ep", "dp", None))      # [L, B2, n]
    sk4, pk4 = R.new_key(ks[0], param4)
    hk4 = R.hybrid_rlk1(ks[1], param4, sk4)
    c1f = R.encrypt(ks[4], param4, pk4, m1b, batch=(B2,))
    c2f = R.encrypt(ks[5], param4, pk4, m2b, batch=(B2,))

    def put2(a, sh):
        an = np.asarray(a)
        return jax.make_array_from_callback(an.shape, sh,
                                            lambda idx: an[idx])

    rep2 = NamedSharding(mesh2, P())
    c1e = R.CT(put2(c1f.c0, ep_sh), put2(c1f.c1, ep_sh))
    c2e = R.CT(put2(c2f.c0, ep_sh), put2(c2f.c1, ep_sh))
    kb2, ka2 = put2(hk4.b, rep2), put2(hk4.a, rep2)
    step2 = jax.jit(lambda a0, a1, b0, b1, b_, a_: R.mul(
        param4, R.HRLK(b_, a_), R.CT(a0, a1), R.CT(b0, b1)))
    out2 = step2(c1e.c0, c1e.c1, c2e.c0, c2e.c1, kb2, ka2)
    jax.block_until_ready(out2)
    # decrypt-verify from the locally addressable limb shards: each process
    # owns limbs for ALL batch rows (dp within-process, ep across), so a
    # full decrypt needs the gathered output — jit with replicated output
    # forces the cross-process all_gather of the product's limb shards
    gather = jax.jit(lambda a, b: (a + jnp.uint64(0), b + jnp.uint64(0)),
                     out_shardings=(rep2, rep2))
    g0, g1 = gather(out2.c0, out2.c1)
    rec2 = np.asarray(R.decrypt(param4, sk4, R.CT(jnp.asarray(g0),
                                                  jnp.asarray(g1))))
    want2 = np.asarray(rn.to_rq(rn.naive_poly_mul(
        m1b.astype(jnp.int64), m2b.astype(jnp.int64)), param4.t, param4.n))
    assert (rec2 == want2).all(), "ep-spanning ct-mul decrypt mismatch"

    print(f"DIST2PROC EP OK p{pid}", flush=True)


if __name__ == "__main__":
    main()
