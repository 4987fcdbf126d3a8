"""Batched TFHE bootstrapping with the ciphertext batch sharded over `dp`
(the tfhe bench cell's single-process shape; the multi-process version is
the same program over a larger mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from fhe_study_tpu.arith import RingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe.glwe import Param, ERR_SIGMA
from fhe_study_tpu.models.tfhe import tlwe, tglwe, bootstrap
from fhe_study_tpu.parallel import mesh as mesh_mod
from fhe_study_tpu.utils import prng
import pytest


@pytest.mark.slow
def test_bootstrap_dp_sharded():
    n, t = 128, 8
    param = Param(ERR_SIGMA, RingParam(TORUS_Q, n), 1, t)
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = prng.split(key, 3)
    table = bootstrap.compute_lookup_table_standard(param)
    s, _ = tglwe.new_key(k1, param)
    s_flat = tglwe.sk_to_tlwe(s)
    btk, s_out = bootstrap.new_bootstrapping_key(
        k2, param, s, beta=256, l=3, beta_ks=16, l_ks=8, s_lwe_out=s_flat)

    B = 8
    m = jnp.tile(jnp.arange(t // 2, dtype=jnp.uint64), B // (t // 2))[:B]
    c = tlwe.encrypt_uniform(k3, param.lwe(), s_flat,
                             tlwe.encode(param, m), batch=(B,))

    mesh = mesh_mod.make_mesh(dp=8, ep=1, sp=1)
    sh = NamedSharding(mesh, P("dp"))
    ca = jax.device_put(c.a, sh)
    cb = jax.device_put(c.b, sh)

    bs = jax.jit(lambda a, b: bootstrap.bootstrap(
        param, btk, table, tlwe.TLWE(a, b), beta=256, l=3,
        beta_ks=16, l_ks=8, mode="standard"))
    out = bs(ca, cb)
    rec = tlwe.decode(param, tlwe.decrypt(param.lwe(), s_out,
                                          tlwe.TLWE(out[0], out[1])))
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(m))
