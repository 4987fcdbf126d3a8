"""Device-side CKKS encoder + the batched/sharded encode-encrypt-add pipeline
(the ckks bench cell)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from fhe_study_tpu.arith import RingParam
from fhe_study_tpu.models.ckks import Encoder, ckks, encoder_device
from fhe_study_tpu.parallel import mesh as mesh_mod
from fhe_study_tpu.utils import prng

Q = 2 ** 16 + 1


def test_device_encoder_matches_host():
    n, delta, t = 32, 512.0, 8
    rng = np.random.default_rng(0)
    z = (rng.integers(0, t, (16, n // 2)) +
         1j * rng.integers(0, t, (16, n // 2))).astype(np.complex128)
    host = Encoder(n, delta).encode(z)
    dev = np.asarray(encoder_device.encode(
        jnp.asarray(z.real), jnp.asarray(z.imag), n, delta))
    np.testing.assert_array_equal(host, dev)
    zr, zi = encoder_device.decode(jnp.asarray(dev), n, delta)
    np.testing.assert_array_equal(np.round(np.asarray(zr)), z.real)
    np.testing.assert_array_equal(np.round(np.asarray(zi)), z.imag)


def test_sharded_encode_encrypt_add():
    """Full CKKS pipeline jitted over a dp-sharded batch."""
    n, t, delta = 16, 8, 1024.0
    param = ckks.Param(RingParam(Q, n), t)
    m = mesh_mod.make_mesh(dp=8, ep=1, sp=1)
    B = 16
    rng = np.random.default_rng(1)
    z0 = (rng.integers(0, t, (B, n // 2)) +
          1j * rng.integers(0, t, (B, n // 2))).astype(np.complex128)
    z1 = (rng.integers(0, t, (B, n // 2)) +
          1j * rng.integers(0, t, (B, n // 2))).astype(np.complex128)

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = prng.split(key, 3)
    sk, pk = ckks.new_key(k1, param)

    sh = NamedSharding(m, P("dp"))

    @jax.jit
    def pipeline(z0r, z0i, z1r, z1i):
        m0 = encoder_device.encode(z0r, z0i, n, delta)
        m1 = encoder_device.encode(z1r, z1i, n, delta)
        c0 = ckks.encrypt(k2, param, pk, m0, batch=(B,))
        c1 = ckks.encrypt(k3, param, pk, m1, batch=(B,))
        return ckks.add(param, c0, c1)

    args = [jax.device_put(jnp.asarray(x), sh)
            for x in (z0.real, z0.imag, z1.real, z1.imag)]
    ct = pipeline(*args)
    dec = np.asarray(ckks.decrypt(param, sk, ct))
    zr, zi = encoder_device.decode(jnp.asarray(dec), n, delta)
    np.testing.assert_array_equal(np.round(np.asarray(zr)), (z0 + z1).real)
    np.testing.assert_array_equal(np.round(np.asarray(zi)), (z0 + z1).imag)
