"""utils coverage: serialization round-trip, profiling helpers, rounding."""

import os
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_study_tpu.utils import serialization, profiling, prng
from fhe_study_tpu.utils.rounding import round_half_away


def test_save_load_pytree_roundtrip():
    from fhe_study_tpu.models.gfhe import glwe as G
    from fhe_study_tpu.arith import RingParam
    param = G.Param(G.ERR_SIGMA, RingParam(2 ** 16 + 1, 16), 2, 4)
    sk, pk = G.new_key(jax.random.PRNGKey(0), param)
    ct = G.encrypt_s(jax.random.PRNGKey(1), param, sk,
                     G.encode(param, jnp.zeros((16,), jnp.uint64)))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ct.npz")
        serialization.save_pytree(path, ct)
        back = serialization.load_pytree(path, ct)
    np.testing.assert_array_equal(np.asarray(back.a), np.asarray(ct.a))
    np.testing.assert_array_equal(np.asarray(back.b), np.asarray(ct.b))


def test_rounding_half_away():
    x = jnp.asarray([0.5, -0.5, 1.5, -1.5, 2.4, -2.4, 2.5, -2.5, 0.0])
    got = np.asarray(round_half_away(x))
    np.testing.assert_array_equal(got, [1, -1, 2, -2, 2, -2, 3, -3, 0])


def test_time_fn_and_roofline():
    t = profiling.time_fn(lambda x: x * 2, jnp.ones((64, 64)), iters=2, warmup=1)
    assert t > 0
    r = profiling.ntt_roofline(rows=8, n=1024, secs=1e-3)
    rep = r.report("NVIDIA H100 80GB HBM3")
    assert rep["butterflies_per_sec"] == 8 * 10 * 512 / 1e-3
    assert rep["hbm_bytes_per_sec"] == 8 * 2 * 1024 * 4 / 1e-3
    assert np.isclose(rep["hbm_fraction_of_peak"],
                      rep["hbm_bytes_per_sec"] / 3.35e12)


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_device_peaks_unknown_kind_raises(kind):
    """A device without published peaks is an error, never a default."""
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks(kind)
    with pytest.raises(KeyError):
        profiling.ntt_roofline(rows=1, n=16, secs=1.0).report(kind)


def test_device_peaks_h100_from_data_sheet():
    p = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9}


def test_noise_budget_bits_util():
    err = jnp.asarray([[3, -5, 0]], jnp.int64)
    bits = np.asarray(profiling.noise_budget_bits(err, q=2 ** 16))
    assert np.isclose(bits.min(), np.log2(2 ** 16 / (2 * 5)), atol=0.01)
