"""The CUDA NTT kernel (ops/ntt_kernel.cu, wrapped by ops/ntt_cuda.py).

On the CPU: the numpy model of the kernel (same tables, same stage
schedule, same u32 Shoup arithmetic) bit-exact against the XLA transform
chain, the wrapper's shapes and dtypes, and which implementation a
computation lowers to on each platform.  On a card (`gpu` marker, run by
chip_smoke.py): the kernel itself against the XLA chain."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_study_tpu.ops import ntt, ntt_cuda
from fhe_study_tpu.ops.primes import ntt_primes

# ~2^30 RNS primes plus the 31-bit CRT prime, the largest the kernel takes
QS = ntt_primes(2, 30, 1 << 16) + (ntt.CRT_PRIMES[0],)


def _fin(qs, n, inverse, kind):
    if kind == "plain":
        return tuple(ntt.get_plan(q, n).n_inv if inverse else 1 for q in qs)
    if kind == "mont":
        return tuple((1 << 32) % q for q in qs)
    return tuple((q - 5) * (ntt.get_plan(q, n).n_inv if inverse else 1) % q
                 for q in qs)


def _x(qs, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (rows, n)) for q in qs]
                    ).astype(np.uint32)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("log_n", range(7, 15))
def test_model_matches_xla_chain(log_n, inverse):
    """The kernel's schedule, modelled in numpy, == the XLA chain bit for
    bit, for every epilogue constant a caller passes."""
    n = 1 << log_n
    x = _x(QS, 2, n, log_n)
    for kind in ("plain", "mont", "scale"):
        fin = _fin(QS, n, inverse, kind)
        want = np.asarray(ntt._transform_xla(jnp.asarray(x), QS, inverse, fin))
        got = ntt_cuda.model(x, QS, inverse, fin)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_tables_and_consts_layout():
    """[L, 2, n]: bit-reversed roots of NttPlan, then floor(w·2^32/q);
    [L, 4]: q, c, floor(c·2^32/q), 0."""
    n = 256
    for inverse in (False, True):
        tw = ntt_cuda.tables(QS, n, inverse)
        assert tw.shape == (len(QS), 2, n) and tw.dtype == np.uint32
        for i, q in enumerate(QS):
            p = ntt.get_plan(q, n)
            w = (p.roots_inv if inverse else p.roots).tolist()
            assert tw[i, 0].tolist() == w
            assert tw[i, 1].tolist() == [(v << 32) // q for v in w]
    fin = tuple(q - 2 for q in QS)
    c = ntt_cuda.consts(QS, fin)
    assert c.dtype == np.uint32
    assert c.tolist() == [[q, f, (f << 32) // q, 0] for q, f in zip(QS, fin)]


def test_supported_shapes_and_primes():
    assert ntt_cuda.supported(QS, 2) and ntt_cuda.supported(QS, 1 << 15)
    assert not ntt_cuda.supported(QS, 1)
    assert not ntt_cuda.supported(QS, 1 << 16)        # row > shared memory
    assert not ntt_cuda.supported((2 ** 31 + 11,), 1024)  # Shoup needs 2q < 2^32
    assert ntt_cuda.supported((ntt_cuda.Q_LIMIT - 1,), 1024)


def _targets(fn, x, platform):
    txt = jax.jit(fn).trace(x).lower(lowering_platforms=(platform,)).as_text()
    return {t for t in ntt_cuda._TARGETS.values() if t in txt}


def test_platform_choice_at_lowering():
    """Lowered for CUDA, the transforms are the kernel's FFI calls; lowered
    for the CPU, or at shapes the kernel does not take, they are not."""
    qs = QS[:2]
    x = jnp.asarray(_x(qs, 3, 1024, 1))
    both = lambda a: ntt.intt_multi(ntt.ntt_multi(a, qs), qs)  # noqa: E731
    assert _targets(both, x, "cuda") == set(ntt_cuda._TARGETS.values())
    assert _targets(both, x, "cpu") == set()
    big_qs = ntt_primes(2, 30, 1 << 17)
    big = jnp.zeros((2, 1, 1 << 16), jnp.uint32)
    assert _targets(lambda a: ntt.ntt_multi(a, big_qs), big, "cuda") == set()
    # single-prime transforms below 2^31 share the path
    assert _targets(lambda a: ntt.ntt(a, qs[0]), x[0].astype(jnp.uint64),
                    "cuda") == {ntt_cuda._TARGETS[False]}


@pytest.mark.parametrize("dtype", [jnp.uint32, jnp.uint64])
def test_wrapper_shapes_and_dtype(dtype):
    """Batch axes fold into the kernel's row axis and unfold after; the
    output dtype is the input dtype."""
    qs = QS[:2]
    x = jnp.zeros((2, 3, 5, 128), dtype)
    out = jax.eval_shape(
        lambda a: ntt_cuda.transform(a, qs, False, (1, 1)), x)
    assert out.shape == x.shape and out.dtype == dtype
    txt = jax.jit(lambda a: ntt.ntt_multi(a, qs)).trace(x).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "tensor<2x15x128xui32>" in txt


# -- on the card ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("log_n", [1, 7, 10, 14, 15])
def test_kernel_matches_xla_on_card(gpu_device, log_n):
    n = 1 << log_n
    qs = ntt_primes(3, 30, 1 << 16)
    x = jnp.asarray(_x(qs, 5, n, log_n))
    for inverse in (False, True):
        for kind in ("plain", "mont", "scale"):
            fin = _fin(qs, n, inverse, kind)
            got = jax.jit(lambda a: ntt_cuda.transform(a, qs, inverse, fin))(x)
            want = jax.jit(
                lambda a: ntt._transform_xla(a, qs, inverse, fin))(x)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_kernel_dtype_and_empty_rows_on_card(gpu_device):
    qs = ntt_primes(2, 30, 1 << 16)
    x = jnp.asarray(_x(qs, 4, 256, 3)).astype(jnp.uint64)
    e = ntt.ntt_multi(x, qs)
    assert e.dtype == jnp.uint64
    np.testing.assert_array_equal(np.asarray(ntt.intt_multi(e, qs)),
                                  np.asarray(x))
    empty = ntt.ntt_multi(jnp.zeros((2, 0, 256), jnp.uint32), qs)
    assert empty.shape == (2, 0, 256)
