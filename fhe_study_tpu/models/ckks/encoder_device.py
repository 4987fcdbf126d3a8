"""Device-side CKKS canonical-embedding encoder: split-complex f64 FFT.

The host encoder (encoder.py) uses numpy complex128; this variant implements
the same twisted transform on the device with REAL f64 arrays (re, im pairs)
and the iterative radix-2 structure of ops/ntt.py — pure jnp, batched over
leading dims, shardable over the batch mesh axis.  Used by the
batched/sharded CKKS encode pipeline (the ckks bench cell).
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from ...ops.ntt import _bit_reverse
from ...utils.rounding import round_half_away


@lru_cache(maxsize=None)
def _fft_tables(n: int, sign: int):
    """Per-stage twiddle (re, im) for a DIT FFT with e^{sign·2πi jk/n};
    plus bit-reversal permutation and the ±π/n twist. numpy (cached)."""
    logn = n.bit_length() - 1
    bitrev = np.array([_bit_reverse(i, logn) for i in range(n)], np.int64)
    tws = []
    for s in range(logn):
        half = 1 << s
        length = 2 * half
        ang = sign * 2.0 * np.pi * np.arange(half) / length
        tws.append((np.cos(ang), np.sin(ang)))
    k = np.arange(n)
    twist = (np.cos(sign * np.pi * k / n), np.sin(sign * np.pi * k / n))
    return bitrev, tws, twist


def _fft_split(re, im, n: int, sign: int):
    """In-place-style radix-2 DIT over the last axis; natural-order output."""
    bitrev, tws, _ = _fft_tables(n, sign)
    re = jnp.take(re, bitrev, axis=-1)
    im = jnp.take(im, bitrev, axis=-1)
    batch = re.shape[:-1]
    logn = n.bit_length() - 1
    for s in range(logn):
        half = 1 << s
        m = n // (2 * half)
        wr, wi = tws[s]
        re = re.reshape(batch + (m, 2, half))
        im = im.reshape(batch + (m, 2, half))
        ur, ui = re[..., 0, :], im[..., 0, :]
        vr0, vi0 = re[..., 1, :], im[..., 1, :]
        vr = vr0 * wr - vi0 * wi
        vi = vr0 * wi + vi0 * wr
        re = jnp.stack([ur + vr, ur - vr], axis=-2).reshape(batch + (m, 2 * half))
        im = jnp.stack([ui + vi, ui - vi], axis=-2).reshape(batch + (m, 2 * half))
    return re.reshape(batch + (n,)), im.reshape(batch + (n,))


def encode(z_re, z_im, n: int, delta: float):
    """[..., n/2] (re, im) -> int64 coefficients [..., n].
    Same math as encoder.Encoder.encode (twisted IDFT of the conjugate-
    symmetric expansion), computed with sign=-1 DFT + w^{-k} twist."""
    z_re = jnp.asarray(z_re, jnp.float64) * delta
    z_im = jnp.asarray(z_im, jnp.float64) * delta
    exp_re = jnp.concatenate([z_re, z_re[..., ::-1]], axis=-1)
    exp_im = jnp.concatenate([z_im, -z_im[..., ::-1]], axis=-1)
    fr, fi = _fft_split(exp_re, exp_im, n, sign=-1)
    _, _, (tr, ti) = _fft_tables(n, -1)
    alpha_re = (fr * tr - fi * ti) / n
    return round_half_away(alpha_re).astype(jnp.int64)


def decode(p, n: int, delta: float):
    """int coefficients [..., n] -> (re, im) [..., n/2]."""
    pr = jnp.asarray(p, jnp.float64)
    _, _, (tr, ti) = _fft_tables(n, +1)
    xr = pr * tr
    xi = pr * ti
    fr, fi = _fft_split(xr, xi, n, sign=+1)
    return fr[..., : n // 2] / delta, fi[..., : n // 2] / delta
