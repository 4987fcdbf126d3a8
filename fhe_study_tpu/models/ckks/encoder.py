"""CKKS canonical-embedding encoder — FFT formulation.

The reference encoder (reference ckks/src/encoder.rs) builds a Vandermonde
matrix at the odd powers of the 2N-th root of unity, projects onto its rows,
and solves a complex linear system with LAPACK/MKL (encoder.rs:143-147, via
arith/src/matrix.rs:106-148) — the single native-code dependency of the whole
reference workspace.

That Vandermonde matrix IS a twisted DFT matrix, and its rows are orthogonal
(norm^2 = N), so projection + solve collapse to one twisted FFT:

    encode:  alpha_k = Re[(1/N) * w^{-k} * DFT(pi_inv(z) * Delta)_k],  round
    decode:  sigma(p)_j = N * IDFT(p * w^k)_j,  first N/2, / Delta

with w = e^{i*pi/N}.  This replaces the O(N^3) solve with O(N log N) and no
LAPACK.  (The reference also computes w by a 10-term Taylor series,
complex.rs:56-88; we use the libm exponential — the tests round to integers,
so both agree at test tolerance.)

Runs host-side in numpy complex128 — the test reference for the device
encoder (encoder_device.py); the device encrypt/decrypt path
consumes/produces the integer coefficient arrays.
"""

import numpy as np


def _round_half_away_np(x):
    t = np.trunc(x)
    frac = x - t
    bump = np.where(np.abs(frac) >= 0.5, np.sign(frac), 0.0)
    return t + bump


class Encoder:
    """Canonical embedding C^{N/2} <-> R = Z[X]/(X^N+1), scale Delta."""

    def __init__(self, n: int, delta: float):
        self.n = n
        self.delta = float(delta)
        k = np.arange(n)
        self.twist = np.exp(-1j * np.pi * k / n)      # w^{-k}
        self.untwist = np.exp(1j * np.pi * k / n)     # w^{+k}

    def pi_inv(self, z):
        """C^{N/2} -> H: append reversed conjugates (encoder.rs:118-123)."""
        z = np.asarray(z, dtype=np.complex128)
        return np.concatenate([z, np.conj(z[..., ::-1])], axis=-1)

    def encode(self, z):
        """z: [..., N/2] complex -> int64 coefficient array [..., N]."""
        expanded = self.pi_inv(z) * self.delta
        alpha = self.twist * np.fft.fft(expanded, axis=-1) / self.n
        return _round_half_away_np(alpha.real).astype(np.int64)

    def decode(self, p):
        """int coefficients [..., N] -> [..., N/2] complex."""
        p = np.asarray(p, dtype=np.float64)
        sigma = np.fft.ifft(p * self.untwist, axis=-1) * self.n
        return sigma[..., : self.n // 2] / self.delta
