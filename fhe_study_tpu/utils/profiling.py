"""Observability: wall-clock op timing, roofline estimates, noise budget.

The reference has no tracing/metrics beyond `Instant::now()` prints in one
test (SURVEY §5).  This module provides:
  * `timed` — block/fn wall timing with device sync
  * `ntt_roofline` — per-kernel speed-of-light model (butterflies vs HBM),
    against the published peaks of `DEVICE_PEAKS`
  * `noise_budget_bits` — the FHE health metric (log2 of remaining headroom),
    generalizing the reference's only probe, `infinity_norm`
    (reference arith/src/ring_nq.rs:347-358)
  * `trace` — context manager around jax.profiler for device timeline capture
"""

import contextlib
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    t0 = time.perf_counter()
    yield
    # caller is responsible for block_until_ready on async results
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Compile, warm up, and time fn; returns seconds/iteration."""
    f = jax.jit(fn)
    out = f(*args)
    jax.block_until_ready(out)
    for _ in range(warmup - 1):
        out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


# Published peaks per device, keyed by jax's `device_kind`.  A device not
# in the table is an error, never a default.
DEVICE_PEAKS = {
    # NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9},
}


def device_peaks(device_kind: str) -> dict:
    if device_kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[device_kind]


@dataclass
class Roofline:
    butterflies: int
    hbm_bytes: int
    secs: float

    @property
    def butterflies_per_sec(self):
        return self.butterflies / self.secs

    @property
    def hbm_bytes_per_sec(self):
        return self.hbm_bytes / self.secs

    def report(self, device_kind: str):
        """Achieved rates and the HBM share of the device's published peak."""
        peak = device_peaks(device_kind)["hbm_bytes_per_s"]
        return {
            "butterflies_per_sec": self.butterflies_per_sec,
            "hbm_bytes_per_sec": self.hbm_bytes_per_sec,
            "hbm_fraction_of_peak": self.hbm_bytes_per_sec / peak,
        }


def ntt_roofline(rows: int, n: int, secs: float, dtype_bytes: int = 4):
    """Model: log2(n) stages × n/2 butterflies per row; the least traffic a
    transform needs reads and writes each row once."""
    logn = n.bit_length() - 1
    return Roofline(
        butterflies=rows * logn * (n // 2),
        hbm_bytes=rows * 2 * n * dtype_bytes,
        secs=secs,
    )


def noise_budget_bits(phase_err, q: int) -> jnp.ndarray:
    """log2(q / (2·|err|)) — bits of headroom before decryption fails.
    phase_err: centered error array (int64)."""
    e = jnp.maximum(jnp.abs(phase_err).astype(jnp.float64), 1.0)
    return jnp.log2(float(q) / (2.0 * e))


@contextlib.contextmanager
def trace(dirname: str = "/tmp/fhe_trace"):
    jax.profiler.start_trace(dirname)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
