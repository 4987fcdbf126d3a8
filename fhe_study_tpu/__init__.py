"""fhe_study_tpu — an FHE primitive library in JAX (XLA plus one CUDA kernel).

A from-scratch, accelerator-first reimplementation of the capabilities of the
arnaucube/fhe-study reference workspace (BFV, CKKS, TFHE over a generalized
GLWE layer, on top of negacyclic polynomial-ring arithmetic with NTT).

Design principles (vs the single-threaded Rust reference):
  * every array op is batched — ciphertexts carry arbitrary leading batch dims
  * all randomness is explicit (threefry keys), no global RNG
  * static scheme parameters are hashable frozen dataclasses → jit cache keys
  * the hot compute path (NTT, gadget contractions, external products) is
    expressed as vectorized XLA ops (and, on the GPU, one fused NTT kernel),
    never Python loops over coefficients
  * scale-out is jax.sharding over a Mesh (batch / limb / coefficient axes),
    not threads

The library requires 64-bit integer support; importing it enables jax x64.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .arith.params import RingParam, TORUS_Q  # noqa: E402,F401
from .arith.ring import RqRing, TorusRing, ring_for  # noqa: E402,F401

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access: fhe_study_tpu.models / .ops / .parallel / ...
    if name in ("arith", "models", "ops", "parallel", "utils", "runtime"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
