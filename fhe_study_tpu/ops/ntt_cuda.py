"""CUDA NTT kernel (ops/ntt_kernel.cu) behind `jax.ffi`, plus its numpy model.

`ops/ntt.py` routes every multi-prime transform through `transform` when the
computation is lowered for CUDA (`lax.platform_dependent`); everywhere else
the XLA stage chain runs.  The kernel computes exactly what that chain
computes: canonical residues, the same bit-reversed root tables, the same
butterfly order, and one per-prime constant multiplied into every output.

The shared library is built from the tracked source with `nvcc` into
`<repo>/_build/` at first use on a machine with a CUDA device, or ahead of
time with `python -m fhe_study_tpu.ops.ntt_cuda`.  On such a machine a
failed build or load raises; nothing falls back to XLA.

`model` runs the kernel's table layout, stage schedule and u32 Shoup
arithmetic in numpy: it is how the CPU test suite checks the kernel's
arithmetic, since CUDA code has no interpret mode.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ntt_kernel.cu")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
_TARGETS = {False: "fhe_ntt_forward", True: "fhe_ntt_inverse"}
_SYMBOLS = {False: "FheNttForward", True: "FheNttInverse"}

MAX_LOG_N = 15          # a 2^15-point u32 row is 128 KB of shared memory
Q_LIMIT = 1 << 31       # Shoup products need 2q < 2^32


def supported(qs: tuple, n: int) -> bool:
    """Whether the kernel takes this transform: n a power of two in
    [2, 2^15] and every prime below 2^31."""
    return 2 <= n <= (1 << MAX_LOG_N) and max(qs) < Q_LIMIT


# -- tables -----------------------------------------------------------------

@lru_cache(maxsize=None)
def tables(qs: tuple, n: int, inverse: bool) -> np.ndarray:
    """[L, 2, n] u32: per prime the bit-reversed (inverse) root table of
    `ntt.NttPlan`, then the Shoup companions floor(w * 2^32 / q)."""
    from .ntt import get_plan
    out = np.empty((len(qs), 2, n), np.uint32)
    for i, q in enumerate(qs):
        p = get_plan(q, n)
        w = p.roots_inv if inverse else p.roots
        out[i, 0] = w
        out[i, 1] = (w << np.uint64(32)) // np.uint64(q)
    return out


def consts(qs: tuple, fin: tuple) -> np.ndarray:
    """[L, 4] u32: per prime q, the epilogue constant c and its Shoup
    companion."""
    return np.array([(q, c, (c << 32) // q, 0) for q, c in zip(qs, fin)],
                    np.uint32)


# -- build and registration ---------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("ntt kernel: nvcc not found (PATH, /usr/local/cuda/bin)")
    return path


def build() -> str:
    """Compile ntt_kernel.cu for sm_90a into _build/ (keyed by the source's
    hash, so an edited source never loads a stale library); returns the
    library's path."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"libfhe_ntt_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"ntt kernel: nvcc failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


@lru_cache(maxsize=1)
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(build())
    for inverse, target in _TARGETS.items():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[inverse])),
            platform="CUDA")


@lru_cache(maxsize=1)
def _have_gpu() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def transform(x, qs: tuple, inverse: bool, fin: tuple):
    """The kernel as a JAX op: x [L, ..., n] residues (u32 or u64) ->
    same shape and dtype; `fin` is the per-prime epilogue constant."""
    if _have_gpu():
        _register()          # lowering for CUDA needs the target registered
    L, n = x.shape[0], x.shape[-1]
    x3 = x.astype(jnp.uint32).reshape(L, -1, n)
    from .ntt import _dev
    call = jax.ffi.ffi_call(_TARGETS[inverse],
                            jax.ShapeDtypeStruct(x3.shape, jnp.uint32))
    y = call(x3, _dev(tables(qs, n, inverse)), jnp.asarray(consts(qs, fin)))
    return y.reshape(x.shape).astype(x.dtype)


# -- numpy model ----------------------------------------------------------------

def model(x, qs: tuple, inverse: bool, fin: tuple) -> np.ndarray:
    """The kernel's computation in numpy, stage by stage: same [L, 2, n]
    tables, same butterfly indices, u32 Shoup products with wrap-around.
    x: [L, ..., n] residues -> u32 array of the same shape."""
    x = np.asarray(x)
    L, n = x.shape[0], x.shape[-1]
    log_n = n.bit_length() - 1
    tw = tables(qs, n, inverse).astype(np.uint64)
    cs = consts(qs, fin).astype(np.uint64)
    s = x.reshape(L, -1, n).astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    q = cs[:, 0][:, None, None]

    def shoup(a, w, ws):
        hi = (a * ws) >> np.uint64(32)
        r = (a * w - hi * q) & m32          # u32 wrap-around, as on the card
        return np.where(r >= q, r - q, r)

    j = np.arange(n // 2)
    for st in range(log_n):
        log_t = st if inverse else log_n - 1 - st
        m = (n // 2) >> log_t
        g = j >> log_t
        a = (g << (log_t + 1)) + (j & ((1 << log_t) - 1))
        b = a + (1 << log_t)
        w = tw[:, 0, m + g][:, None, :]
        ws = tw[:, 1, m + g][:, None, :]
        u, v = s[..., a], s[..., b]
        if inverse:
            d = np.where(u >= v, u - v, u + (q - v))
            s[..., a] = np.where(u + v >= q, u + v - q, u + v)
            s[..., b] = shoup(d, w, ws)
        else:
            v = shoup(v, w, ws)
            s[..., a] = np.where(u + v >= q, u + v - q, u + v)
            s[..., b] = np.where(u >= v, u - v, u + (q - v))
    out = shoup(s, cs[:, 1][:, None, None], cs[:, 2][:, None, None])
    return out.astype(np.uint32).reshape(x.shape)


if __name__ == "__main__":
    print(build())
