"""Coefficient-sharded negacyclic NTT / polynomial multiply (four-step).

The sequence-parallel analog for FHE (SURVEY §2.6): the ring degree N is
sharded across the `sp` mesh axis and the NTT runs as the classic four-step
decomposition n = n1·n2 —

    negacyclic twist (psi^j, local)
    -> column NTT of size n2 (local, root w^{n1})
    -> twiddle w^{j1·k2} (local)
    -> tile exchange (lax.all_to_all)                <- the only comm
    -> row NTT of size n1 (local, root w^{n2})

Pointwise products happen in the transformed (k2-sharded) layout; the inverse
mirrors the pipeline.  One all_to_all each way — bandwidth n/S per device,
exactly the bisection-friendly pattern ring-attention uses for sequence shards.

Layout convention: a polynomial a_j (j = j1 + n1*j2) is viewed as the
row-major matrix A[j2, j1] = a.reshape(n2, n1); the LAST axis (j1, size n1)
is sharded into S column blocks.  The transform leaves data as
B[k2, k1] = â_{k2 + n2·k1} with the k2 axis (size n2) sharded into S row
blocks.
"""

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import modops, ntt

U64 = jnp.uint64


@lru_cache(maxsize=None)
def _four_step_consts(q: int, n: int, n1: int):
    """Host-precomputed twist/twiddle tables for the n = n1*n2 split."""
    n2 = n // n1
    psi = ntt.get_plan(q, n).root          # primitive 2n-th root
    w = pow(psi, 2, q)                     # primitive n-th root
    j = np.arange(n, dtype=object)
    psi_pows = np.array([pow(psi, int(i), q) for i in range(n)], np.uint64)
    psi_inv = pow(psi, q - 2, q)
    psi_inv_pows = np.array([pow(psi_inv, int(i), q) for i in range(n)], np.uint64)
    twist = psi_pows.reshape(n2, n1)       # psi^{j1 + n1*j2}
    untwist = psi_inv_pows.reshape(n2, n1)
    # twiddle w^{j1*k2}: [n2 (k2), n1 (j1)]
    k2 = np.arange(n2)
    j1 = np.arange(n1)
    tw = np.array([[pow(w, int(a * b), q) for b in j1] for a in k2], np.uint64)
    w_inv = pow(w, q - 2, q)
    tw_inv = np.array([[pow(w_inv, int(a * b), q) for b in j1] for a in k2],
                      np.uint64)
    # numpy outputs (lru_cached; jnp here would leak tracers if first called
    # under a trace)
    return (twist, untwist, tw, tw_inv, w, pow(w, n2, q), pow(w, n1, q))


def _fwd_local(x, tw_slab, q, n1, n2, S, axis, w_n1, w_n2, twist_slab):
    """shard_map body: local [.., n2, n1/S] column slab -> [.., n2/S, n1]."""
    x = modops.mulmod(x, twist_slab, q)                    # negacyclic twist
    x = jnp.moveaxis(x, -2, -1)                            # [.., c, n2]
    x = ntt.ntt_cyclic(x, q, w_n1)                         # col NTT (size n2)
    x = jnp.moveaxis(x, -1, -2)                            # [.., n2, c]
    x = modops.mulmod(x, tw_slab, q)                       # twiddle
    x = jax.lax.all_to_all(x, axis, split_axis=x.ndim - 2,
                           concat_axis=x.ndim - 1, tiled=True)
    # received: [.., n2/S, c*S = n1]
    return ntt.ntt_cyclic(x, q, w_n2)                      # row NTT (size n1)


def _inv_local(x, tw_inv_slab, q, n1, n2, S, axis, w_n1, w_n2, untwist_slab):
    """inverse: local [.., n2/S, n1] row slab -> [.., n2, n1/S]."""
    x = ntt.intt_cyclic(x, q, w_n2)                        # row INTT
    x = modops.mulmod(x, tw_inv_slab, q)                   # inverse twiddle
    x = jax.lax.all_to_all(x, axis, split_axis=x.ndim - 1,
                           concat_axis=x.ndim - 2, tiled=True)
    # received: [.., n2, c]
    x = jnp.moveaxis(x, -2, -1)
    x = ntt.intt_cyclic(x, q, w_n1)                        # col INTT
    x = jnp.moveaxis(x, -1, -2)
    return modops.mulmod(x, untwist_slab, q)               # untwist


def negacyclic_mul_sharded(a, b, q: int, mesh: Mesh, axis: str = "sp"):
    """Ring product in Z_q[X]/(X^n+1) with the coefficient axis sharded over
    `axis`.  a, b: [..., n] u64 (any batch dims; batch stays replicated or
    sharded by the caller's in_specs on other axes)."""
    n = a.shape[-1]
    S = mesh.shape[axis]
    # n1: a multiple of S near sqrt(n) (both factors must divide by S)
    n1 = S
    while n1 * n1 < n:
        n1 *= 2
    n2 = n // n1
    assert n1 % S == 0 and n2 % S == 0, (n1, n2, S)
    twist, untwist, tw, tw_inv, w, w_n2, w_n1 = _four_step_consts(q, n, n1)
    # NOTE: w_n2 = w^{n2} (order n1, used for ROW transforms of size n1);
    #       w_n1 = w^{n1} (order n2, used for COLUMN transforms of size n2).

    batch = a.shape[:-1]
    A = a.reshape(batch + (n2, n1))
    B = b.reshape(batch + (n2, n1))
    nb = len(batch)
    col_spec = P(*([None] * nb), None, axis)   # [.., n2, n1<-sharded]
    row_spec = P(*([None] * nb), axis, None)   # [.., n2<-sharded, n1]

    def body(A, B, twist_s, tw_s, tw_inv_s, untwist_s):
        ea = _fwd_local(A, tw_s, q, n1, n2, S, axis, w_n1, w_n2, twist_s)
        eb = _fwd_local(B, tw_s, q, n1, n2, S, axis, w_n1, w_n2, twist_s)
        ec = modops.mulmod(ea, eb, q)
        return _inv_local(ec, tw_inv_s, q, n1, n2, S, axis, w_n1, w_n2, untwist_s)

    two = P(None, axis)
    tworow = P(axis, None)
    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(col_spec, col_spec, two, two, tworow, two),
        out_specs=col_spec,
        check_vma=False,
    )(A, B, twist, tw, tw_inv, untwist)
    return out.reshape(batch + (n,))
