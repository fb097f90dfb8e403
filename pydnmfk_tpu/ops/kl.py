"""KL-divergence inner products with bounded memory.

The KL MU update needs two products of the ratio matrix U = A / (W H + eps):

    UHT = U @ H^T     (m, k)   -- for the W update   (reference glob_UX axis=0,
                                  dist_nmf.py:803-811; 2D UHT_glob :320-343)
    WTU = W^T @ U     (k, n)   -- for the H update   (reference glob_UX axis=1;
                                  2D WTU_glob :293-318)

The reference materializes the full local m x n ratio block every iteration
(dist_nmf.py:806, :312, :338).  Here the default path also materializes U
(XLA fuses the divide into the surrounding ops, and U is the same size as the
dense A that is already resident), but a chunked path bounds the intermediate
to ``chunk`` rows at a time via ``lax.scan`` — the flash-attention-style
fix for very large m where an A-sized U does not fit beside A.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from .linalg import matmul


def _ratio(A, W, H, eps):
    return A / (matmul(W, H) + eps)


def kl_uht(A: jax.Array, W: jax.Array, H: jax.Array, eps: float,
           chunk: int = 0) -> jax.Array:
    """(A / (W H + eps)) @ H^T without materializing U when chunk > 0."""
    if not chunk or chunk >= A.shape[0]:
        return matmul(_ratio(A, W, H, eps), H.T)
    return _chunked(A, W, H, eps, chunk, want="uht")


def kl_wtu(A: jax.Array, W: jax.Array, H: jax.Array, eps: float,
           chunk: int = 0) -> jax.Array:
    """W^T @ (A / (W H + eps)) without materializing U when chunk > 0."""
    if not chunk or chunk >= A.shape[0]:
        return matmul(W.T, _ratio(A, W, H, eps))
    return _chunked(A, W, H, eps, chunk, want="wtu")


def kl_uht_sharded(A, W, H, eps, mesh, chunk: int = 0):
    """Memory-bounded UHT on a device mesh.

    shard_map over the (r, c) grid: each device computes its *local*
    bounded product (the chunked scan above) on its A block, then psums
    over 'c'.  This is exactly the
    collective contract of the reference's 2D KL path (UHT_glob,
    dist_nmf.py:320-343: local U block -> Reduce_scatter over the column
    communicator) with the full m x n intermediate never materialized —
    per device only a (chunk, n_local) slab lives.
    """
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS

    def local(a, w, h):
        part = kl_uht(a, w, h, eps, chunk=chunk)
        return lax.psum(part, COL_AXIS)

    return shard_map(local, mesh=mesh,
                     in_specs=(P(ROW_AXIS, COL_AXIS), P(ROW_AXIS, None),
                               P(None, COL_AXIS)),
                     out_specs=P(ROW_AXIS, None), check_vma=False)(A, W, H)


def kl_wtu_sharded(A, W, H, eps, mesh, chunk: int = 0):
    """Memory-bounded WTU on a device mesh (reference WTU_glob,
    dist_nmf.py:293-318: local product -> Reduce_scatter over the row
    communicator); see kl_uht_sharded."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS

    def local(a, w, h):
        part = kl_wtu(a, w, h, eps, chunk=chunk)
        return lax.psum(part, ROW_AXIS)

    return shard_map(local, mesh=mesh,
                     in_specs=(P(ROW_AXIS, COL_AXIS), P(ROW_AXIS, None),
                               P(None, COL_AXIS)),
                     out_specs=P(None, COL_AXIS), check_vma=False)(A, W, H)


def _chunked(A, W, H, eps, chunk, want):
    """Loop over row-blocks of A and W via dynamic_slice; only a (chunk, n)
    slab of U lives, and A is never copied (jnp.pad/reshape would materialize
    a full padded copy of A — fatal at flagship scale).  Full blocks run in a
    fori_loop; the ragged tail is one static block."""
    m, n = A.shape
    k = W.shape[1]
    out_dt = jnp.result_type(A.dtype, W.dtype)
    n_full = m // chunk
    m1 = n_full * chunk

    if want == "uht":
        def blk_uht(a, w):
            u = a / (matmul(w, H) + eps)
            return matmul(u, H.T)

        def body(i, out):
            a = lax.dynamic_slice_in_dim(A, i * chunk, chunk, 0)
            w = lax.dynamic_slice_in_dim(W, i * chunk, chunk, 0)
            return lax.dynamic_update_slice_in_dim(
                out, blk_uht(a, w).astype(out_dt), i * chunk, 0)

        out = jnp.zeros((m, k), out_dt)
        out = lax.fori_loop(0, n_full, body, out)
        if m1 < m:
            out = out.at[m1:].set(blk_uht(A[m1:], W[m1:]).astype(out_dt))
        return out
    else:
        def blk_wtu(a, w):
            u = a / (matmul(w, H) + eps)
            return matmul(w.T, u)

        def body(i, acc):
            a = lax.dynamic_slice_in_dim(A, i * chunk, chunk, 0)
            w = lax.dynamic_slice_in_dim(W, i * chunk, chunk, 0)
            return acc + blk_wtu(a, w).astype(out_dt)

        acc = lax.fori_loop(0, n_full, body, jnp.zeros((k, n), out_dt))
        if m1 < m:
            acc = acc + blk_wtu(A[m1:], W[m1:]).astype(out_dt)
        return acc
