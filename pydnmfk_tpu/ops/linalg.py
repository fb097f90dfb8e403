"""Distributed linear-algebra primitives for NMF, written global-first.

Every function takes *global* (logically full-size) arrays.  Under ``jax.jit``
with the canonical shardings (parallel/mesh.py), XLA's SPMD partitioner
lowers these to exactly the hand-written collective patterns of the reference
(pyDNMFk/dist_nmf.py):

    gram(W)          == global_gram: local X^T X + Allreduce    (dist_nmf.py:94-116, 662-685)
    matmul_WTA(W, A) == ATW_glob: allgather + matmul + Reduce_scatter (dist_nmf.py:144-172)
    matmul_AHT(A, H) == AH_glob                                  (dist_nmf.py:174-205)
    fro_norm(X)      == utils.norm: sqrt(Allreduce(|X|^2))       (utils.py:367-391)
    sum_axis         == sum_along_axis with Allreduce            (dist_nmf.py:775-801)

The matmuls ask for f32 accumulation explicitly (``preferred_element_type``)
so bf16 inputs run on the tensor cores with full-precision accumulation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def is_sparse(x) -> bool:
    """True for jax.experimental.sparse arrays (BCOO/BCSR).

    Sparse A extends the framework beyond the dense-only reference
    (its extreme-scale runs, docs/scalability.png, were dense): FRO-norm
    solvers accept a BCOO A, with all products sparse-dense and the
    error computed via the Gram identity so the dense m x n residual
    never materializes.
    """
    from jax.experimental import sparse
    return (isinstance(x, sparse.JAXSparse)
            or getattr(x, "_pydnmfk_sparse", False))


def _acc_dtype(x):
    """Accumulate low-precision inputs in f32; keep f64 when enabled.
    Accepts an array or a dtype."""
    dt = getattr(x, "dtype", x)
    if dt == jnp.float64:
        return jnp.float64
    return jnp.float32


def matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Matmul with f32 (or f64) accumulation.

    Same-dtype inputs return that dtype.  Mixed-dtype inputs follow the
    usual mixed-precision recipe: both operands enter the product in the
    *narrower* input dtype (so e.g. a bf16-stored A is read from memory at
    half the bytes and the small factor operand is rounded once),
    accumulation stays f32/f64, and the result is returned in the *wider*
    dtype so factor updates keep full precision."""
    if is_sparse(a) or is_sparse(b):
        # sparse-dense product (BCOO __matmul__); data is stored at the
        # working dtype, accumulation follows the sparse rules
        return a @ b
    if (jnp.issubdtype(a.dtype, jnp.integer)
            or jnp.issubdtype(b.dtype, jnp.integer)):
        int_is_a = jnp.issubdtype(a.dtype, jnp.integer)
        int_dt = a.dtype if int_is_a else b.dtype
        wide = b.dtype if int_is_a else a.dtype
        if jnp.issubdtype(wide, jnp.integer):
            wide = jnp.float32
        if jnp.dtype(int_dt).itemsize == 1 and wide != jnp.float64:
            # 8-bit operand (uint8-quantized A): multiply in bf16 —
            # exact for 8-bit integers (bf16 represents 0..256 exactly) —
            # accumulate f32, return the float side's dtype
            out = jnp.matmul(a.astype(jnp.bfloat16),
                             b.astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32)
            return out.astype(wide)
        # wider integers (or f64 factors): bf16 would round them — compute
        # at the accumulation dtype instead
        acc = _acc_dtype(wide)
        out = jnp.matmul(a.astype(acc), b.astype(acc),
                         preferred_element_type=acc)
        return out.astype(wide)
    if a.dtype != b.dtype:
        a_bits = jnp.finfo(a.dtype).bits
        b_bits = jnp.finfo(b.dtype).bits
        narrow = a.dtype if a_bits <= b_bits else b.dtype
        wide = b.dtype if a_bits <= b_bits else a.dtype
        out = jnp.matmul(a.astype(narrow), b.astype(narrow),
                         preferred_element_type=_acc_dtype(wide))
        return out.astype(wide)
    out = jnp.matmul(a, b, preferred_element_type=_acc_dtype(a))
    return out.astype(a.dtype)


def gram(X: jax.Array) -> jax.Array:
    """X^T X -> (k, k), replicated.  psum over the sharded row axis."""
    return matmul(X.T, X)


def gram_t(X: jax.Array) -> jax.Array:
    """X X^T -> (k, k) for row-major factors H (k, n)."""
    return matmul(X, X.T)


def matmul_WTA(W: jax.Array, A: jax.Array) -> jax.Array:
    """W^T A -> (k, n), sharded like H.  psum over 'r'."""
    if is_sparse(A):
        from .ell import EllSparse, GridEllSparse, ell_wt_a, gell_wt_a
        from .sparse import (GridShardedSparse, nnz_chunk_size, rs_wt_a,
                             wt_a_bcoo)
        if isinstance(A, EllSparse):
            return ell_wt_a(A, W)
        if isinstance(A, GridEllSparse):
            return gell_wt_a(A, W)
        if isinstance(A, GridShardedSparse):
            return rs_wt_a(A, W)
        return wt_a_bcoo(A, W, nnz_chunk_size(A.nse, W.shape[1]))
    return matmul(W.T, A)


def matmul_AHT(A: jax.Array, H: jax.Array) -> jax.Array:
    """A H^T -> (m, k), sharded like W.  psum over 'c'."""
    if is_sparse(A):
        from .ell import EllSparse, GridEllSparse, ell_a_ht, gell_a_ht
        from .sparse import (GridShardedSparse, a_ht_bcoo, nnz_chunk_size,
                             rs_a_ht)
        if isinstance(A, EllSparse):
            return ell_a_ht(A, H)
        if isinstance(A, GridEllSparse):
            return gell_a_ht(A, H)
        if isinstance(A, GridShardedSparse):
            return rs_a_ht(A, H)
        return a_ht_bcoo(A, H, nnz_chunk_size(A.nse, H.shape[0]))
    return matmul(A, H.T)


def sqnorm(X: jax.Array) -> jax.Array:
    """Global squared Frobenius norm (f32/f64 accumulation)."""
    if is_sparse(X):
        from .ell import GridEllSparse, gell_sqnorm
        if isinstance(X, GridEllSparse):
            return gell_sqnorm(X)       # block-local sums + psum
        d = X.data.astype(_acc_dtype(X.data))
        return jnp.sum(d * d)
    Xa = X.astype(_acc_dtype(X))
    return jnp.sum(Xa * Xa)


def fro_norm(X: jax.Array) -> jax.Array:
    return jnp.sqrt(sqnorm(X))


def sum_axis(X: jax.Array, axis: int) -> jax.Array:
    return jnp.sum(X.astype(_acc_dtype(X)), axis=axis).astype(X.dtype)


def col_sqnorms(X: jax.Array) -> jax.Array:
    """Per-column squared L2 norms (global over the sharded row axis)."""
    Xa = X.astype(_acc_dtype(X))
    return jnp.sum(Xa * Xa, axis=0)


def _chunked_residual_reduce(A, W, H, chunk, axis):
    """sum of (A - WH)^2 and A^2 (axis=None: scalars; axis=0: per-column),
    scanning row blocks via dynamic_slice so neither the m x n residual nor
    ANY copy of A is ever materialized (jnp.pad would copy all of A — at
    flagship scale that alone exceeds HBM).  Full blocks run in a fori_loop;
    the ragged tail is one static block."""
    acc_dt = _acc_dtype(A)
    m = A.shape[0]
    n_full = m // chunk
    m1 = n_full * chunk

    def block_stats(a, w):
        r = a.astype(acc_dt) - matmul(w, H).astype(acc_dt)
        aa = a.astype(acc_dt)
        return jnp.sum(r * r, axis=axis), jnp.sum(aa * aa, axis=axis)

    def body(i, acc):
        a = lax.dynamic_slice_in_dim(A, i * chunk, chunk, 0)
        w = lax.dynamic_slice_in_dim(W, i * chunk, chunk, 0)
        dn, dd = block_stats(a, w)
        return (acc[0] + dn, acc[1] + dd)

    shape = () if axis is None else (A.shape[1],)
    zero = jnp.zeros(shape, acc_dt)
    num, den = lax.fori_loop(0, n_full, body, (zero, zero))
    if m1 < m:
        dn, dd = block_stats(A[m1:], W[m1:])
        num = num + dn
        den = den + dd
    return num, den


def relative_error(A: jax.Array, W: jax.Array, H: jax.Array,
                   chunk: int = 0) -> jax.Array:
    """||A - W H||_F / ||A||_F  (reference pyDNMF.py:204-210).

    ``chunk`` > 0 scans row blocks so the m x n residual (and the W H
    product) never materializes — at flagship scale A + W H alone take
    2 x 8.8 GB (f32).  Numerics match the direct path up to f32
    summation order."""
    if is_sparse(A):
        return _sparse_relative_error(A, W, H)
    if not chunk or chunk >= A.shape[0]:
        R = A - matmul(W, H)
        return fro_norm(R) / fro_norm(A)
    num, den = _chunked_residual_reduce(A, W, H, chunk, axis=None)
    return jnp.sqrt(num) / jnp.sqrt(den)


def column_error(A: jax.Array, W: jax.Array, H: jax.Array,
                 chunk: int = 0) -> jax.Array:
    """Per-global-column relative L2 error, length-n vector
    (reference pyDNMF.py:220-239).  ``chunk`` as in relative_error."""
    if is_sparse(A):
        return _sparse_column_error(A, W, H)
    if not chunk or chunk >= A.shape[0]:
        R = A - matmul(W, H)
        num = col_sqnorms(R)
        den = col_sqnorms(A)
        return jnp.sqrt(num / den)
    num, den = _chunked_residual_reduce(A, W, H, chunk, axis=0)
    return jnp.sqrt(num / den)


def error_chunk_rows(m: int, n: int, sharded: bool = False,
                     budget_elems: int = 1 << 27) -> int:
    """Auto row-chunk for the error passes: 0 (direct) while the residual
    stays under ~budget_elems elements (512 MB at f32) or when the array is
    mesh-sharded (per-device blocks already bound it); otherwise a row count
    that keeps each slab inside the budget."""
    if sharded or m * n <= budget_elems:
        return 0
    return max(8, (budget_elems // max(n, 1)) // 8 * 8)


def kl_divergence(A: jax.Array, W: jax.Array, H: jax.Array,
                  eps: float) -> jax.Array:
    """Generalized KL divergence D(A || WH) = sum(A log(A/WH) - A + WH)."""
    WH = matmul(W, H).astype(_acc_dtype(A)) + eps
    Aa = A.astype(_acc_dtype(A))
    return jnp.sum(jnp.where(Aa > 0, Aa * jnp.log((Aa + eps) / WH), 0.0)
                   - Aa + WH)


def quantize_uint8(A: jax.Array):
    """Global-scale uint8 quantization of a nonnegative matrix:
    Q = round(A / s), s = max(A)/255.  Returns (Q, s).

    The NMF of Q is the NMF of A with the scale folded into H (relative
    and per-column errors are scale-invariant); uint8-range inputs whose
    max is 255 — e.g. the reference's own swim.mat (uint8) — quantize
    EXACTLY (s = 1).  Worst-case resolution for general data:
    max(A)/510 per entry.

    Row-chunked: at flagship scale a full-size f32 `A/s` temp (8.8 GB)
    would double A's footprint; only a chunk-row slab ever exists."""
    scale = jnp.max(A).astype(jnp.float32) / 255.0
    scale = jnp.where(scale > 0, scale, 1.0)

    def q_block(a):
        return jnp.clip(jnp.round(a.astype(jnp.float32) / scale),
                        0, 255).astype(jnp.uint8)

    m, n = A.shape[-2], A.shape[-1]
    chunk = error_chunk_rows(m, n)
    if not chunk:
        return q_block(A), scale
    n_full = m // chunk
    m1 = n_full * chunk

    @jax.jit
    def run(A):
        def body(i, q):
            a = lax.dynamic_slice_in_dim(A, i * chunk, chunk, -2)
            return lax.dynamic_update_slice_in_dim(q, q_block(a),
                                                   i * chunk, -2)

        q = jnp.zeros(A.shape, jnp.uint8)
        q = lax.fori_loop(0, n_full, body, q)
        if m1 < m:
            q = q.at[..., m1:, :].set(q_block(A[..., m1:, :]))
        return q

    return run(A), scale


def normalize_features(W: jax.Array, H: jax.Array, eps: float):
    """L1-normalize W columns, rescale H rows (reference pyDNMF.py:184-194)."""
    s = sum_axis(W, axis=0)[None, :]
    W = W / (s + eps)
    H = H * s.T
    return W, H


# ---------------------------------------------------------------------------
# Sparse-A error identities.  ||A - WH||^2 expands to
#   ||A||^2 - 2 <A, WH> + ||WH||^2
# where <A, WH> = sum(H o (W^T A)) and ||WH||^2 = sum((W^T W) o (H H^T)) —
# every term is nnz- or k-sized; the dense m x n residual never exists.
# f32 cancellation limits accuracy to ~1e-3 relative error resolution at
# f32 (fine for NMF reconstruction errors, which are O(1e-2..1)).
# ---------------------------------------------------------------------------
def _sparse_relative_error(A, W, H):
    acc = _acc_dtype(W)
    WTA = matmul_WTA(W, A).astype(acc)        # (k, n), gather/segment path
    a2 = sqnorm(A)
    cross = jnp.sum(H.astype(acc) * WTA)
    wh2 = jnp.sum(gram(W).astype(acc) * gram_t(H).astype(acc))
    num = jnp.maximum(a2 - 2.0 * cross + wh2, 0.0)
    return jnp.sqrt(num) / jnp.sqrt(a2)


def _sparse_column_error(A, W, H):
    from .ell import (EllSparse, GridEllSparse, ell_col_sqsum,
                      gell_col_sqsum)
    from .sparse import GridShardedSparse, col_sqsum, rs_col_sqsum
    acc = _acc_dtype(W)
    WTA = matmul_WTA(W, A).astype(acc)
    cross = jnp.sum(H.astype(acc) * WTA, axis=0)              # (n,)
    WTW = gram(W).astype(acc)
    wh2 = jnp.sum(H.astype(acc) * matmul(WTW, H.astype(acc)), axis=0)
    if isinstance(A, EllSparse):
        a2 = ell_col_sqsum(A)
    elif isinstance(A, GridEllSparse):
        a2 = gell_col_sqsum(A)
    elif isinstance(A, GridShardedSparse):
        a2 = rs_col_sqsum(A, A.shape[1])
    else:
        a2 = col_sqsum(A.data, A.indices[:, 1], A.shape[1])   # (n,)
    num = jnp.maximum(a2 - 2.0 * cross + wh2, 0.0)
    return jnp.sqrt(num / jnp.maximum(a2, jnp.finfo(acc).tiny))
