"""Sparse-A products as gather + segment-sum primitives.

The reference is dense-only (its extreme-scale runs, docs/scalability.png,
were dense matrices); sparse A is a capability extension.  Everything here
is written on the raw (data, rows, cols) triplet of a canonical BCOO
matrix (unique, de-duplicated indices) using plain ``lax`` gathers and
``segment_sum`` scatters rather than ``jax.experimental.sparse`` matmul
primitives, for two reasons:

* ``bcoo_dot_general_sampled``'s default lowering materializes the dense
  m x n product and extracts — exactly the allocation sparse storage is
  supposed to avoid.  The gather form is O(nnz * k) and chunkable.
* gathers/segment_sums are ordinary dense ops with trivial ``vmap``
  batching rules, so the NMFk ensemble can map a batch of perturbed
  ``data`` vectors over shared ``indices`` (models/nmfk.py) without
  relying on BCOO batching support.

KL on sparse data is *exact* relative to the dense formula: the ratio
U = A / (W H + eps) is identically zero wherever A is zero, so U shares
A's sparsity pattern and the two MU products only ever touch nnz entries
(reference dense formula: dist_nmf.py:803-811).

The (nnz, k) gather intermediates are bounded by an nnz-chunked
``fori_loop`` when they would exceed ~512 MB (mirrors
linalg.error_chunk_rows' policy for the dense residual).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .linalg import _acc_dtype


def nnz_chunk_size(nnz: int, k: int, budget_elems: int = 1 << 27) -> int:
    """0 (direct) while the (nnz, k) gather intermediate stays under
    ~budget_elems elements; otherwise an nnz block size inside the budget."""
    if nnz * max(k, 1) <= budget_elems:
        return 0
    return max(1024, (budget_elems // max(k, 1)) // 8 * 8)


def _rows_cols(indices):
    return indices[..., 0], indices[..., 1]


def sddmm(W, H, rows, cols, chunk: int = 0):
    """(W @ H) sampled at (rows, cols) -> (nnz,), f32/f64 accumulation;
    never forms the dense product."""
    acc = _acc_dtype(W)

    def block(r, c):
        wg = W.astype(acc)[r]                  # (b, k)
        hg = H.astype(acc)[:, c]               # (k, b)
        return jnp.sum(wg * hg.T, axis=1)

    nnz = rows.shape[0]
    if not chunk or chunk >= nnz:
        return block(rows, cols)
    n_full = nnz // chunk
    e1 = n_full * chunk

    def body(i, out):
        r = lax.dynamic_slice_in_dim(rows, i * chunk, chunk, 0)
        c = lax.dynamic_slice_in_dim(cols, i * chunk, chunk, 0)
        return lax.dynamic_update_slice_in_dim(out, block(r, c),
                                               i * chunk, 0)

    out = jnp.zeros((nnz,), acc)
    out = lax.fori_loop(0, n_full, body, out)
    if e1 < nnz:
        out = out.at[e1:].set(block(rows[e1:], cols[e1:]))
    return out


def a_ht(data, rows, cols, H, m: int, chunk: int = 0):
    """A @ H^T -> (m, k) from triplet A; segment-sum over rows."""
    acc = _acc_dtype(H)
    k = H.shape[0]

    def block(d, r, c):
        vals = d.astype(acc)[:, None] * H.astype(acc)[:, c].T   # (b, k)
        return jax.ops.segment_sum(vals, r, num_segments=m)

    nnz = data.shape[0]
    if not chunk or chunk >= nnz:
        return block(data, rows, cols)
    n_full = nnz // chunk
    e1 = n_full * chunk

    def body(i, out):
        d = lax.dynamic_slice_in_dim(data, i * chunk, chunk, 0)
        r = lax.dynamic_slice_in_dim(rows, i * chunk, chunk, 0)
        c = lax.dynamic_slice_in_dim(cols, i * chunk, chunk, 0)
        return out + block(d, r, c)

    out = lax.fori_loop(0, n_full, body, jnp.zeros((m, k), acc))
    if e1 < nnz:
        out = out + block(data[e1:], rows[e1:], cols[e1:])
    return out


def wt_a(data, rows, cols, W, n: int, chunk: int = 0):
    """W^T @ A -> (k, n) from triplet A; segment-sum over cols."""
    acc = _acc_dtype(W)
    k = W.shape[1]

    def block(d, r, c):
        vals = d.astype(acc)[:, None] * W.astype(acc)[r]        # (b, k)
        return jax.ops.segment_sum(vals, c, num_segments=n)

    nnz = data.shape[0]
    if not chunk or chunk >= nnz:
        return block(data, rows, cols).T
    n_full = nnz // chunk
    e1 = n_full * chunk

    def body(i, out):
        d = lax.dynamic_slice_in_dim(data, i * chunk, chunk, 0)
        r = lax.dynamic_slice_in_dim(rows, i * chunk, chunk, 0)
        c = lax.dynamic_slice_in_dim(cols, i * chunk, chunk, 0)
        return out + block(d, r, c)

    out = lax.fori_loop(0, n_full, body, jnp.zeros((n, k), acc))
    if e1 < nnz:
        out = out + block(data[e1:], rows[e1:], cols[e1:])
    return out.T


def col_sqsum(data, cols, n: int):
    """Per-column sum of squares -> (n,), f32/f64 accumulation."""
    d = data.astype(_acc_dtype(data))
    return jax.ops.segment_sum(d * d, cols, num_segments=n)


# ---------------------------------------------------------------------------
# Grid-block-sharded triplets: multi-device sparse on the (p_r, p_c) mesh.
#
# The reference's topologies (pyDNMF.py:83-87) applied to the triplet
# format: device (i, j) holds the nnz entries of block (i, j) with LOCAL
# row/col indices, blocks nnz-padded to equal length with zero-data
# entries (zero data contributes nothing to any product, so padding is
# exact).  W is row-sharded P('r', None), H col-sharded P(None, 'c');
# products run per block under shard_map with the dense paths' collective
# contract: A Hᵀ partials psum over 'c', Wᵀ A / Wᵀ U / column reductions
# psum over 'r' (reference 1D dist_nmf.py:729-751; 2D ATW/AH_glob
# :144-205).  p_c == 1 recovers the 1D row topology.
# ---------------------------------------------------------------------------
@jax.tree_util.register_pytree_node_class
class GridShardedSparse:
    """(data, lrows, lcols) each (p_r, p_c, e_max) sharded P('r','c',∅);
    `shape` is the padded global (m, n), block = (m/p_r, n/p_c)."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, data, lrows, lcols, shape, block, mesh):
        self.data = data
        self.lrows = lrows
        self.lcols = lcols
        self.shape = tuple(shape)
        self.block = tuple(block)
        self.mesh = mesh

    def tree_flatten(self):
        return ((self.data, self.lrows, self.lcols),
                (self.shape, self.block, self.mesh))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def nse(self):
        return self.data.size

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def _e_max(self):
        return self.data.shape[-1]


class SparseGridInput:
    """Grid-sharded sparse input bundle from per-host panel reads
    (utils/io.DataReader.read_sparse_grid): the pre-sharded
    GridShardedSparse blocks + the slot -> storage-order perm + the flat
    data vector.  NMF/NMFk consume it directly, skipping the host-global
    BCOO entirely — on multi-host, no process materializes nonlocal index
    panels (only the flat values vector is replicated, for the
    positional member-noise streams).  ``shape`` is the TRUE (m, n);
    ``dims`` the mesh-padded dims of the blocks.

    Member-noise parity: the perm refers to the file's CSR storage
    order; for canonical (sorted) CSR that equals BCOO row-major order,
    so ensembles reproduce the BCOO path bit-for-bit."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, gs: "GridShardedSparse", dims, perm, data_flat,
                 shape):
        self.gs = gs
        self.dims = tuple(dims)
        self.perm = perm
        self._data = data_flat
        self.shape = tuple(shape)

    @property
    def data(self):
        return self._data

    @property
    def nse(self) -> int:
        return int(self._data.shape[0])

    @property
    def dtype(self):
        return self._data.dtype

    def astype(self, dtype):
        gs = GridShardedSparse(self.gs.data.astype(dtype), self.gs.lrows,
                               self.gs.lcols, self.gs.shape,
                               self.gs.block, self.gs.mesh)
        return SparseGridInput(gs, self.dims, self.perm,
                               self._data.astype(dtype), self.shape)


def shard_sparse_grid(A, ctx, return_perm: bool = False):
    """BCOO -> GridShardedSparse on ctx's (p_r, p_c) mesh.  Returns
    (sharded, (m_pad, n_pad)) — dims zero-padded to tile evenly; slice
    factors back at the API boundary (models/nmf.py does).

    ``return_perm=True`` additionally returns a (p_r, p_c, e_max) int32
    map from block slot to ORIGINAL nnz index (padding slots = nnz): the
    NMFk ensemble perturbs the flat COO data vector in original order and
    gathers it into blocks through this map, so the member noise streams
    are identical to the single-device sparse path."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS

    p_r, p_c = ctx.shape
    # p_e > 1 composes: the P('r','c',None) block sharding replicates the
    # shared indices over 'e', and the NMFk ensemble shards its member axis
    # over 'e' via vmap(spmd_axis_name) (models/nmfk.py)
    m, n = A.shape
    m_pad = -(-m // p_r) * p_r
    n_pad = -(-n // p_c) * p_c
    br, bc = m_pad // p_r, n_pad // p_c
    rows = np.asarray(A.indices[:, 0])
    cols = np.asarray(A.indices[:, 1])
    data = np.asarray(A.data)
    nnz = data.shape[0]
    blk = (rows // br) * p_c + (cols // bc)
    counts = np.bincount(blk, minlength=p_r * p_c)
    e_max = max(int(counts.max()), 1)
    # single stable sort partitions all blocks in one pass over nnz
    order = np.argsort(blk, kind="stable")
    rows, cols, data = rows[order], cols[order], data[order]
    starts = np.concatenate(([0], np.cumsum(counts)))
    d_p = np.zeros((p_r, p_c, e_max), data.dtype)
    r_p = np.zeros((p_r, p_c, e_max), np.int32)
    c_p = np.zeros((p_r, p_c, e_max), np.int32)
    perm = np.full((p_r, p_c, e_max), nnz, np.int32)
    for i in range(p_r):
        for j in range(p_c):
            s, e = starts[i * p_c + j], starts[i * p_c + j + 1]
            cnt = e - s
            d_p[i, j, :cnt] = data[s:e]
            r_p[i, j, :cnt] = rows[s:e] - i * br
            c_p[i, j, :cnt] = cols[s:e] - j * bc
            perm[i, j, :cnt] = order[s:e]
    sh = NamedSharding(ctx.mesh, P(ROW_AXIS, COL_AXIS, None))
    put = lambda x: jax.device_put(jnp.asarray(x), sh)
    gs = GridShardedSparse(put(d_p), put(r_p), put(c_p),
                           (m_pad, n_pad), (br, bc), ctx.mesh)
    if return_perm:
        return gs, (m_pad, n_pad), put(perm)
    return gs, (m_pad, n_pad)


def grid_sparse_format(fmt=None) -> str:
    """'ell' or 'triplet' for a sparse A on a (p_r, p_c) grid.  ``fmt``
    forces one; None picks the segment_sum triplet, the faster format on
    the CPU and, on an H100, as fast or faster than grid-ELL on a
    40000x40000 matrix at k=32 and every nnz measured, 3.2e5 to 3.2e7
    (PERF.md, "grid-ELL versus triplet")."""
    f = (fmt or "").lower() or None
    if f not in (None, "ell", "triplet"):
        raise ValueError(f"sparse_grid_format must be 'ell' or 'triplet', "
                         f"got {fmt!r}")
    return f or "triplet"


def shard_sparse_for_grid(A, ctx, fmt=None):
    """Build the grid execution format for a BCOO A on ctx's (p_r, p_c)
    mesh (single-solve path; the NMFk ensemble builds formats itself for
    the member-perm plumbing).  ``fmt`` as in grid_sparse_format; the
    per-block capped-ELL falls back to the triplet when the matrix does
    not pack, unless it was forced.  Returns (sharded, (m_pad, n_pad))."""
    if grid_sparse_format(fmt) == "ell":
        from .ell import grid_ell_pack
        E = grid_ell_pack(A, ctx)
        if E is not None:
            return E, E.shape
        if fmt:
            raise ValueError(
                "sparse_grid_format='ell' but the matrix does not "
                "ELL-pack (nnz distribution too skewed / tails too "
                "heavy); use 'triplet'")
    return shard_sparse_grid(A, ctx)


def _gs_shard_map(fn, A, in_extra, out_spec):
    """shard_map over the grid; `fn` receives flattened local triplets."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:                      # older jax
        from jax.experimental.shard_map import shard_map
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    tri = P(ROW_AXIS, COL_AXIS, None)
    specs = (tri, tri, tri) + tuple(s for _, s in in_extra)
    args = (A.data, A.lrows, A.lcols) + tuple(a for a, _ in in_extra)

    def wrapped(d, r, c, *rest):
        return fn(d.reshape(-1), r.reshape(-1), c.reshape(-1), *rest)

    return shard_map(wrapped, mesh=A.mesh, in_specs=specs,
                     out_specs=out_spec, check_vma=False)(*args)


def _gs_chunk(A, k):
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    p = A.mesh.shape[ROW_AXIS] * A.mesh.shape[COL_AXIS]
    return nnz_chunk_size(A.nse // p, k)


def rs_a_ht(A, H):
    """A @ H^T -> (m, k) sharded P('r', None); block partials psum over
    'c' (reference 2D AH_glob contract, dist_nmf.py:174-205)."""
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    br = A.block[0]
    chunk = _gs_chunk(A, H.shape[0])

    def local(d, r, c, h):
        part = a_ht(d, r, c, h, br, chunk)
        return lax.psum(part, COL_AXIS).astype(
            jnp.result_type(d.dtype, h.dtype))

    return _gs_shard_map(local, A, [(H, P(None, COL_AXIS))],
                         P(ROW_AXIS, None))


def rs_wt_a(A, W):
    """W^T A -> (k, n) sharded P(∅, 'c'); block partials psum over 'r'
    (reference ATW_glob contract, dist_nmf.py:144-172)."""
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    bc = A.block[1]
    chunk = _gs_chunk(A, W.shape[1])

    def local(d, r, c, w):
        part = wt_a(d, r, c, w, bc, chunk)
        return lax.psum(part, ROW_AXIS).astype(
            jnp.result_type(d.dtype, w.dtype))

    return _gs_shard_map(local, A, [(W, P(ROW_AXIS, None))],
                         P(None, COL_AXIS))


def rs_kl_uht(A, W, H, eps):
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    br = A.block[0]
    chunk = _gs_chunk(A, W.shape[1])

    def local(d, r, c, w, h):
        wh = sddmm(w, h, r, c, chunk)
        u = d.astype(wh.dtype) / (wh + eps)
        part = a_ht(u, r, c, h, br, chunk)
        return lax.psum(part, COL_AXIS).astype(
            jnp.result_type(d.dtype, w.dtype))

    return _gs_shard_map(local, A, [(W, P(ROW_AXIS, None)),
                                    (H, P(None, COL_AXIS))],
                         P(ROW_AXIS, None))


def rs_kl_wtu(A, W, H, eps):
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    bc = A.block[1]
    chunk = _gs_chunk(A, W.shape[1])

    def local(d, r, c, w, h):
        wh = sddmm(w, h, r, c, chunk)
        u = d.astype(wh.dtype) / (wh + eps)
        part = wt_a(u, r, c, w, bc, chunk)
        return lax.psum(part, ROW_AXIS).astype(
            jnp.result_type(d.dtype, w.dtype))

    return _gs_shard_map(local, A, [(W, P(ROW_AXIS, None)),
                                    (H, P(None, COL_AXIS))],
                         P(None, COL_AXIS))


def rs_col_sqsum(A, n: int):
    """Per-column sum of squared values -> (n,) sharded P('c')."""
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    bc = A.block[1]

    def local(d, r, c):
        return lax.psum(col_sqsum(d, c, bc), ROW_AXIS)

    return _gs_shard_map(local, A, [], P(COL_AXIS))


# ---------------------------------------------------------------------------
# backend dispatch: the execution format of a sparse A on an accelerator
# ---------------------------------------------------------------------------
def densify_for_backend(A, budget_frac: float = 0.45, allow_ell: bool = True,
                        k_hint: int = 32):
    """Pick the accelerator execution format for a sparse A from the
    per-device cost model (ops/ell.py::ell_time_model, measured by
    tools/sparse_probe.py):

    * element-level products are gather-bound while the dense path
      streams A at memory bandwidth, so above a density crossover
      moderate-density input densifies (it is FASTER, not just simpler);
    * below the crossover the dual-ELL gather path (ops/ell.py) wins and
      is kept sparse;
    * when even a dense bf16 A cannot fit the memory budget, ELL runs the
      beyond-HBM regime with O(nnz) memory.

    The dtype ladder densifies f32 input to bf16 when only bf16 fits
    (errors floor at bf16's ~3-digit resolution — same trade as
    a_precision='bfloat16').  CPU keeps the triplet path, which is
    efficient there.  ``allow_ell=False`` restores densify-or-raise (the
    NMFk ensemble batches members, where ELL's gather cost multiplies)."""
    from .linalg import is_sparse
    from .ell import EllSparse, GridEllSparse
    if (not is_sparse(A) or isinstance(A, GridShardedSparse)
            or isinstance(A, EllSparse) or isinstance(A, GridEllSparse)
            or isinstance(A, SparseGridInput)):
        return A                      # already committed to a format
    from ..parallel.mesh import on_accelerator
    if not on_accelerator():
        return A
    from ..utils.memory import device_memory_budget
    from .ell import ell_pack, ell_time_model
    import numpy as np
    m, n = A.shape
    a_bytes = jnp.dtype(A.data.dtype).itemsize
    need = m * n * a_bytes
    budget = budget_frac * device_memory_budget()

    t_ell, t_dense = ell_time_model(m, n, A.nse, k_hint, a_bytes)
    if allow_ell and t_ell < t_dense:
        ell = ell_pack(A)
        if ell is not None:
            return ell                # very sparse: gather path wins

    if need <= budget:
        dense = np.zeros(A.shape, A.data.dtype)
        dense[np.asarray(A.indices[:, 0]),
              np.asarray(A.indices[:, 1])] = np.asarray(A.data)
        return jnp.asarray(dense)
    if a_bytes > 2 and m * n * 2 <= budget:
        import warnings
        warnings.warn(
            f"sparse A densified to bfloat16 ({m * n * 2 / 1e9:.2f} GB; "
            f"f32 would exceed the {budget / 1e9:.1f} GB budget) — "
            "reconstruction errors floor at bf16 resolution")
        dense = np.zeros(A.shape, np.float32)
        dense[np.asarray(A.indices[:, 0]),
              np.asarray(A.indices[:, 1])] = np.asarray(A.data)
        return jnp.asarray(dense, jnp.bfloat16)
    if allow_ell:
        ell = ell_pack(A)
        if ell is not None:
            import warnings
            warnings.warn(
                f"sparse A exceeds the dense HBM budget even at bf16 "
                f"({m * n * 2 / 1e9:.1f} GB > {budget / 1e9:.1f} GB); "
                "running the ELL gather path (memory O(nnz), throughput "
                "gather-bound)")
            return ell
    raise ValueError(
        f"sparse A would densify to {need / 1e9:.2f} GB "
        f"(> {budget / 1e9:.1f} GB of the device budget) and its "
        "row/column nnz distribution is too skewed for ELL packing. "
        "Options: a multi-device grid (triplet blocks shrink with the "
        "mesh), or the CPU backend (jax.config.update('jax_platforms', "
        "'cpu') / --cpu) where the gather/segment path is efficient.")


# ---------------------------------------------------------------------------
# BCOO-facing wrappers
# ---------------------------------------------------------------------------
def _triplet(A):
    if A.indices.ndim != 2 or A.data.ndim != 1:
        raise ValueError(
            "sparse A must be an unbatched 2-D BCOO (n_batch=0, n_dense=0) "
            f"with canonical indices; got data {A.data.shape}, "
            f"indices {A.indices.shape}")
    rows, cols = _rows_cols(A.indices)
    return A.data, rows, cols


def a_ht_bcoo(A, H, chunk: int = 0):
    data, rows, cols = _triplet(A)
    return a_ht(data, rows, cols, H, A.shape[0], chunk).astype(
        jnp.result_type(A.data.dtype, H.dtype))


def wt_a_bcoo(A, W, chunk: int = 0):
    data, rows, cols = _triplet(A)
    return wt_a(data, rows, cols, W, A.shape[1], chunk).astype(
        jnp.result_type(A.data.dtype, W.dtype))


def kl_uht_sparse(A, W, H, eps, chunk: int = 0):
    """(A / (W H + eps)) @ H^T for sparse A: the ratio U is zero wherever
    A is (0 / x == 0), so only nnz entries exist.  Exact vs the dense
    reference formula (dist_nmf.py:803-811)."""
    data, rows, cols = _triplet(A)
    wh = sddmm(W, H, rows, cols, chunk)
    u = data.astype(wh.dtype) / (wh + eps)
    return a_ht(u, rows, cols, H, A.shape[0], chunk).astype(
        jnp.result_type(A.data.dtype, W.dtype))


def kl_wtu_sparse(A, W, H, eps, chunk: int = 0):
    """W^T @ (A / (W H + eps)) for sparse A; see kl_uht_sparse."""
    data, rows, cols = _triplet(A)
    wh = sddmm(W, H, rows, cols, chunk)
    u = data.astype(wh.dtype) / (wh + eps)
    return wt_a(u, rows, cols, W, A.shape[1], chunk).astype(
        jnp.result_type(A.data.dtype, W.dtype))
