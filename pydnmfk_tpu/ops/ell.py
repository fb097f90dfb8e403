"""ELL-packed sparse A: the accelerator compute format for the VERY sparse
regime.

Element-level sparse products on an accelerator are gather-bound: each
stored entry gathers one k-wide factor row at a random offset, while the
dense path streams A at full memory bandwidth.  ELL wins for very sparse
matrices with large m·n, and in the beyond-HBM regime where dense cannot
run at all; ``densify_for_backend`` (ops/sparse.py) applies the measured
per-device cost model (``ell_time_model``) automatically.

Format: CAPPED-WIDTH ELLPACK in BOTH orientations plus COO tails:

    rvals/rcols : (m, w_r)  per-row values / column indices (CSR-ELL)
    rtail_*     : (t_r,)    entries beyond the per-row width cap
    cvals/crows : (n, w_c)  per-column values / row indices (CSC-ELL)
    ctail_*     : (t_c,)    entries beyond the per-column width cap

Because gather cost ∝ slots, padding every row to the MAX row width
wastes 2-3x of the gathers on typical (Poisson-ish) nnz distributions;
capping the width at a high quantile and routing the overflow through the
segment_sum tail (tiny, so its lower rate never matters) removes that
waste and makes heavy-tailed matrices packable at all.  Padding slots
carry (val=0, idx=0) — inert in every product since the value multiplies
the gathered vector.  Products are gather + dense einsum + tail:

    A @ H^T  = einsum('rw,rwk->rk', rvals, Ht[rcols]) + tail_segment_sum
    W^T @ A  = einsum('cw,cwk->ck', cvals, W[crows]).T + tail

and the KL ratio U = A/(WH+eps) is formed per orientation from the SAME
gathered blocks (U is zero wherever A is, exactly as in ops/sparse.py),
so each KL product costs one gather.  Row/column blocks are chunked
through a ``fori_loop`` so the (block, w, k) gather intermediate stays
bounded.

The reference is dense-only (its extreme-scale runs were dense matrices);
this is a capability extension with no reference analog.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .linalg import _acc_dtype


@jax.tree_util.register_pytree_node_class
class EllSparse:
    """Dual-orientation capped-width ELLPACK matrix (module docstring)."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, rvals, rcols, rtail_d, rtail_r, rtail_c,
                 cvals, crows, ctail_d, ctail_r, ctail_c, shape, nse):
        self.rvals = rvals
        self.rcols = rcols
        self.rtail_d = rtail_d
        self.rtail_r = rtail_r
        self.rtail_c = rtail_c
        self.cvals = cvals
        self.crows = crows
        self.ctail_d = ctail_d
        self.ctail_r = ctail_r
        self.ctail_c = ctail_c
        self.shape = tuple(shape)
        self.nse = nse

    def tree_flatten(self):
        return ((self.rvals, self.rcols, self.rtail_d, self.rtail_r,
                 self.rtail_c, self.cvals, self.crows, self.ctail_d,
                 self.ctail_r, self.ctail_c), (self.shape, self.nse))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def dtype(self):
        return self.rvals.dtype

    @property
    def data(self):
        """Flat values view covering every entry exactly once (padding
        slots are zero — inert in sums/norms)."""
        return jnp.concatenate([self.rvals.reshape(-1), self.rtail_d])

    def astype(self, dtype):
        return EllSparse(self.rvals.astype(dtype), self.rcols,
                         self.rtail_d.astype(dtype), self.rtail_r,
                         self.rtail_c,
                         self.cvals.astype(dtype), self.crows,
                         self.ctail_d.astype(dtype), self.ctail_r,
                         self.ctail_c, self.shape, self.nse)


def ell_pack(A, max_blowup: float = 4.0, return_perms: bool = False,
             cap_q: float = 0.995, w_cap=None,
             max_tail_frac: float = 0.25):
    """BCOO -> EllSparse on the host.

    The per-row/per-column ELL width is capped at the ``cap_q`` quantile
    of the nnz-per-line distribution (override with ``w_cap`` for tests);
    overflow entries go to the COO tails.  Returns None when even the
    capped storage blows up (> max_blowup * mean + 8) or the tails exceed
    25% of nnz — callers fall back to the densify ladder.

    ``return_perms=True`` additionally returns
    (rperm (m, w_r), cperm (n, w_c), rtail_perm (t_r,), ctail_perm (t_c,)):
    slot -> ORIGINAL nnz index maps (ELL padding slots = nnz).  The NMFk
    ensemble perturbs the flat COO data vector and gathers it into both
    orientations through these, keeping member noise streams identical to
    the BCOO path."""
    import numpy as np
    m, n = A.shape
    rows = np.asarray(A.indices[:, 0])
    cols = np.asarray(A.indices[:, 1])
    vals = np.asarray(A.data)
    nnz = vals.shape[0]
    if nnz == 0:
        return None

    def pack(keys, others, dim):
        counts = np.bincount(keys, minlength=dim)
        w = int(w_cap) if w_cap else max(
            int(np.quantile(counts, cap_q)), 1)
        w = min(w, max(int(counts.max()), 1))
        if w > max_blowup * max(nnz / dim, 1.0) + 8:
            return None
        order = np.argsort(keys, kind="stable")
        ks, os_, vs = keys[order], others[order], vals[order]
        starts = np.zeros(dim + 1, np.int64)
        starts[1:] = np.cumsum(counts)
        slot = np.arange(nnz) - starts[ks]
        main = slot < w
        tail = ~main
        if tail.sum() > max_tail_frac * nnz:
            return None                  # too heavy-tailed: not worth ELL
        v = np.zeros((dim, w), vals.dtype)
        i = np.zeros((dim, w), np.int32)
        p = np.full((dim, w), nnz, np.int32)
        v[ks[main], slot[main]] = vs[main]
        i[ks[main], slot[main]] = os_[main]
        p[ks[main], slot[main]] = order[main]
        t_key = ks[tail].astype(np.int32)
        t_other = os_[tail].astype(np.int32)
        t_val = vs[tail]
        t_perm = order[tail].astype(np.int32)
        return v, i, t_val, t_key, t_other, p, t_perm

    r = pack(rows, cols, m)
    c = pack(cols, rows, n)
    if r is None or c is None:
        return None
    E = EllSparse(
        jnp.asarray(r[0]), jnp.asarray(r[1]), jnp.asarray(r[2]),
        jnp.asarray(r[3]), jnp.asarray(r[4]),
        jnp.asarray(c[0]), jnp.asarray(c[1]), jnp.asarray(c[2]),
        jnp.asarray(c[4]), jnp.asarray(c[3]),     # ctail: (d, row, col)
        (m, n), nnz)
    if return_perms:
        return (E, jnp.asarray(r[5]), jnp.asarray(c[5]),
                jnp.asarray(r[6]), jnp.asarray(c[6]))
    return E


# ---------------------------------------------------------------------------
# products (generic over orientation): out[b] = sum_s vals[b,s] * M[idx[b,s]]
# optionally through the sampled ratio u = vals / (<G, x_b> + eps)
# ---------------------------------------------------------------------------
def _block_rows(dim: int, w: int, k: int,
                budget_elems: int = 1 << 26) -> int:
    """Rows per chunk so the (block, w, k) gather stays under ~256 MB."""
    per_row = max(w * k, 1)
    if dim * per_row <= budget_elems:
        return dim
    return max(8, (budget_elems // per_row) // 8 * 8)


@jax.custom_batching.custom_vmap
def _take_rows(table, flat_idx):
    """table[(S,)-indices] -> (S, k), with a batching rule that stacks
    member tables into ONE wide gather when the indices are shared.

    Inside the full compiled ensemble solve (the fori_loop + error
    program) the default batched gather lowers to b narrow gathers; one
    wide gather of the stacked tables reads each index once
    (tools/ell_stack_ab.py times both)."""
    return jnp.take(table, flat_idx, axis=0)


@_take_rows.def_vmap
def _take_rows_vmap(axis_size, in_batched, table, flat_idx):
    tab_b, idx_b = in_batched
    if idx_b:
        # member-specific indices: no shared-slot structure to exploit
        tab = (table if tab_b
               else jnp.broadcast_to(table, (axis_size,) + table.shape))
        out = jax.vmap(lambda t, i: jnp.take(t, i, axis=0))(tab, flat_idx)
        return out, True
    if not tab_b:
        return jnp.take(table, flat_idx, axis=0), False
    b, n, k = table.shape
    wide = jnp.moveaxis(table, 0, 1).reshape(n, b * k)
    out = jnp.take(wide, flat_idx, axis=0)           # ONE wide gather
    return jnp.moveaxis(out.reshape(-1, b, k), 1, 0), True


def _gather_product(vals, idx, M, ratio_with=None, eps=0.0):
    """sum_s vals[b,s] * M[idx[b,s]] -> (dim, k); with ``ratio_with`` (a
    (dim, k) matrix X) the coefficient becomes the KL ratio
    vals / (sum_k X[b,k] M[idx[b,s],k] + eps) * ... i.e. U-slot values."""
    acc = _acc_dtype(M)
    dim, w = vals.shape
    k = M.shape[1]
    Ma = M.astype(acc)

    def block(v, i, x):
        g = _take_rows(Ma, i.reshape(-1)).reshape(v.shape[0], w, k)
        coef = v.astype(acc)
        if x is not None:
            wh = jnp.einsum("bk,bwk->bw", x.astype(acc), g,
                            preferred_element_type=acc)
            coef = coef / (wh + eps)
        return jnp.einsum("bw,bwk->bk", coef, g,
                          preferred_element_type=acc)

    bm = _block_rows(dim, w, k)
    if bm >= dim:
        return block(vals, idx, ratio_with)
    n_full = dim // bm
    d1 = n_full * bm

    def body(t, out):
        v = lax.dynamic_slice_in_dim(vals, t * bm, bm, 0)
        i = lax.dynamic_slice_in_dim(idx, t * bm, bm, 0)
        x = (None if ratio_with is None
             else lax.dynamic_slice_in_dim(ratio_with, t * bm, bm, 0))
        return lax.dynamic_update_slice_in_dim(out, block(v, i, x),
                                               t * bm, 0)

    out = jnp.zeros((dim, k), acc)
    out = lax.fori_loop(0, n_full, body, out)
    if d1 < dim:
        x = None if ratio_with is None else ratio_with[d1:]
        out = out.at[d1:].set(block(vals[d1:], idx[d1:], x))
    return out


def ell_a_ht(A: EllSparse, H):
    """A @ H^T -> (m, k)."""
    out = _gather_product(A.rvals, A.rcols, H.T)
    if A.rtail_d.shape[0]:
        from .sparse import a_ht
        out = out + a_ht(A.rtail_d, A.rtail_r, A.rtail_c, H, A.shape[0])
    return out.astype(jnp.result_type(A.dtype, H.dtype))


def ell_wt_a(A: EllSparse, W):
    """W^T @ A -> (k, n)."""
    out = _gather_product(A.cvals, A.crows, W)
    if A.ctail_d.shape[0]:
        from .sparse import wt_a
        out = out + wt_a(A.ctail_d, A.ctail_r, A.ctail_c, W,
                         A.shape[1]).T
    return out.T.astype(jnp.result_type(A.dtype, W.dtype))


def ell_kl_uht(A: EllSparse, W, H, eps):
    """(A / (WH + eps)) @ H^T -> (m, k); U shares A's sparsity pattern."""
    out = _gather_product(A.rvals, A.rcols, H.T, ratio_with=W, eps=eps)
    if A.rtail_d.shape[0]:
        from .sparse import a_ht, sddmm
        wh = sddmm(W, H, A.rtail_r, A.rtail_c)
        u = A.rtail_d.astype(wh.dtype) / (wh + eps)
        out = out + a_ht(u, A.rtail_r, A.rtail_c, H, A.shape[0])
    return out.astype(jnp.result_type(A.dtype, W.dtype))


def ell_kl_wtu(A: EllSparse, W, H, eps):
    """W^T @ (A / (WH + eps)) -> (k, n)."""
    out = _gather_product(A.cvals, A.crows, W, ratio_with=H.T, eps=eps)
    if A.ctail_d.shape[0]:
        from .sparse import sddmm, wt_a
        wh = sddmm(W, H, A.ctail_r, A.ctail_c)
        u = A.ctail_d.astype(wh.dtype) / (wh + eps)
        out = out + wt_a(u, A.ctail_r, A.ctail_c, W, A.shape[1]).T
    return out.T.astype(jnp.result_type(A.dtype, W.dtype))


def ell_col_sqsum(A: EllSparse):
    """Per-column sum of squares -> (n,)."""
    c = A.cvals.astype(_acc_dtype(A.cvals))
    out = jnp.sum(c * c, axis=1)
    if A.ctail_d.shape[0]:
        from .sparse import col_sqsum
        out = out + col_sqsum(A.ctail_d, A.ctail_c, A.shape[1])
    return out


# ---------------------------------------------------------------------------
# GRID-sharded capped-ELL: per-block dual-ELL (+COO tails) under
# shard_map, so the very-sparse gather path runs on ('r','c') meshes —
# and, via the NMFk ensemble's vmap(spmd_axis_name='e'), in three-way
# ('e','r','c') parallelism — beside the segment_sum triplet path
# (ops/sparse.py::grid_sparse_format picks between them).  Device (i, j)
# holds block (i, j)'s rows/columns ELL-packed with block-LOCAL indices;
# widths and tail lengths are shared across blocks (SPMD-uniform shapes),
# padding slots carry zero values (inert in every product).  Collective
# contract matches the dense/triplet paths: A Hᵀ partials psum over 'c',
# Wᵀ A / column reductions psum over 'r' (reference dist_nmf.py:144-205).
# ---------------------------------------------------------------------------
@jax.tree_util.register_pytree_node_class
class GridEllSparse:
    """Per-block dual-orientation capped-width ELLPACK on a (p_r, p_c)
    mesh.  4-d containers (p_r, p_c, lines_local, w) sharded
    P('r','c',∅,∅); tails (p_r, p_c, t) sharded P('r','c',∅).  ``shape``
    is the padded global (m, n); ``block`` = (m/p_r, n/p_c)."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, rvals, rcols, rtail_d, rtail_r, rtail_c,
                 cvals, crows, ctail_d, ctail_r, ctail_c,
                 shape, block, nse, mesh):
        self.rvals = rvals
        self.rcols = rcols
        self.rtail_d = rtail_d
        self.rtail_r = rtail_r
        self.rtail_c = rtail_c
        self.cvals = cvals
        self.crows = crows
        self.ctail_d = ctail_d
        self.ctail_r = ctail_r
        self.ctail_c = ctail_c
        self.shape = tuple(shape)
        self.block = tuple(block)
        self.nse = nse
        self.mesh = mesh

    def tree_flatten(self):
        return ((self.rvals, self.rcols, self.rtail_d, self.rtail_r,
                 self.rtail_c, self.cvals, self.crows, self.ctail_d,
                 self.ctail_r, self.ctail_c),
                (self.shape, self.block, self.nse, self.mesh))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def dtype(self):
        return self.rvals.dtype

    def astype(self, dtype):
        return GridEllSparse(
            self.rvals.astype(dtype), self.rcols,
            self.rtail_d.astype(dtype), self.rtail_r, self.rtail_c,
            self.cvals.astype(dtype), self.crows,
            self.ctail_d.astype(dtype), self.ctail_r, self.ctail_c,
            self.shape, self.block, self.nse, self.mesh)


def grid_ell_pack(A, ctx, cap_q: float = 0.995, max_blowup: float = 4.0,
                  max_tail_frac: float = 0.25, w_cap=None,
                  return_perms: bool = False):
    """BCOO -> GridEllSparse on ctx's (p_r, p_c) mesh (host side).

    Same capping policy as ``ell_pack``, applied to block-local lines with
    ONE shared width per orientation (SPMD shapes must agree across
    blocks).  Returns None when the capped storage blows up or the tails
    exceed ``max_tail_frac`` — callers fall back to the triplet grid.

    ``return_perms=True`` additionally returns slot -> ORIGINAL nnz index
    maps for all four value containers (padding slots = nnz), which the
    NMFk ensemble uses to gather batched member data vectors into block
    layout (member noise streams stay identical to every other path)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS

    p_r, p_c = ctx.shape
    m, n = A.shape
    m_pad = -(-m // p_r) * p_r
    n_pad = -(-n // p_c) * p_c
    br, bc = m_pad // p_r, n_pad // p_c
    rows = np.asarray(A.indices[:, 0])
    cols = np.asarray(A.indices[:, 1])
    vals = np.asarray(A.data)
    nnz = vals.shape[0]
    if nnz == 0:
        return None
    blk = (rows // br) * p_c + (cols // bc)
    nb = p_r * p_c

    def pack(line_ids, n_lines, lines_per_blk, others):
        counts = np.bincount(line_ids, minlength=n_lines)
        w = int(w_cap) if w_cap else max(int(np.quantile(counts, cap_q)), 1)
        w = min(w, max(int(counts.max()), 1))
        if w * n_lines > max_blowup * nnz + 8 * n_lines:
            return None
        order = np.argsort(line_ids, kind="stable")
        ls, os_, vs = line_ids[order], others[order], vals[order]
        starts = np.zeros(n_lines + 1, np.int64)
        starts[1:] = np.cumsum(counts)
        slot = np.arange(nnz) - starts[ls]
        main = slot < w
        tail = ~main
        if tail.sum() > max_tail_frac * nnz:
            return None
        v = np.zeros((n_lines, w), vals.dtype)
        i = np.zeros((n_lines, w), np.int32)
        p = np.full((n_lines, w), nnz, np.int32)
        v[ls[main], slot[main]] = vs[main]
        i[ls[main], slot[main]] = os_[main]
        p[ls[main], slot[main]] = order[main]
        # per-block tails, padded to a shared length
        t_blk = (ls[tail] // lines_per_blk).astype(np.int64)
        t_counts = np.bincount(t_blk, minlength=nb)
        t_max = int(t_counts.max()) if t_counts.size else 0
        td = np.zeros((nb, t_max), vals.dtype)
        tl = np.zeros((nb, t_max), np.int32)    # line (local) index
        to = np.zeros((nb, t_max), np.int32)    # other (local) index
        tp = np.full((nb, t_max), nnz, np.int32)
        t_starts = np.zeros(nb + 1, np.int64)
        t_starts[1:] = np.cumsum(t_counts)
        t_slot = np.arange(int(tail.sum())) - t_starts[t_blk]
        td[t_blk, t_slot] = vs[tail]
        tl[t_blk, t_slot] = (ls[tail] % lines_per_blk).astype(np.int32)
        to[t_blk, t_slot] = os_[tail]
        tp[t_blk, t_slot] = order[tail]
        shape4 = (p_r, p_c, lines_per_blk, w)
        shape3 = (p_r, p_c, t_max)
        return (v.reshape(shape4), i.reshape(shape4),
                td.reshape(shape3), tl.reshape(shape3),
                to.reshape(shape3), p.reshape(shape4),
                tp.reshape(shape3))

    # row orientation: line = (block, local row); others = local col
    r = pack(blk * br + rows % br, nb * br, br, (cols % bc).astype(np.int32))
    # col orientation: line = (block, local col); others = local row
    c = pack(blk * bc + cols % bc, nb * bc, bc, (rows % br).astype(np.int32))
    if r is None or c is None:
        return None
    sh4 = NamedSharding(ctx.mesh, P(ROW_AXIS, COL_AXIS, None, None))
    sh3 = NamedSharding(ctx.mesh, P(ROW_AXIS, COL_AXIS, None))
    put4 = lambda x: jax.device_put(jnp.asarray(x), sh4)
    put3 = lambda x: jax.device_put(jnp.asarray(x), sh3)
    E = GridEllSparse(
        put4(r[0]), put4(r[1]), put3(r[2]), put3(r[3]), put3(r[4]),
        put4(c[0]), put4(c[1]), put3(c[2]), put3(c[4]), put3(c[3]),
        (m_pad, n_pad), (br, bc), nnz, ctx.mesh)
    if return_perms:
        return (E, put4(r[5]), put4(c[5]), put3(r[6]), put3(c[6]))
    return E


def _gell_shard_map(fn, A: GridEllSparse, containers, in_extra, out_spec):
    """shard_map over the grid; `fn` receives the LOCAL blocks (leading
    (1, 1) dims stripped) of the named containers plus the extras."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:                      # older jax
        from jax.experimental.shard_map import shard_map
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    args, specs = [], []
    for name in containers:
        arr = getattr(A, name)
        args.append(arr)
        specs.append(P(ROW_AXIS, COL_AXIS, *([None] * (arr.ndim - 2))))
    specs += [s for _, s in in_extra]
    args += [a for a, _ in in_extra]

    def wrapped(*xs):
        local = [x.reshape(x.shape[2:]) for x in xs[:len(containers)]]
        return fn(*local, *xs[len(containers):])

    return shard_map(wrapped, mesh=A.mesh, in_specs=tuple(specs),
                     out_specs=out_spec, check_vma=False)(*args)


def gell_a_ht(A: GridEllSparse, H):
    """A @ H^T -> (m, k) sharded P('r', ∅); block partials psum over 'c'."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    br = A.block[0]

    def local(rv, rc, td, tr, tc, h):
        out = _gather_product(rv, rc, h.T)
        if td.shape[0]:
            from .sparse import a_ht
            out = out + a_ht(td, tr, tc, h, br)
        return lax.psum(out, COL_AXIS).astype(
            jnp.result_type(rv.dtype, h.dtype))

    return _gell_shard_map(
        local, A, ("rvals", "rcols", "rtail_d", "rtail_r", "rtail_c"),
        [(H, P(None, COL_AXIS))], P(ROW_AXIS, None))


def gell_wt_a(A: GridEllSparse, W):
    """W^T @ A -> (k, n) sharded P(∅, 'c'); block partials psum over 'r'."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    bc = A.block[1]

    def local(cv, cr, td, tr, tc, w):
        out = _gather_product(cv, cr, w)
        if td.shape[0]:
            from .sparse import wt_a
            out = out + wt_a(td, tr, tc, w, bc).T
        return lax.psum(out.T, ROW_AXIS).astype(
            jnp.result_type(cv.dtype, w.dtype))

    return _gell_shard_map(
        local, A, ("cvals", "crows", "ctail_d", "ctail_r", "ctail_c"),
        [(W, P(ROW_AXIS, None))], P(None, COL_AXIS))


def gell_kl_uht(A: GridEllSparse, W, H, eps):
    """(A / (WH + eps)) @ H^T -> (m, k) P('r', ∅); U shares A's pattern."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    br = A.block[0]

    def local(rv, rc, td, tr, tc, w, h):
        out = _gather_product(rv, rc, h.T, ratio_with=w, eps=eps)
        if td.shape[0]:
            from .sparse import a_ht, sddmm
            wh = sddmm(w, h, tr, tc)
            u = td.astype(wh.dtype) / (wh + eps)
            out = out + a_ht(u, tr, tc, h, br)
        return lax.psum(out, COL_AXIS).astype(
            jnp.result_type(rv.dtype, w.dtype))

    return _gell_shard_map(
        local, A, ("rvals", "rcols", "rtail_d", "rtail_r", "rtail_c"),
        [(W, P(ROW_AXIS, None)), (H, P(None, COL_AXIS))],
        P(ROW_AXIS, None))


def gell_kl_wtu(A: GridEllSparse, W, H, eps):
    """W^T @ (A / (WH + eps)) -> (k, n) P(∅, 'c')."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    bc = A.block[1]

    def local(cv, cr, td, tr, tc, w, h):
        out = _gather_product(cv, cr, w, ratio_with=h.T, eps=eps)
        if td.shape[0]:
            from .sparse import sddmm, wt_a
            wh = sddmm(w, h, tr, tc)
            u = td.astype(wh.dtype) / (wh + eps)
            out = out + wt_a(u, tr, tc, w, bc).T
        return lax.psum(out.T, ROW_AXIS).astype(
            jnp.result_type(cv.dtype, w.dtype))

    return _gell_shard_map(
        local, A, ("cvals", "crows", "ctail_d", "ctail_r", "ctail_c"),
        [(W, P(ROW_AXIS, None)), (H, P(None, COL_AXIS))],
        P(None, COL_AXIS))


def gell_col_sqsum(A: GridEllSparse):
    """Per-column sum of squares -> (n,) sharded P('c')."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS

    def local(cv, td, tc):
        c = cv.astype(_acc_dtype(cv))
        out = jnp.sum(c * c, axis=1)
        if td.shape[0]:
            t = td.astype(out.dtype)
            out = out + jax.ops.segment_sum(t * t, tc,
                                            num_segments=cv.shape[0])
        return lax.psum(out, ROW_AXIS)

    return _gell_shard_map(local, A, ("cvals", "ctail_d", "ctail_c"), [],
                           P(COL_AXIS))


def gell_sqnorm(A: GridEllSparse):
    """Global sum of squared values (padding slots are zero — exact)."""
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import COL_AXIS, ROW_AXIS

    def local(rv, td):
        r = rv.astype(_acc_dtype(rv))
        t = td.astype(r.dtype)
        return lax.psum(jnp.sum(r * r) + jnp.sum(t * t),
                        (ROW_AXIS, COL_AXIS))

    return _gell_shard_map(local, A, ("rvals", "rtail_d"), [], P())


# Per-device constants of the sparse cost model, keyed by
# ``jax.Device.device_kind``.  tools/sparse_probe.py measures every field.
#   floor_s    fixed cost of one gather product (launch + fusion overhead)
#   slot_s     seconds per gathered slot while rows are narrow (k*4 bytes
#              below the gather's byte-bound width)
#   gather_Bps gathered bytes per second once rows are wide
#   dense_Bps  bytes per second the dense A@Hᵀ product streams A at
SPARSE_COST_TABLE = {
    "NVIDIA H100 80GB HBM3": {
        "floor_s": 1.0909449999848188e-04,
        "slot_s": 6.236058189797361e-11,
        "gather_Bps": 3.3082630368516646e12,
        "dense_Bps": 1.7310096502069954e12,
        "source": "tools/sparse_probe.py on an NVIDIA H100 80GB HBM3 "
                  "at a 700 W power limit",
    },
}


def ell_time_model(m: int, n: int, nse: int, k: int, a_bytes: int = 4,
                   device_kind: str = None) -> tuple:
    """(t_ell, t_dense): rough seconds of one A-sized product as an ELL
    gather and as a dense stream of A, on ``device_kind`` (default: the
    first device).  The gather costs a per-product floor plus one k-wide
    factor row per stored entry, bound by the slot rate for narrow rows
    and by gathered bytes for wide ones; the dense product streams
    m·n·a_bytes.  Coarse on purpose: it only orders the two formats for
    the densify policy.  A device kind that was never measured is an
    error, never a default."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    c = SPARSE_COST_TABLE.get(device_kind)
    if c is None:
        raise ValueError(
            f"no sparse cost constants for device kind {device_kind!r} "
            f"(measured: {sorted(SPARSE_COST_TABLE)}); run "
            "tools/sparse_probe.py on it and add its row to "
            "ops/ell.py::SPARSE_COST_TABLE")
    t_ell = c["floor_s"] + nse * max(c["slot_s"], k * 4 / c["gather_Bps"])
    t_dense = m * n * a_bytes / c["dense_Bps"]
    return t_ell, t_dense
