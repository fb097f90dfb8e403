"""One-step NMF update rules (MU-Fro, MU-KL, HALS) and the BCD solver.

Re-design of the reference update kernels
(pyDNMFk/dist_nmf.py).  Two deliberate structural departures:

* **No 1D/2D split.**  The reference implements every rule twice
  (nmf_algorithms_1D :582-1047 vs nmf_algorithms_2D :7-579) differing only in
  hand-placed MPI collectives.  Here each rule is written once on global
  arrays; the mesh sharding decides the collectives.

* **Pure functions, jit-compiled once.**  The reference constructs a fresh
  update object per iteration (pyDNMF.py:154,169); here the driver traces a
  single ``lax.fori_loop`` body.

Numerical semantics are kept identical to the reference (documented
per-function) so the convergence-threshold and golden-value tests transfer.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import linalg
from ..ops.kl import kl_uht, kl_wtu


# ---------------------------------------------------------------------------
# Multiplicative updates, Frobenius norm  (reference Fro_MU_update_{W,H}:
# 1D dist_nmf.py:715-751, 2D :207-263)
# ---------------------------------------------------------------------------
def mu_fro_step(A, W, H, eps, W_update=True):
    if W_update:
        HHT = linalg.gram_t(H)                      # (k,k) psum over 'c'
        AHT = linalg.matmul_AHT(A, H)               # (m,k) psum over 'c'
        W = W * AHT / (linalg.matmul(W, HHT) + eps)
    WTW = linalg.gram(W)                            # (k,k) psum over 'r'
    WTA = linalg.matmul_WTA(W, A)                   # (k,n) psum over 'r'
    # reference: H *= AtW / (H^T W^T W)^T == WTW @ H (WTW symmetric)
    H = H * WTA / (linalg.matmul(WTW, H) + eps)
    return W, H


# ---------------------------------------------------------------------------
# Multiplicative updates, KL divergence  (reference KL_MU_update_{W,H}:
# 1D dist_nmf.py:803-849, 2D :293-407)
# ---------------------------------------------------------------------------
def mu_kl_step(A, W, H, eps, W_update=True, chunk=0, mesh=None):
    """``mesh`` routes the two bounded-memory products through shard_map
    (ops/kl.py::kl_*_sharded) so the chunked single-shard products run
    per device block — the multi-device equivalent of the reference's 2D KL
    path (dist_nmf.py:293-343) without a full m x n intermediate."""
    if linalg.is_sparse(A):
        # triplet path: U shares A's sparsity pattern exactly (0/x == 0),
        # so both products touch only nnz entries (ops/sparse.py); the
        # chunk/mesh machinery is dense-only and unused here.
        # Row-sharded triplets run per block under shard_map (the dense
        # 1D topology's collective contract).
        from ..ops.ell import (EllSparse, GridEllSparse, ell_kl_uht,
                               ell_kl_wtu, gell_kl_uht, gell_kl_wtu)
        from ..ops.sparse import (GridShardedSparse, kl_uht_sparse,
                                  kl_wtu_sparse, nnz_chunk_size,
                                  rs_kl_uht, rs_kl_wtu)
        if isinstance(A, EllSparse):
            uht = lambda a, w, h: ell_kl_uht(a, w, h, eps)
            wtu = lambda a, w, h: ell_kl_wtu(a, w, h, eps)
        elif isinstance(A, GridEllSparse):
            uht = lambda a, w, h: gell_kl_uht(a, w, h, eps)
            wtu = lambda a, w, h: gell_kl_wtu(a, w, h, eps)
        elif isinstance(A, GridShardedSparse):
            uht = lambda a, w, h: rs_kl_uht(a, w, h, eps)
            wtu = lambda a, w, h: rs_kl_wtu(a, w, h, eps)
        else:
            nc = nnz_chunk_size(A.nse, W.shape[1])
            uht = lambda a, w, h: kl_uht_sparse(a, w, h, eps, nc)
            wtu = lambda a, w, h: kl_wtu_sparse(a, w, h, eps, nc)
    elif mesh is not None:
        from ..ops.kl import kl_uht_sharded, kl_wtu_sharded
        uht = lambda a, w, h: kl_uht_sharded(a, w, h, eps, mesh, chunk)
        wtu = lambda a, w, h: kl_wtu_sharded(a, w, h, eps, mesh, chunk)
    else:
        uht = lambda a, w, h: kl_uht(a, w, h, eps, chunk)
        wtu = lambda a, w, h: kl_wtu(a, w, h, eps, chunk)
    if W_update:
        h_rowsum = linalg.sum_axis(H, axis=1)       # (k,) psum over 'c'
        UHT = uht(A, W, H)                          # (m,k)
        W = W * UHT / (h_rowsum[None, :] + eps)
    w_colsum = linalg.sum_axis(W, axis=0)           # (k,) psum over 'r'
    WTU = wtu(A, W, H)                              # (k,n), uses updated W
    H = H * WTU / (w_colsum[:, None] + eps)
    return W, H


# ---------------------------------------------------------------------------
# HALS, Frobenius norm  (reference FRO_HALS_update_{W,H}:
# 1D dist_nmf.py:873-934, 2D :411-470)
# ---------------------------------------------------------------------------
def _hals_w_cols(W, HHT, AHT, eps, lo, hi):
    """Reference-structured per-column W sweep over columns [lo, hi)."""
    def w_col(kk, W):
        hht_col = lax.dynamic_slice_in_dim(HHT, kk, 1, axis=1)[:, 0]
        aht_col = lax.dynamic_slice_in_dim(AHT, kk, 1, axis=1)[:, 0]
        w_col_cur = lax.dynamic_slice_in_dim(W, kk, 1, axis=1)[:, 0]
        v = w_col_cur * HHT[kk, kk] + aht_col - linalg.matmul(W, hht_col)
        v = jnp.maximum(v, eps)
        # global L2 column normalization (reference :889-893)
        ss = jnp.sqrt(linalg.sqnorm(v)).astype(W.dtype)
        v = jnp.where(ss > 0, v / ss, v)
        return lax.dynamic_update_slice_in_dim(W, v[:, None], kk, axis=1)

    return lax.fori_loop(lo, hi, w_col, W, unroll=4)


def _hals_h_rows(H, WTW, WTA, eps, lo, hi):
    """Reference-structured per-row H sweep over rows [lo, hi)."""
    def h_row(kk, H):
        wtw_row = lax.dynamic_slice_in_dim(WTW, kk, 1, axis=0)[0]
        wta_row = lax.dynamic_slice_in_dim(WTA, kk, 1, axis=0)[0]
        h_row_cur = lax.dynamic_slice_in_dim(H, kk, 1, axis=0)[0]
        # reference :912 relies on W columns being L2-normalized (WTW[kk,kk]=1)
        v = h_row_cur + wta_row - linalg.matmul(wtw_row, H)
        v = jnp.maximum(v, eps)
        return lax.dynamic_update_slice_in_dim(H, v[None, :], kk, axis=0)

    return lax.fori_loop(lo, hi, h_row, H, unroll=4)


def _hals_w_blocked(W, HHT, AHT, eps, B):
    """EXACT Gauss-Seidel W sweep via LAPACK-style blocked delayed
    updates: the per-column (m, k) matvec against the half-updated W is
    decomposed into P = W_old @ HHT (one matmul), an in-block (m, B)
    correction matvec per column, and one rank-B update of P per
    block.  Algebraically identical to the column-by-column sweep (only
    summation order differs); the serial chain's per-column work drops
    from m*k to m*B, for large k where that matvec chain binds."""
    m, k = W.shape
    nb = k // B
    P = linalg.matmul(W, HHT)                        # (m, k), W = old

    def block_body(b, WP):
        W, P = WP
        b0 = b * B
        Wblk = lax.dynamic_slice(W, (0, b0), (m, B))
        HHT_blk = lax.dynamic_slice(HHT, (b0, 0), (B, k))

        def col_body(t, D):
            j = b0 + t
            hseg = lax.dynamic_slice(HHT_blk, (0, j), (B, 1))[:, 0]
            mask = (jnp.arange(B) < t).astype(D.dtype)
            corr = linalg.matmul(D, hseg.astype(D.dtype) * mask)
            w_old = lax.dynamic_slice(Wblk, (0, t), (m, 1))[:, 0]
            p_j = lax.dynamic_slice(P, (0, j), (m, 1))[:, 0]
            aht_j = lax.dynamic_slice(AHT, (0, j), (m, 1))[:, 0]
            v = w_old * hseg[t] + aht_j - (p_j + corr)
            v = jnp.maximum(v, eps)
            ss = jnp.sqrt(linalg.sqnorm(v)).astype(W.dtype)
            v = jnp.where(ss > 0, v / ss, v)
            return lax.dynamic_update_slice(D, (v - w_old)[:, None], (0, t))

        D = lax.fori_loop(0, B, col_body, jnp.zeros((m, B), W.dtype))
        W = lax.dynamic_update_slice(W, Wblk + D, (0, b0))
        P = P + linalg.matmul(D, HHT_blk)
        return (W, P)

    W, _ = lax.fori_loop(0, nb, block_body, (W, P))
    if k % B:   # ragged tail: standard sweep on the (now updated) prefix
        W = _hals_w_cols(W, HHT, AHT, eps, nb * B, k)
    return W


def _hals_h_blocked(H, WTW, WTA, eps, B):
    """Blocked delayed-update H sweep (mirror of _hals_w_blocked; the H
    rows carry no normalization, so the chain is pure delayed updates)."""
    k, n = H.shape
    nb = k // B
    P = linalg.matmul(WTW, H)                        # (k, n), H = old

    def block_body(b, HP):
        H, P = HP
        b0 = b * B
        Hblk = lax.dynamic_slice(H, (b0, 0), (B, n))
        WTW_blk = lax.dynamic_slice(WTW, (0, b0), (k, B))

        def row_body(t, D):
            j = b0 + t
            wseg = lax.dynamic_slice(WTW_blk, (t + b0, 0), (1, B))[0]
            mask = (jnp.arange(B) < t).astype(D.dtype)
            corr = linalg.matmul(wseg.astype(D.dtype) * mask, D)
            h_old = lax.dynamic_slice(Hblk, (t, 0), (1, n))[0]
            p_j = lax.dynamic_slice(P, (j, 0), (1, n))[0]
            wta_j = lax.dynamic_slice(WTA, (j, 0), (1, n))[0]
            # reference :912 form (WTW[jj] = 1 after W normalization)
            v = h_old + wta_j - (p_j + corr)
            v = jnp.maximum(v, eps)
            return lax.dynamic_update_slice(D, (v - h_old)[None, :], (t, 0))

        D = lax.fori_loop(0, B, row_body, jnp.zeros((B, n), H.dtype))
        H = lax.dynamic_update_slice(H, Hblk + D, (b0, 0))
        P = P + linalg.matmul(WTW_blk, D)
        return (H, P)

    H, _ = lax.fori_loop(0, nb, block_body, (H, P))
    if k % B:
        H = _hals_h_rows(H, WTW, WTA, eps, nb * B, k)
    return H


def hals_step(A, W, H, eps, W_update=True, block=None):
    """``block``: 0/None = the reference-structured column-by-column
    sweep (the default); > 0 = LAPACK-style delayed-update blocks of that
    size.  Both paths are exact Gauss-Seidel (same fixed point, same
    update order; only fp summation order differs —
    tests/test_nmf_solvers.py pins sweep-level equality).

    Blocking trades the per-column (m, k) matvec for an extra P-matrix
    pass and rank-B updates; it pays only where the matvec chain binds,
    so it stays opt-in (tools/hals_block_probe.py times both)."""
    k = W.shape[1]
    B = block or 0

    if W_update:
        HHT = linalg.gram_t(H)                      # (k,k)
        AHT = linalg.matmul_AHT(A, H)               # (m,k)
        if B and B < k:
            W = _hals_w_blocked(W, HHT, AHT, eps, B)
        else:
            W = _hals_w_cols(W, HHT, AHT, eps, 0, k)

    WTW = linalg.gram(W)
    WTA = linalg.matmul_WTA(W, A)
    if B and B < k:
        H = _hals_h_blocked(H, WTW, WTA, eps, B)
    else:
        H = _hals_h_rows(H, WTW, WTA, eps, 0, k)
    return W, H


# ---------------------------------------------------------------------------
# BCD (block coordinate descent with Nesterov-style extrapolation),
# Frobenius norm  (reference FRO_BCD_update: 1D dist_nmf.py:951-1047,
# 2D :482-579).  Unlike MU/HALS this is a complete inner solver.
# ---------------------------------------------------------------------------
class _BCDState(NamedTuple):
    W: jax.Array
    H: jax.Array
    Wm: jax.Array
    Hm: jax.Array
    W_old: jax.Array
    H_old: jax.Array
    HHT: jax.Array
    AHT: jax.Array
    obj_old: jax.Array
    t_old: jax.Array
    HHTnorm: jax.Array
    WTWnorm: jax.Array


def bcd_solve(A, W, H, eps, itr=1000, rw=1.0, obj_mode="gram",
              col_mask=None):
    """Run the full BCD inner loop; returns (W, H).

    ``obj_mode`` selects how the per-iteration objective 0.5||A - WH||^2
    (which only feeds the restore-vs-extrapolate decision, reference
    dist_nmf.py:1029-1036) is computed:

    * ``"gram"`` (default): the Gram identity
      0.5(||A||^2 - 2<W, A H^T> + <W^T W, H H^T>) from the (m,k)/(k,k)
      products the step already computed — ||A||^2 is loop-invariant, so
      the objective costs O(mk + k^2) instead of a THIRD A-sized pass per
      iteration.  Cancellation bounds its resolution at ~eps * ||A||^2,
      a RELATIVE-ERROR floor of ~sqrt(2 eps): ~7e-4 at f32, ~2e-8 at f64
      — far below typical NMF reconstruction errors (O(1e-2..1)); once
      the iterate converges past the floor, restore fires spuriously and
      progress stalls there (tests/test_nmf_solvers.py pins this).
    * ``"residual"``: the reference's explicit m x n residual
      (dist_nmf.py:560) — converges past the floor; the
      bitwise-reference fallback.
    """
    f32 = jnp.float64 if A.dtype == jnp.float64 else jnp.float32

    # init (reference initWandH :951-969): scale W,H so |W| = |H| = |A|^(1/2)
    Xnorm = linalg.sqnorm(A)
    sqW = linalg.sqnorm(W)
    sqH = linalg.sqnorm(H)
    scale = jnp.sqrt(jnp.sqrt(Xnorm))
    W0 = (W / jnp.sqrt(sqW).astype(W.dtype) * scale.astype(W.dtype))
    H0 = (H / jnp.sqrt(sqH).astype(H.dtype) * scale.astype(H.dtype))
    state = _BCDState(
        W=W0, H=H0, Wm=W0, Hm=H0, W_old=W0, H_old=H0,
        HHT=linalg.gram_t(H0), AHT=linalg.matmul_AHT(A, H0),
        obj_old=0.5 * Xnorm, t_old=jnp.asarray(1.0, f32),
        HHTnorm=jnp.asarray(1.0, f32), WTWnorm=jnp.asarray(1.0, f32))

    def body(_, s: _BCDState) -> _BCDState:
        # --- W update: projected Lipschitz-gradient step ---
        HHTnorm_old = s.HHTnorm
        HHTnorm = jnp.sqrt(linalg.sqnorm(s.HHT))
        GW = linalg.matmul(s.Wm, s.HHT) - s.AHT
        W = jnp.maximum(0.0, s.Wm - GW / HHTnorm.astype(GW.dtype))
        # L1 column normalization (reference :1004-1011, no eps guard).
        # A col_mask (K-padded k-sweep solve, models/nmf._solve) guards
        # the masked-out all-zero columns' 0/0 — active columns keep the
        # reference's unguarded division.
        colsum = linalg.sum_axis(W, axis=0)
        if col_mask is not None:
            colsum = jnp.where(col_mask, colsum, jnp.ones((), colsum.dtype))
        W = W / colsum[None, :]
        WTW = linalg.gram(W)

        # --- H update ---
        WTWnorm_old = s.WTWnorm
        WTWnorm = jnp.sqrt(linalg.sqnorm(WTW))
        GH = linalg.matmul(WTW, s.Hm) - linalg.matmul_WTA(W, A)
        H = jnp.maximum(0.0, s.Hm - GH / WTWnorm.astype(GH.dtype))
        HHT = linalg.gram_t(H)
        AHT = linalg.matmul_AHT(A, H)

        if obj_mode == "gram":
            # <W, A H^T> reuses AHT (updated H); <W^T W, H H^T> reuses the
            # WTW/HHT grams — no A-sized traffic
            acc = linalg._acc_dtype(A)
            cross = jnp.sum(W.astype(acc) * AHT.astype(acc))
            wh2 = jnp.sum(WTW.astype(acc) * HHT.astype(acc))
            obj = 0.5 * (Xnorm - 2.0 * cross + wh2)
        else:
            obj = 0.5 * linalg.sqnorm(A - linalg.matmul(W, H))

        # --- correction / extrapolation (reference :1029-1047) ---
        t = (1.0 + jnp.sqrt(1.0 + 4.0 * s.t_old ** 2)) / 2.0
        restore = obj >= s.obj_old

        def do_restore(_):
            # non-increasing objective: roll Wm/Hm and cached grams back to
            # the previous accepted iterate (reference :1031-1036)
            return (s.W_old, s.H_old, s.W_old, s.H_old,
                    linalg.gram_t(s.H_old), linalg.matmul_AHT(A, s.H_old),
                    s.obj_old, s.t_old)

        def do_extrapolate(_):
            w_ext = jnp.minimum((s.t_old - 1.0) / t,
                                rw * jnp.sqrt(HHTnorm_old / HHTnorm))
            h_ext = jnp.minimum((s.t_old - 1.0) / t,
                                rw * jnp.sqrt(WTWnorm_old / WTWnorm))
            Wm = W + w_ext.astype(W.dtype) * (W - s.W_old)
            Hm = H + h_ext.astype(H.dtype) * (H - s.H_old)
            return (Wm, Hm, W, H, HHT, AHT, obj, t)

        (Wm, Hm, W_old, H_old, HHT2, AHT2, obj_old, t_old) = lax.cond(
            restore, do_restore, do_extrapolate, None)
        return _BCDState(
            W=W, H=H, Wm=Wm, Hm=Hm, W_old=W_old, H_old=H_old,
            HHT=HHT2, AHT=AHT2, obj_old=obj_old, t_old=t_old,
            HHTnorm=HHTnorm, WTWnorm=WTWnorm)

    state = lax.fori_loop(0, itr, body, state)
    return state.W, state.H
