"""Custom clustering of ensemble W columns + cosine-distance silhouettes.

Reference: ``custom_clustering`` (pyDNMFk/dist_clustering.py:5-188).  Given
the W factors of p perturbed NMF runs, greedily align the k columns of every
run to a common centroid ordering (100 fixed alignment iterations, median
centroids), then score cluster stability with cosine-distance silhouettes.

Re-design: the whole alignment loop — including the greedy
quadratic-assignment inner loop — runs as one jit-compiled computation
(``lax.fori_loop`` over iterations, perturbations, and assignment steps);
the reference round-trips numpy + MPI allreduce per (iteration,
perturbation) pair.  Ensemble tensors use a leading perturbation axis
(p, m, k) so they batch/shard naturally; the reference layout is (m, k, p).

Numerical semantics match the reference exactly (verified against the
committed golden ``tests/sill.npy``):
  * normalize: W /= sqrt(colsumsq + eps); H *= the same    (:30-39)
  * initial centroids = first perturbation's W             (:109-110)
  * greedy max-similarity assignment                       (:58-69)
  * centroids = median over perturbations, renormalized    (:120-126)
  * silhouettes from the arccos-of-clipped-gram distances  (:129-160)
  * the reference clusters twice (fit -> dist_silhouettes re-clusters with
    centroids reset to the permuted first slice, :140); replicated here.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops import linalg


def normalize_by_w(W_all, H_all, eps):
    """L2-normalize each W column (globally over rows), rescale H rows.
    W_all: (p, m, k); H_all: (p, k, n)."""
    sumsq = jnp.sum(jnp.square(W_all.astype(jnp.float32)), axis=1)   # (p, k)
    temp = jnp.sqrt(sumsq + eps).astype(W_all.dtype)
    W_all = W_all / temp[:, None, :]
    H_all = H_all * temp[:, :, None]
    return W_all, H_all


def greedy_assignment(dist):
    """Greedy approximation of max-similarity assignment
    (reference greedy_lsa + change_order, :50-69).

    Returns perm such that new_W[:, i] = W[:, perm[i]]."""
    k = dist.shape[0]
    neg = jnp.float32(-jnp.inf)

    def body(_, state):
        X, perm = state
        flat = jnp.argmax(X)
        r = (flat // k).astype(jnp.int32)
        c = (flat % k).astype(jnp.int32)
        perm = perm.at[r].set(c)
        X = X.at[r, :].set(neg)
        X = X.at[:, c].set(neg)
        return X, perm

    _, perm = lax.fori_loop(0, k, body,
                            (dist.astype(jnp.float32),
                             jnp.zeros((k,), jnp.int32)))
    return perm


def _cluster_loop(W_all, H_all, eps, n_iter=100, active=None):
    """The 100-iteration alignment loop (reference :83-127).
    Centroids restart from the (current) first perturbation slice.

    ``active`` (bool (K,)) marks the live columns of a K-padded ensemble
    (the shared-trace k-sweep clustering): padded columns are exact
    zeros, and the +2 bias on active x active similarities makes the
    greedy assignment pick actives in exactly the unpadded order (all
    similarities of L2-normalized nonneg columns lie in [0, 1], so
    biased actives in [2, 3] always dominate; leftover padded columns
    pair among themselves and are sliced off by the caller)."""
    p = W_all.shape[0]
    k = W_all.shape[2]
    centroids = W_all[0]
    bias = (None if active is None else
            2.0 * jnp.outer(active, active).astype(jnp.float32))
    ident = jnp.arange(k, dtype=jnp.int32)

    def one_iter(state):
        it, W_all, H_all, centroids, _ = state

        def one_pert(i, carry):
            W_all, H_all, moved = carry
            Wp = lax.dynamic_index_in_dim(W_all, i, 0, keepdims=False)
            Hp = lax.dynamic_index_in_dim(H_all, i, 0, keepdims=False)
            dist = linalg.matmul(centroids.T, Wp)        # (k,k), psum over 'r'
            if bias is not None:
                dist = dist.astype(jnp.float32) + bias
            perm = greedy_assignment(dist)
            W_all = lax.dynamic_update_index_in_dim(
                W_all, jnp.take(Wp, perm, axis=1), i, 0)
            H_all = lax.dynamic_update_index_in_dim(
                H_all, jnp.take(Hp, perm, axis=0), i, 0)
            return W_all, H_all, moved | jnp.any(perm != ident)

        W_all, H_all, moved = lax.fori_loop(
            0, p, one_pert, (W_all, H_all, jnp.asarray(False)))
        centroids = jnp.median(W_all, axis=0)
        cn = jnp.sqrt(jnp.sum(jnp.square(centroids.astype(jnp.float32)),
                              axis=0) + eps)
        centroids = centroids / cn.astype(centroids.dtype)
        return it + 1, W_all, H_all, centroids, moved

    # EXACT early exit at the reference's fixed point: from iteration 1 on
    # the incoming centroids are the median of the CURRENT (W_all, H_all),
    # so an all-identity iteration leaves the whole state unchanged and
    # every remaining iteration of the reference's fixed 100 (:114) is
    # the identity map — stopping there is bitwise equal to running them
    # all.  Iteration 0's centroids are W_all[0] (:109), not the median,
    # so an identity iteration 0 does NOT yet imply a fixed point — the
    # `it <= 1` term always runs iterations 0 and 1.
    def cond(state):
        it, _, _, _, moved = state
        return jnp.logical_and(it < n_iter,
                               jnp.logical_or(moved, it <= 1))

    _, W_all, H_all, centroids, _ = lax.while_loop(
        cond, one_iter,
        (jnp.asarray(0, jnp.int32), W_all, H_all, centroids,
         jnp.asarray(True)))
    return W_all, H_all, centroids


def _silhouettes(W_all):
    """Cosine-distance silhouettes (reference dist_silhouettes :129-160).
    W_all: (p, m, k) with L2-normalized columns.  Returns (k, p)."""
    P, _, K = W_all.shape
    if K == 1:
        return jnp.ones((K, P), W_all.dtype)
    # G[k1, p1, k2, p2] = <W[p1][:, k1], W[p2][:, k2]>, psum over 'r'
    G = jnp.einsum("ami,bmj->iajb", W_all.astype(jnp.float32),
                   W_all.astype(jnp.float32))
    D = jnp.arccos(jnp.clip(G, -1.0, 1.0))              # (K,P,K,P)
    ii = jnp.arange(K)
    a = D[ii, :, ii, :].sum(-1) / (P - 1)               # (K,P)
    rowsum = D.sum(-1)                                  # (K,P,K)
    mask = (ii[:, None, None] == ii[None, None, :])
    rowsum = jnp.where(mask, jnp.inf, rowsum)
    b = rowsum.min(-1) / P                              # (K,P)
    return ((b - a) / jnp.maximum(a, b)).astype(W_all.dtype)


def _mad(data, axis=-1):
    """Median absolute deviation (reference mad flag=1, :41-48)."""
    med = jnp.nanmedian(data, axis=axis, keepdims=True)
    return jnp.nanmedian(jnp.abs(data - med), axis=axis)


@partial(jax.jit, static_argnames=("n_iter",))
def _fit_impl(W_all, H_all, eps, n_iter=100, active=None):
    W_all, H_all = normalize_by_w(W_all, H_all, eps)
    # first clustering pass (reference fit -> dist_custom_clustering)
    W_all, H_all, centroids = _cluster_loop(W_all, H_all, eps, n_iter,
                                            active)
    cent_std = _mad(jnp.moveaxis(W_all, 0, -1), axis=-1)      # (m, k)
    # second pass inside dist_silhouettes (reference :140) — centroids reset
    W_all2, H_all2, _ = _cluster_loop(W_all, H_all, eps, n_iter, active)
    # K-padded sweeps: padded clusters sit at the maximum possible
    # distance (arccos(0) = pi/2 >= every distance between nonneg
    # normalized columns), so active clusters' silhouettes are EXACT —
    # the caller slices off the padded rows
    sils = _silhouettes(W_all2)                               # (k, p)
    return centroids, cent_std, H_all2, sils


class CustomClustering:
    """API mirror of reference custom_clustering.fit (:162-188).

    ``active`` (bool (K,)) marks live columns of a K-padded ensemble —
    the k-sweep's shared-trace clustering (see _cluster_loop); stats are
    computed over the active rows only and the caller slices factors."""

    def __init__(self, W_all, H_all, eps: float, n_iter: int = 100,
                 active=None):
        """W_all: (p, m, k); H_all: (p, k, n) — leading perturbation axis
        (use ``jnp.moveaxis(x, -1, 0)`` to convert the reference's
        (m, k, p) / (k, n, p) layout)."""
        W_all = jnp.asarray(W_all)
        H_all = jnp.asarray(H_all)
        if W_all.ndim != 3 or H_all.ndim != 3:
            raise ValueError("W_all/H_all must be rank-3 ensemble tensors")
        if W_all.shape[0] != H_all.shape[0] or W_all.shape[2] != H_all.shape[1]:
            raise ValueError(
                f"layout mismatch: expected W_all (p,m,k), H_all (p,k,n); "
                f"got {W_all.shape} and {H_all.shape}")
        self.W_all = W_all
        self.H_all = H_all
        self.eps = eps
        self.n_iter = n_iter
        self.active = active

    def fit(self):
        """Returns (centroids (m,k), cent_std (m,k), H_all (p,k,n),
        cluster_sils (k,), avg_sil (scalar), sils (k,p))."""
        centroids, cent_std, H_all, sils = _fit_impl(
            self.W_all, self.H_all, jnp.float32(self.eps), self.n_iter,
            self.active)
        if self.active is not None:
            # stats over the live clusters only (padded rows are inert
            # in the clustering but their sils are meaningless)
            w = self.active.astype(sils.dtype)
            n_act = jnp.sum(w)
            cluster_sils = jnp.sum(sils * w[:, None], axis=1) / sils.shape[1]
            avg_sil = jnp.sum(sils * w[:, None]) / (n_act * sils.shape[1])
            return centroids, cent_std, H_all, cluster_sils, avg_sil, sils
        cluster_sils = jnp.mean(sils, axis=1)
        avg_sil = jnp.mean(sils)
        return centroids, cent_std, H_all, cluster_sils, avg_sil, sils


def cluster_ensemble(W_all, H_all, eps, n_iter=100, active=None):
    return CustomClustering(W_all, H_all, eps, n_iter, active).fit()
