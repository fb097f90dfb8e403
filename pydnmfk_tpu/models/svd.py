"""Distributed SVD and NNDSVD (non-negative SVD) initialization.

Reference: ``DistSVD`` (pyDNMFk/dist_svd.py:9-267).  The reference computes k
singular triplets by *serial rank-0 power iteration with deflation* on the
replicated Gram matrix (svd1D :96-137: Bcast a random vector, allreduce the
Gram, iterate on rank 0 only, Bcast back — a per-triplet host bottleneck).
Its scale property worth keeping: A stays rank-sharded throughout — Gram and
A@v products are local-matmul + allreduce (dist_svd.py:89-94, :112-115,
:170-181), so nnsvd init works at any scale the grid reaches.

Re-design: one sharded Gram matmul (psum over the mesh) followed
by a single dense ``eigh`` of the (min_dim x min_dim) Gram — all k triplets
at once, no deflation loop, strictly better numerics — with a randomized
subspace-iteration path when min(m, n) is too large to replicate.  The mesh
story mirrors the reference's: A keeps its P('r','c') sharding end to end,
the Gram / panel products lower to local matmul + psum, and only
min(m,n)-sized (exact path) or panel-sized (randomized path) intermediates
are ever replicated — no device holds a full copy of A
(tests/test_nnsvd_golden.py asserts the per-device memory bound on the
compiled program).  The NNDSVD ±-part construction (:233-256) is kept
semantically identical (it is sign-invariant, so the eigenvector sign
ambiguity is immaterial), except the reference's ``UP_norm / p``
processor-count scaling (:250-251) is dropped: it is a uniform column scale
that the final L1 normalize-by-W (:68-78) cancels exactly, so results match
while staying grid-shape independent.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import linalg
from ..parallel.mesh import GridContext


_EXACT_GRAM_LIMIT = 8192   # replicate the Gram and eigh below this min-dim


def _constrain(x, ctx: Optional[GridContext], spec):
    """Pin an intermediate's sharding on the mesh (no-op single-device)."""
    if ctx is not None and ctx.n_devices > 1:
        return lax.with_sharding_constraint(x, ctx.sharding(spec))
    return x


def _panel_qr(Y):
    """Tall-skinny orthonormalization.  Dense reduced QR: rank-deficient
    panels (exactly low-rank A) break Cholesky-QR, and this runs only a few
    times at init, so robustness wins over the matmul-only variant.  QR is
    not SPMD-partitionable, so the (big, b) panel is gathered — b = k + 10,
    i.e. panel bytes are W-sized, not A-sized."""
    Q, _ = jnp.linalg.qr(Y.astype(linalg._acc_dtype(Y)), mode="reduced")
    return Q


def _svd_gram(A, k: int, ctx: Optional[GridContext] = None):
    """Exact top-k SVD via eigh of the smaller Gram matrix.

    With A sharded P('r','c'), the Gram lowers to a local matmul + psum
    (the reference's globalGram, dist_svd.py:89-94); the (min_dim^2) eigh
    runs replicated; the back-projection A @ V / A^T @ U is again local
    matmul + psum with the output pinned to the factor shardings."""
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    from jax.sharding import PartitionSpec as P

    m, n = A.shape
    Af = A.astype(linalg._acc_dtype(A))
    if m >= n:
        B = linalg.matmul(Af.T, Af)             # (n,n), psum over 'r'
        evals, evecs = jnp.linalg.eigh(B)       # ascending
        order = jnp.argsort(evals)[::-1][:k]
        V = jnp.take(evecs, order, axis=1)      # (n,k)
        S = jnp.sqrt(jnp.clip(jnp.take(evals, order), 0.0))
        U = linalg.matmul(Af, V) / jnp.maximum(S, 1e-30)[None, :]
    else:
        B = linalg.matmul(Af, Af.T)             # (m,m), psum over 'c'
        evals, evecs = jnp.linalg.eigh(B)
        order = jnp.argsort(evals)[::-1][:k]
        U = jnp.take(evecs, order, axis=1)      # (m,k)
        S = jnp.sqrt(jnp.clip(jnp.take(evals, order), 0.0))
        V = linalg.matmul(Af.T, U) / jnp.maximum(S, 1e-30)[None, :]
    U = _constrain(U, ctx, P(ROW_AXIS, None))
    Vt = _constrain(V.T, ctx, P(None, COL_AXIS))
    return S, U, Vt                             # V^T is (k,n)


def _svd_randomized(A, key, k: int, iters: int = 12, oversample: int = 10,
                    ctx: Optional[GridContext] = None, tol: float = 1e-4):
    """Randomized subspace iteration for very large min(m, n).

    The subspace panel Q (big, k+oversample) is pinned to the long-axis
    sharding between QR steps, so the X @ (X^T @ Q) products stay
    local-matmul + psum on the mesh (the distributed analog of the
    reference's power iteration, dist_svd.py:112-137, which iterated on
    rank 0 only).

    The loop stops when the subspace converges — the per-step rotation
    ``||Q' - Q(Q^T Q')||_F^2 = b - ||Q^T Q'||_F^2`` (Q' orthonormal) costs
    only one (b, b) Gram — capped at ``iters`` steps (the round-3 version
    always ran a fixed 8; a spectrum with a clean gap converges in 2-3).
    Accuracy at a flagship-ratio synthetic size is pinned by
    tests/test_nnsvd_golden.py::test_randomized_svd_accuracy."""
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    from jax.sharding import PartitionSpec as P

    m, n = A.shape
    b = min(k + oversample, min(m, n))
    acc = linalg._acc_dtype(A)
    Af = A.astype(acc)
    tall = m >= n
    X = Af if tall else Af.T                    # long axis leading
    panel_spec = P(ROW_AXIS if tall else COL_AXIS, None)
    Y = linalg.matmul(X, jax.random.normal(key, (X.shape[1], b), acc))
    Q0 = _constrain(_panel_qr(Y), ctx, panel_spec)

    def cond(state):
        i, _, delta = state
        return jnp.logical_and(i < iters, delta > tol)

    def body(state):
        i, Q, _ = state
        Qn = _constrain(_panel_qr(linalg.matmul(X, linalg.matmul(X.T, Q))),
                        ctx, panel_spec)
        ovl = linalg.matmul(Q.T, Qn)            # (b, b); psum on the mesh
        delta = jnp.sqrt(jnp.maximum(
            b - jnp.sum(jnp.square(ovl)), 0.0) / b)
        return i + 1, Qn, delta.astype(jnp.float32)

    _, Q, _ = lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), Q0,
                     jnp.asarray(jnp.inf, jnp.float32)))
    B = linalg.matmul(Q.T, X)                   # (b, small)
    Bs, Bu, Bvt = _svd_gram(B, k)
    U_big = linalg.matmul(Q, Bu)                # (big, k)
    if tall:
        S, U, Vt = Bs, U_big, Bvt
    else:
        S, U, Vt = Bs, Bvt.T, U_big.T
    U = _constrain(U, ctx, P(ROW_AXIS, None))
    Vt = _constrain(Vt, ctx, P(None, COL_AXIS))
    return S, U, Vt


def _nnsvd_from_svd(S, U, Vt, eps, flag=1):
    """NNDSVD ± construction from SVD factors (reference :233-256) followed
    by L1 normalize-by-W (reference :68-78).  Pure / vmappable; the column
    norms are global sums that psum over the sharded row axes."""
    if flag == 0:
        W = jnp.maximum(U, 0.0)
        H = jnp.maximum(S[:, None] * Vt, 0.0)
    else:
        V = Vt.T                             # (n,k)
        UP, UN = jnp.maximum(U, 0.0), jnp.maximum(-U, 0.0)
        VP, VN = jnp.maximum(V, 0.0), jnp.maximum(-V, 0.0)
        UP_n = jnp.sqrt(jnp.sum(jnp.square(UP), axis=0))   # global: psum 'r'
        UN_n = jnp.sqrt(jnp.sum(jnp.square(UN), axis=0))
        VP_n = jnp.sqrt(jnp.sum(jnp.square(VP), axis=0))
        VN_n = jnp.sqrt(jnp.sum(jnp.square(VN), axis=0))
        mp = jnp.sqrt(UP_n * VP_n * S)
        mn = jnp.sqrt(UN_n * VN_n * S)
        use_p = mp > mn
        W = jnp.where(use_p[None, :], mp * UP / (UP_n + eps),
                      mn * UN / (UN_n + eps))
        H = jnp.where(use_p[None, :], mp * VP / (VP_n + eps),
                      mn * VN / (VN_n + eps)).T
    s = jnp.sum(W, axis=0, keepdims=True) + eps
    return W / s, H * s.T


@partial(jax.jit, static_argnames=("k", "exact", "ctx"))
def _svd_program(A, key, k: int, exact: bool, ctx: Optional[GridContext]):
    if exact:
        return _svd_gram(A, k, ctx)
    return _svd_randomized(A, key, k, ctx=ctx)


@partial(jax.jit, static_argnames=("k", "flag", "exact", "ctx"))
def _nnsvd_program(A, key, eps, k: int, flag: int, exact: bool,
                   ctx: Optional[GridContext]):
    """SVD + NNDSVD as ONE jitted program so the partitioner sees the whole
    init and every intermediate keeps its mesh sharding (W out: P('r',∅),
    H out: P(∅,'c'))."""
    from ..parallel.mesh import COL_AXIS, ROW_AXIS
    from jax.sharding import PartitionSpec as P

    if exact:
        S, U, Vt = _svd_gram(A, k, ctx)
    else:
        S, U, Vt = _svd_randomized(A, key, k, ctx=ctx)
    W, H = _nnsvd_from_svd(S, U, Vt, eps, flag)
    W = _constrain(W, ctx, P(ROW_AXIS, None))
    H = _constrain(H, ctx, P(None, COL_AXIS))
    return W, H


def nnsvd_factors(A, k: int, eps: float, flag: int = 1,
                  ctx: Optional[GridContext] = None):
    """Pure-function NNDSVD init: (W, H) for one matrix.  vmap over a
    leading ensemble axis to initialize a whole perturbation batch."""
    S, U, Vt = _svd_gram(A, k, ctx)
    return _nnsvd_from_svd(S, U, Vt, eps, flag)


class DistSVD:
    """API mirror of reference DistSVD (svd / nnsvd / rel_error).

    ``ctx`` carries the device mesh: with a multi-device context the input
    A is expected sharded P('r','c') (models/nmf.py pads and shards BEFORE
    init) and every product runs as local matmul + psum — the mesh
    equivalent of the reference keeping A rank-sharded through its
    Gram/matvec products (dist_svd.py:89-94, :112-115)."""

    def __init__(self, ctx: Optional[GridContext] = None, k: int = 4,
                 eps: float = float(jnp.finfo(jnp.float32).eps),
                 seed: int = 0):
        self.ctx = ctx
        self.k = k
        self.eps = eps
        self.seed = seed

    def _use_exact(self, A) -> bool:
        return min(A.shape) <= _EXACT_GRAM_LIMIT

    def svd(self, A):
        """Top-k singular triplets.  Returns (S (k,), U (m,k), Vt (k,n))."""
        A = jnp.asarray(A)
        return _svd_program(A, jax.random.key(self.seed), self.k,
                            self._use_exact(A), self.ctx)

    def rel_error(self, A, U, S, Vt):
        """||A - U diag(S) Vt||_F / ||A||_F (reference :188-197)."""
        Aa = jnp.asarray(A)
        R = Aa.astype(linalg._acc_dtype(Aa)) - linalg.matmul(
            U * S[None, :], Vt)
        return float(jnp.sqrt(linalg.sqnorm(R) / linalg.sqnorm(A)))

    def nnsvd(self, A, flag: int = 1, verbose: int = 0):
        """Boutsidis-style NNDSVD factors (reference :199-267).

        Returns (W, H) L1-normalized by W; with verbose=1 also a dict of
        SVD/NNSVD reconstruction errors."""
        A = jnp.asarray(A)
        W, H = _nnsvd_program(A, jax.random.key(self.seed),
                              jnp.asarray(self.eps, jnp.float32),
                              self.k, flag, self._use_exact(A), self.ctx)
        if verbose:
            S, U, Vt = self.svd(A)
            errors = {"recon_err_svd": self.rel_error(A, U, S, Vt)}
            # error of the unnormalized factors == normalized (W scale
            # cancels against H), reference computes it pre-normalize
            errors["recon_err_nnsvd"] = self.rel_error(
                A, W, jnp.ones((self.k,), W.dtype), H)
            return (W, H), errors
        return W, H
