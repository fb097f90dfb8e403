"""Single-NMF driver: one factorization A ~= W H for a fixed k.

Replacement of the reference ``PyNMF`` (pyDNMFk/pyDNMF.py:9-239).
The iteration loop is a single jit-compiled ``lax.fori_loop`` (the reference
re-instantiates a Python update object per step, pyDNMF.py:154,169); the
per-topology branches are gone (sharding decides); and solves can be batched
over an ensemble axis with ``vmap`` for the NMFk pipeline.

Reference semantics preserved:
  * eps = finfo(dtype).eps                          (pyDNMF.py:68-69)
  * clip W,H at eps every 10 iterations             (pyDNMF.py:155-157,170-172)
  * final L1 column-normalize W, rescale H          (pyDNMF.py:184-194)
  * relative error = ||A-WH||_F / ||A||_F           (pyDNMF.py:204-210)
  * per-column error vector                         (pyDNMF.py:220-239)
  * rand init: U[0,1) factors                       (pyDNMF.py:110-129)
  * BCD collapses the outer loop into its own       (pyDNMF.py:152)
"""
from __future__ import annotations

import os
from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import NMFConfig
from ..ops import linalg
from ..parallel.mesh import GridContext, grid_context
from ..utils.pruning import PruneState, prune_all, unprune_factors
from ..utils import timing
from . import updates


# ---------------------------------------------------------------------------
# jitted solver (cached per static signature)
# ---------------------------------------------------------------------------
def _solve(A, W, H, eps, col_mask=None, *, norm: str, method: str, itr: int,
           W_update: bool, chunk: int, tol: float = 0.0,
           tol_check_every: int = 50, mesh=None, err_chunk: int = 0,
           finalize: bool = True, bcd_obj: str = "gram",
           hals_block=None):
    """``col_mask`` (bool (K,)) marks the ACTIVE factor columns of a
    K-padded solve: W columns / H rows outside the mask are held at exact
    zero (re-zeroed after every step's eps clip), which makes the active
    columns' trajectory equal to an unpadded k-column solve — zero columns
    contribute exact-zero terms to every Gram/product the active updates
    consume.  This is what lets the NMFk k-sweep run every k through ONE
    compiled program (models/nmfk.py::_ensemble_program_polyk) instead of
    re-tracing per k (the reference's serial k loop, pyDNMFk.py:198-200)."""
    norm = norm.lower()
    method = method.lower()

    def mask_wh(W, H):
        if col_mask is None:
            return W, H
        return (W * col_mask[None, :].astype(W.dtype),
                H * col_mask[:, None].astype(H.dtype))
    if norm == "fro" and method == "mu":
        step = partial(updates.mu_fro_step, W_update=W_update)
    elif norm == "kl" and method == "mu":
        step = partial(updates.mu_kl_step, W_update=W_update, chunk=chunk,
                       mesh=mesh)
    elif norm == "fro" and method == "hals":
        step = partial(updates.hals_step, W_update=W_update,
                       block=hals_block)
    elif norm == "fro" and method == "bcd":
        step = None
    elif method == "bcd" or method == "hals":
        raise ValueError(f"method {method!r} supports only norm='fro'")
    else:
        raise ValueError(f"invalid (norm, method) = ({norm!r}, {method!r})")

    if method == "bcd":
        W, H = updates.bcd_solve(A, W, H, eps, itr=itr, obj_mode=bcd_obj,
                                 col_mask=col_mask)
        # reference pyDNMF.fit clips at i = itr-1 only when (itr-1) % 10 == 0
        if (itr - 1) % 10 == 0:
            W = jnp.maximum(W, eps)
            H = jnp.maximum(H, eps)
        W, H = mask_wh(W, H)
    else:
        def body(i, WH):
            W, H = WH
            W, H = step(A, W, H, eps)
            clip = (i % 10) == 0
            W = jnp.where(clip, jnp.maximum(W, eps), W)
            H = jnp.where(clip, jnp.maximum(H, eps), H)
            return mask_wh(W, H)

        if tol <= 0.0:
            W, H = lax.fori_loop(0, itr, body, (W, H))
        else:
            # early stop: run tol_check_every iterations per outer step and
            # stop once the relative error improves by less than tol (a
            # production feature the reference lacks — it always runs the
            # full fixed iteration budget, pyDNMF.py:151).  Two-level loop:
            # whole chunks under lax.while_loop, then one static remainder
            # tail — the hot inner loop carries no per-iteration branch.
            chunk_n = max(1, tol_check_every)
            n_full = itr // chunk_n
            rem = itr - n_full * chunk_n

            def cond(state):
                j, _, _, err_prev, err = state
                return jnp.logical_and(j < n_full, err_prev - err > tol)

            def outer(state):
                j, W, H, _, err = state
                W, H = lax.fori_loop(
                    0, chunk_n, lambda t, wh: body(j * chunk_n + t, wh),
                    (W, H))
                new_err = linalg.relative_error(A, W, H, err_chunk)
                return (j + 1, W, H, err, new_err)

            errdt = linalg._acc_dtype(A)
            big = jnp.asarray(jnp.finfo(errdt).max / 4, errdt)
            state = (jnp.asarray(0, jnp.int32), W, H, big, big / 2)
            _, W, H, err_prev, err = lax.while_loop(cond, outer, state)
            if rem:
                # ragged tail runs only if the loop above did not converge
                W, H = lax.cond(
                    err_prev - err > tol,
                    lambda wh: lax.fori_loop(n_full * chunk_n, itr, body, wh),
                    lambda wh: wh, (W, H))

    if not finalize:
        # mid-solve checkpoint chunk: the reference semantics normalize and
        # measure error only once, at the very end (pyDNMF.py:158-162) —
        # skipping here keeps the chunked trajectory identical
        return W, H, jnp.zeros((), linalg._acc_dtype(A))
    W, H = linalg.normalize_features(W, H, eps)
    err = linalg.relative_error(A, W, H, err_chunk)
    return W, H, err


@lru_cache(maxsize=64)
def _jitted_solver(norm, method, itr, W_update, chunk, batched, tol=0.0,
                   tol_check_every=50, mesh=None, err_chunk=0,
                   finalize=True, bcd_obj="gram", masked=False,
                   hals_block=None):
    """``masked=True`` adds a per-member active-column mask argument
    (b, K) — the K-padded k-sweep path (see _solve's col_mask)."""
    fn = partial(_solve, norm=norm, method=method, itr=itr,
                 W_update=W_update, chunk=chunk, tol=tol,
                 tol_check_every=tol_check_every, mesh=mesh,
                 err_chunk=err_chunk, finalize=finalize, bcd_obj=bcd_obj,
                 hals_block=hals_block)
    if batched:
        fn = jax.vmap(fn, in_axes=(0, 0, 0, None, 0) if masked
                      else (0, 0, 0, None))
    return jax.jit(fn)


def dense_chunks(A, cfg: NMFConfig, single_shard: bool, sparse_A: bool):
    """(kl_chunk, err_chunk): the row chunks that bound A-sized temporaries.

    KL's direct path materializes the m x n ratio U; at the headline f32
    shape U and A together take 17.7 GB, so a large single-shard block
    auto-chunks when nothing else bounds it (on a mesh the per-device
    blocks already shrink).  The error passes chunk for the same reason:
    the final relative_error would otherwise materialize an A-sized W@H."""
    chunk = cfg.kl_chunk
    if cfg.norm.lower() == "kl" and not chunk and not sparse_A:
        chunk = linalg.error_chunk_rows(A.shape[-2], A.shape[-1],
                                        sharded=not single_shard)
    err_chunk = 0 if sparse_A else linalg.error_chunk_rows(
        A.shape[-2], A.shape[-1], sharded=not single_shard)
    return chunk, err_chunk


def solve(A, W, H, eps, cfg: NMFConfig, W_update: Optional[bool] = None,
          batched: bool = False, finalize: bool = True, col_mask=None):
    """Run the full iteration loop.  ``batched=True`` maps over a leading
    ensemble axis of A/W/H (the reference's serial perturbation loop,
    pyDNMFk.py:226-231, becomes one compiled batch).  ``col_mask``
    (bool (K,), non-batched only) marks the active columns of a
    K-padded solve (see _solve)."""
    if batched and col_mask is not None:
        raise ValueError("col_mask applies to non-batched solves (the "
                         "batched path uses _jitted_solver(masked=True))")
    if linalg.is_sparse(A):
        from ..ops.sparse import densify_for_backend
        # dense vs ELL gather, picked by the measured cost model
        A = densify_for_backend(A, k_hint=cfg.k)
    sh = getattr(A, "sharding", None)
    single_shard = getattr(sh, "num_devices", 1) <= 1
    sparse_A = linalg.is_sparse(A)
    if sparse_A and cfg.method.lower() == "bcd":
        raise ValueError(
            "sparse A supports MU (fro/kl) and HALS; the BCD objective "
            "needs the dense residual every inner step")
    # multi-device memory-bounded KL: route the chunked products through
    # shard_map on the array's own mesh (ops/kl.py::kl_*_sharded)
    mesh = None
    if (not single_shard and not batched and cfg.norm.lower() == "kl"
            and hasattr(sh, "mesh") and cfg.kl_chunk > 0):
        mesh = sh.mesh
    chunk, err_chunk = dense_chunks(A, cfg, single_shard, sparse_A)
    fn = _jitted_solver(cfg.norm.lower(), cfg.method.lower(), cfg.itr,
                        cfg.W_update if W_update is None else W_update,
                        chunk, batched, float(cfg.tol),
                        int(cfg.tol_check_every), mesh, err_chunk,
                        bool(finalize), cfg.bcd_obj or "gram",
                        hals_block=cfg.hals_block)
    args = (A, W, H, eps) if col_mask is None else (A, W, H, eps, col_mask)
    if cfg.matmul_precision:
        # dot-operand precision (config.py): the context participates in
        # the jit cache key, so default/highest variants coexist
        with jax.default_matmul_precision(cfg.matmul_precision):
            return fn(*args)
    return fn(*args)


# ---------------------------------------------------------------------------
# factor initialization
# ---------------------------------------------------------------------------
def init_factors_rand(key, m, n, k, dtype):
    kw, kh = jax.random.split(key)
    W = jax.random.uniform(kw, (m, k), dtype=jnp.float32).astype(dtype)
    H = jax.random.uniform(kh, (k, n), dtype=jnp.float32).astype(dtype)
    return W, H


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
class NMF:
    """Orchestrates one NMF fit: init -> (prune) -> iterate -> normalize ->
    error -> (unprune).  Mirror of reference ``PyNMF``."""

    def __init__(self, cfg: NMFConfig, ctx: Optional[GridContext] = None):
        from ..config import enable_compilation_cache, ensure_precision_enabled
        ensure_precision_enabled(cfg.precision)
        enable_compilation_cache()
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else grid_context(*cfg.grid)
        self.recon_err = None
        self.prune_state: Optional[PruneState] = None

    def _mesh_pad(self, A, W, H, true_shape=None):
        """Zero-pad (A, W, H) so every dim tiles evenly over the mesh —
        XLA's NamedSharding rejects uneven shapes (SURVEY hard-part (d)).
        Padded rows/cols are exact zeros: multiplicative updates keep the
        corresponding W rows / H cols at ~eps, perturbing global statistics
        only at the eps^2 level.  ``true_shape`` declares the unpadded dims
        when A arrives pre-padded (DataReader pad_to_mesh).  Returns the
        unpadded (m, n)."""
        m, n = true_shape if true_shape else A.shape
        if self.ctx.n_devices == 1:
            return A, W, H, (m, n)
        from ..parallel.partition import padded_dim
        tm = padded_dim(m, self.ctx.shape[0])
        tn = padded_dim(n, self.ctx.shape[1])
        if A.shape != (tm, tn):
            A = jnp.pad(A, ((0, tm - A.shape[0]), (0, tn - A.shape[1])))
        if W.shape[0] != tm:
            W = jnp.pad(W, ((0, tm - W.shape[0]), (0, 0)))
        if H.shape[1] != tn:
            H = jnp.pad(H, ((0, 0), (0, tn - H.shape[1])))
        return A, W, H, (m, n)

    def _shard(self, A, W, H):
        if self.ctx.n_devices > 1:
            A = jax.device_put(A, self.ctx.sharding_A)
            W = jax.device_put(W, self.ctx.sharding_W)
            H = jax.device_put(H, self.ctx.sharding_H)
        return A, W, H

    def init_factors(self, A, key=None, shape=None):
        """``shape`` overrides the draw dims for rand init when A arrives
        pre-padded (keeps the PRNG stream identical to the host-array
        path, where padding happens after the draw); nnsvd ignores it (it
        operates on the padded sharded A by design — zero padding adds
        exact-zero singular directions)."""
        cfg = self.cfg
        m, n = shape if (shape and cfg.init == "rand") else A.shape
        if cfg.init == "rand":
            if key is None:
                key = jax.random.key(cfg.seed)
            W, H = init_factors_rand(key, m, n, cfg.k, cfg.dtype)
        elif cfg.init == "nnsvd":
            from .svd import DistSVD
            W, H = DistSVD(self.ctx, k=cfg.k, eps=cfg.eps).nnsvd(A)
            W = W.astype(cfg.dtype)
            H = H.astype(cfg.dtype)
        else:
            raise ValueError(f"unknown init {cfg.init!r}")
        return W, H

    def fit(self, A, factors: Optional[Tuple] = None, key=None,
            orig_shape: Optional[Tuple[int, int]] = None, col_mask=None):
        """Returns (W, H, recon_err) as the reference PyNMF.fit does
        (pyDNMF.py:137-182).

        ``orig_shape`` declares the true global dims when A arrives already
        zero-padded to the mesh tiling (DataReader ``pad_to_mesh=True``);
        the returned factors are sliced back to it.  ``col_mask`` (bool
        (K,)) marks active columns of K-padded factors (the k-sweep's
        shared-trace regression refit — models/nmfk.py)."""
        cfg = self.cfg
        if linalg.is_sparse(A):
            from ..ops.sparse import densify_for_backend
            # multi-device grids take the sharded-triplet path, not ELL
            A = densify_for_backend(
                A, allow_ell=(self.ctx.shape == (1, 1)), k_hint=cfg.k)
        sparse_A = linalg.is_sparse(A)
        if sparse_A:
            if cfg.prune:
                raise ValueError("prune is not supported with sparse A "
                                 "(pruning IS implicit in sparsity)")
            if cfg.init == "nnsvd":
                raise ValueError("nnsvd init requires dense A; use "
                                 "init='rand' with sparse matrices")
            if jnp.issubdtype(jnp.dtype(cfg.a_dtype), jnp.integer):
                raise ValueError(
                    "quantized (uint8) A storage applies to dense A (the "
                    "sparse triplet stores only nnz values); drop "
                    "a_precision for sparse inputs")
            if jnp.dtype(A.dtype) != jnp.dtype(cfg.a_dtype):
                # a_precision (e.g. bf16 nnz values) applies to sparse
                # storage too — previously silently ignored
                from ..ops.ell import EllSparse
                from ..ops.sparse import SparseGridInput
                if isinstance(A, (EllSparse, SparseGridInput)):
                    A = A.astype(cfg.a_dtype)
                elif hasattr(A, "indices"):      # BCOO
                    from jax.experimental import sparse as jsparse
                    A = jsparse.BCOO(
                        (A.data.astype(cfg.a_dtype), A.indices),
                        shape=A.shape, unique_indices=A.unique_indices,
                        indices_sorted=A.indices_sorted)
        else:
            # integer a_precision = quantized storage: keep A at the work
            # dtype through init/prune/pad, quantize just before the solve
            quant = jnp.issubdtype(jnp.dtype(cfg.a_dtype), jnp.integer)
            A = jnp.asarray(A, dtype=cfg.dtype if quant else cfg.a_dtype)

        # Distributed-init fast path: pad + shard A BEFORE the factor init
        # so nnsvd's Gram/panel products run on the mesh — no device ever
        # holds a full A copy during init (the reference keeps A
        # rank-sharded through its SVD too, dist_svd.py:89-94,112-115).
        # Pruning is host-side and data-dependent, so the prune path keeps
        # the reference's init-then-prune order (pyDNMF.py:90-101).
        pre_sharded = False
        if (not sparse_A and self.ctx.n_devices > 1 and not cfg.prune
                and factors is None and cfg.init == "nnsvd"):
            m0, n0 = orig_shape if orig_shape else A.shape
            from ..parallel.partition import padded_dim
            tm = padded_dim(m0, self.ctx.shape[0])
            tn = padded_dim(n0, self.ctx.shape[1])
            if A.shape != (tm, tn):
                A = jnp.pad(A, ((0, tm - A.shape[0]),
                                (0, tn - A.shape[1])))
            A = jax.device_put(A, self.ctx.sharding_A)
            pre_sharded = (m0, n0)

        import contextlib
        prec_ctx = (
            (lambda: jax.default_matmul_precision(cfg.matmul_precision))
            if cfg.matmul_precision else contextlib.nullcontext)
        with timing.timed("init_factors"):
            if factors is not None:
                W = jnp.asarray(factors[0], dtype=cfg.dtype)
                H = jnp.asarray(factors[1], dtype=cfg.dtype)
            else:
                # pre_sharded: nnsvd of the zero-padded A == zero-padded
                # nnsvd of A (padding adds exact-zero singular directions),
                # so W/H come back padded AND sharded already; rand draws
                # at the TRUE dims (orig_shape) so pre-padded input gets
                # the same stream as the host-array path.  The
                # matmul_precision context covers the nnsvd Gram/panel
                # dots too, matching the solve.
                with prec_ctx():
                    W, H = self.init_factors(A, key=key, shape=orig_shape)

        if cfg.prune:
            A, W, H, self.prune_state = prune_all(A, W, H)

        a_scale = None
        if sparse_A:
            from ..ops.sparse import SparseGridInput, shard_sparse_for_grid
            m_sol, n_sol = A.shape
            if isinstance(A, SparseGridInput):
                # reader-produced pre-sharded blocks (utils/io.py);
                # triplet-format by construction
                if (cfg.sparse_grid_format or "").lower() == "ell":
                    import warnings
                    warnings.warn(
                        "sparse_grid_format='ell' is not available for "
                        "reader-streamed npz input (pre-sharded triplet "
                        "blocks); running the triplet grid path")
                if A.gs.mesh != self.ctx.mesh:
                    raise ValueError(
                        "SparseGridInput was read for a different mesh "
                        "than this NMF's grid context")
                (m_pad, n_pad), A = A.dims, A.gs
                if m_pad != m_sol:
                    W = jnp.pad(W, ((0, m_pad - m_sol), (0, 0)))
                if n_pad != n_sol:
                    H = jnp.pad(H, ((0, 0), (0, n_pad - n_sol)))
                W = jax.device_put(W, self.ctx.sharding_W)
                H = jax.device_put(H, self.ctx.sharding_H)
            elif self.ctx.shape != (1, 1):
                # grid-sharded sparse: W row-sharded, H col-sharded — the
                # reference's 1D/2D topologies.  Format per config
                # sparse_grid_format: per-block capped-ELL (ops/ell.py
                # GridEllSparse, the gather path)
                # or the segment_sum triplet (ops/sparse.py).  (p_e-only
                # contexts keep the triplet unsharded: the ensemble axis
                # plays no role in a single solve)
                A, (m_pad, n_pad) = shard_sparse_for_grid(
                    A, self.ctx, cfg.sparse_grid_format)
                if m_pad != m_sol:
                    W = jnp.pad(W, ((0, m_pad - m_sol), (0, 0)))
                if n_pad != n_sol:
                    H = jnp.pad(H, ((0, 0), (0, n_pad - n_sol)))
                W = jax.device_put(W, self.ctx.sharding_W)
                H = jax.device_put(H, self.ctx.sharding_H)
        else:
            if pre_sharded:
                # A/W/H already padded + sharded by the init fast path
                m_sol, n_sol = pre_sharded
            else:
                A, W, H, (m_sol, n_sol) = self._mesh_pad(
                    A, W, H,
                    true_shape=None if cfg.prune else orig_shape)
            if quant:
                # solve on Q = round(A/s); errors are scale-invariant and
                # the returned H carries s (linalg.quantize_uint8)
                A, a_scale = linalg.quantize_uint8(A)
            A, W, H = self._shard(A, W, H)

        eps = jnp.asarray(cfg.eps, dtype=cfg.dtype)
        with timing.timed("solve"):
            if cfg.solve_checkpoint_every > 0:
                if col_mask is not None:
                    raise ValueError("col_mask is incompatible with "
                                     "solve_checkpoint_every")
                W, H, err = self._solve_checkpointed(A, W, H, eps)
            else:
                W, H, err = solve(A, W, H, eps, cfg, col_mask=col_mask)
            W, H, err = jax.block_until_ready((W, H, err))
        self.recon_err = float(err)
        # (possibly padded) views for column_err; _valid_n masks padding
        self._A, self._W, self._H = A, W, H
        self._valid_n = n_sol

        if W.shape[0] != m_sol or H.shape[1] != n_sol:
            W = W[:m_sol]
            H = H[:, :n_sol]
        if a_scale is not None:
            # Q-scale factors stay in self._W/_H for column_err (which
            # compares against the stored Q); the returned H is A-scale
            H = H * a_scale.astype(H.dtype)
        if cfg.prune:
            W, H = unprune_factors(W, H, self.prune_state)
            if orig_shape and (W.shape[0] != orig_shape[0]
                               or H.shape[1] != orig_shape[1]):
                # pre-padded input: the pruned-away mesh padding was
                # restored as trailing zero rows/cols — slice it back off
                W = W[:orig_shape[0]]
                H = H[:, :orig_shape[1]]
        if cfg.save_factors:
            from ..parallel.mesh import host_local, is_proc0
            from ..utils.io import DataWriter
            with timing.timed("save_factors"):
                W_h, H_h = host_local(W), host_local(H)
                if is_proc0():       # reference rank-0 writer role
                    DataWriter(cfg.results_path, cfg.grid).save_factors(
                        W_h, H_h)
        return W, H, self.recon_err

    def _solve_checkpointed(self, A, W, H, eps):
        """Run the iteration loop in persisted chunks so a multi-hour
        factorization survives preemption (the reference has no recovery
        below whole-k granularity).  The trajectory is identical to one
        solve: chunks skip the final normalize/error (finalize=False) and a
        zero-iteration finalize pass applies them once at the end."""
        cfg = self.cfg
        if cfg.tol > 0:
            raise ValueError(
                "solve_checkpoint_every is incompatible with tol-based "
                "early stopping (fixed-iteration path only)")
        if cfg.method.lower() == "bcd":
            raise ValueError(
                "solve_checkpoint_every does not support BCD (its inner "
                "solver carries extrapolation state across iterations)")
        every = max(10, (cfg.solve_checkpoint_every // 10) * 10)
        os.makedirs(cfg.results_path, exist_ok=True)
        tag = repr((cfg.k, cfg.itr, cfg.norm.lower(), cfg.method.lower(),
                    cfg.seed, cfg.precision, cfg.a_precision,
                    tuple(A.shape)))
        # mesh-sharded factors persist via orbax/tensorstore (each process
        # writes only its own shards — multi-host safe); single-device via
        # one atomic npz (utils/checkpoint.py)
        from ..utils.checkpoint import solve_checkpointer
        sharded = getattr(getattr(W, "sharding", None),
                          "num_devices", 1) > 1
        saver = solve_checkpointer(cfg.results_path, cfg.k, tag, sharded)
        W, H, i = saver.load(W, H)
        while i < cfg.itr:
            n = min(every, cfg.itr - i)
            W, H, _ = solve(A, W, H, eps, cfg.replace(itr=n),
                            finalize=False)
            W, H = jax.block_until_ready((W, H))
            i += n
            saver.save(W, H, i)
        # zero-iteration finalize pass: normalize + error exactly once
        W, H, err = solve(A, W, H, eps, cfg.replace(itr=0), finalize=True)
        saver.cleanup()
        return W, H, err

    def column_err(self) -> np.ndarray:
        """Per-column relative error of the last fit, in pruned space padded
        back to global n (reference pyDNMF.py:220-239 computes it on the
        pruned matrices as well)."""
        sh = getattr(self._A, "sharding", None)
        err_chunk = linalg.error_chunk_rows(
            self._A.shape[0], self._A.shape[1],
            sharded=getattr(sh, "num_devices", 1) > 1)
        from ..parallel.mesh import host_local
        col = linalg.column_error(self._A, self._W, self._H, err_chunk)
        col = host_local(col)[:self._valid_n]
        if self.prune_state is not None:
            full = np.zeros(self.prune_state.n_cols_full, dtype=col.dtype)
            full[np.asarray(self.prune_state.col_mask)] = col
            return full
        return col
