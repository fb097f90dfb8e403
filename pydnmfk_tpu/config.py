"""Typed configuration for the distributed NMFk framework.

Replaces the reference's untyped attribute-bag ``parse`` class and its two
coexisting calling conventions (CLI ``p_r/p_c/start_k/end_k`` fields vs the
runner's ``grid``/``k_range`` — see reference pyDNMFk/utils.py:480-483,
pyDNMF.py:60-63, pyDNMFk.py:132-135) with a single frozen dataclass pair.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


_PRECISIONS = {
    "float16": np.float16,
    "bfloat16": "bfloat16",
    "float32": np.float32,
    "float64": np.float64,
    # A-storage only (a_precision): global-scale uint8 quantization of the
    # nonnegative A (ops/linalg.py::quantize_uint8).  W/H and accumulation
    # stay at `precision`; the solve factorizes Q = round(A/s) and the
    # returned H carries the scale s.  Quarters the dominant HBM traffic
    # vs f32 (halves vs bf16).
    "uint8": np.uint8,
}


def ensure_precision_enabled(precision: str) -> None:
    """float64 needs the global x64 switch flipped before tracing."""
    if precision == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)


# Fixed cache location inside the checkout: a temporary, pid- or
# time-derived directory would never be found again by the next run.
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: an NMFk sweep compiles one program
    per (k, shape) — cached, re-runs and restarts skip all compiles.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here; otherwise the cache lives in
    ``<checkout>/.jax_cache``.
    """
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@dataclasses.dataclass(frozen=True)
class NMFConfig:
    """Configuration for a single NMF factorization (one k).

    Mirrors the argument surface of the reference CLI (main.py:13-31) and
    ``PyNMF`` (pyDNMF.py:54-101), re-expressed mesh-first: the MPI processor
    grid ``p_r x p_c`` becomes a JAX device-mesh shape ``grid``.
    """

    k: int = 4
    grid: Tuple[int, int] = (1, 1)          # (p_r, p_c) -> mesh axes ('r','c')
    init: str = "rand"                       # rand | nnsvd
    itr: int = 5000
    norm: str = "kl"                         # fro | kl
    method: str = "mu"                       # mu | hals | bcd
    prune: bool = False
    precision: str = "float32"               # float16/bfloat16/float32/float64
    seed: int = 100
    verbose: bool = False
    save_factors: bool = False
    W_update: bool = True
    results_path: str = "results/"
    # Knobs beyond the reference surface:
    # rows per chunk for the KL m x n intermediate; 0 = auto
    # (models/nmf.py::dense_chunks)
    kl_chunk: int = 0
    # Mixed precision: storage dtype for A only (e.g. "bfloat16").  W/H and
    # all accumulation stay at `precision`; matmuls read A in its storage
    # dtype (ops/linalg.py::matmul), halving the dominant memory traffic.
    # None = store A at `precision` (reference behavior).
    a_precision: Optional[str] = None
    tol: float = 0.0         # early stop when relative error improves < tol
    tol_check_every: int = 50   # iterations between convergence checks
    # Dot-operand precision: None = XLA's default.  On an H100 an f32 dot
    # at the default is a cuBLAS gemm that rounds its operands to TF32
    # (about 10 mantissa bits, f32 accumulation): an N(0,1) 2048x4096 @
    # 4096x2048 product lands 2.9e-4 from float64, against 1.1e-6 under
    # "highest" (chip_smoke.py phase 1 prints both, and the HLO call).
    # "highest" computes true-f32 dots at a higher per-iteration cost.
    matmul_precision: Optional[str] = None
    # HALS delayed-update block size: 0/None = the reference-structured
    # column-by-column sweep (default); > 0 runs exact Gauss-Seidel via
    # LAPACK-style blocked delayed updates (models/updates.py::hals_step).
    hals_block: Optional[int] = None
    # Sparse execution format on a multi-device ('r','c') grid:
    # None = the segment_sum triplet (ops/sparse.py::grid_sparse_format);
    # "ell" forces the per-block capped-ELL gather path.
    sparse_grid_format: Optional[str] = None
    # BCD objective evaluation: None/"gram" computes the per-iteration
    # objective (restore-vs-extrapolate decision only) via the Gram
    # identity from products the step already has — no third A-sized
    # pass; "residual" restores the
    # reference's explicit m x n residual (dist_nmf.py:560).
    bcd_obj: Optional[str] = None
    # Mid-solve checkpointing for long factorizations: > 0 runs the
    # iteration loop in chunks of this many iterations (rounded to a
    # multiple of 10 to keep the reference's eps-clip cadence) and persists
    # (W, H, iteration) after each chunk; an interrupted fit resumes from
    # the last chunk.  The chunked trajectory is identical to a single
    # solve (normalize/error run once, at the end).  The reference has no
    # recovery below whole-k granularity.  Incompatible with tol > 0.
    solve_checkpoint_every: int = 0

    @property
    def p_r(self) -> int:
        return self.grid[0]

    @property
    def p_c(self) -> int:
        return self.grid[1]

    @property
    def dtype(self):
        return np.dtype(_PRECISIONS[self.precision]) if self.precision != "bfloat16" else _PRECISIONS["bfloat16"]

    @property
    def a_dtype(self):
        """Storage dtype for A (mixed precision); defaults to `dtype`."""
        if self.a_precision is None:
            return self.dtype
        p = _PRECISIONS[self.a_precision]
        return p if self.a_precision == "bfloat16" else np.dtype(p)

    @property
    def eps(self) -> float:
        # reference: np.finfo(A.dtype).eps (pyDNMF.py:68-69)
        if self.precision == "bfloat16":
            return float(np.finfo(np.float32).eps)  # bf16 eps is too coarse for MU denominators
        return float(np.finfo(np.dtype(_PRECISIONS[self.precision])).eps)

    def replace(self, **kw) -> "NMFConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class NMFkConfig:
    """Configuration for the full NMFk model-selection pipeline.

    Mirrors reference parser_pyNMFk (main.py:34-42) + PyNMFk defaults
    (pyDNMFk.py:143-164).
    """

    nmf: NMFConfig = dataclasses.field(default_factory=NMFConfig)
    start_k: int = 1
    end_k: int = 10
    step_k: int = 1
    perturbations: int = 20
    noise_var: float = 0.015
    sampling: str = "uniform"                # uniform | poisson
    sill_thr: float = 0.6
    checkpoint: bool = True
    results_path: str = "results/"
    fname: str = "A"
    # How many ensemble members to run as one batched solve.
    # 0 = auto — sized from the device memory budget (utils/memory.py) so
    # the batched ensemble never exceeds device memory; an explicit value
    # overrides.
    # (The reference runs members serially, pyDNMFk.py:226-231 — the
    # equivalent here is ensemble_batch=1.)
    ensemble_batch: int = 0
    # Per-device memory budget in bytes for auto batch sizing; 0 = detect
    # (PYDNMFK_HBM_BUDGET env / device memory_stats).
    hbm_budget: int = 0
    # Batched k-sweep (None = auto-on for dense A): run every k of the
    # sweep through ONE compiled ensemble program by padding factors to
    # K = max(k_range) columns with a per-member active-column mask
    # (models/nmfk.py::_ensemble_program_polyk).  Removes the per-k
    # re-trace that otherwise makes compile time the dominant sweep cost;
    # the masked trajectory equals the unpadded per-k solve
    # (tests/test_k_sweep.py).  False restores the per-k programs.
    k_sweep_batch: Optional[bool] = None
    # Merged multi-k batches (None = auto-on whenever k_sweep_batch is
    # active and the sweep has > 1 k): members of SEVERAL k values pack
    # into each batched dispatch (per-member noise indexed by the per-k
    # perturbation number — results bitwise equal to the sequential
    # path; perturbed copies are shared across ks exactly as the
    # reference's seed=pert*1000 shares them).  False keeps one k per
    # ensemble batch.
    k_sweep_merge: Optional[bool] = None
    # Reference-MPI seeding compatibility: the reference seeds numpy
    # identically on every rank (pyDNMFk.py:32), so on a p_r x p_c grid the
    # perturbation noise is (p_r, p_c)-tiled and the rand-init factors are
    # (p_r*p_c)-fold tiled.  Set to that grid to reproduce the reference's
    # correlated-ensemble statistics (the executed swim golden nopt=16
    # depends on them — docs/PARITY.md); None = independent sampling (this
    # framework's default, statistically stronger).  Requires the (possibly
    # pruned) matrix dims to divide the grid, as the reference's
    # identical-stream property implicitly does.  Poisson sampling draws
    # every grid block with the same key (the counter-based analog of the
    # reference's identical per-rank seeding: equal-data blocks get
    # bitwise-equal draws, each block marginally Poisson).
    seed_grid: Optional[Tuple[int, int]] = None

    @property
    def k_range(self):
        return range(self.start_k, self.end_k + 1, self.step_k)

    def replace(self, **kw) -> "NMFkConfig":
        return dataclasses.replace(self, **kw)
