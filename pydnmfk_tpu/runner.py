"""High-level object API.

Reference: ``pyDNMFk_Runner`` (pyDNMFk/runner.py:12-176).  Same surface:
construct with hyperparameters, call ``.run(grid=..., fpath=..., ...)``;
returns ``{"nopt": ...}`` for process="pyDNMFk" or ``{"W","H","err"}`` for
process="pyDNMF".
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

from .config import NMFConfig, NMFkConfig
from .models.nmf import NMF
from .models.nmfk import NMFk
from .parallel.mesh import grid_context
from .utils import timing
from .utils.io import DataReader


class Runner:
    def __init__(self, init="rand", itr=5000, norm="kl", method="mu",
                 verbose=False, checkpoint=False, timing_stats=False,
                 prune=False, precision="float32", perturbations=20,
                 noise_var=0.015, sill_thr=0.6, sampling="uniform",
                 process="pyDNMF", a_precision=None, seed_grid=None,
                 seed=100, tol=0.0, solve_checkpoint_every=0,
                 ensemble_batch=0, matmul_precision=None,
                 save_factors=False, bcd_obj=None,
                 sparse_grid_format=None, k_sweep_batch=None,
                 k_sweep_merge=None):
        if process not in ("pyDNMF", "pyDNMFk"):
            raise ValueError("process should be either pyDNMFk or pyDNMF")
        self.init = init
        self.itr = itr
        self.norm = norm
        self.method = method
        self.verbose = verbose
        self.checkpoint = checkpoint
        self.timing_stats = timing_stats
        self.prune = prune
        self.precision = precision
        self.a_precision = a_precision  # mixed precision: A-only storage dtype
        self.seed_grid = seed_grid      # reference-MPI seeding compat (config.py)
        self.perturbations = perturbations
        self.noise_var = noise_var
        self.sill_thr = sill_thr
        self.sampling = sampling
        self.process = process
        # knobs beyond the reference surface (config.py)
        self.seed = seed
        self.tol = tol
        self.solve_checkpoint_every = solve_checkpoint_every
        self.ensemble_batch = ensemble_batch
        self.matmul_precision = matmul_precision
        self.save_factors = save_factors
        self.bcd_obj = bcd_obj
        self.sparse_grid_format = sparse_grid_format
        self.k_sweep_batch = k_sweep_batch
        self.k_sweep_merge = k_sweep_merge
        timing.enable(timing_stats)
        from .config import enable_compilation_cache
        enable_compilation_cache()

    def run(self, grid: Sequence[int], fpath="data/", ftype="mat",
            fname="A", results_path="results/", k_range=(1, 10),
            step_k=1, k=4):
        if len(grid) != 2 or len(k_range) != 2:
            raise ValueError("grid and k_range need to be length-2")
        nmf_cfg = NMFConfig(
            k=k, grid=tuple(grid), init=self.init, itr=self.itr,
            norm=self.norm, method=self.method, prune=self.prune,
            precision=self.precision, verbose=self.verbose,
            results_path=results_path, a_precision=self.a_precision,
            seed=self.seed, tol=self.tol,
            solve_checkpoint_every=self.solve_checkpoint_every,
            matmul_precision=self.matmul_precision,
            save_factors=self.save_factors, bcd_obj=self.bcd_obj,
            sparse_grid_format=self.sparse_grid_format)
        ctx = grid_context(*grid)
        reader = DataReader(fpath, fname, ftype, pgrid=grid,
                            precision=self.precision)
        # pad_to_mesh: uneven shapes arrive zero-padded per block (no host
        # ever assembles the full matrix); true dims travel as orig_shape
        A = reader.read(ctx, pad_to_mesh=True)
        orig_shape = reader.last_global_shape
        if orig_shape == tuple(getattr(A, "shape", ())):
            orig_shape = None

        results = {}
        if self.process == "pyDNMFk":
            cfg = NMFkConfig(
                nmf=nmf_cfg, start_k=k_range[0], end_k=k_range[1],
                step_k=step_k, perturbations=self.perturbations,
                noise_var=self.noise_var, sampling=self.sampling,
                sill_thr=self.sill_thr, checkpoint=self.checkpoint,
                results_path=results_path, fname=fname,
                ensemble_batch=self.ensemble_batch,
                k_sweep_batch=self.k_sweep_batch,
                k_sweep_merge=self.k_sweep_merge,
                seed_grid=(tuple(self.seed_grid)
                           if self.seed_grid else None))
            results["nopt"] = NMFk(cfg, ctx).fit(A, orig_shape=orig_shape)
        else:
            W, H, err = NMF(nmf_cfg, ctx).fit(A, orig_shape=orig_shape)
            results.update(W=W, H=H, err=err)

        if self.timing_stats:
            os.makedirs(results_path, exist_ok=True)
            stats_path = os.path.join(results_path, "Timing_stats.csv")
            timing.save_csv(stats_path)
            try:
                from .utils.plotting import plot_timing_stats
                plot_timing_stats(stats_path, results_path)
            except Exception as e:           # best-effort, but never silent
                import warnings
                warnings.warn(f"timing plot failed: {e!r}")
        return results
