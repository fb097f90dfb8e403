"""Device-memory budgeting for the batched NMFk ensemble.

The reference solves ensemble members serially (pyDNMFk.py:226-231), so its
peak memory is one perturbed copy of A.  This framework batches members into
one vmapped program — a large parallelism win that must not exceed device
memory at flagship scale (57600x38400 f32 is 8.8 GB per copy; 20 copies is
176 GB).  ``auto_ensemble_batch`` sizes the batch from the device memory budget
with a conservative per-member cost model, so the pipeline degrades smoothly
from "whole ensemble at once" down to the reference's serial behavior as the
problem grows.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

# Working-set multipliers (deliberately conservative):
#   A_WORK: the perturbed copy + one elementwise/transpose temp XLA may hold.
#   F_WORK: W/H plus MU numerators/denominators, init factors, and the
#           fori_loop double-buffer.
A_WORK = 2.5
F_WORK = 8.0
HEADROOM = 0.85          # fraction of the budget we allow ourselves
# The CPU backend reports no memory stats; batches there are sized
# against this much host memory.
CPU_BUDGET = 8 << 30


def device_memory_budget() -> int:
    """Per-device memory budget in bytes.

    Order: the PYDNMFK_HBM_BUDGET env var, then the first local device's
    ``memory_stats()["bytes_limit"]`` (the pool JAX reserved on the card).
    An accelerator that reports neither is an error, never a guessed size;
    the CPU backend, which has no stats, uses CPU_BUDGET.
    """
    env = os.environ.get("PYDNMFK_HBM_BUDGET")
    if env:
        return int(float(env))
    import jax
    from ..parallel.mesh import on_accelerator
    stats = jax.local_devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if on_accelerator():
        raise RuntimeError(
            f"device {jax.local_devices()[0].device_kind!r} reports no "
            "memory_stats()['bytes_limit']; set PYDNMFK_HBM_BUDGET (bytes) "
            "or NMFkConfig.hbm_budget")
    return CPU_BUDGET


def ensemble_member_bytes(m: int, n: int, k: int, ncfg, grid_shape,
                          p_e: int = 1) -> int:
    """Per-device bytes one ensemble member adds to the working set."""
    p_r, p_c = grid_shape
    a_bytes = np.dtype(ncfg.a_dtype).itemsize if ncfg.a_precision != "bfloat16" \
        else 2
    w_bytes = 2 if ncfg.precision == "bfloat16" else np.dtype(ncfg.dtype).itemsize
    block = m * n * a_bytes / (p_r * p_c)
    cost = block * A_WORK
    if ncfg.norm.lower() == "kl":
        # the U = A/(WH+eps) intermediate (f32) per device: bounded to
        # kl_chunk rows when chunking is on, a full block otherwise
        u_rows = min(ncfg.kl_chunk, m) if ncfg.kl_chunk else m
        cost += u_rows * n * 4 / (p_r * p_c)
    cost += (m * k / p_r + k * n / p_c) * w_bytes * F_WORK
    return int(cost)


def auto_ensemble_batch_sparse(m: int, n: int, nnz: int, k: int,
                               n_pert: int, ncfg,
                               budget: Optional[int] = None) -> int:
    """Member batch for the sparse-A ensemble (single device): members are
    nnz-sized data copies over shared indices; the gather intermediates are
    (nnz_chunk, k) slabs (ops/sparse.py)."""
    if budget is None:
        budget = device_memory_budget()
    from ..ops.sparse import nnz_chunk_size
    a_bytes = 2 if ncfg.a_precision == "bfloat16" \
        else np.dtype(ncfg.a_dtype).itemsize
    w_b = 2 if ncfg.precision == "bfloat16" \
        else np.dtype(ncfg.dtype).itemsize
    fixed = nnz * (w_b + 8)                       # data + int32 index pair
    chunk = nnz_chunk_size(nnz, k) or nnz
    per_member = (nnz * a_bytes * A_WORK          # perturbed data copies
                  + chunk * k * 4 * 2             # gather/segment slabs
                  + (m * k + k * n) * w_b * F_WORK)
    avail = budget * HEADROOM - fixed
    batch = max(1, int(avail // per_member)) if avail > 0 else 1
    return min(n_pert, batch)


def auto_ensemble_batch(m: int, n: int, k: int, n_pert: int, ncfg,
                        grid_shape, p_e: int = 1,
                        budget: Optional[int] = None) -> int:
    """Largest member batch that fits the device budget (multiple of p_e).

    Never returns less than p_e (one member per ensemble-axis device) —
    below that the problem simply does not fit and XLA will report the OOM
    with the true numbers.
    """
    if budget is None:
        budget = device_memory_budget()
    p_r, p_c = grid_shape
    # the shared unperturbed A is held at the WORK precision (NMFk.fit
    # casts to cfg.nmf.dtype before the pipeline); only the perturbed
    # member copies are stored at a_precision
    w_b = 2 if ncfg.precision == "bfloat16" else np.dtype(ncfg.dtype).itemsize
    fixed = m * n * w_b / (p_r * p_c)
    per_member = ensemble_member_bytes(m, n, k, ncfg, grid_shape, p_e)
    avail = budget * HEADROOM - fixed
    per_dev = max(1, int(avail // per_member)) if avail > 0 else 1
    batch = min(n_pert, per_dev * p_e)
    batch = max(p_e, (batch // p_e) * p_e)
    return batch
