"""Phase timing / profiling.

Reference: the ``comm_timing`` decorator + ``config.time/flag`` globals
(pyDNMFk/utils.py:539-567, config.py:1-5) which accumulate MPI.Wtime deltas
per function name.  Two reference warts fixed by design:

  * the enable flag is checked at *call* time, not latched at import
    (the reference latches at decoration time — utils.py:555-556 — so
    ``--timing_stats`` silently no-ops unless set before imports,
    main.py:58);
  * timings block on device completion (``block_until_ready``) so they
    measure real work, not dispatch.

``jax.profiler`` traces can be layered on top via ``trace()`` for XLA-level
compute/communication breakdown.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, Optional

import jax

# mutable module state (mirrors reference config.time / config.flag,
# but read dynamically)
TIMINGS: Dict[str, float] = {}
ENABLED: bool = False

# the reference's own category taxonomy (plot_results.timing_stats :157-201)
CATEGORIES = {
    "init": ["__init__", "init_factors", "compute_global_dim",
             "compute_local_dim"],
    "data_io": ["read", "read_global", "read_chunk", "save_factors",
                "save_cluster_results"],
    "sampling": ["sample_ensemble", "sample_one"],
    "dist_compute": ["solve", "mu_fro_step", "mu_kl_step", "hals_step",
                     "bcd_solve", "svd", "nnsvd"],
    "dist_comm": ["dist_comm_est"],
    "clustering": ["cluster_ensemble", "fit_clustering"],
}


def enable(on: bool = True):
    global ENABLED
    ENABLED = on


def reset():
    TIMINGS.clear()


def _record(name: str, dt: float):
    TIMINGS[name] = TIMINGS.get(name, 0.0) + dt


@contextlib.contextmanager
def timed(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


def timed_fn(fn: Callable) -> Callable:
    """Decorator analogue of reference comm_timing; flag read per call."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if not ENABLED:
            return fn(*a, **kw)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        out = jax.block_until_ready(out) if _is_arrayish(out) else out
        _record(fn.__name__, time.perf_counter() - t0)
        return out
    return wrapper


def _is_arrayish(x) -> bool:
    try:
        jax.tree_util.tree_leaves(x)
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# dist_comm accounting.  The reference times every MPI collective through the
# comm_timing decorator and groups them into a 'dist_comm' category
# (plot_results.py:157-201).  Under XLA the collectives are compiler-inserted,
# so the equivalent is read off the compiled HLO: op counts and bytes moved
# per collective kind, optionally converted to an estimated time via a link
# rate the caller supplies, to populate TIMINGS['dist_comm'].
# ---------------------------------------------------------------------------
_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                     "collective-permute", "all-to-all")
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}
_COLL_RE = None
_SHAPE_RE = None


def collective_stats(fn, *args) -> Dict[str, object]:
    """Collective op counts + bytes of a (jittable) function's compiled HLO.

    Returns ``{"counts": {kind: n}, "bytes": total_output_bytes}``.  Pass an
    already-jitted function or a plain callable plus example args.
    XLA's all-reduce combiner merges collectives into tuple-shaped ops;
    every tuple operand is summed (the round-2 version counted only the
    first — a silent undercount on any real update step).
    """
    import re
    global _COLL_RE, _SHAPE_RE
    if _COLL_RE is None:
        # result type (scalar or tuple) between '=' and the op name;
        # sync and async '-start' forms ('-done' repeats the shape and is
        # excluded so nothing double-counts)
        _COLL_RE = re.compile(
            r"=\s*(\([^)]*\)|[a-z0-9]+\[[\d,]*\]\S*)\s+(" +
            "|".join(_COLLECTIVE_KINDS) + r")(?:-start)?\(")
        _SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    txt = jitted.lower(*args).compile().as_text()
    counts = {k: 0 for k in _COLLECTIVE_KINDS}
    total = 0
    for m in _COLL_RE.finditer(txt):
        result_ty, kind = m.groups()
        counts[kind] += 1
        for dt, dims in _SHAPE_RE.findall(result_ty):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * _DTYPE_BYTES.get(dt, 4)
    return {"counts": {k: v for k, v in counts.items() if v},
            "bytes": total}


def record_dist_comm(fn, *args, link_gbps: float,
                     iterations: int = 1) -> Dict[str, object]:
    """Estimate collective time of ``fn(*args)`` from HLO bytes over the
    caller's per-link rate ``link_gbps`` (GB/s, measured on the machine at
    hand) and accumulate it under the reference's 'dist_comm' timing
    category.

    Recorded as ``dist_comm_est`` — the ``_est`` suffix marks it as a
    bytes/bandwidth model, distinguishing it from the measured wall-time
    entries it shares the Timing_stats.csv with."""
    stats = collective_stats(fn, *args)
    est = stats["bytes"] * iterations / (link_gbps * 1e9)
    if ENABLED:
        _record("dist_comm_est", est)
    stats["est_seconds"] = est
    return stats


def category_breakdown() -> Dict[str, float]:
    """Group accumulated timings into the reference's categories."""
    out = {c: 0.0 for c in CATEGORIES}
    other = 0.0
    for name, dt in TIMINGS.items():
        for cat, names in CATEGORIES.items():
            if name in names:
                out[cat] += dt
                break
        else:
            other += dt
    out["other"] = other
    return out


def save_csv(path: str):
    """One-row CSV of the accumulated timings (index column first, as the
    reference's pandas writer laid it out)."""
    import csv
    names = list(TIMINGS)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + names)
        w.writerow([0] + [TIMINGS[k] for k in names])


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """XLA profiler trace: compute vs collective breakdown in
    TensorBoard; replaces the reference's Timing_stats.csv taxonomy at the
    hardware level."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield
