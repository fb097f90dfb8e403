"""Measure the sparse cost-model constants (ops/ell.py::SPARSE_COST_TABLE)
on the first device.

  dense_Bps   bytes/s at which the dense A @ Hᵀ streams a 16384² f32 A
              (k=32, XLA's default precision)
  slot_s      seconds per gathered slot of the production ELL product
              (ops/ell.py::_gather_product) at k=32 — 128-byte rows — as
              the slope of time against nnz over three sizes
  gather_Bps  gathered bytes/s of the same product at k=256 (1 KiB rows),
              from its slope
  floor_s     the k=32 fit's intercept: the fixed cost of one product

Times are the best of several runs, each ended by block_until_ready.
Prints the card line, the raw timings and, last, one JSON line holding the
table row keyed by the device's device_kind.

With ``--formats`` it times instead 10 FRO-MU iterations through
``models/nmf.solve`` on a 40000x40000 matrix with nnz 3.2e5, 3.2e6 and
3.2e7 (k=32) in each sparse execution format: single-device ELL, the
single-device BCOO triplet, and grid-ELL and the grid triplet on the (1,1)
grid, beside the densified matrix.

Run: python tools/sparse_probe.py [--formats]
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


def best_time(fn, *args, reps=7):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def ell_slope(k, dims, w=8, table_rows=40000, seed=0):
    """(intercept_s, slope_s_per_slot, [(nnz, t)]) of the ELL gather
    product over row counts ``dims`` at width w."""
    from pydnmfk_tpu.ops.ell import _gather_product
    rng = np.random.default_rng(seed)
    M = jax.random.uniform(jax.random.key(seed), (table_rows, k),
                           jnp.float32)
    prod = jax.jit(_gather_product)
    pts = []
    for dim in dims:
        vals = jnp.asarray(rng.random((dim, w), np.float32))
        idx = jnp.asarray(rng.integers(0, table_rows, (dim, w), np.int32))
        pts.append((dim * w, best_time(prod, vals, idx, M)))
    nnz = np.array([p[0] for p in pts], np.float64)
    t = np.array([p[1] for p in pts], np.float64)
    slope, intercept = np.polyfit(nnz, t, 1)
    return float(intercept), float(slope), pts


def random_bcoo(m, n, nnz, seed=3):
    """nnz distinct uniform positions, values in [0.1, 1.1)."""
    from jax.experimental import sparse as jsparse
    rng = np.random.default_rng(seed)
    flat = np.unique(rng.integers(0, m * n, int(nnz * 1.01)))
    flat = rng.permutation(flat)[:nnz]
    idx = np.stack([flat // n, flat % n], 1).astype(np.int32)
    vals = rng.random(idx.shape[0], np.float32) + 0.1
    return jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=(m, n),
                        unique_indices=True).sort_indices()


def format_times(m=40000, n=40000, k=32, nnzs=(320_000, 3_200_000,
                                                 32_000_000), itr=10):
    """Seconds per ``itr`` FRO-MU iterations in each execution format."""
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.models.nmf import solve
    from pydnmfk_tpu.ops.ell import ell_pack, grid_ell_pack
    from pydnmfk_tpu.ops.sparse import shard_sparse_grid
    from pydnmfk_tpu.parallel.mesh import grid_context

    cfg = NMFConfig(k=k, itr=itr, norm="fro", method="mu")
    eps = jnp.float32(cfg.eps)
    ctx1 = grid_context(1, 1)
    for nnz in nnzs:
        Asp = random_bcoo(m, n, nnz)
        row = {}
        for name, make in (
                ("ell", lambda: ell_pack(Asp)),
                ("bcoo-triplet", lambda: Asp),
                ("grid-ell", lambda: grid_ell_pack(Asp, ctx1)),
                ("grid-triplet", lambda: shard_sparse_grid(Asp, ctx1)[0]),
                ("densified", lambda: Asp.todense())):
            F = make()
            if F is None:
                row[name] = None
                continue
            mp, np_ = F.shape
            W = jax.random.uniform(jax.random.key(1), (mp, k), jnp.float32)
            H = jax.random.uniform(jax.random.key(2), (k, np_), jnp.float32)
            row[name] = best_time(lambda a, w, h: solve(a, w, h, eps, cfg),
                                  F, W, H, reps=3)
            del F
        print(f"{m}x{n} nnz={nnz} k={k}, s per {itr} iterations: "
              f"{json.dumps(row)}", flush=True)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"sparse_probe: no GPU (platform {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; device_kind={dev.device_kind}", flush=True)
    if "--formats" in sys.argv[1:]:
        format_times()
        return

    m = n = 16384
    A = jax.random.uniform(jax.random.key(1), (m, n), jnp.float32)
    H = jax.random.uniform(jax.random.key(2), (32, n), jnp.float32)
    t_dense = best_time(jax.jit(lambda a, h: a @ h.T), A, H)
    dense_Bps = m * n * 4 / t_dense
    print(f"dense A@Ht {m}x{n} f32 k=32: {t_dense!r} s -> "
          f"{dense_Bps / 1e9!r} GB/s", flush=True)
    del A

    dims = (1 << 15, 1 << 17, 1 << 19)
    floor_s, slot_s, pts = ell_slope(32, dims)
    print(f"ell k=32 (nnz, s): {pts}; floor {floor_s!r} s, "
          f"{slot_s!r} s/slot", flush=True)
    _, slope256, pts256 = ell_slope(256, dims)
    gather_Bps = 256 * 4 / slope256
    print(f"ell k=256 (nnz, s): {pts256}; {slope256!r} s/slot -> "
          f"{gather_Bps / 1e9!r} GB/s gathered", flush=True)
    row = {"floor_s": max(floor_s, 0.0), "slot_s": slot_s,
           "gather_Bps": gather_Bps, "dense_Bps": dense_Bps}
    print(json.dumps({"device_kind": dev.device_kind, "card": card,
                      "row": row}), flush=True)


if __name__ == "__main__":
    main()
