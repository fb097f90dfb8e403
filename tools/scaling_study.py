"""Collective structure of the sharded MU step on virtual CPU meshes.

The reference publishes strong/weak-scaling tables (BASELINE.md: 10
FRO-MU iters, 57600x38400, ~115 s @ 2 procs -> ~0.8 s @ 256).  What can
be measured exactly without the hardware is the *communication structure*
GSPMD emits for every grid: collective op counts and bytes per iteration,
read off the compiled HLO (utils/timing.collective_stats), plus per-device
FLOPs and A bytes.  It does not depend on the device, so it runs entirely
on the 8-virtual-device CPU backend; times come only from runs on the
cards.

Prints a markdown table (docs/SCALING.md).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from pydnmfk_tpu.models import updates
from pydnmfk_tpu.parallel.mesh import grid_context
from pydnmfk_tpu.utils import timing

# flagship geometry, scaled so every grid tiles evenly
M_FULL, N_FULL, K = 57600, 38400, 32
SCALE = 25                       # CPU-sized: 2304 x 1536


def step_stats(grid, m, n, k, norm="fro"):
    """Compile one MU step on the mesh; return per-device compute numbers
    + exact collective stats from the HLO."""
    ctx = grid_context(*grid)
    A = jax.device_put(jnp.ones((m, n), jnp.float32), ctx.sharding_A)
    W = jax.device_put(jnp.ones((m, k), jnp.float32), ctx.sharding_W)
    H = jax.device_put(jnp.ones((k, n), jnp.float32), ctx.sharding_H)
    eps = jnp.float32(1e-7)
    if norm == "fro":
        fn = jax.jit(lambda a, w, h: updates.mu_fro_step(a, w, h, eps))
        flops = 4 * m * n * k
    else:
        fn = jax.jit(lambda a, w, h: updates.mu_kl_step(a, w, h, eps))
        flops = 8 * m * n * k
    stats = timing.collective_stats(fn, A, W, H)
    p = grid[0] * grid[1]
    return {
        "grid": f"{grid[0]}x{grid[1]}", "procs": p,
        "collective_ops": sum(stats["counts"].values()),
        "collective_counts": stats["counts"],
        "collective_bytes": stats["bytes"],
        "per_dev_flops": flops // p,
        "per_dev_A_bytes": 4 * m * n // p,
    }


def main():
    rows = []
    # --- strong scaling: fixed global problem, growing grid ---
    m, n = M_FULL // SCALE, N_FULL // SCALE
    for grid in [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (2, 4)]:
        for norm in ("fro", "kl"):
            s = step_stats(grid, m, n, K, norm)
            s["mode"] = "strong"
            s["norm"] = norm
            s["global"] = f"{m}x{n}"
            rows.append(s)
    # --- weak scaling: fixed per-device block (m grows with p_r) ---
    bm, bn = m, n
    for grid in [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2)]:
        mg, ng = bm * grid[0], bn * grid[1]
        s = step_stats(grid, mg, ng, K, "fro")
        s["mode"] = "weak"
        s["norm"] = "fro"
        s["global"] = f"{mg}x{ng}"
        rows.append(s)

    hdr = ("| mode | norm | grid | global | coll ops | coll bytes/iter | "
           "bytes/iter/dev A |")
    print(hdr)
    print("|" + "---|" * 7)
    for s in rows:
        print(f"| {s['mode']} | {s['norm']} | {s['grid']} | {s['global']} "
              f"| {s['collective_ops']} | {s['collective_bytes']:,} "
              f"| {s['per_dev_A_bytes']:,} |")


if __name__ == "__main__":
    main()
