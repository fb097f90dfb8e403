"""Slope measurement: marginal per-iteration cost of the production solve,
separated from the per-solve fixed cost (final error pass + dispatch) via
(t(50 iters) - t(10 iters)) / 40, at the flagship f32 shape.  With
--highest the f32 dots run in true f32 instead of XLA's default precision.

Usage: python tools/slope_probe.py [--highest]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--highest" in sys.argv:
    jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp

from pydnmfk_tpu.config import NMFConfig
from pydnmfk_tpu.models import nmf as nmf_mod


def main():
    m, n, k = 57600, 38400, 32
    key = jax.random.key(0)
    kA, kW, kH = jax.random.split(key, 3)
    A = jax.random.uniform(kA, (m, n), jnp.float32)
    W0 = jax.random.uniform(kW, (m, k), jnp.float32)
    H0 = jax.random.uniform(kH, (k, n), jnp.float32)

    def t_of(itr, reps=4):
        cfg = NMFConfig(k=k, itr=itr, norm="fro", method="mu")
        eps = jnp.asarray(cfg.eps, cfg.dtype)
        W1, H1, e = nmf_mod.solve(A, W0, H0, eps, cfg)
        float(e)
        t0 = time.perf_counter()
        for _ in range(reps):
            W1, H1, e = nmf_mod.solve(A, W1, H1, eps, cfg)
        float(e)
        return (time.perf_counter() - t0) / reps

    t10, t50 = t_of(10), t_of(50)
    per_iter = (t50 - t10) / 40
    fixed = t10 - 10 * per_iter
    print(f"t10={t10*1e3:.1f} ms  t50={t50*1e3:.1f} ms  ->  "
          f"{per_iter*1e3:.2f} ms/iter marginal, "
          f"~{fixed*1e3:.1f} ms fixed per solve")


if __name__ == "__main__":
    main()
