"""GPU probe: blocked delayed-update HALS and the BCD gram-identity
objective at the flagship geometry.

Measures, per 10 iterations through the production solve():
  * HALS bf16-A k=256 with hals_block in {0, 8, 16, 32, 64}
  * HALS f32 k=256 block 0 vs auto
  * BCD f32 k=32 gram vs residual objective

Run: python tools/hals_block_probe.py"""
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from pydnmfk_tpu.config import NMFConfig
from pydnmfk_tpu.models import nmf as nmf_mod

M, N = 57600, 38400
ITERS = 10


def time_solve(A, W, H, cfg, reps=3):
    eps = jnp.asarray(cfg.eps, cfg.dtype)
    W1, H1, err = nmf_mod.solve(A, W, H, eps, cfg)
    float(err)
    t0 = time.perf_counter()
    for _ in range(reps):
        W1, H1, err = nmf_mod.solve(A, W1, H1, eps, cfg)
    float(err)
    return (time.perf_counter() - t0) / reps


def main():
    assert jax.default_backend() == "gpu", jax.default_backend()
    key = jax.random.key(0)
    kA, kW, kH = jax.random.split(key, 3)
    A = jax.random.uniform(kA, (M, N), jnp.float32)
    k2 = 256
    W2 = jax.random.uniform(kW, (M, k2), jnp.float32)
    H2 = jax.random.uniform(kH, (k2, N), jnp.float32)
    base = NMFConfig(k=k2, itr=ITERS, norm="fro", method="hals",
                     precision="float32")

    # f32 k=256 first (A resident)
    for blk in (0, 16):
        dt = time_solve(A, W2, H2, base.replace(hals_block=blk))
        print(f"hals_f32_k256_block{blk}: {dt:.4f} s", flush=True)

    Ab = A.astype(jnp.bfloat16)
    del A
    for blk in (0, 8, 16, 32, 64):
        cfg = base.replace(a_precision="bfloat16", hals_block=blk)
        dt = time_solve(Ab, W2, H2, cfg)
        print(f"hals_bf16A_k256_block{blk}: {dt:.4f} s", flush=True)

    del Ab, W2, H2
    A = jax.random.uniform(kA, (M, N), jnp.float32)
    k = 32
    W0 = jax.random.uniform(kW, (M, k), jnp.float32)
    H0 = jax.random.uniform(kH, (k, N), jnp.float32)
    bcd = NMFConfig(k=k, itr=ITERS, norm="fro", method="bcd",
                    precision="float32")
    dt_g = time_solve(A, W0, H0, bcd)
    print(f"bcd_f32_k32_gram: {dt_g:.4f} s", flush=True)
    dt_r = time_solve(A, W0, H0, bcd.replace(bcd_obj="residual"))
    print(f"bcd_f32_k32_residual: {dt_r:.4f} s  "
          f"(gram speedup {dt_r / dt_g:.2f}x)", flush=True)
    # HALS k=32 sanity: blocked auto must not regress the small-k row
    hals32 = NMFConfig(k=k, itr=ITERS, norm="fro", method="hals",
                       precision="float32")
    for blk in (0, 8):
        dt = time_solve(A, W0, H0, hals32.replace(hals_block=blk))
        print(f"hals_f32_k32_block{blk}: {dt:.4f} s", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
