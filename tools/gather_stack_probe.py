"""Does stacking ensemble member tables widen the gather row and beat
vmap's batched gather?  (XLA's gather rate rises with row width, so one
wide gather of b stacked tables can beat b narrow ones.)

Compares, for b members sharing one index set (the ELL ensemble shape):
  vmap    : jax.vmap(lambda t: take(t, idx))(tables (b,n,k))
  stacked : take(tables.moveaxis->reshape (n, b*k), idx)  — one wide gather

Run: python tools/gather_stack_probe.py
"""
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    print("backend:", jax.default_backend(), flush=True)
    rng = np.random.default_rng(0)

    def run(fn, x, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            x = fn(x)
        float(jnp.sum(x))
        return time.perf_counter() - t0

    def slope(fn, x):
        fn(x)
        t3 = min(run(fn, x, 3) for _ in range(3))
        t10 = min(run(fn, x, 10) for _ in range(3))
        return (t10 - t3) / 7

    n, S = 40_000, 640_000         # table rows, gather slots
    take_rows = jnp.asarray((np.arange(n) % S).astype(np.int32))
    for b, k in [(1, 32), (4, 32), (8, 32), (16, 32), (1, 64), (8, 64),
                 (1, 256)]:
        idx = jnp.asarray(rng.integers(0, n, (S,)).astype(np.int32))
        tabs = jnp.asarray(rng.random((b, n, k), np.float32))

        @jax.jit
        def vmap_step(tabs):
            out = jax.vmap(lambda t: jnp.take(t, idx, axis=0))(tabs)
            # (b, S, k) -> chain back into the tables
            return tabs + out[:, take_rows, :] * 1e-3

        @jax.jit
        def stack_step(tabs):
            wide = jnp.moveaxis(tabs, 0, 1).reshape(n, b * k)
            out = jnp.take(wide, idx, axis=0)          # (S, b*k)
            out = jnp.moveaxis(out.reshape(S, b, k), 1, 0)
            return tabs + out[:, take_rows, :] * 1e-3

        t_v = slope(vmap_step, tabs)
        t_s = slope(stack_step, tabs)
        bytes_ = S * b * k * 4
        print(f"b={b} k={k}: vmap={t_v*1e3:.2f}ms "
              f"({bytes_/t_v/1e9:.0f} GB/s) stacked={t_s*1e3:.2f}ms "
              f"({bytes_/t_s/1e9:.0f} GB/s) "
              f"per-member-slot: vmap={t_v/b/S*1e9:.2f}ns "
              f"stacked={t_s/b/S*1e9:.2f}ns", flush=True)


if __name__ == "__main__":
    main()
