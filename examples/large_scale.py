"""BASELINE.json config 3: synthetic dense 100k x 1k, HALS and BCD on a
2D mesh (virtual CPU devices) or one GPU.

Run: python examples/large_scale.py [m] [n] [k]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(m=100_000, n=1_000, k=16):
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu import NMF, NMFConfig
    from pydnmfk_tpu.utils.data_generator import gauss_matrix

    rng = np.random.RandomState(100)
    W_true = gauss_matrix(m, k).astype(np.float32)
    H_true = rng.rand(k, n).astype(np.float32)
    # build A = W H on device in row blocks (host memory friendly)
    A = jnp.asarray(W_true) @ jnp.asarray(H_true)

    n_dev = jax.device_count()
    grid = (n_dev, 1) if n_dev > 1 else (1, 1)
    for method in ("hals", "bcd", "mu"):
        cfg = NMFConfig(k=k, grid=grid, itr=200, norm="fro", method=method,
                        precision="float32", seed=100)
        t0 = time.perf_counter()
        Wf, Hf, err = NMF(cfg).fit(A)
        dt = time.perf_counter() - t0
        print(f"{method:5s} {m}x{n} k={k} grid={grid}: "
              f"rel_err={err:.2e}  ({dt:.1f}s incl compile)", flush=True)
        assert err < 0.05, f"{method} failed to converge: {err}"


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
