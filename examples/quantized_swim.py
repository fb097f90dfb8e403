"""uint8-quantized A storage on the reference's own sample data.

swim.mat is uint8 with max 255, so `a_precision="uint8"` quantizes it
EXACTLY (scale s = 1) — the solve reads one quarter of the f32 bytes of A
per product, and the result matches the f32 run to the bf16
matmul-rounding level.

Run: python examples/quantized_swim.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np                                        # noqa: E402
from scipy.io import loadmat                              # noqa: E402

from pydnmfk_tpu import NMF, NMFConfig                    # noqa: E402


def main():
    X = loadmat("/root/reference/data/swim.mat")["X"].astype(np.float32)
    cfg = NMFConfig(k=4, norm="fro", method="mu", itr=200, init="rand",
                    results_path="/tmp/quantized_swim/")
    _, _, e32 = NMF(cfg).fit(X)
    W8, H8, e8 = NMF(cfg.replace(a_precision="uint8")).fit(X)
    print(f"f32:   err = {e32:.6f}")
    print(f"uint8: err = {e8:.6f}")
    assert abs(e8 - e32) < 0.01
    # the returned factors are at A's scale (s folded into H)
    rel = (np.linalg.norm(np.asarray(W8) @ np.asarray(H8) - X)
           / np.linalg.norm(X))
    assert abs(rel - e8) < 0.01
    print("uint8 storage reproduces the f32 factorization; OK")


if __name__ == "__main__":
    main()
