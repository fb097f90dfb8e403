"""Very-sparse / beyond-HBM factorization through the ELL gather path.

On the GPU the framework picks the execution format for sparse input by a
cost model measured per device kind (ops/sparse.py::densify_for_backend):
moderate densities densify (faster), while very sparse matrices with
large m*n — including those whose DENSE form cannot fit device memory at
all — run the dual-orientation ELL gather path (ops/ell.py) in O(nnz)
memory.

This example runs a CPU-sized version of both regimes end to end and
demonstrates forcing the format explicitly.

Run: python examples/sparse_ell_beyond_hbm.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                                   # noqa: E402
import numpy as np                                        # noqa: E402
from jax.experimental import sparse                       # noqa: E402

from pydnmfk_tpu import NMFConfig                         # noqa: E402
from pydnmfk_tpu.models.nmf import NMF                    # noqa: E402
from pydnmfk_tpu.ops.ell import ell_pack, ell_time_model  # noqa: E402


def planted_sparse_coo(m, n, ktrue, keep=0.02, seed=0):
    """Low-rank structure sampled down to `keep` density, built directly
    as COO (the dense matrix is never materialized)."""
    rng = np.random.default_rng(seed)
    nnz = int(m * n * keep)
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = (flat // n).astype(np.int32), (flat % n).astype(np.int32)
    W = rng.random((m, ktrue)).astype(np.float32)
    H = rng.random((ktrue, n)).astype(np.float32)
    vals = np.einsum("ek,ke->e", W[rows], H[:, cols]).astype(np.float32)
    idx = np.stack([rows, cols], 1)
    order = np.lexsort((cols, rows))
    return sparse.BCOO((jnp.asarray(vals[order]), jnp.asarray(idx[order])),
                       shape=(m, n), unique_indices=True,
                       indices_sorted=True)


def main():
    # ------------------------------------------------------------------
    # regime 1: the cost model — when does ELL beat streaming dense A?
    m, n, k = 40_000, 40_000, 8
    for nnz in (300_000, 30_000_000):
        t_ell, t_dense = ell_time_model(m, n, nnz, k)
        pick = "ELL" if t_ell < t_dense else "densify"
        print(f"{m}x{n}, nnz={nnz:.0e}: model picks {pick} "
              f"(ell {t_ell*1e3:.1f} ms vs dense {t_dense*1e3:.1f} ms "
              "per product)")

    # ------------------------------------------------------------------
    # regime 2: explicit ELL solve (CPU-sized stand-in for beyond-HBM)
    A = planted_sparse_coo(3000, 2400, ktrue=4, keep=0.01)
    E = ell_pack(A)
    print(f"\nELL pack: shape {E.shape}, nnz {E.nse}, "
          f"row width {E.rvals.shape[1]}, col width {E.cvals.shape[1]}")
    cfg = NMFConfig(k=4, norm="kl", method="mu", itr=400, seed=7)
    W, H, err = NMF(cfg).fit(E)
    print(f"ELL KL solve: rel_err={err:.4f}  W {W.shape}  H {H.shape}")

    # same data through the BCOO triplet path (CPU keeps it sparse)
    W2, H2, err2 = NMF(cfg).fit(A)
    print(f"BCOO solve:  rel_err={err2:.4f} (same data, "
          f"|delta|={abs(err - err2):.2e})")
    assert abs(err - err2) < 5e-3


if __name__ == "__main__":
    main()
