"""Sparse-input workflow (beyond the reference, which is dense-only).

Builds a scipy.sparse .npz from the reference's swim.mat (35% natural
zeros), factorizes it through the Runner with ftype='npz', and runs the
sparse NMFk pipeline on a synthetic planted-k matrix.  Everything runs on
the nnz triplet on CPU (no dense m x n intermediate); on the GPU a cost
model measured per device kind picks dense or the ELL gather path
(ops/sparse.py::densify_for_backend).

Run: python examples/sparse_npz.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                                   # noqa: E402
import numpy as np                                        # noqa: E402
from jax.experimental import sparse                       # noqa: E402
from scipy import sparse as sp                            # noqa: E402
from scipy.io import loadmat                              # noqa: E402

from pydnmfk_tpu import NMFConfig, NMFkConfig             # noqa: E402
from pydnmfk_tpu.models.nmfk import NMFk                  # noqa: E402
from pydnmfk_tpu.runner import Runner                     # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as td:
        # --- single sparse NMF on real data via the Runner/CLI surface ---
        X = loadmat("/root/reference/data/swim.mat")["X"].astype(np.float32)
        sp.save_npz(os.path.join(td, "swim_sp.npz"), sp.csr_matrix(X))
        r = Runner(itr=200, norm="fro", method="mu", init="rand",
                   process="pyDNMF")
        out = r.run(grid=[1, 1], fpath=td + "/", ftype="npz",
                    fname="swim_sp", results_path=os.path.join(td, "res"),
                    k=4)
        print(f"sparse swim k=4 fro/mu: err = {out['err']:.4f}")
        assert 0.60 < out["err"] < 0.62      # matches the dense golden run

        # --- sparse NMFk selects the planted k ---
        rng = np.random.default_rng(7)
        m, n, ktrue = 80, 60, 3
        W = np.zeros((m, ktrue))
        for i in range(ktrue):
            c = (i + 0.5) * m / ktrue
            W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
        A = (W @ (rng.random((ktrue, n)) + 0.1)).astype(np.float32)
        A *= rng.random((m, n)) < 0.5
        Asp = sparse.BCOO.fromdense(jnp.asarray(A))
        cfg = NMFkConfig(nmf=NMFConfig(k=0, norm="kl", method="mu",
                                       itr=300, init="rand", seed=42),
                         start_k=2, end_k=5, perturbations=6,
                         noise_var=0.03, sill_thr=0.6,
                         results_path=os.path.join(td, "nmfk"),
                         fname="sp", checkpoint=False)
        nopt = NMFk(cfg).fit(Asp)
        print(f"sparse NMFk (kl/mu) selected k = {nopt}")
        assert nopt == ktrue


if __name__ == "__main__":
    main()
