"""NMFk k-selection on swim.mat — JAX port of the reference example
examples/dist_pynmfk_2d_Swim.py (there: mpirun -n 4, 2x2 grid, KL/MU, rand
init, 20 perturbations, noise 0.016, itr 5000, k in [14,18]; asserts
nopt == 16 at :53).

The executed reference (4-rank MPI-shim run, tools/ref_harness/) returns
nopt = 16 — and its per-k statistics depend on MPI seeding correlations
(identical per-rank numpy seeds -> 2x2-tiled noise, 4x-tiled rand init).
``seed_grid=(2,2)`` reproduces that regime here: per-k min-silhouettes
0.30/0.47/0.69 vs the reference's 0.27/0.48/0.73 at k=14/15/16, nopt = 16
with comfortable gate margin.  Independent sampling (seed_grid=None, the
framework default) also selects 16 but sits within 0.02 of the silhouette
gate — see docs/PARITY.md.  The executed 4-rank reference takes ~54 min.
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pydnmfk_tpu import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu.utils.io import DataReader


def main(data_path="/root/reference/data/", results_path="results/",
         itr=5000, seed_grid=(2, 2)):
    A = DataReader(data_path, "swim", "mat", precision="float32").read_global()
    cfg = NMFkConfig(
        nmf=NMFConfig(itr=itr, norm="kl", method="mu", init="rand",
                      precision="float32", verbose=True),
        start_k=14, end_k=18, step_k=1,
        perturbations=20, noise_var=0.016, sampling="uniform",
        sill_thr=0.6, results_path=results_path, fname="swim",
        seed_grid=seed_grid)
    nopt = NMFk(cfg).fit(A)
    print("Estimated k =", nopt)
    return nopt


if __name__ == "__main__":
    nopt = main()
    assert nopt == 16, f"swim k-selection regressed: got {nopt}, expected 16"
