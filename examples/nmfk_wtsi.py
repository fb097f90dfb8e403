"""NMFk k-selection on wtsi.mat — JAX port of the reference example
examples/dist_pynmfk_1d_wtsi.py (there: mpirun -n 4, 4x1 grid; here: one
process owning all local devices; the mesh shape only changes shardings).

Golden answer: nopt == 4.
"""
import numpy as np

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pydnmfk_tpu import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu.utils.io import DataReader


def main(data_path="/root/reference/data/", results_path="results/"):
    A = DataReader(data_path, "wtsi", "mat", precision="float32").read_global()
    cfg = NMFkConfig(
        nmf=NMFConfig(itr=1000, norm="fro", method="mu", init="nnsvd",
                      precision="float32", verbose=True),
        start_k=1, end_k=8, step_k=1,
        perturbations=20, noise_var=0.015, sampling="uniform",
        sill_thr=0.6, results_path=results_path, fname="wtsi")
    nopt = NMFk(cfg).fit(A)
    print("Estimated k =", nopt)
    assert nopt == 4
    return nopt


if __name__ == "__main__":
    main()
