"""Library-API example — JAX port of reference examples/
runner_example.py: the Runner object owns hyperparameters; .run() does the
rest."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pydnmfk_tpu import Runner

runner = Runner(init="nnsvd", itr=1000, norm="fro", method="mu",
                verbose=True, perturbations=20, noise_var=0.015,
                sill_thr=0.6, process="pyDNMFk")
results = runner.run(grid=[1, 1], fpath="/root/reference/data/",
                     ftype="mat", fname="wtsi", results_path="results/",
                     k_range=[1, 8], step_k=1)
print(results)
assert results["nopt"] == 4
