"""GPU probe: end-to-end wtsi k-selection sweep wall-clock.

Usage: python tools/wtsi_sweep_probe.py <polyk: 0|1>
Cold-vs-warm compile cost is controlled by the CALLER via
JAX_COMPILATION_CACHE_DIR (else the cache lives in <checkout>/.jax_cache)
and by using a fresh process per run."""
import sys
import tempfile
import time

sys.path.insert(0, ".")

import jax
from scipy.io import loadmat

from pydnmfk_tpu.config import NMFConfig, NMFkConfig
from pydnmfk_tpu.models.nmfk import NMFk


def main():
    polyk = bool(int(sys.argv[1]))
    X = loadmat("/root/reference/data/wtsi.mat")["X"].astype("float32")
    rdir = tempfile.mkdtemp(prefix="wtsi_probe_")
    cfg = NMFkConfig(
        nmf=NMFConfig(k=0, itr=1000, norm="fro", method="mu",
                      init="nnsvd", precision="float32"),
        start_k=1, end_k=8, perturbations=20, noise_var=0.015,
        sill_thr=0.6, results_path=rdir + "/", fname="wtsi",
        checkpoint=False, k_sweep_batch=polyk)
    t0 = time.perf_counter()
    nopt = NMFk(cfg).fit(X)
    dt = time.perf_counter() - t0
    print(f"WTSI_SWEEP polyk={int(polyk)} backend={jax.default_backend()} "
          f"wall={dt:.2f}s nopt={nopt}", flush=True)
    assert nopt == 4, nopt


if __name__ == "__main__":
    main()
