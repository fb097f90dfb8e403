"""NMFk at scale on one card: memory-aware ensemble batching in action.

Runs the full k-selection pipeline on a synthetic low-rank matrix at a
fraction of the reference's headline size with bf16-A storage.  The
ensemble batch is auto-sized from the device memory budget
(utils/memory.py): at these sizes the whole 10-member ensemble cannot be
materialized at once, so the pipeline runs it in the largest batches that
fit — the reference's equivalent is a fully serial loop
(/root/reference/pyDNMFk/pyDNMFk.py:226-231).

Run: python examples/nmfk_large.py [m] [n] [true_k] [--cpu]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(m=28_800, n=19_200, true_k=8):
    import jax
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        m, n = m // 16, n // 16
    import jax.numpy as jnp
    from pydnmfk_tpu import NMFConfig, NMFk, NMFkConfig
    

    rng = np.random.RandomState(100)
    # disjoint-support W: row-block i loads only on feature i — an
    # unambiguous ground truth (overlapping Gaussian bumps at this scale
    # leave k-1 vs k genuinely undecidable at moderate iteration counts)
    W_true = np.zeros((m, true_k), np.float32)
    block = m // true_k
    for j in range(true_k):
        rows = slice(j * block, (j + 1) * block if j < true_k - 1 else m)
        W_true[rows, j] = rng.rand(rows.stop - rows.start)
    H_true = (0.1 + rng.rand(true_k, n)).astype(np.float32)
    A = jnp.asarray(W_true) @ jnp.asarray(H_true)

    cfg = NMFkConfig(
        nmf=NMFConfig(itr=400, norm="fro", method="mu", init="rand",
                      precision="float32", a_precision="bfloat16"),
        start_k=true_k - 1, end_k=true_k + 1, step_k=1,
        perturbations=10, noise_var=0.02, sill_thr=0.6,
        results_path="results_large/", fname="synth", checkpoint=False)
    t0 = time.perf_counter()
    model = NMFk(cfg)
    nopt = model.fit(A)
    dt = time.perf_counter() - t0
    print(f"{m}x{n} true_k={true_k}: estimated k = {nopt}  "
          f"(ensemble batch = {model.last_batch_size}/10, "
          f"{dt:.1f}s incl compiles)")
    assert nopt == true_k, f"expected {true_k}, got {nopt}"
    return nopt


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:] if a.isdigit()]
    main(*args)
