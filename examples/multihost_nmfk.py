"""Whole-pipeline multi-host NMFk — the equivalent of the reference's
``mpirun -n 4 python main.py --process=pyDNMFk ...`` (main.py:45-88).

Launch one copy of this script per host/process (the same contract as
mpirun; on a managed cluster `initialize_multihost()` auto-detects and the
CLI flag `--multihost` does the same):

    # terminal 1                          # terminal 2
    python examples/multihost_nmfk.py \
        --coord=10.0.0.1:9999 --nprocs=2 --pid=0     ... --pid=1

Several processes on ONE GPU host each take their own card with
``--card=<index>`` (a JAX process reserves most of every card it opens);
add ``--cpu`` instead to demo 2 processes on one box without cards.

What happens, per process:
  * jax.distributed bootstrap (replaces mpirun process management)
  * DataReader block-reads ONLY the rows/cols this host's devices own
    (dense formats via the block/.cache.npy reader; 'folder' opens only
    the overlapping pre-split chunks; CSR .npz streams per-host row
    panels into the sharded block layout)
  * one NMFk over the global mesh: ensemble solves run as cross-process
    SPMD programs; clustering/statistics replicate from allgathered host
    copies; results.h5/factors/checkpoint are written by process 0 (the
    reference's rank-0 role) on a SHARED results filesystem
  * every process returns the same nopt

A crash at any point resumes from the per-k checkpoints (see
tests/_multihost_worker.py for a kill+resume exercised end-to-end).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True,
                    help="coordinator address host:port (process 0's)")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--p_r", type=int, default=2)
    ap.add_argument("--p_c", type=int, default=1)
    ap.add_argument("--fpath", default="/root/reference/data/")
    ap.add_argument("--fname", default="wtsi")
    ap.add_argument("--ftype", default="mat")
    ap.add_argument("--results", default="results_mh/")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (local multi-process "
                         "demo on one box)")
    ap.add_argument("--card", type=int, default=None,
                    help="the one GPU this process owns, when several "
                         "processes share a host")
    args = ap.parse_args()

    import jax

    if args.cpu:
        # env vars are latched too late in some environments; the config
        # update after `import jax` always works
        jax.config.update("jax_platforms", "cpu")

    from pydnmfk_tpu.parallel.mesh import (GridContext, initialize_multihost,
                                           make_grid_mesh)

    initialize_multihost(args.coord, num_processes=args.nprocs,
                         process_id=args.pid,
                         local_device_ids=(None if args.card is None
                                           else [args.card]))

    from pydnmfk_tpu import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu.utils.io import DataReader

    ctx = GridContext(make_grid_mesh(args.p_r, args.p_c))
    reader = DataReader(args.fpath, args.fname, args.ftype,
                        pgrid=(args.p_r, args.p_c), precision="float32")
    A = reader.read(ctx, pad_to_mesh=True)   # per-host block reads
    cfg = NMFkConfig(
        nmf=NMFConfig(grid=(args.p_r, args.p_c), norm="fro", method="mu",
                      init="nnsvd", itr=1000),
        start_k=1, end_k=8, perturbations=20, sill_thr=0.6,
        results_path=args.results, fname=args.fname, checkpoint=True)
    nopt = NMFk(cfg, ctx).fit(A, orig_shape=reader.last_global_shape)
    print(f"[process {jax.process_index()}] estimated k = {nopt}")


if __name__ == "__main__":
    main()
