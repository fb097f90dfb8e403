"""Command-line entry point.

Reference: main.py:13-88.  Same argument surface (``--p_r --p_c --k --fpath
--ftype --fname --init --itr --norm --method --verbose --results_path
--checkpoint --timing_stats --prune --precision`` plus the NMFk block
``--perturbations --noise_var --start_k --end_k --step_k --sill_thr
--sampling``), launched as a single process per host (``python -m
pydnmfk_tpu ...``) instead of mpirun: JAX's runtime owns all local devices
and ``jax.distributed.initialize`` covers multi-host pods.
"""
from __future__ import annotations

import argparse
import sys


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser():
    p = argparse.ArgumentParser(
        description="Distributed NMF/NMFk in JAX "
                    "(python -m pydnmfk_tpu --process=pyDNMFk --p_r=2 --p_c=2 ...)")
    p.add_argument("--process", type=str, default="pyDNMF",
                   help="pyDNMF/pyDNMFk")
    # pyNMF block (reference main.py:13-31)
    p.add_argument("--p_r", type=int, required=True, help="mesh rows")
    p.add_argument("--p_c", type=int, required=True, help="mesh cols")
    p.add_argument("--k", type=int, default=4, help="feature count")
    p.add_argument("--fpath", type=str, default="data/")
    p.add_argument("--ftype", type=str, default="mat",
                   help="mat/npy/csv/txt/folder/npz (npz = scipy.sparse "
                        "save_npz; runs the sparse solvers)")
    p.add_argument("--fname", type=str, default="A_")
    p.add_argument("--init", type=str, default="rand", help="rand/nnsvd")
    p.add_argument("--itr", type=int, default=5000)
    p.add_argument("--norm", type=str, default="kl", help="KL/FRO")
    p.add_argument("--method", type=str, default="mu", help="MU/BCD/HALS")
    p.add_argument("--verbose", type=str2bool, default=False)
    p.add_argument("--results_path", type=str, default="results/")
    p.add_argument("--checkpoint", type=str2bool, default=False)
    p.add_argument("--timing_stats", type=str2bool, default=False)
    p.add_argument("--prune", type=str2bool, default=False)
    p.add_argument("--save_factors", type=str2bool, default=False,
                   help="persist W/H factor chunks under results_path "
                        "(reference PyNMF save_factors, pyDNMF.py:163-164)")
    p.add_argument("--precision", type=str, default="float32",
                   help="float16/bfloat16/float32/float64")
    # pyNMFk block (reference main.py:34-42)
    p.add_argument("--perturbations", type=int, default=20)
    p.add_argument("--noise_var", type=float, default=0.015)
    p.add_argument("--start_k", type=int, default=1)
    p.add_argument("--end_k", type=int, default=10)
    p.add_argument("--step_k", type=int, default=1)
    p.add_argument("--sill_thr", type=float, default=0.6)
    p.add_argument("--sampling", type=str, default="uniform",
                   help="uniform/poisson")
    # beyond the reference surface
    p.add_argument("--multihost", type=str2bool, default=False,
                   help="call jax.distributed.initialize() first (managed "
                        "clusters that it detects, e.g. SLURM)")
    p.add_argument("--a_precision", type=str, default=None,
                   help="mixed precision: storage dtype for A only "
                        "(e.g. bfloat16); factors/accumulation stay at "
                        "--precision")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (jax_platforms=cpu; env vars "
                        "are latched too early in some images)")
    p.add_argument("--seed_grid", type=str, default=None,
                   help="reference-MPI seeding compat, e.g. '2,2': tile "
                        "noise/init as the reference's identical-per-rank "
                        "numpy seeding does on that grid (docs/PARITY.md)")
    p.add_argument("--seed", type=int, default=100,
                   help="PRNG seed for init/perturbations")
    p.add_argument("--tol", type=float, default=0.0,
                   help="early stop when the relative error improves by "
                        "less than this between checks (0 = fixed --itr, "
                        "the reference behavior)")
    p.add_argument("--solve_checkpoint_every", type=int, default=0,
                   help="persist (W, H, iteration) every N iterations "
                        "inside one solve; an interrupted fit resumes "
                        "from the last chunk (0 = off)")
    p.add_argument("--ensemble_batch", type=int, default=0,
                   help="NMFk members per batched solve (0 = sized from "
                        "device memory)")
    p.add_argument("--matmul_precision", type=str, default=None,
                   help="dot-operand precision: default = XLA's default "
                        "(on an H100, f32 dots round operands to TF32 and "
                        "accumulate in f32); 'highest' = true-f32 dots")
    p.add_argument("--bcd_obj", type=str, default=None,
                   help="BCD objective: gram (default, no A-sized pass) "
                        "or residual (reference's explicit m x n pass)")
    p.add_argument("--sparse_grid_format", type=str, default=None,
                   help="sparse execution format on a multi-device grid: "
                        "auto (default: triplet), ell, or triplet")
    p.add_argument("--k_sweep_batch", type=str2bool, default=None,
                   help="batched k-sweep: one compiled solver program for "
                        "every k (default on; false = per-k programs)")
    p.add_argument("--k_sweep_merge", type=str2bool, default=None,
                   help="pack members of several ks into each ensemble "
                        "dispatch (default on with the batched sweep)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    if args.multihost:
        from .parallel.mesh import initialize_multihost
        initialize_multihost()

    from .runner import Runner
    runner = Runner(
        init=args.init, itr=args.itr, norm=args.norm, method=args.method,
        verbose=args.verbose, checkpoint=args.checkpoint,
        timing_stats=args.timing_stats, prune=args.prune,
        save_factors=args.save_factors,
        precision=args.precision, perturbations=args.perturbations,
        noise_var=args.noise_var, sill_thr=args.sill_thr,
        sampling=args.sampling, process=args.process,
        a_precision=args.a_precision,
        seed_grid=(tuple(int(x) for x in args.seed_grid.split(","))
                   if args.seed_grid else None),
        seed=args.seed, tol=args.tol,
        solve_checkpoint_every=args.solve_checkpoint_every,
        ensemble_batch=args.ensemble_batch,
        matmul_precision=args.matmul_precision,
        bcd_obj=args.bcd_obj,
        sparse_grid_format=(None if args.sparse_grid_format in
                            (None, "auto") else args.sparse_grid_format),
        k_sweep_batch=args.k_sweep_batch,
        k_sweep_merge=args.k_sweep_merge)
    results = runner.run(
        grid=[args.p_r, args.p_c], fpath=args.fpath, ftype=args.ftype,
        fname=args.fname, results_path=args.results_path,
        k_range=[args.start_k, args.end_k], step_k=args.step_k, k=args.k)
    if "nopt" in results:
        print("Rank estimated by NMFk =", results["nopt"])
    elif "err" in results:
        print("relative error =", results["err"])
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
