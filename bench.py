"""Benchmark: the reference's headline strong-scaling workload, measured
through the PRODUCTION solver path (models/nmf.solve — dispatch, tol
plumbing and all), plus mixed-precision / KL / HALS / BCD / sparse rows.

Reference baseline (BASELINE.md / docs/benchmark.png): 10 FRO-MU iterations
on a dense 57600x38400 matrix take ~115 s on 2 MPI processes (~0.8 s on
256).  The headline row times the same 10 iterations (including the
solver's final normalize + relative-error pass — the production number) on
the first GPU and reports vs_baseline = 115 / measured.

Prints exactly ONE JSON line; secondary rows ride in its "rows" field:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, "rows": [...]}

Without a GPU it refuses to run; ``--cpu`` runs a 1/16-size rehearsal on
the CPU whose times are CPU times, not device measurements.
"""
import json
import subprocess
import sys
import time

M, N, K = 57600, 38400, 32
ITERS = 10
BASELINE_2PROC_S = 115.0


def time_solve(A, W, H, cfg, reps=3, agg="mean"):
    """Simple timing of the full production solve.  ``agg='min'`` takes
    the per-rep minimum instead of the mean — used for format-comparison
    rows, where one slow first execution would otherwise swamp the
    steady-state rate."""
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu.models import nmf as nmf_mod

    eps = jnp.asarray(cfg.eps, cfg.dtype)
    # warmup/compile
    W1, H1, err = nmf_mod.solve(A, W, H, eps, cfg)
    float(err)
    if agg == "min":
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            W1, H1, err = nmf_mod.solve(A, W1, H1, eps, cfg)
            float(err)
            ts.append(time.perf_counter() - t0)
        return min(ts)
    t0 = time.perf_counter()
    for _ in range(reps):
        # chain outputs into inputs: every rep computes fresh values
        W1, H1, err = nmf_mod.solve(A, W1, H1, eps, cfg)
    float(err)  # forces the whole chain + a real device->host transfer
    return (time.perf_counter() - t0) / reps


def make_row(name, dt, m, n, k, iters, extra=None, flop_factor=4.0):
    # FRO-MU: two A-sized matmuls/iter = 4mnk; KL-MU: two WH products +
    # UHT + WTU = ~8mnk
    flops = flop_factor * m * n * k * iters
    row = {"metric": name, "value": round(dt, 4), "unit": "s",
           "gflops": round(flops / dt / 1e9, 1)}
    if extra:
        row.update(extra)
    return row


def main():
    import jax
    cpu = "--cpu" in sys.argv           # 1/16-size rehearsal on the CPU
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU found (platform "
                 f"{jax.devices()[0].platform!r}); use --cpu to rehearse")
    import jax.numpy as jnp
    from pydnmfk_tpu.config import NMFConfig, enable_compilation_cache
    enable_compilation_cache()

    on_gpu = not cpu
    if on_gpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"# card: {card}", file=sys.stderr)
    m, n, k = (M, N, K) if on_gpu else (M // 16, N // 16, K)
    quick = "--quick" in sys.argv       # headline row only
    scale = (m * n * k) / (M * N * K)   # pro-rate baseline on the CPU

    key = jax.random.key(0)
    kA, kW, kH = jax.random.split(key, 3)
    # generate directly on device: no host->device transfer of 8.8 GB
    A = jax.random.uniform(kA, (m, n), jnp.float32)
    W0 = jax.random.uniform(kW, (m, k), jnp.float32)
    H0 = jax.random.uniform(kH, (k, n), jnp.float32)

    base = NMFConfig(k=k, itr=ITERS, norm="fro", method="mu",
                     precision="float32")
    rows = []

    # ---- headline: f32 FRO-MU through the production solve() ----
    dt = time_solve(A, W0, H0, base)
    headline = make_row(f"fro_mu_{ITERS}iter_{m}x{n}_k{k}_f32_solve",
                        dt, m, n, k, ITERS)
    dev = jax.devices()[0]
    headline["device"] = {"platform": dev.platform,
                          "kind": dev.device_kind,
                          "count": len(jax.devices())}
    headline["vs_baseline"] = round(BASELINE_2PROC_S * scale / dt, 2)

    if not quick:
        # ---- HALS / BCD at the flagship shape: the
        # reference offers both as first-class methods (dist_nmf.py:411-579,
        # 873-1047).  HALS FLOPs live in the same AH^T/W^T A matmuls as MU
        # plus a sequential per-column loop (m*k^2 extra work; latency-
        # bound when k is large); BCD runs its own extrapolated inner loop
        # with an objective eval per iteration (~3 A-sized products/iter,
        # flop_factor 6) ----
        cfg = base.replace(method="hals")
        dt = time_solve(A, W0, H0, cfg)
        rows.append(make_row(f"fro_hals_{m}x{n}_k{k}_f32", dt, m, n, k,
                             ITERS))
        # BCD: the gram-identity objective (default since r5) removes the
        # third A-sized pass per iteration; the reference-style residual
        # objective is timed alongside for the delta
        cfg = base.replace(method="bcd")
        dt = time_solve(A, W0, H0, cfg)
        dt_res = time_solve(A, W0, H0, cfg.replace(bcd_obj="residual"))
        rows.append(make_row(f"fro_bcd_{m}x{n}_k{k}_f32", dt, m, n, k,
                             ITERS, flop_factor=6.0,
                             extra={"residual_obj_s": round(dt_res, 4),
                                    "speedup_gram_obj":
                                        round(dt_res / dt, 2)}))

        Ab = A.astype(jnp.bfloat16)

        # ---- bf16-A storage ----
        cfg = base.replace(a_precision="bfloat16")
        dt = time_solve(Ab, W0, H0, cfg)
        rows.append(make_row(f"fro_mu_bf16A_{m}x{n}_k{k}", dt, m, n, k,
                             ITERS))

        # ---- KL/MU (the flagship swim objective), chunked at full size:
        # the U intermediate stays bounded to kl_chunk slabs, so A is the
        # only device-resident big buffer ----
        cfg = base.replace(norm="kl", kl_chunk=4096)
        dt = time_solve(A, W0, H0, cfg)
        rows.append(make_row(f"kl_mu_chunked_{m}x{n}_k{k}_f32", dt, m,
                             n, k, ITERS, flop_factor=8.0))

        # ---- uint8-A storage (quantized: the A read is 1/4 the f32
        # bytes; exact for uint8-valued data like swim).  Placed after the
        # bf16 rows so Ab can be dropped first ----
        del Ab
        from pydnmfk_tpu.ops.linalg import quantize_uint8
        Aq, _ = quantize_uint8(A)
        cfg = base.replace(a_precision="uint8")
        dt = time_solve(Aq, W0, H0, cfg)
        rows.append(make_row(f"fro_mu_uint8A_{m}x{n}_k{k}", dt, m, n, k,
                             ITERS))
        del Aq

        # ---- compute-bound shapes (large k): 100 iterations per solve so
        # per-call dispatch latency cannot masquerade as a low rate ----
        big_k_iters = 100 if on_gpu else 10
        for mk, prec in ((256, "float32"), (256, "bfloat16"),
                         (512, "bfloat16")):
            mm = 8192 if on_gpu else 1024
            kA2, kW2, kH2 = jax.random.split(jax.random.fold_in(key, mk), 3)
            A2 = jax.random.uniform(kA2, (mm, mm),
                                    jnp.float32).astype(jnp.bfloat16)
            wdt = jnp.bfloat16 if prec == "bfloat16" else jnp.float32
            W2 = jax.random.uniform(kW2, (mm, mk), jnp.float32).astype(wdt)
            H2 = jax.random.uniform(kH2, (mk, mm), jnp.float32).astype(wdt)
            cfg = base.replace(k=mk, itr=big_k_iters, precision=prec,
                               a_precision="bfloat16")
            dt = time_solve(A2, W2, H2, cfg)
            rows.append(make_row(
                f"fro_mu_bf16A_{prec[0]}{'32' if prec=='float32' else '16'}"
                f"WH_{mm}x{mm}_k{mk}",
                dt, mm, mm, mk, big_k_iters))

        # ---- the reference's own 57600x38400 shape at k=256, where the
        # products are compute-bound — FRO, HALS and the chunked KL, all
        # through solve() ----
        if on_gpu:
            k2 = 256
            kW2, kH2 = jax.random.split(jax.random.fold_in(key, 99))
            W2 = jax.random.uniform(kW2, (m, k2), jnp.float32)
            H2 = jax.random.uniform(kH2, (k2, n), jnp.float32)
            # HALS at k=256: 256 sequential column updates per iteration
            cfg = base.replace(k=k2, method="hals")
            dt = time_solve(A, W2, H2, cfg)
            rows.append(make_row(f"fro_hals_{m}x{n}_k{k2}_f32", dt, m, n,
                                 k2, ITERS))
            Ab = A.astype(jnp.bfloat16)
            del A            # k=256 temps don't fit next to A (f32) + Ab
            cfg = base.replace(k=k2, a_precision="bfloat16")
            dt = time_solve(Ab, W2, H2, cfg)
            rows.append(make_row(f"fro_mu_bf16A_{m}x{n}_k{k2}_flagship",
                                 dt, m, n, k2, ITERS))
            # HALS with bf16 A storage: halves the A-streaming bytes
            cfg = base.replace(k=k2, method="hals", a_precision="bfloat16")
            dt = time_solve(Ab, W2, H2, cfg)
            rows.append(make_row(f"fro_hals_bf16A_{m}x{n}_k{k2}", dt, m,
                                 n, k2, ITERS))
            cfg = base.replace(k=k2, norm="kl", a_precision="bfloat16",
                               kl_chunk=4096)
            dt = time_solve(Ab, W2, H2, cfg)
            rows.append(make_row(
                f"kl_mu_chunked_bf16A_{m}x{n}_k{k2}_flagship", dt, m, n,
                k2, ITERS, flop_factor=8.0))
            del Ab, W2, H2

        # ---- sparse rows: the ELL gather path (ops/ell.py) in its two
        # regimes — (a) below the density crossover it beats the
        # densified path; (b) beyond the dense memory budget it is the
        # only single-card option ----
        if on_gpu:
            import numpy as np
            from jax.experimental import sparse as jsparse
            from pydnmfk_tpu.ops.ell import ell_pack

            def sparse_coo(ms, ns, nnz, seed=3):
                rng = np.random.default_rng(seed)
                flat = rng.choice(ms * ns, size=nnz, replace=False)
                idx = np.stack([flat // ns, flat % ns], 1).astype(np.int32)
                vals = rng.random(nnz, np.float32) + 0.1
                bc = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)),
                                  shape=(ms, ns), unique_indices=True)
                return bc.sort_indices()

            ms = ns = 40000      # dense f32 = 6.4 GB: streaming it twice
            nnz = 320_000        # per iter is the cost ELL avoids
            Asp = sparse_coo(ms, ns, nnz)
            E = ell_pack(Asp)
            kWs, kHs = jax.random.split(jax.random.fold_in(key, 7))
            Ws = jax.random.uniform(kWs, (ms, K), jnp.float32)
            Hs = jax.random.uniform(kHs, (K, ns), jnp.float32)
            cfg = base.replace(k=K)
            dt_e = time_solve(E, Ws, Hs, cfg)
            # densify on the host: device scatter would hold 2x A in HBM
            dense_np = np.zeros((ms, ns), np.float32)
            dense_np[np.asarray(Asp.indices[:, 0]),
                     np.asarray(Asp.indices[:, 1])] = np.asarray(Asp.data)
            dense = jnp.asarray(dense_np)
            del dense_np
            dt_d = time_solve(dense, Ws, Hs, cfg)
            del dense
            rows.append({
                "metric": f"sparse_ell_vs_dense_{ms}x{ns}_nnz3e5_k{K}",
                "value": round(dt_e, 4), "unit": "s",
                "dense_s": round(dt_d, 4),
                "speedup_vs_densified": round(dt_d / dt_e, 2)})

            # ---- batched ELL ensemble: the stacked-member gather rule
            # (ops/ell.py::_take_rows) turns b narrow gathers into one
            # wide one — per-member cost must drop well below the single
            # solve (the reference solves members serially) ----
            from pydnmfk_tpu.config import NMFConfig as _NC
            from pydnmfk_tpu.models.nmfk import (
                _ensemble_init_rand_program, _ensemble_program_sparse_ell)
            from pydnmfk_tpu.parallel.mesh import grid_context as _gc
            b_ens = 8
            packed = ell_pack(Asp, return_perms=True)
            E2, rperm, cperm, rt_p, ct_p = packed
            ncfg = _NC(k=K, itr=ITERS, norm="fro", method="mu")
            prog = _ensemble_program_sparse_ell(
                ncfg, "uniform", 0.03, ms, ns)
            init_p = _ensemble_init_rand_program(ncfg, K, ms, ns,
                                                 _gc(), False)
            key_e = jax.random.key(0)
            kmask_e = jnp.ones((b_ens, K), bool)

            def run_ens(off):
                midx = jnp.arange(b_ens) + off
                W0e, H0e = init_p(key_e, midx)
                return prog(Asp.data, E2, rperm, cperm, rt_p, ct_p,
                            key_e, midx, W0e, H0e, kmask_e)

            Wb, Hb, errs = run_ens(0)
            float(jnp.sum(errs))
            t0 = time.perf_counter()
            reps = 3
            off = 0
            for _ in range(reps):
                off += b_ens        # new member keys: no cached replay
                Wb, Hb, errs = run_ens(off)
            float(jnp.sum(errs)) ; float(jnp.sum(Wb))
            per_member = (time.perf_counter() - t0) / reps / b_ens
            rows.append({
                "metric": f"sparse_ell_ensemble_b{b_ens}_{ms}x{ns}_k{K}",
                "value": round(per_member, 4), "unit": "s/member",
                "speedup_vs_serial_single": round(dt_e / per_member, 2)})
            # beyond-HBM capability: 1e10 elements (40 GB f32) at 2e-5
            mb = nb = 100_000
            Asp = sparse_coo(mb, nb, 2_000_000, seed=4)
            E = ell_pack(Asp)
            kWs, kHs = jax.random.split(jax.random.fold_in(key, 8))
            Ws = jax.random.uniform(kWs, (mb, K), jnp.float32)
            Hs = jax.random.uniform(kHs, (K, nb), jnp.float32)
            dt_e = time_solve(E, Ws, Hs, cfg)
            rows.append({
                "metric": f"sparse_ell_beyond_hbm_{mb}x{nb}_nnz2e6_k{K}",
                "value": round(dt_e, 4), "unit": "s",
                "note": "dense f32 would need 40 GB; ELL runs in O(nnz)"})
            del E, Asp, Ws, Hs

            # ---- grid-sharded sparse formats: the per-block capped-ELL
            # gather path vs the segment_sum triplet, both through the SAME
            # shard_map grid machinery the mesh path uses (one card =
            # (1,1) grid; correctness across (2,2)/(2,1,'e') CPU meshes is
            # pinned by tests) ----
            from pydnmfk_tpu.ops.ell import grid_ell_pack
            from pydnmfk_tpu.ops.sparse import shard_sparse_grid
            from pydnmfk_tpu.parallel.mesh import grid_context
            ctx1 = grid_context(1, 1)
            Asp = sparse_coo(ms, ns, nnz, seed=3)
            Eg = grid_ell_pack(Asp, ctx1)
            Gt, _ = shard_sparse_grid(Asp, ctx1)
            E0 = ell_pack(Asp)          # single-device path, same matrix
            kWs, kHs = jax.random.split(jax.random.fold_in(key, 9))
            Ws = jax.random.uniform(kWs, (ms, K), jnp.float32)
            Hs = jax.random.uniform(kHs, (K, ns), jnp.float32)
            dt_ge = time_solve(Eg, Ws, Hs, cfg, reps=4, agg="min")
            dt_tri = time_solve(Gt, Ws, Hs, cfg, reps=4, agg="min")
            dt_pe = time_solve(E0, Ws, Hs, cfg, reps=4, agg="min")
            rows.append({
                "metric": f"sparse_grid_ell_vs_triplet_{ms}x{ns}_k{K}",
                "value": round(dt_ge, 4), "unit": "s",
                "triplet_s": round(dt_tri, 4),
                "plain_ell_s": round(dt_pe, 4),
                "speedup_vs_triplet": round(dt_tri / dt_ge, 2)})
            del Eg, Gt, E0, Asp, Ws, Hs

        # ---- end-to-end k-sweep: the reference's wtsi example — 8 k
        # values x 20 perturbations x 1000 FRO-MU iterations, nnsvd init
        # — through the batched-K sweep (ONE solver compile for all 8
        # ks) ----
        import os as _os
        _wtsi = "/root/reference/data/wtsi.mat"
        if _os.path.exists(_wtsi):
            import shutil as _sh
            import tempfile as _tmp
            from scipy.io import loadmat
            from pydnmfk_tpu.config import NMFkConfig as _NKC
            from pydnmfk_tpu.config import NMFConfig as _NC2
            from pydnmfk_tpu.models.nmfk import NMFk as _NMFk
            Xw = loadmat(_wtsi)["X"].astype("float32")
            _rdir = _tmp.mkdtemp(prefix="bench_wtsi_")
            kcfg = _NKC(
                nmf=_NC2(k=0, itr=1000, norm="fro", method="mu",
                         init="nnsvd", precision="float32"),
                start_k=1, end_k=8, perturbations=20, noise_var=0.015,
                sill_thr=0.6, results_path=_rdir + "/", fname="wtsi",
                checkpoint=False)
            t0 = time.perf_counter()
            nopt = _NMFk(kcfg).fit(Xw)
            dt_sweep = time.perf_counter() - t0
            _sh.rmtree(_rdir, ignore_errors=True)
            rows.append({
                "metric": "wtsi_sweep_8k_20pert_1000iter_e2e",
                "value": round(dt_sweep, 2), "unit": "s",
                "nopt": int(nopt),
                "note": "merged batched-K sweep (one solver compile, "
                        "multi-k dispatches); reference 4-rank MPI: "
                        "183 s"})

    headline["rows"] = rows
    print(json.dumps(headline))
    for r in rows:
        if "gflops" in r:
            print(f"# {r['metric']}: {r['value']}s  {r['gflops']} GFLOP/s",
                  file=sys.stderr)
        else:
            print(f"# {r['metric']}: {r['value']}s  "
                  + " ".join(f"{k2}={v}" for k2, v in r.items()
                             if k2 not in ("metric", "value", "unit")),
                  file=sys.stderr)


if __name__ == "__main__":
    main()
