"""End-to-end check of NMF and NMFk on one NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py                # one card: phases 1-7 below
    python chip_smoke.py --four-cards   # the sharded path on four cards

Every phase runs through the entry points a user calls (``models/nmf.solve``,
``NMF``, ``NMFk``, the CLI) at the sizes users run, on data generated from
fixed seeds.  Each comparison states its tolerance and the reason for it.
The script exits non-zero, and prints no result, when JAX finds no GPU or
when any phase fails; on success its last line is one JSON object naming
the device.  One process owns the cards throughout (the CLI runs
in-process).

Phases (one card):
  1. device check: platform, device kind, count, memory pool, and what
     XLA's default precision does to an f32 dot;
  2. the reference's headline workload, dense 57600x38400 f32 k=32, 10
     iterations through ``solve``: FRO-MU, KL-MU, HALS, BCD, FRO-MU with
     bf16-stored A and with uint8-stored A;
  3. a plain jax.numpy FRO-MU / KL-MU (no ``pydnmfk_tpu`` code) at full
     size under "highest" precision, against the production path;
  4. the four methods at 4096x2048 k=16, 50 iterations, on the GPU and on
     the host CPU in the same process, both under "highest";
  5. a 40000x40000 sparse matrix (nnz 3.2e5) in every execution format:
     the policy's pick through ``NMF.fit``, ELL, grid-ELL, the grid
     triplet, each against the densified matrix from one W0/H0: one
     A Hᵀ and one Wᵀ A, then a solve;
  6. the NMFk sweep of examples/nmfk_large.py (28800x19200, planted k=8,
     bf16 A, k 7..9, 10 perturbations, 400 iterations) must return 8;
  7. the CLI on a planted 4096x2048 .npy must print the planted rank.

Four cards: the headline FRO-MU and KL-MU on the (2,2) and (4,1) grids
against the same solve on one card, a check that each card holds a quarter
of A, and the NMFk sweep of phase 6 on the (2,2) grid.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HEADLINE = (57600, 38400, 32)      # the reference's strong-scaling matrix
HEADLINE_ITERS = 10
CROSS = (4096, 2048, 16)
CROSS_ITERS = 50
SPARSE = (40000, 40000, 320_000, 32)
SPARSE_ITERS = 100
NMFK_LARGE = (28800, 19200, 8)
NMFK_ITERS = 400
CLI_SHAPE = (4096, 2048, 4)

# --- tolerances ---------------------------------------------------------
# Production path (XLA's default precision, under which phase 1 shows an
# f32 dot rounding its operands to TF32, about 10 mantissa bits, f32
# accumulation) against the plain loop under "highest" (true f32): each
# product differs by ~1e-3 relative per element, but the relative error
# is a norm over m*n entries, where those roundings average out, and 10 MU
# iterations do not amplify them.
REF_ERR_RTOL = 1e-3
# The same pair compared factor by factor: W columns are L1-normalized, so
# the L1 distance between matching columns is a relative measure; TF32
# rounding moves it by far less than one percent.
REF_W_L1 = 1e-2
# bf16 A keeps 8 mantissa bits (rounding <= 2^-9 relative per entry) and
# uint8 A is rounded to 1/255 of the maximum; both perturb A far below the
# relative reconstruction error of a rank-32 fit to a random matrix.
LOWP_ERR_ATOL = 1e-2
# The same code on the GPU and on the host CPU, both under "highest": only
# the order of f32 sums differs (the GPU splits reductions across blocks).
# Over 50 iterations MU and HALS stay within single-precision drift; BCD's
# restore-or-extrapolate test may flip on a last-bit tie, so its
# trajectories can part for a step before meeting again.
CROSS_ERR_RTOL = {"fro-mu": 1e-4, "kl-mu": 1e-4, "fro-hals": 1e-4,
                  "fro-bcd": 1e-3}
# Sparse formats against the densified matrix under "highest", first one
# A Hᵀ and one Wᵀ A from the same W0/H0: each output entry sums the same
# ~8 nonzero terms in another order (a gather or a segment sum against a
# dense dot whose other terms are exact zeros), so the products differ by
# a few f32 ulps, ~1e-7 in Frobenius norm; a path that drops, duplicates
# or misplaces entries is off by O(1).
SPARSE_PROD_RTOL = 1e-5
# (On an H100 the formats' products have come within 6.6e-8.)  Then
# SPARSE_ITERS MU iterations from the same W0/H0: the formats' rel errors
# have differed by at most 6e-8 (one ulp at 0.998), while a path whose
# products were zero would end at 1.0, 2e-3 away, so 1e-5 leaves two
# orders of room on each side.  W columns are L1-normalized (distance 2
# at most) and have come within 2.8e-5 of the densified run's; 1e-3 sits
# between that and a wrong factor.
SPARSE_ERR_RTOL = 1e-5
SPARSE_W_L1 = 1e-3
# Four cards against one: the sharded products psum per-block partials, a
# different f32 summation order under the same TF32 dots.
MESH_ERR_RTOL = 1e-4


def log(*args):
    print(*args, flush=True)


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, one
    line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def require_gpu():
    """Phase 1's gate: the first JAX device must be a GPU.  Raises
    SystemExit otherwise, before any result is printed."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r}); "
              "nothing is run on the CPU in its place", file=sys.stderr)
        raise SystemExit(2)
    return dev


# --- the plain reference ------------------------------------------------
def plain_nmf(A, W, H, eps, itr, norm):
    """FRO-MU or KL-MU written straight from the update rules in plain
    jax.numpy: clip W and H at eps every 10 iterations, then L1-normalize
    W's columns into H, then the relative error ||A - WH||_F / ||A||_F."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(A, W, H):
        def body(i, WH):
            W, H = WH
            if norm == "fro":
                W = W * (A @ H.T) / (W @ (H @ H.T) + eps)
                H = H * (W.T @ A) / ((W.T @ W) @ H + eps)
            else:
                U = A / (W @ H + eps)
                W = W * (U @ H.T) / (jnp.sum(H, axis=1)[None, :] + eps)
                U = A / (W @ H + eps)
                H = H * (W.T @ U) / (jnp.sum(W, axis=0)[:, None] + eps)
            clip = (i % 10) == 0
            W = jnp.where(clip, jnp.maximum(W, eps), W)
            H = jnp.where(clip, jnp.maximum(H, eps), H)
            return W, H

        W, H = jax.lax.fori_loop(0, itr, body, (W, H))
        s = jnp.sum(W, axis=0, keepdims=True)
        W = W / (s + eps)
        H = H * s.T
        err = jnp.sqrt(jnp.sum((A - W @ H) ** 2)) / jnp.sqrt(jnp.sum(A * A))
        return W, H, err

    return run(A, W, H)


def w_col_l1(W1, W2):
    """Largest L1 distance between matching L1-normalized W columns."""
    return float(np.max(np.sum(np.abs(np.asarray(W1, np.float64)
                                      - np.asarray(W2, np.float64)),
                               axis=0)))


def rel_fro(x, ref):
    """||x - ref||_F / ||ref||_F in float64 on the host."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# --- helpers -------------------------------------------------------------
def uniform_problem(m, n, k, seed=0, sharding=None):
    """A, W0, H0 ~ U[0,1) made on the device from one key (as bench.py does:
    no host copy of an 8.8 GB matrix)."""
    import jax
    import jax.numpy as jnp
    kA, kW, kH = jax.random.split(jax.random.key(seed), 3)
    gen = lambda kk, shape: jax.random.uniform(kk, shape, jnp.float32)
    if sharding is None:
        A = jax.jit(gen, static_argnums=1)(kA, (m, n))
    else:
        A = jax.jit(gen, static_argnums=1, out_shardings=sharding)(kA, (m, n))
    return A, gen(kW, (m, k)), gen(kH, (k, n))


def planted_problem(m, n, k, seed, noise=0.01, disjoint=False):
    """Host-made W_true @ H_true (+ small uniform noise): a matrix whose
    rank is known."""
    rng = np.random.default_rng(seed)
    if disjoint:
        W = np.zeros((m, k), np.float32)
        block = m // k
        for j in range(k):
            stop = (j + 1) * block if j < k - 1 else m
            W[j * block:stop, j] = rng.random(stop - j * block)
    else:
        W = rng.random((m, k), np.float32)
    H = (0.1 + rng.random((k, n))).astype(np.float32)
    A = W @ H
    if noise:
        A += noise * rng.random((m, n), np.float32)
    return A.astype(np.float32)


def timed_solve(A, W, H, cfg, reps=3):
    """(result, first-call seconds incl. compile, best warm seconds)."""
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu.models import nmf as nmf_mod
    eps = jnp.asarray(cfg.eps, cfg.dtype)
    t0 = time.perf_counter()
    out = jax.block_until_ready(nmf_mod.solve(A, W, H, eps, cfg))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(nmf_mod.solve(A, W, H, eps, cfg))
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


# --- phases --------------------------------------------------------------
def dot_precision(size=(2048, 4096, 2048)):
    """What XLA's default precision does to an f32 dot on this device: the
    Frobenius error of an (m, k) @ (k, n) product of N(0,1) entries against
    float64, at the default precision and under "highest", and the dot or
    library call of the default program as its optimized HLO states it.
    Operands rounded to TF32 (10 mantissa bits) give about 3e-4, to bf16
    about 2e-3; true f32 gives about 1e-7."""
    import jax
    import jax.numpy as jnp
    m, k, n = size
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, k), np.float32)
    y = rng.standard_normal((k, n), np.float32)
    ref = x.astype(np.float64) @ y.astype(np.float64)
    errs = {}
    for prec in (None, "highest"):
        with (jax.default_matmul_precision(prec) if prec
              else contextlib.nullcontext()):
            f = jax.jit(lambda a, b: a @ b)
            errs[prec or "default"] = rel_fro(f(x, y), ref)
            if prec is None:
                hlo = f.lower(x, y).compile().as_text()
    calls = [ln.strip() for ln in hlo.splitlines()
             if "custom-call(" in ln or " dot(" in ln]
    return errs, calls


def phase_device(card):
    import jax
    dev = require_gpu()
    stats = dev.memory_stats() or {}
    log(f"platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} "
        f"bytes_limit={stats.get('bytes_limit')}")
    errs, calls = dot_precision()
    log(f"f32 dot 2048x4096 @ 4096x2048, Frobenius error against float64: "
        f"{errs}")
    for ln in calls:
        log(f"  optimized HLO: {ln[:600]}")
    log(f"card: {card}")


def phase_headline(card, shape=HEADLINE, itr=HEADLINE_ITERS):
    """Phases 2 and 3: the headline solves and the plain reference."""
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.ops.linalg import quantize_uint8

    m, n, k = shape
    A, W0, H0 = uniform_problem(m, n, k)
    base = NMFConfig(k=k, itr=itr, norm="fro", method="mu")
    eps = jnp.float32(base.eps)
    a_gb = m * n * 4 / 1e9
    log(f"[phase 2] dense {m}x{n} f32 k={k}, {itr} iterations, "
        f"A = {a_gb:.2f} GB; card: {card}")
    errs, outs = {}, {}
    for name, cfg in (("fro-mu", base),
                      ("kl-mu", base.replace(norm="kl")),
                      ("fro-hals", base.replace(method="hals")),
                      ("fro-bcd", base.replace(method="bcd"))):
        (W, H, err), first, warm = timed_solve(A, W0, H0, cfg)
        errs[name] = float(err)
        if name in ("fro-mu", "kl-mu"):
            outs[name] = W
        check(np.isfinite(errs[name]) and 0 < errs[name] < 1
              and W.shape == (m, k) and H.shape == (k, n),
              f"{name}: rel err {errs[name]!r}, shapes {W.shape} {H.shape}")
        # A-read rate: 2 reads per iteration (3 counted for KL, whose
        # ratio U is A-sized) plus the final error pass
        reads = 2 if name != "kl-mu" else 3
        log(f"  {name}: rel err {errs[name]!r}  first call {first!r} s  "
            f"warm {warm!r} s per {itr} it  (A read {reads}x/it + 1: "
            f"{(reads * itr + 1) * a_gb / warm!r} GB/s)")

    log(f"[phase 3] plain jax.numpy reference under 'highest', same "
        f"W0/H0; card: {card}")
    with jax.default_matmul_precision("highest"):
        for norm in ("fro", "kl"):
            name = f"{norm}-mu"
            Wr, _, err_r = plain_nmf(A, W0, H0, eps, itr, norm)
            err_r = float(err_r)
            rel = abs(errs[name] - err_r) / err_r
            dw = w_col_l1(outs[name], Wr)
            log(f"  {name}: production {errs[name]!r} vs plain {err_r!r} "
                f"(rel diff {rel!r}); W column L1 distance {dw!r}")
            check(rel <= REF_ERR_RTOL, f"{name} rel err within "
                  f"{REF_ERR_RTOL} of the plain reference")
            check(dw <= REF_W_L1, f"{name} W columns within L1 {REF_W_L1}")
            del Wr

    # the same FRO-MU with true-f32 dots: what XLA's default precision
    # for f32 dots costs or saves on this card
    (_, _, e_h), _, warm_h = timed_solve(
        A, W0, H0, base.replace(matmul_precision="highest"))
    log(f"  fro-mu under 'highest': rel err {float(e_h)!r}  warm {warm_h!r} "
        f"s per {itr} it")

    Ab = A.astype(jnp.bfloat16)
    (_, _, e_b), first, warm = timed_solve(
        Ab, W0, H0, base.replace(a_precision="bfloat16"))
    del Ab
    Aq, _ = quantize_uint8(A)
    del A
    (_, _, e_q), first_q, warm_q = timed_solve(
        Aq, W0, H0, base.replace(a_precision="uint8"))
    del Aq
    for name, e, f, w, gb in (("fro-mu bf16-A", e_b, first, warm, a_gb / 2),
                              ("fro-mu uint8-A", e_q, first_q, warm_q,
                               a_gb / 4)):
        e = float(e)
        log(f"  {name}: rel err {e!r} (f32: {errs['fro-mu']!r})  first "
            f"call {f!r} s  warm {w!r} s per {itr} it  (A read 2x/it + 1: "
            f"{(2 * itr + 1) * gb / w!r} GB/s)")
        check(np.isfinite(e) and abs(e - errs["fro-mu"]) <= LOWP_ERR_ATOL,
              f"{name} rel err within {LOWP_ERR_ATOL} of f32")


def phase_cpu_vs_gpu(card, shape=CROSS, itr=CROSS_ITERS):
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.models import nmf as nmf_mod

    m, n, k = shape
    log(f"[phase 4] {m}x{n} k={k}, {itr} iterations, GPU vs host CPU, "
        f"both 'highest'; card: {card}")
    A = planted_problem(m, n, k, seed=4)
    rng = np.random.default_rng(5)
    W0 = rng.random((m, k), np.float32)
    H0 = rng.random((k, n), np.float32)
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    base = NMFConfig(k=k, itr=itr, matmul_precision="highest")
    for name, cfg in (("fro-mu", base.replace(norm="fro")),
                      ("kl-mu", base.replace(norm="kl")),
                      ("fro-hals", base.replace(norm="fro", method="hals")),
                      ("fro-bcd", base.replace(norm="fro", method="bcd"))):
        errs = []
        for dev in (gpu, cpu):
            with jax.default_device(dev):
                put = lambda x: jax.device_put(x, dev)
                _, _, err = nmf_mod.solve(put(A), put(W0), put(H0),
                                          put(jnp.float32(cfg.eps)), cfg)
                errs.append(float(err))
        rel = abs(errs[0] - errs[1]) / errs[1]
        log(f"  {name}: gpu {errs[0]!r} cpu {errs[1]!r} (rel diff {rel!r})")
        check(rel <= CROSS_ERR_RTOL[name],
              f"{name} GPU and CPU agree within {CROSS_ERR_RTOL[name]}")


def sparse_problem(m, n, nnz, seed=3):
    """bench.py's sparse matrix: nnz distinct uniform positions, values in
    [0.1, 1.1)."""
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=nnz, replace=False)
    idx = np.stack([flat // n, flat % n], 1).astype(np.int32)
    vals = rng.random(nnz, np.float32) + 0.1
    return jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=(m, n),
                        unique_indices=True).sort_indices()


def phase_sparse(card, shape=SPARSE, itr=SPARSE_ITERS):
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu import NMF, NMFConfig
    from pydnmfk_tpu.ops.ell import ell_pack, grid_ell_pack
    from pydnmfk_tpu.ops.linalg import matmul_AHT, matmul_WTA
    from pydnmfk_tpu.ops.sparse import densify_for_backend, shard_sparse_grid
    from pydnmfk_tpu.parallel.mesh import grid_context

    m, n, nnz, k = shape
    log(f"[phase 5] sparse {m}x{n} nnz={nnz} k={k}, products and {itr} "
        f"iterations from one W0/H0 under 'highest'; card: {card}")
    Asp = sparse_problem(m, n, nnz)
    ctx1 = grid_context(1, 1)
    dense = np.zeros((m, n), np.float32)
    dense[np.asarray(Asp.indices[:, 0]),
          np.asarray(Asp.indices[:, 1])] = np.asarray(Asp.data)
    W0 = jax.random.uniform(jax.random.key(1), (m, k), jnp.float32)
    H0 = jax.random.uniform(jax.random.key(2), (k, n), jnp.float32)
    # "policy" hands NMF.fit the BCOO matrix, as a user does, and fit
    # resolves the format; the others are built here and passed as built
    formats = (("densified", lambda: jnp.asarray(dense)),
               ("ell", lambda: ell_pack(Asp)),
               ("grid-ell", lambda: grid_ell_pack(Asp, ctx1)),
               ("grid-triplet", lambda: shard_sparse_grid(Asp, ctx1)[0]),
               ("policy", lambda: Asp))
    cfg = NMFConfig(k=k, itr=itr, norm="fro", method="mu",
                    matmul_precision="highest")
    ref = None
    for name, make in formats:
        A = make()
        check(A is not None, f"{name} format builds")
        F = densify_for_backend(A, k_hint=k)
        mp, np_ = F.shape
        Wp = jnp.pad(W0, ((0, mp - m), (0, 0)))
        Hp = jnp.pad(H0, ((0, 0), (0, np_ - n)))
        with jax.default_matmul_precision("highest"):
            aht = np.asarray(matmul_AHT(F, Hp))[:m]
            wta = np.asarray(matmul_WTA(Wp, F))[:, :n]
        W, _, err = NMF(cfg).fit(A, factors=(Wp, Hp))
        W, err = np.asarray(W)[:m], float(err)
        if ref is None:
            ref = dict(aht=aht, wta=wta, W=W, err=err)
        d_aht, d_wta = rel_fro(aht, ref["aht"]), rel_fro(wta, ref["wta"])
        d_err = abs(err - ref["err"]) / ref["err"]
        d_w = w_col_l1(W, ref["W"])
        line = (f"  {name} ({type(F).__name__}): A Hᵀ {d_aht!r}, Wᵀ A "
                f"{d_wta!r} from densified; rel err {err!r} ({d_err!r} "
                f"from densified), W column L1 distance {d_w!r}")
        if name != "policy":
            # 10 iterations at the default precision in this format
            _, first, warm = timed_solve(F, Wp, Hp, cfg.replace(
                itr=10, matmul_precision=None))
            line += f"; 10 it: first call {first!r} s  warm {warm!r} s"
        log(line)
        check(np.isfinite(err) and max(d_aht, d_wta) <= SPARSE_PROD_RTOL,
              f"{name} products within {SPARSE_PROD_RTOL} of densified")
        check(d_err <= SPARSE_ERR_RTOL and d_w <= SPARSE_W_L1,
              f"{name} fit within {SPARSE_ERR_RTOL} (rel err) and L1 "
              f"{SPARSE_W_L1} (W columns) of densified")
        del A, F


def nmfk_large_config(grid=(1, 1), shape=NMFK_LARGE, itr=NMFK_ITERS,
                      results_path="results/"):
    from pydnmfk_tpu import NMFConfig, NMFkConfig
    true_k = shape[2]
    return NMFkConfig(
        nmf=NMFConfig(itr=itr, norm="fro", method="mu", init="rand",
                      precision="float32", a_precision="bfloat16",
                      grid=grid),
        start_k=true_k - 1, end_k=true_k + 1, step_k=1,
        perturbations=10, noise_var=0.02, sill_thr=0.6,
        results_path=results_path, fname="synth", checkpoint=False)


def phase_nmfk(card, grid=(1, 1), shape=NMFK_LARGE, itr=NMFK_ITERS):
    import jax.numpy as jnp
    from pydnmfk_tpu import NMFk
    from pydnmfk_tpu.utils.memory import device_memory_budget

    m, n, true_k = shape
    log(f"[phase 6] NMFk sweep {m}x{n} planted k={true_k}, bf16 A, k "
        f"{true_k - 1}..{true_k + 1}, 10 perturbations, {itr} iterations, "
        f"grid {grid}; memory budget {device_memory_budget()} B; "
        f"card: {card}")
    A = jnp.asarray(planted_problem(m, n, true_k, seed=100, noise=0.0,
                                    disjoint=True))
    with tempfile.TemporaryDirectory() as d:
        model = NMFk(nmfk_large_config(grid, shape, itr, d + "/"))
        t0 = time.perf_counter()
        nopt = model.fit(A)
        dt = time.perf_counter() - t0
    log(f"  estimated k = {nopt} (ensemble batch {model.last_batch_size}, "
        f"{dt!r} s incl. compiles)")
    check(nopt == true_k, f"NMFk returns the planted k={true_k}")


def phase_cli(card, shape=CLI_SHAPE):
    from pydnmfk_tpu import cli

    m, n, true_k = shape
    log(f"[phase 7] CLI on a planted {m}x{n} .npy (k={true_k}); "
        f"card: {card}")
    A = planted_problem(m, n, true_k, seed=7, noise=0.0, disjoint=True)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "planted.npy"), A)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--process=pyDNMFk", "--p_r=1", "--p_c=1",
                      "--ftype=npy", f"--fpath={d}/", "--fname=planted",
                      "--norm=fro", "--method=mu", "--itr=1000",
                      f"--start_k={true_k - 2}", f"--end_k={true_k + 2}",
                      "--perturbations=8", f"--results_path={d}/res/"])
    out = buf.getvalue()
    log("  " + out.strip().replace("\n", "\n  "))
    check(f"Rank estimated by NMFk = {true_k}" in out,
          f"CLI prints the planted rank {true_k}")


def phase_four_cards(card, shape=HEADLINE, itr=HEADLINE_ITERS,
                     nmfk_shape=NMFK_LARGE, nmfk_itr=NMFK_ITERS):
    """The sharded path: grids (2,2) and (4,1) against one card."""
    import jax
    from pydnmfk_tpu import NMF, NMFConfig
    from pydnmfk_tpu.parallel.mesh import grid_context

    devs = jax.devices()
    check(len(devs) >= 4, f"four devices visible ({len(devs)})")
    m, n, k = shape
    a_bytes = m * n * 4
    log(f"[four cards] dense {m}x{n} f32 k={k}, {itr} iterations; "
        f"card: {card}")
    for norm in ("fro", "kl"):
        cfg = NMFConfig(k=k, itr=itr, norm=norm, method="mu")
        A, W0, H0 = uniform_problem(m, n, k)
        t0 = time.perf_counter()
        _, _, e1 = NMF(cfg).fit(A, factors=(W0, H0))
        t1 = time.perf_counter() - t0
        del A
        log(f"  {norm}-mu 1 card: rel err {e1!r} ({t1!r} s incl. compile)")
        for grid in ((2, 2), (4, 1)):
            ctx = grid_context(*grid)
            A, W0, H0 = uniform_problem(m, n, k, sharding=ctx.sharding_A)
            model = NMF(cfg.replace(grid=grid), ctx)
            t0 = time.perf_counter()
            _, _, e4 = model.fit(A, factors=(W0, H0))
            t4 = time.perf_counter() - t0
            model.fit(A, factors=(W0, H0))
            t0 = time.perf_counter()
            model.fit(A, factors=(W0, H0))
            warm = time.perf_counter() - t0
            shards = model._A.addressable_shards
            in_use = [(d.memory_stats() or {}).get("bytes_in_use", -1)
                      for d in devs[:4]]
            log(f"  {norm}-mu grid {grid}: rel err {e4!r} ({t4!r} s incl. "
                f"compile, warm fit {warm!r} s); A on "
                f"{len(model._A.sharding.device_set)} cards, shard bytes "
                f"{[s.data.nbytes for s in shards]}, bytes_in_use {in_use}")
            check(abs(e4 - e1) / e1 <= MESH_ERR_RTOL,
                  f"{norm}-mu grid {grid} agrees with one card within "
                  f"{MESH_ERR_RTOL}")
            check(len(model._A.sharding.device_set) == 4
                  and all(s.data.nbytes == a_bytes // 4 for s in shards),
                  f"grid {grid}: each card holds a quarter of A")
            check(all(a_bytes // 4 <= b < a_bytes // 2 for b in in_use),
                  f"grid {grid}: every card holds at least a quarter and "
                  "less than half of A")
            del A, model
    phase_nmfk(card, grid=(2, 2), shape=nmfk_shape, itr=nmfk_itr)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}", file=sys.stderr)
        return 2
    import jax
    require_gpu()
    from pydnmfk_tpu.config import enable_compilation_cache
    enable_compilation_cache()
    card = card_line()
    log(f"card: {card}")
    if four:
        phases = [("device", phase_device), ("four cards", phase_four_cards)]
    else:
        phases = [("device", phase_device), ("headline", phase_headline),
                  ("cpu vs gpu", phase_cpu_vs_gpu), ("sparse", phase_sparse),
                  ("nmfk sweep", phase_nmfk), ("cli", phase_cli)]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(card)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"FAILED phase {name!r}")
        log(f"  ({name}: {time.perf_counter() - t0!r} s)")
    log(f"total {time.perf_counter() - t_all!r} s; card: {card}")
    if failed:
        log(f"chip_smoke FAILED: {failed}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
