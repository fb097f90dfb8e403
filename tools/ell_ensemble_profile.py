"""Where does the ELL ensemble's time actually go on the card?  Stages:
(1) vmapped ELL FRO product pair (stacked-gather rule),
(2) the member 'orient' gathers (flat data -> both ELL orientations),
(3) the per-member relative-error sddmm,
at bench geometry 40000^2 / nnz 3.2e5 / k=32 / b=8.

Run: python tools/ell_ensemble_profile.py
"""
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    sys.path.insert(0, "/root/repo")
    from pydnmfk_tpu.ops.ell import EllSparse, ell_pack, ell_a_ht, ell_wt_a
    from pydnmfk_tpu.ops import linalg

    print("backend:", jax.default_backend(), flush=True)
    rng = np.random.default_rng(3)
    m = n = 40_000
    nnz, k, b = 320_000, 32, 8
    flat = rng.choice(m * n, size=nnz, replace=False)
    idx = np.stack([flat // n, flat % n], 1).astype(np.int32)
    vals = rng.random(nnz, np.float32) + 0.1
    A = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=(m, n),
                     unique_indices=True).sort_indices()
    packed = ell_pack(A, return_perms=True)
    E, rperm, cperm, rt_perm, ct_perm = packed

    def slope(fn, x):
        def run(reps):
            y = x
            t0 = time.perf_counter()
            for _ in range(reps):
                y = fn(y)
            jax.block_until_ready(y)
            return time.perf_counter() - t0
        fn(x)
        t3 = min(run(3) for _ in range(3))
        t10 = min(run(10) for _ in range(3))
        return (t10 - t3) / 7

    W_b = jnp.asarray(rng.random((b, m, k), np.float32))
    H_b = jnp.asarray(rng.random((b, k, n), np.float32))
    rv_b = jnp.stack([E.rvals] * b)
    cv_b = jnp.stack([E.cvals] * b)

    def member_products(args):
        W, H, rv, cv = args
        def one(w_, h_, rv_, cv_):
            Am = EllSparse(rv_, E.rcols, E.rtail_d, E.rtail_r, E.rtail_c,
                           cv_, E.crows, E.ctail_d, E.ctail_r, E.ctail_c,
                           (m, n), nnz)
            aht = ell_a_ht(Am, h_)
            wta = ell_wt_a(Am, w_)
            return aht, wta
        aht, wta = jax.vmap(one)(W, H, rv, cv)
        # chain
        return (W + aht * 1e-3, H + wta * 1e-3, rv, cv)

    t = slope(jax.jit(member_products), (W_b, H_b, rv_b, cv_b))
    print(f"product pair (b={b}): {t*1e3:.2f} ms  "
          f"-> per member per product {t/b/2*1e3:.3f} ms", flush=True)

    # single member baseline
    def single_products(args):
        W, H = args
        aht = ell_a_ht(E, H)
        wta = ell_wt_a(E, W)
        return (W + aht * 1e-3, H + wta * 1e-3)

    t1 = slope(jax.jit(single_products), (W_b[0], H_b[0]))
    print(f"single product pair: {t1*1e3:.2f} ms", flush=True)

    # orient gathers (per-batch cost in the ensemble program)
    d_b = jnp.stack([A.data * (1 + 0.01 * i) for i in range(b)])

    def orient_all(d_ens):
        def orient(flat, perm):
            return jnp.where(perm < nnz, flat[jnp.minimum(perm, nnz - 1)],
                             jnp.zeros((), flat.dtype))
        rv = jax.vmap(lambda f: orient(f, rperm))(d_ens)
        cv = jax.vmap(lambda f: orient(f, cperm))(d_ens)
        return d_ens + rv.sum(axis=(1, 2), keepdims=True) * 0 \
            + cv.sum() * 0

    t2 = slope(jax.jit(orient_all), d_b)
    print(f"orient gathers (b={b}): {t2*1e3:.2f} ms/batch", flush=True)

    # relative error (sddmm path) per member
    def errs(args):
        W, H = args
        def one(w_, h_):
            return linalg.relative_error(E, w_, h_)
        e = jax.vmap(one)(W, H)
        return (W + e[:, None, None] * 1e-6, H)

    t3_ = slope(jax.jit(errs), (W_b, H_b))
    print(f"relative_error (b={b}): {t3_*1e3:.2f} ms/batch", flush=True)


if __name__ == "__main__":
    main()
