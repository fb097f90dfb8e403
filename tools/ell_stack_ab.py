"""A/B the stacked-member gather rule inside the real ELL product at
b = 8 and 16: _take_rows (custom_vmap stacked) vs plain jnp.take (XLA's
default batched gather).  Quantifies both the modest b=8 effect and the
b=16 cliff the rule removes.

Run: python tools/ell_stack_ab.py
"""
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    sys.path.insert(0, "/root/repo")
    from pydnmfk_tpu.ops import ell as ell_mod
    from pydnmfk_tpu.ops.ell import EllSparse, ell_pack, ell_a_ht, ell_wt_a

    print("backend:", jax.default_backend(), flush=True)
    rng = np.random.default_rng(3)
    m = n = 40_000
    nnz, k = 320_000, 32
    flat = rng.choice(m * n, size=nnz, replace=False)
    idx = np.stack([flat // n, flat % n], 1).astype(np.int32)
    vals = rng.random(nnz, np.float32) + 0.1
    A = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=(m, n),
                     unique_indices=True).sort_indices()
    E = ell_pack(A)

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

    def pair(args):
        W, H, rv, cv = args

        def one(w_, h_, rv_, cv_):
            Am = EllSparse(rv_, E.rcols, E.rtail_d, E.rtail_r, E.rtail_c,
                           cv_, E.crows, E.ctail_d, E.ctail_r, E.ctail_c,
                           (m, n), nnz)
            return ell_a_ht(Am, h_), ell_wt_a(Am, w_)

        aht, wta = jax.vmap(one)(W, H, rv, cv)
        return (W + aht * 1e-3, H + wta * 1e-3, rv, cv)

    plain_take = lambda table, fi: jnp.take(table, fi, axis=0)
    for b in (8, 16):
        W_b = jnp.asarray(rng.random((b, m, k), np.float32))
        H_b = jnp.asarray(rng.random((b, k, n), np.float32))
        rv_b = jnp.stack([E.rvals] * b)
        cv_b = jnp.stack([E.cvals] * b)
        x0 = (W_b, H_b, rv_b, cv_b)

        t_rule = slope(jax.jit(pair), x0)
        saved = ell_mod._take_rows
        ell_mod._take_rows = plain_take
        try:
            t_plain = slope(jax.jit(pair), x0)
        finally:
            ell_mod._take_rows = saved
        print(f"b={b}: stacked={t_rule*1e3:.2f}ms "
              f"plain={t_plain*1e3:.2f}ms "
              f"speedup={t_plain/t_rule:.2f}x "
              f"per-member-pair stacked={t_rule/b*1e3:.2f}ms",
              flush=True)


if __name__ == "__main__":
    main()
