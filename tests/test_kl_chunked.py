"""Memory-bounded KL products and error passes: the chunked paths equal
the direct ones, on one device and on a mesh, and the solver's chunk
policy picks them for large blocks."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.mark.parametrize("a_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("chunk", [8, 32, 21])
def test_kl_chunked_equals_direct(chunk, a_dtype):
    """kl_uht / kl_wtu over row chunks (8 and 32 divide m=96; 21 leaves a
    ragged tail) equal the direct products that materialize U, for f32 and
    bf16-stored A (bf16 A: both paths round A identically, only the f32
    summation order differs)."""
    from pydnmfk_tpu.ops.kl import kl_uht, kl_wtu
    rng = np.random.default_rng(chunk)
    A = jnp.asarray(rng.random((96, 40)), a_dtype)
    W = jnp.asarray(rng.random((96, 5)), jnp.float32)
    H = jnp.asarray(rng.random((5, 40)), jnp.float32)
    eps = 1e-7
    for fn in (kl_uht, kl_wtu):
        direct = np.asarray(fn(A, W, H, eps))
        chunked = np.asarray(fn(A, W, H, eps, chunk))
        assert chunked.dtype == direct.dtype
        np.testing.assert_allclose(chunked, direct, rtol=1e-5)


@pytest.mark.parametrize("chunk", [32])
def test_kl_sharded_wrappers(chunk):
    """Mesh-sharded memory-bounded KL products (the chunked scan per block
    under shard_map) match the dense global computation on a 2x2 mesh — the
    multi-device contract of the reference's UHT_glob/WTU_glob
    (dist_nmf.py:293-343)."""
    from pydnmfk_tpu.ops.kl import kl_uht_sharded, kl_wtu_sharded
    from pydnmfk_tpu.parallel.mesh import GridContext, make_grid_mesh
    ctx = GridContext(make_grid_mesh(2, 2))
    rng = np.random.default_rng(0)
    A = jax.device_put(rng.random((256, 256)).astype(np.float32),
                       ctx.sharding_A)
    W = jax.device_put(rng.random((256, 5)).astype(np.float32),
                       ctx.sharding_W)
    H = jax.device_put(rng.random((5, 256)).astype(np.float32),
                       ctx.sharding_H)
    eps = 1e-7
    U = np.asarray(A) / (np.asarray(W) @ np.asarray(H) + eps)
    uht = kl_uht_sharded(A, W, H, eps, ctx.mesh, chunk)
    wtu = kl_wtu_sharded(A, W, H, eps, ctx.mesh, chunk)
    np.testing.assert_allclose(np.asarray(uht), U @ np.asarray(H).T,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(wtu), np.asarray(W).T @ U,
                               rtol=1e-4, atol=1e-3)
    assert uht.sharding.spec == ctx.spec_W
    assert wtu.sharding.spec == ctx.spec_H


def test_kl_solve_chunked_on_mesh_matches_single_device():
    """Full KL/MU solve with kl_chunk on a 2x2 mesh == unsharded solve:
    the sharded bounded-memory path changes memory behavior, not numerics."""
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.models import nmf as nmf_mod
    from pydnmfk_tpu.parallel.mesh import GridContext, make_grid_mesh
    rng = np.random.default_rng(3)
    m, n, k = 64, 48, 4
    A0 = (rng.random((m, k)) @ rng.random((k, n))).astype(np.float32)
    W0 = rng.random((m, k)).astype(np.float32)
    H0 = rng.random((k, n)).astype(np.float32)
    eps = jnp.float32(1.19e-7)

    cfg1 = NMFConfig(k=k, norm="kl", method="mu", itr=40)
    Wd, Hd, errd = nmf_mod.solve(jnp.asarray(A0), jnp.asarray(W0),
                                 jnp.asarray(H0), eps, cfg1)

    ctx = GridContext(make_grid_mesh(2, 2))
    cfgm = cfg1.replace(grid=(2, 2), kl_chunk=16)
    Ws, Hs, errs = nmf_mod.solve(ctx.put_A(jnp.asarray(A0)),
                                 ctx.put_W(jnp.asarray(W0)),
                                 ctx.put_H(jnp.asarray(H0)), eps, cfgm)
    np.testing.assert_allclose(np.asarray(Ws), np.asarray(Wd),
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hd),
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(float(errs), float(errd), rtol=1e-4)


@pytest.mark.parametrize("fn_name", ["relative_error", "column_error"])
def test_chunked_error_matches_direct(fn_name):
    """Memory-bounded error passes == direct computation (summation-order
    tolerance only)."""
    from pydnmfk_tpu.ops import linalg
    fn = getattr(linalg, fn_name)
    rng = np.random.default_rng(11)
    A = jnp.asarray(rng.random((70, 40)), jnp.float32)  # ragged vs chunk
    W = jnp.asarray(rng.random((70, 5)), jnp.float32)
    H = jnp.asarray(rng.random((5, 40)), jnp.float32)
    direct = np.asarray(fn(A, W, H))
    chunked = np.asarray(fn(A, W, H, 16))
    np.testing.assert_allclose(chunked, direct, rtol=1e-5)


def test_error_chunk_rows_policy():
    from pydnmfk_tpu.ops import linalg
    assert linalg.error_chunk_rows(100, 100) == 0          # small: direct
    assert linalg.error_chunk_rows(57600, 38400) > 0       # flagship: chunk
    assert linalg.error_chunk_rows(57600, 38400, sharded=True) == 0
    c = linalg.error_chunk_rows(57600, 38400)
    assert c * 38400 <= (1 << 27)


def test_fused_auto_dispatch_policy(monkeypatch):
    """The dense chunk policy of solve() (models/nmf.py::dense_chunks) on
    an accelerator backend: KL auto-chunks a large single-shard block and
    runs small ones direct; the error pass chunks large blocks for every
    norm; an explicit kl_chunk is kept."""
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.models import nmf as nmf_mod

    captured = {}
    real = nmf_mod._jitted_solver

    def spy(norm, method, itr, W_update, chunk, batched, *args, **kw):
        captured.update(norm=norm, chunk=chunk,
                        err_chunk=(args[3] if len(args) > 3
                                   else kw.get("err_chunk", 0)))
        return real(norm, method, itr, W_update, chunk, batched, *args,
                    **kw)

    monkeypatch.setattr(nmf_mod, "_jitted_solver", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")

    A32 = jnp.ones((64, 48), jnp.float32)
    A16 = jnp.ones((64, 48), jnp.bfloat16)
    W = jnp.ones((64, 3), jnp.float32)
    H = jnp.ones((3, 48), jnp.float32)
    eps = jnp.float32(1e-7)

    for A in (A16, A32):
        nmf_mod.solve(A, W, H, eps, NMFConfig(k=3, norm="fro", itr=1))
        assert captured["chunk"] == 0 and captured["err_chunk"] == 0

    nmf_mod.solve(A32, W, H, eps, NMFConfig(k=3, norm="kl", itr=1))
    assert captured["chunk"] == 0                 # small block: direct
    nmf_mod.solve(A32, W, H, eps, NMFConfig(k=3, norm="kl", itr=1,
                                            kl_chunk=16))
    assert captured["chunk"] == 16                # explicit: kept

    A_big = jnp.ones((8192, 38400), jnp.float32)
    Wb = jnp.ones((8192, 3), jnp.float32)
    Hb = jnp.ones((3, 38400), jnp.float32)
    nmf_mod.solve(A_big, Wb, Hb, eps, NMFConfig(k=3, norm="kl", itr=1))
    assert captured["chunk"] > 0                  # large block: auto-chunk
    assert captured["err_chunk"] > 0
    nmf_mod.solve(A_big, Wb, Hb, eps, NMFConfig(k=3, norm="fro", itr=1))
    assert captured["chunk"] == 0 and captured["err_chunk"] > 0
