"""Perturbation sampler semantics (reference sample, pyDNMFk.py:8-67)."""
import numpy as np

import jax

from pydnmfk_tpu.models.sampler import sample_ensemble


def test_uniform_noise_range():
    A = np.ones((50, 40), np.float32)
    out = sample_ensemble(A, jax.random.key(0), 0.03, 8, "uniform")
    out = np.asarray(out)
    assert out.shape == (8, 50, 40)
    # reference randM: X * (2*nv*U + nv + 1) in [1+nv, 1+3nv)
    assert out.min() >= 1.03 - 1e-6
    assert out.max() <= 1.09 + 1e-6
    # members differ
    assert not np.allclose(out[0], out[1])


def test_uniform_deterministic():
    A = np.ones((10, 10), np.float32) * 2
    a = np.asarray(sample_ensemble(A, jax.random.key(5), 0.1, 3, "uniform"))
    b = np.asarray(sample_ensemble(A, jax.random.key(5), 0.1, 3, "uniform"))
    np.testing.assert_array_equal(a, b)


def test_poisson_mean():
    A = np.full((100, 100), 7.0, np.float32)
    out = np.asarray(sample_ensemble(A, jax.random.key(1), 0.0, 4, "poisson"))
    assert abs(out.mean() - 7.0) < 0.05
    assert np.all(out == np.round(out))


def test_zero_preserved():
    A = np.zeros((10, 10), np.float32)
    for method in ("uniform", "poisson"):
        out = np.asarray(sample_ensemble(A, jax.random.key(2), 0.05, 2, method))
        assert np.all(out == 0)


def test_seed_grid_tiled_noise():
    """Reference-MPI seeding compat: on a (p_r,p_c) seed grid the noise
    field is (p_r,p_c)-tiled, as every reference rank draws the same block
    (pyDNMFk.py:32,42 with identical per-rank seeds)."""
    import jax
    import jax.numpy as jnp
    from pydnmfk_tpu.models.sampler import sample_member
    A = jnp.ones((8, 6), jnp.float32)
    key = jax.random.key(7)
    X = np.asarray(sample_member(A, key, 0.1, "uniform", tile_grid=(2, 2)))
    np.testing.assert_array_equal(X[:4, :3], X[4:, :3])
    np.testing.assert_array_equal(X[:4, :3], X[:4, 3:])
    np.testing.assert_array_equal(X[:4, :3], X[4:, 3:])
    # independent draw is NOT tiled
    Y = np.asarray(sample_member(A, key, 0.1, "uniform"))
    assert not np.array_equal(Y[:4, :3], Y[4:, :3])
    # noise bounds: [1+nv, 1+3nv)
    assert X.min() >= 1.1 and X.max() < 1.3


def test_seed_grid_poisson_blocks():
    """Poisson seed-grid compat (VERDICT r4 item 5): the reference seeds
    every rank identically and draws Poisson(local block)
    (pyDNMFk.py:32,47-50), so blocks with identical data get identical
    draws while each block stays marginally Poisson(block).  Reproduced by
    drawing every grid block with the same key."""
    import jax.numpy as jnp
    from pydnmfk_tpu.models.sampler import sample_member
    # identical-data blocks -> identical noise (the reference's
    # identical-seed property)
    A = jnp.tile(jnp.asarray(
        np.random.default_rng(3).random((20, 15)) * 9, jnp.float32), (2, 2))
    key = jax.random.key(11)
    X = np.asarray(sample_member(A, key, 0.0, "poisson", tile_grid=(2, 2)))
    np.testing.assert_array_equal(X[:20, :15], X[20:, :15])
    np.testing.assert_array_equal(X[:20, :15], X[:20, 15:])
    np.testing.assert_array_equal(X[:20, :15], X[20:, 15:])
    assert np.all(X == np.round(X))
    # independent draw is NOT block-tiled
    Y = np.asarray(sample_member(A, key, 0.0, "poisson"))
    assert not np.array_equal(Y[:20, :15], Y[20:, :15])
    # blocks with DIFFERENT data differ (it is not a copy of one block)
    B = jnp.asarray(np.random.default_rng(4).random((40, 30)) * 9 + 1,
                    jnp.float32)
    Z = np.asarray(sample_member(B, key, 0.0, "poisson", tile_grid=(2, 2)))
    assert not np.array_equal(Z[:20, :15], Z[20:, :15])
    # marginal statistics: mean of each block tracks its lambda field
    assert abs(Z.mean() - float(B.mean())) < 0.15


def test_seed_grid_poisson_config_accepted():
    """NMFkConfig no longer rejects poisson + seed_grid (VERDICT r4 #5)."""
    from pydnmfk_tpu.config import NMFkConfig
    cfg = NMFkConfig(sampling="poisson", seed_grid=(2, 2))
    assert cfg.seed_grid == (2, 2)


def test_seed_grid_tiled_init():
    """With seed_grid, rand-init W0/H0 are p-fold tiled (reference
    pyDNMF.py:112-113 under identical per-rank streams)."""
    import jax.numpy as jnp
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.models.nmfk import _ensemble_program
    from pydnmfk_tpu.parallel.mesh import grid_context
    import jax
    ncfg = NMFConfig(k=3, itr=0, norm="fro", method="mu", init="rand")
    prog = _ensemble_program(ncfg, 2, "uniform", 0.02, grid_context(),
                             False, 0, (2, 2))
    A = jnp.asarray(np.random.default_rng(0).random((16, 8)), jnp.float32)
    W, H, errs = prog(A, jax.random.key(0), 0)
    W = np.asarray(W[0])
    H = np.asarray(H[0])
    # itr=0 -> returned W is just the (normalized) init: tiling survives
    for i in range(1, 4):
        np.testing.assert_allclose(W[:4], W[4 * i:4 * (i + 1)], rtol=1e-6)
        np.testing.assert_allclose(H[:, :2], H[:, 2 * i:2 * (i + 1)],
                                   rtol=1e-6)
