"""Batched k-sweep (VERDICT r4 item 1): every k of an NMFk sweep runs
through ONE compiled K-padded ensemble program, with the true k expressed
as an active-column mask (models/nmf._solve ``col_mask``).

Correctness contract: a K-padded masked solve's active columns follow the
SAME trajectory as the unpadded k-column solve — zero columns contribute
exact-zero terms to every product the active updates consume, and the mask
re-zeros them after each step's eps clip."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pydnmfk_tpu import NMFConfig, NMFkConfig
from pydnmfk_tpu.models import nmf as nmf_mod
from pydnmfk_tpu.models import nmfk as nmfk_mod
from pydnmfk_tpu.models.nmfk import NMFk


def make_data(m=60, n=40, ktrue=3, seed=0):
    rng = np.random.default_rng(seed)
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    H = rng.random((ktrue, n)) + 0.1
    return (W @ H).astype(np.float32)


@pytest.mark.parametrize("norm,method", [
    ("fro", "mu"), ("kl", "mu"), ("fro", "hals"), ("fro", "bcd")])
def test_masked_padded_solve_matches_unpadded(norm, method):
    """_solve with a K-padded mask == the unpadded k-column solve, for
    every update rule."""
    A = jnp.asarray(make_data(), jnp.float32)
    m, n = A.shape
    k, K = 3, 7
    rng = np.random.default_rng(1)
    W0 = jnp.asarray(rng.random((m, k)), jnp.float32)
    H0 = jnp.asarray(rng.random((k, n)), jnp.float32)
    eps = jnp.float32(np.finfo(np.float32).eps)
    kw = dict(norm=norm, method=method, itr=40, W_update=True, chunk=0)
    W1, H1, e1 = jax.jit(
        lambda *a: nmf_mod._solve(*a, **kw))(A, W0, H0, eps)
    W0p = jnp.pad(W0, ((0, 0), (0, K - k)))
    H0p = jnp.pad(H0, ((0, K - k), (0, 0)))
    mask = jnp.arange(K) < k
    W2, H2, e2 = jax.jit(
        lambda *a: nmf_mod._solve(*a, **kw))(A, W0p, H0p, eps, mask)
    # padded columns stay exactly zero
    np.testing.assert_array_equal(np.asarray(W2[:, k:]), 0.0)
    np.testing.assert_array_equal(np.asarray(H2[k:, :]), 0.0)
    # K-wide contractions group the same real partial sums differently
    # (zeros add exactly, but reduction trees change) — last-ulp effects
    # amplified over 40 iterations bound the tolerance
    np.testing.assert_allclose(np.asarray(W2[:, :k]), np.asarray(W1),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(H2[:k, :]), np.asarray(H1),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(e2), float(e1), rtol=1e-5)


def test_polyk_sweep_matches_per_k(tmp_path):
    """Full NMFk sweep: the batched-K path selects the same k and records
    per-k stats equal to the per-k-program path."""
    A = make_data()
    base = NMFkConfig(
        nmf=NMFConfig(k=0, grid=(1, 1), norm="fro", method="mu", itr=200,
                      init="rand", seed=7),
        start_k=2, end_k=5, perturbations=4, noise_var=0.03, sill_thr=0.6,
        checkpoint=False, fname="A")
    cfg_poly = base.replace(results_path=str(tmp_path / "poly") + "/")
    cfg_perk = base.replace(results_path=str(tmp_path / "perk") + "/",
                            k_sweep_batch=False)
    m_poly = NMFk(cfg_poly)
    nopt_poly = m_poly.fit(A)
    m_perk = NMFk(cfg_perk)
    nopt_perk = m_perk.fit(A)
    assert nopt_poly == nopt_perk == 3
    for k in range(2, 6):
        sp, sq = m_poly.per_k_stats[k], m_perk.per_k_stats[k]
        np.testing.assert_allclose(sp["recon_err"], sq["recon_err"],
                                   rtol=1e-4)
        np.testing.assert_allclose(
            sp["clusterSilhouetteCoefficients"],
            sq["clusterSilhouetteCoefficients"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(sp["L_err"], sq["L_err"],
                                   rtol=1e-3, atol=1e-5)


def test_padded_clustering_matches_unpadded():
    """K-padded clustering with an active mask == unpadded clustering of
    the active columns (models/clustering.py: padded zero-clusters are
    provably inert for nonneg factors; the greedy bias preserves the
    active assignment order)."""
    import jax.numpy as jnp
    from pydnmfk_tpu.models.clustering import cluster_ensemble
    rng = np.random.default_rng(5)
    p, m, n, k, K = 6, 40, 25, 4, 9
    W_all = jnp.asarray(rng.random((p, m, k)), jnp.float32)
    H_all = jnp.asarray(rng.random((p, k, n)), jnp.float32)
    eps = np.float32(1.19e-7)
    cu, su, Hu, csu, au, _ = cluster_ensemble(W_all, H_all, eps)
    Wp = jnp.pad(W_all, ((0, 0), (0, 0), (0, K - k)))
    Hp = jnp.pad(H_all, ((0, 0), (0, K - k), (0, 0)))
    cp, sp, Hpc, csp, ap, _ = cluster_ensemble(
        Wp, Hp, eps, active=jnp.arange(K) < k)
    np.testing.assert_allclose(np.asarray(cp[:, :k]), np.asarray(cu),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(Hpc[:, :k, :]), np.asarray(Hu),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(csp[:k]), np.asarray(csu),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ap), float(au), rtol=1e-5)


def test_polyk_single_solver_trace(tmp_path):
    """The sweep compiles the solver program ONCE (re-tracing it per k
    made compile time the dominant sweep cost)."""
    nmfk_mod._ensemble_program_polyk.cache_clear()
    nmfk_mod._ensemble_init_program.cache_clear()
    A = make_data()
    cfg = NMFkConfig(
        nmf=NMFConfig(k=0, grid=(1, 1), norm="fro", method="mu", itr=60,
                      init="rand", seed=7),
        start_k=2, end_k=6, perturbations=4, noise_var=0.03,
        checkpoint=False, fname="A",
        results_path=str(tmp_path) + "/")
    NMFk(cfg).fit(A)
    assert nmfk_mod._ensemble_program_polyk.cache_info().misses == 1
    # one small init trace per k (5 ks)
    assert nmfk_mod._ensemble_init_program.cache_info().misses == 5


def test_merged_sweep_matches_unmerged(tmp_path):
    """Merged multi-k batches (members of several ks in one dispatch)
    produce the same selection and per-k stats as one-k-per-batch: member
    noise is keyed by the per-k perturbation index, so results are
    invariant to batch packing."""
    A = make_data()
    base = NMFkConfig(
        nmf=NMFConfig(k=0, grid=(1, 1), norm="fro", method="mu", itr=200,
                      init="rand", seed=7),
        start_k=2, end_k=5, perturbations=4, noise_var=0.03, sill_thr=0.6,
        checkpoint=False, fname="A", ensemble_batch=16)  # 4 ks x 4 perts
    m_m = NMFk(base.replace(results_path=str(tmp_path / "m") + "/"))
    n_m = m_m.fit(A)
    m_u = NMFk(base.replace(results_path=str(tmp_path / "u") + "/",
                            k_sweep_merge=False))
    n_u = m_u.fit(A)
    assert n_m == n_u == 3
    for k in range(2, 6):
        np.testing.assert_allclose(
            m_m.per_k_stats[k]["recon_err"],
            m_u.per_k_stats[k]["recon_err"], rtol=1e-5)
        np.testing.assert_allclose(
            m_m.per_k_stats[k]["L_err"],
            m_u.per_k_stats[k]["L_err"], rtol=1e-4, atol=1e-6)


def test_merged_sweep_crash_resume(tmp_path, monkeypatch):
    """A crash mid-sweep under the merged driver resumes from the per-k
    ensemble parts without re-running any ensemble program."""
    import os
    from pydnmfk_tpu.models import nmfk as nmfk_mod
    A = make_data()
    cfg = NMFkConfig(
        nmf=NMFConfig(k=0, grid=(1, 1), norm="fro", method="mu", itr=120,
                      init="rand", seed=7),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03, sill_thr=0.6,
        checkpoint=True, fname="A", results_path=str(tmp_path) + "/")
    calls = {"n": 0}
    orig = nmfk_mod.cluster_ensemble

    def crashing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:               # k=3's clustering
            raise RuntimeError("simulated preemption")
        return orig(*a, **kw)

    monkeypatch.setattr(nmfk_mod, "cluster_ensemble", crashing)
    with pytest.raises(RuntimeError):
        NMFk(cfg).fit(A)
    monkeypatch.setattr(nmfk_mod, "cluster_ensemble", orig)
    # parts for k=3 AND k=4 exist (merged batches ran ahead)
    for k in (3, 4):
        pdir = os.path.join(str(tmp_path), "A", str(k), "ensemble_parts")
        assert os.listdir(pdir), k

    def boom(*a, **kw):
        raise AssertionError("ensemble recomputed on resume")
    monkeypatch.setattr(nmfk_mod, "_ensemble_program_polyk", boom)
    monkeypatch.setattr(nmfk_mod, "_ensemble_program", boom)
    nopt = NMFk(cfg).fit(A)
    assert nopt == 3


def test_sparse_polyk_sweep_matches_per_k(tmp_path):
    """Sparse sweeps share one K-padded program per format too: BCOO and
    grid-ELL k-selection + stats match the per-k-program path."""
    from jax.experimental import sparse as jsparse
    rng = np.random.default_rng(7)
    m, n, ktrue = 78, 60, 3
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    Hm = rng.random((ktrue, n)) + 0.1
    Ad = ((W @ Hm) * (rng.random((m, n)) < 0.5)).astype(np.float32)
    Asp = jsparse.BCOO.fromdense(jnp.asarray(Ad))
    from pydnmfk_tpu.parallel.mesh import grid_context

    for sub, grid, fmt in (("bcoo", (1, 1), None),
                           ("gell", (2, 1), "ell")):
        ctx = grid_context(*grid)
        mk = lambda name, batch: NMFkConfig(
            nmf=NMFConfig(k=0, grid=grid, norm="fro", method="mu",
                          itr=250, init="rand", seed=42,
                          sparse_grid_format=fmt),
            start_k=2, end_k=4, perturbations=4, noise_var=0.03,
            sill_thr=0.6, results_path=str(tmp_path / name) + "/",
            fname="sp", checkpoint=False, k_sweep_batch=batch)
        poly = NMFk(mk(sub + "_p", True), ctx)
        n_p = poly.fit(Asp)
        perk = NMFk(mk(sub + "_q", False), ctx)
        n_q = perk.fit(Asp)
        assert n_p == n_q == ktrue, (sub, n_p, n_q)
        for k in (2, 3, 4):
            np.testing.assert_allclose(
                poly.per_k_stats[k]["recon_err"],
                perk.per_k_stats[k]["recon_err"], rtol=1e-4)
            np.testing.assert_allclose(
                poly.per_k_stats[k]["L_err"],
                perk.per_k_stats[k]["L_err"], rtol=1e-3, atol=1e-5)


def test_polyk_nnsvd_init(tmp_path):
    """nnsvd-init sweeps run the polyk path too (the wtsi golden
    configuration): per-k nnsvd init draws feed the shared solver."""
    A = make_data()
    base = NMFkConfig(
        nmf=NMFConfig(k=0, grid=(1, 1), norm="fro", method="mu", itr=200,
                      init="nnsvd", seed=7),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03,
        checkpoint=False, fname="A")
    m_poly = NMFk(base.replace(
        results_path=str(tmp_path / "p") + "/"))
    n_poly = m_poly.fit(A)
    m_perk = NMFk(base.replace(
        results_path=str(tmp_path / "q") + "/",
        k_sweep_batch=False))
    n_perk = m_perk.fit(A)
    # nnsvd members all start in the same SVD basin, so the walk settles
    # early on this synthetic — the contract here is paths AGREE
    assert n_poly == n_perk
    for k in range(2, 5):
        np.testing.assert_allclose(m_poly.per_k_stats[k]["recon_err"],
                                   m_perk.per_k_stats[k]["recon_err"],
                                   rtol=1e-4)
