"""Sparse-A support (beyond the dense-only reference): MU (fro/kl) and
HALS solvers on BCOO matrices — every product is a gather/segment_sum over
the nnz triplet (ops/sparse.py) and errors use the Gram identity, so no
dense m x n intermediate ever exists — plus the vmapped sparse NMFk
ensemble (models/nmfk.py::_ensemble_program_sparse)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import sparse

from pydnmfk_tpu.config import NMFConfig
from pydnmfk_tpu.models import nmf as nmf_mod
from pydnmfk_tpu.models.nmf import NMF
from pydnmfk_tpu.ops import linalg


def _sparse_lowrank(m, n, k, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.random((m, k)) @ rng.random((k, n))).astype(np.float32)
    mask = rng.random((m, n)) < density
    A = A * mask
    return A, sparse.BCOO.fromdense(jnp.asarray(A))


def test_sparse_error_identities():
    rng = np.random.default_rng(1)
    A, Asp = _sparse_lowrank(60, 40, 3, density=0.2)
    W = jnp.asarray(rng.random((60, 5)), jnp.float32)
    H = jnp.asarray(rng.random((5, 40)), jnp.float32)
    dense_err = float(linalg.relative_error(jnp.asarray(A), W, H))
    sp_err = float(linalg.relative_error(Asp, W, H))
    np.testing.assert_allclose(sp_err, dense_err, rtol=1e-4)
    dense_col = np.asarray(linalg.column_error(jnp.asarray(A), W, H))
    sp_col = np.asarray(linalg.column_error(Asp, W, H))
    np.testing.assert_allclose(sp_col, dense_col, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("method", ["mu", "hals"])
def test_sparse_solve_matches_dense(method):
    A, Asp = _sparse_lowrank(48, 36, 3, density=0.3, seed=2)
    rng = np.random.default_rng(3)
    W0 = jnp.asarray(rng.random((48, 3)), jnp.float32)
    H0 = jnp.asarray(rng.random((3, 36)), jnp.float32)
    eps = jnp.float32(1.19e-7)
    cfg = NMFConfig(k=3, norm="fro", method=method, itr=50)
    Wd, Hd, errd = nmf_mod.solve(jnp.asarray(A), W0, H0, eps, cfg)
    Ws, Hs, errs = nmf_mod.solve(Asp, W0, H0, eps, cfg)
    np.testing.assert_allclose(np.asarray(Ws), np.asarray(Wd), rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(errs), float(errd), rtol=1e-3)


def test_sparse_nmf_driver_and_column_err(tmp_path):
    A, Asp = _sparse_lowrank(40, 30, 3, density=0.4, seed=4)
    cfg = NMFConfig(k=3, norm="fro", method="mu", itr=150, init="rand",
                    results_path=str(tmp_path))
    model = NMF(cfg)
    W, H, err = model.fit(Asp)
    assert W.shape == (40, 3) and H.shape == (3, 30)
    # masking a rank-3 matrix breaks exact low-rankness; just require real
    # progress from a random start (which sits at ~1.0 relative error)
    assert 0 < err < 0.8
    col = model.column_err()
    assert col.shape == (30,)
    assert np.all(np.isfinite(col))


def test_sparse_rejects_unsupported():
    _, Asp = _sparse_lowrank(16, 12, 2)
    W = jnp.ones((16, 2), jnp.float32)
    H = jnp.ones((2, 12), jnp.float32)
    eps = jnp.float32(1e-7)
    with pytest.raises(ValueError, match="sparse"):
        nmf_mod.solve(Asp, W, H, eps,
                      NMFConfig(k=2, norm="fro", method="bcd", itr=5))
    with pytest.raises(ValueError, match="nnsvd"):
        NMF(NMFConfig(k=2, init="nnsvd")).fit(Asp)


# ---------------------------------------------------------------------------
# KL on the sparse triplet: U = A/(WH+eps) is zero wherever A is, so the
# gather/segment path is EXACT vs the dense formula (up to summation order)
# ---------------------------------------------------------------------------
def test_sparse_kl_products_match_dense():
    from pydnmfk_tpu.ops.sparse import kl_uht_sparse, kl_wtu_sparse
    from pydnmfk_tpu.ops.kl import kl_uht, kl_wtu
    rng = np.random.default_rng(5)
    A, Asp = _sparse_lowrank(40, 28, 3, density=0.25, seed=5)
    W = jnp.asarray(rng.random((40, 4)), jnp.float32)
    H = jnp.asarray(rng.random((4, 28)), jnp.float32)
    eps = jnp.float32(1.19e-7)
    np.testing.assert_allclose(
        np.asarray(kl_uht_sparse(Asp, W, H, eps)),
        np.asarray(kl_uht(jnp.asarray(A), W, H, eps)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(kl_wtu_sparse(Asp, W, H, eps)),
        np.asarray(kl_wtu(jnp.asarray(A), W, H, eps)), rtol=1e-5, atol=1e-5)
    # nnz-chunked path is bit-compatible in structure, close numerically
    np.testing.assert_allclose(
        np.asarray(kl_uht_sparse(Asp, W, H, eps, chunk=100)),
        np.asarray(kl_uht_sparse(Asp, W, H, eps)), rtol=1e-6)


def test_sparse_kl_solve_matches_dense():
    A, Asp = _sparse_lowrank(48, 36, 3, density=0.3, seed=2)
    rng = np.random.default_rng(3)
    W0 = jnp.asarray(rng.random((48, 3)), jnp.float32)
    H0 = jnp.asarray(rng.random((3, 36)), jnp.float32)
    eps = jnp.float32(1.19e-7)
    cfg = NMFConfig(k=3, norm="kl", method="mu", itr=50)
    Wd, Hd, errd = nmf_mod.solve(jnp.asarray(A), W0, H0, eps, cfg)
    Ws, Hs, errs = nmf_mod.solve(Asp, W0, H0, eps, cfg)
    np.testing.assert_allclose(np.asarray(Ws), np.asarray(Wd), rtol=5e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(errs), float(errd), rtol=1e-3)
    # frozen-W regression path (the NMFk refit)
    Wr, Hr, er = nmf_mod.solve(Asp, Ws, Hs, eps, cfg.replace(itr=10),
                               W_update=False)
    np.testing.assert_allclose(np.asarray(Wr), np.asarray(
        (Ws / (jnp.sum(Ws, 0) + eps))), rtol=1e-5, atol=1e-6)
    assert float(er) <= float(errs) * 1.05


def test_sparse_sampler_perturbs_nnz_only():
    from pydnmfk_tpu.models import sampler
    _, Asp = _sparse_lowrank(30, 20, 2, density=0.3, seed=6)
    key = jax.random.key(0)
    P = sampler.sample_one(Asp, key, 0.03)
    assert linalg.is_sparse(P)
    np.testing.assert_array_equal(np.asarray(P.indices),
                                  np.asarray(Asp.indices))
    ratio = np.asarray(P.data) / np.asarray(Asp.data)
    assert np.all(ratio >= 1.03 - 1e-6) and np.all(ratio < 1.09 + 1e-6)
    with pytest.raises(ValueError, match="dense-only"):
        sampler.sample_member(Asp, key, 0.03, tile_grid=(2, 2))


@pytest.mark.parametrize("norm", ["fro", "kl"])
def test_sparse_nmfk_selects_true_k(tmp_path, norm):
    """Full sparse NMFk: vmapped triplet ensemble -> clustering ->
    frozen-W regression -> Wilcoxon walk selects the planted k."""
    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models.nmfk import NMFk
    rng = np.random.default_rng(7)
    m, n, ktrue = 80, 60, 3
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    H = rng.random((ktrue, n)) + 0.1
    A = (W @ H).astype(np.float32) * (rng.random((m, n)) < 0.5)
    Asp = sparse.BCOO.fromdense(jnp.asarray(A))
    cfg = NMFkConfig(nmf=NMFConfig(k=0, norm=norm, method="mu", itr=300,
                                   init="rand", seed=42),
                     start_k=2, end_k=5, perturbations=6, noise_var=0.03,
                     sill_thr=0.6, results_path=str(tmp_path), fname="sp",
                     checkpoint=False)
    assert NMFk(cfg).fit(Asp) == ktrue


def _planted_sparse(m=80, n=60, ktrue=3, seed=7):
    rng = np.random.default_rng(seed)
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    H = rng.random((ktrue, n)) + 0.1
    A = (W @ H).astype(np.float32) * (rng.random((m, n)) < 0.5)
    return sparse.BCOO.fromdense(jnp.asarray(A))


@pytest.mark.parametrize("grid,p_e", [((2, 2), 1), ((4, 1), 1), ((1, 1), 4),
                                      ((2, 2), 2)])
def test_sparse_nmfk_multidevice_matches_single(tmp_path, grid, p_e):
    """Multi-device sparse NMFk (VERDICT r2 item 3): the ensemble over
    grid-sharded triplets (or members sharded over 'e') selects the same k
    as the single-device run with near-identical statistics — noise and
    init streams are drawn in flat-COO/unpadded order, so members match up
    to mesh-padding eps effects.  The ((2,2), p_e=2) case is the THREE-WAY
    ('e','r','c') composition (VERDICT r3 item 2): members sharded over 'e'
    via vmap(spmd_axis_name) AND each member's blocks grid-sharded."""
    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models.nmfk import NMFk
    from pydnmfk_tpu.parallel.mesh import grid_context

    Asp = _planted_sparse(m=78, n=60)       # uneven over (2,2)/(4,1) rows
    mk = lambda sub: NMFkConfig(
        nmf=NMFConfig(k=0, norm="fro", method="mu", itr=250, init="rand",
                      seed=42),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03, sill_thr=0.6,
        results_path=str(tmp_path / sub) + "/", fname="sp",
        checkpoint=False)

    single = NMFk(mk("single"), grid_context(1, 1))
    nopt1 = single.fit(Asp)
    multi = NMFk(mk("multi"), grid_context(*grid, p_e))
    noptG = multi.fit(Asp)
    assert noptG == nopt1 == 3
    for k in (2, 3, 4):
        s1, sg = single.per_k_stats[k], multi.per_k_stats[k]
        np.testing.assert_allclose(sg["avgErr"], s1["avgErr"], rtol=1e-3)
        np.testing.assert_allclose(
            sg["clusterSilhouetteCoefficients"],
            s1["clusterSilhouetteCoefficients"], atol=5e-3)
        np.testing.assert_allclose(sg["L_err"], s1["L_err"],
                                   rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("grid,p_e", [((2, 2), 1), ((2, 1), 2)])
def test_sparse_nmfk_grid_ell_matches_triplet(tmp_path, grid, p_e):
    """Grid-sharded capped-ELL ensembles (VERDICT r4 item 3): with
    sparse_grid_format='ell' the per-block dual-ELL gather path under
    shard_map — including the ('e','r','c') three-way composition —
    selects the same k with near-identical stats as the triplet grid
    (identical member noise/init streams via the slot->nnz perms)."""
    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models.nmfk import NMFk
    from pydnmfk_tpu.parallel.mesh import grid_context

    Asp = _planted_sparse(m=78, n=60)       # uneven over the mesh rows
    mk = lambda sub, fmt: NMFkConfig(
        nmf=NMFConfig(k=0, norm="fro", method="mu", itr=250, init="rand",
                      seed=42, sparse_grid_format=fmt),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03, sill_thr=0.6,
        results_path=str(tmp_path / sub) + "/", fname="sp",
        checkpoint=False)

    ctx = grid_context(*grid, p_e)
    tri = NMFk(mk("tri", "triplet"), ctx)
    nopt_t = tri.fit(Asp)
    gell = NMFk(mk("gell", "ell"), ctx)
    nopt_e = gell.fit(Asp)
    assert gell._grid_ell is not None       # the ELL path actually ran
    assert nopt_e == nopt_t == 3
    for k in (2, 3, 4):
        st, se = tri.per_k_stats[k], gell.per_k_stats[k]
        np.testing.assert_allclose(se["avgErr"], st["avgErr"], rtol=1e-3)
        np.testing.assert_allclose(
            se["clusterSilhouetteCoefficients"],
            st["clusterSilhouetteCoefficients"], atol=5e-3)
        np.testing.assert_allclose(se["L_err"], st["L_err"],
                                   rtol=2e-2, atol=2e-3)


def test_sparse_nmfk_ell_mode_matches_bcoo(tmp_path, monkeypatch):
    """NMFk with the ELL member format (the very-sparse/beyond-HBM
    regime) selects the same k with near-identical stats as the BCOO
    triplet path — members perturb the same flat data vector, so noise
    streams are identical and only summation order differs."""
    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models import nmfk as nmfk_mod
    from pydnmfk_tpu.models.nmfk import NMFk
    from pydnmfk_tpu.ops.ell import ell_pack

    Asp = _planted_sparse(m=80, n=60)
    mk = lambda sub: NMFkConfig(
        nmf=NMFConfig(k=0, norm="fro", method="mu", itr=250, init="rand",
                      seed=42),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03, sill_thr=0.6,
        results_path=str(tmp_path / sub) + "/", fname="sp",
        checkpoint=False)

    bcoo = NMFk(mk("bcoo"))
    nopt_b = bcoo.fit(Asp)

    # force the ELL decision (on CPU the policy keeps BCOO)
    monkeypatch.setattr(
        nmfk_mod, "_ensemble_program_sparse",
        lambda *a, **kw: pytest.fail("BCOO program used in ELL mode"))
    from pydnmfk_tpu.ops.ell import EllSparse
    import pydnmfk_tpu.ops.sparse as sp_mod
    monkeypatch.setattr(
        sp_mod, "densify_for_backend",
        lambda A, **kw: A if isinstance(A, EllSparse) else ell_pack(A))
    ell = NMFk(mk("ell"))
    nopt_e = ell.fit(Asp)
    assert ell._ell is not None
    assert nopt_e == nopt_b == 3
    for k in (2, 3, 4):
        sb, se = bcoo.per_k_stats[k], ell.per_k_stats[k]
        np.testing.assert_allclose(se["avgErr"], sb["avgErr"], rtol=1e-3)
        np.testing.assert_allclose(
            se["clusterSilhouetteCoefficients"],
            sb["clusterSilhouetteCoefficients"], atol=5e-3)


def test_sparse_nmfk_rejects_unsupported(tmp_path):
    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models.nmfk import NMFk
    _, Asp = _sparse_lowrank(16, 12, 2)
    base = dict(start_k=2, end_k=3, perturbations=2,
                results_path=str(tmp_path), fname="x", checkpoint=False)
    with pytest.raises(ValueError, match="prune"):
        NMFk(NMFkConfig(nmf=NMFConfig(k=0, prune=True), **base)).fit(Asp)
    with pytest.raises(ValueError, match="nnsvd|rand"):
        NMFk(NMFkConfig(nmf=NMFConfig(k=0, init="nnsvd"), **base)).fit(Asp)
    with pytest.raises(ValueError, match="dense-only"):
        NMFk(NMFkConfig(nmf=NMFConfig(k=0), seed_grid=(2, 2),
                        **base)).fit(Asp)


def test_sparse_npz_cli_and_runner(tmp_path):
    """ftype='npz' (scipy.sparse save_npz) drives the sparse solvers from
    the CLI / Runner surface."""
    import subprocess
    import sys
    from scipy import sparse as sp
    from pydnmfk_tpu.runner import Runner

    A, _ = _sparse_lowrank(40, 30, 3, density=0.4, seed=9)
    sp.save_npz(tmp_path / "spdata.npz", sp.csr_matrix(A))

    r = Runner(itr=150, norm="kl", method="mu", init="rand",
               process="pyDNMF")
    out = r.run(grid=[1, 1], fpath=str(tmp_path) + "/", ftype="npz",
                fname="spdata", results_path=str(tmp_path / "res"), k=3)
    assert out["W"].shape == (40, 3) and 0 < out["err"] < 0.9

    code = subprocess.run(
        [sys.executable, "-m", "pydnmfk_tpu", "--process=pyDNMF",
         "--p_r=1", "--p_c=1", "--k=3", f"--fpath={tmp_path}/",
         "--ftype=npz", "--fname=spdata", "--norm=fro", "--method=mu",
         "--init=rand", "--itr=100", "--cpu",
         f"--results_path={tmp_path}/res2"],
        capture_output=True, text=True)
    assert code.returncode == 0, code.stderr
    assert "relative error" in code.stdout

    # multi-device npz: NMF shard-partitions the triplet itself
    out2 = r.run(grid=[2, 1], fpath=str(tmp_path) + "/", ftype="npz",
                 fname="spdata", results_path=str(tmp_path / "res3"), k=3)
    np.testing.assert_allclose(float(out2["err"]), float(out["err"]),
                               rtol=1e-3)


class _FakeCard:
    """A stand-in first device with a measured sparse cost-table row."""
    device_kind = "NVIDIA H100 80GB HBM3"

    def memory_stats(self):
        return None


def _pretend_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeCard()])
    monkeypatch.setenv("PYDNMFK_HBM_BUDGET", str(16 << 30))


def test_densify_for_backend(monkeypatch):
    """Measurement-driven GPU format policy (tools/sparse_probe.py): dense
    above the gather crossover, bf16 ladder when f32 misses the budget,
    ELL beyond that, raise only when ELL can't pack."""
    from pydnmfk_tpu.ops import sparse as sp_ops
    from pydnmfk_tpu.ops.ell import EllSparse
    A, Asp = _sparse_lowrank(20, 12, 2, density=0.4, seed=11)
    # CPU backend: passthrough, stays sparse
    assert linalg.is_sparse(sp_ops.densify_for_backend(Asp))
    # pretend-GPU: moderate density -> dense round-trip (dense wins)
    _pretend_gpu(monkeypatch)
    out = sp_ops.densify_for_backend(Asp)
    assert not linalg.is_sparse(out)
    np.testing.assert_allclose(np.asarray(out), A, rtol=1e-6)
    # f32 misses the budget but bf16 fits -> bf16 dense (with a warning)
    monkeypatch.setenv("PYDNMFK_HBM_BUDGET", str(20 * 12 * 4 * 2 - 1))
    with pytest.warns(UserWarning, match="bfloat16"):
        out = sp_ops.densify_for_backend(Asp)
    assert out.dtype == jnp.bfloat16
    # nothing dense fits -> ELL keeps it sparse (used to raise)
    monkeypatch.setenv("PYDNMFK_HBM_BUDGET", "100")
    with pytest.warns(UserWarning, match="ELL"):
        out = sp_ops.densify_for_backend(Asp)
    assert isinstance(out, EllSparse)
    # ELL disallowed (the NMFk ensemble) -> the old CPU-pointing error
    with pytest.raises(ValueError, match="CPU backend"):
        sp_ops.densify_for_backend(Asp, allow_ell=False)


def test_densify_prefers_ell_in_win_regime(monkeypatch):
    """Very sparse input with LARGE m*n stays ELL on the GPU even when dense
    would fit — streaming the dense A costs more than the gathers there
    (measured cost model, ops/ell.py::ell_time_model); small matrices
    densify regardless of density (per-call floors dominate)."""
    from pydnmfk_tpu.ops import sparse as sp_ops
    from pydnmfk_tpu.ops.ell import EllSparse
    rng = np.random.default_rng(0)
    _pretend_gpu(monkeypatch)

    def coo(m, n, nnz):
        flat = rng.choice(m * n, nnz, replace=False)
        idx = np.stack([flat // n, flat % n], 1).astype(np.int32)
        bc = sparse.BCOO((jnp.asarray(rng.random(nnz, np.float32)),
                          jnp.asarray(idx)), shape=(m, n),
                         unique_indices=True)
        return bc.sort_indices()

    # 2.5e9 elements (dense f32 = 10 GB streams slowly), 100k nnz -> ELL
    out = sp_ops.densify_for_backend(coo(50_000, 50_000, 100_000),
                                     k_hint=32)
    assert isinstance(out, EllSparse)
    # small matrix, same density: dense (per-call floor dominates)
    out = sp_ops.densify_for_backend(coo(2000, 2000, 200), k_hint=32)
    assert not linalg.is_sparse(out)


def test_ell_products_match_dense():
    from pydnmfk_tpu.ops.ell import ell_pack, ell_a_ht, ell_wt_a, \
        ell_kl_uht, ell_kl_wtu, ell_col_sqsum
    rng = np.random.default_rng(5)
    A, Asp = _sparse_lowrank(50, 30, 3, density=0.15, seed=5)
    E = ell_pack(Asp)
    assert E is not None and E.nse == Asp.nse
    W = jnp.asarray(rng.random((50, 4)), jnp.float32)
    H = jnp.asarray(rng.random((4, 30)), jnp.float32)
    Aj = jnp.asarray(A)
    np.testing.assert_allclose(np.asarray(ell_a_ht(E, H)),
                               np.asarray(Aj @ H.T), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ell_wt_a(E, W)),
                               np.asarray(W.T @ Aj), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ell_col_sqsum(E)),
                               np.sum(A * A, axis=0), rtol=1e-5)
    eps = 1e-7
    U = np.where(A > 0, A / (np.asarray(W @ H) + eps), 0.0)
    np.testing.assert_allclose(np.asarray(ell_kl_uht(E, W, H, eps)),
                               U @ np.asarray(H.T), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ell_kl_wtu(E, W, H, eps)),
                               np.asarray(W.T) @ U, rtol=1e-4)
    # error identities route through the ELL dispatchers
    np.testing.assert_allclose(
        float(linalg.relative_error(E, W, H)),
        float(linalg.relative_error(Aj, W, H)), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(linalg.column_error(E, W, H)),
        np.asarray(linalg.column_error(Aj, W, H)), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("norm", ["fro", "kl"])
def test_ell_solve_matches_dense(norm):
    """Full MU solve on an EllSparse A tracks the dense solve."""
    from pydnmfk_tpu.ops.ell import ell_pack
    A, Asp = _sparse_lowrank(48, 36, 3, density=0.2, seed=9)
    E = ell_pack(Asp)
    cfg = NMFConfig(k=3, norm=norm, method="mu", itr=300, seed=100)
    W1, H1, e1 = NMF(cfg).fit(jnp.asarray(A))
    W2, H2, e2 = NMF(cfg).fit(E)
    np.testing.assert_allclose(e2, e1, atol=2e-3)


def test_sparse_a_precision_bf16():
    """a_precision applies to sparse nnz storage too (previously silently
    ignored): the solve runs with bf16 data and lands near the f32 result."""
    A, Asp = _sparse_lowrank(48, 36, 3, density=0.3, seed=2)
    cfg = NMFConfig(k=3, norm="fro", method="mu", itr=300, seed=100)
    _, _, e32 = NMF(cfg).fit(Asp)
    nmf = NMF(cfg.replace(a_precision="bfloat16"))
    _, _, e16 = nmf.fit(Asp)
    assert jnp.dtype(nmf._A.dtype) == jnp.bfloat16
    assert abs(e16 - e32) < 5e-3, (e16, e32)


def test_ell_capped_width_tail_products_match_dense():
    """Forcing a tiny width cap routes overflow entries through the COO
    tails; every product must still equal the dense result exactly over
    main+tail."""
    from pydnmfk_tpu.ops.ell import (ell_a_ht, ell_col_sqsum, ell_kl_uht,
                                     ell_kl_wtu, ell_pack, ell_wt_a)
    rng = np.random.default_rng(8)
    A, Asp = _sparse_lowrank(40, 30, 3, density=0.3, seed=8)
    E = ell_pack(Asp, w_cap=3, max_tail_frac=1.0)   # force heavy tails
    assert E is not None
    assert E.rtail_d.shape[0] > 0 and E.ctail_d.shape[0] > 0
    assert E.rvals.shape[1] == 3
    # every entry appears exactly once across main + tail
    assert (int(jnp.sum(E.rvals != 0)) + E.rtail_d.shape[0]
            >= Asp.nse)                  # (zeros in data could undercount)
    W = jnp.asarray(rng.random((40, 4)), jnp.float32)
    H = jnp.asarray(rng.random((4, 30)), jnp.float32)
    Aj = jnp.asarray(A)
    np.testing.assert_allclose(np.asarray(ell_a_ht(E, H)),
                               np.asarray(Aj @ H.T), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ell_wt_a(E, W)),
                               np.asarray(W.T @ Aj), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ell_col_sqsum(E)),
                               np.sum(A * A, axis=0), rtol=1e-5)
    eps = 1e-7
    U = np.where(A > 0, A / (np.asarray(W @ H) + eps), 0.0)
    np.testing.assert_allclose(np.asarray(ell_kl_uht(E, W, H, eps)),
                               U @ np.asarray(H.T), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ell_kl_wtu(E, W, H, eps)),
                               np.asarray(W.T) @ U, rtol=1e-4)
    # sqnorm through the .data view covers tails too
    np.testing.assert_allclose(float(linalg.sqnorm(E)),
                               float(np.sum(A * A)), rtol=1e-5)


def test_ell_ensemble_with_forced_tails(tmp_path, monkeypatch):
    """The ELL-mode NMFk with capped widths + tails still matches the
    BCOO-path statistics (noise gathers cover main AND tail slots)."""
    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models import nmfk as nmfk_mod
    from pydnmfk_tpu.models.nmfk import NMFk
    from pydnmfk_tpu.ops.ell import EllSparse, ell_pack
    import pydnmfk_tpu.ops.sparse as sp_mod

    Asp = _planted_sparse(m=60, n=45)
    mk = lambda sub: NMFkConfig(
        nmf=NMFConfig(k=0, norm="fro", method="mu", itr=200, init="rand",
                      seed=42),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03, sill_thr=0.6,
        results_path=str(tmp_path / sub) + "/", fname="sp",
        checkpoint=False)
    bcoo = NMFk(mk("bcoo"))
    nopt_b = bcoo.fit(Asp)

    monkeypatch.setattr(
        sp_mod, "densify_for_backend",
        lambda A, **kw: A if isinstance(A, EllSparse) else ell_pack(A))
    import pydnmfk_tpu.ops.ell as ell_mod
    orig_pack = ell_mod.ell_pack
    monkeypatch.setattr(
        ell_mod, "ell_pack",
        lambda A, **kw: orig_pack(A, w_cap=2, max_tail_frac=1.0, **kw))
    ell = NMFk(mk("ell"))
    nopt_e = ell.fit(Asp)
    E = ell._ell[0]
    assert E.rtail_d.shape[0] > 0        # tails actually exercised
    assert nopt_e == nopt_b == 3
    for k in (2, 3, 4):
        np.testing.assert_allclose(
            ell.per_k_stats[k]["avgErr"], bcoo.per_k_stats[k]["avgErr"],
            rtol=1e-3)


def test_ell_pack_rejects_skew():
    from pydnmfk_tpu.ops.ell import ell_pack
    # one dense row in an otherwise near-empty matrix: per-row widths are
    # (300, 1, ..., 1) -> blowup guard trips
    m, n = 200, 300
    dense = np.zeros((m, n), np.float32)
    dense[0, :] = 1.0
    dense[np.arange(1, m), np.arange(1, m) % n] = 1.0
    Asp = sparse.BCOO.fromdense(jnp.asarray(dense))
    assert ell_pack(Asp) is None


# ---------------------------------------------------------------------------
# Row-sharded sparse (1D row mesh): per-block shard_map products with the
# dense 1D topology's psum contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid,norm,method", [
    ((4, 1), "fro", "mu"), ((4, 1), "kl", "mu"), ((2, 1), "fro", "hals")])
def test_sharded_sparse_matches_single_device(tmp_path, grid, norm, method):
    A, Asp = _sparse_lowrank(46, 36, 3, density=0.3, seed=12)  # uneven m
    cfg = NMFConfig(k=3, norm=norm, method=method, itr=60, init="rand",
                    seed=7, results_path=str(tmp_path / "a"))
    m1 = NMF(cfg)
    W1, H1, e1 = m1.fit(Asp)
    cfg2 = cfg.replace(grid=grid, results_path=str(tmp_path / "b"))
    m2 = NMF(cfg2)
    W2, H2, e2 = m2.fit(Asp)
    np.testing.assert_allclose(np.asarray(W2), np.asarray(W1), rtol=2e-3,
                               atol=1e-5)
    np.testing.assert_allclose(float(e2), float(e1), rtol=1e-3)
    np.testing.assert_allclose(m2.column_err(), m1.column_err(),
                               rtol=2e-3, atol=1e-5)


def test_sharded_sparse_products_match():
    from pydnmfk_tpu.ops.sparse import (rs_a_ht, rs_kl_uht, rs_kl_wtu,
                                        rs_wt_a, shard_sparse_grid)
    from pydnmfk_tpu.ops.sparse import a_ht_bcoo, wt_a_bcoo
    from pydnmfk_tpu.ops.sparse import kl_uht_sparse, kl_wtu_sparse
    from pydnmfk_tpu.parallel.mesh import grid_context
    ctx = grid_context(4, 1)
    A, Asp = _sparse_lowrank(48, 20, 3, density=0.3, seed=13)
    Ars, (m_pad, n_pad) = shard_sparse_grid(Asp, ctx)
    assert (m_pad, n_pad) == (48, 20)
    rng = np.random.default_rng(14)
    W = jnp.asarray(rng.random((48, 4)), jnp.float32)
    H = jnp.asarray(rng.random((4, 20)), jnp.float32)
    eps = jnp.float32(1e-7)
    np.testing.assert_allclose(np.asarray(rs_a_ht(Ars, H)),
                               np.asarray(a_ht_bcoo(Asp, H)), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rs_wt_a(Ars, W)),
                               np.asarray(wt_a_bcoo(Asp, W)), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rs_kl_uht(Ars, W, H, eps)),
                               np.asarray(kl_uht_sparse(Asp, W, H, eps)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rs_kl_wtu(Ars, W, H, eps)),
                               np.asarray(kl_wtu_sparse(Asp, W, H, eps)),
                               rtol=1e-5, atol=1e-6)


def test_sharded_sparse_2d_grid_matches_single_device(tmp_path):
    """The 2D SUMMA-style topology on sparse triplets: uneven m AND n,
    (2, 2) and (4, 2) grids."""
    A, Asp = _sparse_lowrank(46, 35, 3, density=0.3, seed=15)
    cfg = NMFConfig(k=3, norm="kl", method="mu", itr=60, init="rand",
                    seed=9, results_path=str(tmp_path / "a"))
    m1 = NMF(cfg)
    W1, H1, e1 = m1.fit(Asp)
    for grid in ((2, 2), (4, 2)):
        m2 = NMF(cfg.replace(grid=grid,
                             results_path=str(tmp_path / f"g{grid[0]}")))
        W2, H2, e2 = m2.fit(Asp)
        np.testing.assert_allclose(np.asarray(W2), np.asarray(W1),
                                   rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(float(e2), float(e1), rtol=1e-3)
        np.testing.assert_allclose(m2.column_err(), m1.column_err(),
                                   rtol=2e-3, atol=1e-5)


def test_sparse_tol_and_checkpointed_solve(tmp_path):
    """Sparse A composes with tol early-stop and mid-solve checkpointing."""
    A, Asp = _sparse_lowrank(40, 30, 3, density=0.4, seed=16)
    cfg = NMFConfig(k=3, norm="fro", method="mu", itr=400, init="rand",
                    tol=1e-6, tol_check_every=50,
                    results_path=str(tmp_path / "t"))
    W, H, err = NMF(cfg).fit(Asp)
    assert np.isfinite(err) and 0 < err < 0.9
    cfg2 = NMFConfig(k=3, norm="kl", method="mu", itr=90, init="rand",
                     solve_checkpoint_every=30,
                     results_path=str(tmp_path / "c"))
    W2, H2, e2 = NMF(cfg2).fit(Asp)
    W3, H3, e3 = NMF(cfg2.replace(solve_checkpoint_every=0,
                                  results_path=str(tmp_path / "d"))).fit(Asp)
    np.testing.assert_allclose(np.asarray(W2), np.asarray(W3), rtol=1e-6)
    assert float(e2) == float(e3)
