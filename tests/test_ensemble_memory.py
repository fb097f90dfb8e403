"""HBM-aware ensemble batching, batch-size invariance, true mid-ensemble
resume, and prune-through-the-pipeline (VERDICT r1 items 2, 6, 7)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pydnmfk_tpu.config import NMFConfig, NMFkConfig
from pydnmfk_tpu.models import nmfk as nmfk_mod
from pydnmfk_tpu.models.nmfk import NMFk
from pydnmfk_tpu.utils.memory import (auto_ensemble_batch,
                                      ensemble_member_bytes)


def _base_cfg(tmp_path, **kw):
    nmf = kw.pop("nmf", NMFConfig(itr=60, norm="fro", method="mu",
                                  init="rand", precision="float32"))
    defaults = dict(nmf=nmf, start_k=2, end_k=3, step_k=1, perturbations=6,
                    noise_var=0.02, sill_thr=0.6,
                    results_path=str(tmp_path), fname="A")
    defaults.update(kw)
    return NMFkConfig(**defaults)


def _lowrank(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((m, k)) @ rng.random((k, n))).astype(np.float32)


# ---------------------------------------------------------------------------
# auto batch sizing
# ---------------------------------------------------------------------------
def test_auto_batch_bounds_and_monotonicity():
    ncfg = NMFConfig(k=8, norm="fro", precision="float32")
    # huge budget -> whole ensemble; tiny budget -> 1; monotone in budget
    big = auto_ensemble_batch(1024, 512, 8, 20, ncfg, (1, 1),
                              budget=64 << 30)
    tiny = auto_ensemble_batch(1024, 512, 8, 20, ncfg, (1, 1),
                               budget=8 << 20)
    assert big == 20
    assert tiny == 1
    prev = 0
    for budget in (16 << 20, 64 << 20, 256 << 20, 1 << 30):
        b = auto_ensemble_batch(1024, 512, 8, 20, ncfg, (1, 1), budget=budget)
        assert b >= prev
        prev = b


def test_auto_batch_flagship_scale_fits_hbm():
    """At the reference's headline 57600x38400 size the chosen batch's
    working set must fit a 16 GB budget in every configuration that CAN
    fit (materializing all 20 copies would take 11x that).  At f32 on one
    device even one member exceeds it (A + one perturbed copy = 17.6 GB) —
    there the sizer returns the serial floor of 1 and the remedy is bf16-A
    storage or mesh sharding, both asserted below."""
    m, n, k = 57600, 38400, 32
    budget = 16 << 30

    def fits(a_prec, norm, grid):
        ncfg = NMFConfig(k=k, norm=norm, precision="float32",
                         a_precision=a_prec,
                         kl_chunk=2048 if norm == "kl" else 0)
        b = auto_ensemble_batch(m, n, k, 20, ncfg, grid, budget=budget)
        a_bytes = 2 if a_prec == "bfloat16" else 4
        fixed = m * n * a_bytes / (grid[0] * grid[1])
        per = ensemble_member_bytes(m, n, k, ncfg, grid)
        return b, fixed + b * per <= budget

    # bf16-A storage: fits a single chip, for both objectives
    for norm in ("fro", "kl"):
        b, ok = fits("bfloat16", norm, (1, 1))
        assert b >= 1 and ok, (norm, b)
    # f32 on a 2x2 mesh: per-device blocks shrink 4x -> fits
    b, ok = fits(None, "fro", (2, 2))
    assert b >= 1 and ok, b
    # f32 single chip: physically cannot fit -> serial floor, honestly
    b, ok = fits(None, "fro", (1, 1))
    assert b == 1 and not ok


def test_auto_batch_respects_ensemble_axis():
    ncfg = NMFConfig(k=4, precision="float32")
    b = auto_ensemble_batch(256, 128, 4, 20, ncfg, (1, 1), p_e=4,
                            budget=1 << 30)
    assert b % 4 == 0 and b >= 4


def test_nmfk_records_chosen_batch(tmp_path):
    """hbm_budget drives the auto batch inside the pipeline."""
    A = _lowrank(64, 48, 3)
    # budget sized so ~2-4 members fit: member cost ~ 64*48*4*2.5 + factors
    cfg = _base_cfg(tmp_path, start_k=3, end_k=3, perturbations=6,
                    hbm_budget=300_000, checkpoint=False)
    model = NMFk(cfg)
    nopt = model.fit(A)
    assert 1 <= model.last_batch_size < 6
    assert nopt >= cfg.start_k


# ---------------------------------------------------------------------------
# batch-size invariance (global member keys)
# ---------------------------------------------------------------------------
def test_ensemble_batch_size_invariance(tmp_path):
    A = _lowrank(48, 32, 3, seed=1)
    stats = {}
    for tag, batch in [("all", 0), ("split", 2)]:
        cfg = _base_cfg(tmp_path / tag, start_k=3, end_k=3, perturbations=5,
                        ensemble_batch=batch or 5, checkpoint=False)
        model = NMFk(cfg)
        model.fit(A)
        stats[tag] = model.per_k_stats[3]
    np.testing.assert_allclose(stats["all"]["recon_err"],
                               stats["split"]["recon_err"], rtol=1e-6)
    np.testing.assert_allclose(
        stats["all"]["clusterSilhouetteCoefficients"],
        stats["split"]["clusterSilhouetteCoefficients"], rtol=1e-5,
        atol=1e-6)


# ---------------------------------------------------------------------------
# true mid-ensemble resume
# ---------------------------------------------------------------------------
def test_mid_ensemble_resume(tmp_path, monkeypatch):
    A = _lowrank(40, 24, 3, seed=2)
    k = 3

    def run(path, fail_after=None, counter=None):
        cfg = _base_cfg(path, start_k=k, end_k=k, perturbations=6,
                        ensemble_batch=2, checkpoint=True)
        model = NMFk(cfg)
        real_program = nmfk_mod._ensemble_program

        def counting(*a, **kw):
            fn = real_program(*a, **kw)

            def wrapped(*args):
                counter.append(1)
                if fail_after is not None and len(counter) > fail_after:
                    raise RuntimeError("simulated crash")
                return fn(*args)
            return wrapped

        monkeypatch.setattr(nmfk_mod, "_ensemble_program", counting)
        try:
            return model._solve_ensemble(jnp.asarray(A), k), model
        finally:
            monkeypatch.setattr(nmfk_mod, "_ensemble_program", real_program)

    # uninterrupted golden
    calls = []
    (golden_W, golden_H, golden_errs), _ = run(tmp_path / "clean", None,
                                               calls)
    assert len(calls) == 3          # 6 perturbations / batch 2

    # crash after the first batch...
    calls = []
    with pytest.raises(RuntimeError):
        run(tmp_path / "crashy", 1, calls)
    parts = os.listdir(tmp_path / "crashy" / "A" / str(k) / "ensemble_parts")
    assert len(parts) == 1          # batch 0 persisted before the crash

    # ...resume recomputes only the remaining two batches
    calls = []
    (W, H, errs), _ = run(tmp_path / "crashy", None, calls)
    assert len(calls) == 2
    np.testing.assert_allclose(np.asarray(W), np.asarray(golden_W),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(errs), np.asarray(golden_errs),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# prune inside the NMFk ensemble (reference pyDNMF.py:99-101 semantics)
# ---------------------------------------------------------------------------
def test_prune_through_nmfk_pipeline(tmp_path):
    rng = np.random.default_rng(5)
    A = (rng.random((40, 3)) @ rng.random((3, 30))).astype(np.float32)
    A[[4, 17], :] = 0.0              # zero rows
    A[:, [2, 25]] = 0.0              # zero columns
    nmf = NMFConfig(itr=80, norm="fro", method="mu", init="rand",
                    precision="float32", prune=True)
    cfg = _base_cfg(tmp_path, nmf=nmf, start_k=3, end_k=3, perturbations=4,
                    checkpoint=False)
    model = NMFk(cfg)
    model.fit(A)
    stats = model.per_k_stats[3]
    # column errors live in the ORIGINAL coordinates, zero at pruned columns
    assert stats["L_err"].shape == (30,)
    assert stats["L_err"][2] == 0.0 and stats["L_err"][25] == 0.0
    assert np.all(stats["L_err"][[0, 1, 3]] > 0)
    # saved regression factors are full-size with zeros re-inserted
    W = np.load(os.path.join(str(tmp_path), "A", "3", "W_reg_factors",
                             "W.npy"))
    H = np.load(os.path.join(str(tmp_path), "A", "3", "H_reg_factors",
                             "H.npy"))
    assert W.shape == (40, 3) and H.shape == (3, 30)
    assert np.all(W[[4, 17], :] == 0)
    assert np.all(H[:, [2, 25]] == 0)


def test_resume_ignores_stale_config_parts(tmp_path):
    """Parts written under a different noise/solver config are not replayed
    (the resume validates a full config stamp, not just (k, seed))."""
    import jax
    k = 3
    A = _lowrank(40, 24, 3, seed=2)
    cfg1 = _base_cfg(tmp_path, start_k=k, end_k=k, perturbations=4,
                     ensemble_batch=2, checkpoint=True, noise_var=0.02)
    m1 = NMFk(cfg1)
    # write parts for batch 0 only by running a partial solve by hand
    from pydnmfk_tpu.models import nmfk as nm
    ncfg1 = cfg1.nmf.replace(k=k)
    nm._save_ensemble_part(
        str(tmp_path / "A" / str(k) / "ensemble_parts"), 0,
        np.zeros((2, 40, 3), np.float32), np.zeros((2, 3, 24), np.float32),
        np.zeros(2, np.float32), ncfg1.seed,
        nm._ensemble_cfg_tag(ncfg1, cfg1))
    m1.checkpoint.save(0, 2, k, ncfg1.seed)   # FLAG_RUNNING, done=2

    # same seed, different noise_var -> stale parts must be recomputed
    cfg2 = cfg1.replace(noise_var=0.05)
    m2 = NMFk(cfg2)
    W, H, errs = m2._solve_ensemble(jnp.asarray(A), k)
    assert W.shape[0] == 4
    # the zero-filled stale part must NOT appear in the results
    assert float(jnp.sum(jnp.abs(W[:2]))) > 0
