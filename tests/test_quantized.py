"""uint8-quantized A storage (a_precision='uint8'): the solve factorizes
Q = round(A/s) with the scale folded into the returned H; swim-style
uint8 data (max 255) quantizes exactly.  Quarters the bytes of A each
product reads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pydnmfk_tpu.config import NMFConfig
from pydnmfk_tpu.models import nmf as nmf_mod
from pydnmfk_tpu.models.nmf import NMF
from pydnmfk_tpu.ops import linalg


def test_quantize_uint8_roundtrip():
    rng = np.random.default_rng(0)
    A = rng.integers(0, 256, size=(30, 20)).astype(np.float32)
    A.flat[0] = 255.0                       # pin the max -> s = 1 exactly
    q, s = linalg.quantize_uint8(jnp.asarray(A))
    assert q.dtype == jnp.uint8
    assert float(s) == 1.0
    np.testing.assert_array_equal(np.asarray(q, np.float32), A)
    # general floats: bounded quantization error
    B = rng.random((30, 20)).astype(np.float32) * 7.3
    q2, s2 = linalg.quantize_uint8(jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(q2, np.float32) * float(s2), B,
                               atol=float(s2) / 2 + 1e-6)


def test_integer_matmul_rule():
    rng = np.random.default_rng(1)
    A = jnp.asarray(rng.integers(0, 256, size=(16, 12)), jnp.uint8)
    H = jnp.asarray(rng.random((5, 12)), jnp.float32)
    out = linalg.matmul_AHT(A, H)
    assert out.dtype == jnp.float32
    ref = np.asarray(A, np.float32) @ np.asarray(H, np.float32).T
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-2, atol=0.5)


def test_uint8_solve_matches_f32_on_uint8_data(tmp_path):
    """swim-style data (uint8 values, max 255): the quantized solve equals
    the f32 solve exactly in input, so errors track closely."""
    rng = np.random.default_rng(2)
    Wt = rng.random((60, 3))
    Ht = rng.random((3, 40))
    A = np.round(255 * (Wt @ Ht) / (Wt @ Ht).max()).astype(np.float32)
    cfg = NMFConfig(k=3, norm="fro", method="mu", itr=200, init="rand",
                    results_path=str(tmp_path))
    model32 = NMF(cfg)
    W32, H32, e32 = model32.fit(A)
    model8 = NMF(cfg.replace(a_precision="uint8"))
    W8, H8, e8 = model8.fit(A)
    # same trajectory up to the bf16 matmul rounding of the integer rule
    np.testing.assert_allclose(e8, e32, rtol=2e-2)
    # returned H carries the scale: reconstruction approximates A itself
    recon = np.asarray(W8) @ np.asarray(H8)
    rel = np.linalg.norm(recon - A) / np.linalg.norm(A)
    np.testing.assert_allclose(rel, e8, rtol=2e-2)
    col = model8.column_err()
    assert col.shape == (40,) and np.all(np.isfinite(col))


def test_uint8_auto_dispatch_and_nmfk_guard(tmp_path, monkeypatch):
    """On an accelerator backend uint8-stored A runs the XLA solve (integer
    matmul rule, no chunking at this size) and matches the same solve on
    the dequantized f32 matrix; NMFk refuses uint8 storage."""
    captured = {}
    real = nmf_mod._jitted_solver

    def spy(*a, **kw):
        captured["chunk"] = a[4]
        return real(*a, **kw)

    monkeypatch.setattr(nmf_mod, "_jitted_solver", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    A = jnp.asarray(np.arange(64 * 48).reshape(64, 48) % 256, jnp.uint8)
    W = jnp.asarray(np.random.default_rng(0).random((64, 3)), jnp.float32)
    H = jnp.asarray(np.random.default_rng(1).random((3, 48)), jnp.float32)
    cfg = NMFConfig(k=3, norm="fro", itr=5)
    W8, H8, e8 = nmf_mod.solve(A, W, H, jnp.float32(1e-7), cfg)
    assert captured["chunk"] == 0
    Wf, Hf, ef = nmf_mod.solve(A.astype(jnp.float32), W, H,
                               jnp.float32(1e-7), cfg)
    np.testing.assert_allclose(float(e8), float(ef), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(W8), np.asarray(Wf), rtol=2e-2,
                               atol=1e-5)

    from pydnmfk_tpu.config import NMFkConfig
    from pydnmfk_tpu.models.nmfk import NMFk
    with pytest.raises(ValueError, match="uint8"):
        NMFk(NMFkConfig(nmf=NMFConfig(k=0, a_precision="uint8"),
                        start_k=2, end_k=3, perturbations=2,
                        results_path=str(tmp_path), fname="q",
                        checkpoint=False)).fit(jnp.ones((8, 6)))
